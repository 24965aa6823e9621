"""The windowed BA's state programs on the card (``csrc/window.cu``):
K16 ``window_pose``, the window's current poses, their inverses, the
host-to-reference transforms, the affine parameters and the intrinsics in
one launch; K17, the keyframe BA's prologue (the valid-first compaction
and K9's host groups) and epilogue (the newest frame's energy threshold,
its FEJ reset, the drop of points without a good residual and the scatter
back into the pool) around the resident launch; K18 ``marginalize``, the
keyframe tail's point and frame marginalization in one launch.

Each has a plain PyTorch version that the wrappers take for CPU tensors
only: ``window_pose_plain`` here, ``models/ba.py::optimize_keyframe_plain``
and ``marginalize_plain``. On a CUDA tensor a wrapper launches its kernel
or raises. ``window_pose_plain`` computes every entry one rounded
operation at a time in the kernel's order (the rigid inverse (R^T, -R^T t)
where the JAX package calls ``jnp.linalg.inv``): the kernel gives its bits.

K17's and K18's wrappers keep, per (device, stream, sizes, settings), the
kernels' buffers and their parameter structs, built once (the state's
shapes checked then); a call checks each tensor's dtype and device on
the way to its pointer, sets the fields that change and launches. K18's
flags and the flagged points' lists are built on the host
(``marg_lists``) and go up in one copy through a pinned staging buffer
kept with its buffers. A call's outputs are new tensors, views of one
allocation: nothing it returns is a buffer that a later call writes. Each
wrapper counts its launches in ``.launches``; ``phase_split`` reads the
kernels' phase stamps (their ``timers`` fields, null on the main path).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda
from . import ba as kb

_P = ctypes.c_void_p
_P3 = ctypes.c_void_p * 3
MAX_SLOTS = 8
SELECT_MAX = 16384            # csrc/window.cu's kSelectMax: the epilogue's keys
NP_MAX = 65535                # K17's and K18's pools: csrc/window.cu's 16-bit counts


class WindowPose(NamedTuple):
    """K16's outputs: T_all [W, 4, 4] (worldToCam, current), T_inv
    [W, 4, 4] (their inverses), T_rh [W, 4, 4] (T_all[ref] @ T_inv), aff
    [W, 2], calib [4]; on the card views of one buffer."""

    T_all: torch.Tensor
    T_inv: torch.Tensor
    T_rh: torch.Tensor
    aff: torch.Tensor
    calib: torch.Tensor


# ---------------------------------------------------------------------------
# K16: the window's poses
# ---------------------------------------------------------------------------


def _sinc(t2: torch.Tensor):
    """lie._sinc_coeffs in the kernel's order (lie.cuh's sinc_coeffs)."""
    small = t2 < 1e-4
    st2 = torch.where(small, torch.ones_like(t2), t2)
    st = torch.sqrt(st2)
    sin, cos = torch.sin(st), torch.cos(st)
    A = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, sin / st)
    B = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, (1.0 - cos) / st2)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0, (st - sin) / (st2 * st))
    return A, B, C


def _mat(A: torch.Tensor, B: torch.Tensor, n: int) -> torch.Tensor:
    """A @ B over the last two axes with the n products summed left to
    right, one rounded operation at a time (broadcast)."""
    out = A[..., :, 0:1] * B[..., 0:1, :]
    for k in range(1, n):
        out = out + A[..., :, k:k + 1] * B[..., k:k + 1, :]
    return out


def _exp4(xi: torch.Tensor) -> torch.Tensor:
    """se3_exp of [W, 6] as [W, 4, 4], lie.cuh's se3_exp operation by
    operation."""
    t, w = xi[:, :3], xi[:, 3:]
    A, B, C = _sinc(w[:, 0] * w[:, 0] + w[:, 1] * w[:, 1] + w[:, 2] * w[:, 2])
    z = torch.zeros_like(w[:, 0])
    Wm = torch.stack([torch.stack([z, -w[:, 2], w[:, 1]], -1),
                      torch.stack([w[:, 2], z, -w[:, 0]], -1),
                      torch.stack([-w[:, 1], w[:, 0], z], -1)], -2)
    W2 = _mat(Wm, Wm, 3)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A[:, None, None] * Wm + B[:, None, None] * W2
    V = eye + B[:, None, None] * Wm + C[:, None, None] * W2
    tr = V[:, :, 0] * t[:, 0:1] + V[:, :, 1] * t[:, 1:2] + V[:, :, 2] * t[:, 2:3]
    top = torch.cat([R, tr[:, :, None]], -1)
    bottom = torch.zeros_like(top[:, :1])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], -2)


def _inv_rigid(T: torch.Tensor) -> torch.Tensor:
    """(R^T, -R^T t) of [W, 4, 4], the kernel's order."""
    R, t = T[:, :3, :3], T[:, :3, 3]
    ti = -(R[:, 0, :] * t[:, 0:1] + R[:, 1, :] * t[:, 1:2] + R[:, 2, :] * t[:, 2:3])
    top = torch.cat([R.transpose(1, 2), ti[:, :, None]], -1)
    bottom = torch.zeros_like(top[:, :1])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], -2)


def current_poses_plain(T_zero: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """BAState.T_current (se3_exp(delta[:, :6]) @ T_zero) in K16's order."""
    return _mat(_exp4(delta[:, :6]), T_zero, 4)


def window_pose_plain(T_zero, delta, aff_zero, calib_zero, calib_delta,
                      ref: int) -> WindowPose:
    """K16's plain version."""
    T_all = current_poses_plain(T_zero, delta)
    T_inv = _inv_rigid(T_all)
    T_rh = _mat(T_all[ref][None], T_inv, 4)
    return WindowPose(T_all, T_inv, T_rh, aff_zero + delta[:, 6:8], calib_zero + calib_delta)


class PoseParams(ctypes.Structure):
    """csrc/window.cu's ``PoseParams``, field for field."""

    _fields_ = [("W", ctypes.c_int), ("ref", ctypes.c_int)] + \
        [(n, _P) for n in ("T_zero", "delta", "aff_zero", "calib_zero", "calib_delta", "out")]


def window_pose_cuda(T_zero, delta, aff_zero, calib_zero, calib_delta, ref: int) -> WindowPose:
    """K16: one launch; the outputs are views of one new buffer."""
    W = T_zero.shape[0]
    if not 1 <= W <= MAX_SLOTS or not 0 <= int(ref) < W:
        raise ValueError(f"window_pose: {W} slots, reference {ref}")
    ins = tuple(t.contiguous() for t in (T_zero, delta, aff_zero, calib_zero, calib_delta))
    out = torch.empty(50 * W + 4, dtype=torch.float32, device=T_zero.device)
    _cuda.require_cuda("window_pose", *ins, out)
    s = PoseParams(W, int(ref), *(t.data_ptr() for t in ins), out.data_ptr())
    _cuda.call("dsslam_window_pose", ctypes.addressof(s))
    window_pose_cuda.launches += 1
    m = out[:48 * W].view(3, W, 4, 4)
    return WindowPose(m[0], m[1], m[2], out[48 * W:50 * W].view(W, 2), out[50 * W:])


window_pose_cuda.launches = 0


def window_pose(state, ref: int = 0) -> WindowPose:
    """The window's current poses, inverses, T_rh toward slot ``ref``,
    affine parameters and intrinsics of a BA state: K16 on the card, its
    plain version for a CPU state."""
    args = (state.T_zero, state.delta, state.aff_zero, state.calib_zero, state.calib_delta,
            int(ref))
    if state.T_zero.is_cuda:
        return window_pose_cuda(*args)
    return window_pose_plain(*args)


# ---------------------------------------------------------------------------
# K17: around optimize_keyframe's resident launch
# ---------------------------------------------------------------------------

_POOL = ("p_valid", "p_host", "p_u", "p_v", "p_idepth", "p_idepth_zero", "p_color", "p_weight",
         "p_prior", "p_res_good", "p_num_good", "p_last_res", "calib_delta", "delta", "T_zero",
         "energy_th")
_COMPACT = ("c_valid", "c_host", "c_u", "c_v", "c_idepth_zero", "c_color", "c_weight",
            "c_prior", "c_res_good", "c_num_good", "c_last_res")
_BA_OUT = ("l_pair_energy", "l_pair_in", "l_pair_good", "l_Hdd", "o_num_good", "o_last_res",
           "o_rmse", "o_ok")
_KF_OUT = ("T_zero_out", "delta_out", "calib_delta_out", "energy_th_out", "p_idepth_out",
           "p_valid_out", "p_res_good_out", "p_num_good_out", "p_last_res_out", "hdd_out",
           "rmse_out", "ok_out")


class KfParams(ctypes.Structure):
    """csrc/window.cu's ``KfParams``, field for field."""

    _fields_ = [(n, ctypes.c_int) for n in ("W", "NP", "B", "compact", "newest")] + \
        [(n, ctypes.c_float) for n in ("q", "fac", "c_const", "c_keep", "w2", "fallback")] + \
        [(n, _P) for n in _POOL + _COMPACT] + \
        [(n, _P3) for n in ("s_calib_delta", "s_delta", "s_idepth")] + \
        [(n, _P) for n in ("host_pts", "host_off", "rows", "pos", "n_dropped") + _BA_OUT
         + _KF_OUT + ("pro_timers", "epi_timers")]


def _ba_key(cfg) -> tuple:
    ba, tr = cfg.ba, cfg.tracker
    return (ba.huber_th, ba.initial_calib_hessian, ba.initial_aff_a_prior,
            ba.initial_aff_b_prior, tr.affine_mode_a, tr.affine_mode_b, ba.th_opt_iterations,
            ba.min_opt_iterations, ba.solver_force_accept_step, ba.frame_energy_th_n,
            ba.frame_energy_th_fac_median, ba.frame_energy_th_const_weight,
            ba.overall_energy_th_weight)


def _check_shapes(name: str, state, fields) -> None:
    """The BA state's fields' shapes for its W slots, NP points and images:
    checked when a wrapper builds its buffers for a new key (the key holds
    W, NP and the images' shape, which fix every other shape)."""
    W, NP = state.num_slots, state.num_points
    D = 4 + 8 * W
    want = {"T_zero": (W, 4, 4), "delta": (W, 8), "aff_zero": (W, 2), "calib_zero": (4,),
            "calib_delta": (4,), "HM": (D, D), "bM": (D,), "p_color": (NP, 8),
            "p_weight": (NP, 8), "p_res_good": (NP, W), "p_last_res": (NP, 2)}
    for n in fields:
        shape = tuple(getattr(state, n).shape)
        w = want.get(n, tuple(state.images.shape) if n == "images"
                     else (W,) if n in ("exposure", "energy_th", "frame_valid", "frame_id")
                     else (NP,))
        if shape != w:
            raise ValueError(f"{name}: {n} of shape {shape}, not {w}")


class _Keyframe:
    """One (device, stream, W, NP, budget, image, settings)'s buffers: the
    compact view, the resident launch's parameter block (built once, its
    frame pointers set per call) and K17's struct."""

    def __init__(self, state, cfg, B: int, compact: bool):
        W, NP = state.num_slots, state.num_points
        dev = state.images.device
        self.W, self.NP, self.B, self.compact = W, NP, B, compact
        f32 = dict(dtype=torch.float32, device=dev)
        u8 = dict(dtype=torch.bool, device=dev)
        c = {"p_valid": torch.empty(B, **u8),
             "p_host": torch.empty(B, dtype=torch.int64, device=dev),
             "p_u": torch.empty(B, **f32), "p_v": torch.empty(B, **f32),
             "p_idepth_zero": torch.empty(B, **f32), "p_color": torch.empty(B, 8, **f32),
             "p_weight": torch.empty(B, 8, **f32), "p_prior": torch.empty(B, **f32),
             "p_res_good": torch.empty(B, W, **u8), "p_num_good": torch.empty(B, **f32),
             "p_last_res": torch.empty(B, 2, dtype=torch.int32, device=dev)}
        self.compact_view = c
        # a state of the compact view for the parameter block's layout: its
        # frame arrays are the first call's and are set again every call
        sub = state._replace(**c, p_idepth=torch.empty(B, **f32))
        self.params = kb.optimize_params(sub, cfg)
        self.host_pts = torch.empty(B, dtype=torch.int32, device=dev)
        self.host_off = torch.empty(W + 1, dtype=torch.int32, device=dev)
        s = self.params.struct
        s.host_pts, s.host_off = self.host_pts.data_ptr(), self.host_off.data_ptr()
        self.rows = torch.empty(B, dtype=torch.int32, device=dev)
        self.pos = torch.empty(NP, dtype=torch.int32, device=dev)
        ba = cfg.ba
        cw = ba.frame_energy_th_const_weight
        k = KfParams(W=W, NP=NP, B=B, compact=int(compact), newest=0,
                     q=kb._f32(ba.frame_energy_th_n), fac=kb._f32(ba.frame_energy_th_fac_median),
                     c_const=kb._f32(26.0 * cw), c_keep=kb._f32(1.0 - cw),
                     w2=kb._f32(ba.overall_energy_th_weight ** 2),
                     fallback=kb._f32(12.0 * 8.0 ** 0.5))
        for name, t in c.items():
            setattr(k, "c_" + name[2:], t.data_ptr())
        b = self.params.bufs
        for name, field in (("s_calib_delta", "calib_delta"), ("s_delta", "delta"),
                            ("s_idepth", "p_idepth")):
            setattr(k, name, _P3(*(b.state[field][i].data_ptr() for i in range(3))))
        k.host_pts, k.host_off = self.host_pts.data_ptr(), self.host_off.data_ptr()
        k.rows, k.pos = self.rows.data_ptr(), self.pos.data_ptr()
        for name, t in (("l_pair_energy", b.lin["pair_energy"][2]),
                        ("l_pair_in", b.lin["pair_in"][2]),
                        ("l_pair_good", b.lin["pair_good"][2]), ("l_Hdd", b.lin["Hdd"][2]),
                        ("o_num_good", b.out["num_good"]), ("o_last_res", b.out["last_res"]),
                        ("o_rmse", b.out["rmse"]), ("o_ok", b.out["ok"])):
            setattr(k, name, t.data_ptr())
        self.kf = k
        self.dev_index = dev.index
        self.out_layout, self.out_bytes = _kf_outputs(W, NP)
        self.out_fields = []
        for dtype, at, _, sizes, fields in self.out_layout:
            for (name, _), n in zip(fields, sizes):
                self.out_fields.append((name, at))
                at += dtype.itemsize * n


_keyframes = {}


def _keyframe(state, cfg, B: int, compact: bool) -> _Keyframe:
    dev = state.images.device
    key = (dev, torch.cuda.current_stream(dev).cuda_stream, state.num_slots, state.num_points,
           B, compact, tuple(state.images.shape), _ba_key(cfg))
    got = _keyframes.get(key)
    if got is None:
        if len(_keyframes) >= 8:
            _keyframes.pop(next(iter(_keyframes)))
        _check_shapes("ba_keyframe", state, _POOL + _FRAME_INPUTS)
        got = _keyframes[key] = _Keyframe(state, cfg, B, compact)
    return got


_FRAME_INPUTS = ("images", "T_zero", "aff_zero", "exposure", "energy_th", "calib_zero",
                 "frame_valid", "frame_id", "HM", "bM")


def _kf_outputs(W: int, NP: int):
    """K17's outputs in one allocation: per dtype (aligned to its size),
    (dtype, byte offset, element count, sizes, fields (name, shape)), and
    the bytes in all."""
    groups = ((torch.int64, (("n_dropped", ()),)),
              (torch.float32, (("T_zero_out", (W, 4, 4)), ("delta_out", (W, 8)),
                               ("calib_delta_out", (4,)), ("energy_th_out", (W,)),
                               ("p_idepth_out", (NP,)), ("p_num_good_out", (NP,)),
                               ("hdd_out", (NP,)), ("rmse_out", ()))),
              (torch.int32, (("p_last_res_out", (NP, 2)),)),
              (torch.bool, (("p_valid_out", (NP,)), ("p_res_good_out", (NP, W)),
                            ("ok_out", ()))))
    layout, at = [], 0
    for dtype, fields in groups:
        sizes = [int(np.prod(shape, dtype=np.int64)) for _, shape in fields]
        layout.append((dtype, at, sum(sizes), sizes, fields))
        at += dtype.itemsize * sum(sizes)
    return layout, at


def ba_keyframe_cuda(state, cfg, iterations: int, newest_slot: int, compact_budget=None):
    """``optimize_keyframe`` on the card: K17's prologue, the resident
    launch, K17's epilogue (three launches, no host read). Returns (state,
    rmse, ok, Hdd [NP], n_dropped), every tensor new (views of one
    allocation)."""
    W, NP = state.num_slots, state.num_points
    compact = compact_budget is not None and compact_budget < NP
    B = int(compact_budget) if compact else NP
    if not 0 <= int(newest_slot) < W:
        raise ValueError(f"ba_keyframe: newest slot {newest_slot} of {W}")
    if B > SELECT_MAX:
        raise ValueError(f"ba_keyframe: {B} points in the BA's view (at most {SELECT_MAX})")
    if NP > NP_MAX:
        raise ValueError(f"ba_keyframe: a pool of {NP} points (at most {NP_MAX})")
    ws = _keyframe(state, cfg, B, compact)
    keep = []
    pool = _pointers("ba_keyframe", [(n, getattr(state, n)) for n in _POOL], ws.dev_index, keep)
    frames = _pointers("ba_keyframe", [(n, getattr(state, n)) for n in _FRAME_INPUTS],
                       ws.dev_index, keep)
    out = torch.empty(ws.out_bytes, dtype=torch.uint8, device=state.images.device)
    base = out.data_ptr()
    k = ws.kf
    k.newest = int(newest_slot)
    for name, ptr in zip(_POOL, pool):
        setattr(k, name, ptr)
    for name, off in ws.out_fields:
        setattr(k, name, base + off)
    s = ws.params.struct
    for name, ptr in zip(_FRAME_INPUTS, frames):
        setattr(s, name, ptr)
    ba_prologue_cuda(k)
    kb.ba_optimize_cuda(ws.params, iterations)
    ba_epilogue_cuda(k)
    views = {}
    for dtype, at, n, sizes, fields in ws.out_layout:
        parts = out[at:at + n * dtype.itemsize].view(dtype).split_with_sizes(sizes)
        for (name, shape), t in zip(fields, parts):
            views[name] = t.view(shape)
    st = state._replace(T_zero=views["T_zero_out"], delta=views["delta_out"],
                        calib_delta=views["calib_delta_out"], energy_th=views["energy_th_out"],
                        p_idepth=views["p_idepth_out"], p_valid=views["p_valid_out"],
                        p_res_good=views["p_res_good_out"], p_num_good=views["p_num_good_out"],
                        p_last_res=views["p_last_res_out"])
    return st, views["rmse_out"], views["ok_out"], views["hdd_out"], views["n_dropped"]


def ba_prologue_cuda(kf: KfParams) -> None:
    """K17's prologue on a struct ``ba_keyframe_cuda`` filled: the compact
    view, its host groups and the resident launch's state buffers."""
    _cuda.call("dsslam_ba_prologue", ctypes.addressof(kf))
    ba_prologue_cuda.launches += 1


def ba_epilogue_cuda(kf: KfParams) -> None:
    """K17's epilogue on the same struct, after the resident launch: the
    threshold, the FEJ reset, the drop and the scatter into its outputs."""
    _cuda.call("dsslam_ba_epilogue", ctypes.addressof(kf))
    ba_epilogue_cuda.launches += 1


ba_prologue_cuda.launches = 0
ba_epilogue_cuda.launches = 0


# ---------------------------------------------------------------------------
# K18: the keyframe tail's marginalization
# ---------------------------------------------------------------------------


class MargParams(ctypes.Structure):
    """csrc/window.cu's ``MargParams``, field for field."""

    _fields_ = [("ba", kb.BaParams), ("flags", _P), ("mlist", _P), ("Hdd", _P),
                ("calib_delta", _P), ("nm", ctypes.c_int), ("n_slots", ctypes.c_int),
                ("slots", ctypes.c_int * MAX_SLOTS), ("marg_w", ctypes.c_float)] + \
        [(n, _P) for n in ("bpart", "HM_out", "bM_out", "frame_valid_out", "frame_id_out",
                           "delta_out", "p_valid_out", "p_res_good_out", "timers")]


MARG_TILE = 8                 # csrc/window.cu's kMT: a Schur tile's side
_HEAD = 16                    # the upload's head: nm, host_off [W + 1], padding (int32 words)
_RING = 32                    # staging buffers a key: K18 calls in flight before the host waits


class _Marg:
    """One (device, stream, W, NP, image, settings)'s scratch, struct and
    upload buffers (a ring of pinned staging buffers and their card copy:
    head, flags, then mlist and host_pts; a staging buffer is written only
    once the copy that last read it has run, so the host waits only with
    _RING calls in flight)."""

    def __init__(self, state, cfg):
        W, NP = state.num_slots, state.num_points
        D = 4 + 8 * W
        dev = state.images.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.lins = kb.empty_lin(1, NP, W, dev)
        rows = -(-D // MARG_TILE)
        self.scratch = {"lin_part": torch.empty(W * W * (kb.HE + 1), **f32),
                        "pt_part": torch.empty(NP * W * kb.G, **f32),
                        "chunk_part": torch.empty(W * W * kb.CHUNKS * kb.HE, **f32)}
        self.bpart = torch.empty(D * (MAX_SLOTS + 1) + D, **f32)
        self.tiles = rows * (rows + 1) // 2 + rows
        self.sms = _cuda.sm_count(dev)
        # the upload: [head | flags (NP bytes, padded to 64 B) | mlist | host_pts]
        self.lists_at = _HEAD + -(-NP // 64) * 16
        words = self.lists_at + 2 * NP
        self.up_dev = torch.empty(words, dtype=torch.int32, device=dev)
        self.up_host = torch.empty(_RING, words, dtype=torch.int32, pin_memory=True)
        self.up_np = self.up_host.numpy()
        self.copied = [torch.cuda.Event() for _ in range(_RING)]
        self.turn = 0
        self.dev_index = dev.index
        self.out_bytes = 4 * (D * D + D + 8 * W + W) + W + NP + NP * W
        m = MargParams()
        b = m.ba
        b.W, b.NP, b.Himg, b.Wimg = W, NP, state.images.shape[1], state.images.shape[2]
        Himg, Wimg = b.Himg, b.Wimg
        ba = cfg.ba
        mode_a, mode_b = cfg.tracker.affine_mode_a, cfg.tracker.affine_mode_b
        b.umax, b.vmax = kb._f32(Wimg - 1.001), kb._f32(Himg - 1.001)
        b.u_hi, b.v_hi = kb._f32(Wimg - 2.1), kb._f32(Himg - 2.1)
        b.huber, b.calib_h = kb._f32(ba.huber_th), kb._f32(ba.initial_calib_hessian)
        b.a_prior = kb._f32(ba.initial_aff_a_prior if mode_a < 0 else float(mode_a))
        b.b_prior = kb._f32(ba.initial_aff_b_prior if mode_b < 0 else float(mode_b))
        from ..models.ba import _pattern, _precond
        self.consts = (_precond(W, dev),) + _pattern(dev)
        b.precond, b.pat_u, b.pat_v = (t.data_ptr() for t in self.consts)
        up = self.up_dev.data_ptr()
        b.host_off = up + 4
        m.flags, m.mlist = up + 4 * _HEAD, up + 4 * self.lists_at
        for name in kb.LIN_FIELDS:
            setattr(b, name, _P3(*[self.lins[name][0].data_ptr()] * 3))
        for name, t in self.scratch.items():
            setattr(b, name, t.data_ptr())
        m.bpart = self.bpart.data_ptr()
        m.marg_w = kb._f32(ba.marg_weight_fac)
        self.struct = m

    def upload(self, lists: MargLists) -> int:
        """The flags and lists into the staging buffer, then one copy to the
        card; returns the flagged points' count."""
        nm, W = len(lists.mlist), len(lists.host_off) - 1
        i = self.turn
        self.turn = (i + 1) % _RING
        if not self.copied[i].query():
            self.copied[i].synchronize()
        h = self.up_np[i]
        h[0] = nm
        h[1:W + 2] = lists.host_off
        h[_HEAD:self.lists_at].view(np.uint8)[:len(lists.flags)] = lists.flags
        at = self.lists_at
        h[at:at + nm] = lists.mlist
        h[at + nm:at + 2 * nm] = lists.host_pts
        n = at + 2 * nm
        self.up_dev[:n].copy_(self.up_host[i, :n], non_blocking=True)
        self.copied[i].record()
        return nm


_margs = {}

_MARG_INPUTS = ("images", "T_zero", "aff_zero", "exposure", "energy_th", "calib_zero",
                "frame_valid", "frame_id", "HM", "bM", "p_valid", "p_host", "p_u", "p_v",
                "p_idepth_zero", "p_color", "p_weight", "p_prior", "p_res_good")
_MARG_OWN = ("calib_delta", "delta", "p_idepth")


def _pointers(name: str, tensors, dev_index: int, keep: list) -> list:
    """The tensors' data pointers for a kernel, each checked on the way:
    on the card ``dev_index``, of the dtype the BA state gives its field
    (``kb._DTYPES``, else float32); a tensor that is not contiguous is
    made so, its copy kept in ``keep`` for the launch."""
    out = []
    for field, t in tensors:
        want = kb._DTYPES.get(field, torch.float32)
        if t.dtype is not want or t.get_device() != dev_index:
            raise TypeError(f"{name}: {field} must be a {want} tensor on cuda:{dev_index}, "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            t = t.contiguous()
            keep.append(t)
        out.append(t.data_ptr())
    return out


def marginalize_cuda(state, lin_Hdd: torch.Tensor, lists: MargLists, slots, cfg, timers=None,
                     grid=None):
    """K18: ``lists``: the flags and the flagged points' lists
    (``marg_lists``, host arrays; they go up in one copy), ``slots``: the
    frames to marginalize in order, ``lin_Hdd``: the idepth Hessians of
    the linearization the points are folded with; ``timers``: an int64
    buffer for the phase stamps; ``grid``: the launch's blocks (at most
    the card's SMs; by default the widest phase's). One launch; returns
    the new state (HM, bM, frame_valid, frame_id, delta, p_valid and
    p_res_good: views of one new allocation)."""
    W, NP = state.num_slots, state.num_points
    D = 4 + 8 * W
    slots = [int(s) for s in slots]
    if not 1 <= W <= MAX_SLOTS or len(slots) > W or len(set(slots)) != len(slots) \
            or any(not 0 <= s < W for s in slots):
        raise ValueError(f"marginalize: slots {slots} of {W}")
    if NP > NP_MAX:
        raise ValueError(f"marginalize: a pool of {NP} points (at most {NP_MAX})")
    if len(lists.flags) != NP or len(lists.host_off) != W + 1:
        raise ValueError(f"marginalize: lists of {len(lists.flags)} points and "
                         f"{len(lists.host_off) - 1} hosts for {NP} and {W}")
    dev = state.images.device
    key = (dev, torch.cuda.current_stream(dev).cuda_stream, W, NP,
           tuple(state.images.shape), _ba_key(cfg), cfg.ba.marg_weight_fac)
    ws = _margs.get(key)
    if ws is None:
        if len(_margs) >= 8:
            _margs.pop(next(iter(_margs)))
        _check_shapes("marginalize", state, _MARG_INPUTS + _MARG_OWN)
        ws = _margs[key] = _Marg(state, cfg)
    keep = []
    ptrs = _pointers("marginalize", [(n, getattr(state, n)) for n in _MARG_INPUTS + _MARG_OWN]
                     + [("Hdd", lin_Hdd)], ws.dev_index, keep)
    out = torch.empty(ws.out_bytes, dtype=torch.uint8, device=dev)
    m = ws.struct
    b = m.ba
    for name, ptr in zip(_MARG_INPUTS, ptrs):
        setattr(b, name, ptr)
    cd, dl, idp, m.Hdd = ptrs[len(_MARG_INPUTS):]
    b.calib_delta, b.delta, b.idepth = _P3(cd, cd, cd), _P3(dl, dl, dl), _P3(idp, idp, idp)
    m.calib_delta = cd
    nm = ws.upload(lists)
    m.nm = nm
    b.host_pts = m.mlist + 4 * nm
    m.n_slots = len(slots)
    for i in range(MAX_SLOTS):
        m.slots[i] = slots[i] if i < len(slots) else -1
    base = out.data_ptr()
    f = 4 * (D * D + D + 8 * W)
    m.HM_out, m.bM_out, m.delta_out = base, base + 4 * D * D, base + 4 * (D * D + D)
    m.frame_id_out, m.frame_valid_out = base + f, base + f + 4 * W
    m.p_valid_out, m.p_res_good_out = base + f + 5 * W, base + f + 5 * W + NP
    m.timers = None if timers is None else timers.data_ptr()
    # the grid: the widest phase's blocks (the pixel pass's items two a
    # block, the Schur units, the point rows 16 a block), at most an SM each
    items = int(np.count_nonzero(np.diff(lists.host_off))) * kb.CHUNKS * W if nm else 0
    if grid is None:
        grid = max((items + 1) // 2, ws.tiles if nm else 1, -(-nm // 16))
    grid = max(1, min(ws.sms, int(grid)))
    _cuda.call("dsslam_marginalize", ctypes.addressof(m), grid)
    marginalize_cuda.launches += 1
    fl = out[:f].view(torch.float32)
    return state._replace(HM=fl[:D * D].view(D, D), bM=fl[D * D:D * D + D],
                          delta=fl[D * D + D:].view(W, 8),
                          frame_id=out[f:f + 4 * W].view(torch.int32),
                          frame_valid=out[f + 4 * W:f + 5 * W].view(torch.bool),
                          p_valid=out[f + 5 * W:f + 5 * W + NP].view(torch.bool),
                          p_res_good=out[f + 5 * W + NP:].view(torch.bool).view(NP, W))


marginalize_cuda.launches = 0


# phase stamps (csrc/window.cu's warp_stamp): a kernel's phases in order,
# lane 0 of every warp stamping each boundary; "barrier" phases are grid
# barriers
PRO_PHASES = ("count", "barrier_1", "place_gather", "barrier_2", "host_groups")
EPI_PHASES = ("keys", "select", "above_threshold", "outputs")   # block 0; the others: scatter
EPI_THREADS = 1024
MARG_PHASES = ("pixel", "barrier_1", "reduce_rows", "barrier_2", "schur", "barrier_3",
               "frames")


def phase_split(stamps, phases) -> dict:
    """us per phase from one launch's stamps (rows: the warps that stamp
    these phases): a phase from the first warp's start to the last warp's
    end; a barrier from the last warp's arrival to the first warp's exit,
    with every warp's mean wait in it beside; ``total`` the whole span."""
    t = np.asarray(stamps, np.float64).reshape(-1, len(phases) + 1)
    out = {}
    for k, name in enumerate(phases):
        if name.startswith("barrier"):
            out[name] = (t[:, k + 1].min() - t[:, k].max()) / 1e3
            out[name + "_mean_wait"] = float(np.mean(t[:, k + 1] - t[:, k])) / 1e3
        else:
            out[name] = (t[:, k + 1].max() - t[:, k].min()) / 1e3
    out["total"] = (t[:, -1].max() - t[:, 0].min()) / 1e3
    return out


def pack_flags(marg: np.ndarray, drop: np.ndarray) -> np.ndarray:
    """K18's per-point flags from the host masks: bit 0 marginalize, bit 1
    drop."""
    return (np.asarray(marg, bool).astype(np.uint8)
            | (np.asarray(drop, bool).astype(np.uint8) << 1))


class MargLists(NamedTuple):
    """K18's inputs from the host masks (``marg_lists``)."""

    flags: np.ndarray      # uint8 [NP]: bit 0 marginalize, bit 1 drop
    mlist: np.ndarray      # int32 [nm]: the flagged valid points, ascending
    host_pts: np.ndarray   # int32 [nm]: mlist grouped by host, ascending within a host
    host_off: np.ndarray   # int32 [W + 1]: host s's are host_pts[host_off[s]:host_off[s + 1]]


def marg_lists(marg, drop, p_valid, p_host, W: int) -> MargLists:
    """The flags and the flagged points' lists of a keyframe tail, from the
    host masks and host copies of the state's validity and hosts: the
    points folded in are those flagged and valid, in ascending order (the
    Schur sums' order), and grouped by host as ``ops/ba.py::host_groups``
    groups a pool (K9's pixel pass's lists)."""
    mlist = np.flatnonzero(np.asarray(marg, bool) & np.asarray(p_valid, bool)).astype(np.int32)
    hosts = np.asarray(p_host)[mlist]
    host_pts = mlist[np.argsort(hosts, kind="stable")]
    host_off = np.zeros(W + 1, np.int32)
    np.cumsum(np.bincount(hosts, minlength=W)[:W], out=host_off[1:])
    return MargLists(pack_flags(marg, drop), mlist, host_pts, host_off)
