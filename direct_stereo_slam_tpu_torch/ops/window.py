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
kernels' buffers and their parameter structs, built once; a call sets the
state's pointers and launches. A call's outputs are new tensors: nothing it
returns is a buffer that a later call writes. Each wrapper counts its
launches in ``.launches``.
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
SORT_MAX = 8192               # csrc/window.cu's kSortMax: the epilogue's keys


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
         + _KF_OUT]


def _ba_key(cfg) -> tuple:
    ba, tr = cfg.ba, cfg.tracker
    return (ba.huber_th, ba.initial_calib_hessian, ba.initial_aff_a_prior,
            ba.initial_aff_b_prior, tr.affine_mode_a, tr.affine_mode_b, ba.th_opt_iterations,
            ba.min_opt_iterations, ba.solver_force_accept_step, ba.frame_energy_th_n,
            ba.frame_energy_th_fac_median, ba.frame_energy_th_const_weight,
            ba.overall_energy_th_weight)


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


_keyframes = {}


def _keyframe(state, cfg, B: int, compact: bool) -> _Keyframe:
    dev = state.images.device
    key = (dev, torch.cuda.current_stream(dev).cuda_stream, state.num_slots, state.num_points,
           B, compact, tuple(state.images.shape), _ba_key(cfg))
    got = _keyframes.get(key)
    if got is None:
        if len(_keyframes) >= 8:
            _keyframes.pop(next(iter(_keyframes)))
        got = _keyframes[key] = _Keyframe(state, cfg, B, compact)
    return got


_FRAME_INPUTS = ("images", "T_zero", "aff_zero", "exposure", "energy_th", "calib_zero",
                 "frame_valid", "frame_id", "HM", "bM")


def ba_keyframe_cuda(state, cfg, iterations: int, newest_slot: int, compact_budget=None):
    """``optimize_keyframe`` on the card: K17's prologue, the resident
    launch, K17's epilogue (three launches, no host read). Returns (state,
    rmse, ok, Hdd [NP], n_dropped), every tensor new."""
    W, NP = state.num_slots, state.num_points
    compact = compact_budget is not None and compact_budget < NP
    B = int(compact_budget) if compact else NP
    if not 0 <= int(newest_slot) < W:
        raise ValueError(f"ba_keyframe: newest slot {newest_slot} of {W}")
    if B > SORT_MAX:
        raise ValueError(f"ba_keyframe: {B} points in the BA's view (at most {SORT_MAX})")
    ws = _keyframe(state, cfg, B, compact)
    dev = state.images.device
    pool = {n: getattr(state, n).contiguous() for n in _POOL}
    frames = {n: getattr(state, n).contiguous() for n in _FRAME_INPUTS}
    for name, t in frames.items():
        want = kb._DTYPES.get(name, torch.float32)
        if t.dtype != want:
            raise TypeError(f"ba_keyframe: {name} must be {want}, got {t.dtype}")
    for name in ("p_valid", "p_res_good"):
        if pool[name].dtype != torch.bool:
            raise TypeError(f"ba_keyframe: {name} must be bool")
    f32 = dict(dtype=torch.float32, device=dev)
    fl = torch.empty(16 * W + 8 * W + 4 + W + 3 * NP + 1, **f32)
    by = torch.empty(NP + NP * W + 1, dtype=torch.bool, device=dev)
    last = torch.empty(NP, 2, dtype=torch.int32, device=dev)
    n_dropped = torch.empty((), dtype=torch.int64, device=dev)
    o = 0
    views = {}
    for name, n, shape in (("T_zero_out", 16 * W, (W, 4, 4)), ("delta_out", 8 * W, (W, 8)),
                           ("calib_delta_out", 4, (4,)), ("energy_th_out", W, (W,)),
                           ("p_idepth_out", NP, (NP,)), ("p_num_good_out", NP, (NP,)),
                           ("hdd_out", NP, (NP,)), ("rmse_out", 1, ())):
        views[name] = fl[o:o + n].view(shape)
        o += n
    views["p_valid_out"] = by[:NP]
    views["p_res_good_out"] = by[NP:NP + NP * W].view(NP, W)
    views["ok_out"] = by[NP + NP * W:].view(())
    views["p_last_res_out"] = last
    _cuda.require_cuda("ba_keyframe", *pool.values(), *frames.values(), fl, by, last, n_dropped,
                       dtypes=(torch.float32, torch.bool, torch.int32, torch.int64))
    if pool["p_host"].dtype != torch.int64 or pool["p_last_res"].dtype != torch.int32:
        raise TypeError("ba_keyframe: p_host must be int64 and p_last_res int32")
    k = ws.kf
    k.newest = int(newest_slot)
    for name, t in pool.items():
        setattr(k, name, t.data_ptr())
    for name, t in views.items():
        setattr(k, name, t.data_ptr())
    k.n_dropped = n_dropped.data_ptr()
    s = ws.params.struct
    for name, t in frames.items():
        setattr(s, name, t.data_ptr())
    ba_prologue_cuda(k)
    kb.ba_optimize_cuda(ws.params, iterations)
    ba_epilogue_cuda(k)
    out = state._replace(T_zero=views["T_zero_out"], delta=views["delta_out"],
                         calib_delta=views["calib_delta_out"], energy_th=views["energy_th_out"],
                         p_idepth=views["p_idepth_out"], p_valid=views["p_valid_out"],
                         p_res_good=views["p_res_good_out"], p_num_good=views["p_num_good_out"],
                         p_last_res=last)
    return out, views["rmse_out"], views["ok_out"], views["hdd_out"], n_dropped


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

    _fields_ = [("ba", kb.BaParams), ("flags", _P), ("Hdd", _P), ("calib_delta", _P),
                ("points", ctypes.c_int), ("n_slots", ctypes.c_int),
                ("slots", ctypes.c_int * MAX_SLOTS), ("marg_w", ctypes.c_float)] + \
        [(n, _P) for n in ("mlist", "Hsc", "bsc", "HM_out", "bM_out", "frame_valid_out",
                           "frame_id_out", "delta_out", "p_valid_out", "p_res_good_out")]


class _Marg:
    """One (device, stream, W, NP, image, settings)'s scratch and struct."""

    def __init__(self, state, cfg):
        W, NP = state.num_slots, state.num_points
        D = 4 + 8 * W
        dev = state.images.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.lins = kb.empty_lin(1, NP, W, dev)
        self.scratch = {"lin_part": torch.empty(W * W * (kb.HE + 1), **f32),
                        "pt_part": torch.empty(NP * W * kb.G, **f32),
                        "chunk_part": torch.empty(W * W * kb.CHUNKS * kb.HE, **f32)}
        self.host_pts = torch.empty(NP, dtype=torch.int32, device=dev)
        self.host_off = torch.empty(W + 1, dtype=torch.int32, device=dev)
        self.mlist = torch.empty(NP + 1, dtype=torch.int32, device=dev)
        self.Hsc = torch.empty(D * D, **f32)
        self.bsc = torch.empty(D, **f32)
        self.grid = max(1, min(_cuda.sm_count(dev), (kb.CHUNKS * W * W + 1) // 2))
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
        b.host_pts, b.host_off = self.host_pts.data_ptr(), self.host_off.data_ptr()
        for name in kb.LIN_FIELDS:
            setattr(b, name, _P3(*[self.lins[name][0].data_ptr()] * 3))
        for name, t in self.scratch.items():
            setattr(b, name, t.data_ptr())
        m.mlist, m.Hsc, m.bsc = self.mlist.data_ptr(), self.Hsc.data_ptr(), self.bsc.data_ptr()
        m.marg_w = kb._f32(ba.marg_weight_fac)
        self.struct = m


_margs = {}

_MARG_INPUTS = ("images", "T_zero", "aff_zero", "exposure", "energy_th", "calib_zero",
                "frame_valid", "frame_id", "HM", "bM", "p_valid", "p_host", "p_u", "p_v",
                "p_idepth_zero", "p_color", "p_weight", "p_prior", "p_res_good")


def marginalize_cuda(state, lin_Hdd: torch.Tensor, flags: torch.Tensor, points: bool, slots,
                     cfg):
    """K18: ``flags`` uint8 [NP] on the card (bit 0: marginalize the point,
    bit 1: drop it), ``points``: whether any point is marginalized (known on
    the host), ``slots``: the frames to marginalize in order, ``lin_Hdd``:
    the idepth Hessians of the linearization the points are folded with.
    One launch; returns the new state (HM, bM, frame_valid, frame_id, delta,
    p_valid and p_res_good new tensors)."""
    W, NP = state.num_slots, state.num_points
    D = 4 + 8 * W
    slots = [int(s) for s in slots]
    if not 1 <= W <= MAX_SLOTS or len(slots) > W or len(set(slots)) != len(slots) \
            or any(not 0 <= s < W for s in slots):
        raise ValueError(f"marginalize: slots {slots} of {W}")
    dev = state.images.device
    key = (dev, torch.cuda.current_stream(dev).cuda_stream, W, NP,
           tuple(state.images.shape), _ba_key(cfg), cfg.ba.marg_weight_fac)
    ws = _margs.get(key)
    if ws is None:
        if len(_margs) >= 8:
            _margs.pop(next(iter(_margs)))
        ws = _margs[key] = _Marg(state, cfg)
    ins = {n: getattr(state, n).contiguous() for n in _MARG_INPUTS}
    own = {n: getattr(state, n).contiguous() for n in ("calib_delta", "delta", "p_idepth")}
    for name, t in ins.items():
        want = kb._DTYPES.get(name, torch.float32)
        if t.dtype != want:
            raise TypeError(f"marginalize: {name} must be {want}, got {t.dtype}")
    if flags.dtype != torch.uint8 or flags.shape != (NP,):
        raise TypeError("marginalize: flags must be uint8 [NP]")
    f32 = dict(dtype=torch.float32, device=dev)
    fl = torch.empty(D * D + D + 8 * W, **f32)
    by = torch.empty(W + NP + NP * W, dtype=torch.bool, device=dev)
    fid = torch.empty(W, dtype=torch.int32, device=dev)
    hdd = lin_Hdd.contiguous()
    _cuda.require_cuda("marginalize", *ins.values(), *own.values(), flags, hdd, fl, by, fid,
                       dtypes=(torch.float32, torch.bool, torch.int32, torch.int64, torch.uint8))
    m = ws.struct
    b = m.ba
    for name, t in ins.items():
        setattr(b, name, t.data_ptr())
    b.calib_delta = _P3(*[own["calib_delta"].data_ptr()] * 3)
    b.delta = _P3(*[own["delta"].data_ptr()] * 3)
    b.idepth = _P3(*[own["p_idepth"].data_ptr()] * 3)
    m.flags, m.Hdd, m.calib_delta = flags.data_ptr(), hdd.data_ptr(), own["calib_delta"].data_ptr()
    m.points = int(bool(points))
    m.n_slots = len(slots)
    for i in range(MAX_SLOTS):
        m.slots[i] = slots[i] if i < len(slots) else -1
    HM, bM, delta = fl[:D * D].view(D, D), fl[D * D:D * D + D], fl[D * D + D:].view(W, 8)
    frame_valid, p_valid = by[:W], by[W:W + NP]
    p_res_good = by[W + NP:].view(NP, W)
    m.HM_out, m.bM_out, m.delta_out = HM.data_ptr(), bM.data_ptr(), delta.data_ptr()
    m.frame_valid_out, m.frame_id_out = frame_valid.data_ptr(), fid.data_ptr()
    m.p_valid_out, m.p_res_good_out = p_valid.data_ptr(), p_res_good.data_ptr()
    _cuda.call("dsslam_marginalize", ctypes.addressof(m), ws.grid)
    marginalize_cuda.launches += 1
    return state._replace(HM=HM, bM=bM, frame_valid=frame_valid, frame_id=fid, delta=delta,
                          p_valid=p_valid, p_res_good=p_res_good)


marginalize_cuda.launches = 0


def pack_flags(marg: np.ndarray, drop: np.ndarray) -> np.ndarray:
    """K18's per-point flags from the host masks: bit 0 marginalize, bit 1
    drop."""
    return (np.asarray(marg, bool).astype(np.uint8)
            | (np.asarray(drop, bool).astype(np.uint8) << 1))
