"""Launch wrappers of the resident LM kernels (``csrc/resident_lm.cu``):
K2-LM ``dsslam_track_lm``, the tracker's whole coarse-to-fine LM for a
candidate batch, K3-LM ``dsslam_scale_lm``, the stereo scale optimizer's
for a grid of guesses, and K4-LM ``dsslam_loop_pose_lm``, the loop pose
estimator's for a seed stack. One launch per call, no host read.

The callers are ``models/tracker.track_candidates_batch``,
``models/scale_opt.optimize_scale_batch`` and
``loop/pose_estimator.estimate_batch``: for CUDA tensors they call these
wrappers (the tracker and the estimator then apply their acceptance gates
in PyTorch); for CPU tensors they take their plain versions
(``track_candidates_batch_plain``, ``optimize_scale_batch_plain``,
``estimate_seeds_plain``: the Python LM loops over the passes). Each
wrapper counts its launches in ``.launches``.

A kernel takes one parameter struct by value (mirrored here with
``ctypes``); a scalar that lives on the card (an affine parameter, an
exposure) is passed as its address and read there, and K3-LM's per-level
``R01 K0^-1``, ``t01`` and camera 1's intrinsics are computed on the host
from host values, so a call builds no tensor besides its output. K2-LM's
struct is built once per template and K3-LM's once per sizes,
intrinsics, extrinsics and configuration; a call copies it and fills in
its own pointers.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _cuda
from .residual_hb import POSE_PRECOND

MAX_LEVELS = 8
CLUSTER = 8
OUT = 40           # floats per candidate in the output row
_OUT_A, _OUT_B, _OUT_RES, _OUT_X0, _OUT_X1, _OUT_PASSES = 16, 17, 18, 26, 27, 28
SCALE_OUT = 28     # floats per guess in K3-LM's output row
_SOUT_REPEAT, _SOUT_PASSES, _SOUT_RUN = 4, 12, 20
# dsslam_lm_max_active_clusters' kernel numbers
KINDS = {"track": 0, "loop_pose": 1, "scale": 2}
# the LM kernels' phase counters (resident_lm.cu, Phase): per candidate
# (K3-LM: guess) and level the SM cycles of each phase on thread 0 of
# cluster rank 0, then the whole run's cycles and nanoseconds (%globaltimer)
PHASES = ("load", "points", "reduce", "cluster", "step", "barrier")
TIMER_WORDS = MAX_LEVELS * len(PHASES) + 2

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


class _Level(ctypes.Structure):
    _fields_ = [("img", _P), ("p0", _P), ("p1", _P), ("p2", _P), ("pcolor", _P),
                ("pmask", _P), ("H", _I), ("W", _I), ("umax", _F), ("vmax", _F),
                ("N", _I), ("color_stride", _I), ("fx", _F), ("fy", _F),
                ("cx", _F), ("cy", _F), ("Ki", _F * 9), ("max_iters", _I),
                ("compute_flow", _I), ("img_stride", _LL), ("pt_stride", _LL)]


class _Scalar(ctypes.Structure):
    _fields_ = [("ptr", _P), ("value", _F)]


class LmParams(ctypes.Structure):
    _fields_ = [("lv", _Level * MAX_LEVELS), ("T_init", _P), ("out", _P), ("timers", _P),
                ("aff_a0", _Scalar), ("aff_b0", _Scalar), ("ref_a", _Scalar),
                ("ref_b", _Scalar), ("ref_exp", _Scalar), ("new_exp", _Scalar),
                ("pre", _F * 8), ("huber", _F), ("coarse_cutoff", _F),
                ("sat_ratio_repeat", _F), ("cutoff_repeat_max", _F),
                ("lambda_init", _F), ("lambda_lim", _F), ("lambda_accept", _F),
                ("lambda_reject", _F), ("inc_break", _F), ("mode_a", _F),
                ("mode_b", _F), ("levels", _I), ("B", _I), ("chunk", _I), ("per_seq", _I)]


class ScaleLmParams(ctypes.Structure):
    """K3-LM's parameters: a level's ``Ki`` holds R01 K0^-1 and its
    intrinsics are camera 1's."""

    _fields_ = [("lv", _Level * MAX_LEVELS), ("s_init", _P), ("out", _P), ("timers", _P),
                ("t01", _F * 3), ("huber", _F), ("coarse_cutoff", _F),
                ("sat_ratio_repeat", _F), ("cutoff_repeat_max", _F),
                ("lambda_init", _F), ("lambda_lim", _F), ("lambda_accept", _F),
                ("lambda_reject", _F), ("inc_break", _F), ("levels", _I),
                ("G", _I), ("per_seq", _I)]


class LmOut(NamedTuple):
    """Per candidate: the final pose, affine, per-level residual (K2), the
    two level-0 values (K2: flow_t, flow_rt; K4: E, n), and the passes run
    per level."""

    T: torch.Tensor          # [B, 4, 4]
    a: torch.Tensor          # [B]
    b: torch.Tensor          # [B]
    res: torch.Tensor        # [B, L]
    x0: torch.Tensor         # [B]
    x1: torch.Tensor         # [B]
    passes: torch.Tensor     # [B, L] (float counts)


class ScaleLmOut:
    """K3-LM's output rows [G, SCALE_OUT]: per guess the scale, the error
    sqrt(E/n) at level 0, level 0's E and n, and per level the
    cutoff-doubling factor, the passes the reference's loop runs and those
    the kernel ran (it skips a pass whose sums it holds). Each field is a
    view of the rows, made when it is read."""

    def __init__(self, rows: torch.Tensor, levels: int):
        self.rows, self.levels = rows, levels

    scale = property(lambda o: o.rows[:, 0])                          # [G]
    error = property(lambda o: o.rows[:, 1])                          # [G]
    E = property(lambda o: o.rows[:, 2])                              # [G]
    n = property(lambda o: o.rows[:, 3])                              # [G]
    repeat = property(lambda o: o.rows[:, _SOUT_REPEAT:_SOUT_REPEAT + o.levels])  # [G, L]
    passes = property(lambda o: o.rows[:, _SOUT_PASSES:_SOUT_PASSES + o.levels])  # [G, L]
    run = property(lambda o: o.rows[:, _SOUT_RUN:_SOUT_RUN + o.levels])           # [G, L]

    def __iter__(self):
        return iter((self.scale, self.error, self.E, self.n, self.repeat, self.passes,
                     self.run))


def slice_len(n: int) -> int:
    """Points per cluster block at a level (resident_lm.cu slice_len)."""
    per = (n + CLUSTER - 1) // CLUSTER
    return (per + 3) // 4 * 4


def _smem_bytes(points: int) -> int:
    """A block's shared memory for a level's points (resident_lm.cu
    smem_bytes: 17 bytes a point, 16-byte aligned)."""
    return (points * 17 + 15) // 16 * 16


def scale_smem(sizes) -> int:
    """K3-LM's dynamic shared memory a block for levels of ``sizes``
    points: every level's slice (resident_lm.cu scale_smem)."""
    return sum(_smem_bytes(slice_len(n)) for n in sizes)


def _scalar(x, dev) -> _Scalar:
    """A device scalar by address, a host number by value."""
    if isinstance(x, torch.Tensor):
        if x.device != dev or x.dtype != torch.float32 or x.numel() != 1:
            raise ValueError(f"scalar tensors must be one f32 value on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        return _Scalar(x.data_ptr(), 0.0)
    return _Scalar(None, float(x))


def _mask_u8(m: torch.Tensor) -> torch.Tensor:
    return m.view(torch.uint8) if m.dtype == torch.bool else m


@functools.lru_cache(maxsize=None)
def _level_matrix(intr, lvl: int, R01: Optional[Tuple[float, ...]] = None
                  ) -> Tuple[float, ...]:
    """A level's 3x3 matrix in f32, row-major: K^-1, or R01 K^-1 (R01 nine
    floats) as the plain scale loop forms it. Cached: the intrinsics and
    the extrinsics are fixed for a run, and forming them costs more host
    time than the launch."""
    M = np.asarray(intr.Ki(lvl), np.float32)
    if R01 is not None:
        M = np.asarray(R01, np.float32).reshape(3, 3) @ M
    return tuple(float(v) for v in M.reshape(9))


def _lm_scalars(p, cfg) -> None:
    """The LM's schedule, shared by both parameter structs."""
    tc = cfg.tracker
    p.huber = tc.huber_th
    p.coarse_cutoff = tc.coarse_cutoff_th
    p.sat_ratio_repeat = tc.saturated_ratio_repeat
    p.cutoff_repeat_max = tc.cutoff_repeat_max
    p.lambda_init = tc.lambda_init
    p.lambda_lim = tc.lambda_extrapolation_limit
    p.lambda_accept = tc.lambda_accept_factor
    p.lambda_reject = tc.lambda_reject_factor
    p.inc_break = tc.inc_break_norm


_PRECOND = tuple(float(v) for v in POSE_PRECOND)


def _schedule(p: LmParams, cfg) -> None:
    """K2-LM's / K4-LM's schedule, preconditioner and affine mode."""
    tc = cfg.tracker
    p.pre[:] = _PRECOND
    _lm_scalars(p, cfg)
    p.mode_a = tc.affine_mode_a
    p.mode_b = tc.affine_mode_b


def _batch(p: LmParams, T_inits: torch.Tensor, out: torch.Tensor, S: int = 1) -> None:
    B = T_inits.shape[0]
    if B % S:
        raise ValueError(f"a batch of {B} over {S} sequences")
    p.T_init = T_inits.data_ptr()
    p.out = out.data_ptr()
    p.B = B
    p.per_seq = B // S


def n_sequences(pyr) -> int:
    """The sequences a launch covers: 1 for levels [H, W, 3], S for
    stacked levels [S, H, W, 3]."""
    return pyr[0].shape[0] if pyr[0].dim() == 4 else 1


def _check_sequences(name: str, pyr, template) -> int:
    """One sequence (levels [H, W, 3], the template's lists [N]) or S
    stacked ones (levels [S, H, W, 3], lists [S, N]; every sequence has the
    same N per level, padding marked by pmask): returns S."""
    levels = template.levels
    S = n_sequences(pyr)
    img_dim, list_dim = (4, 2) if pyr[0].dim() == 4 else (3, 1)
    lists = [x for k in ("pu", "pv", "pid", "pcolor", "pmask") for x in getattr(template, k)]
    if any(x.dim() != img_dim or (img_dim == 4 and x.shape[0] != S) for x in pyr[:levels]) \
            or any(x.dim() != list_dim or (list_dim == 2 and x.shape[0] != S) for x in lists):
        raise ValueError(f"{name}: levels [H, W, 3] with lists [N], or [S, H, W, 3] with "
                         f"[S, N], got {[tuple(x.shape) for x in pyr[:levels]]} and "
                         f"{[tuple(x.shape) for x in template.pu]}")
    return S


def _level(p, lvl: int, img, p0, p1, p2, pcolor, color_stride: int,
           pmask, intr, max_iters: int, compute_flow: bool) -> None:
    """Level ``lvl`` of a launch on one sequence (img [H, W, 3], point
    lists [N]) or on S stacked sequences (img [S, H, W, 3], lists [S, N]):
    the strides between sequences are 0 for one."""
    L = p.lv[lvl]
    H, W = img.shape[-3], img.shape[-2]
    L.img, L.p0, L.p1, L.p2 = img.data_ptr(), p0.data_ptr(), p1.data_ptr(), p2.data_ptr()
    L.pcolor, L.pmask = pcolor.data_ptr(), pmask.data_ptr()
    L.H, L.W, L.umax, L.vmax = H, W, W - 1.001, H - 1.001
    L.N = p0.shape[-1]
    L.img_stride = H * W * 3 if img.dim() == 4 else 0
    L.pt_stride = L.N if p0.dim() == 2 else 0
    L.color_stride = color_stride
    L.fx, L.fy, L.cx, L.cy = intr.fx[lvl], intr.fy[lvl], intr.cx[lvl], intr.cy[lvl]
    L.Ki[:] = _level_matrix(intr, lvl)
    L.max_iters = max_iters
    L.compute_flow = int(compute_flow)


@functools.lru_cache(maxsize=None)
def _library() -> _cuda.KernelLibrary:
    """The kernel library, with the LM entry points' helpers typed and
    its ``LmParams`` and ``ScaleLmParams`` layouts checked against the
    mirrors above (once)."""
    kl = _cuda.load_library()
    kl.lib.dsslam_lm_max_active_clusters.argtypes = [_I, _I, _P]
    kl.lib.dsslam_lm_max_active_clusters.restype = _I
    for fn, struct in (("dsslam_lm_params_size", LmParams),
                       ("dsslam_scale_lm_params_size", ScaleLmParams)):
        getattr(kl.lib, fn).argtypes = []
        getattr(kl.lib, fn).restype = _I
        size = getattr(kl.lib, fn)()
        if size != ctypes.sizeof(struct):
            raise RuntimeError(f"{struct.__name__} is {size} bytes in {kl.path.name}, "
                               f"{ctypes.sizeof(struct)} in ctypes")
    return kl


def _timers(p: LmParams, timers: Optional[torch.Tensor], B: int, dev) -> None:
    if timers is None:
        return
    if (timers.device != dev or timers.dtype != torch.int64 or not timers.is_contiguous()
            or tuple(timers.shape) != (B, TIMER_WORDS)):
        raise ValueError(f"timers must be a contiguous int64 [{B}, {TIMER_WORDS}] tensor "
                         f"on {dev}, got {timers.dtype} {tuple(timers.shape)} on "
                         f"{timers.device}")
    p.timers = timers.data_ptr()


def timer_buffer(B: int, dev) -> torch.Tensor:
    """A phase-counter array for an LM kernel's call on B candidates,
    seeds or guesses."""
    return torch.zeros(B, TIMER_WORDS, dtype=torch.int64, device=dev)


def phase_breakdown(timers, passes, clock_mhz: float) -> dict:
    """The phase counters of one call (``timers`` [B, TIMER_WORDS], host
    or device; ``passes`` [B, L], the call's ``LmOut.passes``) converted at
    ``clock_mhz`` (the SM clock nvidia-smi reports beside the run; for
    K3-LM pass ``ScaleLmOut.run``, the passes it ran): per
    level and over the call, microseconds per pass (summed over the
    candidates, whose clusters run side by side) and each phase's share;
    ``run_us`` the mean of the candidates' whole runs, and ``kernel_mhz``
    the SM clock the kernel itself saw (cycles over %globaltimer)."""
    t = np.asarray(timers.cpu() if isinstance(timers, torch.Tensor) else timers, np.float64)
    n = np.asarray(passes.cpu() if isinstance(passes, torch.Tensor) else passes, np.float64)
    L = n.shape[1]
    cyc = t[:, :MAX_LEVELS * len(PHASES)].reshape(-1, MAX_LEVELS, len(PHASES))[:, :L].sum(0)
    shares = lambda c: {k: float(v / max(c.sum(), 1.0)) for k, v in zip(PHASES, c)}
    per_level = [dict(passes=float(n[:, l].sum()),
                      us_per_pass=float(cyc[l].sum() / clock_mhz / max(n[:, l].sum(), 1.0)),
                      shares=shares(cyc[l])) for l in range(L)]
    total = cyc.sum(0)
    run_cyc, run_ns = t[:, -2], t[:, -1]
    return dict(clock_mhz=clock_mhz, passes=float(n.sum()),
                us_per_pass=float(total.sum() / clock_mhz / max(n.sum(), 1.0)),
                shares=shares(total), phase_us=float(total.sum() / clock_mhz / t.shape[0]),
                run_us=float(run_cyc.mean() / clock_mhz),
                kernel_mhz=float(1e3 * run_cyc.sum() / max(run_ns.sum(), 1.0)),
                levels=per_level)


def _launch(name: str, p: LmParams, levels: int, out: torch.Tensor) -> LmOut:
    _library()
    _cuda.call(name, ctypes.addressof(p))
    B = out.shape[0]
    return LmOut(T=out[:, :16].reshape(B, 4, 4), a=out[:, _OUT_A], b=out[:, _OUT_B],
                 res=out[:, _OUT_RES:_OUT_RES + levels], x0=out[:, _OUT_X0],
                 x1=out[:, _OUT_X1], passes=out[:, _OUT_PASSES:_OUT_PASSES + levels])


def _max_iters(cfg, lvl: int) -> int:
    its = cfg.tracker.max_iterations
    return its[min(lvl, len(its) - 1)]


# K2-LM's struct for the last template: (template, intr, cfg, image
# shapes) and the struct with every field but the call's own
_track_proto: list = [None]


def _track_params(pyr_new, template, intr, cfg) -> LmParams:
    """K2-LM's parameter struct for a call on ``pyr_new``: the per-level
    part (the template's lists, the level's size, intrinsics, K^-1 and
    iterations) and the LM's schedule are built once per template (the
    front end's changes only at a keyframe), keyed on the template object
    as the front end keys its host views on the BA state, and copied per
    call; the call fills in the images."""
    levels = template.levels
    key = (template, intr, cfg, tuple(tuple(x.shape) for x in pyr_new[:levels]))
    hit = _track_proto[0]
    if hit is None or any(a is not b for a, b in zip(hit[0][:3], key[:3])) or hit[0][3] != key[3]:
        if levels > MAX_LEVELS:
            raise ValueError(f"track_lm: at most {MAX_LEVELS} levels, got {levels}")
        _check_sequences("track_lm", pyr_new, template)
        p = LmParams()
        for lvl in range(levels):
            pts = (template.pu[lvl], template.pv[lvl], template.pid[lvl],
                   template.pcolor[lvl], _mask_u8(template.pmask[lvl]))
            _cuda.require_cuda("track_lm", pyr_new[lvl], *pts)
            _level(p, lvl, pyr_new[lvl], *pts[:4], 1, pts[4], intr, _max_iters(cfg, lvl),
                   lvl == 0)
        _schedule(p, cfg)
        p.levels = levels
        p.chunk = max(slice_len(int(x.shape[-1])) for x in template.pu)
        hit = _track_proto[0] = (key, p)
    p = LmParams.from_buffer_copy(hit[1])
    for lvl in range(levels):
        p.lv[lvl].img = pyr_new[lvl].data_ptr()
    return p


def track_lm_cuda(pyr_new, template, intr, cfg, T_inits: torch.Tensor, aff_init,
                  ref_aff, ref_exposure, new_exposure,
                  timers: Optional[torch.Tensor] = None) -> LmOut:
    """Launch K2-LM for the candidate batch ``T_inits`` [B, 4, 4]: every
    level coarse to fine of ``models/tracker.track_candidates_batch``
    (before its gates). ``res`` is sqrt(E/n) per level (inf where no term
    survived), ``x0``/``x1`` level 0's flow_t and flow_rt. ``timers``
    (``timer_buffer(B)``) receives the phase counters.

    With stacked sequences (levels [S, H, W, 3], the template's lists
    [S, N]) the batch is S groups of B / S candidates, group s tracked on
    sequence s; the affine and exposure scalars are the launch's."""
    dev = pyr_new[0].device
    T_inits = T_inits.to(torch.float32).contiguous()
    _cuda.require_cuda("track_lm", *pyr_new[:template.levels], T_inits)
    B = T_inits.shape[0]
    out = torch.empty(B, OUT, dtype=torch.float32, device=dev)
    p = _track_params(pyr_new, template, intr, cfg)
    _batch(p, T_inits, out, n_sequences(pyr_new))
    p.aff_a0, p.aff_b0 = _scalar(aff_init.a, dev), _scalar(aff_init.b, dev)
    p.ref_a, p.ref_b = _scalar(ref_aff.a, dev), _scalar(ref_aff.b, dev)
    p.ref_exp, p.new_exp = _scalar(ref_exposure, dev), _scalar(new_exposure, dev)
    _timers(p, timers, B, dev)
    res = _launch("dsslam_track_lm", p, template.levels, out)
    track_lm_cuda.launches += 1
    return res


track_lm_cuda.launches = 0


def loop_pose_lm_cuda(pyr_cur, px, py, pz, pcolors, pmask, T_inits: torch.Tensor,
                      intr, cfg, ref_exposure=1.0, new_exposure=1.0,
                      timers: Optional[torch.Tensor] = None) -> LmOut:
    """Launch K4-LM for the seed stack ``T_inits`` [S, 4, 4] over the
    points ``px, py, pz`` [K] with per-level intensities ``pcolors``
    [K, L]: every level of ``loop/pose_estimator.estimate_seeds_plain``
    (before its gates). ``x0``/``x1`` are level 0's E and n. ``timers``
    (``timer_buffer(S)``) receives the phase counters."""
    levels = len(pyr_cur)
    if levels > MAX_LEVELS:
        raise ValueError(f"loop_pose_lm: at most {MAX_LEVELS} levels, got {levels}")
    dev = pyr_cur[0].device
    T_inits = T_inits.to(torch.float32).contiguous()
    S = T_inits.shape[0]
    pmask = _mask_u8(pmask)
    _cuda.require_cuda("loop_pose_lm", *pyr_cur, px, py, pz, pcolors, pmask, T_inits)
    if pcolors.dim() != 2 or pcolors.shape[1] < levels:
        raise ValueError(f"loop_pose_lm: pcolors must be [K, >= {levels}], "
                         f"got {tuple(pcolors.shape)}")
    out = torch.empty(S, OUT, dtype=torch.float32, device=dev)
    p = LmParams()
    stride = pcolors.shape[1]
    for lvl in range(levels):
        # the level's column: pcolors[i, lvl] at base + lvl + i * stride
        col = pcolors.reshape(-1)[lvl:]
        _level(p, lvl, pyr_cur[lvl], px, py, pz, col, stride, pmask, intr,
               _max_iters(cfg, lvl), False)
    _schedule(p, cfg)
    _batch(p, T_inits, out)
    zero = _Scalar(None, 0.0)
    p.aff_a0 = p.aff_b0 = p.ref_a = p.ref_b = zero
    p.ref_exp, p.new_exp = _scalar(ref_exposure, dev), _scalar(new_exposure, dev)
    _timers(p, timers, S, dev)
    p.levels = levels
    p.chunk = slice_len(px.shape[0])
    res = _launch("dsslam_loop_pose_lm", p, levels, out)
    loop_pose_lm_cuda.launches += 1
    return res


loop_pose_lm_cuda.launches = 0


def scale_lm_params(pyr1, template, scales0: torch.Tensor, intr0, intr1,
                    t_cam1_cam0, cfg, out: torch.Tensor) -> ScaleLmParams:
    """K3-LM's parameter struct for ``optimize_scale_batch``'s arguments,
    built afresh, without a launch: per level camera 1's image and
    intrinsics, the template's lists, ``R01 @ Ki0`` in f32 (as the plain
    loop forms it) and the level's LM iterations. ``t_cam1_cam0`` is read
    on the host."""
    levels = template.levels
    if levels > MAX_LEVELS:
        raise ValueError(f"scale_lm: at most {MAX_LEVELS} levels, got {levels}")
    _check_sequences("scale_lm", pyr1, template)
    T = np.asarray(t_cam1_cam0, np.float32)
    R01 = tuple(float(v) for v in T[:3, :3].reshape(9))
    p = ScaleLmParams()
    for lvl in range(levels):
        _level(p, lvl, pyr1[lvl], template.pu[lvl], template.pv[lvl],
               template.pid[lvl], template.pcolor[lvl], 1,
               _mask_u8(template.pmask[lvl]), intr1, _max_iters(cfg, lvl), False)
        p.lv[lvl].Ki[:] = _level_matrix(intr0, lvl, R01)
    p.t01[:] = [float(v) for v in T[:3, 3]]
    _lm_scalars(p, cfg)
    p.levels = levels
    _guesses(p, scales0, out, n_sequences(pyr1))
    return p


def _guesses(p: ScaleLmParams, scales0: torch.Tensor, out: torch.Tensor, S: int) -> None:
    G = scales0.shape[0]
    if G % S:
        raise ValueError(f"{G} guesses over {S} sequences")
    p.s_init = scales0.data_ptr()
    p.out = out.data_ptr()
    p.G = G
    p.per_seq = G // S


# K3-LM's struct for the last sizes, intrinsics, extrinsics and
# configuration: (key, struct), as _track_proto holds K2-LM's
_scale_proto: list = [None]
# the last template whose tensors were checked: (device, weak references
# to its tensors), so a freed template never matches and none is kept alive
_scale_checked: list = [None]


def _scale_params(pyr1, template, scales0: torch.Tensor, intr0, intr1, t_cam1_cam0,
                  cfg, out: torch.Tensor) -> ScaleLmParams:
    """``scale_lm_params`` for a call: a copy of a prototype, built once
    per image and template sizes, intrinsics, extrinsics and configuration
    (a run keeps all of them; the template changes every keyframe, so it
    is not part of the key), with the call's pointers filled in: the
    images, the template's lists, the guesses and the output."""
    levels = template.levels
    T = np.asarray(t_cam1_cam0, np.float32)
    key = (intr0, intr1, cfg, T.tobytes(), tuple(tuple(x.shape) for x in pyr1[:levels]),
           tuple(tuple(x.shape) for x in template.pu))
    hit = _scale_proto[0]
    if hit is None or any(a is not b for a, b in zip(hit[0][:3], key[:3])) or hit[0][3:] != key[3:]:
        hit = _scale_proto[0] = (key, scale_lm_params(pyr1, template, scales0, intr0, intr1,
                                                      t_cam1_cam0, cfg, out))
    p = ScaleLmParams.from_buffer_copy(hit[1])
    for lvl in range(levels):
        L = p.lv[lvl]
        L.img, L.p0, L.p1 = pyr1[lvl].data_ptr(), template.pu[lvl].data_ptr(), \
            template.pv[lvl].data_ptr()
        L.p2, L.pcolor = template.pid[lvl].data_ptr(), template.pcolor[lvl].data_ptr()
        L.pmask = template.pmask[lvl].data_ptr()
    _guesses(p, scales0, out, n_sequences(pyr1))
    return p


def _check_template(template, dev) -> None:
    """The template's lists are contiguous f32 (masks bool or uint8) on
    dev: checked once per template (a tensor's device, type and layout do
    not change)."""
    ts = [x for k in ("pu", "pv", "pid", "pcolor", "pmask") for x in getattr(template, k)]
    hit = _scale_checked[0]
    if hit is not None and hit[0] == dev and len(hit[1]) == len(ts) \
            and all(r() is t for r, t in zip(hit[1], ts)):
        return
    if any(t.device != dev for t in ts):
        raise ValueError(f"scale_lm: the template must be on {dev}")
    _cuda.require_cuda("scale_lm", *(_mask_u8(t) for t in ts))
    _scale_checked[0] = (dev, tuple(weakref.ref(t) for t in ts))


def scale_lm_cuda(pyr1, template, scales0, intr0, intr1, t_cam1_cam0,
                  cfg, timers: Optional[torch.Tensor] = None) -> ScaleLmOut:
    """Launch K3-LM for the guesses ``scales0`` [G]: every level coarse to
    fine of ``models/scale_opt.optimize_scale_batch``, the cutoff doubling,
    the 1-DoF LM and the one-shot level repeat, one 8-block cluster per
    guess. ``t_cam1_cam0`` is a host array, as the front end keeps it.
    ``timers`` (``timer_buffer(G)``) receives the phase counters. With
    stacked sequences (levels [S, H, W, 3], lists [S, N]) the guesses are
    S groups of G / S, group s optimized on sequence s."""
    dev = pyr1[0].device
    s0 = torch.as_tensor(scales0, dtype=torch.float32, device=dev).reshape(-1).contiguous()
    levels = template.levels
    if levels > MAX_LEVELS:
        raise ValueError(f"scale_lm: at most {MAX_LEVELS} levels, got {levels}")
    _cuda.require_cuda("scale_lm", *pyr1[:levels], s0)
    _check_template(template, dev)
    out = torch.empty(s0.shape[0], SCALE_OUT, dtype=torch.float32, device=dev)
    p = _scale_params(pyr1, template, s0, intr0, intr1, t_cam1_cam0, cfg, out)
    _timers(p, timers, s0.shape[0], dev)
    _library()
    _cuda.call("dsslam_scale_lm", ctypes.addressof(p))
    scale_lm_cuda.launches += 1
    return ScaleLmOut(out, levels)


scale_lm_cuda.launches = 0


def lm_solve_cuda(H: torch.Tensor, g: torch.Tensor, lam: torch.Tensor, mode_a: float,
                  mode_b: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2-LM's and K4-LM's damped solve (``damped_solve`` in
    ``resident_lm.cu``) on a batch of systems, one thread each, for tests:
    H [n, 8, 8], g [n, 8], lam [n] -> the increment [n, 8] (as
    ``models/tracker._solve_inc``) and the pivot row of each column [n, 8]
    (int32, -1 past the affine mode's sub-block)."""
    H, g, lam = (x.to(torch.float32).contiguous() for x in (H, g, lam))
    _cuda.require_cuda("lm_solve", H, g, lam)
    n = H.shape[0]
    if tuple(H.shape) != (n, 8, 8) or tuple(g.shape) != (n, 8) or tuple(lam.shape) != (n,):
        raise ValueError(f"lm_solve: H [n, 8, 8], g [n, 8], lam [n], got "
                         f"{tuple(H.shape)}, {tuple(g.shape)}, {tuple(lam.shape)}")
    inc = torch.empty(n, 8, dtype=torch.float32, device=H.device)
    piv = torch.empty(n, 8, dtype=torch.int32, device=H.device)
    _library()
    _cuda.call("dsslam_lm_solve", H.data_ptr(), g.data_ptr(), lam.data_ptr(), float(mode_a),
               float(mode_b), n, inc.data_ptr(), piv.data_ptr())
    return inc, piv


def max_active_clusters(kind: str, n_points: int) -> int:
    """How many 8-block clusters of an LM kernel (``kind`` "track": K2-LM,
    "loop_pose": K4-LM, for levels of up to ``n_points`` points; "scale":
    K3-LM, for a template of one level of ``n_points``) the card holds at
    once."""
    if kind == "scale":
        return scale_max_active_clusters((n_points,))
    return _max_active_clusters(KINDS[kind], _smem_bytes(slice_len(n_points)))


def scale_max_active_clusters(sizes) -> int:
    """How many 8-block clusters of K3-LM the card holds at once for a
    template of levels of ``sizes`` points (a block holds every level's
    slice)."""
    return _max_active_clusters(KINDS["scale"], scale_smem(sizes))


def _max_active_clusters(kind: int, smem: int) -> int:
    out = ctypes.c_int(0)
    kl = _library()
    err = kl.lib.dsslam_lm_max_active_clusters(kind, smem, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: CUDA error {err}: "
                           f"{kl.lib.dsslam_error_string(err).decode()}")
    return out.value
