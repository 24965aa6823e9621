"""Launch wrappers of the windowed BA's kernels (``csrc/ba.cu``):
``dsslam_ba_optimize``, optimize_keyframe's whole LM loop and its
bookkeeping in one resident launch; K9 ``dsslam_ba_linearize``, the
linearization of a state; K10 ``dsslam_ba_step``, the LM step and the
candidate state; K11 ``dsslam_ba_accept``, the accept / reject of the
candidate (K10 and K11 queued: the resident launch's bit reference). None
reads the card from the host.

Every entry point reads one parameter block (``BaParams``, the C struct
field for field): the window's constant inputs, the state and the
linearization as up to three buffers each (the current one, the
candidate, and the resident launch's output), and a control pair
``ctrl_i`` = (cur, done, converged, rounds run), ``ctrl_f`` = (lam, e_old)
on the card. ``models/ba.py`` calls them for CUDA states (``linearize``;
``optimize_keyframe`` through ``_optimize_device``); for CPU states it
takes the plain versions there. Each wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _cuda

_P = ctypes.c_void_p
_P3 = ctypes.c_void_p * 3

# csrc/ba.cu's scratch: floats per reduced (host, target) block (its 230
# entries, energy, good pairs) and per (point, target) (G20, Hdd, bd); the
# resident launch's Schur partials per rank (kSchurFloats + 4, 16 ranks),
# then the prior part of an energy
HE, G = 232, 22
SCHUR_STRIDE, MAX_RANKS = 1984, 16


class BaParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("W", "NP", "Himg", "Wimg")] + \
        [(n, ctypes.c_float) for n in ("umax", "vmax", "u_hi", "v_hi", "huber", "calib_h",
                                        "a_prior", "b_prior", "th_a", "th_b", "th_r", "th_t")] + \
        [(n, ctypes.c_int) for n in ("min_opt_iterations", "force_accept")] + \
        [(n, _P) for n in ("images", "T_zero", "aff_zero", "exposure", "energy_th",
                           "calib_zero", "frame_valid", "frame_id", "HM", "bM", "p_valid",
                           "p_host", "p_u", "p_v", "p_idepth_zero", "p_color", "p_weight",
                           "p_prior", "p_res_good", "precond", "pat_u", "pat_v",
                           "host_pts", "host_off", "p_num_good", "p_last_res")] + \
        [(n, _P3) for n in ("calib_delta", "delta", "idepth", "Hff", "bf", "Hfd", "Hdd", "bd",
                            "energy", "num_terms", "pair_energy", "pair_good", "pair_in")] + \
        [(n, _P) for n in ("ctrl_i", "ctrl_f", "lin_part", "pt_part", "x", "x_d", "chunk_part",
                           "schur_part", "out_num_good", "out_last_res", "out_rmse", "out_ok",
                           "timers")]


STATE_FIELDS = ("calib_delta", "delta", "p_idepth")
LIN_FIELDS = ("Hff", "bf", "Hfd", "Hdd", "bd", "energy", "num_terms", "pair_energy",
              "pair_good", "pair_in")
_INPUTS = ("images", "T_zero", "aff_zero", "exposure", "energy_th", "calib_zero",
           "frame_valid", "frame_id", "HM", "bM", "p_valid", "p_host", "p_u", "p_v",
           "p_idepth_zero", "p_color", "p_weight", "p_prior", "p_res_good", "p_num_good",
           "p_last_res")
_DTYPES = {"frame_valid": torch.bool, "p_valid": torch.bool, "p_res_good": torch.bool,
           "frame_id": torch.int32, "p_host": torch.int64, "p_last_res": torch.int32}


def _f32(x) -> float:
    """A Python number rounded to f32, as a float32 tensor compares with it."""
    return float(torch.tensor(x, dtype=torch.float32))


class Buffers(NamedTuple):
    """The card-side arrays one parameter block points at (kept alive with
    it): the states [n, ...], the linearizations [n, ...], the control pair,
    the scratch and the resident launch's bookkeeping outputs (``out``:
    num_good [NP], last_res [NP, 2], rmse and ok 0-dim; empty for the
    queued entry points)."""

    inputs: tuple
    state: dict
    lin: dict
    ctrl_i: torch.Tensor
    ctrl_f: torch.Tensor
    scratch: dict
    out: dict


class Params(NamedTuple):
    struct: BaParams
    bufs: Buffers


# phase stamps (csrc/ba.cu, BaParams::timers): K9's pixel pass LIN_STAMPS
# per block of an [8, 8, 8] (host, target, chunk) grid, then K10's
# STEP_STAMPS per cluster rank (at most 16), then 5 counters of K10's solve,
# K9's second launch's stamps, then the resident launch's OPT_STAMPS (block
# 0's ns in each phase, at the grid barriers, their count, the span)
LIN_STAMPS, STEP_STAMPS, CHUNKS = 8, 10, 8
_LIN_WORDS = 8 * 8 * CHUNKS * LIN_STAMPS
_STEP_WORDS = 16 * STEP_STAMPS
OPT_STAMPS = ("pixel", "reduce", "finish", "schur", "solve", "backsub", "epilogue", "barrier",
              "barriers", "total")


_FIN_BLOCKS = 1024
_OPT_BASE = _LIN_WORDS + _STEP_WORDS + 8 + 2 * _FIN_BLOCKS


def timer_buffer(dev) -> torch.Tensor:
    """A zeroed buffer for ``Params.struct.timers`` (null on the main
    path)."""
    return torch.zeros(_OPT_BASE + len(OPT_STAMPS), dtype=torch.int64, device=dev)


def optimize_phases(timers: torch.Tensor, rounds: int) -> dict:
    """One resident launch's stamps (``timer_buffer``): block 0's us in
    each phase per LM round (the first linearization and the bookkeeping
    once), the us it waited at grid barriers per round, the barriers per
    round and the launch's span (us)."""
    t = dict(zip(OPT_STAMPS, timers[_OPT_BASE:].tolist()))
    per = max(int(rounds), 1)
    out = {k: t[k] / 1e3 / per for k in OPT_STAMPS[:-3] + ("barrier",)}
    out.update(barriers=t["barriers"], span_us=t["total"] / 1e3, rounds=int(rounds))
    return out


def phase_us(timers: torch.Tensor, W: int, clock_mhz: float, fin_split: int = 0) -> dict:
    """One K9 and one K10 call's stamps. K9's pixel pass: its span (the
    first block's start to the last block's end, us), per block the
    set-up, the rounds and the end (mean and largest, us), and thread 0's
    us per round in the warp and sample, the compaction and the products
    (at ``clock_mhz``); K9's second launch: the span and the longest
    block of its assembly blocks (the first ``fin_split``) and of its row
    blocks. K10: its span, each rank's copy and Schur sums, and
    rank 0's barrier, reduction and assembly, solve, projection and push,
    second barrier and back-substitution (us); the solve's cycles per
    pivot step by part (the pivot key's row, the barrier, the factor,
    the next column and its warp max, the rest of the row)."""
    t = timers.cpu().numpy().astype("float64")
    lin = t[:_LIN_WORDS].reshape(8, 8, CHUNKS, LIN_STAMPS)[:W, :W].reshape(-1, LIN_STAMPS)
    lin = lin[lin[:, 0] > 0]
    d = (lin[:, 1:4] - lin[:, 0:3]) / 1e3
    rounds = max(float(lin[:, 7].sum()), 1.0)
    per_round = {k: float(lin[:, 4 + i].sum() / rounds / clock_mhz)
                 for i, k in enumerate(("warp_sample", "compaction", "products"))}
    step = t[_LIN_WORDS:_LIN_WORDS + _STEP_WORDS].reshape(16, STEP_STAMPS)
    step = step[step[:, 0] > 0]
    us = lambda a, b: (step[:, b] - step[:, a]) / 1e3
    order = (0, 8, 1, 2, 3, 4, 5, 6, 7)
    names = ("copy", "schur", "barrier", "reduce_assemble", "solve", "project_push",
             "barrier2", "backsub")
    gj = t[_LIN_WORDS + _STEP_WORDS:_LIN_WORDS + _STEP_WORDS + 5]
    fin = t[_LIN_WORDS + _STEP_WORDS + 8:_OPT_BASE].reshape(_FIN_BLOCKS, 2)
    fin_parts = {}
    for name, part in (("assembly", fin[:fin_split]), ("rows", fin[fin_split:])):
        part = part[part[:, 0] > 0]
        if len(part):
            fin_parts[name] = {"blocks": int(len(part)),
                               "span": float((part[:, 1].max() - part[:, 0].min()) / 1e3),
                               "block_max": float((part[:, 1] - part[:, 0]).max() / 1e3)}
    if len(fin[fin[:, 0] > 0]):
        live = fin[fin[:, 0] > 0]
        fin_parts["span"] = float((live[:, 1].max() - live[:, 0].min()) / 1e3)
    n_steps = max(8 * W - 4, 1)
    return {"K9_pixel_pass": {
                "span": float((lin[:, 3].max() - lin[:, 0].min()) / 1e3),
                "blocks": int(len(lin)), "rounds": int(rounds),
                "rounds_largest_block": int(lin[:, 7].max()),
                **{k: {"mean": float(d[:, i].mean()), "max": float(d[:, i].max())}
                   for i, k in enumerate(("setup", "rounds", "end"))},
                "us_per_round": per_round},
            "K9_finish": fin_parts,
            "K10": {"span": float((step[:, 7].max() - step[:, 0].min()) / 1e3),
                    "ranks": int(len(step)),
                    "copy_max": float(us(0, 8).max()), "schur_max": float(us(8, 1).max()),
                    "rank0": {k: float(us(a, b)[0]) for k, a, b in
                              zip(names, order[:-1], order[1:])},
                    "solve_cycles_per_step": {k: float(v / n_steps) for k, v in zip(
                        ("key_row", "barrier", "factor", "next_key", "elimination"), gj)}}}


def host_groups(p_host: torch.Tensor, W: int):
    """The points grouped by host for K9: (pts [NP] int32, off [W + 1]
    int32), host s's points pts[off[s]:off[s + 1]] in ascending index. A
    stable sort and a count per host on the tensors' device: no atomics,
    no host read."""
    pts = torch.sort(p_host, stable=True).indices.to(torch.int32)
    hosts = torch.arange(W, device=p_host.device)
    counts = (p_host[None, :] == hosts[:, None]).sum(1)
    off = torch.cat([torch.zeros(1, dtype=counts.dtype, device=p_host.device),
                     torch.cumsum(counts, 0)]).to(torch.int32)
    return pts.contiguous(), off


def empty_lin(n: int, NP: int, W: int, dev) -> dict:
    D = 4 + 8 * W
    f = dict(dtype=torch.float32, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    return {"Hff": torch.empty(n, D, D, **f), "bf": torch.empty(n, D, **f),
            "Hfd": torch.empty(n, NP, D, **f), "Hdd": torch.empty(n, NP, **f),
            "bd": torch.empty(n, NP, **f), "energy": torch.empty(n, **f),
            "num_terms": torch.empty(n, **f), "pair_energy": torch.empty(n, NP, W, **f),
            "pair_good": torch.empty(n, NP, W, **b), "pair_in": torch.empty(n, NP, W, **b)}


def make_params(state, cfg, states=None, lins=None, resident: bool = False) -> Params:
    """The parameter block of a window: ``states`` holds the buffers of
    each state field ([n, ...] tensors, n <= 3; default: the state's own
    tensors as buffer 0 alone), ``lins`` the linearization's (default: new
    [1, ...] outputs). ``resident``: with the resident launch's scratch and
    bookkeeping outputs. Checks every tensor (one CUDA device, its dtype,
    contiguous)."""
    W, NP = state.num_slots, state.num_points
    D = 4 + 8 * W
    if not 1 <= W <= 8:
        raise ValueError(f"ba kernels: {W} slots (1 to 8 supported)")
    dev = state.images.device
    inputs = tuple(getattr(state, name).contiguous() for name in _INPUTS)
    # the preconditioner and the pattern as the plain version builds them
    from ..models.ba import _pattern, _precond
    consts = (_precond(W, dev),) + _pattern(dev)
    if states is None:
        states = {f: getattr(state, f).contiguous()[None] for f in STATE_FIELDS}
    if lins is None:
        lins = empty_lin(1, NP, W, dev)
    consts += host_groups(state.p_host, W)
    f = dict(dtype=torch.float32, device=dev)
    scratch = {"lin_part": torch.empty(W * W * (HE + 1), **f),
               "pt_part": torch.empty(NP * W * G, **f),
               "x": torch.empty(D, **f), "x_d": torch.empty(NP, **f)}
    out = {}
    if resident:
        scratch.update(chunk_part=torch.empty(W * W * CHUNKS * HE, **f),
                       schur_part=torch.empty(MAX_RANKS * SCHUR_STRIDE + 4, **f))
        out = {"num_good": torch.empty(NP, **f),
               "last_res": torch.empty(NP, 2, dtype=torch.int32, device=dev),
               "rmse": torch.empty((), **f), "ok": torch.empty((), dtype=torch.bool, device=dev)}
    ctrl_i = torch.zeros(4, dtype=torch.int32, device=dev)
    ctrl_f = torch.zeros(2, **f)
    for name, t in zip(_INPUTS, inputs):
        want = _DTYPES.get(name, torch.float32)
        if t.dtype != want:
            raise TypeError(f"ba kernels: {name} must be {want}, got {t.dtype}")
    everything = (inputs + consts + tuple(states.values()) + tuple(lins.values())
                  + tuple(scratch.values()) + tuple(out.values()) + (ctrl_i, ctrl_f))
    _cuda.require_cuda("ba", *everything,
                       dtypes=(torch.float32, torch.bool, torch.int32, torch.int64))

    ba = cfg.ba
    mode_a, mode_b = cfg.tracker.affine_mode_a, cfg.tracker.affine_mode_b
    th = ba.th_opt_iterations
    Himg, Wimg = state.images.shape[1], state.images.shape[2]
    s = BaParams(W=W, NP=NP, Himg=Himg, Wimg=Wimg,
                 umax=_f32(Wimg - 1.001), vmax=_f32(Himg - 1.001),
                 u_hi=_f32(Wimg - 2.1), v_hi=_f32(Himg - 2.1), huber=_f32(ba.huber_th),
                 calib_h=_f32(ba.initial_calib_hessian),
                 a_prior=_f32(ba.initial_aff_a_prior if mode_a < 0 else float(mode_a)),
                 b_prior=_f32(ba.initial_aff_b_prior if mode_b < 0 else float(mode_b)),
                 th_a=_f32(0.0005 * th), th_b=_f32(0.00005 * th),
                 th_r=_f32(0.00005 * th), th_t=_f32(0.00005 * th),
                 min_opt_iterations=ba.min_opt_iterations,
                 force_accept=int(bool(ba.solver_force_accept_step)))
    if any(t.data_ptr() % 16 for t in (lins["Hfd"][0], lins["Hfd"][-1])):
        raise ValueError("ba kernels: Hfd's buffers must be 16-byte aligned")
    for name, t in zip(_INPUTS + ("precond", "pat_u", "pat_v", "host_pts", "host_off"),
                       inputs + consts):
        setattr(s, name, t.data_ptr())
    # buffers 0, 1, 2 (a buffer that is not there: the last one)
    bufs = lambda t: _P3(*(t[min(k, t.shape[0] - 1)].data_ptr() for k in range(3)))
    s.calib_delta = bufs(states["calib_delta"])
    s.delta = bufs(states["delta"])
    s.idepth = bufs(states["p_idepth"])
    for name in LIN_FIELDS:
        setattr(s, name, bufs(lins[name]))
    s.ctrl_i, s.ctrl_f = ctrl_i.data_ptr(), ctrl_f.data_ptr()
    s.timers = None
    for name, t in scratch.items():
        setattr(s, name, t.data_ptr())
    for name, t in out.items():
        setattr(s, "out_" + name, t.data_ptr())
    return Params(s, Buffers(inputs + consts, states, lins, ctrl_i, ctrl_f, scratch, out))


def optimize_params(state, cfg) -> Params:
    """The resident launch's parameter block: three buffers of the state
    (buffer 0 a copy of ``state``'s) and of the linearization, the scratch
    and the bookkeeping outputs."""
    states = {f: torch.stack([getattr(state, f)] * 3) for f in STATE_FIELDS}
    lins = empty_lin(3, state.num_points, state.num_slots, state.images.device)
    return make_params(state, cfg, states, lins, resident=True)


def ba_optimize_cuda(params: Params, iterations: int) -> None:
    """The resident launch: optimize_keyframe's whole LM loop (K9, K11's
    start, up to ``iterations`` rounds of K10 -> K9 -> K11) and its
    bookkeeping from state buffer 0 of ``params`` (``optimize_params``): the
    accepted state and linearization in buffer 2, ``params.bufs.out``, and
    the final control (ctrl_i = cur, done, converged, rounds run)."""
    _cuda.call("dsslam_ba_optimize", ctypes.addressof(params.struct), int(iterations))
    ba_optimize_cuda.launches += 1


ba_optimize_cuda.launches = 0


def optimize_grid(W: int, NP: int) -> dict:
    """The resident launch at these sizes: blocks, blocks an SM, registers,
    dynamic shared memory bytes, K10's ranks, local (spill) bytes a thread
    (host calls only)."""
    out = (ctypes.c_int * 6)()
    err = _cuda.load_library().lib.dsslam_ba_optimize_grid(int(W), int(NP), out)
    if err != 0:
        raise RuntimeError(f"dsslam_ba_optimize_grid: CUDA error {err}")
    return dict(zip(("blocks", "blocks_per_sm", "registers", "smem", "ranks", "local_bytes"),
                    list(out)))


def ba_linearize_cuda(params: Params, mode: int = 0) -> None:
    """K9: linearize state buffer cur (mode 0) or the candidate 1 - cur
    (mode 1; nothing once done) into the linearization buffer of the same
    index."""
    _cuda.call("dsslam_ba_linearize", ctypes.addressof(params.struct), int(mode))
    ba_linearize_cuda.launches += 1


ba_linearize_cuda.launches = 0


def ba_step_cuda(params: Params) -> None:
    """K10: the LM step from buffer cur at lambda ctrl_f[0]: x, x_d, the
    convergence flag ctrl_i[2] and the candidate state in buffer 1 - cur
    (nothing once done)."""
    _cuda.call("dsslam_ba_step", ctypes.addressof(params.struct))
    ba_step_cuda.launches += 1


ba_step_cuda.launches = 0


def ba_accept_cuda(params: Params, it: int) -> None:
    """K11: ``it`` < 0: lam = 0.1 and e_old = the total energy of buffer
    cur; else the accept / reject of iteration ``it``'s candidate (nothing
    once done)."""
    _cuda.call("dsslam_ba_accept", ctypes.addressof(params.struct), int(it))
    ba_accept_cuda.launches += 1


ba_accept_cuda.launches = 0


def pick(buf: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """buf[cur] for a device index (no host read)."""
    return torch.index_select(buf, 0, cur)[0]
