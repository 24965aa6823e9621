"""Launch wrappers of the windowed BA's kernels (``csrc/ba.cu``): K9
``dsslam_ba_linearize``, the linearization of a state; K10
``dsslam_ba_step``, the LM step and the candidate state; K11
``dsslam_ba_accept``, the accept / reject of the candidate. None reads the
card from the host.

Every entry point reads one parameter block (``BaParams``, the C struct
field for field): the window's constant inputs, the state and the
linearization as two buffers each (the current one and the candidate),
and a control pair ``ctrl_i`` = (cur, done, converged), ``ctrl_f`` =
(lam, e_old) on the card. ``models/ba.py`` calls them for CUDA states
(``linearize``; ``optimize_keyframe`` through ``_optimize_loop_device``); for CPU
states it takes the plain versions there. Each wrapper counts its
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _cuda

_P = ctypes.c_void_p
_P2 = ctypes.c_void_p * 2

# csrc/ba.cu's tiles: points per block of K9's first launch, per block of
# K10's Schur sums; floats per (s, t) block and per (point, target)
LIN_TILE, SCHUR_TILE, HE, G = 128, 64, 232, 22


class BaParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("W", "NP", "Himg", "Wimg")] + \
        [(n, ctypes.c_float) for n in ("umax", "vmax", "u_hi", "v_hi", "huber", "calib_h",
                                        "a_prior", "b_prior", "th_a", "th_b", "th_r", "th_t")] + \
        [(n, ctypes.c_int) for n in ("min_opt_iterations", "force_accept")] + \
        [(n, _P) for n in ("images", "T_zero", "aff_zero", "exposure", "energy_th",
                           "calib_zero", "frame_valid", "frame_id", "HM", "bM", "p_valid",
                           "p_host", "p_u", "p_v", "p_idepth_zero", "p_color", "p_weight",
                           "p_prior", "p_res_good", "precond", "pat_u", "pat_v")] + \
        [(n, _P2) for n in ("calib_delta", "delta", "idepth", "Hff", "bf", "Hfd", "Hdd", "bd",
                            "energy", "num_terms", "pair_energy", "pair_good", "pair_in")] + \
        [(n, _P) for n in ("ctrl_i", "ctrl_f", "lin_part", "pt_part", "sc_part", "inv_hdd",
                           "x", "x_d")]


STATE_FIELDS = ("calib_delta", "delta", "p_idepth")
LIN_FIELDS = ("Hff", "bf", "Hfd", "Hdd", "bd", "energy", "num_terms", "pair_energy",
              "pair_good", "pair_in")
_INPUTS = ("images", "T_zero", "aff_zero", "exposure", "energy_th", "calib_zero",
           "frame_valid", "frame_id", "HM", "bM", "p_valid", "p_host", "p_u", "p_v",
           "p_idepth_zero", "p_color", "p_weight", "p_prior", "p_res_good")
_DTYPES = {"frame_valid": torch.bool, "p_valid": torch.bool, "p_res_good": torch.bool,
           "frame_id": torch.int32, "p_host": torch.int64}


def _f32(x) -> float:
    """A Python number rounded to f32, as a float32 tensor compares with it."""
    return float(torch.tensor(x, dtype=torch.float32))


class Buffers(NamedTuple):
    """The card-side arrays one parameter block points at (kept alive with
    it): the two states [2, ...], the two linearizations [2, ...], the
    control pair and the scratch."""

    inputs: tuple
    state: dict
    lin: dict
    ctrl_i: torch.Tensor
    ctrl_f: torch.Tensor
    scratch: dict


class Params(NamedTuple):
    struct: BaParams
    bufs: Buffers


def empty_lin(n: int, NP: int, W: int, dev) -> dict:
    D = 4 + 8 * W
    f = dict(dtype=torch.float32, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    return {"Hff": torch.empty(n, D, D, **f), "bf": torch.empty(n, D, **f),
            "Hfd": torch.empty(n, NP, D, **f), "Hdd": torch.empty(n, NP, **f),
            "bd": torch.empty(n, NP, **f), "energy": torch.empty(n, **f),
            "num_terms": torch.empty(n, **f), "pair_energy": torch.empty(n, NP, W, **f),
            "pair_good": torch.empty(n, NP, W, **b), "pair_in": torch.empty(n, NP, W, **b)}


def make_params(state, cfg, states=None, lins=None) -> Params:
    """The parameter block of a window: ``states`` / ``lins`` hold the two
    buffers of each state field ([2, ...] tensors; default: the state's
    own tensors as buffer 0 and no buffer 1), ``lins`` the linearization's
    (default: new [1, ...] outputs). Checks every tensor (one CUDA device,
    its dtype, contiguous)."""
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
    ntiles = (NP + LIN_TILE - 1) // LIN_TILE
    nschur = (NP + SCHUR_TILE - 1) // SCHUR_TILE
    U = D * (D + 1) // 2
    f = dict(dtype=torch.float32, device=dev)
    scratch = {"lin_part": torch.empty(ntiles * W * (W * HE + 2), **f),
               "pt_part": torch.empty(NP * W * G, **f),
               "sc_part": torch.empty(nschur * (U + D + 2), **f),
               "inv_hdd": torch.empty(NP, **f), "x": torch.empty(D, **f),
               "x_d": torch.empty(NP, **f)}
    ctrl_i = torch.zeros(3, dtype=torch.int32, device=dev)
    ctrl_f = torch.zeros(2, **f)
    for name, t in zip(_INPUTS, inputs):
        want = _DTYPES.get(name, torch.float32)
        if t.dtype != want:
            raise TypeError(f"ba kernels: {name} must be {want}, got {t.dtype}")
    everything = (inputs + consts + tuple(states.values()) + tuple(lins.values())
                  + tuple(scratch.values()) + (ctrl_i, ctrl_f))
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
    for name, t in zip(_INPUTS + ("precond", "pat_u", "pat_v"), inputs + consts):
        setattr(s, name, t.data_ptr())
    pair = lambda t: _P2(t[0].data_ptr(), t[t.shape[0] - 1].data_ptr())
    s.calib_delta = pair(states["calib_delta"])
    s.delta = pair(states["delta"])
    s.idepth = pair(states["p_idepth"])
    for name in LIN_FIELDS:
        setattr(s, name, pair(lins[name]))
    s.ctrl_i, s.ctrl_f = ctrl_i.data_ptr(), ctrl_f.data_ptr()
    for name, t in scratch.items():
        setattr(s, name, t.data_ptr())
    return Params(s, Buffers(inputs + consts, states, lins, ctrl_i, ctrl_f, scratch))


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
