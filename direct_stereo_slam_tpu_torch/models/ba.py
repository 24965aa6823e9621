"""Windowed photometric bundle adjustment (port of models/ba.py).

Sliding window of up to W keyframe slots x a pool of NP active points,
8-pixel-pattern photometric residuals between every (point, target-frame)
pair, Gauss-Newton with first-estimate Jacobians, closed-form Schur
complement over inverse depths, quadratic marginalization prior (HM, bM),
percentile energy thresholds, and exact gauge handling (anchor-frame
elimination + scale-direction projection). Layout and deviations from DSO
are the reference's; see its module docstring.

Frame states: worldToCam FEJ pose ``T_zero`` and additive tangent
``delta`` [W, 8] = (trans3, rot3, aff_a, aff_b); frame-parameter vector of
dimension ``D = 4 + 8 W`` (calib first). In this port the per-point
(host, target) transforms are a plain index (the reference's one-hot
einsum was a TPU gather workaround), and the 20-column per-pair blocks
are placed into the D x D system by index.

On the card the linearization and the LM loop are the hand-written
kernels of ``csrc/ba.cu`` (``ops/ba.py``): K9 ``linearize``, and the LM
loop one resident launch (K10 the step -> K9 at the candidate -> K11 the
accept or reject, with no host read); sums in a fixed order, so two runs
give the same bits. The programs around it are ``csrc/window.cu``'s
(``ops/window.py``): K16 the window's poses (``current_views``,
``template_pose_prep``), K17 ``optimize_keyframe``'s compaction before the
launch and its threshold, FEJ reset, drop and scatter after it, K18 the
keyframe tail's marginalization (``marginalize``). For a CPU state the
plain versions run: ``linearize_plain``, ``_optimize_loop_plain`` (a Python
loop with one read of its exit condition per iteration),
``optimize_keyframe_plain``, ``marginalize_plain`` (its small dense solves
and Schur products on ``torch.linalg`` and matmuls) and
``ops/window.py::window_pose_plain``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import (PATTERN_OFFSETS, SCALE_A, SCALE_B, SCALE_C, SCALE_F,
                      SCALE_XI_ROT, SCALE_XI_TRANS, SLAMConfig)
from ..geometry import lie
from ..ops import ba as kb
from ..ops import window as win
from ..ops.interp import bilinear_gather_frames
from ..utils.device import constant, to_device

RES_IN = 0
RES_OOB = 1
RES_OUTLIER = 2
RES_NONE = 3


class BAState(NamedTuple):
    frame_valid: torch.Tensor     # [W] bool
    frame_id: torch.Tensor        # [W] int32 global KF id (-1 = empty)
    T_zero: torch.Tensor          # [W, 4, 4] worldToCam at FEJ point
    delta: torch.Tensor           # [W, 8] additive state (t3, r3, a, b)
    aff_zero: torch.Tensor        # [W, 2]
    exposure: torch.Tensor        # [W]
    images: torch.Tensor          # [W, H, W0, 3] level-0 (I, dx, dy)
    energy_th: torch.Tensor       # [W]
    calib_zero: torch.Tensor      # [4] fx fy cx cy at FEJ
    calib_delta: torch.Tensor     # [4]
    p_valid: torch.Tensor         # [NP] bool
    p_host: torch.Tensor          # [NP] int64 frame slot
    p_u: torch.Tensor
    p_v: torch.Tensor
    p_idepth: torch.Tensor
    p_idepth_zero: torch.Tensor
    p_color: torch.Tensor         # [NP, 8]
    p_weight: torch.Tensor        # [NP, 8]
    p_prior: torch.Tensor         # [NP]
    p_res_good: torch.Tensor      # [NP, W] bool
    p_num_good: torch.Tensor      # [NP] f32 lifetime good-residual count
    p_last_res: torch.Tensor      # [NP, 2] int32 RES_*
    HM: torch.Tensor              # [D, D]
    bM: torch.Tensor              # [D]

    @property
    def num_slots(self) -> int:
        return self.frame_valid.shape[0]

    @property
    def num_points(self) -> int:
        return self.p_valid.shape[0]

    def T_current(self) -> torch.Tensor:
        """[W, 4, 4] current worldToCam = exp(delta) @ T_zero, in K16's
        operation order (``ops/window.py::current_poses_plain``)."""
        return win.current_poses_plain(self.T_zero, self.delta)

    def aff_current(self) -> torch.Tensor:
        return self.aff_zero + self.delta[:, 6:8]

    def calib_current(self) -> torch.Tensor:
        return self.calib_zero + self.calib_delta


def empty_state(n_slots: int, n_points: int, h: int, w: int, calib,
                device="cpu") -> BAState:
    D = 4 + 8 * n_slots
    f32 = dict(dtype=torch.float32, device=device)
    return BAState(
        frame_valid=torch.zeros(n_slots, dtype=torch.bool, device=device),
        frame_id=torch.full((n_slots,), -1, dtype=torch.int32, device=device),
        T_zero=torch.eye(4, **f32).expand(n_slots, 4, 4).clone(),
        delta=torch.zeros(n_slots, 8, **f32),
        aff_zero=torch.zeros(n_slots, 2, **f32),
        exposure=torch.ones(n_slots, **f32),
        images=torch.zeros(n_slots, h, w, 3, **f32),
        energy_th=torch.full((n_slots,), 12.0 * 12.0 * 8.0, **f32),
        calib_zero=torch.as_tensor(calib, **f32),
        calib_delta=torch.zeros(4, **f32),
        p_valid=torch.zeros(n_points, dtype=torch.bool, device=device),
        p_host=torch.zeros(n_points, dtype=torch.int64, device=device),
        p_u=torch.zeros(n_points, **f32),
        p_v=torch.zeros(n_points, **f32),
        p_idepth=torch.ones(n_points, **f32),
        p_idepth_zero=torch.ones(n_points, **f32),
        p_color=torch.zeros(n_points, 8, **f32),
        p_weight=torch.ones(n_points, 8, **f32),
        p_prior=torch.zeros(n_points, **f32),
        p_res_good=torch.zeros(n_points, n_slots, dtype=torch.bool, device=device),
        p_num_good=torch.zeros(n_points, **f32),
        p_last_res=torch.full((n_points, 2), RES_NONE, dtype=torch.int32, device=device),
        HM=torch.zeros(D, D, **f32),
        bM=torch.zeros(D, **f32),
    )


def _precond(n_slots: int, device) -> torch.Tensor:
    """[D] preconditioner, a cached device constant (building it from a
    host list per call would wait for the stream)."""
    per_frame = (SCALE_XI_TRANS,) * 3 + (SCALE_XI_ROT,) * 3 + (SCALE_A, SCALE_B)
    return constant((SCALE_F, SCALE_F, SCALE_C, SCALE_C) + per_frame * n_slots,
                    torch.device(device))


class Linearization(NamedTuple):
    Hff: torch.Tensor          # [D, D] frame/calib GN Hessian (unpreconditioned)
    bf: torch.Tensor           # [D]
    Hfd: torch.Tensor          # [NP, D] frame-idepth coupling
    Hdd: torch.Tensor          # [NP] idepth Hessian (incl. point prior)
    bd: torch.Tensor           # [NP]
    energy: torch.Tensor       # scalar photometric energy (active residuals)
    pair_energy: torch.Tensor  # [NP, W]
    pair_good: torch.Tensor    # [NP, W]
    pair_in: torch.Tensor      # [NP, W] valid + fully in-bounds
    num_terms: torch.Tensor    # scalar


def _pattern(device) -> tuple:
    """([8] u, [8] v) offsets of the residual pattern, cached device
    constants."""
    return tuple(constant(tuple(o[i] for o in PATTERN_OFFSETS), torch.device(device))
                 for i in (0, 1))


def _pattern_uv(u, v):
    du, dv = _pattern(u.device)
    return u[..., None] + du, v[..., None] + dv


def _block_columns(W: int, device) -> torch.Tensor:
    """[S, W, 20] column of the D-vector for each of a (host s, target t)
    block's 20 parameters: calib 0:4, host frame 4+8s, target 4+8t."""
    s = torch.arange(W, device=device)[:, None, None]
    t = torch.arange(W, device=device)[None, :, None]
    k = torch.arange(8, device=device)[None, None, :]
    calib = torch.arange(4, device=device).expand(W, W, 4)
    return torch.cat([calib, (4 + 8 * s + k).expand(W, W, 8),
                      (4 + 8 * t + k).expand(W, W, 8)], dim=-1)


def linearize(state: BAState, cfg: SLAMConfig) -> Linearization:
    """Linearize all (point, target) residuals at the current state with
    first-estimate Jacobians (geometry at zero states, photometric residual
    at current states): K9 on the card, ``linearize_plain`` for a CPU
    state."""
    if not state.images.is_cuda:
        return linearize_plain(state, cfg)
    params = kb.make_params(state, cfg)
    kb.ba_linearize_cuda(params, 0)
    return Linearization(**{f: params.bufs.lin[f][0] for f in kb.LIN_FIELDS})


def _host_blocks(Tth: torch.Tensor, h_idx: torch.Tensor) -> torch.Tensor:
    """Tth[t, h_idx[p]] as [NP, W, 4, 4]. The JAX package gathers it by a
    one-hot matmul, which spreads a block toward target t that is not
    finite for some host (times 0) to every point's block toward t; here
    every finite entry of such a block is NaN, as in K9. (The matmul
    spreads entry by entry; any NaN entry makes the warp non-finite, so the
    pairs' flags and energies are the same.)"""
    ph = Tth[:, h_idx].transpose(0, 1)
    spread = ~torch.isfinite(Tth).flatten(1).all(dim=1)         # [W] targets
    return torch.where(spread[None, :, None, None] & torch.isfinite(ph),
                       torch.full_like(ph, float("nan")), ph)


def linearize_plain(state: BAState, cfg: SLAMConfig,
                    magnitudes: bool = False) -> Linearization:
    """``linearize`` in plain PyTorch, on any device (K9's plain version;
    the per-(host, target) blocks placed with ``index_add_``).
    ``magnitudes``: H, b and the idepth terms summed from the magnitudes
    of every pixel's terms instead, the scale that a sum which cancels is
    compared against."""
    W = state.num_slots
    NP = state.num_points
    D = 4 + 8 * W
    dev = state.images.device
    Himg, Wimg = state.images.shape[1], state.images.shape[2]
    huber = cfg.ba.huber_th

    fx0, fy0, cx0, cy0 = state.calib_zero.unbind(0)
    fxc, fyc, cxc, cyc = state.calib_current().unbind(0)
    T_cur = state.T_current()
    T_zero = state.T_zero
    aff = state.aff_current()

    # T_th[t, h] = T[t] @ inv(T[h]); per point: its host's column
    Tth_cur = torch.einsum("tij,hjk->thik", T_cur, lie.se3_inverse(T_cur))
    Tth_zero = torch.einsum("tij,hjk->thik", T_zero, lie.se3_inverse(T_zero))
    h_idx = state.p_host
    Tth_cur_ph = _host_blocks(Tth_cur, h_idx)                   # [NP, W, 4, 4]
    Tth_zero_ph = _host_blocks(Tth_zero, h_idx)
    Rth_cur, tth_cur = Tth_cur_ph[..., :3, :3], Tth_cur_ph[..., :3, 3]
    Rth_zero, tth_zero = Tth_zero_ph[..., :3, :3], Tth_zero_ph[..., :3, 3]

    pu8, pv8 = _pattern_uv(state.p_u, state.p_v)                # [NP, 8]
    id_cur = torch.clamp(state.p_idepth, min=1e-6)
    id_zero = torch.clamp(state.p_idepth_zero, min=1e-6)
    Xh_cur = torch.stack([(pu8 - cxc) / fxc, (pv8 - cyc) / fyc,
                          torch.ones_like(pu8)], -1) / id_cur[:, None, None]
    Xh_zero = torch.stack([(pu8 - cx0) / fx0, (pv8 - cy0) / fy0,
                           torch.ones_like(pu8)], -1) / id_zero[:, None, None]

    pt_cur = torch.einsum("ptij,pkj->ptki", Rth_cur, Xh_cur) + tth_cur[:, :, None, :]
    pt_zero = torch.einsum("ptij,pkj->ptki", Rth_zero, Xh_zero) + tth_zero[:, :, None, :]
    z_cur = pt_cur[..., 2]
    un_cur = pt_cur[..., 0] / z_cur
    vn_cur = pt_cur[..., 1] / z_cur
    Ku = fxc * un_cur + cxc                                      # [NP, W, 8]
    Kv = fyc * vn_cur + cyc
    in_bounds = ((Ku > 1.1) & (Kv > 1.1) & (Ku < Wimg - 2.1) & (Kv < Himg - 2.1)
                 & (z_cur > 1e-4))

    t_fold = torch.arange(W, device=dev)[None, :, None]
    hit_i, gx, gy = bilinear_gather_frames(state.images, t_fold, Ku, Kv)

    a_h = aff[h_idx, 0][:, None]
    b_h = aff[h_idx, 1][:, None]
    a_t = aff[None, :, 0]
    b_t = aff[None, :, 1]
    exp_h = state.exposure[h_idx][:, None]
    exp_t = state.exposure[None, :]
    a_th = torch.exp(a_t - a_h) * (exp_t / torch.clamp(exp_h, min=1e-9))   # [NP, W]
    b_th = b_t - a_th * b_h
    residual = hit_i - (a_th[..., None] * state.p_color[:, None, :] + b_th[..., None])

    wp = state.p_weight[:, None, :]
    abs_r = torch.abs(residual)
    hw = torch.where(abs_r < huber, torch.ones_like(abs_r),
                     huber / torch.clamp(abs_r, min=1e-12))

    t_idx = torch.arange(W, device=dev)[None, :]
    pair_mask = (state.p_valid[:, None] & state.frame_valid[None, :]
                 & (t_idx != h_idx[:, None]) & state.p_res_good)
    pix_ok = in_bounds & torch.isfinite(hit_i) & pair_mask[..., None]
    pix_energy = hw * residual * residual * (2.0 - hw) * wp * wp
    pair_energy = torch.sum(torch.where(pix_ok, pix_energy, torch.zeros_like(pix_energy)), -1)
    all_pix_in = torch.all(in_bounds | ~pair_mask[..., None], dim=-1)
    th = torch.maximum(state.energy_th[h_idx][:, None], state.energy_th[None, :])
    is_good = pair_mask & all_pix_in & (pair_energy < th)

    # ---- Jacobians (geometry at FEJ) ---------------------------------------
    z0 = torch.clamp(pt_zero[..., 2], min=1e-6)
    un0 = pt_zero[..., 0] / z0
    vn0 = pt_zero[..., 1] / z0
    iz0 = 1.0 / z0
    gxf = gx * fx0
    gyf = gy * fy0
    Jt = torch.stack([
        iz0 * gxf,
        iz0 * gyf,
        -iz0 * (un0 * gxf + vn0 * gyf),
        -(un0 * vn0 * gxf + (1.0 + vn0 * vn0) * gyf),
        un0 * vn0 * gyf + (1.0 + un0 * un0) * gxf,
        un0 * gyf - vn0 * gxf,
    ], dim=-1)                                                   # [NP, W, 8, 6]
    dr_dpt = Jt[..., :3]                                         # [NP, W, 8, 3]
    Xh = Xh_zero
    zero = torch.zeros_like(Xh[..., 0])
    hatX = torch.stack([
        torch.stack([zero, Xh[..., 2], -Xh[..., 1]], -1),
        torch.stack([-Xh[..., 2], zero, Xh[..., 0]], -1),
        torch.stack([Xh[..., 1], -Xh[..., 0], zero], -1),
    ], dim=-2)                                                   # [NP, 8, 3, 3] = -hat(X)
    I3 = torch.eye(3, dtype=torch.float32, device=dev).expand(hatX.shape)
    G = torch.cat([I3, hatX], dim=-1)                            # [NP, 8, 3, 6]
    RG = torch.einsum("ptij,pkjl->ptkil", Rth_zero, G)           # [NP, W, 8, 3, 6]
    Jh = -torch.einsum("ptki,ptkil->ptkl", dr_dpt, RG)           # [NP, W, 8, 6]

    dpt_did = -(pt_zero - tth_zero[:, :, None, :]) / id_zero[:, None, None, None]
    Jd = torch.sum(dr_dpt * dpt_did, -1)                         # [NP, W, 8]

    xh_x = (pu8 - cx0) / fx0
    xh_y = (pv8 - cy0) / fy0
    Rcol0 = Rth_zero[..., :, 0]
    Rcol1 = Rth_zero[..., :, 1]
    idz = id_zero[:, None]
    dpt_dfx = -(Rcol0[:, :, None, :] * (xh_x / fx0 / idz)[:, None, :, None])
    dpt_dfy = -(Rcol1[:, :, None, :] * (xh_y / fy0 / idz)[:, None, :, None])
    dpt_dcx = -(Rcol0[:, :, None, :] * (1.0 / fx0 / idz).expand_as(xh_x)[:, None, :, None])
    dpt_dcy = -(Rcol1[:, :, None, :] * (1.0 / fy0 / idz).expand_as(xh_y)[:, None, :, None])
    Jfx = gx * un0 + torch.sum(dr_dpt * dpt_dfx, -1)
    Jfy = gy * vn0 + torch.sum(dr_dpt * dpt_dfy, -1)
    Jcx = gx + torch.sum(dr_dpt * dpt_dcx, -1)
    Jcy = gy + torch.sum(dr_dpt * dpt_dcy, -1)
    Jcalib = torch.stack([Jfx, Jfy, Jcx, Jcy], dim=-1)           # [NP, W, 8, 4]

    c_minus_bh = state.p_color[:, None, :] - b_h[..., None]
    Ja_t = -a_th[..., None] * c_minus_bh
    Ja_h = a_th[..., None] * c_minus_bh
    Jb_t = -torch.ones_like(Ja_t)
    Jb_h = a_th[..., None] * torch.ones_like(Ja_t)

    # ---- assemble H/b ---------------------------------------------------------
    w_pix = torch.where(is_good[..., None] & pix_ok, hw * wp * wp, torch.zeros_like(hw))
    J20 = torch.cat([Jcalib, Jh, Ja_h[..., None], Jb_h[..., None],
                     Jt, Ja_t[..., None], Jb_t[..., None]], dim=-1)   # [NP, W, 8, 20]
    if magnitudes:
        J20, Jd, residual = J20.abs(), Jd.abs(), residual.abs()
    Jw = J20 * w_pix[..., None]
    # per (host, target) 20x20 blocks: sum over the host's points (one-hot
    # matmul over the pool: a fixed-order reduction)
    onehot = torch.nn.functional.one_hot(h_idx, W).to(torch.float32)   # [NP, S]
    Hp = torch.einsum("pwki,pwkj->pwij", Jw, J20)                 # [NP, W, 20, 20]
    bp = torch.einsum("pwki,pwk->pwi", Jw, residual)              # [NP, W, 20]
    H20 = (onehot.T @ Hp.reshape(NP, -1)).reshape(W, W, 20, 20)
    b20 = (onehot.T @ bp.reshape(NP, -1)).reshape(W, W, 20)
    cols = _block_columns(W, dev)                                 # [S, W, 20]
    flat = (cols[..., :, None] * D + cols[..., None, :]).reshape(-1)
    Hff = torch.zeros(D * D, dtype=torch.float32, device=dev).index_add_(
        0, flat, H20.reshape(-1)).reshape(D, D)
    bf = torch.zeros(D, dtype=torch.float32, device=dev).index_add_(
        0, cols.reshape(-1), b20.reshape(-1))
    # the JAX package places the blocks by one einsum with 0/1 matrices, so
    # one non-finite block entry makes all of Hff (bf) NaN, as in K9
    nan = torch.full((), float("nan"), device=dev)
    Hff = torch.where(torch.isfinite(H20).all(), Hff, nan)
    bf = torch.where(torch.isfinite(b20).all(), bf, nan)

    # Schur blocks per point: calib, the host frame's 8 and each target's 8
    G20 = torch.einsum("pwki,pwk->pwi", Jw, Jd)                   # [NP, W, 20]
    Hfd = torch.zeros(NP, D, dtype=torch.float32, device=dev)
    Hfd[:, :4] = G20[..., :4].sum(1)
    frames = Hfd[:, 4:].view(NP, W, 8)
    frames += G20[..., 12:20]
    frames[torch.arange(NP, device=dev), h_idx] += G20[..., 4:12].sum(1)
    Hdd = torch.sum(w_pix * Jd * Jd, dim=(1, 2))
    bd = torch.sum(w_pix * Jd * residual, dim=(1, 2))
    Hdd = Hdd + state.p_prior
    d_prior = state.p_prior * (state.p_idepth - state.p_idepth_zero)
    bd = bd + (d_prior.abs() if magnitudes else d_prior)

    e_contrib = torch.where(is_good, pair_energy,
                            torch.where(pair_mask, th, torch.zeros_like(th)))
    energy = torch.sum(e_contrib)
    num_terms = torch.sum(is_good.to(torch.float32)) * 8.0
    return Linearization(Hff=Hff, bf=bf, Hfd=Hfd, Hdd=Hdd, bd=bd, energy=energy,
                         pair_energy=pair_energy, pair_good=is_good,
                         pair_in=pair_mask & all_pix_in, num_terms=num_terms)


# ---------------------------------------------------------------------------
# priors & solving
# ---------------------------------------------------------------------------


def _prior_diag(state: BAState, cfg: SLAMConfig) -> torch.Tensor:
    """Diagonal prior over [D]: calib prior + affine mode priors; invalid
    slots frozen hard."""
    W = state.num_slots
    ba = cfg.ba
    dev = state.delta.device
    mode_a, mode_b = cfg.tracker.affine_mode_a, cfg.tracker.affine_mode_b
    a_prior = ba.initial_aff_a_prior if mode_a < 0 else float(mode_a)
    b_prior = ba.initial_aff_b_prior if mode_b < 0 else float(mode_b)
    calib = torch.full((4,), ba.initial_calib_hessian, dtype=torch.float32, device=dev)
    per_frame = constant((0.0,) * 6 + (a_prior, b_prior), dev)
    frames = per_frame.expand(W, 8)
    frames = torch.where(state.frame_valid[:, None], frames, torch.full_like(frames, 1e12))
    return torch.cat([calib, frames.reshape(-1)])


def anchor_slot(state: BAState) -> torch.Tensor:
    """The gauge anchor: the oldest valid KF in the window."""
    fid = torch.where(state.frame_valid, state.frame_id,
                      torch.full_like(state.frame_id, 2 ** 30))
    return torch.argmin(fid)


def _free_mask(state: BAState) -> torch.Tensor:
    """[D] bool: False for the anchor frame's 8 parameters."""
    D = 4 + 8 * state.num_slots
    a = anchor_slot(state)
    idx = torch.arange(D, device=state.delta.device)
    return ~((idx >= 4 + 8 * a) & (idx < 4 + 8 * a + 8))


def _state_vector(state: BAState) -> torch.Tensor:
    return torch.cat([state.calib_delta, state.delta.reshape(-1)])


def _nullspaces(state: BAState) -> torch.Tensor:
    """Global-scale gauge direction with the anchor eliminated: [D, 1]."""
    W = state.num_slots
    D = 4 + 8 * W
    dev = state.delta.device
    t_cw = state.T_current()[:, :3, 3]
    a = anchor_slot(state)
    blk = (state.frame_valid & (torch.arange(W, device=dev) != a)).to(torch.float32)
    N = torch.zeros(D, 1, dtype=torch.float32, device=dev)
    N[4:].view(W, 8)[:, :3] = t_cw * blk[:, None]
    return N


def _project_out_nullspace(x: torch.Tensor, N: torch.Tensor) -> torch.Tensor:
    """x <- x - N (N^T N)^+ N^T x."""
    k = N.shape[1]
    NtN = N.T @ N + 1e-6 * torch.eye(k, dtype=torch.float32, device=x.device)
    coef = torch.linalg.solve_ex(NtN, N.T @ x[:, None])[0]
    return x - (N @ coef)[:, 0]


def damped_system(state: BAState, lin: Linearization, lam, cfg: SLAMConfig):
    """An LM step's frame system: the Schur complement over idepths, the
    priors, the anchor eliminated, preconditioned and damped. Returns
    (Hp [D, D], bp [D], P [D], inv_Hdd [NP]); the step solves Hp xp = -bp."""
    W = state.num_slots
    D = 4 + 8 * W
    dev = state.delta.device
    x0 = _state_vector(state)
    prior = _prior_diag(state, cfg)

    Hdd_mult = lin.Hdd * (1.0 + lam) + 1e-10
    inv_Hdd = torch.where(lin.Hdd > 1e-10, 1.0 / Hdd_mult, torch.zeros_like(Hdd_mult))
    H_sc = (lin.Hfd.T * inv_Hdd[None, :]) @ lin.Hfd
    b_sc = (lin.Hfd.T @ (inv_Hdd * lin.bd)[:, None])[:, 0]
    H = lin.Hff - H_sc + state.HM + torch.diag(prior)
    b = lin.bf - b_sc + state.bM + (state.HM @ x0[:, None])[:, 0] + prior * x0

    free = _free_mask(state)
    H = torch.where(free[:, None] & free[None, :], H, torch.zeros_like(H))
    H = H + torch.diag(torch.where(free, 0.0, 1.0))
    b = torch.where(free, b, torch.zeros_like(b))

    P = _precond(W, dev)
    Hp = H * P[:, None] * P[None, :]
    bp = b * P
    Hp = Hp + lam * torch.diag(torch.diagonal(Hp)) + 1e-8 * torch.eye(D, dtype=torch.float32, device=dev)
    return Hp, bp, P, inv_Hdd


def solve_step(state: BAState, lin: Linearization, lam, cfg: SLAMConfig):
    """One GN/LM step: Schur over idepths, solve the frame system, project
    the gauge nullspace out, back-substitute idepths. Returns (x [D], x_d [NP])."""
    Hp, bp, P, inv_Hdd = damped_system(state, lin, lam, cfg)
    xp = torch.linalg.solve_ex(Hp, -bp[:, None])[0][:, 0]
    x = xp * P
    x = _project_out_nullspace(x, _nullspaces(state))
    x_d = inv_Hdd * (-lin.bd - (lin.Hfd @ x[:, None])[:, 0])
    return x, x_d


def apply_step(state: BAState, x: torch.Tensor, x_d: torch.Tensor) -> BAState:
    W = state.num_slots
    return state._replace(
        calib_delta=state.calib_delta + x[:4],
        delta=state.delta + x[4:].reshape(W, 8),
        p_idepth=torch.where(state.p_valid, state.p_idepth + x_d, state.p_idepth))


def _step_converged(x, x_d, state: BAState, cfg: SLAMConfig) -> torch.Tensor:
    """DSO doStepFromBackup convergence test."""
    W = state.num_slots
    nf = torch.clamp(torch.sum(state.frame_valid.to(torch.float32)), min=1.0)
    xf = x[4:].reshape(W, 8)
    msk = state.frame_valid[:, None].to(torch.float32)
    sumT = torch.sum(msk * xf[:, 0:3] ** 2) / nf
    sumR = torch.sum(msk * xf[:, 3:6] ** 2) / nf
    sumA = torch.sum(msk[:, 0] * xf[:, 6] ** 2) / nf
    sumB = torch.sum(msk[:, 0] * xf[:, 7] ** 2) / nf
    nid = torch.clamp(torch.sum(state.p_valid.to(torch.float32)), min=1.0)
    sumNID = torch.sum(torch.where(state.p_valid, torch.abs(state.p_idepth),
                                   torch.zeros_like(state.p_idepth))) / nid
    th = cfg.ba.th_opt_iterations
    return ((torch.sqrt(sumA) < 0.0005 * th) & (torch.sqrt(sumB) < 0.00005 * th)
            & (torch.sqrt(sumR) < 0.00005 * th)
            & (torch.sqrt(sumT) * sumNID < 0.00005 * th))


def _select(pred: torch.Tensor, a, b):
    """Elementwise tree select on a scalar predicate."""
    return type(a)(*[torch.where(pred, x, y) for x, y in zip(a, b)])


def total_energy(st: BAState, lin: Linearization, cfg: SLAMConfig) -> torch.Tensor:
    """The photometric energy plus the marginalization and state priors."""
    x = _state_vector(st)
    prior = _prior_diag(st, cfg)
    return lin.energy + torch.dot(x, (st.HM @ x[:, None])[:, 0] + 2.0 * st.bM + prior * x)


def _optimize_loop_plain(state: BAState, cfg: SLAMConfig, iterations: int):
    """The LM loop in plain PyTorch (the resident launch's plain version;
    one host read of the exit condition per iteration). Returns (state,
    lin)."""
    lin = linearize(state, cfg)
    e_old = total_energy(state, lin, cfg)
    lam = torch.full((), 1e-1, dtype=torch.float32, device=state.delta.device)
    for it in range(int(iterations)):
        x, x_d = solve_step(state, lin, lam, cfg)
        converged = _step_converged(x, x_d, state, cfg)
        st_new = apply_step(state, x, x_d)
        done = converged & (it + 1 >= cfg.ba.min_opt_iterations)
        if cfg.ba.solver_force_accept_step:
            do_apply = (~converged) | (it < cfg.ba.min_opt_iterations)
            state = _select(do_apply, st_new, state)
            lin = linearize(state, cfg)
            lam = lam * 0.25
        else:
            lin_new = linearize(st_new, cfg)
            e_new = total_energy(st_new, lin_new, cfg)
            accept = (e_new < e_old) & (lin_new.num_terms >= 0.3 * lin.num_terms)
            state = _select(accept, st_new, state)
            lin = _select(accept, lin_new, lin)
            lam = torch.where(accept, lam * 0.25, torch.clamp(lam * 100.0, max=1e4))
            e_old = torch.where(accept, e_new, e_old)
        if bool(done):
            break
    return state, lin


def _optimize_loop_queued(state: BAState, cfg: SLAMConfig, iterations: int):
    """The LM loop as queued launches: K9 and K11 once, then ``iterations``
    rounds of K10 -> K9 -> K11 with no host read (each returns at once
    when the done flag on the card is set); the accepted state and
    linearization picked by the device index ctrl_i[0]. Not the main path
    (``_optimize_device`` runs the same code in one launch): its bit
    reference, for tests and ``chip_smoke.py``. Returns (state, lin,
    params)."""
    W, NP = state.num_slots, state.num_points
    states = {f: torch.stack([getattr(state, f)] * 2) for f in kb.STATE_FIELDS}
    lins = kb.empty_lin(2, NP, W, state.images.device)
    params = kb.make_params(state, cfg, states, lins)
    kb.ba_linearize_cuda(params, 0)
    kb.ba_accept_cuda(params, -1)
    for it in range(int(iterations)):
        kb.ba_step_cuda(params)
        kb.ba_linearize_cuda(params, 1)
        kb.ba_accept_cuda(params, it)
    cur = params.bufs.ctrl_i[:1].to(torch.int64)
    state = state._replace(**{f: kb.pick(states[f], cur) for f in kb.STATE_FIELDS})
    return state, Linearization(**{f: kb.pick(lins[f], cur) for f in kb.LIN_FIELDS}), params


def _optimize_device(state: BAState, cfg: SLAMConfig, iterations: int, params=None):
    """``_optimize_impl`` on the card: one resident launch
    (``kb.ba_optimize_cuda``) runs the LM loop, leaves it once done, and
    writes the accepted state and linearization and
    ``_finish_optimize``'s bookkeeping; nothing is read back or picked on
    the host. ``params``: a block from ``kb.optimize_params`` (default: a new
    one). Returns (state, rmse, ok, lin)."""
    if params is None:
        params = kb.optimize_params(state, cfg)
    kb.ba_optimize_cuda(params, iterations)
    b = params.bufs
    state = state._replace(**{f: b.state[f][2] for f in kb.STATE_FIELDS},
                           p_res_good=b.lin["pair_good"][2], p_num_good=b.out["num_good"],
                           p_last_res=b.out["last_res"])
    return (state, b.out["rmse"], b.out["ok"],
            Linearization(**{f: b.lin[f][2] for f in kb.LIN_FIELDS}))


def _finish_optimize(state: BAState, lin: Linearization):
    """The isOOB bookkeeping after the loop (the resident launch's last
    phase): the residuals' states toward the two newest frames, the good
    residual counts, rmse and ok. Returns (state, rmse, ok, lin)."""
    W = state.num_slots
    dev = state.delta.device
    t_idx = torch.arange(W, device=dev)[None, :]
    participated = (state.p_valid[:, None] & state.frame_valid[None, :]
                    & (t_idx != state.p_host[:, None]) & state.p_res_good)
    c = lambda v: torch.full_like(state.p_last_res[:, :1].expand(-1, W), v)
    pair_state = torch.where(lin.pair_good, c(RES_IN),
                             torch.where(lin.pair_in, c(RES_OUTLIER),
                                         torch.where(participated, c(RES_OOB), c(RES_NONE))))
    # the two newest slots as device indices (indexing with them would
    # read them back)
    fid = torch.where(state.frame_valid, state.frame_id, torch.full_like(state.frame_id, -1))
    newest = torch.argmax(fid)
    fid2 = torch.where(torch.arange(W, device=dev) == newest, torch.full_like(fid, -1), fid)
    second = torch.argmax(fid2)
    has2 = torch.max(fid2) >= 0
    col = lambda a, i: torch.index_select(a, 1, i.view(1))[:, 0]
    lr0 = torch.where(col(participated, newest), col(pair_state, newest), state.p_last_res[:, 0])
    lr1 = torch.where(has2 & col(participated, second), col(pair_state, second),
                      state.p_last_res[:, 1])
    state = state._replace(
        p_res_good=lin.pair_good,
        p_num_good=state.p_num_good + torch.sum(lin.pair_good, dim=1).to(torch.float32),
        p_last_res=torch.stack([lr0, lr1], -1))
    rmse = torch.sqrt(lin.energy / torch.clamp(lin.num_terms, min=1.0))
    return state, rmse, torch.isfinite(lin.energy), lin


def _optimize_impl(state: BAState, cfg: SLAMConfig, iterations: int):
    """The windowed BA loop: LM with energy-gated accept/reject (or DSO's
    force-accept), one linearization per iteration, early exit once the
    step converges after min_opt_iterations, then the isOOB bookkeeping
    (on the card one resident launch, for a CPU state the plain loop and
    ``_finish_optimize``). Returns (state, rmse, energy_finite, final
    Linearization)."""
    if state.images.is_cuda:
        return _optimize_device(state, cfg, iterations)
    return _finish_optimize(*_optimize_loop_plain(state, cfg, iterations))


def optimize(state: BAState, cfg: SLAMConfig, iterations: int):
    """Windowed BA; returns (state, rmse, ok)."""
    state, rmse, ok, _ = _optimize_impl(state, cfg, iterations)
    return state, rmse, ok


def set_new_frame_energy_th_from_lin(state: BAState, lin: Linearization,
                                     newest_slot: int, cfg: SLAMConfig) -> BAState:
    """Percentile-based energy threshold for the newest frame, over ALL
    residual energies toward it (linear-interpolated nanquantile)."""
    is_target = torch.arange(state.num_slots, device=state.delta.device)[None, :] == newest_slot
    sel = lin.pair_in & is_target
    e = torch.where(sel, lin.pair_energy, torch.full_like(lin.pair_energy, float("nan")))
    nth = torch.nanquantile(e.reshape(-1), cfg.ba.frame_energy_th_n, interpolation="linear")
    nth = torch.where(torch.isfinite(nth), torch.sqrt(nth),
                      torch.full_like(nth, 12.0 * 8.0 ** 0.5))
    th = nth * cfg.ba.frame_energy_th_fac_median
    th = 26.0 * cfg.ba.frame_energy_th_const_weight + th * (1.0 - cfg.ba.frame_energy_th_const_weight)
    th = th * th * cfg.ba.overall_energy_th_weight ** 2
    energy_th = state.energy_th.clone()
    energy_th[newest_slot] = th
    return state._replace(energy_th=energy_th)


def reset_fej_newest(state: BAState, newest_slot: int) -> BAState:
    """Move the newest frame's FEJ point to its current pose (K16's
    operation order, as K17's epilogue forms it), keeping the affine
    delta."""
    T_zero = state.T_zero.clone()
    T_zero[newest_slot] = state.T_current()[newest_slot]
    delta = state.delta.clone()
    delta[newest_slot, 0:6] = 0.0
    return state._replace(T_zero=T_zero, delta=delta)


# ---------------------------------------------------------------------------
# marginalization
# ---------------------------------------------------------------------------


def marginalize_points(state: BAState, marg_mask: torch.Tensor, cfg: SLAMConfig,
                       lin: Optional[Linearization] = None) -> BAState:
    """Fold flagged points into the prior (HM, bM) via the Schur complement
    over their idepths, weighted by setting_margWeightFac, then invalidate
    them. ``lin``: an existing linearization of ``state``."""
    if lin is None:
        lin = linearize(state, cfg)
    m = (marg_mask & state.p_valid).to(torch.float32)
    inv_Hdd = torch.where(lin.Hdd > 1e-10, 1.0 / lin.Hdd, torch.zeros_like(lin.Hdd)) * m
    lin_p = linearize(state._replace(p_valid=state.p_valid & marg_mask), cfg)
    H_sc = (lin_p.Hfd.T * inv_Hdd[None, :]) @ lin_p.Hfd
    b_sc = (lin_p.Hfd.T @ (inv_Hdd * lin_p.bd)[:, None])[:, 0]
    w = cfg.ba.marg_weight_fac
    x0 = _state_vector(state)
    dH = w * (lin_p.Hff - H_sc)
    db = w * (lin_p.bf - b_sc)
    return state._replace(HM=state.HM + dH,
                          bM=state.bM + db - (dH @ x0[:, None])[:, 0],
                          p_valid=state.p_valid & ~marg_mask)


def drop_points(state: BAState, drop_mask: torch.Tensor) -> BAState:
    """Drop points without folding them into the prior."""
    return state._replace(p_valid=state.p_valid & ~drop_mask)


def marginalize_frame(state: BAState, slot: int) -> BAState:
    """Schur-remove a frame's 8 parameters from (HM, bM) and free its slot;
    a marginalized anchor first gets a strong pose prior so the remaining
    frames stay anchored."""
    W = state.num_slots
    D = 4 + 8 * W
    dev = state.delta.device
    idx0 = 4 + 8 * slot
    ar = torch.arange(D, device=dev)
    onblock = (ar >= idx0) & (ar < idx0 + 8)
    is_anchor = anchor_slot(state) == slot
    HM = state.HM + torch.diag(torch.where(onblock & is_anchor, 1e8, 0.0))
    bM = state.bM
    sel = torch.arange(idx0, idx0 + 8, device=dev)
    keep = ~onblock
    Hbb = HM[sel][:, sel] + 1e-8 * torch.eye(8, dtype=torch.float32, device=dev)
    Hab = HM[:, sel] * keep[:, None].to(torch.float32)
    bb = bM[sel]
    Hbb_inv = torch.linalg.inv_ex(Hbb)[0]
    HM_new = HM - (Hab @ Hbb_inv) @ Hab.T
    bM_new = bM - (Hab @ (Hbb_inv @ bb[:, None]))[:, 0]
    mask2d = keep[:, None] & keep[None, :]
    HM_new = torch.where(mask2d, HM_new, torch.zeros_like(HM_new))
    bM_new = torch.where(keep, bM_new, torch.zeros_like(bM_new))

    # (a host number assigned to one element would be copied from the host,
    # a wait for the card: filled in place instead)
    frame_valid = state.frame_valid.clone()
    frame_valid[slot].fill_(False)
    frame_id = state.frame_id.clone()
    frame_id[slot].fill_(-1)
    p_res_good = state.p_res_good.clone()
    p_res_good[:, slot] = False
    delta = state.delta.clone()
    delta[slot] = 0.0
    return state._replace(HM=HM_new, bM=bM_new, frame_valid=frame_valid,
                          frame_id=frame_id, p_res_good=p_res_good,
                          p_valid=state.p_valid & (state.p_host != slot), delta=delta)


def marginalize_plain(state: BAState, lin: Linearization, marg: np.ndarray,
                      drop: np.ndarray, slots, cfg: SLAMConfig) -> BAState:
    """K18's plain version: ``marginalize_points`` of the host mask ``marg``
    with ``lin``, ``drop_points`` of ``drop``, then ``marginalize_frame`` of
    each slot in order (each step only where it has something to do)."""
    dev = state.delta.device
    if np.any(marg):
        state = marginalize_points(state, to_device(np.asarray(marg, bool), dev), cfg, lin)
    if np.any(drop):
        state = drop_points(state, to_device(np.asarray(drop, bool), dev))
    for slot in slots:
        state = marginalize_frame(state, int(slot))
    return state


def marginalize(state: BAState, lin: Linearization, marg: np.ndarray, drop: np.ndarray,
                slots, cfg: SLAMConfig) -> BAState:
    """The keyframe tail's marginalization, given the host masks of the
    points to fold into the prior (``marg``) and to drop (``drop``), the
    frames to marginalize in order (``slots``) and the linearization the
    points are folded with: K18, one launch, on the card (the masks go up
    in one copy); ``marginalize_plain`` for a CPU state."""
    if not state.images.is_cuda:
        return marginalize_plain(state, lin, marg, drop, slots, cfg)
    flags = to_device(win.pack_flags(marg, drop), state.images.device)
    return win.marginalize_cuda(state, lin.Hdd, flags, bool(np.any(marg)), list(slots), cfg)


# ---------------------------------------------------------------------------
# window management
# ---------------------------------------------------------------------------


def current_views(state: BAState, pose: Optional[win.WindowPose] = None):
    """(T_current [W,4,4], aff_current [W,2], calib_current [4],
    frame_valid [W], frame_id [W], p_valid [NP], p_host [NP]); the first
    three from K16 (``pose``: its outputs for this state, else one launch)."""
    if pose is None:
        pose = win.window_pose(state)
    return (pose.T_all, pose.aff, pose.calib,
            state.frame_valid, state.frame_id, state.p_valid, state.p_host)


_POINT_FIELDS = ("p_u", "p_v", "p_idepth", "p_idepth_zero", "p_host", "p_valid",
                 "p_color", "p_weight", "p_prior", "p_res_good", "p_num_good",
                 "p_last_res")


def _compact_points(state: BAState, budget: int):
    """The pool's valid rows first (stable, original order) in a
    [budget]-row view sharing the frame arrays. Returns (sub_state, rows,
    n_dropped); n_dropped > 0 means the view excluded valid points."""
    order = torch.sort((~state.p_valid).to(torch.int8), stable=True).indices
    rows = order[:budget]
    n_dropped = torch.clamp(torch.sum(state.p_valid) - budget, min=0)
    sub = state._replace(**{f: getattr(state, f)[rows] for f in _POINT_FIELDS})
    return sub, rows, n_dropped


def _scatter_points(full: BAState, work: BAState, rows) -> BAState:
    """Merge an optimized compact state back into the full pool."""
    upd = {}
    for f in ("p_idepth", "p_valid", "p_res_good", "p_num_good", "p_last_res"):
        a = getattr(full, f).clone()
        a[rows] = getattr(work, f)
        upd[f] = a
    for f in ("p_u", "p_v", "p_idepth_zero", "p_host", "p_color", "p_weight", "p_prior"):
        upd[f] = getattr(full, f)
    return work._replace(**upd)


def optimize_keyframe(state: BAState, cfg: SLAMConfig, iterations: int,
                      newest_slot: int, compact_budget: Optional[int] = None):
    """Keyframe BA step: optimize -> percentile energy threshold for the
    newest frame -> FEJ reset -> drop residual-less points. On the card
    K17's prologue, the resident launch and K17's epilogue
    (``ops/window.py::ba_keyframe_cuda``); ``optimize_keyframe_plain`` for
    a CPU state. Returns (state, rmse, ok, Hdd [NP], n_dropped)."""
    if state.images.is_cuda:
        return win.ba_keyframe_cuda(state, cfg, iterations, newest_slot, compact_budget)
    return optimize_keyframe_plain(state, cfg, iterations, newest_slot, compact_budget)


def optimize_keyframe_plain(state: BAState, cfg: SLAMConfig, iterations: int,
                            newest_slot: int, compact_budget: Optional[int] = None):
    """``optimize_keyframe`` in plain PyTorch around ``_optimize_impl`` (K17's
    plain version: a stable sort for the compaction, ``torch.nanquantile``
    for the threshold, indexed writes for the scatter)."""
    if compact_budget is None or compact_budget >= state.num_points:
        work, rows = state, None
        n_dropped = torch.zeros((), dtype=torch.int64, device=state.delta.device)
    else:
        work, rows, n_dropped = _compact_points(state, compact_budget)
    work, rmse, ok, lin = _optimize_impl(work, cfg, iterations)
    state, hdd = keyframe_epilogue_plain(state, work, rows, lin, newest_slot, cfg)
    return state, rmse, ok, hdd, n_dropped


def keyframe_epilogue_plain(state: BAState, work: BAState, rows, lin: Linearization,
                            newest_slot: int, cfg: SLAMConfig):
    """What ``optimize_keyframe_plain`` does after the LM loop (K17's
    epilogue's plain version): the newest frame's energy threshold, its FEJ
    reset, the drop of points left without a good residual, and the
    optimized view ``work`` (rows ``rows`` of the pool; None: the pool
    itself) scattered back into ``state``. Returns (state, Hdd [NP])."""
    work = set_new_frame_energy_th_from_lin(work, lin, newest_slot, cfg)
    work = reset_fej_newest(work, newest_slot)
    no_res = ~torch.any(work.p_res_good & work.p_valid[:, None], dim=1)
    work = work._replace(p_valid=work.p_valid & ~no_res)
    if rows is None:
        return work, lin.Hdd
    state = _scatter_points(state, work, rows)
    hdd = torch.zeros(state.num_points, dtype=torch.float32, device=state.delta.device)
    hdd[rows] = lin.Hdd
    return state, hdd


def template_pose_prep(state: BAState, ref_slot: int,
                       pose: Optional[win.WindowPose] = None):
    """The template's window part: the current calibration [4] (fx, fy,
    cx, cy) and every slot's host-to-reference transform T_rh [W, 4, 4],
    from K16 (``pose``: its outputs for this state toward ``ref_slot``,
    else one launch)."""
    if pose is None:
        pose = win.window_pose(state, ref_slot)
    return pose.calib, pose.T_rh


def template_project(p_u, p_v, p_idepth, p_host, p_valid, hdd, calib, T_rh):
    """The template's per-point part: each point projected into the
    reference KF and weighted by its idepth hessian, (proj_u, proj_v,
    new_id, w, valid). One elementwise operation at a time in a fixed
    order (``R @ Xh`` as three products and two sums a row, then ``+ t``),
    which K15's state mode (``csrc/template.cu``) repeats operation by
    operation."""
    fx0, fy0, cx0, cy0 = calib.unbind(0)
    inv = torch.clamp(p_idepth, min=1e-6)
    x0 = (p_u - cx0) / fx0 / inv
    x1 = (p_v - cy0) / fy0 / inv
    x2 = torch.ones_like(p_u) / inv
    T = T_rh[p_host]
    pt = [T[:, r, 0] * x0 + T[:, r, 1] * x1 + T[:, r, 2] * x2 + T[:, r, 3] for r in range(3)]
    proj_u = fx0 * pt[0] / pt[2] + cx0
    proj_v = fy0 * pt[1] / pt[2] + cy0
    new_id = 1.0 / torch.clamp(pt[2], min=1e-6)
    valid = p_valid & (pt[2] > 0)
    w = torch.sqrt(1e-3 * torch.clamp(hdd, min=1e-9))
    return proj_u, proj_v, new_id, w, valid


def template_inputs(state: BAState, cfg: SLAMConfig, ref_slot: int, hdd=None):
    """Project every window point into the reference KF and weight it by
    the BA idepth hessian: (proj_u, proj_v, new_id, w, valid)."""
    if hdd is None:
        hdd = linearize(state, cfg).Hdd
    calib, T_rh = template_pose_prep(state, ref_slot)
    return template_project(state.p_u, state.p_v, state.p_idepth, state.p_host, state.p_valid,
                            hdd, calib, T_rh)


def add_frame(state: BAState, slot: int, frame_id: int, T_cw, aff, exposure: float,
              image_planes: torch.Tensor) -> BAState:
    """Insert a keyframe into a free slot; residuals toward it activate
    through the dense [NP, W] grid."""
    dev = state.delta.device

    def put(a, v):
        # a host number is filled in place: assigned through an index it
        # would be copied from the host, a wait for the card
        a = a.clone()
        if isinstance(v, torch.Tensor):
            a[slot] = v
        else:
            a[slot].fill_(v)
        return a

    def upload(x):
        # a host array through pinned memory: a pageable copy waits for
        # the card
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.float32)
        return to_device(np.asarray(x, np.float32), dev)

    p_res_good = state.p_res_good.clone()
    p_res_good[:, slot] = True
    c = lambda v: torch.full_like(state.p_last_res[:, 0], v)
    return state._replace(
        frame_valid=put(state.frame_valid, True),
        frame_id=put(state.frame_id, int(frame_id)),
        T_zero=put(state.T_zero, upload(T_cw)),
        delta=put(state.delta, 0.0),
        aff_zero=put(state.aff_zero, upload(aff)),
        exposure=put(state.exposure, float(exposure)),
        images=put(state.images, image_planes),
        energy_th=put(state.energy_th, 12.0 * 12.0 * 8.0),
        p_res_good=p_res_good,
        p_last_res=torch.stack([
            torch.where(state.p_valid, c(RES_IN), c(RES_NONE)),
            torch.where(state.p_valid, state.p_last_res[:, 0], c(RES_NONE))], -1),
    )


def add_points(state: BAState, free_idx: torch.Tensor, host_slot, u, v, idepth,
               color, weight, valid: torch.Tensor, prior=None) -> BAState:
    """Insert points into the pool at ``free_idx``; lanes with
    valid=False are dropped (fixed-length padded batches). ``host_slot``
    is an int or a per-lane tensor. A dropped lane writes a scratch row
    past the pool's end, and every value written is a tensor on the
    state's device: no boolean-mask indexing and no host value through a
    tensor index, which would wait for the card."""
    dev = state.delta.device
    NP = state.num_points
    keep = valid.to(torch.bool)
    n = keep.shape[0]
    if prior is None:
        prior = torch.zeros_like(u)
    idx = torch.where(keep, free_idx.to(torch.int64),
                      torch.full((n,), NP, dtype=torch.int64, device=dev))
    host = (host_slot.to(torch.int64).expand(n) if isinstance(host_slot, torch.Tensor)
            else torch.full((n,), int(host_slot), dtype=torch.int64, device=dev))

    def put(a, vals):
        out = torch.cat([a, a[:1]])
        out[idx] = vals.to(a.dtype).expand((n,) + a.shape[1:])
        return out[:NP]

    def const(a, value):
        return torch.full((1,) + a.shape[1:], value, dtype=a.dtype, device=dev)

    return state._replace(
        p_valid=put(state.p_valid, const(state.p_valid, True)),
        p_host=put(state.p_host, host),
        p_u=put(state.p_u, u),
        p_v=put(state.p_v, v),
        p_idepth=put(state.p_idepth, idepth),
        p_idepth_zero=put(state.p_idepth_zero, idepth),
        p_color=put(state.p_color, color),
        p_weight=put(state.p_weight, weight),
        p_prior=put(state.p_prior, prior),
        p_res_good=put(state.p_res_good, const(state.p_res_good, True)),
        p_num_good=put(state.p_num_good, const(state.p_num_good, 0.0)),
        p_last_res=put(state.p_last_res, const(state.p_last_res, RES_IN)),
    )
