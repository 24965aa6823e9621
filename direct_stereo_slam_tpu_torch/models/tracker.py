"""Coarse-to-fine LM pose tracker (port of models/tracker.py).

The policy of the reference's ``trackNewestCoarse``: per-level LM with
accept/reject and the 0.5x/4x lambda schedule, the increment-norm break,
the cutoff-doubling pre-loop while >60% of residuals saturate, the
one-shot level repeat after a cutoff-doubled level, affine gates, and the
flow indicators of the finest level.

Candidates are a batch dimension (the reference vmaps): ``track_candidate``
is the batch of one. On the card ``track_candidates_batch`` is one launch
of kernel K2-LM (``ops/resident_lm.track_lm_cuda``), which runs every
level, pass and LM step of every candidate on the device; the acceptance
gates follow in PyTorch. Its plain version, ``track_candidates_batch_plain``
(what CPU tensors take), is the same policy as a Python loop over one
residual pass per LM iteration for the whole batch
(``ops/residual_hb.pose_residual_pass``): each candidate follows its own
loop exactly as under ``vmap`` — a candidate whose loop has ended keeps
its carry while the others iterate — and the loop conditions are read on
the host once per iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import SLAMConfig
from ..geometry import lie
from ..geometry.camera import PyramidIntrinsics
from ..ops.resident_lm import track_lm_cuda
from ..ops.residual_hb import POSE_PRECOND, pose_residual_pass
from .depth_template import TrackerTemplate


class AffLight(NamedTuple):
    """DSO AffLight: per-frame brightness-transfer params (a, b)."""

    a: torch.Tensor
    b: torch.Tensor


def aff_from_to(exp_f, a_f, b_f, exp_t, a_t, b_t):
    """DSO ``AffLight::fromToVecExposure``: relative (a, b) mapping frame
    F's intensities onto frame T's."""
    den = clamp_min(exp_f, 1e-9)
    if isinstance(den, torch.Tensor) and not isinstance(exp_t, torch.Tensor):
        # number / tensor is reciprocal(tensor) * number in PyTorch, which
        # rounds differently from the reference's f32 division
        exp_t = torch.full_like(den, exp_t)
    a = torch.exp(a_t - a_f) * (exp_t / den)
    b = b_t - a * b_f
    return a, b


def clamp_min(x, m: float):
    """max(x, m) for a tensor or a Python number."""
    return torch.clamp(x, min=m) if isinstance(x, torch.Tensor) else max(x, m)


def solve(A, b):
    """Batched dense solve without the host sync of ``torch.linalg.solve``'s
    singularity check: like the reference's solve, a singular system yields
    non-finite values, which the callers' isfinite guards reject."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


class TrackResult(NamedTuple):
    T: torch.Tensor                # [.., 4, 4] ref-to-new
    aff: AffLight                  # new frame's (a, b)
    res_per_level: torch.Tensor    # [.., L] sqrt(E/n) at each level's end
    flow: torch.Tensor             # [.., 3] (flow_t, 0, flow_rt) from level 0
    ok: torch.Tensor               # bool: gates passed, residuals finite


def _solve_inc(H, b, lam, cfg: SLAMConfig):
    """LM-damped solve with DSO's affine-mode sub-block logic. H [B, 8, 8],
    b [B, 8], lam [B]."""
    Hl = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
    mode_a, mode_b = cfg.tracker.affine_mode_a, cfg.tracker.affine_mode_b
    zeros = lambda k: torch.zeros(b.shape[0], k, dtype=b.dtype, device=b.device)
    if mode_a < 0 and mode_b < 0:       # fix both
        inc6 = solve(Hl[:, :6, :6], -b[:, :6])
        return torch.cat([inc6, zeros(2)], dim=1)
    if mode_a >= 0 and mode_b < 0:      # fix b
        inc7 = solve(Hl[:, :7, :7], -b[:, :7])
        return torch.cat([inc7, zeros(1)], dim=1)
    if mode_a < 0 and mode_b >= 0:      # fix a (stitch b into slot 6)
        idx = torch.tensor([0, 1, 2, 3, 4, 5, 7], device=b.device)
        inc7 = solve(Hl[:, idx][:, :, idx], -b[:, idx])
        return torch.cat([inc7[:, :6], zeros(1), inc7[:, 6:7]], dim=1)
    return solve(Hl, -b)   # optimize both


def _where(mask, a, b):
    """Per-candidate select: mask [B] against [B, ...] operands."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _track_level(img_l, tmpl_pu, tmpl_pv, tmpl_pid, tmpl_pcolor, tmpl_pmask,
                 Ki_l, fx, fy, cx, cy, T0, aff0: AffLight, ref_aff: AffLight,
                 ref_exposure, new_exposure, max_iters: int, cfg: SLAMConfig,
                 compute_flow: bool, residual_pass, active=None):
    """One pyramid level of LM for a batch: T0 [B, 4, 4], aff0 fields [B].
    ``active`` [B] (default all) marks candidates that run this level; the
    others keep their inputs (the reference's 0/1-iteration repeat loop).
    Returns (T, aff, E, n, flow_t, flow_rt, cutoff_repeat)."""
    tc = cfg.tracker
    huber = tc.huber_th
    B = T0.shape[0]
    dev = T0.device
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=dev)

    def run_pass(T, aff, cutoff):
        a_rel, b_rel = aff_from_to(ref_exposure, ref_aff.a, ref_aff.b,
                                   new_exposure, aff.a, aff.b)
        return residual_pass(
            img_l, tmpl_pu, tmpl_pv, tmpl_pid, tmpl_pcolor, tmpl_pmask,
            T[:, :3, :3] @ Ki_l, Ki_l, T[:, :3, 3], a_rel, b_rel, ref_aff.b,
            fx, fy, cx, cy, huber, cutoff, compute_flow=compute_flow)

    def select(mask, new, old):
        return type(old)(*[select(mask, n_, o_) if isinstance(o_, tuple)
                           else _where(mask, n_, o_) for n_, o_ in zip(new, old)])

    # ---- cutoff-doubling pre-loop -------------------------------------------
    repeat = torch.ones(B, dtype=torch.float32, device=dev)
    out0 = run_pass(T0, aff0, tc.coarse_cutoff_th * repeat)
    while True:
        cond = (active & (out0.stats.saturated_ratio > tc.saturated_ratio_repeat)
                & (repeat < tc.cutoff_repeat_max))
        if not bool(cond.any()):
            break
        repeat = torch.where(cond, repeat * 2.0, repeat)
        out0 = select(cond, run_pass(T0, aff0, tc.coarse_cutoff_th * repeat), out0)
    cutoff = tc.coarse_cutoff_th * repeat

    # ---- LM loop -------------------------------------------------------------
    T, aff_a, aff_b = T0, aff0.a, aff0.b
    Hm, bm = out0.H, out0.b
    E, n = out0.stats.E, out0.stats.num_terms
    flow_t, flow_rt = out0.stats.flow_t, out0.stats.flow_rt
    lam = torch.full((B,), tc.lambda_init, dtype=torch.float32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    lim = tc.lambda_extrapolation_limit
    for _ in range(max_iters):
        run = active & ~done
        if not bool(run.any()):
            break
        inc = _solve_inc(Hm, bm, lam, cfg)
        extrap = torch.where(lam < lim, torch.sqrt(torch.sqrt(lim / lam)),
                             torch.ones_like(lam))
        inc = inc * extrap[:, None]
        inc_scaled = inc * POSE_PRECOND.to(dev)
        inc_scaled = torch.where(torch.isfinite(torch.sum(inc_scaled, dim=1))[:, None],
                                 inc_scaled, torch.zeros_like(inc_scaled))
        T_new = lie.se3_exp(inc_scaled[:, :6]) @ T
        aff_new = AffLight(aff_a + inc_scaled[:, 6], aff_b + inc_scaled[:, 7])
        out = run_pass(T_new, aff_new, cutoff)
        accept = (out.stats.E / torch.clamp(out.stats.num_terms, min=1.0)) < (
            E / torch.clamp(n, min=1.0))
        acc_run = run & accept
        new_lam = torch.where(accept, lam * tc.lambda_accept_factor,
                              torch.clamp(lam * tc.lambda_reject_factor, min=lim))
        T = _where(acc_run, T_new, T)
        aff_a = torch.where(acc_run, aff_new.a, aff_a)
        aff_b = torch.where(acc_run, aff_new.b, aff_b)
        Hm = _where(acc_run, out.H, Hm)
        bm = _where(acc_run, out.b, bm)
        E = torch.where(acc_run, out.stats.E, E)
        n = torch.where(acc_run, out.stats.num_terms, n)
        flow_t = torch.where(acc_run, out.stats.flow_t, flow_t)
        flow_rt = torch.where(acc_run, out.stats.flow_rt, flow_rt)
        lam = torch.where(run, new_lam, lam)
        done = torch.where(run, torch.linalg.norm(inc, dim=1) <= tc.inc_break_norm, done)
    return T, AffLight(aff_a, aff_b), E, n, flow_t, flow_rt, repeat


def track_candidates_batch(pyr_new: Tuple[torch.Tensor, ...],
                           template: TrackerTemplate, intr: PyramidIntrinsics,
                           cfg: SLAMConfig, T_inits: torch.Tensor,
                           aff_init: AffLight, ref_aff: AffLight, ref_exposure,
                           new_exposure) -> TrackResult:
    """Track B pose candidates ([B, 4, 4]) over all levels, coarse to fine,
    with the one-shot level repeat after a cutoff-doubled level. A CUDA
    pyramid launches kernel K2-LM once; CPU tensors take
    ``track_candidates_batch_plain``."""
    if pyr_new[0].is_cuda:
        o = track_lm_cuda(pyr_new, template, intr, cfg, T_inits, aff_init,
                          ref_aff, ref_exposure, new_exposure)
        return _gated(o.T, AffLight(o.a, o.b), o.res, o.x0, o.x1, cfg, ref_aff,
                      ref_exposure, new_exposure)
    return track_candidates_batch_plain(pyr_new, template, intr, cfg, T_inits,
                                        aff_init, ref_aff, ref_exposure,
                                        new_exposure)


def track_candidates_batch_plain(pyr_new: Tuple[torch.Tensor, ...],
                                 template: TrackerTemplate,
                                 intr: PyramidIntrinsics, cfg: SLAMConfig,
                                 T_inits: torch.Tensor, aff_init: AffLight,
                                 ref_aff: AffLight, ref_exposure, new_exposure,
                                 residual_pass=pose_residual_pass) -> TrackResult:
    """Plain version of K2-LM: the LM as a Python loop, one
    ``residual_pass`` per iteration for the whole batch (the plain pass on
    the CPU; on the card the per-pass kernel K2, or ``pose_residual_pass_plain``
    to hold K2-LM against plain PyTorch throughout)."""
    levels = template.levels
    tc = cfg.tracker
    dev = T_inits.device
    B = T_inits.shape[0]
    T = T_inits.to(torch.float32)
    full = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(-1).expand(B).clone()
    aff = AffLight(full(aff_init.a), full(aff_init.b))
    res_levels = [None] * levels
    flow_t = flow_rt = torch.zeros(B, device=dev)
    have_repeated = torch.zeros(B, dtype=torch.bool, device=dev)

    for lvl in range(levels - 1, -1, -1):
        Ki_l = torch.as_tensor(intr.Ki(lvl), dtype=torch.float32, device=dev)
        args = (pyr_new[lvl], template.pu[lvl], template.pv[lvl],
                template.pid[lvl], template.pcolor[lvl], template.pmask[lvl],
                Ki_l, intr.fx[lvl], intr.fy[lvl], intr.cx[lvl], intr.cy[lvl])
        max_it = tc.max_iterations[min(lvl, len(tc.max_iterations) - 1)]
        T, aff, E, n, f_t, f_rt, repeat = _track_level(
            *args, T, aff, ref_aff, ref_exposure, new_exposure, max_it, cfg,
            compute_flow=(lvl == 0), residual_pass=residual_pass)
        need_repeat = (repeat > 1.0) & ~have_repeated
        if bool(need_repeat.any()):
            T2, aff2, E2, n2, ft2, frt2, _ = _track_level(
                *args, T, aff, ref_aff, ref_exposure, new_exposure, max_it, cfg,
                compute_flow=(lvl == 0), residual_pass=residual_pass,
                active=need_repeat)
            T = _where(need_repeat, T2, T)
            aff = AffLight(torch.where(need_repeat, aff2.a, aff.a),
                           torch.where(need_repeat, aff2.b, aff.b))
            E = torch.where(need_repeat, E2, E)
            n = torch.where(need_repeat, n2, n)
            f_t = torch.where(need_repeat, ft2, f_t)
            f_rt = torch.where(need_repeat, frt2, f_rt)
        have_repeated = have_repeated | (repeat > 1.0)
        # vacuous tracking (no surviving terms) must read as failure
        res_levels[lvl] = torch.where(
            n > 0, torch.sqrt(E / torch.clamp(n, min=1.0)),
            torch.full_like(E, float("inf")))
        if lvl == 0:
            flow_t, flow_rt = f_t, f_rt

    return _gated(T, aff, torch.stack(res_levels, dim=1), flow_t, flow_rt, cfg,
                  ref_aff, ref_exposure, new_exposure)


def _gated(T, aff: AffLight, res, flow_t, flow_rt, cfg: SLAMConfig,
           ref_aff: AffLight, ref_exposure, new_exposure) -> TrackResult:
    """The acceptance gates on the tracked batch (residuals finite, affine
    bounds by mode), then the affine of a fixed mode zeroed."""
    tc = cfg.tracker
    ok = torch.all(torch.isfinite(res), dim=1)
    if tc.affine_mode_a != 0:
        ok = ok & (torch.abs(aff.a) <= tc.max_aff_a)
    if tc.affine_mode_b != 0:
        ok = ok & (torch.abs(aff.b) <= tc.max_aff_b)
    rel_a, rel_b = aff_from_to(ref_exposure, ref_aff.a, ref_aff.b, new_exposure,
                               aff.a, aff.b)
    if tc.affine_mode_a == 0:
        ok = ok & (torch.abs(torch.log(torch.clamp(rel_a, min=1e-12)))
                   <= tc.max_rel_aff_log_a)
    if tc.affine_mode_b == 0:
        ok = ok & (torch.abs(rel_b) <= tc.max_rel_aff_b)
    if tc.affine_mode_a < 0:
        aff = AffLight(torch.zeros_like(aff.a), aff.b)
    if tc.affine_mode_b < 0:
        aff = AffLight(aff.a, torch.zeros_like(aff.b))
    zero = torch.zeros_like(flow_t)
    return TrackResult(T=T, aff=aff, res_per_level=res,
                       flow=torch.stack([flow_t, zero, flow_rt], dim=1), ok=ok)


def track_candidate(pyr_new, template: TrackerTemplate, intr: PyramidIntrinsics,
                    cfg: SLAMConfig, T_init: torch.Tensor, aff_init: AffLight,
                    ref_aff: AffLight, ref_exposure, new_exposure) -> TrackResult:
    """Track one pose candidate ([4, 4]): the batch of one."""
    r = track_candidates_batch(pyr_new, template, intr, cfg, T_init[None],
                               aff_init, ref_aff, ref_exposure, new_exposure)
    return TrackResult(T=r.T[0], aff=AffLight(r.aff.a[0], r.aff.b[0]),
                       res_per_level=r.res_per_level[0], flow=r.flow[0], ok=r.ok[0])


def make_motion_tries(T_const: np.ndarray, T_last_to_slast: np.ndarray,
                      T_fh_to_slast: np.ndarray, cfg: SLAMConfig):
    """Candidate pose lists, host side: (stage1 [5,4,4], stage2 [78,4,4]) —
    const/double/half/zero-motion/zero-from-KF, then 26 rotation sign
    patterns x 3 deltas on top of the constant-motion hypothesis."""
    inv = np.linalg.inv
    fh2slast = T_fh_to_slast
    stage1 = np.stack([
        inv(fh2slast) @ T_last_to_slast,
        inv(fh2slast) @ inv(fh2slast) @ T_last_to_slast,
        _half_motion(fh2slast) @ T_last_to_slast,
        T_last_to_slast,
        np.eye(4, dtype=np.float64),
    ]).astype(np.float32)
    rot_signs = [
        (1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 0, 0), (0, -1, 0),
        (0, 0, -1), (1, 1, 0), (0, 1, 1), (1, 0, 1), (-1, 1, 0),
        (0, -1, 1), (-1, 0, 1), (1, -1, 0), (0, 1, -1), (1, 0, -1),
        (-1, -1, 0), (0, -1, -1), (-1, 0, -1), (-1, -1, -1), (-1, -1, 1),
        (-1, 1, -1), (-1, 1, 1), (1, -1, -1), (1, -1, 1), (1, 1, -1),
        (1, 1, 1),
    ]
    T_c = stage1[0].astype(np.float64)
    out = []
    for delta in cfg.tracker.rot_perturbation_deltas:
        for rs in rot_signs:
            q = np.array([1.0, rs[0] * delta, rs[1] * delta, rs[2] * delta])
            q = q / np.linalg.norm(q)
            w, x, y, z = q
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ])
            P = np.eye(4)
            P[:3, :3] = R
            out.append(T_c @ P)
    return stage1, np.stack(out).astype(np.float32)


def _half_motion(T: np.ndarray) -> np.ndarray:
    """SE3::exp(0.5 * log(T))^{-1}, numpy."""
    xi = lie.se3_log_np(T)
    return np.linalg.inv(lie.se3_exp_np(0.5 * xi))


def select_winner(results, last_rmse: float, cfg: SLAMConfig):
    """First in-order candidate beating re_track_threshold * last_rmse,
    else the argmin residual among good candidates (host arrays)."""
    res0 = np.asarray(results.res_per_level[:, 0])
    ok = np.asarray(results.ok) & np.isfinite(res0)
    thresh = cfg.tracker.re_track_threshold * last_rmse
    order_hit = np.where(ok & (res0 < thresh))[0]
    if len(order_hit) > 0:
        return int(order_hit[0]), True
    if ok.any():
        return int(np.argmin(np.where(ok, res0, np.inf))), True
    return 0, False


def select_winner_serial(results, last_rmse: float, cfg: SLAMConfig):
    """Reference-exact serial try-list walk over evaluated candidates."""
    res = np.asarray(results.res_per_level)
    ok = np.asarray(results.ok)
    achieved = np.full(res.shape[1], np.nan)
    thresh = cfg.tracker.re_track_threshold * last_rmse
    best, have = 0, False
    for i in range(res.shape[0]):
        r0 = res[i, 0]
        bar = achieved[0] if np.isfinite(achieved[0]) else np.inf
        if ok[i] and np.isfinite(r0) and not (r0 >= bar):
            best, have = i, True
        if have:
            upd = ~np.isfinite(achieved) | (achieved > res[i])
            achieved = np.where(upd, res[i], achieved)
        if have and achieved[0] < thresh:
            break
    return best, have
