"""Direct loop-closure pose estimation (port of loop/pose_estimator.py).

Coarse-to-fine LM alignment of a matched keyframe's sparse metric points
(with per-level intensities) against the current keyframe's pyramid, with
the reference's acceptance gates on the level-0 residual, the inlier
ratio and the affine parameters. The LM policy is the tracker's (cutoff
doubling, one-shot level repeat).

The reference vmaps the LM over the seed stack; here the seed is the
batch dimension ``S``. On the card the whole LM of all seeds and levels
is one launch of kernel K4-LM (``ops/resident_lm.loop_pose_lm_cuda``);
the gates and the winner follow in PyTorch. Its plain version,
``estimate_seeds_plain`` (what CPU tensors take), is a Python loop with one
residual pass per LM iteration for the whole stack
(``ops/residual_hb.pose3d_residual_pass``). Each seed follows its own loop
exactly as under ``vmap``: a seed whose loop has ended keeps its carry
(and its own damping) while the others iterate, and the level repeat runs
only for the seeds that need it; the plain loop reads its conditions on
the host once per iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import SLAMConfig
from ..geometry import lie
from ..geometry.camera import PyramidIntrinsics
from ..models.tracker import AffLight, _solve_inc, _where, aff_from_to
from ..ops.resident_lm import loop_pose_lm_cuda
from ..ops.residual_hb import POSE_PRECOND, pose3d_residual_pass


class LoopPoseResult(NamedTuple):
    T: torch.Tensor            # refined [.., 4, 4] tfm_cur_matched
    pose_error: torch.Tensor   # sqrt(E/n) at level 0
    inlier_ratio: torch.Tensor
    aff: AffLight
    ok: torch.Tensor
    # which acceptance gate(s) passed
    ok_res: torch.Tensor = None
    ok_inlier: torch.Tensor = None
    ok_aff: torch.Tensor = None


class LoopPoseBatchResult(NamedTuple):
    best: LoopPoseResult          # winning seed (ok seeds first, then
    #                               lowest pose_error)
    seed_errors: torch.Tensor     # [S] per-seed pose_error
    seed_inliers: torch.Tensor    # [S] per-seed inlier ratio
    seed_ok: torch.Tensor         # [S]


def _select(mask, new, old):
    return type(old)(*[_select(mask, n_, o_) if isinstance(o_, tuple)
                       else _where(mask, n_, o_) for n_, o_ in zip(new, old)])


def _estimate_level(img_l, px, py, pz, pcolor_l, pmask, fx, fy, cx, cy, T0,
                    aff0: AffLight, ref_exposure, new_exposure, max_iters: int,
                    cfg: SLAMConfig, residual_pass, active=None):
    """One pyramid level of LM for the seed stack T0 [S, 4, 4]. ``active``
    [S] (default all) marks the seeds that run; the others keep their
    inputs. Returns (T, aff, E, n, num_in, cutoff_repeat)."""
    tc = cfg.tracker
    S = T0.shape[0]
    dev = T0.device
    if active is None:
        active = torch.ones(S, dtype=torch.bool, device=dev)
    zero = torch.zeros((), device=dev)

    def run_pass(T, aff, cutoff):
        a_rel, b_rel = aff_from_to(ref_exposure, zero, zero, new_exposure,
                                   aff.a, aff.b)
        return residual_pass(
            img_l, px, py, pz, pcolor_l, pmask, T[:, :3, :3], T[:, :3, 3],
            a_rel, b_rel, zero, fx, fy, cx, cy, tc.huber_th, cutoff)

    # ---- cutoff-doubling pre-loop -------------------------------------------
    repeat = torch.ones(S, dtype=torch.float32, device=dev)
    out0 = run_pass(T0, aff0, tc.coarse_cutoff_th * repeat)
    while True:
        cond = (active & (out0.stats.saturated_ratio > tc.saturated_ratio_repeat)
                & (repeat < tc.cutoff_repeat_max))
        if not bool(cond.any()):
            break
        repeat = torch.where(cond, repeat * 2.0, repeat)
        out0 = _select(cond, run_pass(T0, aff0, tc.coarse_cutoff_th * repeat), out0)
    cutoff = tc.coarse_cutoff_th * repeat

    # ---- LM loop -------------------------------------------------------------
    T, aff_a, aff_b = T0, aff0.a, aff0.b
    Hm, bm = out0.H, out0.b
    E, n, n_in = out0.stats.E, out0.stats.num_terms, out0.num_in
    lam = torch.full((S,), tc.lambda_init, dtype=torch.float32, device=dev)
    done = torch.zeros(S, dtype=torch.bool, device=dev)
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
        n_in = torch.where(acc_run, out.num_in, n_in)
        lam = torch.where(run, new_lam, lam)
        done = torch.where(run, torch.linalg.norm(inc, dim=1) <= tc.inc_break_norm, done)
    return T, AffLight(aff_a, aff_b), E, n, n_in, repeat


def estimate_seeds(pyr_cur, px, py, pz, pcolors, pmask, T_inits,
                   intr: PyramidIntrinsics, cfg: SLAMConfig, ref_exposure=1.0,
                   new_exposure=1.0) -> LoopPoseResult:
    """All seeds [S, 4, 4] over all levels; a LoopPoseResult of [S] fields.
    A CUDA pyramid launches kernel K4-LM once; CPU tensors take
    ``estimate_seeds_plain``."""
    if pyr_cur[0].is_cuda:
        o = loop_pose_lm_cuda(pyr_cur, px, py, pz, pcolors, pmask, T_inits, intr,
                              cfg, ref_exposure, new_exposure)
        return _gated(o.T, AffLight(o.a, o.b), o.x0, o.x1, pmask, cfg,
                      ref_exposure, new_exposure)
    return estimate_seeds_plain(pyr_cur, px, py, pz, pcolors, pmask, T_inits, intr,
                                cfg, ref_exposure, new_exposure)


def estimate_seeds_plain(pyr_cur, px, py, pz, pcolors, pmask, T_inits,
                         intr: PyramidIntrinsics, cfg: SLAMConfig, ref_exposure=1.0,
                         new_exposure=1.0,
                         residual_pass=pose3d_residual_pass) -> LoopPoseResult:
    """Plain version of K4-LM: the LM as a Python loop, one
    ``residual_pass`` per iteration for the whole stack (the plain pass on
    the CPU; on the card the per-pass kernel K4, or
    ``pose3d_residual_pass_plain`` to hold K4-LM against plain PyTorch
    throughout)."""
    levels = len(pyr_cur)
    tc = cfg.tracker
    dev = T_inits.device
    S = T_inits.shape[0]
    T = T_inits.to(torch.float32)
    aff = AffLight(torch.zeros(S, device=dev), torch.zeros(S, device=dev))
    have_repeated = torch.zeros(S, dtype=torch.bool, device=dev)
    E0 = torch.zeros(S, device=dev)
    n0 = torch.ones(S, device=dev)

    for lvl in range(levels - 1, -1, -1):
        args = (pyr_cur[lvl], px, py, pz, pcolors[:, lvl].contiguous(), pmask,
                float(intr.fx[lvl]), float(intr.fy[lvl]), float(intr.cx[lvl]),
                float(intr.cy[lvl]))
        max_it = tc.max_iterations[min(lvl, len(tc.max_iterations) - 1)]
        T, aff, E, n, n_inl, repeat = _estimate_level(
            *args, T, aff, ref_exposure, new_exposure, max_it, cfg, residual_pass)
        need_repeat = (repeat > 1.0) & ~have_repeated
        if bool(need_repeat.any()):
            T2, aff2, E2, n2, in2, _ = _estimate_level(
                *args, T, aff, ref_exposure, new_exposure, max_it, cfg,
                residual_pass, active=need_repeat)
            T = _where(need_repeat, T2, T)
            aff = AffLight(torch.where(need_repeat, aff2.a, aff.a),
                           torch.where(need_repeat, aff2.b, aff.b))
            E = torch.where(need_repeat, E2, E)
            n = torch.where(need_repeat, n2, n)
        have_repeated = have_repeated | (repeat > 1.0)
        if lvl == 0:
            E0, n0 = E, n
    return _gated(T, aff, E0, n0, pmask, cfg, ref_exposure, new_exposure)


def _gated(T, aff: AffLight, E0, n0, pmask, cfg: SLAMConfig, ref_exposure,
           new_exposure) -> LoopPoseResult:
    """Level 0's error and inlier ratio, and the reference's gates on them
    and on the affine parameters, per seed."""
    tc = cfg.tracker
    dev = T.device
    S = T.shape[0]
    pose_error = torch.sqrt(E0 / torch.clamp(n0, min=1.0))
    total = torch.clamp(torch.sum(pmask.to(torch.float32)), min=1.0)
    # "inner percent" counts every in-view term, saturated included (the
    # reference's numTermsInE, PoseEstimator.cpp:249-257, 483-484)
    inlier_ratio = 100.0 * n0 / total

    lp = cfg.loop
    ok_res = pose_error < lp.res_thres
    ok_inlier = inlier_ratio > lp.inner_percent
    ok_aff = torch.ones(S, dtype=torch.bool, device=dev)
    if tc.affine_mode_a != 0:
        ok_aff = ok_aff & (torch.abs(aff.a) <= tc.max_aff_a)
    if tc.affine_mode_b != 0:
        ok_aff = ok_aff & (torch.abs(aff.b) <= tc.max_aff_b)
    zero = torch.zeros((), device=dev)
    rel_a, rel_b = aff_from_to(ref_exposure, zero, zero, new_exposure, aff.a, aff.b)
    if tc.affine_mode_a == 0:
        ok_aff = ok_aff & (torch.abs(torch.log(torch.clamp(rel_a, min=1e-12)))
                           <= tc.max_rel_aff_log_a)
    if tc.affine_mode_b == 0:
        ok_aff = ok_aff & (torch.abs(rel_b) <= tc.max_rel_aff_b)
    ok = ok_res & ok_inlier & ok_aff
    return LoopPoseResult(T=T, pose_error=pose_error, inlier_ratio=inlier_ratio,
                          aff=aff, ok=ok, ok_res=ok_res, ok_inlier=ok_inlier,
                          ok_aff=ok_aff)


def _index(res: LoopPoseResult, i) -> LoopPoseResult:
    return LoopPoseResult(*[AffLight(f.a[i], f.b[i]) if isinstance(f, AffLight)
                            else f[i] for f in res])


def estimate(pyr_cur: Tuple[torch.Tensor, ...], px, py, pz, pcolors, pmask,
             T_init: torch.Tensor, intr: PyramidIntrinsics, cfg: SLAMConfig,
             ref_exposure=1.0, new_exposure=1.0) -> LoopPoseResult:
    """Single-seed estimate: ``pyr_cur`` the current KF's [H, W, 3] level
    planes, points [K] with per-level intensities ``pcolors`` [K, L],
    ``T_init`` [4, 4] the tfm_cur_matched seed."""
    res = estimate_seeds(pyr_cur, px, py, pz, pcolors, pmask, T_init[None], intr,
                         cfg, ref_exposure, new_exposure)
    return _index(res, 0)


def estimate_batch(pyr_cur: Tuple[torch.Tensor, ...], px, py, pz, pcolors, pmask,
                   T_inits: torch.Tensor, intr: PyramidIntrinsics, cfg: SLAMConfig,
                   ref_exposure=1.0, new_exposure=1.0) -> LoopPoseBatchResult:
    """Multi-seed direct alignment over the seed stack ``T_inits`` [S, 4, 4],
    then the reference's choice: the passing seed with the lowest
    pose_error; with none passing, the seed closest to acceptance
    (visibility-passing seeds by error, then any seed that sees a point).
    Ties go to the first index."""
    res = estimate_seeds(pyr_cur, px, py, pz, pcolors, pmask, T_inits, intr, cfg,
                         ref_exposure, new_exposure)
    inf = torch.full_like(res.pose_error, float("inf"))
    best_ok = torch.argmin(torch.where(res.ok, res.pose_error, inf))
    vis_key = torch.where(res.inlier_ratio > cfg.loop.inner_percent, res.pose_error,
                          torch.where(res.inlier_ratio > 0.0, res.pose_error + 1e3,
                                      inf))
    best_err = torch.argmin(vis_key)
    idx = torch.where(torch.any(res.ok), best_ok, best_err)
    return LoopPoseBatchResult(best=_index(res, idx), seed_errors=res.pose_error,
                               seed_inliers=res.inlier_ratio, seed_ok=res.ok)


def make_seed_stack(primary: np.ndarray, extras, yaw_perturb_deg) -> np.ndarray:
    """[S, 4, 4] seed stack: primary, then extras, then yaw perturbations
    of the primary about its own camera-frame Y axis."""
    seeds = [np.asarray(primary, np.float64)]
    for e in extras:
        seeds.append(np.asarray(e, np.float64))
    for deg in yaw_perturb_deg:
        th = np.deg2rad(deg)
        R = np.array([[np.cos(th), 0.0, np.sin(th), 0.0],
                      [0.0, 1.0, 0.0, 0.0],
                      [-np.sin(th), 0.0, np.cos(th), 0.0],
                      [0.0, 0.0, 0.0, 1.0]])
        seeds.append(np.asarray(primary, np.float64) @ R)
    return np.stack(seeds).astype(np.float32)
