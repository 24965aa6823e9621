"""Stereo 1-DoF scale optimizer (port of models/scale_opt.py).

Coarse-to-fine LM over the single scale parameter: the tracker template
is projected into the second camera through the fixed stereo extrinsics
with a scaled rotation term. The grid of initial guesses is a batch
dimension. On the card ``optimize_scale_batch`` is one launch of kernel
K3-LM (``ops/resident_lm.scale_lm_cuda``), which runs every level, pass
and LM step of every guess on the device with no host read. Its plain
version, ``optimize_scale_batch_plain`` (what CPU tensors take), is the
same LM as a Python loop over one residual pass per LM iteration for all
guesses (``ops/residual_hb.scale_residual_pass``): each guess follows its
own loop exactly as under ``vmap``, and the loop conditions are read on
the host once per iteration. The trap/untrap state machine stays on the
host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import SLAMConfig
from ..geometry.camera import PyramidIntrinsics
from ..ops.resident_lm import scale_lm_cuda
from ..ops.residual_hb import scale_residual_pass
from .depth_template import TrackerTemplate


class ScaleOptResult(NamedTuple):
    scale: torch.Tensor       # optimized scale
    error: torch.Tensor       # sqrt(E/n) at finest level


def _optimize_scale_level(img1_l, pu, pv, pid, pcolor, pmask, R01Ki_l, Ki0_l,
                          t01, fx1, fy1, cx1, cy1, scale0, max_iters: int,
                          cfg: SLAMConfig, residual_pass, active=None):
    """One level of LM for G guesses (scale0 [G]). Returns (s, E, n, repeat)."""
    tc = cfg.tracker
    G = scale0.shape[0]
    dev = scale0.device
    if active is None:
        active = torch.ones(G, dtype=torch.bool, device=dev)

    def run_pass(s, cutoff):
        return residual_pass(img1_l, pu, pv, pid, pcolor, pmask, R01Ki_l, Ki0_l,
                             t01, s, fx1, fy1, cx1, cy1, tc.huber_th, cutoff)

    def sel(mask, new, old):
        return type(old)(*[sel(mask, n_, o_) if isinstance(o_, tuple)
                           else torch.where(mask, n_, o_) for n_, o_ in zip(new, old)])

    repeat = torch.ones(G, dtype=torch.float32, device=dev)
    out0 = run_pass(scale0, tc.coarse_cutoff_th * repeat)
    while True:
        cond = (active & (out0.stats.saturated_ratio > tc.saturated_ratio_repeat)
                & (repeat < tc.cutoff_repeat_max))
        if not bool(cond.any()):
            break
        repeat = torch.where(cond, repeat * 2.0, repeat)
        out0 = sel(cond, run_pass(scale0, tc.coarse_cutoff_th * repeat), out0)
    cutoff = tc.coarse_cutoff_th * repeat

    s = scale0
    Hc, bc = out0.H, out0.b
    E, n = out0.stats.E, out0.stats.num_terms
    lam = torch.full((G,), tc.lambda_init, dtype=torch.float32, device=dev)
    done = torch.zeros(G, dtype=torch.bool, device=dev)
    lim = tc.lambda_extrapolation_limit
    for _ in range(max_iters):
        run = active & ~done
        if not bool(run.any()):
            break
        Hl = Hc * (1.0 + lam)
        inc = -bc / torch.where(torch.abs(Hl) < 1e-20, torch.full_like(Hl, 1e-20), Hl)
        extrap = torch.where(lam < lim, torch.sqrt(torch.sqrt(lim / lam)),
                             torch.ones_like(lam))
        inc = inc * extrap
        # reject non-finite or over-large steps
        inc = torch.where(torch.isfinite(inc) & (torch.abs(inc) <= s), inc,
                          torch.zeros_like(inc))
        s_new = s + inc
        out = run_pass(s_new, cutoff)
        accept = (out.stats.E / torch.clamp(out.stats.num_terms, min=1.0)) < (
            E / torch.clamp(n, min=1.0))
        acc_run = run & accept
        s = torch.where(acc_run, s_new, s)
        Hc = torch.where(acc_run, out.H, Hc)
        bc = torch.where(acc_run, out.b, bc)
        E = torch.where(acc_run, out.stats.E, E)
        n = torch.where(acc_run, out.stats.num_terms, n)
        new_lam = torch.where(accept, lam * tc.lambda_accept_factor,
                              torch.clamp(lam * tc.lambda_reject_factor, min=lim))
        lam = torch.where(run, new_lam, lam)
        # the reference breaks on inc <= 1e-3 (signed); the JAX package and
        # this port use |inc|
        done = torch.where(run, torch.abs(inc) <= tc.inc_break_norm, done)
    return s, E, n, repeat


def optimize_scale_batch(pyr1: Tuple[torch.Tensor, ...], template: TrackerTemplate,
                         scales0: torch.Tensor, intr0: PyramidIntrinsics,
                         intr1: PyramidIntrinsics, t_cam1_cam0: np.ndarray,
                         cfg: SLAMConfig) -> ScaleOptResult:
    """Full coarse-to-fine scale optimization for G initial guesses,
    including the one-shot level repeat. A CUDA pyramid launches kernel
    K3-LM once (``t_cam1_cam0`` a host array); CPU tensors take
    ``optimize_scale_batch_plain``."""
    if pyr1[0].is_cuda:
        o = scale_lm_cuda(pyr1, template, scales0, intr0, intr1, t_cam1_cam0, cfg)
        return ScaleOptResult(scale=o.scale, error=o.error)
    return optimize_scale_batch_plain(pyr1, template, scales0, intr0, intr1,
                                      t_cam1_cam0, cfg)


def optimize_scale_batch_plain(pyr1: Tuple[torch.Tensor, ...],
                               template: TrackerTemplate, scales0: torch.Tensor,
                               intr0: PyramidIntrinsics, intr1: PyramidIntrinsics,
                               t_cam1_cam0, cfg: SLAMConfig,
                               residual_pass=scale_residual_pass) -> ScaleOptResult:
    """Plain version of K3-LM: the LM as a Python loop, one
    ``residual_pass`` per iteration for all guesses (the plain pass on the
    CPU; on the card the per-pass kernel K3, or
    ``scale_residual_pass_plain`` to hold K3-LM against plain PyTorch
    throughout)."""
    levels = template.levels
    tc = cfg.tracker
    dev = pyr1[0].device
    t_cam1_cam0 = torch.as_tensor(t_cam1_cam0, dtype=torch.float32, device=dev)
    R01 = t_cam1_cam0[:3, :3]
    t01 = t_cam1_cam0[:3, 3]
    s = torch.as_tensor(scales0, dtype=torch.float32, device=dev).reshape(-1)
    err = torch.full_like(s, float("nan"))
    have_repeated = torch.zeros_like(s, dtype=torch.bool)

    for lvl in range(levels - 1, -1, -1):
        Ki0_l = torch.as_tensor(intr0.Ki(lvl), dtype=torch.float32, device=dev)
        R01Ki_l = R01 @ Ki0_l
        args = (pyr1[lvl], template.pu[lvl], template.pv[lvl], template.pid[lvl],
                template.pcolor[lvl], template.pmask[lvl], R01Ki_l, Ki0_l, t01,
                intr1.fx[lvl], intr1.fy[lvl], intr1.cx[lvl], intr1.cy[lvl])
        max_it = tc.max_iterations[min(lvl, len(tc.max_iterations) - 1)]
        s, E, n, repeat = _optimize_scale_level(*args, s, max_it, cfg, residual_pass)
        need_repeat = (repeat > 1.0) & ~have_repeated
        if bool(need_repeat.any()):
            s2, E2, n2, _ = _optimize_scale_level(*args, s, max_it, cfg, residual_pass,
                                                  active=need_repeat)
            s = torch.where(need_repeat, s2, s)
            E = torch.where(need_repeat, E2, E)
            n = torch.where(need_repeat, n2, n)
        have_repeated = have_repeated | (repeat > 1.0)
        if lvl == 0:
            err = torch.sqrt(E / torch.clamp(n, min=1.0))
    return ScaleOptResult(scale=s, error=err)


def optimize_scale_single(pyr1, template, intr0, intr1, t_cam1_cam0,
                          cfg: SLAMConfig, scale0) -> ScaleOptResult:
    """One initial guess: the batch of one."""
    r = optimize_scale_batch(pyr1, template, torch.as_tensor(scale0).reshape(1),
                             intr0, intr1, t_cam1_cam0, cfg)
    return ScaleOptResult(scale=r.scale[0], error=r.error[0])


@dataclasses.dataclass
class ScaleState:
    """Host-side trap/untrap state machine (survives FrontEnd reinit)."""

    trapped: bool = False
    consecutive_fails: int = 0


def dispatch_scale_optimization(pyr1, template: TrackerTemplate,
                                intr0: PyramidIntrinsics,
                                intr1: PyramidIntrinsics, t_cam1_cam0,
                                cfg: SLAMConfig, state: ScaleState) -> ScaleOptResult:
    """Device half: the (possibly batched) scale LM; pair with
    ``decide_scale_optimization``."""
    so = cfg.scale_opt
    guesses = (1.0,) if state.trapped else tuple(so.grid_guesses)
    return optimize_scale_batch(tuple(pyr1), template,
                                _guesses(guesses, pyr1[0].device), intr0, intr1,
                                t_cam1_cam0, cfg)


@functools.lru_cache(maxsize=None)
def _guesses(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """The guesses as a tensor on the device, made once: a copy from the
    host each keyframe would wait for the stream. Never written to."""
    return torch.tensor(np.array(values, np.float32), device=device)


def decide_scale_optimization(scales: np.ndarray, errors: np.ndarray,
                              cfg: SLAMConfig, state: ScaleState):
    """Host half: the reference's accept/trap/untrap state machine.
    Returns (accepted, scale, scale_error, state); ``scale_error < 0``
    encodes rejection/disabled."""
    so = cfg.scale_opt
    ok = errors > 0
    if ok.any():
        best = int(np.argmin(np.where(ok, errors, np.inf)))
        new_scale = float(scales[best])
        scale_error = float(errors[best])
    else:
        new_scale, scale_error = 1.0, -1.0
    succeed = 0 <= scale_error < so.accept_thres
    if state.trapped and abs(new_scale - 1.0) > so.trapped_jump_thres:
        succeed = False
    state.consecutive_fails = 0 if succeed else state.consecutive_fails + 1
    if state.consecutive_fails > so.max_consecutive_fails:
        state.trapped = False
        scale_error = -1.0
    if succeed and not state.trapped:
        state.trapped = True
    return succeed, new_scale, scale_error, state


def run_scale_optimization(pyr1, template, intr0, intr1, t_cam1_cam0,
                           cfg: SLAMConfig, state: ScaleState):
    """One keyframe's scale optimization with the reference's accept logic."""
    if cfg.scale_opt.accept_thres < 0:
        return False, 1.0, -1.0, state
    out = dispatch_scale_optimization(pyr1, template, intr0, intr1, t_cam1_cam0,
                                      cfg, state)
    scales, errors = torch.stack([out.scale, out.error]).cpu().numpy()
    return decide_scale_optimization(scales, errors, cfg, state)
