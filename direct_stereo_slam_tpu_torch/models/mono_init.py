"""Monocular bootstrap initializer (port of models/mono_init.py).

DSO's ``CoarseInitializer`` (reference call sites FrontEnd.cpp:607-623,
842-934): two-frame direct alignment that jointly optimizes the relative
pose, the affine brightness and a per-point inverse depth, coarse to
fine, with a prior pulling idepths toward 1 until the baseline is large
enough ("snapped"); after the snap the prior gives way to a coupling of
each point to the median of its 10 image-plane neighbours. Points are
fixed-budget per-level sets (level 0 from the pixel selector, coarser
levels one gradient argmax per grid cell), linked to their nearest
coarser point for the idepth blend down the pyramid (``propagateDown``);
the per-point idepths are eliminated by a Schur complement.

The reference's arithmetic order is kept: this bootstrap is sensitive to
the last ulp (one change of gather form in the reference moved its
end-to-end ATE from 0.19 m to 0.81 m). Three of its primitives need care
in PyTorch: ``jnp.median`` over an even count averages the two middle
values (``torch.median`` returns the lower one); ``jax.lax.top_k`` breaks
ties by the lower index, and the KNN graph of integer pixel grids is full
of ties (a stable sort keeps that order); ``jnp.nonzero(size=, fill_value=)``
is ``utils.compact.nonzero_fixed``.

``track_frame`` reads nothing back from the device: its loop counts are
fixed (6 Gauss-Newton iterations per level, 10 at level 0), and the
snap decision stays on the device until ``is_done`` reads it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import SLAMConfig
from ..geometry import lie
from ..geometry.camera import PyramidIntrinsics
from ..ops.interp import bilinear_gather
from ..ops.pyramid import Pyramid
from ..ops.select import make_selection_map
from ..utils.compact import nonzero_fixed
from ..utils.device import to_device
from .tracker import solve

_K_NN = 10


class MonoInitState(NamedTuple):
    """Per-level point hierarchies (tuples indexed by pyramid level; each
    level's coordinates are in that level's pixel units)."""

    u: Tuple[torch.Tensor, ...]        # [N_l]
    v: Tuple[torch.Tensor, ...]
    color: Tuple[torch.Tensor, ...]    # [N_l] intensity at that level
    idepth: Tuple[torch.Tensor, ...]   # [N_l]
    valid: Tuple[torch.Tensor, ...]    # [N_l] bool
    knn: Tuple[torch.Tensor, ...]      # [N_l, K] same-level neighbours (int64)
    parent: Tuple[torch.Tensor, ...]   # [N_l] index into level l+1 (int64)
    T: torch.Tensor                    # [4, 4] first-to-current estimate
    snapped: torch.Tensor              # bool
    snapped_count: torch.Tensor        # int32, frames tracked since the snap
    resid0: torch.Tensor               # [N_0] |photometric residual| at the
                                       # latest frame (inf = out of view)

    @property
    def levels(self) -> int:
        return len(self.u)


def _median10(x: torch.Tensor) -> torch.Tensor:
    """jnp.median over the last axis of [N, 10]: the mean of the two
    middle values, as (low + high) * 0.5."""
    s = torch.sort(x, dim=-1).values
    return (s[..., 4] + s[..., 5]) * 0.5


def _knn_graph(u, v, lane_ok, budget: int):
    """Fixed image-plane KNN graph (DSO CoarseInitializer::makeNN):
    invalid lanes and neighbours resolve to self, so the coupling is
    inert there. Ties go to the lower index, as ``lax.top_k`` breaks them."""
    d2 = (u[:, None] - u[None, :]) ** 2 + (v[:, None] - v[None, :]) ** 2
    d2 = torch.where(lane_ok[None, :], d2, torch.full_like(d2, float("inf")))
    d2.fill_diagonal_(float("inf"))
    knn = torch.sort(d2, dim=1, stable=True).indices[:, :_K_NN]
    self_idx = torch.arange(budget, device=u.device)[:, None].expand(budget, _K_NN)
    nb_ok = lane_ok[knn] & lane_ok[:, None]
    return torch.where(nb_ok, knn, self_idx)


def _grid_select(abs_grad_l: torch.Tensor, budget: int, min_grad: float = 1.0):
    """Coarse-level candidates: the gradient argmax of each cell of a grid
    sized to the budget (first maximum on ties). Returns (u, v, lane_ok)
    with N == budget."""
    H, W = abs_grad_l.shape
    dev = abs_grad_l.device
    cx = max(1, int(np.ceil(np.sqrt(budget * W / max(H, 1)))))
    cy = max(1, int(np.ceil(budget / cx)))
    bh = max(1, int(np.ceil(H / cy)))
    bw = max(1, int(np.ceil(W / cx)))
    ph, pw = cy * bh, cx * bw
    g = torch.nn.functional.pad(abs_grad_l, (0, pw - W, 0, ph - H), value=-1.0)
    ys = torch.arange(ph, device=dev)[:, None]
    xs = torch.arange(pw, device=dev)[None, :]
    g = torch.where((ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3), g,
                    torch.full_like(g, -1.0))
    blocks = g.reshape(cy, bh, cx, bw).permute(0, 2, 1, 3).reshape(cy * cx, bh * bw)
    arg = torch.argmax(blocks, dim=1)
    val = torch.gather(blocks, 1, arg[:, None])[:, 0]
    cell = torch.arange(cy * cx, device=dev)
    u = (cell % cx * bw + arg % bw).to(torch.float32)
    v = (cell // cx * bh + arg // bw).to(torch.float32)
    ok = val > min_grad
    n = cy * cx
    if n < budget:
        pad = budget - n
        u = torch.cat([u, torch.zeros(pad, device=dev)])
        v = torch.cat([v, torch.zeros(pad, device=dev)])
        ok = torch.cat([ok, torch.zeros(pad, dtype=torch.bool, device=dev)])
    return u[:budget], v[:budget], ok[:budget]


def create(pyr0: Pyramid, cfg: SLAMConfig, budget: int = 1024,
           pot: int = 6) -> MonoInitState:
    """The per-level point hierarchies of the first frame
    (CoarseInitializer::setFirst): level 0 through the pixel selector,
    coarser levels through ``_grid_select``; each point's parent is its
    nearest coarser-level point."""
    levels = pyr0.levels
    dev = pyr0.data[0].device
    us, vs, cols, ids, oks, knns = [], [], [], [], [], []
    for lvl in range(levels):
        bud = max(64, budget >> lvl)
        if lvl == 0:
            sel, _ = make_selection_map(pyr0.abs_grad[0], pyr0.abs_grad[1],
                                        pyr0.abs_grad[2], pot, cfg)
            H, W = sel.shape
            ys = torch.arange(H, device=dev)[:, None]
            xs = torch.arange(W, device=dev)[None, :]
            good = (sel > 0) & (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
            flat = good.reshape(-1)
            idx = nonzero_fixed(flat, bud, 0)
            ok = torch.arange(bud, device=dev) < torch.sum(flat)
            u = (idx % W).to(torch.float32)
            v = (idx // W).to(torch.float32)
        else:
            u, v, ok = _grid_select(pyr0.abs_grad[lvl], bud)
        us.append(u)
        vs.append(v)
        cols.append(bilinear_gather(pyr0.data[lvl], u, v)[:, 0])
        ids.append(torch.ones(bud, device=dev))
        oks.append(ok)
        knns.append(_knn_graph(u, v, ok, bud))

    parents = []
    for lvl in range(levels):
        if lvl == levels - 1:
            parents.append(torch.arange(us[lvl].shape[0], device=dev))
            continue
        cu = (us[lvl] + 0.5) / 2.0 - 0.5
        cv = (vs[lvl] + 0.5) / 2.0 - 0.5
        d2 = (cu[:, None] - us[lvl + 1][None, :]) ** 2 + (
            cv[:, None] - vs[lvl + 1][None, :]) ** 2
        d2 = torch.where(oks[lvl + 1][None, :], d2, torch.full_like(d2, float("inf")))
        parents.append(torch.argmin(d2, dim=1))

    return MonoInitState(
        u=tuple(us), v=tuple(vs), color=tuple(cols), idepth=tuple(ids),
        valid=tuple(oks), knn=tuple(knns), parent=tuple(parents),
        T=torch.eye(4, device=dev),
        snapped=torch.zeros((), dtype=torch.bool, device=dev),
        snapped_count=torch.zeros((), dtype=torch.int32, device=dev),
        resid0=torch.zeros(us[0].shape[0], device=dev),
    )


def _level_pass(img_l, ref_col, pu, pv, pid, pmask, Ki, fx, fy, cx, cy,
                T, aff, alpha_w, huber, iR=None, coup_w=0.0):
    """Residual and blocks of the joint (pose8, idepth[N]) system at one
    level: (E, n, Hpp [8,8], bp [8], Hpd [N,8], Hdd [N], bd [N], r, ok)."""
    Hh, Ww, _ = img_l.shape
    R = T[:3, :3]
    t = T[:3, 3]
    RKi = R @ Ki
    xyz = torch.stack([pu, pv, torch.ones_like(pu)], -1)
    Kx = xyz @ RKi.T
    pt = Kx + t[None, :] * pid[:, None]
    z = pt[:, 2]
    un = pt[:, 0] / z
    vn = pt[:, 1] / z
    Ku = fx * un + cx
    Kv = fy * vn + cy
    new_id = pid / z
    ok = pmask & (Ku > 2) & (Kv > 2) & (Ku < Ww - 3) & (Kv < Hh - 3) & (new_id > 0)
    hit = bilinear_gather(img_l, Ku, Kv)
    r = hit[:, 0] - (aff[0] * ref_col + aff[1])
    # a full tensor numerator: number / tensor is reciprocal * number in
    # PyTorch, which rounds differently from the reference's division
    hw = torch.where(torch.abs(r) < huber, torch.ones_like(r),
                     torch.full_like(r, huber) / torch.clamp(torch.abs(r), min=1e-9))
    w = torch.where(ok, hw, torch.zeros_like(hw))

    gx = hit[:, 1] * fx
    gy = hit[:, 2] * fy
    Jp = torch.stack([
        new_id * gx,
        new_id * gy,
        -new_id * (un * gx + vn * gy),
        -(un * vn * gx + (1 + vn * vn) * gy),
        un * vn * gy + (1 + un * un) * gx,
        un * gy - vn * gx,
        -ref_col * torch.ones_like(un),      # d r / d a (model a*I + b)
        -torch.ones_like(un),
    ], -1)                                   # [N, 8]
    # d(pt)/d id = t  =>  d un / d id = (t0 - un t2) / z, likewise vn
    Jd = gx * (t[0] - un * t[2]) / z + gy * (t[1] - vn * t[2]) / z

    zero = torch.zeros_like(pid)
    E = torch.sum(w * r * r) + alpha_w * torch.sum(
        torch.where(pmask, (pid - 1.0) ** 2, zero))
    n = torch.sum(ok.to(torch.float32))
    Jw = Jp * w[:, None]
    Hpp = Jw.T @ Jp
    bp = (Jw.T @ r[:, None])[:, 0]
    Hpd = Jp * (w * Jd)[:, None]
    Hdd = w * Jd * Jd + alpha_w
    bd = w * Jd * r + alpha_w * (pid - 1.0)
    if iR is not None:
        # coupling toward the neighbour median iR (DSO's post-snap
        # regularisation), iR held constant within an iteration
        E = E + coup_w * torch.sum(torch.where(pmask, (pid - iR) ** 2, zero))
        Hdd = Hdd + coup_w
        bd = bd + coup_w * (pid - iR)
    return E, n, Hpp, bp, Hpd, Hdd, bd, r, ok


def track_frame(state: MonoInitState, pyr_new_data: Tuple[torch.Tensor, ...],
                intr: PyramidIntrinsics, cfg: SLAMConfig) -> MonoInitState:
    """One frame of bootstrap tracking (CoarseInitializer::trackFrame):
    coarse to fine over the hierarchies, blending idepths down the parent
    links before each finer level, Gauss-Newton with LM damping and the
    idepths eliminated by a Schur complement."""
    levels = len(pyr_new_data)
    dev = state.T.device
    huber = cfg.tracker.huber_th
    T = state.T
    pids = list(state.idepth)
    one = torch.ones((), device=dev)
    aff = torch.stack([one, torch.zeros_like(one)])
    n0 = state.u[0].shape[0]
    alpha_w = torch.where(state.snapped, 0.0, 150.0 * 150.0 / n0)
    # the neighbour coupling replaces the prior after the snap (weight as
    # the reference chose it: 50 keeps the pose intact)
    coup_w = torch.where(state.snapped, 50.0, 0.0)
    Ki_all = [to_device(np.asarray(intr.Ki(lvl), np.float32), dev) for lvl in range(levels)]
    eye8 = torch.eye(8, device=dev)

    for lvl in range(levels - 1, -1, -1):
        if lvl < levels - 1:
            par = pids[lvl + 1][state.parent[lvl]]
            par_ok = state.valid[lvl + 1][state.parent[lvl]]
            blended = (2.0 * pids[lvl] + par) / 3.0
            pids[lvl] = torch.where(par_ok, blended, pids[lvl])

        pu, pv = state.u[lvl], state.v[lvl]
        ref_col = state.color[lvl]
        pmask = state.valid[lvl]
        knn = state.knn[lvl]
        Ki = Ki_all[lvl]
        img_l = pyr_new_data[lvl]
        fx, fy, cx, cy = intr.fx[lvl], intr.fy[lvl], intr.cx[lvl], intr.cy[lvl]

        def level_pass(T_, pid_, aff_):
            return _level_pass(img_l, ref_col, pu, pv, pid_, pmask, Ki, fx, fy, cx, cy,
                               T_, aff_, alpha_w, huber, iR=_median10(pid_[knn]),
                               coup_w=coup_w)

        pid = pids[lvl]
        lam = torch.full((), 0.1, device=dev)
        E_old = level_pass(T, pid, aff)[0]
        for _ in range(6 if lvl > 0 else 10):
            E, n, Hpp, bp, Hpd, Hdd, bd, _, _ = level_pass(T, pid, aff)
            inv_Hdd = 1.0 / torch.clamp(Hdd * (1 + lam), min=1e-6)
            H_sc = Hpp - (Hpd.T * inv_Hdd[None, :]) @ Hpd
            b_sc = bp - (Hpd.T @ (inv_Hdd * bd)[:, None])[:, 0]
            H_sc = H_sc + lam * torch.diag(torch.diagonal(H_sc)) + 1e-6 * eye8
            x = solve(H_sc, -b_sc)
            xd = inv_Hdd * (-bd - (Hpd @ x[:, None])[:, 0])
            T_new = lie.se3_exp(x[:6]) @ T
            aff_new = aff + torch.stack([x[6] * 0.01, x[7] * 1.0])
            pid_new = torch.clamp(pid + xd, 1e-3, 50.0)
            E_new, n_new = level_pass(T_new, pid_new, aff_new)[:2]
            # LM accept gate, with a surviving-count guard as in the BA
            accept = (E_new < E_old) & (n_new > 0.5 * torch.clamp(n, min=1.0))
            T = torch.where(accept, T_new, T)
            pid = torch.where(accept, pid_new, pid)
            aff = torch.where(accept, aff_new, aff)
            lam = torch.where(accept, lam * 0.5, torch.clamp(lam * 4.0, max=1e3))
            E_old = torch.where(accept, E_new, E_old)
        pids[lvl] = pid

    # snap on the finest level: enough translation and a healthy fit
    E_fin, n_fin, _, _, _, _, _, r0, ok0 = _level_pass(
        pyr_new_data[0], state.color[0], state.u[0], state.v[0], pids[0], state.valid[0],
        Ki_all[0], intr.fx[0], intr.fy[0], intr.cx[0], intr.cy[0], T, aff, alpha_w,
        huber, iR=_median10(pids[0][state.knn[0]]), coup_w=coup_w)
    mean_r2 = E_fin / torch.clamp(n_fin, min=1.0)
    snapped = state.snapped | ((torch.linalg.vector_norm(T[:3, 3]) > 0.12)
                               & (mean_r2 < 150.0) & (n_fin > 0.3 * n0))
    snapped_count = torch.where(snapped, state.snapped_count + 1,
                                torch.zeros_like(state.snapped_count))
    resid0 = torch.where(ok0, torch.abs(r0), torch.full_like(r0, float("inf")))
    return state._replace(T=T, idepth=tuple(pids), snapped=snapped,
                          snapped_count=snapped_count, resid0=resid0)


def is_done(state: MonoInitState) -> bool:
    """DSO: initialize after tracking 5+ frames past the snap (one read)."""
    snapped, count = torch.stack([state.snapped.to(torch.int64),
                                  state.snapped_count.to(torch.int64)]).tolist()
    return bool(snapped) and count >= 5


def to_points(state: MonoInitState):
    """Rescale to mean idepth 1 (the monocular arbitrary scale,
    FrontEnd.cpp:863-868) and emit the level-0 points as (u, v, idepth,
    rescaled first-to-new pose, rescale), host arrays. Only DSO's isGood
    points: a residual at the last frame above max(12, 2x the median)
    marks a bad depth, and such points are dropped."""
    resid = state.resid0.cpu().numpy()
    m = state.valid[0].cpu().numpy() & np.isfinite(resid)
    if m.any():
        med = float(np.median(resid[m]))
        m = m & (resid < max(12.0, 2.0 * med))
    pid = state.idepth[0].cpu().numpy()
    T = state.T.cpu().numpy().copy()
    if not m.any():
        return np.zeros(0), np.zeros(0), np.zeros(0), T, 1.0
    rescale = 1.0 / max(float(pid[m].mean()), 1e-6)
    T[:3, 3] /= rescale          # first-to-new with the rescaled translation
    return (state.u[0].cpu().numpy()[m], state.v[0].cpu().numpy()[m], pid[m] * rescale,
            T, rescale)
