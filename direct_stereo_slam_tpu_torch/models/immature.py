"""Immature points: creation, epipolar trace and activation (port of
models/immature.py, the pieces the front end calls).

Candidates are batched over a fixed per-slot budget with validity masks;
the epipolar search evaluates a fixed grid of samples along the clamped
segment, then a 3-iteration GN refine; the status machine follows DSO's
IPS_*. The front end keeps ONE stacked [S, NI] candidate set for the
window.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import PATTERN_OFFSETS, SLAMConfig
from ..ops import trace as trace_ops
from ..ops.interp import bilinear_gather, bilinear_gather_frames, bilinear_gather_scalar
from ..utils.compact import nonzero_fixed
from ..utils.device import constant, to_device

IPS_GOOD = 0
IPS_OOB = 1
IPS_OUTLIER = 2
IPS_SKIPPED = 3
IPS_BADCONDITION = 4
IPS_UNINITIALIZED = 5

NUM_TRACE_STEPS = 64
MIN_TEST_RADIUS = 2.0    # setting_minTraceTestRadius


class ImmaturePoints(NamedTuple):
    """Fixed-budget candidate points of one host frame ([NI]) or of the
    whole window ([S, NI])."""

    valid: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    idepth_min: torch.Tensor
    idepth_max: torch.Tensor       # inf until the first successful trace
    color: torch.Tensor            # [.., 8]
    weight: torch.Tensor           # [.., 8]
    grad_h: torch.Tensor           # [.., 3] (gxx, gxy, gyy)
    quality: torch.Tensor
    my_type: torch.Tensor          # selection scale 1/2/4
    status: torch.Tensor           # int32 IPS_*
    pixel_interval: torch.Tensor


def _pattern(device):
    return (constant(tuple(o[0] for o in PATTERN_OFFSETS), device),
            constant(tuple(o[1] for o in PATTERN_OFFSETS), device))


def _inf(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, float("inf"))


def create_points(host_planes: torch.Tensor, selection_map: torch.Tensor,
                  budget: int, outlier_th_sum: float = 50.0 * 50.0) -> ImmaturePoints:
    """Immature points from a selection map: pattern colors, gradient
    weights sqrt(c^2/(c^2+|g|^2)) and the 2x2 pattern gradient hessian."""
    H, W = selection_map.shape
    dev = host_planes.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    border_ok = (ys >= 3) & (ys < H - 4) & (xs >= 3) & (xs < W - 4)
    good = (selection_map > 0) & border_ok
    flat = good.reshape(-1)
    idx = nonzero_fixed(flat, budget, 0)
    count = torch.sum(flat)
    lane_ok = torch.arange(budget, device=dev) < count

    u = (idx % W).to(torch.float32)
    v = (idx // W).to(torch.float32)
    my_type = selection_map.reshape(-1)[idx].to(torch.float32)
    du, dv = _pattern(dev)
    hit = bilinear_gather(host_planes, u[:, None] + du, v[:, None] + dv)   # [NI, 8, 3]
    color = hit[..., 0]
    g2 = hit[..., 1] ** 2 + hit[..., 2] ** 2
    weight = torch.sqrt(outlier_th_sum / (outlier_th_sum + g2))
    gxx = torch.sum(hit[..., 1] * hit[..., 1], dim=-1)
    gxy = torch.sum(hit[..., 1] * hit[..., 2], dim=-1)
    gyy = torch.sum(hit[..., 2] * hit[..., 2], dim=-1)
    lane_ok = lane_ok & torch.all(torch.isfinite(color), dim=-1)
    zeros = torch.zeros(budget, dtype=torch.float32, device=dev)
    return ImmaturePoints(
        valid=lane_ok, u=u, v=v, idepth_min=zeros.clone(),
        idepth_max=_inf(zeros), color=color, weight=weight,
        grad_h=torch.stack([gxx, gxy, gyy], -1),
        quality=torch.full((budget,), 1e4, dtype=torch.float32, device=dev),
        my_type=my_type,
        status=torch.full((budget,), IPS_UNINITIALIZED, dtype=torch.int32, device=dev),
        pixel_interval=zeros.clone(),
    )


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right: a fixed order, which K14
    reproduces operation by operation (torch.sum's order on the card is
    its own)."""
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s


def _project(KRKi: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """KRKi @ (u, v, 1) per lane, each row as two products and two sums in
    index order (KRKi broadcastable to [..., 3, 3] against u, v [...])."""
    return torch.stack([KRKi[..., r, 0] * u + KRKi[..., r, 1] * v + KRKi[..., r, 2]
                        for r in range(3)], -1)


def _segment(pts: ImmaturePoints, pr, Kt, H: int, W: int, max_pix_search: float,
             cfg: SLAMConfig):
    """Phase-1 epipolar geometry and gates shared by both trace forms.
    pr: [.., 3] = KRKi @ (u, v, 1); Kt broadcastable to pr."""
    tc = cfg.trace
    ptp_min = pr + Kt * pts.idepth_min[..., None]
    u_min = ptp_min[..., 0] / ptp_min[..., 2]
    v_min = ptp_min[..., 1] / ptp_min[..., 2]
    oob_min = ~((u_min > 4) & (v_min > 4) & (u_min < W - 5) & (v_min < H - 5))
    have_max = torch.isfinite(pts.idepth_max)
    id_for_max = torch.where(have_max, pts.idepth_max, torch.full_like(pts.idepth_max, 0.01))
    ptp_max = pr + Kt * id_for_max[..., None]
    u_max = ptp_max[..., 0] / ptp_max[..., 2]
    v_max = ptp_max[..., 1] / ptp_max[..., 2]
    d_u = u_max - u_min
    d_v = v_max - v_min
    dist_full = torch.sqrt(d_u * d_u + d_v * d_v)
    dirx = d_u / torch.clamp(dist_full, min=1e-9)
    diry = d_v / torch.clamp(dist_full, min=1e-9)
    dist = torch.where(have_max, torch.clamp(dist_full, max=max_pix_search),
                       torch.full_like(dist_full, max_pix_search))
    u_max = u_min + dirx * dist
    v_max = v_min + diry * dist
    oob_max = ~((u_max > 4) & (v_max > 4) & (u_max < W - 5) & (v_max < H - 5))
    gxx, gxy, gyy = pts.grad_h[..., 0], pts.grad_h[..., 1], pts.grad_h[..., 2]
    a = dirx * dirx * gxx + 2 * dirx * diry * gxy + diry * diry * gyy
    b = diry * diry * gxx - 2 * dirx * diry * gxy + dirx * dirx * gyy
    error_px = 0.2 + 0.2 * (a + b) / torch.clamp(a, min=1e-9)
    badcond = error_px > 10.0
    error_px = torch.clamp(error_px, max=10.0)
    skipped = (dist < tc.trace_slack_interval) | (
        error_px * tc.trace_min_improvement_factor > dist)
    return u_min, v_min, oob_min, oob_max, dirx, diry, dist, error_px, badcond, skipped


def _search(plane, u_min, v_min, dirx, diry, dist, color, aff_a, aff_b, rdu, rdv,
            old_quality, pr, Kt, err, H: int, W: int, num_steps: int,
            cfg: SLAMConfig):
    """Uniform-grid search over [0, dist] + GN refine + interval update for
    a list of lanes ([B]); per-lane rdu/rdv [B, 8], color [B, 8],
    aff_a/aff_b [B, 1], pr/Kt [B, 3]. Returns (quality, outlier, new_min,
    new_max). Every sum is a left-to-right chain (``_sum_last``) and the
    step is the segment times 1 / (num_steps - 1) rounded to f32, so that
    K14 can give the same bits."""
    tc = cfg.trace
    dev = u_min.device
    t = torch.arange(num_steps, dtype=torch.float32, device=dev)[None, :]
    inv_steps = float(np.float32(1.0) / np.float32(max(num_steps - 1, 1)))
    step_len = torch.clamp(dist, min=1e-6)[:, None] * inv_steps
    px = u_min[:, None] + dirx[:, None] * t * step_len
    py = v_min[:, None] + diry[:, None] * t * step_len
    s_ok = (px > 3) & (py > 3) & (px < W - 4) & (py < H - 4)
    spx = px[..., None] + rdu[:, None, :]
    spy = py[..., None] + rdv[:, None, :]
    hit = bilinear_gather_scalar(plane[..., 0], spx, spy)
    ref = aff_a * color + aff_b                                        # [B, 8]
    res = hit - ref[:, None, :]
    energy = _sum_last(res * res)
    energy = torch.where(s_ok, energy, _inf(energy))

    best_e, best_i = torch.min(energy, dim=-1)
    far = torch.abs(t - best_i[:, None].to(torch.float32)) * step_len >= MIN_TEST_RADIUS
    second_e = torch.amin(torch.where(far, energy, _inf(energy)), dim=-1)
    new_quality = torch.where(torch.isfinite(second_e),
                              second_e / torch.clamp(best_e, min=1e-9),
                              torch.full_like(second_e, 1e4))
    quality = torch.where(dist > 3.0, new_quality, torch.minimum(old_quality, new_quality))

    best_u = u_min + dirx * step_len[:, 0] * best_i.to(torch.float32)
    best_v = v_min + diry * step_len[:, 0] * best_i.to(torch.float32)
    for _ in range(tc.trace_gn_iterations):
        gpx = best_u[:, None] + rdu
        gpy = best_v[:, None] + rdv
        h3 = bilinear_gather(plane, gpx, gpy)
        r = h3[..., 0] - ref
        gdotd = h3[..., 1] * dirx[:, None] + h3[..., 2] * diry[:, None]
        Hs = _sum_last(gdotd * gdotd)
        bs = _sum_last(r * gdotd)
        stp = torch.clamp(-bs / torch.clamp(Hs, min=1e-9), -0.5, 0.5) * tc.trace_step_size
        nu = best_u + stp * dirx
        nv = best_v + stp * diry
        rn = bilinear_gather_scalar(plane[..., 0], nu[:, None] + rdu, nv[:, None] + rdv) - ref
        ne = _sum_last(rn * rn)
        better = ne < best_e
        best_u = torch.where(better, nu, best_u)
        best_v = torch.where(better, nv, best_v)
        best_e = torch.where(better, ne, best_e)

    outlier = best_e > 8.0 * 12.0 * 12.0 * tc.trace_extra_slack_on_th
    use_x = dirx * dirx > diry * diry

    def id_from_px(uu, vv):
        dx_ = Kt[:, 0] - Kt[:, 2] * uu
        dy_ = Kt[:, 1] - Kt[:, 2] * vv
        idx_ = (pr[:, 2] * uu - pr[:, 0]) / torch.clamp(torch.abs(dx_), min=1e-12) * torch.sign(dx_)
        idy_ = (pr[:, 2] * vv - pr[:, 1]) / torch.clamp(torch.abs(dy_), min=1e-12) * torch.sign(dy_)
        return torch.where(use_x, idx_, idy_)

    id_lo = id_from_px(best_u - err * dirx, best_v - err * diry)
    id_hi = id_from_px(best_u + err * dirx, best_v + err * diry)
    return quality, outlier, torch.minimum(id_lo, id_hi), torch.maximum(id_lo, id_hi)


def _rotated_pattern(KRKi, du, dv):
    rdu = KRKi[..., 0, 0, None] * du + KRKi[..., 0, 1, None] * dv
    rdv = KRKi[..., 1, 0, None] * du + KRKi[..., 1, 1, None] * dv
    return rdu, rdv


def trace_points(pts: ImmaturePoints, target_planes: torch.Tensor, KRKi, Kt,
                 aff_a, aff_b, cfg: SLAMConfig, max_search_px: Optional[float] = None,
                 num_steps: int = NUM_TRACE_STEPS) -> ImmaturePoints:
    """Epipolar depth search for ONE host's candidates [NI] (the stereo
    initializer's full-length static-stereo trace uses it)."""
    H, W = target_planes.shape[:2]
    dev = target_planes.device
    tc = cfg.trace
    max_pix = max_search_px if max_search_px is not None else tc.max_pix_search_frac * (H + W)
    NI = pts.u.shape[0]
    traceable = pts.valid & (pts.status != IPS_OOB)
    pr = _project(KRKi, pts.u, pts.v)
    (u_min, v_min, oob_min, oob_max, dirx, diry, dist, error_px, badcond,
     skipped) = _segment(pts, pr, Kt[None, :], H, W, max_pix, cfg)
    du, dv = _pattern(dev)
    rdu, rdv = _rotated_pattern(KRKi, du, dv)
    aff_a = torch.as_tensor(aff_a, dtype=torch.float32, device=dev).reshape(1, 1).expand(NI, 1)
    aff_b = torch.as_tensor(aff_b, dtype=torch.float32, device=dev).reshape(1, 1).expand(NI, 1)
    quality, outlier, new_min, new_max = _search(
        target_planes, u_min, v_min, dirx, diry, dist, pts.color, aff_a, aff_b,
        rdu.expand(NI, 8), rdv.expand(NI, 8), pts.quality, pr,
        Kt[None, :].expand(NI, 3), error_px, H, W, num_steps, cfg)
    good = traceable & ~oob_min & ~skipped & ~badcond & ~outlier & ~oob_max
    st = lambda c: torch.full_like(pts.status, c)
    status = torch.where(
        ~traceable, pts.status,
        torch.where(oob_min | oob_max, st(IPS_OOB),
        torch.where(skipped, st(IPS_SKIPPED),
        torch.where(badcond, st(IPS_BADCONDITION),
        torch.where(outlier, st(IPS_OUTLIER), st(IPS_GOOD))))))
    return pts._replace(
        idepth_min=torch.where(good, new_min, pts.idepth_min),
        idepth_max=torch.where(good, new_max, pts.idepth_max),
        quality=torch.where(traceable, quality, pts.quality),
        status=status,
        pixel_interval=torch.where(good, 2.0 * error_px, pts.pixel_interval),
    )


def trace_points_all_compact_plain(pts: ImmaturePoints, target_planes: torch.Tensor,
                                   KRKi, Kt, aff_a, aff_b, cfg: SLAMConfig,
                                   num_steps: Optional[int] = None,
                                   budget: Optional[int] = None,
                                   max_reach: Optional[float] = None,
                                   lanes: Optional[torch.Tensor] = None):
    """K14's plain version (see ``trace_points_all_compact``); ``KRKi``
    [S, 3, 3], ``Kt`` [S, 3], ``aff_a``, ``aff_b`` [S] host arrays or
    tensors. ``lanes`` (int64 [budget]) gets the compacted lanes, as the
    kernel's wrapper gives them."""
    S, NI = pts.u.shape
    H, W = target_planes.shape[:2]
    dev = target_planes.device
    tc = cfg.trace
    num_steps = tc.num_steps if num_steps is None else num_steps
    budget = min(tc.search_budget if budget is None else budget, S * NI)
    max_pix = tc.max_pix_search_frac * (H + W)
    f32 = lambda x: (x.to(device=dev, dtype=torch.float32) if torch.is_tensor(x)
                     else to_device(np.asarray(x, np.float32), dev))
    KRKi, Kt, aff_a, aff_b = f32(KRKi), f32(Kt), f32(aff_a), f32(aff_b)

    traceable = pts.valid & (pts.status != IPS_OOB)
    pr = _project(KRKi[:, None], pts.u, pts.v)
    (u_min, v_min, oob_min, oob_max, dirx, diry, dist, error_px, badcond,
     skipped) = _segment(pts, pr, Kt[:, None, :], H, W, max_pix, cfg)

    want = traceable & ~oob_min & ~oob_max & ~skipped & ~badcond
    if max_reach is None:
        search = want
        n_deferred = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        search = want & (dist <= max_reach)
        n_deferred = torch.sum(want & (dist > max_reach))
    n_search = torch.sum(want)
    n_overflow = torch.clamp(torch.sum(search) - budget, min=0) + n_deferred

    st = lambda c: torch.full_like(pts.status, c)
    status1 = torch.where(
        ~traceable, pts.status,
        torch.where(oob_min | oob_max, st(IPS_OOB),
        torch.where(skipped, st(IPS_SKIPPED),
        torch.where(badcond, st(IPS_BADCONDITION), pts.status))))

    # ---- phase 2: compact + search -----------------------------------------
    flat = lambda a: a.reshape((S * NI,) + a.shape[2:])
    cidx = nonzero_fixed(flat(search), budget, S * NI)
    if lanes is not None:
        lanes.copy_(cidx)
    lane_ok = cidx < S * NI
    idx_c = torch.clamp(cidx, max=S * NI - 1)
    slot = idx_c // NI
    take = lambda a: flat(a)[idx_c]

    du, dv = _pattern(dev)
    rdu_s, rdv_s = _rotated_pattern(KRKi, du, dv)                 # [S, 8]
    c_err = take(error_px)
    quality, outlier, new_min, new_max = _search(
        target_planes, take(u_min), take(v_min), take(dirx), take(diry),
        take(dist), take(pts.color), aff_a[slot][:, None], aff_b[slot][:, None],
        rdu_s[slot], rdv_s[slot], take(pts.quality), take(pr), Kt[slot], c_err,
        H, W, num_steps, cfg)

    # ---- phase 3: scatter back -----------------------------------------------
    good_c = lane_ok & ~outlier

    def scat(dst, val, ok):
        out = torch.cat([flat(dst), flat(dst)[:1]])     # one trash row
        out[torch.where(ok, cidx, torch.full_like(cidx, S * NI))] = val.to(out.dtype)
        return out[:S * NI].reshape(S, NI)

    status = scat(status1, torch.where(outlier, torch.full_like(cidx, IPS_OUTLIER),
                                       torch.full_like(cidx, IPS_GOOD)), lane_ok)
    return pts._replace(
        idepth_min=scat(pts.idepth_min, new_min, good_c),
        idepth_max=scat(pts.idepth_max, new_max, good_c),
        quality=scat(pts.quality, quality, lane_ok),
        status=status,
        pixel_interval=scat(pts.pixel_interval, 2.0 * c_err, good_c),
    ), n_search, n_overflow


def trace_points_all_compact(pts: ImmaturePoints, target_planes: torch.Tensor,
                             KRKi, Kt, aff_a, aff_b, cfg: SLAMConfig,
                             num_steps: Optional[int] = None,
                             budget: Optional[int] = None,
                             max_reach: Optional[float] = None):
    """traceOn for the whole window ([S, NI]) with search compaction: phase
    1 gates every lane without touching the image, phase 2 searches the
    first ``budget`` search-needing lanes (row-major lane order), phase 3
    scatters results back. Lanes beyond the budget or (tiered form)
    ``max_reach`` keep their state and are counted in n_overflow.
    Returns (points, n_searched, n_overflow), new tensors (``pts`` stays
    as it was). ``KRKi`` [S, 3, 3], ``Kt`` [S, 3], ``aff_a``, ``aff_b``
    [S] are host values (numpy arrays, or CPU tensors). On the card this
    is one launch of K14 (``ops/trace.py``), which takes them by value;
    for CPU tensors the plain version runs."""
    if target_planes.is_cuda:
        return trace_ops.trace_points_all_compact_cuda(pts, target_planes, KRKi, Kt, aff_a,
                                                       aff_b, cfg, num_steps, budget, max_reach)
    return trace_points_all_compact_plain(pts, target_planes, KRKi, Kt, aff_a, aff_b, cfg,
                                          num_steps, budget, max_reach)


class ActivationResult(NamedTuple):
    idepth: torch.Tensor
    idepth_hessian: torch.Tensor
    energy: torch.Tensor
    num_good: torch.Tensor
    ok: torch.Tensor


def activate_points_all(pts: ImmaturePoints, slots: torch.Tensor, images,
                        frame_valid, T_cw, T_wc, aff, calib, exposure,
                        cfg: SLAMConfig) -> ActivationResult:
    """Batched 1-D inverse-depth LM for every slot's candidates ([S, NI];
    ``slots`` [S] host slot of each row) against all other window frames;
    ``T_wc`` [W, 4, 4] the inverses of ``T_cw``."""
    Wn, H, Wd = images.shape[0], images.shape[1], images.shape[2]
    dev = images.device
    fx, fy, cx, cy = calib[0], calib[1], calib[2], calib[3]
    du, dv = _pattern(dev)
    xh = (pts.u[..., None] + du - cx) / fx                       # [S, NI, 8]
    yh = (pts.v[..., None] + dv - cy) / fy

    Tth = torch.einsum("tij,sjk->stik", T_cw, T_wc[slots])       # [S, Wn, 4, 4]
    Rth = Tth[..., :3, :3]
    tth = Tth[..., :3, 3]
    a_t = torch.exp(aff[None, :, 0] - aff[slots, 0][:, None]) * (
        exposure[None, :] / torch.clamp(exposure[slots], min=1e-9)[:, None])  # [S, Wn]
    b_t = aff[None, :, 1] - a_t * aff[slots, 1][:, None]
    t_ok = frame_valid[None, :] & (torch.arange(Wn, device=dev)[None, :] != slots[:, None])

    id0 = torch.clamp(0.5 * (pts.idepth_min + torch.clamp(pts.idepth_max, max=1e3)), 1e-4, 1e3)
    th = 8.0 * cfg.trace.outlier_th
    wpat = pts.weight[:, None] ** 2                               # [S, 1, NI, 8]
    t_fold = torch.arange(Wn, device=dev)[None, :, None, None]

    def residual_pass(idepth):
        """-> (H_id, b_id, E, n_good), each [S, NI]"""
        Xh = torch.stack([xh, yh, torch.ones_like(xh)], -1) / idepth[..., None, None]
        pt = torch.einsum("stij,spkj->stpki", Rth, Xh) + tth[:, :, None, None, :]
        z = pt[..., 2]
        un = pt[..., 0] / z
        vn = pt[..., 1] / z
        Ku = fx * un + cx
        Kv = fy * vn + cy
        inb = (Ku > 2) & (Kv > 2) & (Ku < Wd - 3) & (Kv < H - 3) & (z > 1e-4)
        hit_i, hit_dx, hit_dy = bilinear_gather_frames(images, t_fold, Ku, Kv)
        r = hit_i - (a_t[:, :, None, None] * pts.color[:, None] + b_t[:, :, None, None])
        hw = torch.where(torch.abs(r) < 9.0, torch.ones_like(r),
                         9.0 / torch.clamp(torch.abs(r), min=1e-9))
        dr_dpt = torch.stack([
            (1.0 / z) * hit_dx * fx,
            (1.0 / z) * hit_dy * fy,
            -(1.0 / z) * (un * hit_dx * fx + vn * hit_dy * fy),
        ], -1)
        dpt_did = -(pt - tth[:, :, None, None, :]) / idepth[:, None, :, None, None]
        Jd = torch.sum(dr_dpt * dpt_did, -1)
        pair_e = torch.sum(torch.where(inb, hw * r * r * (2 - hw) * wpat,
                                       torch.zeros_like(r)), -1)        # [S, Wn, NI]
        pair_in = torch.all(inb, -1) & t_ok[:, :, None]
        pair_good = pair_in & (pair_e < th)
        m = (pair_good[..., None] & inb).to(torch.float32) * hw * wpat
        H_id = torch.sum(m * Jd * Jd, dim=(1, 3))
        b_id = torch.sum(m * Jd * r, dim=(1, 3))
        E = torch.sum(torch.where(pair_good, pair_e,
                                  torch.where(pair_in, torch.full_like(pair_e, th),
                                              torch.zeros_like(pair_e))), 1)
        n_good = torch.sum(pair_good.to(torch.int32), 1)
        return H_id, b_id, E, n_good

    H_id, b_id, E, n_good = residual_pass(id0)
    idep = id0
    lam = torch.full_like(id0, 0.1)
    for _ in range(3):
        stp = -b_id / torch.clamp(H_id * (1 + lam), min=1e-9)
        new_id = torch.clamp(idep + stp, 1e-5, 50.0)
        H2, b2, E2, n2 = residual_pass(new_id)
        better = E2 < E
        idep = torch.where(better, new_id, idep)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
        H_id = torch.where(better, H2, H_id)
        b_id = torch.where(better, b2, b_id)
        E = torch.where(better, E2, E)
        n_good = torch.where(better, n2, n_good)

    ok = (pts.valid & (n_good >= 1) & (H_id > cfg.ba.min_idepth_h_act)
          & (idep > 1e-5) & torch.isfinite(E))
    return ActivationResult(idepth=idep, idepth_hessian=H_id, energy=E,
                            num_good=n_good, ok=ok)


def can_activate(pts: ImmaturePoints, cfg: SLAMConfig) -> torch.Tensor:
    """Activation pre-gates."""
    s = pts.status
    return (pts.valid
            & ((s == IPS_GOOD) | (s == IPS_SKIPPED) | (s == IPS_BADCONDITION)
               | (s == IPS_OOB))
            & (pts.pixel_interval < 8.0)
            & (pts.quality > cfg.trace.min_trace_quality)
            & ((pts.idepth_max + pts.idepth_min) > 0)
            & torch.isfinite(pts.idepth_max))


def empty_batch(n_slots: int, budget: int, device="cpu") -> ImmaturePoints:
    """All-invalid stacked candidate set [S, NI]."""
    f32 = dict(dtype=torch.float32, device=device)
    z = lambda *s: torch.zeros(*s, **f32)
    return ImmaturePoints(
        valid=torch.zeros(n_slots, budget, dtype=torch.bool, device=device),
        u=z(n_slots, budget), v=z(n_slots, budget), idepth_min=z(n_slots, budget),
        idepth_max=torch.full((n_slots, budget), float("inf"), **f32),
        color=z(n_slots, budget, 8), weight=z(n_slots, budget, 8),
        grad_h=z(n_slots, budget, 3), quality=z(n_slots, budget),
        my_type=z(n_slots, budget),
        status=torch.full((n_slots, budget), IPS_UNINITIALIZED, dtype=torch.int32,
                          device=device),
        pixel_interval=z(n_slots, budget),
    )


def set_slot(batch: ImmaturePoints, slot: int, pts: ImmaturePoints) -> ImmaturePoints:
    """Write one slot's candidate set into the stacked batch (new tensors;
    the previous batch stays intact)."""
    def put(full, one):
        out = full.clone()
        out[slot] = one
        return out
    return ImmaturePoints(*[put(f, o) for f, o in zip(batch, pts)])


def clear_slots(batch: ImmaturePoints, slot_mask: torch.Tensor) -> ImmaturePoints:
    """Invalidate whole slots ([S] bool mask)."""
    return batch._replace(valid=batch.valid & ~slot_mask[:, None])
