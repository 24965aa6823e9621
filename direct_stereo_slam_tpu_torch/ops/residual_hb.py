"""Fused direct-alignment residual / Jacobian / Hessian passes (port of
ops/residual_hb.py): kernels K2 (pose), K3 (stereo scale) and K4 (the
loop-closure pose estimator's pass over metric 3-D points).

One pass per LM iteration: warp -> bilinear read of (I, dx, dy) -> Huber
weight and saturation cutoff -> Jacobian -> reduction to (H, b, stats).

Every pass takes an optional leading candidate dimension: the tracker's
candidate batches (1, 5 or 78 poses), the loop estimator's seed stack
(1 or 6 seeds) and the scale optimizer's 8 grid guesses run as ONE
launch each, the candidate on ``blockIdx.y`` (the reference vmaps the
same pass). For a CUDA image the public functions
launch the hand-written kernel (``csrc/residual_hb.cu``); the plain
PyTorch versions below (``*_plain``) are taken only for CPU tensors, and
are what the card's kernels are checked against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SCALE_A, SCALE_B, SCALE_XI_ROT, SCALE_XI_TRANS
from . import _cuda
from .interp import bilinear_gather


class ResStats(NamedTuple):
    E: torch.Tensor              # total energy (saturated terms add max_energy)
    num_terms: torch.Tensor      # number of valid terms in E
    flow_t: torch.Tensor         # mean squared translation-only pixel shift
    flow_rt: torch.Tensor        # mean squared rot+trans pixel shift
    saturated_ratio: torch.Tensor

    @property
    def mean_energy(self):
        return self.E / torch.clamp(self.num_terms, min=1.0)


class PosePassOut(NamedTuple):
    stats: ResStats
    H: torch.Tensor              # [.., 8, 8] preconditioned GN Hessian
    b: torch.Tensor              # [.., 8] preconditioned gradient
    num_in: torch.Tensor         # inlier (non-saturated, valid) count


class ScalePassOut(NamedTuple):
    stats: ResStats
    H: torch.Tensor
    b: torch.Tensor


# preconditioner of the 8-param pose+affine system (DSO's swapped naming:
# tangent[0:3] is translation and receives "SCALE_XI_ROT" = 1.0)
POSE_PRECOND = torch.tensor(
    [SCALE_XI_TRANS] * 3 + [SCALE_XI_ROT] * 3 + [SCALE_A, SCALE_B],
    dtype=torch.float32)

_THREADS = 256
_MAX_BLOCKS = 32


def _blocks_for(n: int) -> int:
    """Stage-1 blocks per candidate (csrc/residual_hb.cu blocks_for)."""
    return min(max((n + _THREADS - 1) // _THREADS, 1), _MAX_BLOCKS)


def _huber_energy(r, hw, sat, max_energy):
    return torch.where(sat, max_energy, hw * r * r * (2.0 - hw))


def _batched(x, B: int, device) -> torch.Tensor:
    """Broadcast a scalar / [B] value to a [B] f32 tensor."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(-1).expand(B)


def _unbatch(out, batched: bool):
    if batched:
        return out
    return type(out)(*[
        _unbatch(f, False) if isinstance(f, tuple) else f[0] for f in out])


def _pose_sums(img, Ku, Kv, u, v, new_id, valid, pcolor, a, bb, ref_b0, cutoff,
               fx, fy, huber_th):
    """The 8-parameter terms shared by K2 and K4, from warped coordinates
    [B, N]: bilinear read, Huber weight, cutoff, Jacobian and the masked
    sums. Returns (E, num_terms, num_sat, H [B, 8, 8], b [B, 8], num_in)."""
    hit = bilinear_gather(img, Ku, Kv)
    hit_i, hit_dx, hit_dy = hit[..., 0], hit[..., 1], hit[..., 2]
    valid = valid & torch.isfinite(hit_i)

    residual = hit_i - (a * pcolor[None] + bb)
    abs_r = torch.abs(residual)
    hw = torch.where(abs_r < huber_th, torch.ones_like(abs_r),
                     huber_th / torch.clamp(abs_r, min=1e-12))
    sat = abs_r > cutoff
    max_energy = 2.0 * huber_th * cutoff - huber_th * huber_th
    vf = valid.to(torch.float32)
    energy = torch.sum(vf * _huber_energy(residual, hw, sat, max_energy), dim=1)
    num_terms = torch.sum(vf, dim=1)
    num_sat = torch.sum(vf * sat.to(torch.float32), dim=1)

    in_mask = (valid & ~sat).to(torch.float32)
    dxfx = hit_dx * fx
    dyfy = hit_dy * fy
    J = torch.stack([
        new_id * dxfx,
        new_id * dyfy,
        -new_id * (u * dxfx + v * dyfy),
        -(u * v * dxfx + (1.0 + v * v) * dyfy),
        u * v * dyfy + (1.0 + u * u) * dxfx,
        u * dyfy - v * dxfx,
        (a * (ref_b0 - pcolor[None])).expand_as(u),
        -torch.ones_like(u),
    ], dim=-1)                                                     # [B, N, 8]
    w = (in_mask * hw)[..., None]
    n_in = torch.sum(in_mask, dim=1)
    n_safe = torch.clamp(n_in, min=1.0)
    Jw = J * w
    H = (Jw.transpose(1, 2) @ J) / n_safe[:, None, None]
    b = (Jw.transpose(1, 2) @ residual[..., None])[..., 0] / n_safe[:, None]
    P = POSE_PRECOND.to(img.device)
    return energy, num_terms, num_sat, H * P[:, None] * P[None, :], b * P, n_in


def _pose_out(energy, num_terms, num_sat, H, b, n_in, flow_t, flow_rt, batched):
    stats = ResStats(E=energy, num_terms=num_terms, flow_t=flow_t,
                     flow_rt=flow_rt,
                     saturated_ratio=num_sat / torch.clamp(num_terms, min=1.0))
    return _unbatch(PosePassOut(stats=stats, H=H, b=b, num_in=n_in), batched)


# ---------------------------------------------------------------------------
# K2: pose pass
# ---------------------------------------------------------------------------


def pose_residual_pass(img, pu, pv, pid, pcolor, pmask, RKi, Ki, t, aff_a,
                       aff_b, ref_b0, fx: float, fy: float, cx: float,
                       cy: float, huber_th: float, cutoff_th,
                       compute_flow: bool = True) -> PosePassOut:
    """Track-pose flavor. ``img`` [H, W, 3]; point lists [N]; ``RKi``
    [3, 3] or [B, 3, 3] with ``t`` [3] / [B, 3] and ``aff_a``, ``aff_b``,
    ``cutoff_th`` scalars or [B]. Outputs carry the candidate dim iff
    ``RKi`` does. CUDA tensors launch kernel K2; CPU tensors take
    ``pose_residual_pass_plain``."""
    if img.is_cuda:
        return pose_residual_pass_cuda(img, pu, pv, pid, pcolor, pmask, RKi, Ki,
                                       t, aff_a, aff_b, ref_b0, fx, fy, cx, cy,
                                       huber_th, cutoff_th, compute_flow)
    return pose_residual_pass_plain(img, pu, pv, pid, pcolor, pmask, RKi, Ki, t,
                                    aff_a, aff_b, ref_b0, fx, fy, cx, cy,
                                    huber_th, cutoff_th, compute_flow)


def pose_residual_pass_plain(img, pu, pv, pid, pcolor, pmask, RKi, Ki, t,
                             aff_a, aff_b, ref_b0, fx, fy, cx, cy, huber_th,
                             cutoff_th, compute_flow=True) -> PosePassOut:
    """Plain PyTorch version of K2 (the reference's expression, batched)."""
    batched = RKi.dim() == 3
    RKi = RKi.reshape(-1, 3, 3)
    B = RKi.shape[0]
    dev = img.device
    t = t.reshape(B, 3)
    a = _batched(aff_a, B, dev)[:, None]
    bb = _batched(aff_b, B, dev)[:, None]
    cutoff = _batched(cutoff_th, B, dev)[:, None]
    ref_b0 = torch.as_tensor(ref_b0, dtype=torch.float32, device=dev)
    H_img, W_img = img.shape[0], img.shape[1]

    xyz1 = torch.stack([pu, pv, torch.ones_like(pu)], dim=-1)      # [N, 3]
    Kixyz = xyz1[None] @ RKi.transpose(1, 2)                       # [B, N, 3]
    pt = Kixyz + t[:, None, :] * pid[None, :, None]
    u = pt[..., 0] / pt[..., 2]
    v = pt[..., 1] / pt[..., 2]
    Ku = fx * u + cx
    Kv = fy * v + cy
    new_id = pid[None] / pt[..., 2]
    valid = (pmask[None] & (Ku > 2.0) & (Kv > 2.0) & (Ku < W_img - 3.0)
             & (Kv < H_img - 3.0) & (new_id > 0.0))
    energy, num_terms, num_sat, H, b, n_in = _pose_sums(
        img, Ku, Kv, u, v, new_id, valid, pcolor, a, bb, ref_b0, cutoff,
        fx, fy, huber_th)

    if compute_flow:
        n = pu.shape[0]
        sub = ((torch.arange(n, device=dev) % 32 == 0) & pmask).to(torch.float32)
        Kixyz0 = xyz1 @ Ki.T                                       # [N, 3]

        def proj(p):
            return fx * p[..., 0] / p[..., 2] + cx, fy * p[..., 1] / p[..., 2] + cy

        tid = t[:, None, :] * pid[None, :, None]
        KuT, KvT = proj(Kixyz0[None] + tid)
        KuT2, KvT2 = proj(Kixyz0[None] - tid)
        KuR2, KvR2 = proj(Kixyz - tid)

        def d2(a_, b_):
            return (a_ - pu) ** 2 + (b_ - pv) ** 2

        num = torch.sum(sub) * 2.0 + 0.1
        flow_t = torch.sum(sub * (d2(KuT, KvT) + d2(KuT2, KvT2)), dim=1) / num
        flow_rt = torch.sum(sub * (d2(Ku, Kv) + d2(KuR2, KvR2)), dim=1) / num
    else:
        flow_t = torch.zeros(B, device=dev)
        flow_rt = torch.zeros(B, device=dev)

    return _pose_out(energy, num_terms, num_sat, H, b, n_in, flow_t, flow_rt,
                     batched)


def pose_residual_pass_cuda(img, pu, pv, pid, pcolor, pmask, RKi, Ki, t, aff_a,
                            aff_b, ref_b0, fx, fy, cx, cy, huber_th, cutoff_th,
                            compute_flow=True) -> PosePassOut:
    """Launch kernel K2 (csrc/residual_hb.cu) for all candidates at once."""
    batched = RKi.dim() == 3
    RKi = RKi.reshape(-1, 3, 3)
    B = RKi.shape[0]
    dev = img.device
    f32 = dict(dtype=torch.float32, device=dev)
    params = torch.cat([
        RKi.reshape(B, 9).to(torch.float32),
        t.reshape(B, 3).to(torch.float32),
        _batched(aff_a, B, dev)[:, None],
        _batched(aff_b, B, dev)[:, None],
        _batched(cutoff_th, B, dev)[:, None],
        _batched(ref_b0, B, dev)[:, None],
        torch.as_tensor(Ki, **f32).reshape(1, 9).expand(B, 9),
        POSE_PRECOND.to(dev).reshape(1, 8).expand(B, 8),
        torch.zeros(B, 7, **f32),
    ], dim=1).contiguous()
    img = img.contiguous()
    pmask_u8 = pmask.to(torch.bool).contiguous().view(torch.uint8)
    N = pu.shape[0]
    H_img, W_img = img.shape[0], img.shape[1]
    nblk = _blocks_for(N)
    partial = torch.empty(B, nblk, 51, **f32)
    out = torch.empty(B, 80, **f32)
    _cuda.require_cuda("pose_residual_pass", img, pu, pv, pid, pcolor, pmask_u8,
                       params)
    _cuda.call("dsslam_pose_pass", img.data_ptr(), H_img, W_img,
               W_img - 1.001, H_img - 1.001, pu.data_ptr(), pv.data_ptr(),
               pid.data_ptr(), pcolor.data_ptr(), pmask_u8.data_ptr(), N,
               params.data_ptr(), B, fx, fy, cx, cy, huber_th,
               int(bool(compute_flow)), partial.data_ptr(), nblk,
               out.data_ptr())
    pose_residual_pass_cuda.launches += 1
    stats = ResStats(E=out[:, 72], num_terms=out[:, 73], flow_t=out[:, 74],
                     flow_rt=out[:, 75], saturated_ratio=out[:, 76])
    res = PosePassOut(stats=stats, H=out[:, :64].reshape(B, 8, 8),
                      b=out[:, 64:72], num_in=out[:, 77])
    return _unbatch(res, batched)


pose_residual_pass_cuda.launches = 0


# ---------------------------------------------------------------------------
# K3: scale pass
# ---------------------------------------------------------------------------


def scale_residual_pass(img1, pu, pv, pid, pcolor, pmask, R01Ki, Ki0, t01,
                        scale, fx1: float, fy1: float, cx1: float, cy1: float,
                        huber_th: float, cutoff_th) -> ScalePassOut:
    """Stereo scale flavor. ``scale`` and ``cutoff_th`` are scalars or [G]
    (the 8-guess grid); outputs carry the guess dim iff ``scale`` does.
    CUDA tensors launch kernel K3; CPU tensors take the plain version."""
    if img1.is_cuda:
        return scale_residual_pass_cuda(img1, pu, pv, pid, pcolor, pmask, R01Ki,
                                        Ki0, t01, scale, fx1, fy1, cx1, cy1,
                                        huber_th, cutoff_th)
    return scale_residual_pass_plain(img1, pu, pv, pid, pcolor, pmask, R01Ki, Ki0,
                                     t01, scale, fx1, fy1, cx1, cy1, huber_th,
                                     cutoff_th)


def scale_residual_pass_plain(img1, pu, pv, pid, pcolor, pmask, R01Ki, Ki0, t01,
                              scale, fx1, fy1, cx1, cy1, huber_th,
                              cutoff_th) -> ScalePassOut:
    """Plain PyTorch version of K3 (the reference's expression, batched)."""
    dev = img1.device
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    batched = scale.dim() == 1
    s = scale.reshape(-1)
    G = s.shape[0]
    cutoff = _batched(cutoff_th, G, dev)[:, None]
    s = s[:, None]
    H_img, W_img = img1.shape[0], img1.shape[1]
    xyz1 = torch.stack([pu, pv, torch.ones_like(pu)], dim=-1)
    rKix = xyz1 @ R01Ki.T                                         # [N, 3]
    pt = s[..., None] * rKix[None] + t01[None, None, :] * pid[None, :, None]
    u = pt[..., 0] / pt[..., 2]
    v = pt[..., 1] / pt[..., 2]
    Ku = fx1 * u + cx1
    Kv = fy1 * v + cy1
    new_id = pid[None] / pt[..., 2]
    valid = (pmask[None] & (Ku > 2.0) & (Kv > 2.0) & (Ku < W_img - 3.0)
             & (Kv < H_img - 3.0) & (new_id > 0.0))
    hit = bilinear_gather(img1, Ku, Kv)
    hit_i, hit_dx, hit_dy = hit[..., 0], hit[..., 1], hit[..., 2]
    valid = valid & torch.isfinite(hit_i)

    residual = hit_i - pcolor[None]
    abs_r = torch.abs(residual)
    hw = torch.where(abs_r < huber_th, torch.ones_like(abs_r),
                     huber_th / torch.clamp(abs_r, min=1e-12))
    sat = abs_r > cutoff
    max_energy = 2.0 * huber_th * cutoff - huber_th * huber_th
    vf = valid.to(torch.float32)
    energy = torch.sum(vf * _huber_energy(residual, hw, sat, max_energy), dim=1)
    num_terms = torch.sum(vf, dim=1)
    num_sat = torch.sum(vf * sat.to(torch.float32), dim=1)

    rx = rKix / pid[:, None]
    tx, ty, tz = t01[0], t01[1], t01[2]
    deno_sqrt = s * rx[None, :, 2] + tz
    deno = 1.0 / torch.clamp(deno_sqrt * deno_sqrt, min=1e-20)
    xno = rx[:, 0] * tz - rx[:, 2] * tx
    yno = rx[:, 1] * tz - rx[:, 2] * ty
    Js = hit_dx * fx1 * deno * xno[None] + hit_dy * fy1 * deno * yno[None]

    in_mask = (valid & ~sat).to(torch.float32)
    w = in_mask * hw
    n_in = torch.sum(in_mask, dim=1)
    n_safe = torch.clamp(n_in, min=1.0)
    H = torch.sum(w * Js * Js, dim=1) / n_safe
    b = torch.sum(w * Js * residual, dim=1) / n_safe
    zero = torch.zeros(G, device=dev)
    stats = ResStats(E=energy, num_terms=num_terms, flow_t=zero, flow_rt=zero,
                     saturated_ratio=num_sat / torch.clamp(num_terms, min=1.0))
    return _unbatch(ScalePassOut(stats=stats, H=H, b=b), batched)


def scale_residual_pass_cuda(img1, pu, pv, pid, pcolor, pmask, R01Ki, Ki0, t01,
                             scale, fx1, fy1, cx1, cy1, huber_th,
                             cutoff_th) -> ScalePassOut:
    """Launch kernel K3 (csrc/residual_hb.cu) for all guesses at once."""
    dev = img1.device
    f32 = dict(dtype=torch.float32, device=dev)
    scale = torch.as_tensor(scale, **f32)
    batched = scale.dim() == 1
    s = scale.reshape(-1)
    G = s.shape[0]
    params = torch.cat([
        torch.as_tensor(R01Ki, **f32).reshape(1, 9).expand(G, 9),
        torch.as_tensor(t01, **f32).reshape(1, 3).expand(G, 3),
        s[:, None],
        _batched(cutoff_th, G, dev)[:, None],
        torch.zeros(G, 2, **f32),
    ], dim=1).contiguous()
    img1 = img1.contiguous()
    pmask_u8 = pmask.to(torch.bool).contiguous().view(torch.uint8)
    N = pu.shape[0]
    H_img, W_img = img1.shape[0], img1.shape[1]
    nblk = _blocks_for(N)
    partial = torch.empty(G, nblk, 6, **f32)
    out = torch.empty(G, 8, **f32)
    _cuda.require_cuda("scale_residual_pass", img1, pu, pv, pid, pcolor,
                       pmask_u8, params)
    _cuda.call("dsslam_scale_pass", img1.data_ptr(), H_img, W_img,
               W_img - 1.001, H_img - 1.001, pu.data_ptr(), pv.data_ptr(),
               pid.data_ptr(), pcolor.data_ptr(), pmask_u8.data_ptr(), N,
               params.data_ptr(), G, fx1, fy1, cx1, cy1, huber_th,
               partial.data_ptr(), nblk, out.data_ptr())
    scale_residual_pass_cuda.launches += 1
    zero = torch.zeros(G, **f32)
    stats = ResStats(E=out[:, 2], num_terms=out[:, 3], flow_t=zero,
                     flow_rt=zero, saturated_ratio=out[:, 4])
    return _unbatch(ScalePassOut(stats=stats, H=out[:, 0], b=out[:, 1]), batched)


scale_residual_pass_cuda.launches = 0


# ---------------------------------------------------------------------------
# K4: loop-closure pose pass over metric 3-D points
# ---------------------------------------------------------------------------


def pose3d_residual_pass(img, px, py, pz, pcolor, pmask, R, t, aff_a, aff_b,
                         ref_b0, fx: float, fy: float, cx: float, cy: float,
                         huber_th: float, cutoff_th) -> PosePassOut:
    """Loop-estimator flavor: points [N] are metric xyz in the matched
    keyframe's camera frame, warped by ``R @ p + t``. ``R`` [3, 3] or
    [S, 3, 3] (the seed stack) with ``t`` [3] / [S, 3] and ``aff_a``,
    ``aff_b``, ``cutoff_th`` scalars or [S]; outputs carry the seed dim iff
    ``R`` does. No flow statistics (0). CUDA tensors launch kernel K4; CPU
    tensors take ``pose3d_residual_pass_plain``."""
    if img.is_cuda:
        return pose3d_residual_pass_cuda(img, px, py, pz, pcolor, pmask, R, t,
                                         aff_a, aff_b, ref_b0, fx, fy, cx, cy,
                                         huber_th, cutoff_th)
    return pose3d_residual_pass_plain(img, px, py, pz, pcolor, pmask, R, t, aff_a,
                                      aff_b, ref_b0, fx, fy, cx, cy, huber_th,
                                      cutoff_th)


def pose3d_residual_pass_plain(img, px, py, pz, pcolor, pmask, R, t, aff_a, aff_b,
                               ref_b0, fx, fy, cx, cy, huber_th,
                               cutoff_th) -> PosePassOut:
    """Plain PyTorch version of K4 (the reference's expression, batched)."""
    batched = R.dim() == 3
    R = R.reshape(-1, 3, 3)
    S = R.shape[0]
    dev = img.device
    t = t.reshape(S, 3)
    a = _batched(aff_a, S, dev)[:, None]
    bb = _batched(aff_b, S, dev)[:, None]
    cutoff = _batched(cutoff_th, S, dev)[:, None]
    ref_b0 = torch.as_tensor(ref_b0, dtype=torch.float32, device=dev)
    H_img, W_img = img.shape[0], img.shape[1]

    xyz = torch.stack([px, py, pz], dim=-1)                         # [N, 3]
    pt = xyz[None] @ R.transpose(1, 2) + t[:, None, :]              # [S, N, 3]
    u = pt[..., 0] / pt[..., 2]
    v = pt[..., 1] / pt[..., 2]
    Ku = fx * u + cx
    Kv = fy * v + cy
    new_id = 1.0 / pt[..., 2]
    valid = (pmask[None] & (Ku > 2.0) & (Kv > 2.0) & (Ku < W_img - 3.0)
             & (Kv < H_img - 3.0) & (new_id > 0.0))
    sums = _pose_sums(img, Ku, Kv, u, v, new_id, valid, pcolor, a, bb, ref_b0,
                      cutoff, fx, fy, huber_th)
    zero = torch.zeros(S, device=dev)
    return _pose_out(*sums, zero, zero, batched)


def pose3d_residual_pass_cuda(img, px, py, pz, pcolor, pmask, R, t, aff_a, aff_b,
                              ref_b0, fx, fy, cx, cy, huber_th,
                              cutoff_th) -> PosePassOut:
    """Launch kernel K4 (csrc/residual_hb.cu) for all seeds at once."""
    batched = R.dim() == 3
    R = R.reshape(-1, 3, 3)
    S = R.shape[0]
    dev = img.device
    params = torch.cat([
        R.reshape(S, 9).to(torch.float32),
        t.reshape(S, 3).to(torch.float32),
        _batched(aff_a, S, dev)[:, None],
        _batched(aff_b, S, dev)[:, None],
        _batched(cutoff_th, S, dev)[:, None],
        _batched(ref_b0, S, dev)[:, None],
        POSE_PRECOND.to(dev).reshape(1, 8).expand(S, 8),
    ], dim=1).contiguous()
    img = img.contiguous()
    pmask_u8 = pmask.to(torch.bool).contiguous().view(torch.uint8)
    N = px.shape[0]
    H_img, W_img = img.shape[0], img.shape[1]
    nblk = _blocks_for(N)
    partial = torch.empty(S, nblk, 48, dtype=torch.float32, device=dev)
    out = torch.empty(S, 80, dtype=torch.float32, device=dev)
    _cuda.require_cuda("pose3d_residual_pass", img, px, py, pz, pcolor, pmask_u8,
                       params)
    _cuda.call("dsslam_pose3d_pass", img.data_ptr(), H_img, W_img,
               W_img - 1.001, H_img - 1.001, px.data_ptr(), py.data_ptr(),
               pz.data_ptr(), pcolor.data_ptr(), pmask_u8.data_ptr(), N,
               params.data_ptr(), S, float(fx), float(fy), float(cx), float(cy),
               float(huber_th), partial.data_ptr(), nblk, out.data_ptr())
    pose3d_residual_pass_cuda.launches += 1
    stats = ResStats(E=out[:, 72], num_terms=out[:, 73], flow_t=out[:, 74],
                     flow_rt=out[:, 75], saturated_ratio=out[:, 76])
    res = PosePassOut(stats=stats, H=out[:, :64].reshape(S, 8, 8),
                      b=out[:, 64:72], num_in=out[:, 77])
    return _unbatch(res, batched)


pose3d_residual_pass_cuda.launches = 0
