"""Bilinear interpolation of (I, dx, dy) planes (port of ops/interp.py).

One sampler with the reference's semantics: coordinates are clamped to
``[0, W - 1.001] x [0, H - 1.001]``, the four taps (ix, iy), (ix+1, iy),
(ix, iy+1), (ix+1, iy+1) are blended with fractional weights, and masking
of out-of-range lanes is left to the caller. The reference's TPU gather
variants (flat takes, planes-first forms) have no counterpart here.
"""

from __future__ import annotations

import torch


def _corners(H: int, W: int, u: torch.Tensor, v: torch.Tensor):
    u = torch.clamp(u, 0.0, W - 1.001)
    v = torch.clamp(v, 0.0, H - 1.001)
    # the clamp keeps finite coordinates in range; the index clamp only
    # guards NaN lanes (which the caller masks) against an invalid index
    ix = torch.floor(u).to(torch.int64).clamp_(0, W - 2)
    iy = torch.floor(v).to(torch.int64).clamp_(0, H - 2)
    fx = u - ix.to(u.dtype)
    fy = v - iy.to(v.dtype)
    return ix, iy, fx, fy


def bilinear_gather(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """img: [H, W, C] (channel-last); u, v: [...] pixel coords -> [..., C]."""
    H, W, C = img.shape
    ix, iy, fx, fy = _corners(H, W, u, v)
    base = iy * W + ix
    fx = fx[..., None]
    fy = fy[..., None]
    flat = img.reshape(H * W, C)
    p00 = flat[base]
    p10 = flat[base + 1]
    p01 = flat[base + W]
    p11 = flat[base + W + 1]
    top = p00 * (1.0 - fx) + p10 * fx
    bot = p01 * (1.0 - fx) + p11 * fx
    return top * (1.0 - fy) + bot * fy


def bilinear_gather_scalar(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """img: [H, W]; returns [...] interpolated scalar."""
    return bilinear_gather(img[..., None], u, v)[..., 0]


def bilinear_gather_frames(images: torch.Tensor, fidx: torch.Tensor,
                           u: torch.Tensor, v: torch.Tensor):
    """images: [F, H, W, C]; fidx broadcastable to u/v; returns a C-tuple of
    planes sampled in frame ``fidx`` at (u, v)."""
    F_, H, W, C = images.shape
    ix, iy, fx, fy = _corners(H, W, u, v)
    fidx = torch.broadcast_to(fidx, ix.shape)
    base = (fidx * H + iy) * W + ix
    fx = fx[..., None]
    fy = fy[..., None]
    flat = images.reshape(F_ * H * W, C)
    p00 = flat[base]
    p10 = flat[base + 1]
    p01 = flat[base + W]
    p11 = flat[base + W + 1]
    top = p00 * (1.0 - fx) + p10 * fx
    bot = p01 * (1.0 - fx) + p11 * fx
    out = top * (1.0 - fy) + bot * fy
    return tuple(out[..., c] for c in range(C))
