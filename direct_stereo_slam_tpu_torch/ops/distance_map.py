"""Half-resolution distance transform for activation gating (port of
ops/distance_map.py): kernel K1.

Active window points projected into the newest keyframe at half
resolution mark an occupancy grid; 16 (``MAX_DIST``) 3x3 min-plus
relaxations turn it into the Chebyshev distance to the nearest occupied
cell, capped at 16. Candidates are activated only where that distance
exceeds an adaptive threshold.

For CUDA tensors ``build_distance_map`` launches the hand-written kernel
(``csrc/distance_map.cu``); ``build_distance_map_plain`` is the plain
PyTorch version, taken only for CPU tensors. Values are small integers in
f32, so the two are bit-equal.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda

MAX_DIST = 16


def _relax_once(d: torch.Tensor) -> torch.Tensor:
    """One 3x3 min-plus (Chebyshev) relaxation with MAX_DIST borders."""
    dp = F.pad(d[None, None], (1, 1, 1, 1), value=float(MAX_DIST))
    winmin = -F.max_pool2d(-dp, 3, stride=1)[0, 0]
    return torch.minimum(d, winmin + 1.0)


def _occupancy_indices(pu, pv, h2: int, w2: int):
    # jnp.round and torch.round both round half to even; clamping in float
    # before the int conversion equals the reference's saturating cast + clip
    ui = torch.clamp(torch.round(pu), 0, w2 - 1).to(torch.int64)
    vi = torch.clamp(torch.round(pv), 0, h2 - 1).to(torch.int64)
    return vi, ui


def build_distance_map_plain(pu, pv, mask, h2: int, w2: int) -> torch.Tensor:
    """Plain PyTorch version of K1: returns [h2, w2] f32 distances."""
    vi, ui = _occupancy_indices(pu, pv, h2, w2)
    flat = torch.full((h2 * w2,), float(MAX_DIST), dtype=torch.float32,
                      device=pu.device)
    idx = (vi * w2 + ui)[mask]
    flat[idx] = 0.0
    d = flat.reshape(h2, w2)
    for _ in range(MAX_DIST):
        d = _relax_once(d)
    return d


def build_distance_map_cuda(pu, pv, mask, h2: int, w2: int) -> torch.Tensor:
    """Launch kernel K1 (csrc/distance_map.cu): occupancy + 16 relaxations."""
    pu = pu.to(torch.float32).contiguous()
    pv = pv.to(torch.float32).contiguous()
    mask_u8 = mask.to(torch.bool).contiguous().view(torch.uint8)
    _cuda.require_cuda("build_distance_map", pu, pv, mask_u8)
    occ = torch.empty(h2, w2, dtype=torch.float32, device=pu.device)
    out = torch.empty(h2, w2, dtype=torch.float32, device=pu.device)
    _cuda.call("dsslam_distance_map", pu.data_ptr(), pv.data_ptr(),
               mask_u8.data_ptr(), pu.shape[0], occ.data_ptr(), out.data_ptr(),
               h2, w2)
    build_distance_map_cuda.launches += 1
    return out


build_distance_map_cuda.launches = 0


def build_distance_map(pu: torch.Tensor, pv: torch.Tensor, mask: torch.Tensor,
                       h2: int, w2: int) -> torch.Tensor:
    """[h2, w2] float distance-to-nearest-occupied (capped at MAX_DIST).
    pu, pv: [N] projected half-res pixel coords; mask: [N] bool."""
    if pu.is_cuda:
        return build_distance_map_cuda(pu, pv, mask, h2, w2)
    return build_distance_map_plain(pu, pv, mask, h2, w2)
