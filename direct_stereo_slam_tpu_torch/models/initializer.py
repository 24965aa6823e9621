"""Bootstrap initializer from one stereo pair (port of models/initializer.py).

The pixel selector picks candidates in the left image; a full-length
epipolar trace against the right image (static stereo, known extrinsics)
gives metric inverse depths in one shot.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SLAMConfig
from ..geometry.camera import PyramidIntrinsics
from ..ops.pyramid import Pyramid
from ..ops.select import make_selection_map
from . import immature


class InitResult(NamedTuple):
    ok: bool
    u: Optional[torch.Tensor]       # [K] selected pixels
    v: Optional[torch.Tensor]
    idepth: Optional[torch.Tensor]  # [K] metric inverse depth
    color: Optional[torch.Tensor]   # [K, 8]
    weight: Optional[torch.Tensor]  # [K, 8]
    valid: Optional[torch.Tensor]   # [K] bool


def initialize_from_stereo(pyr0: Pyramid, pyr1: Pyramid, intr: PyramidIntrinsics,
                           t_cam1_cam0: np.ndarray, cfg: SLAMConfig, budget: int,
                           pot: int = 5, min_points: int = 50) -> InitResult:
    """Up to ``budget`` metric-depth points from one stereo pair."""
    dev = pyr0.data[0].device
    K = np.asarray(intr.K(0), np.float32)
    sel, _ = make_selection_map(pyr0.abs_grad[0], pyr0.abs_grad[1],
                                pyr0.abs_grad[2], pot, cfg)
    pts = immature.create_points(pyr0.data[0], sel, budget)
    KRKi = torch.as_tensor(K @ t_cam1_cam0[:3, :3] @ np.linalg.inv(K),
                           dtype=torch.float32, device=dev)
    Kt = torch.as_tensor(K @ t_cam1_cam0[:3, 3], dtype=torch.float32, device=dev)
    # dense sample grid: the stereo search spans up to w/3 pixels, and far
    # points need sub-pixel disparity
    traced = immature.trace_points(pts, pyr1.data[0], KRKi, Kt, 1.0, 0.0, cfg,
                                   max_search_px=float(intr.w[0]) / 3.0,
                                   num_steps=256)
    good = ((traced.status == immature.IPS_GOOD) & traced.valid
            & (traced.quality > cfg.trace.min_trace_quality))
    idepth = 0.5 * (traced.idepth_min + traced.idepth_max)
    good = good & (idepth > 1e-4)
    if int(good.sum()) < min_points:
        return InitResult(False, None, None, None, None, None, None)
    return InitResult(ok=True, u=traced.u, v=traced.v, idepth=idepth,
                      color=traced.color, weight=traced.weight, valid=good)
