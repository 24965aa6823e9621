"""Pinhole camera / pyramid intrinsics (port of geometry/camera.py).

Per-level intrinsics follow the reference's pyramid convention:
``fx[l] = fx[l-1] * 0.5``, ``cx[l] = (cx[0] + 0.5) / 2^l - 0.5``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class PyramidIntrinsics(NamedTuple):
    """Static (host) per-level intrinsics."""

    fx: Tuple[float, ...]
    fy: Tuple[float, ...]
    cx: Tuple[float, ...]
    cy: Tuple[float, ...]
    w: Tuple[int, ...]
    h: Tuple[int, ...]

    @property
    def levels(self) -> int:
        return len(self.fx)

    def K(self, lvl: int) -> np.ndarray:
        return np.array(
            [[self.fx[lvl], 0.0, self.cx[lvl]],
             [0.0, self.fy[lvl], self.cy[lvl]],
             [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    def Ki(self, lvl: int) -> np.ndarray:
        return np.linalg.inv(self.K(lvl))


def make_pyramid_intrinsics(fx: float, fy: float, cx: float, cy: float,
                            w: int, h: int, levels: int) -> PyramidIntrinsics:
    fxs, fys, cxs, cys, ws, hs = [fx], [fy], [cx], [cy], [w], [h]
    for lvl in range(1, levels):
        fxs.append(fxs[-1] * 0.5)
        fys.append(fys[-1] * 0.5)
        cxs.append((cx + 0.5) / (1 << lvl) - 0.5)
        cys.append((cy + 0.5) / (1 << lvl) - 0.5)
        ws.append(w >> lvl)
        hs.append(h >> lvl)
    return PyramidIntrinsics(tuple(fxs), tuple(fys), tuple(cxs), tuple(cys),
                             tuple(ws), tuple(hs))


def num_usable_levels(w: int, h: int, max_levels: int = 6) -> int:
    """Levels while dimensions stay even and the level is >= 64 px wide
    (see the reference's docstring for the depth gate's rationale)."""
    levels = 1
    wl, hl = w, h
    while levels < max_levels and wl % 2 == 0 and hl % 2 == 0 and wl >= 64:
        wl //= 2
        hl //= 2
        levels += 1
    return levels


def project(pts_cam: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) pixels."""
    z = pts_cam[..., 2]
    u = pts_cam[..., 0] / z
    v = pts_cam[..., 1] / z
    return torch.stack([fx * u + cx, fy * v + cy], dim=-1)


def backproject(u: torch.Tensor, v: torch.Tensor, idepth: torch.Tensor,
                fx, fy, cx, cy) -> torch.Tensor:
    """Pixels + inverse depth -> (..., 3) camera-frame points."""
    z = 1.0 / idepth
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    return torch.stack([x, y, z], dim=-1)
