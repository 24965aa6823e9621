"""Image undistortion: photometric correction and geometric remap (port of
io/undistort.py).

DSO's ``Undistort::undistort<uchar>`` and ``photometricUndist`` (reference
call sites main.cpp:249-255): the inverse response through the 256-entry
``Binv`` table with linear interpolation, the division by the vignette
(applied in the raw frame, before the remap), then a bilinear remap
through the rectification grids of ``utils.calib.build_rectified_camera``
(output pixels whose source lies outside the raw image read 0). The grids
and tables live on the device the ``Undistorter`` was made for; the raw
image is copied there as it comes (uint8 stays uint8) without waiting
for the stream.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.interp import bilinear_gather_scalar
from ..utils.device import DEFAULT_DEVICE, resolve_device, to_device


def undistort_image(raw: torch.Tensor, remap_x: Optional[torch.Tensor],
                    remap_y: Optional[torch.Tensor], has_remap: bool,
                    binv_lut: Optional[torch.Tensor] = None,
                    inv_vignette: Optional[torch.Tensor] = None) -> torch.Tensor:
    """raw [H_in, W_in] (uint8 or float) -> f32 [H_out, W_out], the
    irradiance-corrected, rectified image."""
    img = raw.to(torch.float32)
    if binv_lut is not None:
        idx = torch.clamp(img, 0.0, 255.0)
        lo = torch.floor(idx).to(torch.int64)
        frac = idx - lo.to(torch.float32)
        img = binv_lut[lo] * (1.0 - frac) + binv_lut[torch.clamp(lo + 1, 0, 255)] * frac
    if inv_vignette is not None:
        img = img * inv_vignette
    if has_remap:
        out = bilinear_gather_scalar(img, remap_x, remap_y)
        return torch.where(remap_x < 0, torch.zeros_like(out), out)
    return img


class Undistorter:
    """A camera's remap grids and photometric tables on ``device``;
    calling it undistorts one raw image (numpy or tensor)."""

    def __init__(self, rect_cam, binv: Optional[np.ndarray] = None,
                 vignette: Optional[np.ndarray] = None, device=DEFAULT_DEVICE):
        self.cam = rect_cam
        self.device = resolve_device(device)
        self.has_remap = rect_cam.remap_x is not None
        put = lambda a: to_device(np.asarray(a, np.float32), self.device)
        self.remap_x = put(rect_cam.remap_x) if self.has_remap else None
        self.remap_y = put(rect_cam.remap_y) if self.has_remap else None
        self.binv = put(binv) if binv is not None else None
        self.inv_vignette = (put(1.0 / np.maximum(vignette, 1e-3))
                             if vignette is not None else None)

    def __call__(self, raw) -> torch.Tensor:
        if isinstance(raw, torch.Tensor):
            raw = raw.to(self.device)
        else:
            raw = to_device(np.asarray(raw), self.device)
        return undistort_image(raw, self.remap_x, self.remap_y, self.has_remap,
                               self.binv, self.inv_vignette)
