"""Camera calibration parsing and rectification-map construction (the
port's copy of the JAX package's ``utils/calib.py``, pinned to it by
``tests/test_torch_host_copies.py``).

Replaces the external DSO ``Undistort::getUndistorterForFile`` (reference
call site main.cpp:146-147). Supports the DSO text format used by the
reference's ``cams/**/camera*.txt``:

    line 1: "Pinhole fx fy cx cy 0"  |  "RadTan fx fy cx cy k1 k2 r1 r2"
            | "fx fy cx cy omega" (FOV model, all values relative if < 1)
    line 2: "in_w in_h"
    line 3: "crop" | "full" | "fx fy cx cy 0" (explicit output K, relative)
    line 4: "out_w out_h"

Relative (normalized) intrinsics (fx<=1) are scaled by the input size as DSO
does: fx*w, fy*h, cx*w-0.5, cy*h-0.5.

Also parses ``T_stereo.yaml`` (pose of cam0 in cam1, reference README.md:58)
and DSO gamma ``pcalib.txt`` / vignette files for photometric undistortion
(photometric mode 0).
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class CameraModel:
    kind: str                      # "pinhole" | "radtan" | "fov"
    fx: float
    fy: float
    cx: float
    cy: float
    dist: Tuple[float, ...]        # distortion params (model-specific)
    in_w: int
    in_h: int


@dataclass(frozen=True)
class RectifiedCamera:
    """Output of calibration processing: output pinhole K + remap grids."""

    fx: float
    fy: float
    cx: float
    cy: float
    w: int
    h: int
    # remap_x/y[vo, uo] = source pixel coords in the raw image (float32),
    # -1 where invalid. Identity rectification => None (pure pinhole).
    remap_x: Optional[np.ndarray]
    remap_y: Optional[np.ndarray]

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1.0]],
            dtype=np.float64,
        )


def _parse_floats(line: str):
    return [float(x) for x in line.replace(",", " ").split()]


def parse_camera_file(path: str) -> Tuple[CameraModel, str, Tuple[int, int]]:
    """Returns (input model, output mode string, output size)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f.read().splitlines() if ln.strip()]
    if len(lines) < 4:
        raise ValueError(f"calibration file {path}: expected 4 lines, got {len(lines)}")

    toks = lines[0].split()
    if toks[0].lower() == "pinhole":
        vals = [float(x) for x in toks[1:]]
        kind, params, dist = "pinhole", vals[:4], ()
    elif toks[0].lower() == "radtan":
        vals = [float(x) for x in toks[1:]]
        kind, params, dist = "radtan", vals[:4], tuple(vals[4:8])
    elif toks[0].lower() in ("equidistant", "kannalabrandt"):
        vals = [float(x) for x in toks[1:]]
        kind, params, dist = "equidistant", vals[:4], tuple(vals[4:8])
    else:
        vals = _parse_floats(lines[0])
        if len(vals) == 5:
            kind, params, dist = "fov", vals[:4], (vals[4],)
        else:
            raise ValueError(f"unrecognized camera model line: {lines[0]!r}")

    in_w, in_h = (int(x) for x in lines[1].split()[:2])
    fx, fy, cx, cy = params
    # DSO convention: values <= 1 are relative to image size
    if fx <= 1.0 and fy <= 1.0:
        fx, fy = fx * in_w, fy * in_h
        cx, cy = cx * in_w - 0.5, cy * in_h - 0.5

    model = CameraModel(kind, fx, fy, cx, cy, dist, in_w, in_h)
    out_mode = lines[2]
    out_w, out_h = (int(x) for x in lines[3].split()[:2])
    return model, out_mode, (out_w, out_h)


def _distort_point(model: CameraModel, xn: np.ndarray, yn: np.ndarray):
    """Normalized ideal coords -> normalized distorted coords."""
    if model.kind == "pinhole":
        return xn, yn
    if model.kind == "fov":
        (omega,) = model.dist
        if abs(omega) < 1e-9:
            return xn, yn
        r = np.sqrt(xn * xn + yn * yn)
        fac = np.where(
            r < 1e-8, 1.0, np.arctan(r * 2.0 * np.tan(omega * 0.5)) / (omega * np.maximum(r, 1e-8))
        )
        return xn * fac, yn * fac
    if model.kind == "radtan":
        k1, k2, p1, p2 = model.dist
        r2 = xn * xn + yn * yn
        rad = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = xn * rad + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
        yd = yn * rad + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
        return xd, yd
    if model.kind == "equidistant":
        k1, k2, k3, k4 = model.dist
        r = np.sqrt(xn * xn + yn * yn)
        th = np.arctan(r)
        th2 = th * th
        thd = th * (1 + k1 * th2 + k2 * th2**2 + k3 * th2**3 + k4 * th2**4)
        fac = np.where(r < 1e-8, 1.0, thd / np.maximum(r, 1e-8))
        return xn * fac, yn * fac
    raise ValueError(model.kind)


def _compute_crop_K(model: CameraModel, out_w: int, out_h: int):
    """DSO 'crop' mode: find the largest output pinhole K whose every pixel
    maps inside the raw image (UndistortFOV::makeOptimalK_crop equivalent,
    simplified iterative shrink)."""
    # sample border rays of the output image in normalized coords, expand
    # focal until all map inside; binary-search style refinement.
    # Start from input focal scaled to output size.
    if model.kind == "pinhole" and not model.dist:
        # pure pinhole: scale K to output size
        sx = out_w / model.in_w
        sy = out_h / model.in_h
        return (
            model.fx * sx,
            model.fy * sy,
            (model.cx + 0.5) * sx - 0.5,
            (model.cy + 0.5) * sy - 0.5,
        )

    # For distorted models: find the LARGEST ideal-coordinate box whose
    # every border point maps inside the raw image after distortion —
    # DSO's makeOptimalK_crop guarantee (every output pixel valid), done
    # as bound-then-shrink instead of its randomized sampling.
    us = np.linspace(0, model.in_w - 1, 200)
    vs = np.linspace(0, model.in_h - 1, 200)
    uu, vv = np.meshgrid(us, vs)
    xd = (uu - model.cx) / model.fx
    yd = (vv - model.cy) / model.fy
    # approximate undistortion by fixed-point iteration
    xn, yn = xd.copy(), yd.copy()
    for _ in range(30):
        xdd, ydd = _distort_point(model, xn, yn)
        xn += xd - xdd
        yn += yd - ydd
    # start from the full ideal extent and shrink toward the center until
    # the box's distorted BORDER lies inside the raw image (the extrema
    # of a monotone radial distortion are on the border)
    x_lo, x_hi = xn.min(), xn.max()
    y_lo, y_hi = yn.min(), yn.max()
    t = np.linspace(0.0, 1.0, 256)
    ones = np.ones_like(t)

    def border_inside(xl, xh, yl, yh):
        bx = np.concatenate([xl + (xh - xl) * t, xl + (xh - xl) * t,
                             xl * ones, xh * ones])
        by = np.concatenate([yl * ones, yh * ones,
                             yl + (yh - yl) * t, yl + (yh - yl) * t])
        dx, dy = _distort_point(model, bx, by)
        su = model.fx * dx + model.cx
        sv = model.fy * dy + model.cy
        return (su.min() >= 0 and su.max() <= model.in_w - 1.001
                and sv.min() >= 0 and sv.max() <= model.in_h - 1.001)

    for _ in range(400):
        if border_inside(x_lo, x_hi, y_lo, y_hi):
            break
        mx, my = 0.5 * (x_lo + x_hi), 0.5 * (y_lo + y_hi)
        x_lo, x_hi = mx + (x_lo - mx) * 0.995, mx + (x_hi - mx) * 0.995
        y_lo, y_hi = my + (y_lo - my) * 0.995, my + (y_hi - my) * 0.995
    fx = (out_w - 1) / (x_hi - x_lo)
    fy = (out_h - 1) / (y_hi - y_lo)
    cx = -x_lo * fx
    cy = -y_lo * fy
    return fx, fy, cx, cy


def build_rectified_camera(path: str) -> RectifiedCamera:
    model, out_mode, (out_w, out_h) = parse_camera_file(path)

    if out_mode.lower().startswith("crop"):
        fx, fy, cx, cy = _compute_crop_K(model, out_w, out_h)
    elif out_mode.lower().startswith("full") or out_mode.lower().startswith("none"):
        sx, sy = out_w / model.in_w, out_h / model.in_h
        fx, fy = model.fx * sx, model.fy * sy
        cx, cy = (model.cx + 0.5) * sx - 0.5, (model.cy + 0.5) * sy - 0.5
    else:
        vals = _parse_floats(out_mode)
        fx, fy, cx, cy = vals[0] * out_w, vals[1] * out_h, vals[2] * out_w - 0.5, vals[3] * out_h - 0.5

    identity = (
        model.kind == "pinhole"
        and not model.dist
        and out_w == model.in_w
        and out_h == model.in_h
        and abs(fx - model.fx) < 1e-6
        and abs(fy - model.fy) < 1e-6
        and abs(cx - model.cx) < 1e-6
        and abs(cy - model.cy) < 1e-6
    )
    if identity:
        return RectifiedCamera(fx, fy, cx, cy, out_w, out_h, None, None)

    # build remap: for each output pixel, ideal ray -> distort -> raw pixel
    uo, vo = np.meshgrid(np.arange(out_w), np.arange(out_h))
    xn = (uo - cx) / fx
    yn = (vo - cy) / fy
    xd, yd = _distort_point(model, xn, yn)
    src_x = (model.fx * xd + model.cx).astype(np.float32)
    src_y = (model.fy * yd + model.cy).astype(np.float32)
    invalid = (
        (src_x < 0) | (src_x > model.in_w - 1.001) | (src_y < 0) | (src_y > model.in_h - 1.001)
    )
    src_x[invalid] = -1.0
    src_y[invalid] = -1.0
    return RectifiedCamera(fx, fy, cx, cy, out_w, out_h, src_x, src_y)


def parse_t_stereo(path: str) -> np.ndarray:
    """Parse T_stereo.yaml (pose of cam0 in cam1 frame; reference
    cams/*/T_stereo.yaml, consumed at main.cpp:275). Returns [4,4]."""
    with open(path) as f:
        text = f.read()
    m = re.search(r"data\s*:\s*\[([^\]]*)\]", text, re.S)
    if not m:
        raise ValueError(f"{path}: no data: [...] block found")
    vals = [float(x) for x in m.group(1).replace("\n", " ").split(",")]
    if len(vals) != 16:
        raise ValueError(f"{path}: expected 16 values, got {len(vals)}")
    return np.array(vals, dtype=np.float64).reshape(4, 4)


def parse_gamma(path: str) -> np.ndarray:
    """DSO pcalib: 256 (or more) irradiance values G[i]; returns Binv[256]
    normalized to 0..255 (Undistort::loadPhotometricCalibration)."""
    with open(path) as f:
        vals = np.array([float(x) for x in f.read().split()], dtype=np.float64)
    if len(vals) < 256:
        raise ValueError(f"{path}: gamma file needs >=256 values")
    # resample to 256 and normalize
    if len(vals) != 256:
        xs = np.linspace(0, len(vals) - 1, 256)
        vals = np.interp(xs, np.arange(len(vals)), vals)
    vals = vals - vals.min()
    vals = vals / vals.max() * 255.0
    return vals.astype(np.float32)


def parse_vignette(path: str, out_w: int = None, out_h: int = None) -> np.ndarray:
    """Load a DSO vignette image (16-bit or 8-bit PNG/PGM of relative optical
    attenuation; Undistort::loadPhotometricCalibration). Returns float [H, W]
    normalized so max == 1, optionally resized to the working resolution."""
    img = None
    try:
        import cv2
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is not None and img.ndim == 3:
            img = img.mean(axis=2)
        if img is not None and (out_w or out_h):
            img = cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)
    except ImportError:
        pass
    if img is None:
        from PIL import Image
        im = Image.open(path).convert("F")
        if out_w and out_h:
            im = im.resize((out_w, out_h))
        img = np.asarray(im)
    img = img.astype(np.float64)
    m = img.max()
    if m <= 0:
        raise ValueError(f"{path}: vignette image is empty")
    return (img / m).astype(np.float32)
