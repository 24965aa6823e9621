"""Per-keyframe debug image dumps (port of viz/debug.py).

Runtime equivalents of the reference's online debug rendering: idepth jet
maps pushed to the viewer (TrackerAndScaler.cpp:338-449) and optional PNG
dumps (TAS.cpp:432-437). Enabled with cfg.runtime.debug_dump_dir; each new
keyframe writes ``kf_<id>_idepth.png`` (jet-colored template inverse depth
over the keyframe image) and ``kf_<id>_window.png``, each other frame
``frame_<id>_residual.png``.

Each function reads what it needs from the device in one packed copy
(``utils.device.to_host``), where the reference makes one bundled
``jax.device_get``; the arithmetic after it is the reference's numpy, so
the pixels are the reference's. The template's level-0 lists are read
once per template (it is replaced, never written, when it changes), so a
frame that makes no keyframe reads nothing from the device for its
residual image when its image is a host array. PNGs go through
``viz/png.py``.
"""

from __future__ import annotations

import os
import weakref

import numpy as np
import torch

from ..utils.device import to_host
from .export import _jet, depth_image_rgb
from .png import write_png

_TEMPLATE_FIELDS = ("pu", "pv", "pid", "pcolor", "pmask")
# the last template whose level-0 lists were read: (weak references to
# its tensors, their host copies)
_level0_read = [None]


def _host_level0(template, image=None):
    """Host copies of the template's level-0 (pu, pv, pid, pcolor, pmask)
    and of ``image`` (a device tensor, or None), in one packed copy; the
    lists of the template read last are not read again."""
    ts = tuple(getattr(template, k)[0] for k in _TEMPLATE_FIELDS)
    hit = _level0_read[0]
    if hit is not None and all(r() is t for r, t in zip(hit[0], ts)):
        lists = hit[1]
        img = to_host([image])[0] if image is not None else None
    else:
        host = to_host(list(ts) + ([image] if image is not None else []))
        lists = host[:len(ts)]
        img = host[len(ts)] if image is not None else None
        _level0_read[0] = (tuple(weakref.ref(t) for t in ts), lists)
    return (*lists, img)


def render_template_idepth(template, pyr0) -> np.ndarray:
    """Scatter the level-0 tracker template into a sparse idepth map and
    return the jet overlay as [H, W, 3] uint8 (the reference's KF
    depth-image pane, TrackerAndScaler.cpp:338-449)."""
    pu, pv, pid, _col, mask, img = _host_level0(
        template, pyr0.data[0][..., 0] if pyr0 is not None else None)
    h, w = (img.shape if img is not None
            else (int(pv.max()) + 2, int(pu.max()) + 2))
    idepth = np.zeros((h, w), np.float32)
    u = np.clip(np.round(pu).astype(int), 0, w - 1)
    v = np.clip(np.round(pv).astype(int), 0, h - 1)
    sel = mask & (pid > 0)
    idepth[v[sel], u[sel]] = pid[sel]
    # 2x2 dilation so single pixels are visible at full resolution
    d = np.maximum.reduce([
        idepth,
        np.roll(idepth, 1, 0), np.roll(idepth, 1, 1),
        np.roll(np.roll(idepth, 1, 0), 1, 1),
    ])
    return depth_image_rgb(d, image=img)


def dump_template_idepth(out_dir: str, kf_id: int, template, pyr0,
                         prefix: str = "kf"):
    """Write the jet overlay PNG (see render_template_idepth)."""
    rgb = render_template_idepth(template, pyr0)
    os.makedirs(out_dir, exist_ok=True)
    write_png(os.path.join(out_dir, f"{prefix}_{kf_id:05d}_idepth.png"), rgb)


def dump_tracking_residual(out_dir: str, frame_id: int, img_new,
                           template, intr, T_ref_new: np.ndarray,
                           a_rel: float, b_rel: float,
                           prefix: str = "frame"):
    """Level-0 photometric residual image of the accepted tracking pose
    (the reference's debugPlotResiduals pushes,
    TrackerAndScaler.cpp:730-734): template points warped by the final
    pose, |I_new - a*color - b| scattered at the projected pixels over the
    new image, jet-colored by residual magnitude (red = large).
    ``img_new`` is a host array or a tensor."""
    pu, pv, pid, col, mask, img_t = _host_level0(
        template, img_new if isinstance(img_new, torch.Tensor) else None)
    img = img_t if img_t is not None else np.asarray(img_new)
    h, w = img.shape
    fx, fy, cx, cy = (float(intr.fx[0]), float(intr.fy[0]),
                      float(intr.cx[0]), float(intr.cy[0]))
    X = np.stack([(pu - cx) / fx, (pv - cy) / fy, np.ones_like(pu)], -1)
    X = X / np.maximum(pid, 1e-9)[:, None]
    T = np.asarray(T_ref_new, np.float64)
    P = X @ T[:3, :3].T + T[:3, 3]
    z = P[:, 2]
    u = fx * P[:, 0] / np.maximum(z, 1e-9) + cx
    v = fy * P[:, 1] / np.maximum(z, 1e-9) + cy
    ok = mask & (pid > 0) & (z > 0) & (u >= 1) & (v >= 1) & \
        (u < w - 2) & (v < h - 2)
    ui = np.round(u).astype(int)
    vi = np.round(v).astype(int)
    r = np.zeros_like(pu)
    r[ok] = np.abs(img[vi[ok], ui[ok]] - (a_rel * col[ok] + b_rel))
    rgb = np.clip(img, 0, 255).astype(np.uint8)[..., None].repeat(3, -1)
    jet = _jet(np.clip(r / 30.0, 0, 1))       # 30 intensity units = red
    rgb[vi[ok], ui[ok]] = jet[ok]
    os.makedirs(out_dir, exist_ok=True)
    write_png(os.path.join(out_dir, f"{prefix}_{frame_id:05d}_residual.png"), rgb)


def dump_window_stitch(out_dir: str, kf_id: int, frontend,
                       prefix: str = "kf"):
    """Tile every active window keyframe's image with its hosted active
    points overlaid (jet by inverse depth) — the reference's window-stitch
    debug plot (FrontEndDebugStuff.cpp:34-310)."""
    st = frontend.ba_state
    slots = [s for s in frontend._active_slots() if s in frontend.pyramids]
    if not slots:
        return
    pu, pv, pid, pvalid, phost, *images = to_host(
        [st.p_u, st.p_v, st.p_idepth, st.p_valid, st.p_host]
        + [frontend.pyramids[s].data[0][..., 0] for s in slots])
    tiles = []
    for s, img in zip(slots, images):
        rgb = np.clip(img, 0, 255).astype(np.uint8)[..., None].repeat(3, -1)
        sel = pvalid & (phost == s) & (pid > 0)
        if sel.any():
            lo, hi = np.percentile(pid[sel], [5, 95])
            jet = _jet((pid - lo) / max(hi - lo, 1e-9))
            ui = np.clip(np.round(pu).astype(int), 0, rgb.shape[1] - 1)
            vi = np.clip(np.round(pv).astype(int), 0, rgb.shape[0] - 1)
            for dy in (0, 1):
                for dx in (0, 1):
                    rgb[np.clip(vi[sel] + dy, 0, rgb.shape[0] - 1),
                        np.clip(ui[sel] + dx, 0, rgb.shape[1] - 1)] = jet[sel]
        tiles.append(rgb)
    # grid: up to 4 tiles per row
    per_row = min(4, len(tiles))
    rows = []
    for i in range(0, len(tiles), per_row):
        row = tiles[i:i + per_row]
        row += [np.zeros_like(tiles[0])] * (per_row - len(row))
        rows.append(np.concatenate(row, axis=1))
    grid = np.concatenate(rows, axis=0)
    os.makedirs(out_dir, exist_ok=True)
    write_png(os.path.join(out_dir, f"{prefix}_{kf_id:05d}_window.png"), grid)
