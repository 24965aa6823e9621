"""Headless visualization exports.

The port's copy of the JAX package's ``viz/export.py`` (numpy only),
pinned to it by ``tests/test_torch_host_copies.py``; PNGs go through the
port's own encoder (``viz/png.py``), not cv2 or PIL.

Replaces the reference's Pangolin viewer stack (pangolin_viewer/
PangolinLoopViewer + KeyFrameDisplay: trajectory + point cloud + KF depth
image + lidar-scan panes) with file exports usable from any environment:

* ``write_ply`` — point clouds (the KeyFrameDisplay GL buffers);
* ``write_trajectory_ply`` — trajectory polyline with per-vertex color;
* ``plot_trajectories`` — matplotlib top-down x/z comparison plot (the
  sodso-vs-dslam A/B view, README.md:73-75);
* ``depth_image_png`` — jet-colored inverse-depth map (the reference's
  ``debugPlotIDepthMap`` pane, TrackerAndScaler.cpp:338-449).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .png import write_png


def write_ply(path: str, pts: np.ndarray, colors: Optional[np.ndarray] = None):
    """pts [N, 3] float; colors [N, 3] uint8 optional."""
    n = len(pts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{pts[i, 0]:.4f} {pts[i, 1]:.4f} {pts[i, 2]:.4f}"
            if colors is not None:
                row += f" {int(colors[i, 0])} {int(colors[i, 1])} {int(colors[i, 2])}"
            f.write(row + "\n")


def write_trajectory_ply(path: str, positions: np.ndarray,
                         color: Tuple[int, int, int] = (255, 0, 0)):
    cols = np.tile(np.asarray(color, np.uint8), (len(positions), 1))
    write_ply(path, positions, cols)


def plot_trajectories(path: str, named_trajectories, gt: Optional[np.ndarray] = None):
    """Top-down (x, z) plot. named_trajectories: list of (label, [N, 3])."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    if gt is not None:
        ax.plot(gt[:, 0], gt[:, 2], "k--", label="ground truth", linewidth=1)
    for label, tr in named_trajectories:
        tr = np.asarray(tr)
        ax.plot(tr[:, 0], tr[:, 2], label=label, linewidth=1.2)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def _jet(x: np.ndarray) -> np.ndarray:
    """x in [0,1] -> [.., 3] uint8 jet colors (MinimalImage makeJet3B)."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def depth_image_rgb(idepth_map: np.ndarray,
                    image: Optional[np.ndarray] = None) -> np.ndarray:
    """Jet-colored idepth overlay (invalid = grayscale background) as an
    [H, W, 3] uint8 array — shared by the PNG dump and the live viewer's
    KF depth pane."""
    valid = idepth_map > 0
    lo = np.percentile(idepth_map[valid], 5) if valid.any() else 0.0
    hi = np.percentile(idepth_map[valid], 95) if valid.any() else 1.0
    norm = (idepth_map - lo) / max(hi - lo, 1e-9)
    rgb = _jet(norm)
    if image is not None:
        bg = np.clip(image, 0, 255).astype(np.uint8)[..., None].repeat(3, -1)
        rgb = np.where(valid[..., None], rgb, bg)
    else:
        rgb = np.where(valid[..., None], rgb, 0)
    return rgb


def depth_image_png(path: str, idepth_map: np.ndarray, image: Optional[np.ndarray] = None):
    """Jet-colored idepth overlay (invalid = grayscale background)."""
    write_png(path, depth_image_rgb(idepth_map, image))


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """Absolute trajectory error (translation RMSE) after Umeyama-free
    direct comparison (both in the same frame)."""
    d = est - gt
    return float(np.sqrt((d**2).sum(axis=1).mean()))


def ate_rmse_aligned(est: np.ndarray, gt: np.ndarray) -> float:
    """ATE after SE(3) alignment (Horn/Kabsch on positions)."""
    ce, cg = est.mean(0), gt.mean(0)
    H = (est - ce).T @ (gt - cg)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1, 1, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    est_al = (est - ce) @ R.T + cg
    return ate_rmse(est_al, gt)
