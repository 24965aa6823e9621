"""Evaluation harness (port of runtime/eval.py): run a dataset through the
full pipeline (SLAMNode + LoopHandler) and score trajectories against
ground truth.

``run_sequence`` drives the port over any dataset object with
``frame(i) -> {img0, img1, timestamp}``; the ATE helpers score
``incoming_id x y z`` trajectory rows against ground-truth positions."""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import SLAMConfig
from ..geometry.camera import make_pyramid_intrinsics, num_usable_levels
from ..loop.handler import LoopHandler
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.timing import StageTimers
from .node import STAGE_NAMES, SLAMNode


def run_sequence(ds, cfg: SLAMConfig, K: np.ndarray, t_cam1_cam0: np.ndarray,
                 undistorter0=None, undistorter1=None, levels: int = 5,
                 threaded_loop: Optional[bool] = None, progress: bool = False,
                 max_frames: Optional[int] = None, device=DEFAULT_DEVICE,
                 sync_timers: bool = False):
    """Run the full SLAM pipeline over ``ds`` on ``device``. Returns (node,
    handler, wall_seconds); on a card the time ends after the loop
    handler has drained and the device has synchronized."""
    import torch

    device = resolve_device(device)
    f0 = ds.frame(0)
    h, w = np.asarray(f0["img0"]).shape[:2]
    if undistorter0 is not None:
        w, h = undistorter0.cam.w, undistorter0.cam.h
    # floor at 3: the pixel selector scores on three pyramid scales
    levels = min(levels, max(3, num_usable_levels(w, h)))
    cfg = cfg.replace(tracker=dataclasses.replace(cfg.tracker, pyr_levels=levels))
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], w, h, levels)
    timers = StageTimers(sync=sync_timers)
    handler = LoopHandler(cfg, intr, timers=timers, threaded=threaded_loop,
                          device=device)
    node = SLAMNode(cfg, intr, intr, t_cam1_cam0, loop_handler=handler,
                    undistorter0=undistorter0, undistorter1=undistorter1,
                    device=device)
    node.timers = timers
    node.frontend.timers = timers

    n = len(ds) if max_frames is None else min(len(ds), max_frames)
    t0 = time.perf_counter()
    for i in range(n):
        f = ds.frame(i)
        node.process(f["img0"], f["img1"], float(f["timestamp"]),
                     exposure=float(f.get("exposure", 1.0)))
        if progress and i % 50 == 0:
            print(f"  [{i}/{n}] kfs={node.frontend.num_kfs} "
                  f"loops={handler.direct_loop_count}+{handler.icp_loop_count}",
                  flush=True)
    node.finish()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return node, handler, time.perf_counter() - t0


def kitti_gt_positions(root: str, seq: str) -> Optional[np.ndarray]:
    """Ground-truth cam0 positions [N, 3] from <root>/poses/<seq>.txt
    (KITTI odometry devkit format: 12 floats = 3x4 row-major per frame)."""
    path = os.path.join(root, "poses", f"{seq}.txt")
    if not os.path.exists(path):
        return None
    return np.loadtxt(path).reshape(-1, 3, 4)[:, :, 3]


def trajectory_xyz(rows: List) -> Tuple[np.ndarray, np.ndarray]:
    """(frame_ids, positions [K, 3]) from `incoming_id x y z` rows."""
    if not len(rows):
        return np.zeros(0, np.int64), np.zeros((0, 3))
    arr = np.asarray([[r[0], r[1], r[2], r[3]] for r in rows], np.float64)
    return arr[:, 0].astype(np.int64), arr[:, 1:4]


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: str = "se3") -> float:
    """ATE RMSE after alignment: 'none', 'se3' (rigid Umeyama) or 'sim3'
    (adds scale)."""
    assert est.shape == gt.shape and est.ndim == 2
    if align == "none":
        d = est - gt
        return float(np.sqrt((d * d).sum(axis=1).mean()))
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E0, G0 = est - mu_e, gt - mu_g
    U, S, Vt = np.linalg.svd(G0.T @ E0)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = (S * np.diag(D)).sum() / max((E0 ** 2).sum(), 1e-12) \
        if align == "sim3" else 1.0
    resid = G0 - s * E0 @ R.T
    return float(np.sqrt((resid ** 2).sum(axis=1).mean()))


def score_rows(rows: List, gt_positions: np.ndarray,
               align: str = "se3") -> Optional[float]:
    """ATE of trajectory rows vs per-frame GT positions (indexed by
    incoming frame id, the sodso/dslam row convention)."""
    ids, xyz = trajectory_xyz(rows)
    ok = ids < len(gt_positions)
    if ok.sum() < 3:
        return None
    return ate_rmse(xyz[ok], gt_positions[ids[ok]], align=align)


def timing_table(timers: StageTimers) -> Dict[str, Tuple[float, int]]:
    """{stage: (avg_ms, count)} with the reference's stage names."""
    return {n: (timers.average_ms(n), timers.count(n))
            for n in STAGE_NAMES if timers.count(n) > 0}
