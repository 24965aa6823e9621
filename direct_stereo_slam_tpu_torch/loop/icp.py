"""Point-to-point ICP fallback.

Equivalent of the reference's PCL ICP wrapper (pose_estimation/icp.h:44-71):
max 5 iterations, 2 m correspondence distance, accept if mean-squared
correspondence distance (PCL getFitnessScore) < 1.5. The PCL KD-tree
becomes a brute-force nearest neighbor in matmul form (|a-b|^2 = |a|^2 +
|b|^2 - 2ab, float32, chunked over the source axis so peak memory stays
at chunk x M instead of N x M — a 4k x 4k float64 difference tensor was
128 MB per iteration), and the per-iteration rigid update is a closed-form
Kabsch solve.

The port's copy of the JAX package's ``loop/icp.py``, pinned to it by
``tests/test_torch_host_copies.py``."""

from __future__ import annotations

from typing import Tuple

import numpy as np

_NN_CHUNK = 1024


def _nn_f32(src: np.ndarray, tgt: np.ndarray):
    """Chunked brute-force nearest neighbor. Returns (idx [N], d2 [N])."""
    src32 = np.ascontiguousarray(src, np.float32)
    tgt32 = np.ascontiguousarray(tgt, np.float32)
    t2 = (tgt32 * tgt32).sum(axis=1)
    idx = np.empty(len(src32), np.int64)
    d2 = np.empty(len(src32), np.float32)
    for s in range(0, len(src32), _NN_CHUNK):
        e = min(s + _NN_CHUNK, len(src32))
        c = src32[s:e]
        cross = c @ tgt32.T                       # [chunk, M] matmul
        dd = (c * c).sum(axis=1)[:, None] + t2[None, :] - 2.0 * cross
        j = np.argmin(dd, axis=1)
        idx[s:e] = j
        d2[s:e] = np.maximum(dd[np.arange(e - s), j], 0.0)
    return idx, d2


def _kabsch(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Best-fit rigid transform mapping src -> dst (equal-length [K, 3])."""
    cs = src.mean(axis=0)
    cd = dst.mean(axis=0)
    H = (src - cs).T @ (dst - cd)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = cd - R @ cs
    return T


def icp(
    pts_source: np.ndarray,        # [N, 3] (matched frame's scan)
    pts_target: np.ndarray,        # [M, 3] (current frame's scan)
    tfm_target_source: np.ndarray, # [4, 4] initial guess
    max_iterations: int = 5,
    max_corr_dist: float = 2.0,
    transformation_eps: float = 0.01,
    fitness_thres: float = 1.5,
) -> Tuple[bool, np.ndarray, float]:
    """Returns (accepted, refined tfm_target_source, fitness)."""
    if len(pts_source) < 10 or len(pts_target) < 10:
        return False, tfm_target_source, float("inf")

    T = np.asarray(tfm_target_source, np.float64).copy()
    src = pts_source @ T[:3, :3].T + T[:3, 3]

    for _ in range(max_iterations):
        nn, nnd2 = _nn_f32(src, pts_target)
        ok = nnd2 < max_corr_dist * max_corr_dist
        if ok.sum() < 10:
            break
        dT = _kabsch(src[ok], pts_target[nn[ok]])
        src = src @ dT[:3, :3].T + dT[:3, 3]
        T = dT @ T
        if np.linalg.norm(dT[:3, 3]) + np.linalg.norm(dT[:3, :3] - np.eye(3)) < transformation_eps:
            break

    # PCL getFitnessScore: mean squared distance of correspondences within
    # the (default: max) range
    _, nnd2 = _nn_f32(src, pts_target)
    fitness = float(nnd2.mean())
    return fitness < fitness_thres, T, fitness
