"""Scan Context place-recognition descriptor.

Equivalent of the reference's ``ScanContext::generate`` + ``align_points_PCA``
(loop_detection/ScanContext.cpp:19-142): PCA-align the scan (rotation/
translation invariance + the PCA pose used as the loop pose prior), build
the 60-sector x 20-ring polar max-height signature, the per-ring occupancy
ringkey, and L2-normalize the signature per sector.

The port's copy of the JAX package's ``loop/scancontext.py``, pinned to it by
``tests/test_torch_host_copies.py``."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class ScanContextResult(NamedTuple):
    ringkey: np.ndarray        # [num_rings] occupancy / num_sectors
    signature: np.ndarray      # [num_sectors * num_rings] dense, 0 = empty
    sig_mask: np.ndarray       # bool, occupied bins
    tfm_pca_rig: np.ndarray    # [4, 4] rig -> PCA frame


def align_points_pca(pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (aligned points [N, 3], tfm_pca_rig [4, 4]).

    After PCA (ascending eigenvalues, matching Eigen SelfAdjointEigenSolver):
    axis 0 = smallest variance ("up"), axes 1/2 span the ground plane
    (ScanContext.cpp:19-66: x: up, y: left, z: back)."""
    mean = pts.mean(axis=0)
    centered = pts - mean
    cov = centered.T @ centered
    _, vecs = np.linalg.eigh(cov)      # ascending, like Eigen
    # canonical sign disambiguation (improvement over the reference, whose
    # eigenvector signs are input-order dependent and make ~50% of genuine
    # revisits un-matchable): orient each axis so the projection skewness is
    # positive; resolve near-zero skewness by the max-|projection| sign.
    for k in range(3):
        proj = centered @ vecs[:, k]
        s = np.sum(proj**3)
        if abs(s) < 1e-9 * (np.abs(proj).max() ** 3 + 1e-12):
            s = proj[np.argmax(np.abs(proj))]
        if s < 0:
            vecs[:, k] = -vecs[:, k]
    # per-axis sign disambiguation can leave a reflection (det = -1); a
    # reflected tfm_pca_rig makes the relative seed inv(A) @ B a non-SE(3)
    # transform that Kabsch ICP can never escape. Restore handedness by
    # flipping the middle axis (its skewness is the least stable of the
    # three on ground-plane-dominant scans).
    if np.linalg.det(vecs) < 0:
        vecs[:, 1] = -vecs[:, 1]
    aligned = centered @ vecs          # project on v0, v1, v2
    tfm = np.eye(4)
    tfm[:3, :3] = vecs.T
    tfm[:3, 3] = -vecs.T @ mean
    return aligned, tfm


def generate(pts_spherical: np.ndarray, lidar_range: float,
             num_sectors: int = 60, num_rings: int = 20,
             binary: bool = True) -> ScanContextResult:
    """binary=True replaces the max-height cell value with occupancy (0/1)
    before the per-sector normalization. Measured on sparse photometric
    point clouds (39-KF synthetic loop, 300-2000 pts/scan): max-height
    signatures give genuine-revisit distances at median 0.344 (above the
    0.33 gate -> zero recall) vs spurious 0.446; occupancy gives 0.182 vs
    0.302 — recall restored at the reference threshold, with spurious
    candidates still rejected downstream by photometric verification.
    Max-height (the reference formulation, ScanContext.cpp:96-119, tuned
    for dense LiDAR-like clouds) remains available with binary=False."""
    aligned, tfm = align_points_pca(pts_spherical)

    yp = aligned[:, 1]
    zp = aligned[:, 2]
    rho = np.sqrt(yp * yp + zp * zp)
    theta = np.arctan2(zp, yp)
    theta = np.mod(theta, 2.0 * np.pi)

    si = np.minimum((theta / (2.0 * np.pi) * num_sectors).astype(np.int64),
                    num_sectors - 1)
    ri = (rho / lidar_range * num_rings).astype(np.int64)
    ok = ri < num_rings        # PCA translation can push points out

    max_height = np.full(num_sectors * num_rings, -lidar_range - 1.0)
    flat = si * num_rings + ri
    np.maximum.at(max_height, flat[ok], aligned[ok, 0])

    occupied = max_height >= -lidar_range
    ringkey = np.zeros(num_rings)
    idx = np.arange(num_sectors * num_rings)
    np.add.at(ringkey, idx[occupied] % num_rings, 1.0)
    ringkey /= num_sectors

    sig = np.where(occupied, 1.0 if binary else max_height, 0.0)
    # per-sector L2 normalization (ScanContext.cpp:122-141)
    norms = np.sqrt(
        (sig.reshape(num_sectors, num_rings) ** 2).sum(axis=1, keepdims=True))
    norms = np.where(norms > 0, norms, 1.0)
    sig = (sig.reshape(num_sectors, num_rings) / norms).reshape(-1)

    return ScanContextResult(ringkey, sig, occupied, tfm)


def signature_difference(sig_a: np.ndarray, sig_b: np.ndarray,
                         num_sectors: int = 60) -> float:
    """(1 - <a, b> / num_sectors) / 2 (search_place.h:66-79); the sparse
    intersection product equals the dense dot because empty bins are 0."""
    prod = float(np.dot(sig_a, sig_b))
    return (1.0 - prod / num_sectors) / 2.0
