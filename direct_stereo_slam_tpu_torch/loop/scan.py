"""Imitated-LiDAR scan generation (port of loop/scan.py).

The reference's ``generate_spherical_points``: a rolling world point cloud
contributed by marginalized keyframes, trimmed of keyframes whose
orientation differs too much from the current one, range-gated and
voxel-downsampled keeping the highest point per voxel. Host-side numpy,
as in the JAX package: the cloud is small and mutates per keyframe."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..geometry import lie


class NearbyPointCloud:
    def __init__(self, cfg):
        self.cfg = cfg
        self.pts: np.ndarray = np.zeros((0, 3), np.float64)   # world points
        self.ids: np.ndarray = np.zeros((0,), np.int64)       # owning kf id
        self.id_pose_wc: Dict[int, np.ndarray] = {}           # kf id -> T_wc

    def add_keyframe_points(self, kf_id: int, T_wc: np.ndarray, pts_world: np.ndarray):
        if len(pts_world):
            self.pts = np.concatenate([self.pts, pts_world], axis=0)
            self.ids = np.concatenate([self.ids, np.full(len(pts_world), kf_id)])
        self.id_pose_wc[kf_id] = np.asarray(T_wc, np.float64)

    def generate_scan(self, T_cw: np.ndarray) -> np.ndarray:
        """Returns the local scan [M, 3] (camera frame) and prunes the
        rolling cloud to the surviving points."""
        lp = self.cfg.loop
        rng = lp.lidar_range

        # orientation trim (generate_spherical_points.h:34-40)
        keep_ids = set()
        for kf_id, T_wc in list(self.id_pose_wc.items()):
            w = lie.so3_log_np((T_cw @ T_wc)[:3, :3])
            if np.linalg.norm(w) > lp.orientation_trim_rad:
                del self.id_pose_wc[kf_id]
            else:
                keep_ids.add(kf_id)

        if len(self.pts) == 0:
            return np.zeros((0, 3))

        id_ok = np.isin(self.ids, np.fromiter(keep_ids, np.int64, len(keep_ids)))
        p_local = (self.pts @ T_cw[:3, :3].T) + T_cw[:3, 3]
        ok = id_ok & (np.linalg.norm(p_local, axis=1) < rng)

        # voxel filter keeping the highest (most negative y = up) point
        steps = 1.0 / np.asarray(lp.voxel_res, np.float64)
        vx = np.floor((p_local[:, 0] + rng) * steps[0]).astype(np.int64)
        vy = np.floor((p_local[:, 1] + rng) * steps[1]).astype(np.int64)
        vz = np.floor((p_local[:, 2] + rng) * steps[2]).astype(np.int64)
        nx = int(np.floor(2 * rng * steps[0]) + 1)
        ny = int(np.floor(2 * rng * steps[1]) + 1)
        key = np.where(ok, vx + vy * nx + vz * nx * ny, -1)

        # one stable lexsort by (voxel asc, height desc), first of each group
        order = np.lexsort((p_local[:, 1], key))
        ks = key[order]
        first = np.ones(len(ks), bool)
        first[1:] = ks[1:] != ks[:-1]
        sel_idx = order[first & (ks >= 0)]

        # prune the cloud to the survivors and forget keyframes left with none
        self.pts = self.pts[sel_idx]
        self.ids = self.ids[sel_idx]
        live = set(np.unique(self.ids).tolist())
        for kf_id in [k for k in self.id_pose_wc if k not in live]:
            del self.id_pose_wc[kf_id]
        return p_local[sel_idx]
