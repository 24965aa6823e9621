"""Synthetic stereo sequence generator with exact ground truth (port of
io/synthetic.py).

Scene construction is numpy-seeded exactly as in the reference, so both
renderers build the same scene; ``render`` is the same per-pixel
plane/box ray cast written in torch, and runs on whichever device the
dataset was given.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry import lie


class SyntheticScene(NamedTuple):
    """Axis-aligned planes (n . x = c) plus axis-aligned boxes. Camera
    convention: x right, y down, z forward (world = first camera frame)."""

    normals: torch.Tensor      # [P, 3]
    offsets: torch.Tensor      # [P]
    tex_phase: torch.Tensor    # [P, 2]
    box_centers: torch.Tensor  # [B, 3]
    box_half: torch.Tensor     # [B, 3]
    box_phase: torch.Tensor    # [B, 2]
    tex_freq: Optional[float] = None


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def default_scene(ground_y: float = 1.5, wall_x: float = 8.0,
                  front_z: float = 60.0, back_z: float = -20.0,
                  ceil_y: float = -6.0, n_boxes: int = 0, box_seed: int = 0,
                  box_area: float = 20.0) -> SyntheticScene:
    normals = [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
               [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, -1.0, 0.0]]
    offsets = [ground_y, wall_x, wall_x, front_z, -back_z, -ceil_y]
    tex_phase = [[0.0, 0.0], [1.7, 0.4], [3.1, 2.2], [0.9, 4.0], [2.5, 1.1],
                 [4.2, 3.3]]
    if n_boxes > 0:
        rng = np.random.RandomState(box_seed)
        centers = np.stack([
            rng.uniform(-box_area, box_area, n_boxes),
            rng.uniform(ground_y - 3.0, ground_y - 0.5, n_boxes),
            rng.uniform(-box_area * 0.5, box_area * 1.5, n_boxes),
        ], -1).astype(np.float32)
        half = rng.uniform(0.4, 2.5, (n_boxes, 3)).astype(np.float32)
        phase = rng.uniform(0, 6.28, (n_boxes, 2)).astype(np.float32)
    else:
        centers = np.zeros((1, 3), np.float32) + 1e6   # far away, never hit
        half = np.full((1, 3), 1e-3, np.float32)
        phase = np.zeros((1, 2), np.float32)
    return SyntheticScene(_f32(normals), _f32(offsets), _f32(tex_phase),
                          _f32(centers), _f32(half), _f32(phase))


def _loop_scene() -> SyntheticScene:
    """Wide room + parallax boxes off the default loop ring."""
    rng = np.random.RandomState(7)
    centers = []
    while len(centers) < 14:
        c = rng.uniform(-22, 22, 3)
        c[1] = rng.uniform(-1.5, 0.5)
        c[2] = rng.uniform(-14, 30)
        if np.hypot(c[0], c[2] - 8.0) < 4.0 or np.hypot(c[0], c[2] - 8.0) > 13.0:
            centers.append(c)
    scene = default_scene(wall_x=25.0, front_z=45.0, back_z=-25.0)
    return scene._replace(
        box_centers=_f32(np.stack(centers)),
        box_half=_f32(rng.uniform(0.5, 2.0, (14, 3))),
        box_phase=_f32(rng.uniform(0, 6.28, (14, 2))),
    )


def _texture(p: torch.Tensor, phase: torch.Tensor, freq=None) -> torch.Tensor:
    """World position [..., 3] + per-plane phase [..., 2] -> intensity."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    if freq is not None:
        x, y, z = x * freq, y * freq, z * freq
    a, b = phase[..., 0], phase[..., 1]
    val = (
        0.45 * torch.sin(0.45 * x + 0.65 * z + a)
        + 0.30 * torch.cos(0.85 * z - 0.4 * y + b)
        + 0.15 * torch.sin(1.55 * x - 1.15 * y + 0.35 * z + a + b)
        + 0.10 * torch.cos(3.05 * x + 2.65 * z - 0.55 * y + 2.0 * a)
    )
    return 128.0 + 115.0 * val


def render(scene: SyntheticScene, T_wc: torch.Tensor, K: torch.Tensor,
           width: int, height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (image [H, W] float32, depth [H, W] float32 camera-z depth),
    on the device of ``T_wc``."""
    dev = T_wc.device
    R = T_wc[:3, :3]
    o = T_wc[:3, 3]
    us, vs = torch.meshgrid(
        torch.arange(width, dtype=torch.float32, device=dev),
        torch.arange(height, dtype=torch.float32, device=dev), indexing="xy")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    d_cam = torch.stack([(us - cx) / fx, (vs - cy) / fy, torch.ones_like(us)], dim=-1)
    d_world = d_cam @ R.T

    n = scene.normals
    c = scene.offsets
    denom = d_world @ n.T                                 # [H, W, P]
    numer = (c - o @ n.T)[None, None, :]
    inf = torch.tensor(float("inf"), device=dev)
    t = torch.where(torch.abs(denom) > 1e-8, numer / denom, inf)
    t = torch.where(t > 0.1, t, inf)
    t_hit, plane_idx = torch.min(t, dim=-1)

    inv_d = 1.0 / torch.where(torch.abs(d_world) < 1e-9,
                              torch.full_like(d_world, 1e-9), d_world)
    lo = scene.box_centers - scene.box_half
    hi = scene.box_centers + scene.box_half
    t_lo = (lo[None, None] - o[None, None, None]) * inv_d[:, :, None, :]
    t_hi = (hi[None, None] - o[None, None, None]) * inv_d[:, :, None, :]
    t_near = torch.amax(torch.minimum(t_lo, t_hi), dim=-1)   # [H, W, B]
    t_far = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
    box_hit = (t_near <= t_far) & (t_near > 0.1)
    t_box = torch.where(box_hit, t_near, inf)
    t_box_min, box_idx = torch.min(t_box, dim=-1)

    use_box = t_box_min < t_hit
    t_final = torch.where(use_box, t_box_min, t_hit)
    p_world = o[None, None, :] + d_world * t_final[..., None]
    phase = torch.where(use_box[..., None], scene.box_phase[box_idx],
                        scene.tex_phase[plane_idx])
    img = torch.clamp(_texture(p_world, phase, scene.tex_freq), 0.0, 255.0)
    return img, t_final


def kitti_like_intrinsics(width: int = 320, height: int = 96, f: float = 0.58):
    """Small KITTI-ish camera for tests; f is focal relative to width."""
    fx = f * width
    fy = fx
    cx = width / 2 - 0.5
    cy = height / 2 - 0.5
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], dtype=np.float32)


def forward_trajectory(n_frames: int, speed: float = 0.3, yaw_rate: float = 0.0):
    """Constant-velocity trajectory: camera-to-world poses [N, 4, 4]."""
    step = lie.se3_exp(torch.tensor([0, 0, speed, 0, yaw_rate, 0],
                                    dtype=torch.float32)).numpy()
    poses = []
    T = np.eye(4, dtype=np.float32)
    for _ in range(n_frames):
        poses.append(T.copy())
        T = T @ step
    return np.stack(poses)


def loop_trajectory(n_frames: int, radius: float = 12.0, laps: float = 1.0,
                    ease_in: int = 0):
    """Circular trajectory in the x-z plane (see the reference)."""
    if ease_in > 0:
        w = np.minimum(1.0, (np.arange(n_frames) + 1) / ease_in)
        cum = np.concatenate([[0.0], np.cumsum(w)[:-1]])
        angles = laps * 2.0 * np.pi * cum / cum[-1] if cum[-1] > 0 else cum
    else:
        angles = laps * 2.0 * np.pi * np.arange(n_frames) / n_frames
    poses = []
    for ang in angles:
        cy_, sy_ = np.cos(ang), np.sin(ang)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]], dtype=np.float32)
        T[:3, 3] = [radius * np.sin(ang), 0.0, radius * (1.0 - np.cos(ang))]
        poses.append(T)
    return np.stack(poses)


class SyntheticStereoDataset:
    """Iterable stereo dataset: frames ((img0, img1), timestamp, gt pose).

    ``tfm_cam1_cam0`` follows the reference convention: pose of cam0 in
    the cam1 frame, KITTI-like baseline 0.54 m. Frames render on
    ``device`` and come back as numpy arrays, like a dataset reader."""

    def __init__(self, n_frames: int = 60, width: int = 320, height: int = 96,
                 baseline: float = 0.54, trajectory: str = "forward",
                 speed: float = 0.3, fps: float = 10.0,
                 scene: Optional[SyntheticScene] = None,
                 yaw_rate: float = 0.0, device="cpu"):
        self.K = kitti_like_intrinsics(width, height)
        self.width, self.height = width, height
        self.device = torch.device(device)
        if scene is not None:
            self.scene = scene
        elif trajectory == "loop":
            self.scene = _loop_scene()
        else:
            self.scene = default_scene()
        self.fps = fps
        if trajectory == "forward":
            self.poses = forward_trajectory(n_frames, speed, yaw_rate)
        elif trajectory == "loop":
            self.poses = loop_trajectory(n_frames, radius=8.0,
                                         laps=n_frames * 5.5 / 360.0, ease_in=8)
        else:
            raise ValueError(trajectory)
        self.t_cam1_cam0 = np.eye(4, dtype=np.float32)
        self.t_cam1_cam0[0, 3] = -baseline
        self.t_cam1_cam0[2, 3] = 1e-9  # reference numerical-stability quirk

    def __len__(self):
        return len(self.poses)

    def frame(self, i: int):
        dev = self.device
        scene = SyntheticScene(*[t.to(dev) if isinstance(t, torch.Tensor) else t
                                 for t in self.scene])
        T_w_c0 = torch.as_tensor(np.asarray(self.poses[i]), device=dev)
        # cam1-to-world = cam0-to-world @ (cam1-to-cam0), in f32 like the
        # reference's device matmul
        T_w_c1 = T_w_c0 @ torch.as_tensor(
            np.linalg.inv(self.t_cam1_cam0).astype(np.float32), device=dev)
        K = torch.as_tensor(self.K, device=dev)
        img0, depth0 = render(scene, T_w_c0, K, self.width, self.height)
        img1, _ = render(scene, T_w_c1, K, self.width, self.height)
        return {
            "img0": img0.cpu().numpy(),
            "img1": img1.cpu().numpy(),
            "depth0": depth0.cpu().numpy(),
            "timestamp": i / self.fps,
            "pose_w_c0": self.poses[i],
            "incoming_id": i,
        }

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)
