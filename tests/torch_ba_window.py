"""Small windowed-BA states built with the port alone (no JAX), for the
card tests of K9-K11 (``test_torch_cuda_ba.py``): frames of
``SyntheticStereoDataset`` at 96x48, poses after the first perturbed,
points hosted in every frame at their true idepths x (1 + 2% noise),
energy thresholds set from a linearization, as
``test_torch_select_immature_ba.py::_ba_window`` builds them with the
JAX package."""

import numpy as np
import torch

from direct_stereo_slam_tpu_torch.config import PATTERN_OFFSETS, make_config
from direct_stereo_slam_tpu_torch.geometry import lie
from direct_stereo_slam_tpu_torch.io.synthetic import SyntheticStereoDataset
from direct_stereo_slam_tpu_torch.models import ba
from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid

W, H = 96, 48


def ba_window(n_slots=4, n_points=256, n_frames=3, per=48, perturb=2e-3, seed=0,
              outside=False, device="cpu"):
    """(state, cfg): ``n_frames`` keyframes in the first slots of
    ``n_slots``, ``per`` points hosted by each in a pool of ``n_points``;
    ``outside``: frame 0's first point sits 3 pixels from the right edge,
    so its pattern projects out of the image."""
    ds = SyntheticStereoDataset(n_frames=n_frames, width=W, height=H, speed=0.25,
                                yaw_rate=0.01)
    frames = [ds.frame(i) for i in range(n_frames)]
    cfg = make_config(W, H, preset=0, mode=1)
    K = ds.K
    calib = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)
    st = ba.empty_state(n_slots, n_points, H, W, calib)
    rng = np.random.RandomState(seed)
    for i, f in enumerate(frames):
        T = np.linalg.inv(f["pose_w_c0"]).astype(np.float32)
        if i > 0:
            xi = rng.randn(6) * perturb
            xi[3:] *= 0.3
            T = lie.se3_exp_np(xi).astype(np.float32) @ T
        img = build_pyramid(torch.tensor(f["img0"]), 1).data[0]
        st = ba.add_frame(st, i, i, T, np.zeros(2), 1.0, img)
    P = n_points // n_slots
    for h, f in enumerate(frames):
        us = rng.randint(4, W - 5, per).astype(np.float32)
        vs = rng.randint(4, H - 5, per).astype(np.float32)
        if outside and h == 0:
            us[0] = W - 3.0
        idepth = (1.0 / f["depth0"][vs.astype(int), us.astype(int)]).astype(np.float32)
        idepth *= 1.0 + 0.02 * rng.randn(per).astype(np.float32)
        img = f["img0"]
        color = np.stack([img[np.clip((vs + dv).astype(int), 0, H - 1),
                              np.clip((us + du).astype(int), 0, W - 1)]
                          for du, dv in PATTERN_OFFSETS], -1).astype(np.float32)
        st = ba.add_points(st, torch.arange(h * P, h * P + per), h, torch.tensor(us),
                           torch.tensor(vs), torch.tensor(idepth), torch.tensor(color),
                           torch.ones(per, 8), torch.ones(per, dtype=torch.bool))
    for i in range(1, n_frames):
        st = ba.set_new_frame_energy_th_from_lin(st, ba.linearize_plain(st, cfg), i, cfg)
    return ba.BAState(*[x.to(device) for x in st]), cfg


def with_nan_pose(st, slot=1):
    """The window with a NaN in one frame's pose (what DSO's force-accept
    steps produce when they diverge)."""
    d = st.delta.clone()
    d[slot, 0] = float("nan")
    return st._replace(delta=d)
