"""The whole slice: the JAX SLAMNode and the port's SLAMNode get the same
12 rendered frames (96x48, 3 levels, the smoke configuration of
tests/test_smoke_e2e.py). They must pick the same keyframes, agree per
frame on translation within 1e-2 m, and both track with ATE < 0.12 m.
A 16-frame run of the same sequence adds a fifth keyframe, which reaches
frame marginalization and the stereo scale optimizer."""

import dataclasses

import numpy as np
import pytest

from direct_stereo_slam_tpu.config import make_config
from direct_stereo_slam_tpu.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
from direct_stereo_slam_tpu.runtime.node import SLAMNode as NodeJ
from direct_stereo_slam_tpu_torch.models.frontend import FrontEnd as FrontEndT
from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode as NodeT
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax as port_cfg

pytestmark = pytest.mark.smoke

W, H, LVLS = 96, 48, 3


def _config():
    cfg = make_config(W, H)
    return cfg.replace(
        tracker=cfg.tracker.__class__(pyr_levels=LVLS, max_iterations=(10, 20, 20)),
        ba=cfg.ba.__class__(max_frames=4, min_frames=3, max_points_per_frame=64,
                            max_immature_per_frame=128, desired_point_density=150.0,
                            desired_immature_density=100.0),
    )


def _node(node_cls, cfg, intr, t_stereo, **kw):
    """The JAX node, or the port's on the CPU with its own config."""
    if node_cls is NodeT:
        return NodeT(port_cfg(cfg), intr, intr, t_stereo, device="cpu", **kw)
    return node_cls(cfg, intr, intr, t_stereo, **kw)


def _run(node_cls, frames, cfg, intr, t_stereo):
    node = _node(node_cls, cfg, intr, t_stereo)
    shells = [node.process(f["img0"], f["img1"], timestamp=float(i) * 0.1)
              for i, f in enumerate(frames)]
    fe = node.frontend
    assert fe.initialized and not fe.is_lost and not fe.init_failed
    node.finish()
    return shells, node


@pytest.mark.parametrize("n_frames", [12, 16])
def test_port_tracks_like_the_reference(n_frames):
    ds = SyntheticStereoDataset(n_frames=n_frames, width=W, height=H, speed=0.2)
    frames = [ds.frame(i) for i in range(len(ds))]
    cfg = _config()
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LVLS)
    sj, node_j = _run(NodeJ, frames, cfg, intr, ds.t_cam1_cam0)
    st, node_t = _run(NodeT, frames, cfg, intr, ds.t_cam1_cam0)

    kf_j = [i for i, s in enumerate(sj) if s.is_kf]
    kf_t = [i for i, s in enumerate(st) if s.is_kf]
    assert kf_t == kf_j and len(kf_t) >= 3
    tj = np.stack([np.asarray(s.T_wc)[:3, 3] for s in sj])
    tt = np.stack([np.asarray(s.T_wc)[:3, 3] for s in st])
    assert np.abs(tt - tj).max() <= 1e-2, np.abs(tt - tj).max(axis=1)
    for traj in (tj, tt):
        errs = np.linalg.norm(traj - ds.poses[:, :3, 3], axis=1)
        assert float(np.sqrt(np.mean(errs ** 2))) < 0.12, errs
    assert [s.tracking_ref_kf for s in st] == [s.tracking_ref_kf for s in sj]
    assert "track" in node_t.timing_report()
    fe_j, fe_t = node_j.frontend, node_t.frontend
    assert vars(fe_t.scale_state) == vars(fe_j.scale_state)
    assert fe_t.pot == fe_j.pot and fe_t.num_kfs == fe_j.num_kfs
    if n_frames == 16:
        assert fe_t.scale_state.trapped                   # scale accepted
        assert fe_t.removal_stats["host_leaving"] > 0     # a frame marginalized
        assert fe_j.removal_stats["host_leaving"] > 0


def test_unported_modes_raise():
    """What is still not ported raises: the viewer, the debug dumps and
    step mode. Every front-end mode constructs."""
    ds = SyntheticStereoDataset(n_frames=1, width=W, height=H)
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LVLS)
    cfg = _config()
    for rt in (dataclasses.replace(cfg.runtime, pipelined_tracking=True),
               dataclasses.replace(cfg.runtime, mono_initializer=True)):
        FrontEndT(port_cfg(cfg.replace(runtime=rt)), intr, intr, ds.t_cam1_cam0,
                  device="cpu")
    for unported in (dict(live_view_path="x.html"), dict(debug_dump_dir="dumps"),
                     dict(step_by_step=True)):
        with pytest.raises(NotImplementedError):
            _node(NodeT, cfg.replace(runtime=dataclasses.replace(cfg.runtime, **unported)),
                  intr, ds.t_cam1_cam0)


def test_sequence_gap_reinitializes_like_the_reference():
    """A >10 s timestamp gap marks the front end lost; the next frame
    starts a new one that keeps the global keyframe count and the pose."""
    ds = SyntheticStereoDataset(n_frames=8, width=W, height=H, speed=0.2)
    frames = [ds.frame(i) for i in range(len(ds))]
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LVLS)
    stamps = [0.1 * i for i in range(4)] + [20.0 + 0.1 * i for i in range(4)]
    counts = {}
    for name, cls in (("jax", NodeJ), ("torch", NodeT)):
        node = _node(cls, _config(), intr, ds.t_cam1_cam0)
        first = None
        for f, ts in zip(frames, stamps):
            node.process(f["img0"], f["img1"], timestamp=ts)
            first = first or node.frontend
        assert node.frontend is not first and node.frontend.initialized
        counts[name] = (first.num_kfs, node.frontend.prev_kf_count,
                        node.frontend.num_kfs, node.frontend.last_dso_error)
    assert counts["torch"][:3] == counts["jax"][:3]
    assert np.isnan(counts["torch"][3]) and np.isnan(counts["jax"][3])
