"""Pipelined tracking in the port against the JAX package: both SLAMNodes
run with ``pipelined_tracking=True`` on the same 16 rendered frames
(96x48, 3 levels, the smoke configuration of test_torch_slice_e2e.py).
Frame 8 carries a one-frame +4 degree heading glitch (as
test_pipelined_long_horizon.py does), so the constant-motion candidate
misses and the staged escalation runs; every keyframe flushes the
in-flight successor into a retrack. Tolerances: the same keyframes and
tracking references, translation within 1e-2 m per frame, equal
``pl_escalations`` / ``pl_retracks`` (at least one of each). Also: the
serial winner policy bypasses the pipeline, the port's packed transfer
round-trips a tracked batch, a sequence gap in pipelined mode drops the
in-flight frame (its placeholder shell popped) and restarts with the
same keyframe offset and a NaN restart marker in both packages, and
``runtime/eval.run_sequence`` runs the mode with the loop handler."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
from direct_stereo_slam_tpu.runtime.node import SLAMNode as NodeJ
from direct_stereo_slam_tpu_torch.models import frontend as fe_t
from direct_stereo_slam_tpu_torch.models.tracker import AffLight, TrackResult
from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode as NodeT
from test_torch_slice_e2e import LVLS, H, W, _config, _node
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N_FRAMES, GLITCH = 16, 8


def _pipelined(cfg, **tracker):
    return cfg.replace(runtime=dataclasses.replace(cfg.runtime, pipelined_tracking=True),
                       tracker=dataclasses.replace(cfg.tracker, **tracker))


def _glitched_sequence():
    ds = SyntheticStereoDataset(n_frames=N_FRAMES, width=W, height=H, speed=0.2)
    kink = np.deg2rad(4.0)
    Ry = np.eye(4)
    Ry[0, 0] = Ry[2, 2] = np.cos(kink)
    Ry[0, 2], Ry[2, 0] = np.sin(kink), -np.sin(kink)
    poses = np.asarray(ds.poses, np.float64).copy()
    poses[GLITCH] = poses[GLITCH] @ Ry
    ds.poses = poses.astype(np.float32)
    return ds, [ds.frame(i) for i in range(N_FRAMES)]


@functools.lru_cache(maxsize=None)
def _runs():
    ds, frames = _glitched_sequence()
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LVLS)
    out = {}
    for name, cls in (("jax", NodeJ), ("torch", NodeT)):
        node = _node(cls, _pipelined(_config()), intr, ds.t_cam1_cam0)
        for i, f in enumerate(frames):
            node.process(f["img0"], f["img1"], timestamp=float(i) * 0.1)
            assert not node.frontend.is_lost
        node.finish()
        out[name] = node.frontend
    return ds, out


def test_pipelined_port_tracks_like_the_reference():
    ds, fes = _runs()
    fj, ft = fes["jax"], fes["torch"]
    assert ft._pl_inflight is None and fj._pl_inflight is None
    assert len(ft.all_frames) == len(fj.all_frames) == N_FRAMES
    assert [s.is_kf for s in ft.all_frames] == [s.is_kf for s in fj.all_frames]
    assert sum(s.is_kf for s in ft.all_frames) >= 3
    assert ([s.tracking_ref_kf for s in ft.all_frames]
            == [s.tracking_ref_kf for s in fj.all_frames])
    tj = np.stack([np.asarray(s.T_wc)[:3, 3] for s in fj.all_frames])
    tt = np.stack([np.asarray(s.T_wc)[:3, 3] for s in ft.all_frames])
    assert np.abs(tt - tj).max() <= 1e-2, np.abs(tt - tj).max(axis=1)
    # the glitch leaves both packages ~0.2 m off after frame 8: the port's
    # ATE is the reference's within the per-frame tolerance
    ate = [float(np.sqrt(np.mean(np.linalg.norm(t - ds.poses[:, :3, 3], axis=1) ** 2)))
           for t in (tj, tt)]
    assert ate[1] <= ate[0] + 1e-2 and ate[0] < 0.2, ate


def test_glitch_exercises_escalation_and_retrack():
    _, fes = _runs()
    fj, ft = fes["jax"], fes["torch"]
    assert (ft.pl_escalations, ft.pl_retracks) == (fj.pl_escalations, fj.pl_retracks)
    assert ft.pl_escalations >= 1 and ft.pl_retracks >= 1
    assert ft.last_completed_shell is ft.all_frames[-1]


def test_serial_policy_bypasses_the_pipeline():
    """winner_policy='serial' ignores the flag: frame by frame the same
    shells as the synchronous serial path, nothing in flight."""
    ds, frames = _glitched_sequence()
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LVLS)
    cfg = _config()
    serial = cfg.replace(tracker=dataclasses.replace(cfg.tracker, winner_policy="serial"))
    poses = {}
    for name, c in (("sync", serial), ("pipelined", _pipelined(serial))):
        node = _node(NodeT, c, intr, ds.t_cam1_cam0)
        for i, f in enumerate(frames[:8]):
            node.process(f["img0"], f["img1"], timestamp=float(i) * 0.1)
            assert node.frontend._pl_inflight is None
            if i > 0:      # the initialization frame completes no tracked shell
                assert node.frontend.last_completed_shell is node.frontend.all_frames[-1]
        node.finish()
        poses[name] = np.stack([s.T_wc for s in node.frontend.all_frames])
        assert node.frontend.pl_escalations == node.frontend.pl_retracks == 0
    np.testing.assert_array_equal(poses["sync"], poses["pipelined"])


def test_packed_transfer_round_trips():
    """The one flat f32 copy of a dispatch (results and counts) unpacks to
    the fields the synchronous read gives."""
    g = torch.Generator().manual_seed(0)
    B, L, S = 3, 4, 5
    r = TrackResult(T=torch.randn(B, 4, 4, generator=g),
                    aff=AffLight(torch.randn(B, generator=g), torch.randn(B, generator=g)),
                    res_per_level=torch.randn(B, L, generator=g),
                    flow=torch.randn(B, 3, generator=g),
                    ok=torch.tensor([True, False, True]))
    counts = torch.tensor([0, 7, 1024, 3, 0])
    res, got_counts = fe_t._unpack_track(fe_t._pack_track(r, counts).numpy(), L, S)
    np.testing.assert_array_equal(res.T, r.T.numpy())
    np.testing.assert_array_equal(res.res_per_level, r.res_per_level.numpy())
    np.testing.assert_array_equal(res.flow, r.flow.numpy())
    np.testing.assert_array_equal(res.aff, torch.stack([r.aff.a, r.aff.b], -1).numpy())
    np.testing.assert_array_equal(res.ok, r.ok.numpy())
    np.testing.assert_array_equal(got_counts, counts.numpy())


def test_const_motion_candidate_matches_the_host_motion_model():
    """Tl @ inv(Tp) @ Tl is make_motion_tries' stage1[0] for shells tracked
    against one reference."""
    from direct_stereo_slam_tpu_torch.geometry.lie import se3_exp_np
    from direct_stereo_slam_tpu_torch.models.tracker import make_motion_tries
    from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax

    T_w_ref = se3_exp_np([0.3, -0.1, 0.2, 0.05, -0.02, 0.01])
    T_w_last = se3_exp_np([0.1, 0.0, 1.2, 0.01, 0.03, 0.0])
    T_w_prelast = se3_exp_np([0.05, 0.0, 0.9, 0.005, 0.02, 0.0])
    Tl = np.linalg.inv(T_w_last) @ T_w_ref
    Tp = np.linalg.inv(T_w_prelast) @ T_w_ref
    stage1, _ = make_motion_tries(np.eye(4), np.linalg.inv(T_w_last) @ T_w_ref,
                                  np.linalg.inv(T_w_prelast) @ T_w_last,
                                  config_from_jax(_config()))
    got = fe_t._const_motion_candidate(torch.as_tensor(Tl, dtype=torch.float32),
                                       torch.as_tensor(Tp, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), stage1[0], atol=1e-5)


def test_sequence_gap_in_pipelined_mode_like_the_reference():
    """A >10 s gap marks the front end lost with a frame in flight: the
    placeholder shell is popped, the new front end keeps the keyframe
    offset and starts with the NaN restart marker, in both packages."""
    ds = SyntheticStereoDataset(n_frames=10, width=W, height=H, speed=0.2)
    frames = [ds.frame(i) for i in range(len(ds))]
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LVLS)
    stamps = [0.1 * i for i in range(6)] + [20.0 + 0.1 * i for i in range(4)]
    got = {}
    for name, cls in (("jax", NodeJ), ("torch", NodeT)):
        node = _node(cls, _pipelined(_config()), intr, ds.t_cam1_cam0)
        first = in_flight = None
        for f, ts in zip(frames, stamps):
            if ts >= 20.0 and first is None:
                first = node.frontend
                in_flight = first._pl_inflight
            node.process(f["img0"], f["img1"], timestamp=ts)
        assert in_flight is not None, "no frame in flight at the gap"
        assert node.frontend is not first and node.frontend.initialized
        assert first._pl_inflight is None and first._pl_state is None
        assert all(s is not in_flight["shell"] for s in first.all_frames)
        node.finish()
        got[name] = (len(first.all_frames), first.num_kfs, node.frontend.prev_kf_count,
                     node.frontend.num_kfs, len(node.frontend.all_frames),
                     node.frontend.last_dso_error)
    assert got["torch"][:5] == got["jax"][:5]
    assert np.isnan(got["torch"][5]) and np.isnan(got["jax"][5])


def test_run_sequence_pipelined():
    """runtime/eval.run_sequence with the loop handler in pipelined mode:
    nothing left in flight, every frame completed, the odometry rows of
    the keyframes that left the window."""
    from direct_stereo_slam_tpu_torch.runtime.eval import run_sequence
    from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax

    ds, _ = _glitched_sequence()
    node, handler, _ = run_sequence(ds, config_from_jax(_pipelined(_config())), ds.K,
                                    ds.t_cam1_cam0, levels=LVLS, threaded_loop=False,
                                    device="cpu")
    fe = node.frontend
    assert fe._pl_inflight is None and len(fe.all_frames) == N_FRAMES
    assert fe.last_completed_shell is fe.all_frames[-1]
    assert fe.pl_retracks >= 1
    assert len(handler.odometry_rows()) >= 1
