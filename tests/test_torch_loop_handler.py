"""The port's LoopHandler against the JAX package's on one keyframe stream
(``test_loop_handler.make_loop_stream``: 39 keyframes around 1.5 laps at
256x80, 4 levels, drifted odometry), both synchronous. The detection
funnel, the loop counts and the database-to-frame map must be identical,
every direct try must pass and fail the same gates, and the optimized
trajectory must agree within 1e-3 m. The threaded port handler must give
what the synchronous one gives. The MarginalizedKF records cross over
through ``utils.convert``; both handlers run on the CPU."""

import numpy as np
import pytest

from direct_stereo_slam_tpu.loop.handler import LoopHandler as HandlerJ
from direct_stereo_slam_tpu_torch.loop.handler import LoopHandler as HandlerT
from direct_stereo_slam_tpu_torch.utils.convert import to_torch
from test_loop_handler import make_loop_stream
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _feed(handler, stream):
    for mkf in stream:
        handler.publish_keyframe(mkf)
    handler.close()
    return handler


@pytest.fixture(scope="module")
def handlers():
    cfg, intr, stream, gt, est = make_loop_stream()
    ref = _feed(HandlerJ(cfg, intr, threaded=False), stream)
    port_stream = [to_torch(m) for m in stream]
    port = _feed(HandlerT(cfg, intr, threaded=False), port_stream)
    return cfg, intr, port_stream, ref, port


def test_funnel_and_loops_identical(handlers):
    _, _, _, ref, port = handlers
    assert port.stats == ref.stats
    assert (port.direct_loop_count, port.icp_loop_count) == \
        (ref.direct_loop_count, ref.icp_loop_count)
    assert port.direct_loop_count + port.icp_loop_count >= 1
    assert port.db_to_frame == ref.db_to_frame
    assert port.min_sc_diff == pytest.approx(ref.min_sc_diff, rel=1e-9)
    assert [len(f.edges) for f in port.frames] == [len(f.edges) for f in ref.frames]


def test_try_log_gates_identical(handlers):
    """Per direct try: seeds passing, ok_res, ok_inlier, ok_aff and the
    frame pair; the best seed's error within 1e-3 relative where it passed."""
    _, _, _, ref, port = handlers
    assert len(port.try_log) == len(ref.try_log) > 0
    for r, p in zip(ref.try_log, port.try_log):
        assert p[2:6] == r[2:6] and p[8:] == r[8:], (r, p)
        if r[3]:
            assert p[0] == pytest.approx(r[0], rel=1e-3)


def test_optimized_trajectory_agrees(handlers):
    _, _, _, ref, port = handlers
    odo_r, odo_p = np.asarray(ref.odometry_rows()), np.asarray(port.odometry_rows())
    np.testing.assert_array_equal(odo_p, odo_r)
    opt_r, opt_p = np.asarray(ref.optimized_rows()), np.asarray(port.optimized_rows())
    assert np.array_equal(opt_p[:, 0], opt_r[:, 0])
    assert np.abs(opt_p[:, 1:] - opt_r[:, 1:]).max() <= 1e-3
    for lf in port.frames:
        assert lf.T_wc.dtype == np.float64


def test_threaded_equals_sync(handlers):
    cfg, intr, port_stream, _, sync = handlers
    thr = _feed(HandlerT(cfg, intr, threaded=True), port_stream)
    assert thr.stats == sync.stats
    assert (thr.direct_loop_count, thr.icp_loop_count) == \
        (sync.direct_loop_count, sync.icp_loop_count)
    assert thr.db_to_frame == sync.db_to_frame
    assert [t[2:] for t in thr.try_log] == [t[2:] for t in sync.try_log]
    np.testing.assert_allclose(np.stack([lf.T_wc for lf in thr.frames]),
                               np.stack([lf.T_wc for lf in sync.frames]), atol=1e-5)


def test_threaded_resolves_from_config(handlers):
    """threaded=None follows cfg.runtime.multi_threading, as in the reference."""
    import dataclasses

    cfg, intr, _, _, _ = handlers
    for flag in (True, False):
        c = cfg.replace(runtime=dataclasses.replace(cfg.runtime, multi_threading=flag))
        h = HandlerT(c, intr)
        assert h.threaded is flag
        h.close()
