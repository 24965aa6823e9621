"""The port's LoopHandler against the JAX package's on one keyframe stream
(``test_loop_handler.make_loop_stream``: 39 keyframes around 1.5 laps at
256x80, 4 levels, drifted odometry), both synchronous. The detection
funnel, the loop counts and the database-to-frame map must be identical,
every direct try must pass and fail the same gates, and the optimized
trajectory must agree within 1e-3 m. The threaded port handler must give
what the synchronous one gives. The MarginalizedKF records cross over
through ``utils.convert``; both handlers run on the CPU."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

from direct_stereo_slam_tpu.loop.handler import LoopHandler as HandlerJ
from direct_stereo_slam_tpu_torch.config import make_config
from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu_torch.loop.handler import LoopHandler as HandlerT
from direct_stereo_slam_tpu_torch.utils.convert import to_torch
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax as port_cfg
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
    port = _feed(HandlerT(port_cfg(cfg), intr, threaded=False, device="cpu"), port_stream)
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
    frame pair; the best seed's error within 1e-3 relative, or 2e-4 gray
    levels, where it passed.

    The absolute term is the JAX package's own spread on the same inputs:
    a passing seed's error at level 0 (0.016-0.08 gray levels, intensities
    ~100 cancelling) moves by up to 1.9e-4 (2.4e-3 relative) between its
    jitted single-seed ``estimate`` and its jitted vmapped
    ``estimate_batch``, and by up to 1.2e-3 relative between ``jit`` and
    ``jax.disable_jit()``. Both packages take the same passes, accepts and
    counts; the iterates part at ~1e-6 from the 8x8 LU's rounding (LAPACK
    against MKL, the same pivots) on systems of condition ~2e5."""
    _, _, _, ref, port = handlers
    assert len(port.try_log) == len(ref.try_log) > 0
    for r, p in zip(ref.try_log, port.try_log):
        assert p[2:6] == r[2:6] and p[8:] == r[8:], (r, p)
        if r[3]:
            assert p[0] == pytest.approx(r[0], rel=1e-3, abs=2e-4)


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
    thr = _feed(HandlerT(port_cfg(cfg), intr, threaded=True, device="cpu"), port_stream)
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
        h = HandlerT(port_cfg(c), intr, device="cpu")
        assert h.threaded is flag
        h.close()


def test_threaded_failure_is_raised():
    """The threaded handler does not swallow a failure: processing raises on
    the second keyframe, the later ones are drained without being
    processed, and close() (and join()) raise it, chained, without
    hanging."""
    intr = make_pyramid_intrinsics(100.0, 100.0, 63.5, 39.5, 128, 80, 3)
    handler = HandlerT(make_config(128, 80), intr, threaded=True, device="cpu")
    seen = []

    def process(mkf):
        seen.append(mkf.kf_id)
        if mkf.kf_id == 1:
            raise ValueError("keyframe 1")

    handler._process = process
    for i in range(4):
        handler.publish_keyframe(SimpleNamespace(kf_id=i))
    raised = []

    def close():
        try:
            handler.close()
        except RuntimeError as e:
            raised.append(e)

    t = threading.Thread(target=close, daemon=True)
    t.start()
    t.join(timeout=30.0)
    assert not t.is_alive(), "close() hung"
    assert len(raised) == 1 and isinstance(raised[0].__cause__, ValueError)
    assert seen == [0, 1]
    with pytest.raises(RuntimeError):
        handler.join()
