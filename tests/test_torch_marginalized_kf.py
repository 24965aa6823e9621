"""The stream of marginalized keyframes, the loop handler's input: the JAX
SLAMNode and the port's get the same 24 rendered frames (96x48, 3
levels, window of 4 keyframes), and each hands its MarginalizedKF records
to a recording handler; three keyframes leave the window. The records must agree:
the same kf_id, incoming_id and order; T_wc translation within 1e-2 m;
point counts within 2%; colours of shared points within 1e-3; dso_error
and scale_error within 1e-3 relative (NaN, the sequence-restart marker,
only where the reference has NaN); a pyramid where the reference has
one."""

import math

import numpy as np
import pytest

from direct_stereo_slam_tpu.config import make_config
from direct_stereo_slam_tpu.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
from direct_stereo_slam_tpu.runtime.node import SLAMNode as NodeJ
from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode as NodeT
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W, H, LVLS = 96, 48, 3
N_FRAMES = 24


class Recorder:
    """Stands in for a loop handler: keeps every published record."""

    def __init__(self):
        self.records = []

    def publish_keyframe(self, mkf):
        self.records.append(mkf)

    def join(self):
        pass

    def odometry_rows(self):
        return [(m.incoming_id, *m.T_wc[:3, 3]) for m in self.records]


def _run(node_cls, frames, intr, t_stereo):
    cfg = make_config(W, H)
    cfg = cfg.replace(
        tracker=cfg.tracker.__class__(pyr_levels=LVLS, max_iterations=(10, 20, 20)),
        ba=cfg.ba.__class__(max_frames=4, min_frames=3, max_points_per_frame=64,
                            max_immature_per_frame=128, desired_point_density=150.0,
                            desired_immature_density=100.0))
    rec = Recorder()
    node = node_cls(cfg, intr, intr, t_stereo, loop_handler=rec)
    for i, f in enumerate(frames):
        node.process(f["img0"], f["img1"], timestamp=0.1 * i)
    rows = node.finish()
    assert len(rows) == len(rec.records)
    return rec.records


@pytest.fixture(scope="module")
def streams():
    ds = SyntheticStereoDataset(n_frames=N_FRAMES, width=W, height=H, speed=0.2)
    frames = [ds.frame(i) for i in range(len(ds))]
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LVLS)
    return (_run(NodeJ, frames, intr, ds.t_cam1_cam0),
            _run(NodeT, frames, intr, ds.t_cam1_cam0))


def _close_or_both_nan(a, b, rel=1e-3):
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return abs(a - b) <= rel * max(abs(a), 1e-12)


def test_same_records_in_the_same_order(streams):
    ref, port = streams
    assert len(ref) >= 3, "too few keyframes left the window"
    assert [(m.kf_id, m.incoming_id) for m in port] == \
        [(m.kf_id, m.incoming_id) for m in ref]


def test_poses_errors_and_pyramids_agree(streams):
    ref, port = streams
    for r, p in zip(ref, port):
        assert np.abs(np.asarray(p.T_wc)[:3, 3] - np.asarray(r.T_wc)[:3, 3]).max() <= 1e-2
        assert _close_or_both_nan(p.dso_error, r.dso_error), (r.kf_id, r.dso_error, p.dso_error)
        assert _close_or_both_nan(p.scale_error, r.scale_error), (r.kf_id, r.scale_error,
                                                                  p.scale_error)
        assert (p.pyr is not None) == (r.pyr is not None)
        if r.pyr is not None:
            assert [tuple(x.shape) for x in p.pyr] == [tuple(np.shape(x)) for x in r.pyr]
        assert p.exposure == r.exposure


def test_points_and_colours_agree(streams):
    ref, port = streams
    for r, p in zip(ref, port):
        n_r, n_p = len(r.pts_cam), len(p.pts_cam)
        assert abs(n_p - n_r) <= 0.02 * max(n_r, 1), (r.kf_id, n_r, n_p)
        assert p.pts_colors.shape[1] == r.pts_colors.shape[1]
        if not n_r or not n_p:
            continue
        # shared points: the nearest reference point within 1e-3 of depth
        d = np.linalg.norm(p.pts_cam[:, None, :] - r.pts_cam[None, :, :], axis=-1)
        j = np.argmin(d, axis=1)
        shared = d[np.arange(n_p), j] <= 1e-3 * np.abs(r.pts_cam[j, 2])
        # all but 2% of the points, or one: a far point's depth is weakly
        # held and moves with the float summation order (a point at 82 m
        # moves 0.27% between 1 and 8 intra-op threads at 96x48)
        m = min(n_r, n_p)
        assert shared.sum() >= m - max(1, 0.02 * m), (r.kf_id, int(shared.sum()))
        np.testing.assert_allclose(p.pts_colors[shared], r.pts_colors[j[shared]],
                                   atol=1e-3, rtol=0)
