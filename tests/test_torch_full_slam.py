"""Full-system test of the port: its SLAMNode + LoopHandler over the
multi-lap synthetic sequence of test_full_slam.py (the box-rich loop room,
70 frames at 256x80, 4 levels, 1.1 laps), trajectory exports included.
The counterpart of test_full_slam.py, with the same gates; it runs the
port only (PERF.md records both packages on this sequence)."""

import numpy as np
import pytest

from direct_stereo_slam_tpu_torch.config import make_config
from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu_torch.io.synthetic import (
    SyntheticStereoDataset, _loop_scene, loop_trajectory)
from direct_stereo_slam_tpu_torch.loop.handler import LoopHandler
from direct_stereo_slam_tpu_torch.runtime.eval import score_rows
from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode, write_trajectory
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W, H, LVLS = 256, 80, 4
N_FRAMES = 70


def full_slam_setup():
    """(dataset, cfg, intr) of test_full_slam.py's sequence in the port."""
    ds = SyntheticStereoDataset(n_frames=N_FRAMES, width=W, height=H, scene=_loop_scene())
    ds.poses = loop_trajectory(N_FRAMES, radius=8.0, laps=1.1, ease_in=8)
    cfg = make_config(W, H)
    cfg = cfg.replace(
        tracker=cfg.tracker.__class__(pyr_levels=LVLS),
        ba=cfg.ba.__class__(
            max_frames=5, min_frames=3,
            desired_point_density=600.0, desired_immature_density=450.0,
            max_points_per_frame=128, max_immature_per_frame=512,
        ),
        loop=cfg.loop.__class__(loop_margin=4, lidar_range=40.0,
                                scan_context_thres=0.33, icp_thres=0.25),
    )
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LVLS)
    return ds, cfg, intr


@pytest.mark.slow
def test_full_slam_synthetic_loop(tmp_path):
    ds, cfg, intr = full_slam_setup()
    handler = LoopHandler(cfg, intr, threaded=False, device="cpu")
    node = SLAMNode(cfg, intr, intr, ds.t_cam1_cam0, loop_handler=handler, device="cpu")
    for f in ds:
        node.process(f["img0"], f["img1"], f["timestamp"])
        assert not node.frontend.is_lost

    rows = node.finish()
    assert len(rows) > 5
    write_trajectory(str(tmp_path / "sodso.txt"), handler.odometry_rows())
    write_trajectory(str(tmp_path / "dslam.txt"), handler.optimized_rows())
    txt = (tmp_path / "sodso.txt").read_text().strip().splitlines()
    assert len(txt) == len(rows)
    assert len(txt[0].split()) == 4

    # the reference test's gate: the last frame within 10% of the path
    gt_last = ds.poses[len(node.frontend.all_frames) - 1]
    est_last = node.frontend.all_frames[-1].T_wc
    err = np.linalg.norm(est_last[:3, 3] - gt_last[:3, 3])
    path_len = 2 * np.pi * 8.0 * 1.1
    assert err < 0.10 * path_len, (err, path_len)
    gt = ds.poses[:, :3, 3]
    print(f"port: loops {handler.direct_loop_count}+{handler.icp_loop_count}, "
          f"funnel {handler.stats}, ATE sodso {score_rows(handler.odometry_rows(), gt)} "
          f"dslam {score_rows(handler.optimized_rows(), gt)}")
