"""Command-line entry point of the PyTorch port: the counterpart of
``scripts/run_slam.py`` (the reference's ``slam_node``, src/main.cpp).

Examples:
    # synthetic run, loop closure on (no dataset needed)
    python -m direct_stereo_slam_tpu_torch.run_slam --synthetic \
        --trajectory loop --frames 70 --loop-margin 4 --out /tmp/slam_out

    # KITTI odometry layout (<root>/sequences/<seq>/, calib.txt, times.txt)
    python -m direct_stereo_slam_tpu_torch.run_slam --kitti /data/kitti --seq 00

Runs ``SLAMNode`` with a ``LoopHandler`` (threaded as
``cfg.runtime.multi_threading`` says), writes sodso.txt (odometry) and
dslam.txt (loop-closed) in the ``incoming_id x y z`` format, prints the
per-stage timing table and ``loop_count``, and, where ground truth exists
(synthetic runs, ``<root>/poses/<seq>.txt``), the ATE of both
trajectories. ``--device`` defaults to ``cuda``; on a host without a card
the run stops with a message unless ``--device cpu`` is given.
Not ported yet (they raise ``NotImplementedError``): rosbag replay, ROS
topics, undistorted image folders (``--dir0``/``--dir1``), the trajectory
plot, the live viewer, debug dumps, step mode and pipelined tracking.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--trajectory", default="forward", choices=["forward", "loop"])
    ap.add_argument("--width", type=int, default=320, help="synthetic image width")
    ap.add_argument("--height", type=int, default=96, help="synthetic image height")
    ap.add_argument("--kitti", help="KITTI odometry root")
    ap.add_argument("--seq", default="00")
    ap.add_argument("--dir0")
    ap.add_argument("--dir1")
    ap.add_argument("--bag", help="rosbag v2.0 file (not ported yet)")
    ap.add_argument("--ros-master", help="live ROS1 topics (not ported yet)")
    ap.add_argument("--preset", type=int, default=0)
    ap.add_argument("--mode", type=int, default=1)
    ap.add_argument("--scale-opt-thres", type=float, default=15.0)
    ap.add_argument("--lidar-range", type=float, default=40.0)
    ap.add_argument("--scan-context-thres", type=float, default=0.33)
    ap.add_argument("--loop-margin", type=int, default=100,
                    help="KFs excluded from retrieval (reference default 100; "
                         "lower it for short sequences)")
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--pipelined", action="store_true",
                    help="pipelined tracking (not ported yet)")
    ap.add_argument("--plot", action="store_true",
                    help="write trajectory.png (not ported yet)")
    ap.add_argument("--live", action="store_true", help="live viewer (not ported yet)")
    ap.add_argument("--debug-dir", default=None, help="debug dumps (not ported yet)")
    ap.add_argument("--step", action="store_true", help="step mode (not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; without a card the run "
                         "stops unless --device cpu is given)")
    ap.add_argument("--out", default="./slam_out")
    return ap


def _refuse_unported(args) -> None:
    unported = [("--bag", args.bag), ("--ros-master", args.ros_master),
                ("--dir0/--dir1 (undistortion)", args.dir0 or args.dir1),
                ("--plot", args.plot), ("--live", args.live),
                ("--debug-dir", args.debug_dir), ("--step", args.step),
                ("--pipelined", args.pipelined)]
    asked = [name for name, v in unported if v]
    if asked:
        raise NotImplementedError(f"not ported yet: {', '.join(asked)}")
    if not (args.synthetic or args.kitti):
        raise SystemExit("give --synthetic or --kitti")


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    _refuse_unported(args)

    from .config import make_config
    from .geometry.camera import make_pyramid_intrinsics, num_usable_levels
    from .loop.handler import LoopHandler
    from .runtime.eval import score_rows
    from .runtime.node import SLAMNode, write_trajectory
    from .utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"run_slam: {err}") from None
    os.makedirs(args.out, exist_ok=True)

    gt = None
    if args.synthetic:
        from .io.synthetic import SyntheticStereoDataset
        ds = SyntheticStereoDataset(n_frames=args.frames, width=args.width,
                                    height=args.height, trajectory=args.trajectory,
                                    device=device)
        K, w, h = ds.K, args.width, args.height
        t10 = ds.t_cam1_cam0
        gt = ds.poses[:, :3, 3]
    else:
        from .io.dataset import KittiOdometryDataset
        from .runtime.eval import kitti_gt_positions
        ds = KittiOdometryDataset(args.kitti, args.seq)
        c = ds.calib
        h, w = ds.frame(0)["img0"].shape
        K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1]])
        t10 = ds.t_cam1_cam0()
        gt = kitti_gt_positions(args.kitti, args.seq)

    # floor at 3: the pixel selector scores on three pyramid scales
    levels = min(args.levels, max(3, num_usable_levels(w, h)))
    cfg = make_config(w, h, preset=args.preset, mode=args.mode,
                      scale_opt_thres=args.scale_opt_thres,
                      lidar_range=args.lidar_range,
                      scan_context_thres=args.scan_context_thres)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=levels),
                      loop=dataclasses.replace(cfg.loop, loop_margin=args.loop_margin))
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], w, h, levels)

    handler = LoopHandler(cfg, intr, device=device)
    node = SLAMNode(cfg, intr, intr, t10, loop_handler=handler, device=device)
    handler.timers = node.timers
    n = len(ds)
    for i in range(n):
        f = ds.frame(i)
        node.process(f["img0"], f["img1"], float(f["timestamp"]),
                     exposure=float(f.get("exposure", 1.0)))
        if i % 10 == 0:
            print(f"[{i}/{n}] kfs={node.frontend.num_kfs} "
                  f"loops={handler.direct_loop_count}+{handler.icp_loop_count}",
                  flush=True)
    node.finish()
    handler.close()

    write_trajectory(os.path.join(args.out, "sodso.txt"), handler.odometry_rows())
    write_trajectory(os.path.join(args.out, "dslam.txt"), handler.optimized_rows())

    print("\n************** Statistics (ms) ***************")
    print(node.timing_report())
    print(f"loop_count: {handler.direct_loop_count} (direct) + "
          f"{handler.icp_loop_count} (icp)")
    if gt is not None:
        for name, rows in (("sodso", handler.odometry_rows()),
                           ("dslam", handler.optimized_rows())):
            ate = score_rows(rows, gt)
            print(f"ATE {name}: {'n/a' if ate is None else f'{ate:.4f} m'}")
    print(f"outputs in {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
