"""Command-line entry point of the PyTorch port: the counterpart of
``scripts/run_slam.py`` (the reference's ``slam_node``, src/main.cpp).

Examples:
    # synthetic run, loop closure on (no dataset needed)
    python -m direct_stereo_slam_tpu_torch.run_slam --synthetic \
        --trajectory loop --frames 70 --loop-margin 4 --out /tmp/slam_out

    # KITTI odometry layout (<root>/sequences/<seq>/, calib.txt, times.txt)
    python -m direct_stereo_slam_tpu_torch.run_slam --kitti /data/kitti --seq 00

    # raw (distorted) image folders with DSO calibration files, pipelined
    python -m direct_stereo_slam_tpu_torch.run_slam --dir0 cam0/ --dir1 cam1/ \
        --calib0 camera.txt --gamma0 pcalib.txt --vignette0 vignette.png \
        --t-stereo T_stereo.yaml --pipelined

    # a rosbag (kitti2bag), with the live viewer and the debug images
    python -m direct_stereo_slam_tpu_torch.run_slam --bag seq.bag \
        --calib0 camera.txt --t-stereo T_stereo.yaml --live --debug-dir dbg/

    # live ROS1 topics through a master (until --ros-idle s without a pair)
    python -m direct_stereo_slam_tpu_torch.run_slam --ros-master http://host:11311 \
        --calib0 camera.txt --topic0 /cam0/image_raw --topic1 /cam1/image_raw

Runs ``SLAMNode`` with a ``LoopHandler`` (threaded as
``cfg.runtime.multi_threading`` says), writes sodso.txt (odometry) and
dslam.txt (loop-closed) in the ``incoming_id x y z`` format, prints the
per-stage timing table and ``loop_count``, and, where ground truth exists
(synthetic runs, ``<root>/poses/<seq>.txt``), the ATE of both
trajectories. ``--device`` defaults to ``cuda``; on a host without a card
the run stops with a message unless ``--device cpu`` is given. Image
folders (``--dir0``/``--dir1``) go through the ``Undistorter`` of their
camera files (``--calib0``/``--calib1``, ``--gamma*``, ``--vignette*``;
the vignette applies in the raw frame, before the remap), with the
stereo extrinsics of ``--t-stereo``. So do the frames of a rosbag
(``--bag``: ``--topic0``/``--topic1`` paired as the reference's bag
replay, main.cpp:320-345) and of live ROS1 topics (``--ros-master``: the
reference's message_filters path, main.cpp:347-362; ``node.process``
runs on the source's thread under a lock, until ``--ros-idle`` seconds
pass without a pair; a failure there fails the run). ``--pipelined``
turns on pipelined tracking, ``--mono`` the monocular bootstrap.
``--live`` keeps a self-refreshing ``<out>/live.html`` viewer,
``--debug-dir`` writes the debug images (keyframe idepth, window stitch,
tracking residual), ``--step`` waits for Enter after every frame, and
``--plot`` writes ``<out>/trajectory.png`` (it needs matplotlib: without
it the run stops before any work).
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
    ap.add_argument("--dir0", help="left raw image folder (with --calib0)")
    ap.add_argument("--dir1", help="right raw image folder")
    ap.add_argument("--calib0", help="DSO camera.txt of cam0")
    ap.add_argument("--calib1", help="DSO camera.txt of cam1 (default: --calib0)")
    ap.add_argument("--t-stereo", help="T_stereo.yaml (default: identity)")
    ap.add_argument("--gamma0", help="DSO pcalib.txt of cam0")
    ap.add_argument("--gamma1", help="DSO pcalib.txt of cam1 (default: --gamma0)")
    ap.add_argument("--vignette0", help="vignette image of cam0")
    ap.add_argument("--vignette1", help="vignette image of cam1 (default: --vignette0)")
    ap.add_argument("--bag", help="rosbag v2.0 file (with --calib0)")
    ap.add_argument("--ros-master", help="live mode: ROS1 master URI to subscribe to "
                    "--topic0/--topic1 over TCPROS (with --calib0)")
    ap.add_argument("--ros-idle", type=float, default=5.0,
                    help="live mode: stop after this many seconds without a pair")
    ap.add_argument("--topic0", default="/cam0/image_raw")
    ap.add_argument("--topic1", default="/cam1/image_raw")
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
                    help="pipelined tracking: frame N's track runs while "
                         "frame N-1 is consumed (default: synchronous)")
    ap.add_argument("--mono", action="store_true",
                    help="monocular bootstrap instead of the stereo initializer")
    ap.add_argument("--plot", action="store_true",
                    help="write <out>/trajectory.png (needs matplotlib)")
    ap.add_argument("--live", action="store_true",
                    help="write a self-refreshing <out>/live.html viewer")
    ap.add_argument("--debug-dir", default=None, help="write the debug images here")
    ap.add_argument("--step", action="store_true",
                    help="wait for Enter between frames")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; without a card the run "
                         "stops unless --device cpu is given)")
    ap.add_argument("--out", default="./slam_out")
    return ap


def _check_args(args) -> None:
    """Stop before any work when the input is not given or --plot cannot
    be honoured."""
    raw = args.bag or args.ros_master or (args.dir0 and args.dir1)
    if not (args.synthetic or args.kitti or raw):
        raise SystemExit("give --synthetic, --kitti, --bag, --ros-master, or "
                         "--dir0 and --dir1")
    if raw and not args.calib0:
        raise SystemExit("--bag, --ros-master and --dir0/--dir1 need --calib0")
    if args.plot:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit("run_slam: --plot needs matplotlib, which this "
                             "Python does not have") from None


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    _check_args(args)

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
    undist0 = undist1 = None
    if args.synthetic:
        from .io.synthetic import SyntheticStereoDataset
        ds = SyntheticStereoDataset(n_frames=args.frames, width=args.width,
                                    height=args.height, trajectory=args.trajectory,
                                    device=device)
        K, w, h = ds.K, args.width, args.height
        t10 = ds.t_cam1_cam0
        gt = ds.poses[:, :3, 3]
    elif args.kitti:
        from .io.dataset import KittiOdometryDataset
        from .runtime.eval import kitti_gt_positions
        ds = KittiOdometryDataset(args.kitti, args.seq)
        c = ds.calib
        h, w = ds.frame(0)["img0"].shape
        K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1]])
        t10 = ds.t_cam1_cam0()
        gt = kitti_gt_positions(args.kitti, args.seq)
    else:
        from .io.undistort import Undistorter
        from .utils.calib import (build_rectified_camera, parse_camera_file, parse_gamma,
                                  parse_t_stereo, parse_vignette)
        cam0 = build_rectified_camera(args.calib0)
        cam1 = build_rectified_camera(args.calib1 or args.calib0)
        g0 = parse_gamma(args.gamma0) if args.gamma0 else None
        g1 = parse_gamma(args.gamma1) if args.gamma1 else g0
        # the vignette applies in the raw frame, before the remap: a bag's
        # or a topic's raw size is the calibration file's
        if args.bag or args.ros_master:
            ds = None
            model0 = parse_camera_file(args.calib0)[0]
            in_w, in_h = model0.in_w, model0.in_h
        else:
            from .io.dataset import StereoDirDataset
            ds = StereoDirDataset(args.dir0, args.dir1)
            in_h, in_w = ds.frame(0)["img0"].shape
        v0 = parse_vignette(args.vignette0, in_w, in_h) if args.vignette0 else None
        v1 = parse_vignette(args.vignette1, in_w, in_h) if args.vignette1 else v0
        undist0 = Undistorter(cam0, binv=g0, vignette=v0, device=device)
        undist1 = Undistorter(cam1, binv=g1, vignette=v1, device=device)
        K, w, h = cam0.K, cam0.w, cam0.h
        t10 = parse_t_stereo(args.t_stereo) if args.t_stereo else np.eye(4)

    # floor at 3: the pixel selector scores on three pyramid scales
    levels = min(args.levels, max(3, num_usable_levels(w, h)))
    cfg = make_config(w, h, preset=args.preset, mode=args.mode,
                      scale_opt_thres=args.scale_opt_thres,
                      lidar_range=args.lidar_range,
                      scan_context_thres=args.scan_context_thres)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=levels),
                      loop=dataclasses.replace(cfg.loop, loop_margin=args.loop_margin),
                      runtime=dataclasses.replace(
                          cfg.runtime, pipelined_tracking=args.pipelined,
                          mono_initializer=args.mono,
                          live_view_path=os.path.join(args.out, "live.html") if args.live else "",
                          debug_dump_dir=args.debug_dir or "", step_by_step=args.step))
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], w, h, levels)

    handler = LoopHandler(cfg, intr, device=device)
    node = SLAMNode(cfg, intr, intr, t10, loop_handler=handler, undistorter0=undist0,
                    undistorter1=undist1, device=device)
    handler.timers = node.timers
    n = len(ds) if ds is not None else "?"
    fed = [0]

    def feed(img0, img1, timestamp, exposure=1.0):
        node.process(img0, img1, float(timestamp), exposure=float(exposure))
        if fed[0] % 10 == 0:
            print(f"[{fed[0]}/{n}] kfs={node.frontend.num_kfs} "
                  f"loops={handler.direct_loop_count}+{handler.icp_loop_count}",
                  flush=True)
        fed[0] += 1

    if args.bag:
        from .io.rosbag import replay_stereo_bag
        pairs = replay_stereo_bag(args.bag, args.topic0, args.topic1,
                                  lambda a, b: feed(a.data, b.data, a.stamp))
        print(f"{pairs} stereo pairs replayed from {args.bag}", flush=True)
    elif args.ros_master:
        pairs = _run_live(args, feed)
        print(f"{pairs} stereo pairs received from {args.ros_master}", flush=True)
    else:
        for i in range(len(ds)):
            f = ds.frame(i)
            feed(f["img0"], f["img1"], f["timestamp"], f.get("exposure", 1.0))
    node.finish()
    handler.close()

    write_trajectory(os.path.join(args.out, "sodso.txt"), handler.odometry_rows())
    write_trajectory(os.path.join(args.out, "dslam.txt"), handler.optimized_rows())
    if args.plot:
        from .viz.export import plot_trajectories
        so = np.array([r[1:] for r in handler.odometry_rows()]).reshape(-1, 3)
        dl = np.array([r[1:] for r in handler.optimized_rows()]).reshape(-1, 3)
        plot_trajectories(os.path.join(args.out, "trajectory.png"),
                          [("sodso", so), ("dslam", dl)], gt=gt)

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


def _run_live(args, feed) -> int:
    """Feed synced pairs of the two live topics to ``feed`` on the
    source's thread, under a lock, until ``--ros-idle`` seconds pass
    without a pair (or Ctrl-C, or a failure); returns the pairs fed. The
    pairs received before the end are processed; a failure raises."""
    import threading
    import time

    from .io.ros_transport import StereoTopicSource

    lock = threading.Lock()
    last = [time.monotonic(), 0]

    def on_pair(a, b):
        with lock:
            feed(a.data, b.data, a.stamp)
            last[:] = [time.monotonic(), last[1] + 1]

    src = StereoTopicSource(args.ros_master, args.topic0, args.topic1, on_pair)
    try:
        while not src.failed and (last[1] == 0 or
                                  time.monotonic() - last[0] <= args.ros_idle):
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        src.close()
    return last[1]


if __name__ == "__main__":
    raise SystemExit(main())
