"""Render a long synthetic stereo sequence into the KITTI odometry disk
layout (the counterpart of the JAX package's ``scripts/gen_longseq.py``),
so the real-format path (PNG decode -> calib parse -> stereo sync -> full
pipeline) runs at realistic length and resolution without a KITTI
download.

Writes ``<out>/sequences/<seq>/{image_0,image_1}/NNNNNN.png``,
``times.txt``, ``calib.txt`` (P0/P1 rows; the reader derives fx/fy/cx/cy
and baseline = -P1[0,3]/fx) and ``<out>/poses/<seq>.txt`` (devkit 3x4
row-major ground truth): what ``eval_kitti`` reads.

The world is the box-rich loop room (``io/synthetic._loop_scene``: 14
boxes from RandomState(7)) on a circle of radius 8 m at 4.5 deg/frame, as
in the JAX package. Frames render on ``--device`` (default ``cuda``;
without a card the run stops unless ``--device cpu`` is given); PNGs are
written through cv2, or PIL where cv2 is missing.

Usage:
    python -m direct_stereo_slam_tpu_torch.gen_longseq --out /tmp/kitti_synth \\
        [--frames 320] [--width 1232] [--height 368] [--seq 00] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _png_writer():
    try:
        import cv2
        return lambda path, arr: cv2.imwrite(path, arr)
    except ImportError:
        from PIL import Image
        return lambda path, arr: Image.fromarray(arr, mode="L").save(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seq", default="00")
    ap.add_argument("--frames", type=int, default=320)
    ap.add_argument("--width", type=int, default=1232)
    ap.add_argument("--height", type=int, default=368)
    ap.add_argument("--radius", type=float, default=8.0)
    ap.add_argument("--deg-per-frame", type=float, default=4.5)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args(argv)

    from .io.synthetic import SyntheticStereoDataset, _loop_scene, loop_trajectory
    from .utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"gen_longseq: {err}") from None
    W, H, N = args.width, args.height, args.frames
    laps = args.deg_per_frame * N / 360.0
    ds = SyntheticStereoDataset(n_frames=N, width=W, height=H, scene=_loop_scene(),
                                device=device)
    ds.poses = loop_trajectory(N, radius=args.radius, laps=laps, ease_in=8)

    seq_dir = os.path.join(args.out, "sequences", args.seq)
    os.makedirs(os.path.join(seq_dir, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "image_1"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "poses"), exist_ok=True)

    K = ds.K
    baseline = float(-ds.t_cam1_cam0[0, 3])
    P0 = np.zeros((3, 4))
    P0[:3, :3] = K
    P1 = P0.copy()
    P1[0, 3] = -K[0, 0] * baseline
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        for name, P in (("P0", P0), ("P1", P1)):
            f.write(name + ": " + " ".join(f"{v:.12e}" for v in P.ravel()) + "\n")

    write_png = _png_writer()
    times, pose_rows = [], []
    for i in range(N):
        fr = ds.frame(i)
        for cam, img in (("image_0", fr["img0"]), ("image_1", fr["img1"])):
            arr = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
            write_png(os.path.join(seq_dir, cam, f"{i:06d}.png"), arr)
        times.append(i / args.fps)
        pose_rows.append(np.asarray(ds.poses[i])[:3, :4].ravel())
        if (i + 1) % 20 == 0:
            print(f"rendered {i + 1}/{N}", flush=True)

    np.savetxt(os.path.join(seq_dir, "times.txt"), np.asarray(times), fmt="%.6f")
    np.savetxt(os.path.join(args.out, "poses", f"{args.seq}.txt"),
               np.stack(pose_rows), fmt="%.9e")
    print("wrote", seq_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
