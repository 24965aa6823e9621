"""Batch evaluation over KITTI odometry sequences (the counterpart of the
JAX package's ``scripts/eval_kitti.py``; BASELINE.json config 5).

One command produces the BASELINE.md comparison table: per sequence the
ATE of sodso.txt (odometry) and dslam.txt (loop-closed) against KITTI
ground truth, FPS and the per-stage ms table (reference main.cpp:181-201),
for the odometry-only and loop-closure configurations (BASELINE configs
1/3). With ``--ref-out`` (a directory of the C++ reference's outputs,
<ref-out>/<seq>/{sodso.txt,dslam.txt}) the reference's ATE is computed
with the same scorer and the percent delta is reported against the 5%
target. Writes ``<out>/results.json``, ``<out>/results.md`` and each
run's trajectories under ``<out>/<seq>_<config>/``. ``--device`` defaults
to ``cuda``; without a card the run stops unless ``--device cpu`` is
given.

Usage:
    python -m direct_stereo_slam_tpu_torch.eval_kitti --kitti /data/kitti_odometry \\
        --seqs 00 01 02 --config loop --out ./eval_out \\
        [--ref-out /data/reference_outputs] [--max-frames N]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kitti", required=True, help="KITTI odometry root "
                    "(sequences/<seq>/image_{0,1} + poses/<seq>.txt)")
    ap.add_argument("--seqs", nargs="+", default=[f"{i:02d}" for i in range(11)])
    ap.add_argument("--config", default="loop", choices=["odometry", "loop", "both"],
                    help="odometry = lidar_range=-1 (BASELINE config 1); "
                    "loop = full SLAM (config 3)")
    ap.add_argument("--preset", type=int, default=0)
    ap.add_argument("--mode", type=int, default=1)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--ref-out", default=None,
                    help="directory of reference outputs per sequence")
    ap.add_argument("--out", default="./eval_kitti_out")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; without a card the run "
                         "stops unless --device cpu is given)")
    args = ap.parse_args(argv)

    from .config import make_config
    from .io.dataset import KittiOdometryDataset
    from .runtime.eval import kitti_gt_positions, run_sequence, score_rows, timing_table
    from .runtime.node import write_trajectory
    from .utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"eval_kitti: {err}") from None
    configs = ["odometry", "loop"] if args.config == "both" else [args.config]
    os.makedirs(args.out, exist_ok=True)
    results = []

    for seq in args.seqs:
        ds = KittiOdometryDataset(args.kitti, seq)
        c = ds.calib
        K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1]])
        t10 = ds.t_cam1_cam0()
        gt = kitti_gt_positions(args.kitti, seq)

        for config in configs:
            lidar_range = -1.0 if config == "odometry" else 40.0
            cfg = make_config(int(2 * c["cx"] + 1), int(2 * c["cy"] + 1),
                              preset=args.preset, mode=args.mode, scale_opt_thres=15.0,
                              lidar_range=lidar_range, scan_context_thres=0.33)
            print(f"== seq {seq} [{config}] ({len(ds)} frames) ==", flush=True)
            node, handler, wall = run_sequence(ds, cfg, K, t10, levels=args.levels,
                                               progress=True, max_frames=args.max_frames,
                                               device=device)

            sodso = handler.odometry_rows()
            dslam = handler.optimized_rows()
            seq_out = os.path.join(args.out, f"{seq}_{config}")
            os.makedirs(seq_out, exist_ok=True)
            write_trajectory(os.path.join(seq_out, "sodso.txt"), sodso)
            write_trajectory(os.path.join(seq_out, "dslam.txt"), dslam)

            frames = args.max_frames or len(ds)
            row = {
                "seq": seq, "config": config,
                "frames": frames,
                "fps": round(frames / wall, 2),
                "kfs": len(sodso),
                "loops": handler.direct_loop_count + handler.icp_loop_count,
                "loop_funnel": dict(handler.stats),
                "removal_stats": dict(node.frontend.removal_stats),
                "stages_ms": {k: round(v[0], 3) for k, v in timing_table(node.timers).items()},
            }
            if gt is not None:
                row["ate_sodso"] = score_rows(sodso, gt)
                row["ate_dslam"] = score_rows(dslam, gt)
            if args.ref_out:
                for name in ("sodso", "dslam"):
                    p = os.path.join(args.ref_out, seq, f"{name}.txt")
                    if os.path.exists(p) and gt is not None:
                        with open(p) as f:
                            ref_rows = [tuple(map(float, l.split())) for l in f if l.strip()]
                        ref_ate = score_rows(ref_rows, gt)
                        row[f"ref_ate_{name}"] = ref_ate
                        ours = row.get(f"ate_{name}")
                        if ref_ate and ours:
                            row[f"delta_{name}_pct"] = round(100.0 * (ours - ref_ate) / ref_ate, 2)
            results.append(row)
            print(json.dumps(row), flush=True)

    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=2)

    # markdown table (the BASELINE.md comparison artifact)
    lines = ["| seq | config | frames | fps | KFs | loops | ATE sodso | "
             "ATE dslam | ref sodso | ref dslam | Δ% |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in results:
        fmt = lambda k: (f"{r[k]:.3f}" if r.get(k) is not None else "—")
        delta = r.get("delta_dslam_pct", r.get("delta_sodso_pct"))
        lines.append(
            f"| {r['seq']} | {r['config']} | {r['frames']} | {r['fps']} | "
            f"{r['kfs']} | {r['loops']} | {fmt('ate_sodso')} | "
            f"{fmt('ate_dslam')} | {fmt('ref_ate_sodso')} | "
            f"{fmt('ref_ate_dslam')} | "
            f"{delta if delta is not None else '—'} |")
    table = "\n".join(lines)
    with open(os.path.join(args.out, "results.md"), "w") as f:
        f.write(table + "\n")
    print(table)

    # 5%-target verdict when reference outputs were provided
    deltas = [r[k] for r in results for k in ("delta_sodso_pct", "delta_dslam_pct")
              if r.get(k) is not None]
    if deltas:
        worst = max(deltas)
        print(f"worst ATE delta vs reference: {worst:+.2f}% "
              f"({'WITHIN' if worst <= 5.0 else 'OUTSIDE'} the 5% target)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
