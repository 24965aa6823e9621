"""Batch evaluation of S sequences as one program (the counterpart of the
JAX package's ``scripts/run_batch.py``; BASELINE.json config 5, the
headless batch evaluation over KITTI 00-10).

SLAM state is sequential per sequence, so the scale-out is data
parallelism over sequences (``parallel/mesh.py``): each step tracks the
next frame of every sequence against a template of its previous frame and
optimizes its stereo scale; on a card one K2-LM and one K3-LM launch
cover the sequences of a device. The S sequences are rendered with
different motion profiles over the same world; the first step is left
out of the timing.

Examples:
    # one card, 8 sequences batched on it
    python -m direct_stereo_slam_tpu_torch.run_batch --sequences 8 --frames 20

    # the host CPU (the plain loops), a mesh of 2 CPU entries
    python -m direct_stereo_slam_tpu_torch.run_batch --device cpu --devices 2 \\
        --sequences 4 --frames 6 --width 64 --height 32 --levels 2
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def run(sequences: int, frames: int, width: int, height: int, levels: int,
        devices: int = 0, device="cuda", passes: int = 1) -> dict:
    """Render ``sequences`` sequences of ``frames`` frames, build every
    step's inputs, then step through them ``passes`` times (more passes
    give a longer timed window over the same frames); returns the mesh
    size, the timed seconds, aggregate and per-sequence FPS, each pass's
    aggregate FPS, the tracking errors (m, rad) of every step and sequence
    of the first pass, each step's seconds and the first pass's poses
    [frames - 1, S, 4, 4]."""
    import torch

    from .config import make_config
    from .geometry import lie
    from .geometry.camera import make_pyramid_intrinsics
    from .io.synthetic import SyntheticStereoDataset
    from .models.depth_template import TrackerTemplate, build_template, default_budgets
    from .parallel.mesh import make_batched_step, make_mesh, shard_batched_step
    from .utils.device import resolve_device

    dev = resolve_device(device)
    W, H, L, B = width, height, levels, sequences
    n_dev = devices or (torch.cuda.device_count() if dev.type == "cuda" else 1)
    if B % n_dev != 0:
        raise SystemExit(f"--sequences {B} must divide the mesh size {n_dev}")

    cfg = make_config(W, H)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=L))

    # B sequences with different motion profiles over the same world
    print(f"rendering {B} sequences x {frames} frames ...", flush=True)
    seqs = [SyntheticStereoDataset(n_frames=frames, width=W, height=H,
                                   speed=0.25 + 0.05 * (i % 4), yaw_rate=0.004 * (i % 3),
                                   device=dev)
            for i in range(B)]
    K = seqs[0].K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, L)
    budgets = default_budgets(W, H, L)
    rng = np.random.RandomState(0)
    n_pts = 512
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def template_for(f):
        us = rng.uniform(3, W - 4, n_pts).astype(np.float32)
        vs = rng.uniform(3, H - 4, n_pts).astype(np.float32)
        depth = np.asarray(f["depth0"])[vs.astype(int), us.astype(int)]
        return build_template(t(us), t(vs), t((1.0 / depth).astype(np.float32)),
                              torch.ones(n_pts, dtype=torch.float32, device=dev),
                              t(f["img0"]), L, budgets)

    mesh = make_mesh(n_dev, device=dev)
    step = shard_batched_step(make_batched_step(intr, cfg, L), mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    T_init = torch.eye(4, dtype=torch.float32, device=dev).expand(B, 4, 4).contiguous()
    # each step's inputs: a template of every sequence's previous frame and
    # the next pair of every sequence
    inputs, current = [], [ds.frame(0) for ds in seqs]
    for i in range(frames - 1):
        tmpls = [template_for(f) for f in current]
        tmpl = TrackerTemplate(*[tuple(torch.stack([tm[k][l] for tm in tmpls])
                                       for l in range(L)) for k in range(5)])
        current = [ds.frame(i + 1) for ds in seqs]
        inputs.append((t(np.stack([f["img0"] for f in current])),
                       t(np.stack([f["img1"] for f in current])), tmpl))
    errs_t, errs_r, step_s, T_all = [], [], [], []
    for p in range(passes):
        for i, (img0, img1, tmpl) in enumerate(inputs):
            sync()
            t0 = time.perf_counter()
            out = step(img0, img1, tmpl, T_init)
            sync()
            step_s.append(time.perf_counter() - t0)
            if p > 0:
                continue
            T_est = out.T.cpu().numpy()
            T_all.append(T_est)
            for b, ds in enumerate(seqs):
                T_gt = np.linalg.inv(ds.poses[i + 1]) @ ds.poses[i]
                d = lie.se3_log(torch.as_tensor(np.linalg.inv(T_gt) @ T_est[b],
                                                dtype=torch.float32)).numpy()
                errs_t.append(float(np.linalg.norm(d[:3])))
                errs_r.append(float(np.linalg.norm(d[3:])))

    # the first step pays the kernels' load and first launch: untimed
    n = frames - 1
    timed = step_s[1:] if len(step_s) > 1 else step_s
    t_total = sum(timed)
    fps = len(timed) * B / max(t_total, 1e-9)
    pass_fps = [len(s) * B / max(sum(s), 1e-9)
                for s in (step_s[max(p * n, 1):(p + 1) * n] for p in range(passes)) if s]
    return dict(devices=n_dev, sequences=B, frames=frames, passes=passes, seconds=t_total,
                fps=fps, fps_per_sequence=fps / B, pass_fps=pass_fps, errs_t=errs_t,
                errs_r=errs_r, step_s=step_s, T=np.stack(T_all))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--devices", type=int, default=0,
                    help="mesh size (default: all visible cards; 1 on the CPU)")
    ap.add_argument("--passes", type=int, default=1,
                    help="step through the rendered frames this many times "
                         "(a longer timed window)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; without a card the run "
                         "stops unless --device cpu is given)")
    args = ap.parse_args(argv)
    from .utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"run_batch: {err}") from None
    r = run(args.sequences, args.frames, args.width, args.height, args.levels,
            args.devices, device, args.passes)
    print(f"devices {r['devices']}  sequences {r['sequences']}  frames {r['frames']}")
    print(f"aggregate tracking throughput: {r['fps']:.1f} frames/s "
          f"({r['fps_per_sequence']:.1f} per sequence)")
    print(f"tracking error: median |t| {np.median(r['errs_t']) * 100:.2f} cm, "
          f"median |w| {np.degrees(np.median(r['errs_r'])):.3f} deg")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
