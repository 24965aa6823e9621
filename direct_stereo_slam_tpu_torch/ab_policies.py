"""A/B policy harness (the counterpart of the JAX package's
``scripts/ab_policies.py``).

Where the system's control policies deliberately differ from the C++
reference, this harness measures the drift on adversarial synthetic
sequences, each policy against its reference form:

1. winner selection over the tracking try-list: staged growing batches
   (1 -> 5 -> 78, ``tracker.winner_policy="staged"``) against the
   reference's serial achievedRes-tightening walk (``"serial"``);
2. windowed-BA step acceptance: energy-gated LM (default) against the
   reference's forced acceptance (``ba.solver_force_accept_step``);
3. loop acceptance: ICP-refined and photometrically verified (default)
   against the reference's direct-from-PCA-seed, ICP-fitness-only path
   (``loop.reference_acceptance``).

Scenarios: nominal forward motion, a brightness jump (x1.7 exposure over
the middle third, which exercises the affine gates) and the fast-rotation
loop lap (~5.5 deg/frame yaw, with loop closure). Writes the table to
``--out`` (nothing else). ``--device`` defaults to ``cuda``; without a
card the run stops unless ``--device cpu`` is given.

Usage:
    python -m direct_stereo_slam_tpu_torch.ab_policies [--frames 60] [--out results.md]
    python -m direct_stereo_slam_tpu_torch.ab_policies --device cpu --frames 6 \\
        --width 96 --height 48
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

# variant -> (config section, field, value): the one switch it flips
SWITCHES = {
    "serial_winner": ("tracker", "winner_policy", "serial"),
    "force_accept": ("ba", "solver_force_accept_step", True),
    "reference_loop": ("loop", "reference_acceptance", True),
}
GRID = (
    ("nominal", ("baseline", "serial_winner", "force_accept")),
    ("brightness_jump", ("baseline", "serial_winner", "force_accept")),
    ("fast_rotation", ("baseline", "serial_winner", "force_accept", "reference_loop")),
)


def build_scenario(name: str, n_frames: int, width: int, height: int, device):
    """(dataset, per-frame exposure gains) of a scenario."""
    from .io.synthetic import SyntheticStereoDataset

    trajectory = "loop" if name == "fast_rotation" else "forward"
    ds = SyntheticStereoDataset(n_frames=n_frames, width=width, height=height,
                                trajectory=trajectory, device=device)
    gains = np.ones(n_frames)
    if name == "brightness_jump":
        gains[n_frames // 3: 2 * n_frames // 3] = 1.7
    return ds, gains


def make_cfg(scenario: str, variant: str, width: int, height: int, levels: int):
    from .config import make_config

    cfg = make_config(width, height)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=levels))
    if scenario == "fast_rotation":
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, loop_margin=4))
    if variant != "baseline":
        section, field, value = SWITCHES[variant]
        cfg = cfg.replace(**{section: dataclasses.replace(getattr(cfg, section),
                                                          **{field: value})})
    return cfg


def switches(cfg) -> dict:
    """The value of every A/B switch in ``cfg``."""
    return {v: getattr(getattr(cfg, s), f) for v, (s, f, _) in SWITCHES.items()}


def run_one(scenario: str, variant: str, n_frames: int, levels: int = 4, width: int = 320,
            height: int = 96, device="cuda") -> dict:
    from .geometry.camera import make_pyramid_intrinsics
    from .loop.handler import LoopHandler
    from .runtime.node import SLAMNode

    ds, gains = build_scenario(scenario, n_frames, width, height, device)
    cfg = make_cfg(scenario, variant, width, height, levels)
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width, height, levels)
    with_loop = scenario == "fast_rotation"
    handler = LoopHandler(cfg, intr, threaded=False, device=device) if with_loop else None
    node = SLAMNode(cfg, intr, intr, ds.t_cam1_cam0, loop_handler=handler, device=device)

    t0 = time.perf_counter()
    for i, f in enumerate(ds):
        img0, img1 = f["img0"], f["img1"]
        if gains[i] != 1.0:
            img0 = np.clip(img0 * gains[i], 0, 255).astype(np.float32)
            img1 = np.clip(img1 * gains[i], 0, 255).astype(np.float32)
        node.process(img0, img1, f["timestamp"])
        if node.frontend.is_lost:
            break
    node.finish()
    dt = time.perf_counter() - t0

    fe = node.frontend
    est = (np.stack([sh.T_wc[:3, 3] for sh in fe.all_frames]) if fe.all_frames
           else np.zeros((1, 3)))
    gt = ds.poses[:len(est), :3, 3]
    out = {
        "scenario": scenario, "variant": variant, "switches": switches(cfg),
        "frames": len(fe.all_frames), "kfs": len(fe.kf_shells), "lost": fe.is_lost,
        "ate": float(np.sqrt(((est - gt) ** 2).sum(1).mean())),
        "endpoint": float(np.linalg.norm(est[-1] - gt[len(est) - 1])), "sec": dt,
    }
    if handler is not None:
        out["loops"] = handler.direct_loop_count + handler.icp_loop_count
        odo = {r[0]: np.array(r[1:4]) for r in handler.odometry_rows()}
        opt = {r[0]: np.array(r[1:4]) for r in handler.optimized_rows()}
        kf_gt = {sh.incoming_id: ds.poses[i][:3, 3]
                 for i, sh in enumerate(fe.all_frames) if sh.is_kf}
        common = [k for k in opt if k in kf_gt]
        if common:
            out["ate_sodso"] = float(np.sqrt(np.mean(
                [np.sum((odo[k] - kf_gt[k]) ** 2) for k in common])))
            out["ate_dslam"] = float(np.sqrt(np.mean(
                [np.sum((opt[k] - kf_gt[k]) ** 2) for k in common])))
    return out


def table(rows) -> str:
    lines = ["| scenario | variant | frames | KFs | ATE (m) | endpoint (m) | "
             "lost | loops | dslam ATE |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['scenario']} | {r['variant']} | {r['frames']} | {r['kfs']} | "
            f"{r['ate']:.3f} | {r['endpoint']:.3f} | {'yes' if r['lost'] else 'no'} | "
            f"{r.get('loops', '—')} | {r.get('ate_dslam', float('nan')):.3f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--out", default="", help="write the results table here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; without a card the run "
                         "stops unless --device cpu is given)")
    args = ap.parse_args(argv)

    from .utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"ab_policies: {err}") from None
    rows = []
    for scenario, variants in GRID:
        for v in variants:
            r = run_one(scenario, v, args.frames, width=args.width, height=args.height,
                        device=device)
            rows.append(r)
            print(f"[{scenario}/{v}] frames={r['frames']} kfs={r['kfs']} "
                  f"ate={r['ate']:.3f} end={r['endpoint']:.3f} lost={r['lost']} "
                  f"loops={r.get('loops', '-')} "
                  f"dslam={r.get('ate_dslam', float('nan')):.3f} ({r['sec']:.1f} s)",
                  flush=True)
    text = table(rows)
    print("\n" + text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
