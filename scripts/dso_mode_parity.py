"""DSO mode (monocular bootstrap, no stereo scale) of both packages on the
same inputs, on the CPU: the JAX package (the reference) and its PyTorch
port, each a fresh SLAMNode over chip_smoke.py's mono sequence (40 poses:
12 sideways frames, then forward with a slight lateral drift) rendered at
616x184 (half KITTI size), preset 0, mode 1, scale_opt.accept_thres -1,
mono_initializer on, zeros for the right image.

Inputs, the same numpy images for both packages: the float render, and
for each of the dither seeds the render with a +-0.5 gray-level dither
(seed 100 * d + frame), once as floats and once cut to uint8 as a camera
gives them (chip_smoke.py's ``quantised``; handed over as float32 values,
as both packages' readers convert a frame).

Per run it reports whether the first window passed its RMSE gates (a
front end that fails one, ``init_failed``, is reset by the node), the
frame that made keyframe 0, keyframes, resets, the first keyframe BAs'
RMSEs (frame, RMSE: what the gates compare) and the Sim(3)-aligned
translation ATE of the tracked frames (the bootstrap hand-off frame left
out, as chip_smoke.py's mono phase). One JSON line per run; with both
packages, one per input and offset saying where their camera positions
part; with several offsets, one per input and package giving the spread
of the bootstrap's hand-off pose over the offsets (the camera pose at
the frame that made keyframe 0 in the first offset's run, in every
offset's run: the largest distance between two of its positions, m, and
the largest angle between two of its rotations, degrees); then a
summary. The port's runs on the CPU depend on torch's thread count
(``torch.get_num_threads()``, printed: it orders the f32 sums): compare
runs at one ``OMP_NUM_THREADS``.

    JAX_PLATFORMS=cpu python scripts/dso_mode_parity.py [--dithers 6] [--frames 40]
        [--only "uint8 dither 2,uint8 dither 5"] [--offsets 0,1e-3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

W, H = 616, 184


def poses(n: int) -> np.ndarray:
    out, T = [], np.eye(4, dtype=np.float32)
    for i in range(n):
        out.append(T.copy())
        T = T.copy()
        T[0, 3] += 0.12 if i < 12 else 0.04
        T[2, 3] += 0.03 if i < 12 else 0.1
    return np.stack(out)


def render(n: int):
    """The left images [n, H, W] (float32), the ground truth and K."""
    import torch

    from direct_stereo_slam_tpu_torch.io.synthetic import SyntheticStereoDataset

    ds = SyntheticStereoDataset(n_frames=n, width=W, height=H, speed=0.0,
                                device=torch.device("cpu"))
    ds.poses = poses(n)
    imgs = np.stack([np.asarray(ds.frame(i)["img0"], np.float32) for i in range(n)])
    return imgs, ds.poses, np.asarray(ds.K, np.float64), np.asarray(ds.t_cam1_cam0)


def inputs(imgs, dithers: int):
    yield "float", imgs
    for d in range(dithers):
        noise = np.stack([np.random.RandomState(100 * d + i).uniform(-0.5, 0.5, imgs[i].shape)
                          for i in range(len(imgs))])
        dithered = imgs + noise
        yield f"float dither {d}", dithered.astype(np.float32)
        # the uint8 cut, as float32 values: what the port's own conversion
        # of a uint8 frame gives, and what the JAX package's readers hand it
        yield f"uint8 dither {d}", np.clip(dithered, 0, 255).astype(np.uint8).astype(np.float32)


def make_node(pkg: str, K, t_stereo):
    """A DSO-mode SLAMNode of the package ``pkg`` ("jax" or "torch")."""
    import dataclasses

    if pkg == "jax":
        from direct_stereo_slam_tpu.config import make_config
        from direct_stereo_slam_tpu.geometry.camera import make_pyramid_intrinsics
        from direct_stereo_slam_tpu.runtime.node import SLAMNode
        kw = {}
    else:
        from direct_stereo_slam_tpu_torch.config import make_config
        from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
        from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode
        kw = dict(device="cpu")
    cfg = make_config(W, H, preset=0, mode=1)
    cfg = cfg.replace(scale_opt=dataclasses.replace(cfg.scale_opt, accept_thres=-1.0),
                      runtime=dataclasses.replace(cfg.runtime, mono_initializer=True))
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H,
                                   cfg.tracker.pyr_levels)
    return SLAMNode(cfg, intr, intr, t_stereo, **kw)


def run(pkg: str, left, gt, K, t_stereo) -> dict:
    import importlib

    import torch

    from direct_stereo_slam_tpu_torch.runtime.eval import ate_rmse

    node = make_node(pkg, K, t_stereo)
    zeros = np.zeros(left[0].shape, np.float32)
    shells, resets, snap, rmses = [], [], None, []
    # each keyframe BA's RMSE (what the first window's gates compare), read
    # on the host after the call: the arithmetic is unchanged
    ba = importlib.import_module(("direct_stereo_slam_tpu" if pkg == "jax"
                                  else "direct_stereo_slam_tpu_torch") + ".models.ba")
    optimize_keyframe = ba.optimize_keyframe

    def recorded(*a, **k):
        out = optimize_keyframe(*a, **k)
        rmses.append([i, float(np.asarray(out[1]))])
        return out

    ba.optimize_keyframe = recorded
    t0 = time.perf_counter()
    for i, img in enumerate(left):
        fe = node.frontend
        shells.append(node.process(img, zeros, 0.1 * i))
        if node.frontend is not fe:
            resets.append((i, "lost" if fe.is_lost else "init failed"))
        if snap is None and node.frontend.initialized:
            snap = i
    idx = [i for i, s in enumerate(shells) if s.tracking_ref_kf >= 0 or s.is_kf]
    ate = None
    if len(idx) >= 3:
        est = np.stack([np.asarray(shells[i].T_wc)[:3, 3] for i in idx])[1:].astype(np.float64)
        ate = ate_rmse(est, gt[idx][1:, :3, 3].astype(np.float64), align="sim3")
    ba.optimize_keyframe = optimize_keyframe
    failed = [i for i, why in resets if why == "init failed"]
    return dict(package=pkg, gate_passed=not failed and snap is not None,
                init_failed_at=failed, resets=resets, snap=snap,
                keyframes=len(node.frontend.kf_shells), ate_sim3_m=ate,
                ba_rmse_first=rmses[:6], seconds=time.perf_counter() - t0,
                torch_threads=torch.get_num_threads(),
                t_wc=[np.asarray(sh.T_wc, np.float64)[:3, 3] for sh in shells],
                R_wc=[np.asarray(sh.T_wc, np.float64)[:3, :3] for sh in shells])


def parted(a: dict, b: dict) -> dict:
    """Where two packages' runs on one input part: per frame the distance
    between their camera positions (m), and the first frame past 1e-4 m
    and past 1e-2 m (both runs' frames up to the first reset of either)."""
    n = min([len(a["t_wc"])] + [i for i, _ in a["resets"] + b["resets"]])
    d = [float(np.linalg.norm(a["t_wc"][i] - b["t_wc"][i])) for i in range(n)]
    first = lambda th: next((i for i, x in enumerate(d) if x > th), None)
    return dict(pose_gap_m=[float(f"{x:.3g}") for x in d], first_past_1e4=first(1e-4),
                first_past_1e2=first(1e-2))


def handoff_spread(runs: list) -> dict:
    """The spread of the bootstrap's hand-off pose over one package's runs
    of one input at several offsets: the pose at the first run's hand-off
    frame (``snap``) in every run (None where no run handed off)."""
    f = runs[0]["snap"]
    if f is None or any(len(r["t_wc"]) <= f for r in runs):
        return dict(handoff_frame=f, handoff_frames=[r["snap"] for r in runs],
                    spread_m=None, spread_deg=None)
    ts = [r["t_wc"][f] for r in runs]
    Rs = [r["R_wc"][f] for r in runs]
    dist = max(float(np.linalg.norm(a - b)) for a in ts for b in ts)
    ang = max(float(np.degrees(np.arccos(np.clip((np.trace(a.T @ b) - 1) / 2, -1, 1))))
              for a in Rs for b in Rs)
    return dict(handoff_frame=f, handoff_frames=[r["snap"] for r in runs], spread_m=dist,
                spread_deg=ang)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dithers", type=int, default=6)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--only", default="",
                    help="comma-separated input tags to run (default: all)")
    ap.add_argument("--offsets", default="0",
                    help="comma-separated gray-level offsets added to every input image "
                         "(e.g. 0,1e-3,2e-3: how far the gate's outcome moves with the "
                         "input's last bits)")
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")

    imgs, gt, K, t_stereo = render(args.frames)
    results, spreads = [], []
    only = [t for t in args.only.split(",") if t]
    for tag, left in inputs(imgs, args.dithers):
        if only and tag not in only:
            continue
        by_pkg = {}
        for off in (float(o) for o in args.offsets.split(",")):
            pair = []
            for pkg in args.packages.split(","):
                r = dict(input=tag, offset=off,
                         **run(pkg, (left + np.float32(off)).astype(np.float32), gt, K,
                               t_stereo))
                pair.append(r)
                by_pkg.setdefault(pkg, []).append(r)
                print(json.dumps({k: v for k, v in r.items() if k not in ("t_wc", "R_wc")}),
                      flush=True)
                results.append(r)
            if len(pair) == 2:
                print(json.dumps(dict(input=tag, offset=off, **parted(*pair))), flush=True)
        for pkg, runs in by_pkg.items():
            if len(runs) > 1:
                sp = dict(input=tag, package=pkg, **handoff_spread(runs))
                spreads.append(sp)
                print("handoff " + json.dumps(sp), flush=True)
    summary = {}
    for pkg in args.packages.split(","):
        for kind in ("float", "float dither", "uint8 dither"):
            rs = [r for r in results if r["package"] == pkg
                  and (r["input"] == kind if kind == "float" else r["input"].startswith(kind))]
            if rs:
                summary[f"{pkg} {kind}"] = dict(
                    passed=sum(r["gate_passed"] for r in rs), runs=len(rs),
                    ate_sim3_m=[r["ate_sim3_m"] for r in rs])
        sp = [x["spread_m"] for x in spreads if x["package"] == pkg and x["spread_m"] is not None]
        if sp:
            summary[f"{pkg} handoff spread"] = dict(inputs=len(sp), median_m=float(np.median(sp)),
                                                    max_m=max(sp))
    print("summary " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
