"""Chip smoke test of the PyTorch / CUDA port (direct_stereo_slam_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass (any fault exits non-zero):

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the hand-written kernels from csrc/ (timed);
3. each kernel against its plain PyTorch version on the card, at KITTI
   shapes: K1 distance map (bit-equal), K2 pose pass at budgets 8192 and
   512 with the tracker's batches of 1, 5 and 78 poses, and K3 scale pass
   with 8 guesses, and K4 loop pose pass (metric points, N = 2048 with
   all lanes live and with padded lanes, 1 and 6 seeds, one seed that
   projects no point, on pyramid levels 0 and 3) (H and b per entry
   within 1e-4 x max|entry|, stats within rel 1e-5);
   median over 25 samples of the time per call of each (10 back-to-back
   calls per sample, CUDA events);
4. the port's SLAMNode end to end on a rendered 40-frame 1232x368
   sequence (preset 0, mode 1): initialised, never lost, >= 3 keyframes,
   translation ATE < 2% of the path length, and K1, K2 and K3 each
   launched during the timed pass. A first pass with a device
   synchronize at the end of every span gives the per-stage table; FPS
   comes from the second pass, without them;
5. loop closure: the port's SLAMNode with its threaded LoopHandler (as
   ``run_slam`` runs them) over 160 frames (2 laps at 4.5 deg/frame) of
   the loop room at 1232x368, images quantised to uint8, loop_margin 40:
   at least one verified loop, the loop-closed (dslam) ATE below the
   odometry (sodso) ATE, and K1-K4 each launched during the run.

Options: --profile DIR profiles one more end-to-end pass; --long also
runs the full 320-frame loop protocol (loop_margin 100), printed beside
the JAX package's TPU record of the same protocol, then an 80-frame loop
and a 120-frame forward sequence at the same size with the error of every
frame (reported, not gated), each of those also through the port on the
host CPU, frame by frame against the card.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. The script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

W, H, LEVELS = 1232, 368, 5
E2E_FRAMES = 40
# loop closure: scripts/gen_longseq.py's world and trajectory (the loop
# room, radius 8 m, 4.5 deg/frame), cut from its 320 frames to 2 laps and
# from loop_margin 100 to the smallest margin that still keeps the last
# ~half lap of keyframes out of retrieval
LOOP_FRAMES, LOOP_MARGIN = 160, 40
# the JAX package's record of the full protocol (EVAL_r05.json, TPU v5e)
R05 = dict(loops=50, tries=74, ate_sodso=1.765, ate_dslam=0.545)
REPEATS = 25
POSE_BATCHES = (1, 5, 78)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, repeats: int = REPEATS, inner: int = 10) -> float:
    """Time per call of fn() on the card: CUDA events around `inner`
    back-to-back calls (host enqueue overlapping device work, as in a
    loop), synchronized before each sample; median over `repeats`
    samples, warm-up excluded."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def ab_ms(torch, kernel_fn, plain_fn):
    """(kernel ms, plain ms) measured in turns plain, kernel, kernel, plain
    and averaged, so drift in the card's clocks hits both alike."""
    p1 = median_ms(torch, plain_fn)
    k1 = median_ms(torch, kernel_fn)
    k2 = median_ms(torch, kernel_fn)
    p2 = median_ms(torch, plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_err(torch, a, b) -> float:
    scale = float(torch.max(torch.abs(b)).clamp(min=1e-30))
    return float(torch.max(torch.abs(a - b))) / scale


def kernel_phase(torch, dev):
    """Each kernel vs its plain version at the main path's shapes."""
    from direct_stereo_slam_tpu_torch.geometry import lie
    from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
    from direct_stereo_slam_tpu_torch.io.synthetic import SyntheticStereoDataset
    from direct_stereo_slam_tpu_torch.ops import distance_map as dm
    from direct_stereo_slam_tpu_torch.ops import residual_hb as rh
    from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid

    rows = []
    gen = np.random.RandomState(0)

    # ---- K1: distance map on the KITTI half-res grid -------------------------
    h2, w2 = H // 2, W // 2
    for n in (2000, 8192):
        pu = torch.as_tensor(gen.uniform(-20, w2 + 20, n).astype(np.float32), device=dev)
        pv = torch.as_tensor(gen.uniform(-20, h2 + 20, n).astype(np.float32), device=dev)
        mask = torch.as_tensor(gen.rand(n) < 0.8, device=dev)
        got = dm.build_distance_map_cuda(pu, pv, mask, h2, w2)
        ref = dm.build_distance_map_plain(pu, pv, mask, h2, w2)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"K1 distance map differs from plain at n={n}: "
                 f"{int((got != ref).sum())} cells")
        err = float(torch.max(torch.abs(got - ref)))
        ms, pms = ab_ms(torch, lambda: dm.build_distance_map_cuda(pu, pv, mask, h2, w2),
                        lambda: dm.build_distance_map_plain(pu, pv, mask, h2, w2))
        print(f"K1 distance_map {h2}x{w2} n={n}: bit-equal, kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms", flush=True)
        rows.append(dict(name=f"distance_map[n={n}]", route="cuda",
                         source="direct_stereo_slam_tpu_torch/csrc/distance_map.cu",
                         replaces="direct_stereo_slam_tpu/ops/distance_map.py:59",
                         max_abs_err=err, ms=ms, plain_ms=pms))

    # ---- K2 / K3 on a rendered KITTI-size stereo pair ------------------------
    ds = SyntheticStereoDataset(n_frames=2, width=W, height=H, speed=0.4, device=dev)
    f0, f1 = ds.frame(0), ds.frame(1)
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LEVELS)
    pyr1 = build_pyramid(torch.as_tensor(f1["img0"], device=dev), LEVELS)
    pyr_r = build_pyramid(torch.as_tensor(f0["img1"], device=dev), LEVELS)
    img0 = torch.as_tensor(f0["img0"], device=dev)
    depth0 = f0["depth0"]

    def points(lvl, budget, n_live):
        """Template-like point list at a level: n_live live lanes, the
        rest padding (pid 0, mask False) like build_template's."""
        s = 1 << lvl
        wl, hl = W >> lvl, H >> lvl
        us = gen.uniform(3, wl - 4, budget).astype(np.float32)
        vs = gen.uniform(3, hl - 4, budget).astype(np.float32)
        d = depth0[np.clip((vs * s).astype(int), 0, H - 1), np.clip((us * s).astype(int), 0, W - 1)]
        pid = (1.0 / d).astype(np.float32)
        live = np.arange(budget) < n_live
        pid[~live] = 0.0
        col = pyr_template[lvl][np.clip(vs.astype(int), 0, hl - 1), np.clip(us.astype(int), 0, wl - 1)]
        col[~live] = 0.0
        t = lambda a: torch.as_tensor(a, device=dev)
        return t(us), t(vs), t(pid), t(col.astype(np.float32)), t(live)

    pyr_template = [p[..., 0].cpu().numpy()
                    for p in build_pyramid(img0, LEVELS).data]
    T = lie.se3_exp(torch.tensor([0.01, -0.005, -0.4, 0.002, 0.003, -0.001],
                                 dtype=torch.float32, device=dev))
    # the tracker's batches: 1 pose per LM step, 5 and 78 when it escalates
    # through the motion tries (models/frontend.py, _track_frame)
    poses = {}
    for B in POSE_BATCHES:
        xi = torch.as_tensor(0.02 * gen.randn(B, 6).astype(np.float32), device=dev)
        xi[0] = 0.0
        poses[B] = torch.stack([T @ lie.se3_exp(x) for x in xi])
    for lvl, budget in ((0, 8192), (4, 512)):
        Ki = torch.as_tensor(intr.Ki(lvl), dtype=torch.float32, device=dev)
        pts = points(lvl, budget, int(budget * 0.8))
        for B, Tb in poses.items():
            args = (pyr1.data[lvl], *pts, Tb[:, :3, :3] @ Ki, Ki, Tb[:, :3, 3],
                    torch.linspace(0.97, 1.02, B, device=dev),
                    torch.linspace(-2.0, 1.5, B, device=dev),
                    torch.tensor(0.5, device=dev), intr.fx[lvl], intr.fy[lvl],
                    intr.cx[lvl], intr.cy[lvl], 9.0,
                    torch.linspace(20.0, 40.0, B, device=dev), lvl == 0)
            got = rh.pose_residual_pass_cuda(*args)
            ref = rh.pose_residual_pass_plain(*args)
            torch.cuda.synchronize()
            eH, eb = rel_err(torch, got.H, ref.H), rel_err(torch, got.b, ref.b)
            est = max(rel_err(torch, g, r) for g, r in zip(
                list(got.stats) + [got.num_in], list(ref.stats) + [ref.num_in]))
            if not (eH <= 1e-4 and eb <= 1e-4 and est <= 1e-5):
                fail(f"K2 pose pass lvl {lvl} B={B}: H {eH:.3g} b {eb:.3g} "
                     f"stats {est:.3g}")
            err = max(float(torch.max(torch.abs(got.H - ref.H))),
                      float(torch.max(torch.abs(got.b - ref.b))))
            ms, pms = ab_ms(torch, lambda: rh.pose_residual_pass_cuda(*args),
                            lambda: rh.pose_residual_pass_plain(*args))
            print(f"K2 pose_residual_pass lvl {lvl} N={budget} B={B}: H rel {eH:.2e}, "
                  f"b rel {eb:.2e}, stats rel {est:.2e}; kernel {ms:.4f} ms, "
                  f"plain {pms:.4f} ms", flush=True)
            rows.append(dict(name=f"pose_residual_pass[N={budget},B={B}]", route="cuda",
                             source="direct_stereo_slam_tpu_torch/csrc/residual_hb.cu",
                             replaces="direct_stereo_slam_tpu/ops/residual_hb.py:126",
                             max_abs_err=err, ms=ms, plain_ms=pms))

        Ki0 = Ki
        t01 = torch.as_tensor(ds.t_cam1_cam0[:3, 3], device=dev)
        R01Ki = torch.as_tensor(ds.t_cam1_cam0[:3, :3], device=dev) @ Ki0
        scales = torch.tensor([0.1, 1.0, 5.0, 10.0, 15.0, 25.0, 30.0, 50.0], device=dev)
        # a fully live list (finite H, b) and the padded one: padding lanes
        # carry pid = 0, which makes the reference's H and b NaN (0 * NaN
        # in its masked sums); the kernel must reproduce that too
        full = points(lvl, budget, budget)
        for tag, p in (("live", full), ("padded", pts)):
            sargs = (pyr_r.data[lvl], *p, R01Ki, Ki0, t01, scales, intr.fx[lvl],
                     intr.fy[lvl], intr.cx[lvl], intr.cy[lvl], 9.0,
                     torch.full((8,), 20.0, device=dev))
            got = rh.scale_residual_pass_cuda(*sargs)
            ref = rh.scale_residual_pass_plain(*sargs)
            torch.cuda.synchronize()
            for name, g, r in (("H", got.H, ref.H), ("b", got.b, ref.b)):
                same_nan = torch.equal(torch.isnan(g), torch.isnan(r))
                fin = torch.isfinite(r)
                if not same_nan or (fin.any() and rel_err(torch, g[fin], r[fin]) > 1e-4):
                    fail(f"K3 scale pass lvl {lvl} {tag}: {name} differs "
                         f"({g.tolist()} vs {r.tolist()})")
            est = max(rel_err(torch, g, r) for g, r in zip(got.stats, ref.stats))
            if est > 1e-5:
                fail(f"K3 scale pass lvl {lvl} {tag}: stats rel {est:.3g}")
            if tag == "live":
                if not bool(torch.isfinite(ref.H).all()):
                    fail(f"K3 live list gave a non-finite H: {ref.H.tolist()}")
                eH = rel_err(torch, got.H, ref.H)
                err = max(float(torch.max(torch.abs(got.H - ref.H))),
                          float(torch.max(torch.abs(got.b - ref.b))))
        ms, pms = ab_ms(torch, lambda: rh.scale_residual_pass_cuda(*sargs),
                        lambda: rh.scale_residual_pass_plain(*sargs))
        print(f"K3 scale_residual_pass lvl {lvl} N={budget} G=8: H rel {eH:.2e}, "
              f"stats rel {est:.2e}, padded-list NaNs agree; kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms", flush=True)
        rows.append(dict(name=f"scale_residual_pass[N={budget}]", route="cuda",
                         source="direct_stereo_slam_tpu_torch/csrc/residual_hb.cu",
                         replaces="direct_stereo_slam_tpu/ops/residual_hb.py:313",
                         max_abs_err=err, ms=ms, plain_ms=pms))

    rows += pose3d_rows(torch, dev, gen, pyr1, pyr_template, depth0, intr, T)
    return rows


def pose3d_rows(torch, dev, gen, pyr1, pyr_template, depth0, intr, T):
    """K4 against its plain version at the loop estimator's shapes: the
    matched keyframe's points (max_loop_points = 2048, metric, in its
    camera frame) against the current keyframe's pyramid levels 0 and 3,
    all lanes live and k < 2048 live (padding x = y = 0, z = 1, mask
    False, as the handler pads), a stack of 1 seed (reference_acceptance)
    and of 6 (primary, a second seed, 4 yaw perturbations). The second
    seed sits 100 m behind the points and projects none of them."""
    from direct_stereo_slam_tpu_torch.loop.pose_estimator import make_seed_stack
    from direct_stereo_slam_tpu_torch.ops import residual_hb as rh

    rows = []
    kmax = 2048
    K0 = intr.K(0)
    us = gen.uniform(4, W - 5, kmax)
    vs = gen.uniform(4, H - 5, kmax)
    z = depth0[vs.astype(int), us.astype(int)].astype(np.float64)
    xyz = np.stack([(us - K0[0, 2]) / K0[0, 0] * z, (vs - K0[1, 2]) / K0[1, 1] * z, z], -1)
    T_np = T.cpu().numpy().astype(np.float64)
    behind = T_np.copy()
    behind[2, 3] -= 100.0
    stacks = {1: T_np[None].astype(np.float32),
              6: make_seed_stack(T_np, (behind,), (3.0, -3.0, 6.0, -6.0))}
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    for lvl in (0, 3):
        s = 1 << lvl
        hl, wl = pyr_template[lvl].shape
        col = pyr_template[lvl][np.clip((vs / s).astype(int), 0, hl - 1),
                                np.clip((us / s).astype(int), 0, wl - 1)]
        for k in (kmax, 1500):
            live = np.arange(kmax) < k
            p = np.where(live[:, None], xyz, [0.0, 0.0, 1.0]).astype(np.float32)
            c = np.where(live, col, 0.0).astype(np.float32)
            for S, Ts in stacks.items():
                args = (pyr1.data[lvl], t(p[:, 0]), t(p[:, 1]), t(p[:, 2]), t(c), t(live),
                        t(Ts[:, :3, :3]), t(Ts[:, :3, 3]),
                        torch.linspace(0.97, 1.02, S, device=dev),
                        torch.linspace(-2.0, 1.5, S, device=dev),
                        torch.zeros((), device=dev), intr.fx[lvl], intr.fy[lvl],
                        intr.cx[lvl], intr.cy[lvl], 9.0,
                        torch.linspace(20.0, 40.0, S, device=dev))
                got = rh.pose3d_residual_pass_cuda(*args)
                ref = rh.pose3d_residual_pass_plain(*args)
                torch.cuda.synchronize()
                tag = f"lvl {lvl} N={kmax} k={k} S={S}"
                if not bool(torch.isfinite(ref.H).all()) or float(ref.num_in[0]) < 0.25 * k:
                    fail(f"K4 {tag}: the plain version saw too little "
                         f"(num_in {ref.num_in.tolist()})")
                if S == 6 and float(ref.stats.num_terms[1]) != 0.0:
                    fail(f"K4 {tag}: the seed behind the points projected some")
                eH, eb = rel_err(torch, got.H, ref.H), rel_err(torch, got.b, ref.b)
                est = max(rel_err(torch, g, r) for g, r in zip(
                    list(got.stats) + [got.num_in], list(ref.stats) + [ref.num_in]))
                if not (eH <= 1e-4 and eb <= 1e-4 and est <= 1e-5):
                    fail(f"K4 pose3d pass {tag}: H {eH:.3g} b {eb:.3g} stats {est:.3g}")
                err = max(float(torch.max(torch.abs(got.H - ref.H))),
                          float(torch.max(torch.abs(got.b - ref.b))))
                ms, pms = ab_ms(torch, lambda: rh.pose3d_residual_pass_cuda(*args),
                                lambda: rh.pose3d_residual_pass_plain(*args))
                print(f"K4 pose3d_residual_pass {tag}: H rel {eH:.2e}, b rel {eb:.2e}, "
                      f"stats rel {est:.2e}; kernel {ms:.4f} ms, plain {pms:.4f} ms",
                      flush=True)
                rows.append(dict(name=f"pose3d_residual_pass[lvl={lvl},k={k},S={S}]",
                                 route="cuda",
                                 source="direct_stereo_slam_tpu_torch/csrc/residual_hb.cu",
                                 replaces="direct_stereo_slam_tpu/ops/residual_hb.py:235",
                                 max_abs_err=err, ms=ms, plain_ms=pms))
    return rows


def e2e_profile(torch, run_once, out_dir: str) -> None:
    """One more end-to-end pass under torch.profiler: device busy share of
    the pass, device time by kernel, and the hand-written kernels' share
    (full table written to out_dir)."""
    import os
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_ms = lambda e: e.self_device_time_total / 1e3
    busy = sum(dev_ms(e) for e in kernels)
    print(f"profile: pass wall {wall:.3f} s under the profiler, device kernels "
          f"{busy:.1f} ms = {100 * busy / 1e3 / wall:.1f}% busy; "
          f"{sum(e.count for e in kernels)} kernel launches", flush=True)
    ours = [e for e in kernels if e.key.startswith("(anonymous namespace)::") and any(
        k in e.key for k in ("pose_partial", "pose3d_partial", "pose_final", "scale_partial",
                             "scale_final", "relax_kernel", "occupancy_kernel",
                             "fill_kernel"))]
    for e in sorted(ours, key=dev_ms, reverse=True):
        print(f"profile:   ours {dev_ms(e):9.3f} ms  x{e.count:6d}  {e.key[:60]}", flush=True)
    for e in sorted(kernels, key=dev_ms, reverse=True)[:12]:
        print(f"profile:   {dev_ms(e):9.3f} ms  x{e.count:6d}  {e.key[:90]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "e2e_profile.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=80))


def run_sequence(torch, SLAMNode, cfg, intr, ds, frames, dev, sync_timers=False):
    """One pass of a fresh SLAMNode over the frames: (node, shells, frames
    at which the node reset the front end, seconds ending in a device
    synchronize)."""
    node = SLAMNode(cfg, intr, intr, ds.t_cam1_cam0, device=dev,
                    sync_timers=sync_timers)
    shells, resets = [], []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        fe = node.frontend
        shells.append(node.process(f["img0"], f["img1"], float(f["timestamp"])))
        if node.frontend is not fe:
            resets.append(i)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return node, shells, resets, time.perf_counter() - t0


def translations(frames, shells):
    """(estimated, true) camera positions [n, 3], and the path length."""
    gt = np.stack([f["pose_w_c0"][:3, 3] for f in frames])
    est = np.stack([np.asarray(s.T_wc)[:3, 3] for s in shells])
    return est, gt, float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))


def sequence_setup(dev, n, **kw):
    from direct_stereo_slam_tpu_torch.config import make_config
    from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
    from direct_stereo_slam_tpu_torch.io.synthetic import SyntheticStereoDataset

    ds = SyntheticStereoDataset(n_frames=n, width=W, height=H, device=dev, **kw)
    t0 = time.perf_counter()
    frames = [ds.frame(i) for i in range(n)]
    print(f"rendered {n} frames {W}x{H} {kw} in {time.perf_counter() - t0:.2f} s "
          f"(set-up)", flush=True)
    cfg = make_config(W, H, preset=0, mode=1)
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H,
                                   cfg.tracker.pyr_levels)
    return ds, frames, cfg, intr


def e2e_phase(torch, dev, profile_dir=None):
    """The port's SLAMNode on a rendered KITTI-size sequence; returns the
    launch count of each kernel during the timed pass."""
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    ds, frames, cfg, intr = sequence_setup(dev, E2E_FRAMES, speed=0.4)
    # a first pass with a device synchronize at the end of every span gives
    # the per-stage table and warms the allocator and library handles
    node1, shells1, _, dt1 = run_sequence(torch, SLAMNode, cfg, intr, ds,
                                                    frames, dev, sync_timers=True)
    print(f"e2e stage table (first pass, host wall clock per span with a device "
          f"synchronize at its end, ms; {E2E_FRAMES / dt1:.3f} FPS with the "
          f"barriers):", flush=True)
    print(node1.timing_report(), flush=True)

    counters = kernel_counters()
    del counters["pose3d_residual_pass"]      # loop closure is not on this path
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    # the timed pass: no per-span synchronize, as a user runs the node
    node, shells, resets, dt = run_sequence(torch, SLAMNode, cfg, intr, ds,
                                            frames, dev)
    launches = {name: fn.launches for name, fn in counters.items()}

    fe = node.frontend
    kfs = [i for i, s in enumerate(shells) if s.is_kf]
    est, gt, path = translations(frames, shells)
    errs = np.linalg.norm(est[1:] - gt[1:], axis=1)
    ate = float(np.sqrt(np.mean(errs ** 2)))
    print(f"e2e: {E2E_FRAMES} frames in {dt:.3f} s = {E2E_FRAMES / dt:.3f} FPS "
          f"({1000 * dt / E2E_FRAMES:.2f} ms/frame, second pass, synchronous path, "
          f"no per-span synchronize); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    print(f"e2e: keyframes {len(kfs)} at {kfs}, ATE {ate:.4f} m over a "
          f"{path:.2f} m path ({100 * ate / path:.3f}%), max frame error "
          f"{float(errs.max()):.4f} m", flush=True)
    same = [i for i, s in enumerate(shells1) if s.is_kf] == kfs
    print(f"e2e: first vs second pass: keyframes {'equal' if same else 'differ'}, "
          f"positions differ by at most "
          f"{float(np.max(np.linalg.norm(est - translations(frames, shells1)[0], axis=1))):.3g} m",
          flush=True)
    print(f"e2e kernel launches: {launches}", flush=True)
    if not fe.initialized:
        fail("e2e: front end never initialised")
    if fe.is_lost or fe.init_failed or resets:
        fail(f"e2e: lost={fe.is_lost} init_failed={fe.init_failed} resets at {resets}")
    if len(kfs) < 3:
        fail(f"e2e: only {len(kfs)} keyframes")
    if not np.all(np.isfinite(est)):
        fail("e2e: non-finite poses")
    if not ate < 0.02 * path:
        fail(f"e2e: ATE {ate:.4f} m >= 2% of {path:.2f} m")
    for name, n in launches.items():
        if n <= 0:
            fail(f"e2e: kernel {name} was never launched on the main path")
    if profile_dir:
        e2e_profile(torch, lambda: run_sequence(torch, SLAMNode, cfg, intr, ds,
                                                frames, dev), profile_dir)
    return launches


def kernel_counters():
    from direct_stereo_slam_tpu_torch.ops import distance_map as dm
    from direct_stereo_slam_tpu_torch.ops import residual_hb as rh

    return {"distance_map": dm.build_distance_map_cuda,
            "pose_residual_pass": rh.pose_residual_pass_cuda,
            "scale_residual_pass": rh.scale_residual_pass_cuda,
            "pose3d_residual_pass": rh.pose3d_residual_pass_cuda}


class QuantisedFrames:
    """Pre-rendered frames as a dataset reader gives them after PNG
    decoding: images cut to uint8 as scripts/gen_longseq.py writes them
    (np.clip(img, 0, 255).astype(np.uint8), truncating)."""

    def __init__(self, frames):
        self.frames = [dict(f, img0=np.clip(f["img0"], 0, 255).astype(np.uint8),
                            img1=np.clip(f["img1"], 0, 255).astype(np.uint8))
                       for f in frames]

    def __len__(self):
        return len(self.frames)

    def frame(self, i):
        return self.frames[i]


def loop_phase(torch, dev, n_frames: int, loop_margin: int, gate: bool = True):
    """The port's SLAMNode + threaded LoopHandler over the loop room.
    Returns the launch count of each kernel during the run."""
    import dataclasses

    from direct_stereo_slam_tpu_torch.config import make_config
    from direct_stereo_slam_tpu_torch.io.synthetic import (
        SyntheticStereoDataset, _loop_scene, loop_trajectory)
    from direct_stereo_slam_tpu_torch.runtime.eval import (
        run_sequence, score_rows, timing_table)

    ds = SyntheticStereoDataset(n_frames=n_frames, width=W, height=H,
                                scene=_loop_scene(), device=dev)
    ds.poses = loop_trajectory(n_frames, radius=8.0, laps=4.5 * n_frames / 360.0,
                               ease_in=8)
    t0 = time.perf_counter()
    frames = QuantisedFrames([ds.frame(i) for i in range(n_frames)])
    print(f"loop {n_frames}: rendered {n_frames} frames {W}x{H} in "
          f"{time.perf_counter() - t0:.2f} s (set-up)", flush=True)
    cfg = make_config(W, H, preset=0, mode=1)
    cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, loop_margin=loop_margin))

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    node, handler, dt = run_sequence(frames, cfg, ds.K, ds.t_cam1_cam0, levels=LEVELS,
                                     device=dev)
    launches = {name: fn.launches for name, fn in counters.items()}
    handler.close()

    gt = ds.poses[:, :3, 3]
    ate_o = score_rows(handler.odometry_rows(), gt)
    ate_d = score_rows(handler.optimized_rows(), gt)
    loops = handler.direct_loop_count + handler.icp_loop_count
    tag = f"loop {n_frames} (margin {loop_margin})"
    print(f"{tag}: {n_frames / dt:.3f} FPS ({dt:.2f} s, threaded loop handler drained, "
          f"synchronized); keyframes {node.frontend.num_kfs}, loop frames "
          f"{len(handler.frames)}; funnel {handler.stats}; loops "
          f"{handler.direct_loop_count} direct + {handler.icp_loop_count} ICP; "
          f"ATE sodso {ate_o:.4f} m, dslam {ate_d:.4f} m; min SC distance "
          f"{handler.min_sc_diff:.4f}", flush=True)
    print(f"{tag} stage table (host wall clock per span, no per-span synchronize; "
          f"ms x count): " + ", ".join(f"{n} {ms:.2f} x {c}" for n, (ms, c) in
                                       timing_table(node.timers).items()), flush=True)
    tries = handler.try_log
    print(f"{tag}: direct tries {len(tries)}, passed {sum(t[3] and t[4] and t[5] for t in tries)}"
          f"; gates failed: res {sum(not t[3] for t in tries)}, inlier "
          f"{sum(not t[4] for t in tries)}, aff {sum(not t[5] for t in tries)}; "
          f"best pose_error per try "
          f"{' '.join(f'{t[0]:.2f}' for t in tries)}", flush=True)
    print(f"{tag} kernel launches: {launches}", flush=True)
    # the final pose graph optimized once more with nothing else running:
    # what pose_graph_opt costs without the tracking thread beside it
    from direct_stereo_slam_tpu_torch.loop import pose_graph

    data, _ = handler.graph_data()
    pose_graph.optimize(data, cfg.loop.pgo_iterations)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pose_graph.optimize(data, cfg.loop.pgo_iterations)
    torch.cuda.synchronize()
    print(f"{tag}: the final pose graph ({len(handler.frames)} nodes, bucket "
          f"{data.T_wc.shape[0]}) alone: {1000 * (time.perf_counter() - t0):.2f} ms per "
          f"optimize", flush=True)
    if n_frames == 320:
        print(f"{tag} vs EVAL_r05 (JAX package, TPU v5e, PNG ingestion): loops "
              f"{loops} vs {R05['loops']}, direct tries {handler.stats['direct_try']} "
              f"vs {R05['tries']}, ATE sodso {ate_o:.3f} vs {R05['ate_sodso']} m, "
              f"dslam {ate_d:.3f} vs {R05['ate_dslam']} m", flush=True)
    if not gate:
        return launches
    if ate_o is None or ate_d is None or not (np.isfinite(ate_o) and np.isfinite(ate_d)):
        fail(f"{tag}: no finite ATE ({ate_o}, {ate_d})")
    if loops < 1:
        fail(f"{tag}: no loop verified")
    if not ate_d < ate_o:
        fail(f"{tag}: dslam ATE {ate_d:.4f} m is not below sodso ATE {ate_o:.4f} m")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{tag}: kernel {name} was never launched on the loop path")
    return launches


def long_phase(torch, dev) -> None:
    """Longer rendered sequences at KITTI size, reported, not gated: an
    80-frame loop (radius 8 m in a 50 m room) and a 120-frame straight
    forward run (47.6 m of the scene's 60 m depth; both stay inside the
    rendered scene, which a forward run with yaw leaves through its side
    wall after ~37 frames). Each also runs through the port on the host
    CPU (the kernels' plain versions), frame by frame against the card."""
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    for n, kw in ((80, dict(trajectory="loop")),
                  (120, dict(trajectory="forward", speed=0.4))):
        ds, frames, cfg, intr = sequence_setup(dev, n, **kw)
        node, shells, resets, dt = run_sequence(torch, SLAMNode, cfg, intr, ds,
                                                frames, dev)
        est, gt, path = translations(frames, shells)
        errs = np.linalg.norm(est - gt, axis=1)
        if not np.all(np.isfinite(est)):
            fail(f"long {kw}: non-finite poses")
        kfs = [i for i, s in enumerate(shells) if s.is_kf]
        over = lambda th: int(np.argmax(errs > th)) if (errs > th).any() else None
        print(f"long {kw}: {n} frames {n / dt:.3f} FPS, {len(kfs)} keyframes, "
              f"resets at {resets}, ATE {float(np.sqrt(np.mean(errs ** 2))):.4f} m "
              f"over {path:.2f} m; first frame with error > 0.1 m: {over(0.1)}, "
              f"> 1 m: {over(1.0)}", flush=True)
        print(f"long {kw}: error per frame (m): "
              f"{' '.join(f'{e:.3f}' for e in errs)}", flush=True)
        print(f"long {kw}: keyframes at {kfs}", flush=True)
        print(node.timing_report(), flush=True)
        _, hshells, hresets, hdt = run_sequence(torch, SLAMNode, cfg, intr, ds,
                                                frames, torch.device("cpu"))
        d = np.linalg.norm(translations(frames, hshells)[0] - est, axis=1)
        hkfs = [i for i, s in enumerate(hshells) if s.is_kf]
        first = int(np.argmax(d > 0.01)) if (d > 0.01).any() else None
        print(f"long {kw}: host CPU in {hdt:.1f} s, resets at {hresets}; keyframes "
              f"{'as on the card' if hkfs == kfs else hkfs}; position card "
              f"vs host: max {float(d.max()):.4f} m, first > 1 cm at frame {first}; "
              f"per frame (m): {' '.join(f'{e:.3f}' for e in d)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one more end-to-end pass; table to DIR")
    ap.add_argument("--long", action="store_true",
                    help="also run the 320-frame loop protocol and longer "
                         "KITTI-size sequences on the card and on the host CPU "
                         "(reported, not gated)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card")
    dev = torch.device("cuda", 0)
    print(card_info(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from direct_stereo_slam_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    lib = _cuda.load_library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s -> {lib.path.name}",
          flush=True)
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    rows = kernel_phase(torch, dev)
    launches = e2e_phase(torch, dev, args.profile)
    launches.update(pose3d_residual_pass=loop_phase(
        torch, dev, LOOP_FRAMES, LOOP_MARGIN)["pose3d_residual_pass"])
    if args.long:
        loop_phase(torch, dev, 320, 100, gate=False)
        long_phase(torch, dev)
    for row in rows:
        row["launches"] = launches[row["name"].split("[")[0]]
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if leaked:
        fail(f"the port pulled in JAX: {leaked[:5]}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
