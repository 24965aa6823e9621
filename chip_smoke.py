"""Chip smoke test of the PyTorch / CUDA port (direct_stereo_slam_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass (any fault exits non-zero):

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the hand-written kernels from csrc/ (timed);
3. each kernel against its plain PyTorch version on the card, at KITTI
   shapes: K1 distance map (one launch, bit-equal), K2 pose pass at budgets 8192 and
   512 with the tracker's batches of 1, 5 and 78 poses, and K3 scale pass
   with 8 guesses, and K4 loop pose pass (metric points, N = 2048 with
   all lanes live and with padded lanes, 1 and 6 seeds, one seed that
   projects no point, on pyramid levels 0 and 3) (H and b per entry
   within 1e-4 x max|entry|, stats within rel 1e-5); then the resident
   LM kernels K2-LM (the tracker's whole LM for a batch of 1, 5 or 78
   candidates, templates of base budget 8192 and 512) and K4-LM (the
   loop estimator's for a stack of 1 or 6 seeds over 2048 points, all
   live or padded) and K3-LM (the stereo scale optimizer's for 1 guess or
   the grid of 8, templates of base budget 8192 and 512, all lanes live
   or the last fifth padded, whose NaN H and b keep every guess), each
   against the Python LM loop driving the per-pass kernel and against
   the same loop over plain passes (K2-LM / K4-LM: residuals per level
   within 1e-3 relative, poses within 1e-3 per matrix entry, the same ok,
   the same winner; K3-LM: scale and error within 1e-3 relative, the same
   accept/trap decision; a candidate may differ only where a near-tie
   accept/reject makes the loops themselves differ when the points' lane
   order changes, as utils/lm_agreement.py measures in each run); median
   time per call of each (CUDA events), with its bound
   (bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s, the larger),
   and for K1 and K3-LM the card's own time per call (the calls queued
   behind a spin of the card, so that the host's issue time drops out);
4. the port's SLAMNode end to end on a rendered 40-frame 1232x368
   sequence (preset 0, mode 1): initialised, never lost, >= 3 keyframes,
   translation ATE < 2% of the path length, K1, K2-LM and K3-LM each
   launched during the timed pass and the per-pass K2 and K3 never. A
   first pass with a device synchronize at the end of every span gives
   the per-stage table; FPS, ``track`` per frame and ``scale_opt`` per
   keyframe come from the second pass, without them;
5. pipelined tracking: the e2e sequence in turns synchronous, pipelined,
   pipelined, synchronous, twice (FPS of each mode from the same
   process), then one pass of each with the host's blocking waits on the
   card counted per call (``WaitCounter``). The last pipelined pass:
   initialised, never lost, ATE < 2% of the path, keyframe count within
   2 of the first synchronous pass, mean per-frame translation
   difference to it < 5% of the distance travelled, at least one
   keyframe flush retrack, nothing in flight after ``finish``, K1, K2-LM
   and K3-LM launched and the per-pass K2/K3 not;
6. the monocular bootstrap in DSO mode (``mono_initializer``, no stereo
   scale, zeros for the right image) on test_mono_frontend_e2e.py's 40
   poses at 1232x368, frames cut to uint8 as a camera gives them:
   keyframe 0 within ``mono_init_max_frames``, never lost, >= 3
   keyframes, Sim(3)-aligned ATE < 0.35 m, K1 and K2-LM launched; ms per
   bootstrap frame (``mono_init.track_frame``, plain PyTorch on the
   card);
7. undistortion: the ``Undistorter`` on tests/fixtures/realformat on the
   card against the same call on the CPU, within 1e-3 gray levels; ms
   per frame;
8. loop closure: the port's SLAMNode with its threaded LoopHandler (as
   ``run_slam`` runs them) over 160 frames (2 laps at 4.5 deg/frame) of
   the loop room at 1232x368, images quantised to uint8, loop_margin 40:
   at least one verified loop, the loop-closed (dslam) ATE below the
   odometry (sodso) ATE, K1, K2-LM, K3-LM and K4-LM each launched during
   the run and the per-pass K2, K3 and K4 never; ``direct_est`` per try,
   ``scale_opt`` per keyframe. A failure in the loop thread fails the
   run (the handler re-raises it when it is drained).

Options: --profile DIR profiles one more end-to-end pass; --long also
runs the mono sequence on the float render and on six dithered uint8
inputs, the 160-frame loop phase pipelined, the full 320-frame loop
protocol (loop_margin 100), printed beside the JAX package's TPU record
of the same protocol, then an 80-frame loop and a 120-frame forward
sequence at the same size with the error of every frame (reported, not
gated), each of those also through the port on the host CPU, frame by
frame against the card.

The line before the last is the kernel table as JSON (each row's
launches in the e2e or loop phase, in the last pipelined pass and per
frame of it, and in the mono phase); the last line is
{"ok": true, "device": {...}}. The script imports nothing of JAX nor of
the JAX package, and checks so before its last line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from functools import partial

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
# the least time of a call: bytes over the H100's memory rate, or f32
# operations over its rate outside the tensor cores (H100 SXM data sheet),
# whichever is larger
DRAM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# a residual pass per point: warp, 4 bilinear taps of 3 floats, Huber,
# Jacobian and the 44 H/b products (~200 f32 operations); it reads the
# point's 17 bytes and 4 taps x 12 bytes
PASS_OPS, POINT_BYTES, TAP_BYTES = 200, 17, 48
# the 1-DoF scale pass: warp, taps, Huber and the 2 H/b products
SCALE_PASS_OPS = 80


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


def median_ms(torch, fn, repeats: int = REPEATS, inner: int = 10,
              warmup: int = 3) -> float:
    """Time per call of fn() on the card: CUDA events around `inner`
    back-to-back calls (host enqueue overlapping device work, as in a
    loop), synchronized before each sample; median over `repeats`
    samples, warm-up excluded."""
    for _ in range(warmup):
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


def ab_ms(torch, kernel_fn, plain_fn, plain_kw=None, kernel_kw=None):
    """(kernel ms, plain ms) measured in turns plain, kernel, kernel, plain
    and averaged, so drift in the card's clocks hits both alike."""
    plain_kw, kernel_kw = plain_kw or {}, kernel_kw or {}
    p1 = median_ms(torch, plain_fn, **plain_kw)
    k1 = median_ms(torch, kernel_fn, **kernel_kw)
    k2 = median_ms(torch, kernel_fn, **kernel_kw)
    p2 = median_ms(torch, plain_fn, **plain_kw)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_ms(torch, fn, calls: int = 20, samples: int = 5):
    """The card's own time per call of fn(): the calls are queued behind a
    spin of the card (torch.cuda._sleep, ~100 ms), so the host has issued
    them all before the first one runs and CUDA events around them time
    only the card (the gaps between back-to-back launches included); the
    median over ``samples``. None if the host took longer to issue them
    than a tenth of the spin."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        issued = time.perf_counter() - t0
        end.record()
        end.synchronize()
        if issued > 0.01:
            return None
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def row(name, source, replaces, err, ms, plain_ms, n_bytes, n_ops):
    """One entry of the kernel table: the bound is the larger of the bytes
    the call must move and the f32 operations it must do."""
    b_ms = 1e3 * n_bytes / DRAM_BYTES_PER_S
    o_ms = 1e3 * n_ops / F32_OPS_PER_S
    return dict(name=name, route="cuda",
                source=f"direct_stereo_slam_tpu_torch/csrc/{source}",
                replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms else "operations",
                library_ms=None)


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
        dev_ms = device_ms(torch, lambda: dm.build_distance_map_cuda(pu, pv, mask, h2, w2))
        print(f"K1 distance_map {h2}x{w2} n={n}: bit-equal, kernel {ms:.4f} ms "
              f"(on the card {dev_ms} ms), plain {pms:.4f} ms", flush=True)
        # reads (pu, pv, mask), writes the f32 map. The function is the
        # chessboard distance capped at 16: the least work is ~6 operations
        # per point to round and clip it and a two-pass chamfer sweep
        # (per cell and pass 4 mins, 1 add, 1 min with the cell) plus the
        # cap, 13 per cell (the kernel's 16 relaxations do far more)
        rows.append(row(f"distance_map[n={n}]", "distance_map.cu",
                        "direct_stereo_slam_tpu/ops/distance_map.py:59", err, ms, pms,
                        n * 9 + h2 * w2 * 4, n * 6 + h2 * w2 * 13))
        rows[-1]["device_ms"] = dev_ms

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
            rows.append(row(f"pose_residual_pass[N={budget},B={B}]", "residual_hb.cu",
                            "direct_stereo_slam_tpu/ops/residual_hb.py:126", err, ms, pms,
                            budget * POINT_BYTES + B * budget * TAP_BYTES + B * 80 * 4,
                            B * budget * PASS_OPS))

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
        # 8 guesses
        rows.append(row(f"scale_residual_pass[N={budget}]", "residual_hb.cu",
                        "direct_stereo_slam_tpu/ops/residual_hb.py:313", err, ms, pms,
                        budget * POINT_BYTES + 8 * budget * TAP_BYTES + 8 * 8 * 4,
                        8 * budget * SCALE_PASS_OPS))

    rows += pose3d_rows(torch, dev, gen, pyr1, pyr_template, depth0, intr, T)
    rows += lm_rows(torch, dev, ds, f0, f1, intr, pyr1, pyr_template)
    rows += scale_lm_rows(torch, dev, ds, f0, intr, pyr_r)
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
                rows.append(row(f"pose3d_residual_pass[lvl={lvl},k={k},S={S}]",
                                "residual_hb.cu",
                                "direct_stereo_slam_tpu/ops/residual_hb.py:235", err, ms,
                                pms, kmax * POINT_BYTES + S * kmax * TAP_BYTES + S * 80 * 4,
                                S * kmax * PASS_OPS))
    return rows


def lm_bytes_ops(sizes, passes, B, pass_ops=PASS_OPS, io_bytes=64 + 160):
    """Bytes and operations of a resident LM call from the passes it ran:
    each level's points read once, 4 taps per point and pass, per
    candidate its start read and its row written (``io_bytes``)."""
    n = np.asarray(sizes, np.float64)
    point_passes = float((np.asarray(passes, np.float64) * n[None]).sum())
    return (float(n.sum()) * POINT_BYTES + point_passes * TAP_BYTES + B * io_bytes,
            point_passes * pass_ops)


def lm_rows(torch, dev, ds, f0, f1, intr, pyr1, pyr_template):
    """K2-LM and K4-LM against the Python LM loops at the main path's
    shapes: the tracker's batches of 1, 5 and 78 candidates (the first
    try, the motion tries, the rotation tries around the constant-motion
    guess) on a template of base budget 8192 (the front end's) and 512;
    the loop estimator's stacks of 1 and 6 seeds (primary, a seed 100 m
    behind the points, 4 yaw perturbations) over 2048 metric points, all
    live or 1500 live."""
    from direct_stereo_slam_tpu_torch.config import make_config
    from direct_stereo_slam_tpu_torch.geometry import lie
    from direct_stereo_slam_tpu_torch.loop import pose_estimator as pe
    from direct_stereo_slam_tpu_torch.models import depth_template as dt
    from direct_stereo_slam_tpu_torch.models import tracker as tr
    from direct_stereo_slam_tpu_torch.ops import resident_lm as rlm
    from direct_stereo_slam_tpu_torch.ops import residual_hb as rh
    from direct_stereo_slam_tpu_torch.ops.interp import bilinear_gather_scalar
    from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid
    from direct_stereo_slam_tpu_torch.utils import lm_agreement as lma

    rows = []
    cfg = make_config(W, H, preset=0, mode=1)
    gen = np.random.RandomState(1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    n = 20000
    us = gen.uniform(3, W - 4, n).astype(np.float32)
    vs = gen.uniform(3, H - 4, n).astype(np.float32)
    z = f0["depth0"][vs.astype(int), us.astype(int)].astype(np.float64)
    T_true = np.linalg.inv(f1["pose_w_c0"]) @ f0["pose_w_c0"]
    slast = lie.se3_exp_np([0.02, -0.01, 0.05, 0.01, -0.005, 0.002])
    stage1, stage2 = tr.make_motion_tries(np.eye(4), T_true, slast, cfg)
    zero, one = torch.zeros((), device=dev), torch.ones((), device=dev)
    aff = tr.AffLight(zero, zero)
    img0 = t(f0["img0"])
    print(f"K2-LM / K3-LM / K4-LM occupancy: {rlm.max_active_clusters('track', 8192)} / "
          f"{rlm.max_active_clusters('scale', 8192)} / "
          f"{rlm.max_active_clusters('loop_pose', 2048)} 8-block clusters of 256 threads "
          f"resident at once", flush=True)
    slow = dict(repeats=3, inner=1, warmup=1)
    fast = dict(repeats=11, inner=3, warmup=2)

    def winner(r):
        return tr.select_winner(tr.TrackResult(
            r.T.cpu().numpy(), None, r.res_per_level.cpu().numpy(), None,
            r.ok.cpu().numpy()), 1e9, cfg)

    for base in (8192, 512):
        budgets = dt.default_budgets(W, H, LEVELS, base=base)
        tmpl = dt.build_template(t(us), t(vs), t((1.0 / z).astype(np.float32)),
                                 t(np.ones(n, np.float32)), img0, LEVELS, budgets)
        sizes = [int(x.shape[0]) for x in tmpl.pu]
        for B, batch in ((1, stage1[:1]), (5, stage1), (78, stage2)):
            args = (tuple(pyr1.data), tmpl, intr, cfg, t(batch.astype(np.float32)), aff,
                    aff, one, one)
            got = tr.track_candidates_batch(*args)
            o = rlm.track_lm_cuda(*args)
            loops = (tr.track_candidates_batch_plain,
                     partial(tr.track_candidates_batch_plain,
                             residual_pass=rh.pose_residual_pass_plain))
            refs = {"K2 loop": loops[0](*args), "plain": loops[1](*args)}
            torch.cuda.synchronize()
            tag = f"K2-LM track_lm base {base} (N = {sizes}) B={B}"
            if not (torch.equal(got.T, o.T) and torch.equal(
                    torch.nan_to_num(got.res_per_level, 7.0), torch.nan_to_num(o.res, 7.0))):
                fail(f"{tag}: two launches on the same inputs differ")
            # a near-tie accept/reject decided the other way sends a
            # candidate down another path: the allowance is the number of
            # candidates on which the two loops, also run over the
            # template's lanes in two other orders, disagree among themselves
            agr = lma.check(got, refs, lma.reordered_track_runs(args, loops))
            wins = [winner(r) for r in (got, *refs.values())]
            if not agr.ok or len(set(wins)) != 1:
                fail(f"{tag}: {agr}; winners {wins}")
            err = max(agr.max_abs_err.values())
            ms, pms = ab_ms(torch, lambda: tr.track_candidates_batch(*args),
                            lambda: tr.track_candidates_batch_plain(
                                *args, residual_pass=rh.pose_residual_pass_plain),
                            plain_kw=slow, kernel_kw=fast)
            loop_ms = median_ms(torch, lambda: tr.track_candidates_batch_plain(*args), **slow)
            passes = o.passes.cpu().numpy()
            n_bytes, n_ops = lm_bytes_ops(sizes, passes, B)
            r = row(f"track_lm[N={base},B={B}]", "resident_lm.cu",
                    "direct_stereo_slam_tpu/models/tracker.py:316", err, ms, pms, n_bytes, n_ops)
            r.update(differ=agr.differ, order_sensitive=agr.sensitive)
            rows.append(r)
            print(f"{tag}: {agr}; passes per candidate per level (mean) "
                  f"{passes.mean(axis=0).round(1).tolist()}; kernel {ms:.4f} ms, plain "
                  f"loop {pms:.4f} ms, loop over K2 passes {loop_ms:.4f} ms, bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']})", flush=True)

    # ---- K4-LM: the loop estimator's seed stacks ------------------------------
    kmax = 2048
    pyr0 = build_pyramid(img0, LEVELS).data
    K0 = intr.K(0)
    zk = z[:kmax]
    xyz = np.stack([(us[:kmax] - K0[0, 2]) / K0[0, 0] * zk,
                    (vs[:kmax] - K0[1, 2]) / K0[1, 1] * zk, zk], -1).astype(np.float32)
    cols = torch.stack([bilinear_gather_scalar(pyr0[l][..., 0], t(us[:kmax] / 2 ** l),
                                               t(vs[:kmax] / 2 ** l))
                        for l in range(LEVELS)], 1)
    primary = T_true @ lie.se3_exp_np([0.03, -0.01, 0.05, 0.004, 0.01, -0.003])
    behind = primary.copy()
    behind[2, 3] -= 100.0
    stacks = {1: primary[None].astype(np.float32),
              6: pe.make_seed_stack(primary, (behind,), (3.0, -3.0, 6.0, -6.0))}
    for k in (kmax, 1500):
        live = torch.arange(kmax, device=dev) < k
        p = torch.where(live[:, None], t(xyz), torch.tensor([0.0, 0.0, 1.0], device=dev))
        c = torch.where(live[:, None], cols, torch.zeros_like(cols)).contiguous()
        for S, Ts in stacks.items():
            args = (tuple(pyr1.data), p[:, 0].contiguous(), p[:, 1].contiguous(),
                    p[:, 2].contiguous(), c, live, t(Ts), intr, cfg)
            got = pe.estimate_seeds(*args)
            o = rlm.loop_pose_lm_cuda(*args)
            loops = (pe.estimate_seeds_plain,
                     partial(pe.estimate_seeds_plain,
                             residual_pass=rh.pose3d_residual_pass_plain))
            refs = {"K4 loop": loops[0](*args), "plain": loops[1](*args)}
            torch.cuda.synchronize()
            tag = f"K4-LM loop_pose_lm N={kmax} k={k} S={S}"
            if not torch.equal(got.T, o.T):
                fail(f"{tag}: two launches on the same inputs differ")
            if not bool(got.ok[0]) or (S == 6 and float(got.inlier_ratio[1]) != 0.0):
                fail(f"{tag}: primary ok {bool(got.ok[0])}, inlier ratios "
                     f"{got.inlier_ratio.tolist()}")
            agr = lma.check(got, refs, lma.reordered_seed_runs(args, loops))
            if not agr.ok:
                fail(f"{tag}: {agr} (errors {got.pose_error.tolist()} vs "
                     f"{[r.pose_error.tolist() for r in refs.values()]})")
            err = max(agr.max_abs_err.values())
            ms, pms = ab_ms(torch, lambda: pe.estimate_seeds(*args),
                            lambda: pe.estimate_seeds_plain(
                                *args, residual_pass=rh.pose3d_residual_pass_plain),
                            plain_kw=slow, kernel_kw=fast)
            loop_ms = median_ms(torch, lambda: pe.estimate_seeds_plain(*args), **slow)
            passes = o.passes.cpu().numpy()
            n_bytes, n_ops = lm_bytes_ops([kmax] * LEVELS, passes, S)
            r = row(f"loop_pose_lm[k={k},S={S}]", "resident_lm.cu",
                    "direct_stereo_slam_tpu/loop/pose_estimator.py:217", err, ms, pms,
                    n_bytes, n_ops)
            r.update(differ=agr.differ, order_sensitive=agr.sensitive)
            rows.append(r)
            print(f"{tag}: {agr}; passes per seed per level (mean) "
                  f"{passes.mean(axis=0).round(1).tolist()}; kernel {ms:.4f} ms, plain "
                  f"loop {pms:.4f} ms, loop over K4 passes {loop_ms:.4f} ms, bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']})", flush=True)
    return rows


def scale_lm_rows(torch, dev, ds, f0, intr, pyr_r):
    """K3-LM against the Python scale loops at the main path's shapes: one
    guess (a trapped keyframe) and the grid of 8, on templates of the left
    image with the front end's budgets of base 8192 and 512 against the
    right image's pyramid. "live": every lane live at sub-pixel positions,
    idepths wrong by a factor 1.6, so the LM moves; "padded": the last
    fifth of each level padded as build_template pads, which makes every
    pass's H and b NaN (the main path's templates are padded so), so every
    step is rejected and each guess stays."""
    from direct_stereo_slam_tpu_torch.config import make_config
    from direct_stereo_slam_tpu_torch.models import depth_template as dt
    from direct_stereo_slam_tpu_torch.models import scale_opt as so
    from direct_stereo_slam_tpu_torch.ops import resident_lm as rlm
    from direct_stereo_slam_tpu_torch.ops import residual_hb as rh
    from direct_stereo_slam_tpu_torch.ops.interp import bilinear_gather_scalar
    from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid
    from direct_stereo_slam_tpu_torch.utils import lm_agreement as lma

    rows = []
    cfg = make_config(W, H, preset=0, mode=1)
    gen = np.random.RandomState(2)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    pyr0 = build_pyramid(t(f0["img0"]), LEVELS).data
    depth = f0["depth0"]
    loops = (so.optimize_scale_batch_plain,
             partial(so.optimize_scale_batch_plain, residual_pass=rh.scale_residual_pass_plain))
    slow = dict(repeats=3, inner=1, warmup=1)
    fast = dict(repeats=11, inner=3, warmup=2)

    def decision(r, trapped):
        state = so.ScaleState(trapped=trapped)
        ok, scale, error, state = so.decide_scale_optimization(
            r.scale.cpu().numpy(), r.error.cpu().numpy(), cfg, state)
        return ok, vars(state), np.array([scale, error])

    for base in (8192, 512):
        budgets = dt.default_budgets(W, H, LEVELS, base=base)
        cols = {k: [] for k in dt.TrackerTemplate._fields}
        for lvl, n in enumerate(budgets):
            u = gen.uniform(4, (W >> lvl) - 5, n).astype(np.float32)
            v = gen.uniform(4, (H >> lvl) - 5, n).astype(np.float32)
            d = depth[(v * (1 << lvl)).astype(int), (u * (1 << lvl)).astype(int)]
            cols["pu"].append(t(u))
            cols["pv"].append(t(v))
            cols["pid"].append(t((1.6 / d).astype(np.float32)))
            cols["pcolor"].append(bilinear_gather_scalar(pyr0[lvl][..., 0], t(u), t(v)))
            cols["pmask"].append(torch.ones(n, dtype=torch.bool, device=dev))
        live = dt.TrackerTemplate(*[tuple(cols[k]) for k in dt.TrackerTemplate._fields])
        pad = [torch.arange(len(x), device=dev) >= 0.8 * len(x) for x in live.pu]
        padded = live._replace(
            pid=tuple(torch.where(m, 0.0, x) for x, m in zip(live.pid, pad)),
            pcolor=tuple(torch.where(m, 0.0, x) for x, m in zip(live.pcolor, pad)),
            pmask=tuple(~m for m in pad))
        for kind, tmpl in (("live", live), ("padded", padded)):
            for G in (1, 8):
                guesses = (1.0,) if G == 1 else cfg.scale_opt.grid_guesses
                args = (tuple(pyr_r.data), tmpl, t(np.array(guesses, np.float32)), intr,
                        intr, ds.t_cam1_cam0, cfg)
                got = so.optimize_scale_batch(*args)
                o = rlm.scale_lm_cuda(*args)
                refs = {"K3 loop": loops[0](*args), "plain": loops[1](*args)}
                torch.cuda.synchronize()
                tag = f"K3-LM scale_lm base {base} (N = {list(budgets)}) G={G} {kind}"
                if not (torch.equal(got.scale, o.scale) and torch.equal(got.error, o.error)):
                    fail(f"{tag}: two launches on the same inputs differ")
                agr = lma.check(got, refs, lma.reordered_scale_runs(args, loops))
                dec = [decision(r, G == 1) for r in (got, *refs.values())]
                same = all(d[:2] == dec[0][:2] and np.allclose(d[2], dec[0][2], rtol=1e-3)
                           for d in dec[1:])
                if not agr.ok or not same:
                    fail(f"{tag}: {agr}; decisions {dec}")
                if kind == "padded" and not torch.equal(got.scale, args[2]):
                    fail(f"{tag}: a guess moved on the padded template: {got.scale.tolist()}")
                err = max(agr.max_abs_err.values())
                ms, pms = ab_ms(torch, lambda: so.optimize_scale_batch(*args),
                                lambda: loops[1](*args), plain_kw=slow, kernel_kw=fast)
                loop_ms = median_ms(torch, lambda: loops[0](*args), **slow)
                dev_ms = device_ms(torch, lambda: so.optimize_scale_batch(*args))
                passes = o.passes.cpu().numpy()
                n_bytes, n_ops = lm_bytes_ops(budgets, passes, G, SCALE_PASS_OPS, 4 + 80)
                r = row(f"scale_lm[N={base},G={G},{kind}]", "resident_lm.cu",
                        "direct_stereo_slam_tpu/models/scale_opt.py:169", err, ms, pms,
                        n_bytes, n_ops)
                r.update(differ=agr.differ, order_sensitive=agr.sensitive, device_ms=dev_ms)
                rows.append(r)
                print(f"{tag}: {agr}; passes per guess per level (mean) "
                      f"{passes.mean(axis=0).round(1).tolist()}, cutoff doublings "
                      f"{o.repeat.cpu().numpy().max(axis=0).tolist()}; decision "
                      f"{dec[0][0]}, scale {dec[0][2][0]:.4f}, error {dec[0][2][1]:.4f}; "
                      f"kernel {ms:.4f} ms (on the card {dev_ms} ms), plain loop "
                      f"{pms:.4f} ms, loop over K3 passes "
                      f"{loop_ms:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})",
                      flush=True)
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
    ours = [e for e in kernels if "(anonymous namespace)::" in e.key and any(
        k in e.key for k in ("pose_partial", "pose3d_partial", "pose_final", "scale_partial",
                             "scale_final", "distance_kernel", "lm_kernel"))]
    for e in sorted(ours, key=dev_ms, reverse=True):
        print(f"profile:   ours {dev_ms(e):9.3f} ms  x{e.count:6d}  {e.key[:60]}", flush=True)
    for e in sorted(kernels, key=dev_ms, reverse=True)[:12]:
        print(f"profile:   {dev_ms(e):9.3f} ms  x{e.count:6d}  {e.key[:90]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "e2e_profile.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=80))


def run_sequence(torch, SLAMNode, cfg, intr, ds, frames, dev, sync_timers=False,
                 per_call=None):
    """One pass of a fresh SLAMNode over the frames: (node, shells, frames
    at which the node reset the front end, seconds ending in a device
    synchronize). In pipelined mode a call returns its frame's shell in
    flight: it is completed in place one call later (the last one by
    ``finish``). ``per_call(node, process)`` wraps each frame's call when
    given."""
    node = SLAMNode(cfg, intr, intr, ds.t_cam1_cam0, device=dev,
                    sync_timers=sync_timers)
    shells, resets = [], []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        fe = node.frontend
        process = partial(node.process, f["img0"], f["img1"], float(f["timestamp"]))
        shells.append(per_call(node, process) if per_call else process())
        if node.frontend is not fe:
            resets.append(i)
    node.finish()
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
    print(f"e2e: track {node.timers.average_ms('track'):.3f} ms per frame x "
          f"{node.timers.count('track')} (timed pass; synchronized first pass: "
          f"{node1.timers.average_ms('track'):.3f} ms), K2-LM launches per tracked "
          f"frame {launches['track_lm'] / max(node.timers.count('track'), 1):.2f}; "
          f"scale_opt {node.timers.average_ms('scale_opt'):.3f} ms per keyframe x "
          f"{node.timers.count('scale_opt')} (synchronized first pass: "
          f"{node1.timers.average_ms('scale_opt'):.3f} ms), K3-LM launches per scale "
          f"optimization {launches['scale_lm'] / max(node.timers.count('scale_opt'), 1):.2f}",
          flush=True)
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
    gate_launches("e2e", launches, E2E_KERNELS)
    if profile_dir:
        e2e_profile(torch, lambda: run_sequence(torch, SLAMNode, cfg, intr, ds,
                                                frames, dev), profile_dir)
    return launches


def with_runtime(cfg, **runtime):
    import dataclasses
    return cfg.replace(runtime=dataclasses.replace(cfg.runtime, **runtime))


class WaitCounter:
    """Wraps each SLAMNode call and counts the host's blocking waits on the
    card in it: the synchronizing operations PyTorch reports under
    ``torch.cuda.set_sync_debug_mode("warn")`` (a read of a device value,
    a copy to pageable memory, a stream or device synchronize) plus the
    CUDA event waits (``torch.cuda.Event.synchronize``, the pipelined
    consume's wait). A call is "benign" when it tracked one frame with one
    K2-LM launch and completed a frame that is no keyframe (pipelined: and
    neither escalated nor retracked)."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = []          # (kind, waits)
        self.sites = {}          # kind -> {file:line of a reported wait: count}

    def __call__(self, node, process):
        import warnings

        from direct_stereo_slam_tpu_torch.ops import resident_lm as rlm

        torch = self.torch
        fe = node.frontend
        before = (fe.last_completed_shell, fe.pl_escalations, fe.pl_retracks,
                  rlm.track_lm_cuda.launches)
        events = [0]
        event_sync = torch.cuda.Event.synchronize

        def counted(ev):
            events[0] += 1
            return event_sync(ev)

        torch.cuda.Event.synchronize = counted
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                shell = process()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.Event.synchronize = event_sync
        synced = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
        waits = events[0] + len(synced)
        done = node.frontend.last_completed_shell
        fresh = node.frontend is fe and done is not None and done is not before[0]
        one_track = rlm.track_lm_cuda.launches - before[3] == 1
        calm = (fe.pl_escalations, fe.pl_retracks) == before[1:3]
        if fresh and done.is_kf:
            kind = "keyframe"
        elif fresh and one_track and calm:
            kind = "benign"
        else:
            kind = "other"
        self.calls.append((kind, waits))
        sites = self.sites.setdefault(kind, {})
        for w in synced:
            site = f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
        if events[0]:
            sites["Event.synchronize"] = sites.get("Event.synchronize", 0) + events[0]
        return shell

    def summary(self) -> dict:
        out = {}
        for kind in ("benign", "keyframe", "other"):
            w = [n for k, n in self.calls if k == kind]
            if w:
                top = sorted(self.sites.get(kind, {}).items(), key=lambda kv: -kv[1])[:6]
                out[kind] = dict(calls=len(w), median=float(np.median(w)),
                                 mean=float(np.mean(w)), max=int(max(w)), sites=dict(top))
        return out


def pipelined_phase(torch, dev):
    """The e2e sequence again in both tracking modes, in turns synchronous,
    pipelined, pipelined, synchronous, twice; then one pass of each with
    the blocking waits counted. Gates on the last pipelined pass against
    the first synchronous one. Returns the last pipelined pass's kernel
    launches."""
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    ds, frames, cfg, intr = sequence_setup(dev, E2E_FRAMES, speed=0.4)
    cfgs = {"synchronous": cfg, "pipelined": with_runtime(cfg, pipelined_tracking=True)}
    counters = kernel_counters()
    runs = {mode: [] for mode in cfgs}
    launches = None
    for mode in ("synchronous", "pipelined", "pipelined", "synchronous") * 2:
        for fn in counters.values():
            fn.launches = 0
        runs[mode].append(run_sequence(torch, SLAMNode, cfgs[mode], intr, ds, frames, dev))
        if mode == "pipelined":
            launches = {name: fn.launches for name, fn in counters.items()}
    fps = {mode: [E2E_FRAMES / r[3] for r in rs] for mode, rs in runs.items()}
    waits = {}
    for mode, c in cfgs.items():
        counter = WaitCounter(torch)
        run_sequence(torch, SLAMNode, c, intr, ds, frames, dev, per_call=counter)
        waits[mode] = counter.summary()

    node_s, shells_s, _, _ = runs["synchronous"][0]
    node, shells, resets, dt = runs["pipelined"][-1]
    fe = node.frontend
    est, gt, path = translations(frames, shells)
    est_s = translations(frames, shells_s)[0]
    errs = np.linalg.norm(est[1:] - gt[1:], axis=1)
    ate = float(np.sqrt(np.mean(errs ** 2)))
    kfs = [i for i, s in enumerate(shells) if s.is_kf]
    kfs_s = [i for i, s in enumerate(shells_s) if s.is_kf]
    diff = float(np.mean(np.linalg.norm(est - est_s, axis=1)))
    travelled = float(np.linalg.norm(est_s[-1] - est_s[0]))
    print(f"pipelined: FPS synchronous {' / '.join(f'{x:.3f}' for x in fps['synchronous'])} "
          f"(median {np.median(fps['synchronous']):.3f}), pipelined "
          f"{' / '.join(f'{x:.3f}' for x in fps['pipelined'])} (median "
          f"{np.median(fps['pipelined']):.3f}); turns s, p, p, s, s, p, p, s, {E2E_FRAMES} "
          f"frames each, same process", flush=True)
    for mode in cfgs:
        print(f"pipelined: blocking waits per call, {mode}: {waits[mode]}", flush=True)
    print(f"pipelined: keyframes {len(kfs)} at {kfs} (synchronous {len(kfs_s)} at "
          f"{kfs_s}); ATE {ate:.4f} m over {path:.2f} m ({100 * ate / path:.3f}%); mean "
          f"translation difference to the synchronous pass {diff:.4f} m "
          f"({100 * diff / travelled:.2f}% of {travelled:.2f} m); pl_escalations "
          f"{fe.pl_escalations}, pl_retracks {fe.pl_retracks}", flush=True)
    print(f"pipelined kernel launches: {launches}; K2-LM per frame "
          f"{launches['track_lm'] / E2E_FRAMES:.3f} (synchronous pass: "
          f"{node_s.timers.count('track')} track spans); track "
          f"{node.timers.average_ms('track'):.3f} ms x {node.timers.count('track')} (synchronous "
          f"{node_s.timers.average_ms('track'):.3f} ms x {node_s.timers.count('track')})",
          flush=True)
    if not fe.initialized or fe.is_lost or fe.init_failed or resets:
        fail(f"pipelined: initialized={fe.initialized} lost={fe.is_lost} "
             f"init_failed={fe.init_failed} resets at {resets}")
    if fe._pl_inflight is not None:
        fail("pipelined: a frame is still in flight after finish")
    if not np.all(np.isfinite(est)) or not ate < 0.02 * path:
        fail(f"pipelined: ATE {ate:.4f} m >= 2% of {path:.2f} m")
    if abs(len(kfs) - len(kfs_s)) > 2:
        fail(f"pipelined: {len(kfs)} keyframes against {len(kfs_s)} synchronous")
    if not diff < 0.05 * travelled:
        fail(f"pipelined: mean difference {diff:.4f} m >= 5% of {travelled:.2f} m")
    if fe.pl_retracks < 1:
        fail("pipelined: no keyframe flush retracked the frame in flight")
    gate_launches("pipelined", launches, E2E_KERNELS)
    return launches


MONO_FRAMES = 40


def mono_sequence(dev):
    """test_mono_frontend_e2e.py's 40 poses rendered at KITTI size (12
    sideways frames, then forward with a slight lateral drift) and the
    DSO-mode configuration: the monocular bootstrap, no stereo scale."""
    import dataclasses

    from direct_stereo_slam_tpu_torch.config import make_config
    from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
    from direct_stereo_slam_tpu_torch.io.synthetic import SyntheticStereoDataset

    n = MONO_FRAMES
    ds = SyntheticStereoDataset(n_frames=n, width=W, height=H, speed=0.0, device=dev)
    poses, T = [], np.eye(4, dtype=np.float32)
    for i in range(n):
        poses.append(T.copy())
        T = T.copy()
        T[0, 3] += 0.12 if i < 12 else 0.04
        T[2, 3] += 0.03 if i < 12 else 0.1
    ds.poses = np.stack(poses)
    t0 = time.perf_counter()
    frames = [ds.frame(i) for i in range(n)]
    print(f"mono: rendered {n} frames {W}x{H} in {time.perf_counter() - t0:.2f} s (set-up)",
          flush=True)
    cfg = make_config(W, H, preset=0, mode=1)
    cfg = cfg.replace(scale_opt=dataclasses.replace(cfg.scale_opt, accept_thres=-1.0),
                      runtime=dataclasses.replace(cfg.runtime, mono_initializer=True))
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H,
                                   cfg.tracker.pyr_levels)
    return ds, frames, cfg, intr


def quantised(img, dither_seed=None):
    """An image as a camera or dataset reader gives it: cut to uint8
    (truncating, as QuantisedFrames), after a +-0.5 gray-level dither
    when a seed is given."""
    if dither_seed is not None:
        img = img + np.random.RandomState(dither_seed).uniform(-0.5, 0.5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def mono_run(torch, dev, seq, left):
    """One DSO-mode pass of a fresh SLAMNode (zeros for the right image:
    DSO mode never reads it); ``left(i, frame)`` gives the left image.
    Returns the pass's figures and kernel launches."""
    from direct_stereo_slam_tpu_torch.runtime.eval import ate_rmse
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    ds, frames, cfg, intr = seq
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    node = SLAMNode(cfg, intr, intr, ds.t_cam1_cam0, device=dev)
    zeros = np.zeros_like(frames[0]["img1"])
    shells, resets, boot_ms, snap = [], [], [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        fe = node.frontend
        tracking = fe.mono_state is not None
        t1 = time.perf_counter()
        shells.append(node.process(left(i, f), zeros, 0.1 * i))
        if tracking and not node.frontend.initialized:
            boot_ms.append(1e3 * (time.perf_counter() - t1))   # is_done read the card
        if node.frontend is not fe:
            resets.append((i, "lost" if fe.is_lost else "init failed"))
        if snap is None and node.frontend.initialized:
            snap = i
    node.finish()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    idx = [i for i, s in enumerate(shells) if s.tracking_ref_kf >= 0 or s.is_kf]
    ate = None
    if len(idx) >= 3:
        # the bootstrap hand-off frame is left out, as the test does
        est = np.stack([shells[i].T_wc[:3, 3] for i in idx])[1:].astype(np.float64)
        ate = ate_rmse(est, ds.poses[idx][1:, :3, 3].astype(np.float64), align="sim3")
    return dict(snap=snap, resets=resets, boot_ms=boot_ms, dt=dt, ate=ate, tracked=len(idx),
                fe=node.frontend, launches={n: fn.launches for n, fn in counters.items()})


def mono_summary(tag, r) -> str:
    return (f"{tag}: {MONO_FRAMES} frames in {r['dt']:.2f} s ({MONO_FRAMES / r['dt']:.3f} FPS); "
            f"keyframe 0 made at frame {r['snap']}; {len(r['boot_ms'])} bootstrap frames, "
            f"{np.mean(r['boot_ms']) if r['boot_ms'] else 0:.2f} ms per bootstrap frame "
            f"(median {np.median(r['boot_ms']) if r['boot_ms'] else 0:.2f}); keyframes "
            f"{len(r['fe'].kf_shells)}; tracked frames {r['tracked']}; Sim(3) ATE {r['ate']} m; "
            f"resets {r['resets']}")


def mono_phase(torch, dev):
    """DSO mode on the mono sequence, its frames cut to uint8 as a camera
    gives them. Returns the run's kernel launches."""
    from direct_stereo_slam_tpu_torch.models import mono_init
    from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid

    seq = mono_sequence(dev)
    r = mono_run(torch, dev, seq, lambda i, f: quantised(f["img0"]))
    print(mono_summary("mono", r), flush=True)
    print(f"mono kernel launches: {r['launches']}", flush=True)
    # one bootstrap step alone: the time for the host to queue it against
    # the time until the card has run it (equal: the host is the bound)
    _, frames, cfg, intr = seq
    pyrs = [build_pyramid(torch.as_tensor(quantised(frames[i]["img0"]), device=dev).float(),
                          cfg.tracker.pyr_levels) for i in (0, 1)]
    state = mono_init.create(pyrs[0], cfg, budget=cfg.ba.max_immature_per_frame)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mono_init.track_frame(state, tuple(pyrs[1].data), intr, cfg)
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        done = time.perf_counter() - t0
    print(f"mono: one track_frame: queued by the host in {1e3 * queued:.2f} ms, run by "
          f"the card {1e3 * done:.2f} ms after its start", flush=True)
    fe, cfg = r["fe"], seq[2]
    if r["snap"] is None or r["snap"] > cfg.runtime.mono_init_max_frames:
        fail(f"mono: not initialized within {cfg.runtime.mono_init_max_frames} frames")
    if fe.is_lost or fe.init_failed or r["resets"]:
        fail(f"mono: lost={fe.is_lost} init_failed={fe.init_failed} resets {r['resets']}")
    if len(fe.kf_shells) < 3:
        fail(f"mono: only {len(fe.kf_shells)} keyframes")
    if r["ate"] is None or not r["ate"] < 0.35:
        fail(f"mono: Sim(3) ATE {r['ate']} m, not < 0.35 m")
    gate_launches("mono", r["launches"], MONO_KERNELS)
    return r["launches"]


def mono_sweep(torch, dev) -> None:
    """The mono sequence in other inputs (reported, not gated): the float
    render itself and six +-0.5 gray-level dithers before the uint8 cut.
    The bootstrap is ulp-sensitive (ROADMAP §3)."""
    seq = mono_sequence(dev)
    inputs = [("float", lambda i, f: f["img0"])] + [
        (f"uint8 dither {d}", lambda i, f, d=d: quantised(f["img0"], 100 * d + i))
        for d in range(6)]
    for tag, left in inputs:
        print(mono_summary(f"mono sweep, {tag}", mono_run(torch, dev, seq, left)), flush=True)


def undistort_phase(torch, dev):
    """The Undistorter on the real-format fixture (tests/fixtures/realformat:
    PGM frames, RadTan camera.txt with crop, pcalib gamma, 16-bit
    vignette) on the card against the same call on the CPU."""
    import os

    from direct_stereo_slam_tpu_torch.io.dataset import StereoDirDataset
    from direct_stereo_slam_tpu_torch.io.undistort import Undistorter
    from direct_stereo_slam_tpu_torch.utils import calib

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                       "realformat")
    cam = calib.build_rectified_camera(os.path.join(fix, "camera.txt"))
    binv = calib.parse_gamma(os.path.join(fix, "pcalib.txt"))
    vig = calib.parse_vignette(os.path.join(fix, "vignette.png"))
    ds = StereoDirDataset(os.path.join(fix, "image_0"), os.path.join(fix, "image_1"))
    raws = [ds.frame(i)[k].astype(np.uint8) for i in range(len(ds)) for k in ("img0", "img1")]
    card = Undistorter(cam, binv=binv, vignette=vig, device=dev)
    host = Undistorter(cam, binv=binv, vignette=vig, device="cpu")
    err = max(float(torch.max(torch.abs(card(r).cpu() - host(r)))) for r in raws)
    ms = median_ms(torch, lambda: card(raws[0]))
    print(f"undistort: {len(raws)} frames {raws[0].shape[1]}x{raws[0].shape[0]} -> "
          f"{cam.w}x{cam.h} (gamma, vignette, RadTan remap): card vs CPU max abs "
          f"{err:.3g} gray levels; {ms:.4f} ms per frame on the card (uint8 upload "
          f"included)", flush=True)
    if not err <= 1e-3:
        fail(f"undistort: card and CPU differ by {err} gray levels")


# the kernels each path must launch; the per-pass K2, K3 and K4 must not
# (the tracker, the scale optimizer and the loop estimator run K2-LM,
# K3-LM and K4-LM on the card)
E2E_KERNELS = ("distance_map", "track_lm", "scale_lm")
LOOP_KERNELS = E2E_KERNELS + ("loop_pose_lm",)
# DSO mode makes no stereo scale optimization
MONO_KERNELS = ("distance_map", "track_lm")
OFF_PATH = ("pose_residual_pass", "scale_residual_pass", "pose3d_residual_pass")


def kernel_counters():
    from direct_stereo_slam_tpu_torch.ops import distance_map as dm
    from direct_stereo_slam_tpu_torch.ops import resident_lm as rlm
    from direct_stereo_slam_tpu_torch.ops import residual_hb as rh

    return {"distance_map": dm.build_distance_map_cuda,
            "pose_residual_pass": rh.pose_residual_pass_cuda,
            "scale_residual_pass": rh.scale_residual_pass_cuda,
            "pose3d_residual_pass": rh.pose3d_residual_pass_cuda,
            "track_lm": rlm.track_lm_cuda,
            "scale_lm": rlm.scale_lm_cuda,
            "loop_pose_lm": rlm.loop_pose_lm_cuda}


def gate_launches(tag, launches, needed):
    for name in needed:
        if launches[name] <= 0:
            fail(f"{tag}: kernel {name} was never launched on the main path")
    for name in OFF_PATH:
        if launches[name] != 0:
            fail(f"{tag}: the per-pass kernel {name} ran {launches[name]} times")


class QuantisedFrames:
    """Pre-rendered frames as a dataset reader gives them after PNG
    decoding: images cut to uint8 as scripts/gen_longseq.py writes them
    (np.clip(img, 0, 255).astype(np.uint8), truncating)."""

    def __init__(self, frames):
        self.frames = [dict(f, img0=quantised(f["img0"]), img1=quantised(f["img1"]))
                       for f in frames]

    def __len__(self):
        return len(self.frames)

    def frame(self, i):
        return self.frames[i]


def loop_phase(torch, dev, n_frames: int, loop_margin: int, gate: bool = True,
               pipelined: bool = False):
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
    cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, loop_margin=loop_margin),
                      runtime=dataclasses.replace(cfg.runtime, pipelined_tracking=pipelined))

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
    tag = f"loop {n_frames} (margin {loop_margin}{', pipelined' if pipelined else ''})"
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
    table = timing_table(node.timers)
    scale_ms, scale_n = table.get("scale_opt", (float("nan"), 0))
    if "direct_est" in table:
        ms, n = table["direct_est"]
        print(f"{tag}: direct_est {ms:.3f} ms per try x {n}, K4-LM launches per try "
              f"{launches['loop_pose_lm'] / max(n, 1):.2f}; track "
              f"{table['track'][0]:.3f} ms per frame x {table['track'][1]}; scale_opt "
              f"{scale_ms:.3f} ms per keyframe x {scale_n}", flush=True)
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
    gate_launches(tag, launches, LOOP_KERNELS)
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
                    help="also run the 160-frame loop phase pipelined, the "
                         "320-frame loop protocol and longer KITTI-size "
                         "sequences on the card and on the host CPU (reported, "
                         "not gated)")
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
    # each path's kernels count in that path's run: K1, K2-LM and K3-LM in
    # the e2e pass, K4-LM in the loop phase; the per-pass K2, K3 and K4 run
    # on none of the paths (every phase gates that they stay at 0)
    launches = e2e_phase(torch, dev, args.profile)
    pl_launches = pipelined_phase(torch, dev)
    mono_launches = mono_phase(torch, dev)
    undistort_phase(torch, dev)
    loop_launches = loop_phase(torch, dev, LOOP_FRAMES, LOOP_MARGIN)
    if args.long:
        mono_sweep(torch, dev)
        loop_phase(torch, dev, LOOP_FRAMES, LOOP_MARGIN, gate=False, pipelined=True)
        loop_phase(torch, dev, 320, 100, gate=False)
        long_phase(torch, dev)
    launches.update(loop_pose_lm=loop_launches["loop_pose_lm"],
                    pose3d_residual_pass=loop_launches["pose3d_residual_pass"])
    for r in rows:
        name = r["name"].split("[")[0]
        r["launches"] = launches[name]
        r["pipelined_launches"] = pl_launches[name]
        r["pipelined_launches_per_frame"] = pl_launches[name] / E2E_FRAMES
        r["mono_launches"] = mono_launches[name]
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "direct_stereo_slam_tpu"))
    if leaked:
        fail(f"the port pulled in JAX or the JAX package: {leaked[:5]}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
