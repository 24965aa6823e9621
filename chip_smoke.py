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
   time per call of
   each (CUDA events), with its bound (bytes over 3.35 TB/s or f32
   operations over 67 TFLOP/s, the larger), the card's own time per call
   of K1 and the LM kernels (the calls queued behind a spin of the card,
   so that the host's issue time drops out), the LM kernels' phase
   counters, and K3-LM's host part (its issue while the card is busy,
   its parameter struct built afresh and filled from the prototype);
   then K2-LM and K3-LM over S = 8 and 11 rendered sequences in one
   launch (the batched step's form: one candidate, one guess per
   sequence, each with its own template and pyramid): every sequence's
   rows bit-equal to a launch on that sequence alone, and held to the
   Python loops per sequence by the same rule; times of the one
   launch, of the S single launches and of the plain loops;
4. the port's SLAMNode end to end on a rendered 40-frame 1232x368
   sequence (preset 0, mode 1): initialised, never lost, >= 3 keyframes,
   translation ATE < 2% of the path length, K1, K2-LM and K3-LM each
   launched during the timed pass and the per-pass K2 and K3 never. A
   first pass with a device synchronize at the end of every span gives
   the per-stage table; FPS, ``track`` per frame, ``scale_opt`` and
   ``activate`` per keyframe come from the second pass, without them; a
   third pass counts the blocking waits per call (a keyframe call may
   wait a median of 3 times at most: the tracker's read and bundle 3); a
   fourth splits the ``activate`` span into its parts (``act_split``:
   the host pose math, the state reads and ``inv_ex``, the projection's
   plain launches, K1's, K12's and K13's wrappers, the rest) and a fifth
   the ``template`` span (``template_split``: the window's pose prep,
   the plain per-point projection, K15's wrapper, the rest, beside K15's
   card time); then the
   activation kernels (csrc/activate.cu) on that pass's fullest
   activation (the call with the most valid candidates: 8 slots of 1024,
   budget 256, a pool of 4096): K12 against its plain version (``drop``
   and ``lane`` equal; ``ok`` and the accepted idepths, rel 1e-4, equal
   but on edge lanes, counted, at most 1% of the accepted lanes), its
   LM warps the sum over slots of min(survivors, budget); K13 bit-equal
   to its plain version on that call, with every participating slot's
   own segment full and with the pool all but full; two runs of each
   bit-equal; each timed (its card time too) with its bound, its phase
   stamps and ptxas's registers, shared memory and spills; then the
   trace and template kernels on that pass's calls (the pass gates one
   K14 launch a traced frame and one K15 launch a template): K14
   (csrc/trace.cu) on the fullest full-shape trace, the fullest
   steady-tier trace and the full one with its budget at half its
   searching lanes (an overflow), K15 (csrc/template.cu) on the fullest
   template in both modes (state mode, the path's, which projects the
   points in its launch, and points mode), each against its plain version
   (K14: the statuses, the compacted lanes, n_search and n_overflow
   equal, idepth_min, idepth_max, quality and pixel_interval bit-equal;
   K15: every level's lists bit-equal), two runs bit-equal, timed (the wrapper, the card's
   own time, the plain version) with its bound from the call's own data,
   its phase stamps and ptxas's registers and spills;
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
8. the reference's own inputs and outputs, on the e2e sequence cut to
   uint8, each gating K1, K2-LM and K3-LM launched and the per-pass
   kernels not: *bag*, the 40 pairs written as a rosbag uncompressed and
   bz2 and replayed through SLAMNode in turns with the frames from
   memory (40 pairs fired, ATE < 2% of the path, keyframes within 1 of
   memory; read + decode ms per pair, FPS), then ``run_slam --bag
   --live --debug-dir`` as a user runs it (exit 0, trajectories, page and
   images written); *live*, the pairs published at 10 Hz over loopback
   TCPROS into ``StereoTopicSource`` -> ``SLAMNode.process`` (all 40
   processed, ``close()`` raises nothing, ATE < 2%, waits counted on the
   source's thread; lag publish -> end of process, deepest queue, FPS);
   *resume*, under ``torch.use_deterministic_algorithms``: two
   uninterrupted runs A, A2 with a threaded LoopHandler, B stopped at
   frame 20 and saved (front end and handler), C loaded from it into a
   fresh node for frames 20-39 (state on the card, keyframes within 1 of
   A, every position within the A-A2 spread + 1e-3 m; save / load ms and
   bytes), then a checkpoint the host CPU wrote resumed on the card for 5
   frames; *observe*, the live viewer and the debug images on and off in
   turns (FPS of each; a window and an idepth PNG per tracked keyframe,
   a residual PNG per other frame, live.html with every tracked frame's
   pose and a depth pane; blocking waits per benign frame the same on
   as off);
9. loop closure: the port's SLAMNode with its threaded LoopHandler (as
   ``run_slam`` runs them) over 160 frames (2 laps at 4.5 deg/frame) of
   the loop room at 1232x368, images quantised to uint8, loop_margin 40:
   at least one verified loop, the loop-closed (dslam) ATE below the
   odometry (sodso) ATE, K1, K2-LM, K3-LM, K4-LM and the pose graph's K7
   (one launch a dense optimize) each launched during the run and the
   per-pass K2, K3 and K4 never; ``direct_est`` per try, ``scale_opt`` per keyframe. A failure
   in the loop thread fails the run (the handler re-raises it when it is
   drained). Then the final pose graph alone, optimized by the plain
   version and by the kernels in turns (plain, kernels, kernels, plain:
   the two kernel runs bit-equal), and a few of the run's own graphs
   replayed through both (ms per ``pose_graph_opt`` call, before and
   after);
10. on the e2e frames cut to uint8 (with phase 8): *native*, the 40 pairs
   as PGM files read by the native prefetching loader
   (``NativeStereoLoader``) and by the synchronous reader
   (``StereoDirDataset``) into SLAMNode, in turns: frames bit-equal to
   each other and to memory, ATE < 2% of the path, keyframes within 1,
   FPS and blocking waits per frame of both; *eval*, ``gen_longseq``
   renders 80 frames of the loop room at 1232x368 into the KITTI layout
   and ``eval_kitti --config odometry`` reads it back as a new process:
   exit 0, results.json, keyframes within 1 of an in-memory run of the
   same uint8 frames, ATE < 2% of the path, K1, K2-LM and K3-LM launched
   by that process (its counts, printed by the process);
11. batch evaluation over sequences: ``run_batch`` at 1232x368, 5
   levels, S = 1, 8 and 11 sequences of 20 frames (11 = KITTI 00-10,
   BASELINE config 5), the 19 steps' inputs built once and stepped
   through in 40 passes (a timed window of seconds): exactly one K2-LM
   and one K3-LM launch per step and no other kernel, a finite pose for
   every sequence; aggregate and per-sequence FPS, the median and range of
   the passes' FPS, median translation and rotation errors;
12. the pose graph (K6-K8, csrc/pose_graph.cu): ring graphs at buckets
   16, 128, 256, 512 (dense: one K7 launch an optimize) and 1024 (CG: one
   launch of K8's redesign, the resident CG optimize), each ``optimize``
   within 1e-4 of ``optimize_plain`` (1024, both
   CG: 2e-3 x the translation scale), two runs bit-equal, launches per
   optimize, ms of both (the card's ms of K7 too), and K7's phase split
   per iteration (``ops/pose_graph.GN_STAMPS``: edges, assembly, panel
   factorization, trailing update, the solves, the grid barriers, by
   %globaltimer stamps) beside the dense optimize as one K7 launch per
   iteration (in turns); the cost of one grid barrier; then each kernel
   against its plain version at the loop phase's final graph (K6's blocks
   within 1e-4 x max|entry|, or, where f32 cancels next to a Lie branch
   point, no further from the float64 blocks than 2x the plain version;
   K7 stopped after an iteration's assembly: its edge phase bit-equal to
   K6, the system's H within 1e-4 x max|entry| and its b within 1e-4 x
   the largest sum of its terms' magnitudes of the index_add_ form, and
   bit-equal to its fixed-order plain form; stopped after the solve at
   the final graph and at buckets 16, 128 and 512: x within 1e-5 x max|x|
   of ``_solve_dense_fixed`` and no further from a float64 solve than 2x
   ``solve_ex``'s error) and at bucket 1024 (K8, within 1e-3 of
   ``_solve_cg``, with its phase stamps: set-up, edge pass, node pass,
   update, cluster barriers), timed, with ``solve_ex`` on the same systems
   as K7's library time; the resident CG optimize at bucket 1024, 16 runs
   bit-equal (poses and CG steps), bit-equal to the queued K6 -> K8 chain
   and within 1e-3 x the translation scale of
   ``optimize_plain(solver="cg")``, the card's ms in turns (one launch
   against the chain), its phase stamps per CG step and
   its CG steps; and the device kernels per optimize of the plain, dense
   and CG paths (torch.profiler, one session: the dense path is one K7
   launch, the CG path one launch).

13. the windowed BA (K9-K11, csrc/ba.cu), on the e2e run's fullest
   keyframe window (its ``optimize_keyframe`` arguments kept during the
   timed pass), at the compact view of 2560 points and the full pool:
   K9 against ``linearize_plain`` (Hff, bf, Hfd, Hdd, bd within 1e-4 x
   max|entry| or, where a sum cancels, x the largest sum of its terms'
   magnitudes, ``linearize_plain(magnitudes=True)``; pair_good / pair_in equal except on lanes within 1e-5 of
   their energy threshold, two calls bit-equal), K10 against
   ``solve_step`` / ``_step_converged`` / ``apply_step`` on K9's
   linearization (x, x_d within 1e-3 x max|entry|, the same convergence),
   K11's starting energy against ``total_energy`` (rel 1e-5) and its
   decision on the candidate (the same, unless the margin is within 1e-5),
   each timed with its bound (``solve_ex`` on the damped system as K10's
   library time); then the whole ``optimize_keyframe`` on the card
   against the plain BA (the loop and ``linearize_plain``, no K9-K11) on
   the same card state (poses within 1e-3 per
   entry, rmse rel 1e-3, the same ok; or the same against the plain loop
   on the reversed point pool, where the plain loop's own accept margins
   decide), two card runs bit-equal, one under
   ``set_sync_debug_mode("error")``, its launches (one resident launch,
   no queued K9-K11) and ms; the resident launch (``dsslam_ba_optimize``)
   at both views bit-equal to the queued K9 / K11, K10 -> K9 -> K11 chain
   and ``_finish_optimize`` (state, linearization, bookkeeping, control),
   the card's ms of the two in turns, its grid and its phase stamps; and,
   in a new process
   (``--ba-split``, one torch.profiler session of its own), the card time
   of each of K9's and K10's sub-launches at both views of the window,
   with the kernels' registers, shared memory and spills as ptxas
   reported them, and ``optimize_keyframe``'s host split (run right
   after phase 4);
13b. the BA's state programs (csrc/window.cu) on the same window and on
   the e2e run's fullest keyframe tail (its ``ba.marginalize`` arguments
   kept during the timed pass): K16 ``window_pose`` bit-equal to
   ``window_pose_plain``; K17 (``optimize_keyframe``: the prologue, the
   resident launch, the epilogue) bit-equal to ``optimize_keyframe_plain``
   around the same resident launch; K18 ``marginalize``'s validity and
   bookkeeping bit-equal to ``marginalize_plain``, its points stage's HM /
   bM within 1e-5 of the largest entry of the change it made (K18_TOL),
   the whole call no further from float64 frame marginalizations of its
   points stage than twice the plain version plus 1e-5 of the largest
   entry; two runs of each bit-equal; each timed against its plain
   version in turns, with its card time, its wrapper's host ms, its bound
   and ptxas's registers. The e2e phase counts their launches per frame
   (one K18 a keyframe tail), splits the ``point_marg`` / ``frame_marg``
   spans into the host's numpy and the device program's calls
   (``marg_split``) and the ``scale_opt`` span into the right image's
   upload, its pyramid, K3-LM's wrapper and the rest, with K3-LM's card
   time (``scale_split``);
14. ``ab_policies`` as a new process at the JAX package's 320x96, 80
   frames (``AB_CHILD``, each arm's launches counted in it): exit 0 within
   600 s (the force-accept arm's NaN poses reach the BA's kernels without
   a crash or a hang), K2-LM, K3-LM, K9 and the resident BA launch
   launched in every arm, the
   fast-rotation arms' K4-LM / K6 launches printed, the table beside the
   JAX package's; then two witnesses of the force-accept fast-rotation
   arm, printed beside it, not gated: the port with the plain BA on the
   card, and the port on the host CPU (run with phase 10).

The e2e phase also counts the host's blocking waits per call (every
site of a keyframe call's waits printed) and times
the path with ``torch.use_deterministic_algorithms`` off and on in turns;
the loop phase runs three more times after its gated run (deterministic
algorithms on, off with the waits counted, on): the FPS of each mode, the
waits per keyframe call by site (it fails when a keyframe call waits a
mean of more than 2 times, or at all in the loop estimator or the pose
graph's build: the loop thread's designed reads are the try's and the
optimize's, in loop/handler.py), and whether two runs of one mode agree. Every
path that makes keyframes gates K9 and the resident BA launch launched
(the e2e, pipelined, mono, bag, live, resume, observe, native, eval and
loop phases).

K3-LM's calls on the e2e and loop paths are counted by the number of
guesses and by whether a level doubled its cutoff (read after each run).

Options: --profile DIR profiles one more end-to-end pass; --long also
runs the mono sequence on the float render and on six dithered uint8
inputs, the 160-frame loop phase pipelined, the full 320-frame loop
protocol (loop_margin 100), printed beside the JAX package's TPU record
of the same protocol, then an 80-frame loop and a 120-frame forward
sequence at the same size with the error of every frame (reported, not
gated), each of those also through the port on the host CPU, frame by
frame against the card, and the 320-frame protocol through disk
(``gen_longseq`` -> ``eval_kitti --config both``, reported).
--fps [--root DIR] only times the e2e and loop sequences (FPS, the
spans ``activate``, ``trace``, ``template`` and the BA's stages, timed
and with a synchronize at the end of each span, ``pose_graph_opt``,
``icp`` and ``direct_est``, the waits per keyframe call by site, and the
loop phase's loops, keyframes and translation ATE of the odometry and of
the loop-closed trajectory), not gated; with --root, of the port in
another checkout, so that a tree and its parent run in turns in one call;
--fps-variant plain_activation / eager_tail / idepth_ulp_up /
idepth_ulp_down (repeatable, applied in order) times this tree's port
with K12 and K13 replaced by their plain versions on the card, with each
keyframe tail committed at once, or with the activation's idepths moved
one f32 step.
--act [--root DIR] only runs the e2e sequence, the ``activate`` span's
split and the activation kernels' part of phase 4 (K12 / K13 against
their plain versions, timed, with phase stamps; with --root, of the port
in another checkout).
--trace only runs the e2e sequence, the ``template`` span's split and
the trace and template kernels' part of phase 4 (K14 / K15 against their
plain versions, timed, with phase stamps).
--pg-split [--root DIR] only times the dense ``optimize`` on the ring
graphs of buckets 16 ... 512 and the CG ``optimize`` at 1024 (host ms
per call and the card's ms), and, where the port has K7's, K8's and the
resident CG optimize's phase stamps, their split (with --root, of the
port in another checkout).
--ba-window FILE only runs the e2e sequence once and saves its fullest BA
window to FILE; --ba-split FILE [--root DIR] only times K9's and K10's
calls (``device_ms``) and sub-launches (torch.profiler) on that window,
with the kernels' registers and spills, ``optimize_keyframe``'s host
split and card time, and, where the port has it, the resident launch
against the queued chain (with --root, of the port in another checkout:
the parent and a change in turns in one call, each a process of its
own).
--lm-digest [--root DIR] only prints digests of K2-LM's and K3-LM's
single-sequence outputs on seeded inputs and the card's time per call
(with --root, of the port in another checkout: two forms of the kernels
held to the same bits, and timed).

The line before the last is the kernel table as JSON (each row's
launches in the e2e or loop phase, in the last pipelined pass and per
frame of it, in the mono phase and in the bag, live, resume and observe
phases, in the native and eval phases, per step of the batch phase, and
per frame of the loop phase); the last line is
{"ok": true, "device": {...}}. The script imports nothing of JAX nor of
the JAX package, and checks so before its last line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
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


def sm_clock_mhz() -> float:
    """The SM clock nvidia-smi reports now (MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


def lm_phases(torch, rlm, launch, passes=lambda o: o.passes):
    """One call of a resident LM wrapper (``launch(timers=...)``) with its
    phase counters on, converted at the SM clock nvidia-smi reports right
    after it (``passes(out)``: the passes the call ran per candidate and
    level); and the calls' outputs with the counters on and off must be
    the same bits."""
    off = launch()
    first = next(iter(off))                  # [candidates, ...]
    buf = rlm.timer_buffer(first.shape[0], first.device)
    on = launch(timers=buf)
    torch.cuda.synchronize()
    clock = sm_clock_mhz()
    for x, y in zip(off, on):
        if not torch.equal(torch.nan_to_num(x, 7.0), torch.nan_to_num(y, 7.0)):
            fail("the phase counters changed a resident LM kernel's output")
    ph = rlm.phase_breakdown(buf, passes(on), clock)
    ph["kernel_device_ms"] = device_ms(torch, launch)
    return ph


def phase_text(ph) -> str:
    share = lambda d: " ".join(f"{k} {100 * v:.1f}%" for k, v in d.items())
    levels = "; ".join(f"L{l} {d['passes']:.0f} passes {d['us_per_pass']:.3f} us/pass "
                       f"({share(d['shares'])})" for l, d in enumerate(ph["levels"]))
    return (f"{ph['us_per_pass']:.3f} us per pass over {ph['passes']:.0f} passes at "
            f"{ph['clock_mhz']:.0f} MHz (the kernel saw {ph['kernel_mhz']:.0f} MHz), "
            f"phases {share(ph['shares'])}; per candidate {ph['phase_us']:.2f} us in "
            f"phases, {ph['run_us']:.2f} us run, the kernel alone "
            f"{ph['kernel_device_ms']} ms per call on the card; per level: {levels}")


def lm_usage(build_log: str) -> dict:
    """Per resident LM kernel (by its row's name): the registers and the
    bytes of spill stores ptxas reported when it built the library, and
    how many 8-block clusters of it the card holds at once (K2-LM at
    levels of 8192 points, K4-LM at 2048, K3-LM on the front end's
    template of base 8192)."""
    from direct_stereo_slam_tpu_torch.models.depth_template import default_budgets
    from direct_stereo_slam_tpu_torch.ops import resident_lm as rlm

    entries = {"track_lm": ("lm_kernelILb0E", "track", 8192),
               "loop_pose_lm": ("lm_kernelILb1E", "loop_pose", 2048),
               "scale_lm": ("scale_lm_kernel", "scale", 8192)}
    sizes = default_budgets(W, H, LEVELS, base=8192)
    found, current, spill = {}, None, 0
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            current = next((k for k, (m, _, _) in entries.items() if m in line), None)
        elif current and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif current and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split("registers")[0])
            _, kind, n = entries[current]
            found[current] = (regs, spill, rlm.scale_max_active_clusters(sizes)
                              if kind == "scale" else rlm.max_active_clusters(kind, n))
            current = None
    if set(found) != set(entries):
        fail(f"ptxas reported no registers for {sorted(set(entries) - set(found))}")
    return found


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


def queued(torch, fn, calls: int = 20, samples: int = 5):
    """Per sample of ``calls`` calls of fn() queued behind a spin of the
    card (torch.cuda._sleep, ~100 ms), so the host has issued them all
    before the first one runs: (the card's ms per call by CUDA events
    around them, the gaps between back-to-back launches included; the
    host's ms per call to issue them)."""
    fn()
    torch.cuda.synchronize()
    out = []
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
        out.append((start.elapsed_time(end) / calls, 1e3 * issued / calls))
    return out


def device_ms(torch, fn, calls: int = 20, samples: int = 5):
    """The card's own time per call of fn() (``queued``), the median over
    ``samples``; None if the host took longer to issue the calls than half
    the spin."""
    runs = queued(torch, fn, calls, samples)
    if any(issue * calls > 50.0 for _, issue in runs):
        return None
    return statistics.median(card for card, _ in runs)


def host_ms(fn, calls: int = 200) -> float:
    """The host's time per call of fn() (no card work waited for)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return 1e3 * (time.perf_counter() - t0) / calls


def issue_ms(torch, fn) -> float:
    """The host's time to issue one call of fn() while the card is busy
    (``queued``: no launch waits for a free slot), the median."""
    return statistics.median(issue for _, issue in queued(torch, fn))


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


def bits(t):
    """A tensor's bits, for equality (NaN equal to the same NaN)."""
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def rel_err(torch, a, b) -> float:
    scale = float(torch.max(torch.abs(b)).clamp(min=1e-30))
    return float(torch.max(torch.abs(a - b))) / scale


def frames64(torch, state, slots) -> dict:
    """HM and bM (float64) after ``ba.marginalize_frame`` of each slot in
    order, computed in float64: the anchor of each step (the oldest valid
    frame) gets the 1e8 prior, the 8x8 block + 1e-8 I is inverted, and the
    slot's rows and columns are zeroed."""
    H, b = state.HM.double().clone(), state.bM.double().clone()
    fv, fid = state.frame_valid.clone(), state.frame_id.clone()
    D = H.shape[0]
    for slot in slots:
        anchor = int(torch.argmin(torch.where(fv, fid, torch.full_like(fid, 2 ** 30))))
        sel = torch.arange(4 + 8 * slot, 12 + 8 * slot, device=H.device)
        keep = torch.ones(D, dtype=torch.bool, device=H.device)
        keep[sel] = False
        if anchor == slot:
            H[sel, sel] += 1e8
        Hbb = H[sel][:, sel] + 1e-8 * torch.eye(8, dtype=H.dtype, device=H.device)
        Hab = H[:, sel] * keep[:, None]
        inv = torch.linalg.inv(Hbb)
        H = (H - Hab @ inv @ Hab.T) * (keep[:, None] & keep[None, :])
        b = (b - Hab @ (inv @ b[sel])) * keep
        fv[slot], fid[slot] = False, -1
    return {"HM": H, "bM": b}


def change_err(torch, got, want, base) -> float:
    """max|got - want| over the largest entry of the change ``want - base``
    (in float64): the error against what the call changed, not against a
    large prior it kept."""
    d = float(torch.max(torch.abs(want.double() - base.double())).clamp(min=1e-30))
    return float(torch.max(torch.abs(got.double() - want.double()))) / d


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
    rows += seq_lm_rows(torch, dev)
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
          f"{rlm.scale_max_active_clusters(dt.default_budgets(W, H, LEVELS))} / "
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
            dev_ms = device_ms(torch, lambda: tr.track_candidates_batch(*args))
            ph = lm_phases(torch, rlm, partial(rlm.track_lm_cuda, *args))
            passes = o.passes.cpu().numpy()
            n_bytes, n_ops = lm_bytes_ops(sizes, passes, B)
            r = row(f"track_lm[N={base},B={B}]", "resident_lm.cu",
                    "direct_stereo_slam_tpu/models/tracker.py:316", err, ms, pms, n_bytes, n_ops)
            r.update(differ=agr.differ, order_sensitive=agr.sensitive, device_ms=dev_ms,
                     passes_per_call=float(passes.sum(axis=1).mean()),
                     us_per_pass=ph["us_per_pass"], phase_shares=ph["shares"],
                     sm_clock_mhz=ph["clock_mhz"])
            rows.append(r)
            print(f"{tag}: {agr}; passes per candidate per level (mean) "
                  f"{passes.mean(axis=0).round(1).tolist()}; kernel {ms:.4f} ms (on the "
                  f"card {dev_ms} ms), plain loop {pms:.4f} ms, loop over K2 passes "
                  f"{loop_ms:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})",
                  flush=True)
            print(f"{tag}: phase counters: {phase_text(ph)}", flush=True)

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
            dev_ms = device_ms(torch, lambda: pe.estimate_seeds(*args))
            ph = lm_phases(torch, rlm, partial(rlm.loop_pose_lm_cuda, *args))
            passes = o.passes.cpu().numpy()
            n_bytes, n_ops = lm_bytes_ops([kmax] * LEVELS, passes, S)
            r = row(f"loop_pose_lm[k={k},S={S}]", "resident_lm.cu",
                    "direct_stereo_slam_tpu/loop/pose_estimator.py:217", err, ms, pms,
                    n_bytes, n_ops)
            r.update(differ=agr.differ, order_sensitive=agr.sensitive, device_ms=dev_ms,
                     passes_per_call=float(passes.sum(axis=1).mean()),
                     us_per_pass=ph["us_per_pass"], phase_shares=ph["shares"],
                     sm_clock_mhz=ph["clock_mhz"])
            rows.append(r)
            print(f"{tag}: {agr}; passes per seed per level (mean) "
                  f"{passes.mean(axis=0).round(1).tolist()}; kernel {ms:.4f} ms (on the "
                  f"card {dev_ms} ms), plain loop {pms:.4f} ms, loop over K4 passes "
                  f"{loop_ms:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})",
                  flush=True)
            print(f"{tag}: phase counters: {phase_text(ph)}", flush=True)
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
                reordered = lma.reordered_scale_runs(args, loops)
                agr = lma.check(got, refs, reordered)
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
                ph = lm_phases(torch, rlm, partial(rlm.scale_lm_cuda, *args), lambda o: o.run)
                # the wrapper's host part: its issue while the card is busy,
                # the parameter struct built afresh, and the prototype's copy
                # with the call's pointers that a call makes
                out = torch.empty(G, rlm.SCALE_OUT, device=dev)
                host = dict(issue_ms=issue_ms(torch, lambda: so.optimize_scale_batch(*args)),
                            struct_ms=host_ms(lambda: rlm.scale_lm_params(*args, out)),
                            fill_ms=host_ms(lambda: rlm._scale_params(*args, out)))
                passes, run = o.passes.cpu().numpy(), o.run.cpu().numpy()
                n_bytes, n_ops = lm_bytes_ops(budgets, run, G, SCALE_PASS_OPS, 4 + 112)
                r = row(f"scale_lm[N={base},G={G},{kind}]", "resident_lm.cu",
                        "direct_stereo_slam_tpu/models/scale_opt.py:169", err, ms, pms,
                        n_bytes, n_ops)
                r.update(differ=agr.differ, order_sensitive=agr.sensitive, device_ms=dev_ms,
                         passes_per_call=float(run.sum(axis=1).mean()),
                         reference_passes_per_call=float(passes.sum(axis=1).mean()),
                         us_per_pass=ph["us_per_pass"], phase_shares=ph["shares"],
                         sm_clock_mhz=ph["clock_mhz"], **host)
                rows.append(r)
                print(f"{tag}: {agr}; passes per guess per level (mean) run "
                      f"{run.mean(axis=0).round(1).tolist()} of the reference's "
                      f"{passes.mean(axis=0).round(1).tolist()}, cutoff doublings "
                      f"{o.repeat.cpu().numpy().max(axis=0).tolist()}; decision "
                      f"{dec[0][0]}, scale {dec[0][2][0]:.4f}, error {dec[0][2][1]:.4f}; "
                      f"kernel {ms:.4f} ms (on the card {dev_ms} ms), plain loop "
                      f"{pms:.4f} ms, loop over K3 passes "
                      f"{loop_ms:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}); "
                      f"host: issue {host['issue_ms']:.4f} ms "
                      f"per call, struct {host['struct_ms']:.4f} ms afresh, "
                      f"{host['fill_ms']:.4f} ms from the prototype", flush=True)
                print(f"{tag}: phase counters: {phase_text(ph)}", flush=True)
    return rows


def e2e_profile(torch, run_once, out_dir: str) -> None:
    """One more end-to-end pass under torch.profiler: device busy share of
    the pass, device time by kernel, and the hand-written kernels' share
    (full table written to out_dir)."""
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
                             "scale_final", "distance_kernel", "lm_kernel", "lin_pair_kernel",
                             "lin_finish_kernel", "step_kernel", "accept_kernel"))]
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
    with ScaleTraffic() as traffic, BaTraffic() as ba_traffic, ActTraffic() as act_traffic, \
            TraceTraffic() as trace_traffic, MargTraffic() as marg_traffic:
        node, shells, resets, dt = run_sequence(torch, SLAMNode, cfg, intr, ds,
                                                frames, dev)
    launches = {name: fn.launches for name, fn in counters.items()}
    n_trace, n_tmpl = len(trace_traffic.trace), len(trace_traffic.template)
    print(f"e2e: K14 launches {launches['trace_points_all_compact']} for {n_trace} traced "
          f"frames ({node.timers.count('trace')} trace spans, "
          f"{sum('max_reach' in kw for _, kw in trace_traffic.trace)} on the steady tier), "
          f"{launches['trace_points_all_compact'] / E2E_FRAMES:.3f} per frame; K15 launches "
          f"{launches['build_template']} for {n_tmpl} templates", flush=True)
    if launches["trace_points_all_compact"] != n_trace or launches["build_template"] != n_tmpl:
        fail(f"e2e: K14 {launches['trace_points_all_compact']} launches for {n_trace} traces, "
             f"K15 {launches['build_template']} for {n_tmpl} templates (one a call)")
    scale_calls = traffic.summary()

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
    print(f"e2e: K3-LM calls by guesses (calls, those with a doubled cutoff, the "
          f"largest doubling factor): {scale_calls}", flush=True)
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
    n_kf = node.timers.count("dso_opt")
    print(f"e2e: BA launches per keyframe ({n_kf} optimize_keyframe calls): " + ", ".join(
        f"{k} {launches[k] / max(n_kf, 1):.2f}" for k in BA_ROWS), flush=True)
    print(f"e2e: activate {node.timers.average_ms('activate'):.3f} ms per keyframe x "
          f"{node.timers.count('activate')} (timed pass; synchronized first pass: "
          f"{node1.timers.average_ms('activate'):.3f} ms); launches per keyframe: "
          + ", ".join(f"{k} {launches[k] / max(n_kf, 1):.2f}"
                      for k in ("distance_map",) + ACT_KERNELS), flush=True)
    print(f"e2e: K16-K18 launches per frame ({E2E_FRAMES} frames, {n_kf} keyframes, "
          f"{len(marg_traffic.calls)} keyframe tails): " + ", ".join(
              f"{k} {launches[k] / E2E_FRAMES:.3f} ({launches[k] / max(n_kf, 1):.2f} per "
              f"keyframe)" for k in WINDOW_KERNELS), flush=True)
    if launches["marginalize"] != len(marg_traffic.calls):
        fail(f"e2e: K18 {launches['marginalize']} launches for {len(marg_traffic.calls)} "
             f"keyframe tails (one a tail)")
    waits = count_waits(torch, cfg, intr, ds, frames, dev)
    print(f"e2e: blocking waits per call: {waits}", flush=True)
    act_traffic.split = activate_split(torch, dev, cfg, intr, ds, frames)
    trace_traffic.split = template_split(torch, dev, cfg, intr, ds, frames)
    marg_traffic.split = marg_split(torch, dev, cfg, intr, ds, frames)
    marg_traffic.scale = scale_split(torch, dev, cfg, intr, ds, frames)
    # the reference's design: a keyframe call waits for the tracker's read
    # and bundle 3 only (the tail's read hides behind the next frame's)
    if waits.get("keyframe", {}).get("median", 0) > 3:
        fail(f"e2e: a keyframe call waits a median {waits['keyframe']['median']} times (> 3)")
    deterministic_turns(torch, "e2e", E2E_FRAMES, lambda: run_sequence(
        torch, SLAMNode, cfg, intr, ds, frames, dev)[3])
    if profile_dir:
        e2e_profile(torch, lambda: run_sequence(torch, SLAMNode, cfg, intr, ds,
                                                frames, dev), profile_dir)
    return (launches, scale_calls, ba_traffic.calls, n_kf, act_traffic, trace_traffic,
            marg_traffic)


def deterministic_turns(torch, tag, n_frames, run) -> dict:
    """FPS of ``run()`` (its seconds) with torch.use_deterministic_algorithms
    off and on, in turns off, on, on, off: what the deterministic mode
    costs on the path."""
    fps = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        torch.use_deterministic_algorithms(mode == "on")
        try:
            fps[mode].append(n_frames / run())
        finally:
            torch.use_deterministic_algorithms(False)
    off, on = np.mean(fps["off"]), np.mean(fps["on"])
    print(f"{tag}: FPS with torch.use_deterministic_algorithms off "
          f"{' / '.join(f'{x:.3f}' for x in fps['off'])}, on "
          f"{' / '.join(f'{x:.3f}' for x in fps['on'])} (turns off, on, on, off): the "
          f"deterministic mode costs {100 * (off - on) / off:.1f}% of the FPS", flush=True)
    return fps


# ---------------------------------------------------------------------------
# the windowed BA: K9 (linearize), K10 (the LM step), K11 (accept)
# ---------------------------------------------------------------------------

# f32 operations a residual of K9 needs: its warp and bilinear sample
# (~60), the 20-wide Jacobian row (~110), the 210 + 20 products of its
# block and b (~460) and the 22 sums toward Hfd, Hdd, bd (~44)
BA_RES_OPS = 650
BA_COMPACT = 2560                 # cfg.ba.compact_budget at KITTI size


class BaTraffic:
    """The front end's ``optimize_keyframe`` calls on a path: the function
    is wrapped for the run and each call's arguments kept (states are
    never mutated), to be replayed after it."""

    def __init__(self):
        from direct_stereo_slam_tpu_torch.models import ba

        self.ba, self.calls = ba, []

    def __enter__(self):
        self.wrapped = self.ba.optimize_keyframe

        def kept(*a, **kw):
            self.calls.append((a, kw))
            return self.wrapped(*a, **kw)

        self.ba.optimize_keyframe = kept
        return self

    def __exit__(self, *exc):
        self.ba.optimize_keyframe = self.wrapped


class ActTraffic:
    """The front end's activation calls on a path: K12's and K13's entry
    points wrapped for the run, each call's arguments kept (states and
    candidate sets are replaced, never written in place)."""

    def __init__(self):
        from direct_stereo_slam_tpu_torch.ops import activate as act

        self.act, self.gate, self.alloc, self.split = act, [], [], None

    def __enter__(self):
        act = self.act
        self.wrapped = act.gate_compact_activate, act.allocate_insert_consume

        def gate(*a):
            self.gate.append(a)
            return self.wrapped[0](*a)

        def alloc(*a):
            self.alloc.append(a)
            return self.wrapped[1](*a)

        act.gate_compact_activate, act.allocate_insert_consume = gate, alloc
        return self

    def __exit__(self, *exc):
        self.act.gate_compact_activate, self.act.allocate_insert_consume = self.wrapped


class TraceTraffic:
    """The front end's trace and template calls on a path: the entry points
    wrapped for the run (the front end's own name of
    ``build_template_from_state``), each call's arguments kept (candidate
    sets and BA states are replaced, never written in place)."""

    def __init__(self):
        from direct_stereo_slam_tpu_torch.models import frontend, immature

        self.fe, self.imm, self.trace, self.template = frontend, immature, [], []

    def __enter__(self):
        self.wrapped = self.imm.trace_points_all_compact, self.fe.build_template_from_state

        def trace(*a, **kw):
            self.trace.append((a, kw))
            return self.wrapped[0](*a, **kw)

        def template(*a, **kw):
            self.template.append((a, kw))
            return self.wrapped[1](*a, **kw)

        self.imm.trace_points_all_compact, self.fe.build_template_from_state = trace, template
        return self

    def __exit__(self, *exc):
        self.imm.trace_points_all_compact, self.fe.build_template_from_state = self.wrapped


class MargTraffic:
    """The keyframe tails' marginalizations on a path: ``ba.marginalize``
    wrapped for the run, each call's arguments kept (states are replaced,
    never written in place; the masks are host arrays)."""

    def __init__(self):
        from direct_stereo_slam_tpu_torch.models import ba

        self.ba, self.calls = ba, []

    def __enter__(self):
        self.wrapped = getattr(self.ba, "marginalize", None)
        if self.wrapped is not None:
            def kept(*a):
                self.calls.append(a)
                return self.wrapped(*a)

            self.ba.marginalize = kept
        return self

    def __exit__(self, *exc):
        if self.wrapped is not None:
            self.ba.marginalize = self.wrapped


# f32 operations of K12: a valid candidate's gate, and a (lane, frame,
# pattern pixel) term of a residual pass: the warp, the bilinear sample
# (3 channels x 3 lerps), the residual, Huber, the idepth Jacobian and the
# sums
ACT_GATE_OPS, ACT_TERM_OPS = 60, 80
# bytes K12 reads of a valid candidate for its gate (u, v, the idepth
# range, quality, type, pixel interval, status) and of a survivor for its
# LM (8 colours, 8 weights); bytes of a pool row K13 copies (valid, host,
# 4 floats, 8 colours, 8 weights, prior, num_good, 2 states; + W flags)
ACT_GATE_BYTES, ACT_LM_BYTES = 28 + 4, 64
POOL_ROW_BYTES = 1 + 8 + 16 + 64 + 4 + 4 + 8


def act_bytes_ops(torch, act, a):
    """(bytes, f32 operations, footprint) K12 needs on a call, from the
    call's own data, each byte it must read counted once: every
    candidate's valid flag, a valid candidate's gate inputs, the distance
    map's distinct cells read for the candidates the gate can pass, the
    survivors' colours and weights, and the distinct image pixels (3
    floats) under the 4 bilinear taps of the in-bounds samples of a
    survivor in each frame it is tested against, over the 4 residual
    passes (the samples recorded from the plain version's run on the same
    inputs; a sample behind the camera that lands in the image is counted);
    the window's poses and the outputs once. ACT_GATE_OPS a valid
    candidate, ACT_TERM_OPS a term of a survivor's (frame, pattern pixel)
    pairs in each pass."""
    from direct_stereo_slam_tpu_torch.models import immature
    from direct_stereo_slam_tpu_torch.ops.interp import _corners

    imm, dist, images, frame_valid, cfg, w2, h2 = a[0], a[1], a[6], a[7], a[13], a[14], a[15]
    S, NI = imm.valid.shape
    Wn, Hi, Wi = images.shape[:3]
    bud = min(a[16], NI)
    dev = dist.device
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    KRKi1, Kt1 = f32(a[2]), f32(a[3])
    can = immature.can_activate(imm, cfg)
    _, gu, gv, in_b = act.halfres_cells(imm, KRKi1, Kt1, w2, h2)
    cells = torch.unique((gv * w2 + gu)[can & in_b]).numel()
    gate_ok, _ = act._gate_impl(imm, dist, KRKi1, Kt1, f32(a[4]),
                                torch.as_tensor(np.asarray(a[5], bool), device=dev), cfg, w2, h2)
    # the compaction puts a slot's survivors first
    n_surv = torch.clamp(gate_ok.sum(1), max=bud)
    surv = torch.arange(bud, device=dev)[None, :] < n_surv[:, None]            # [S, bud]
    frames = torch.arange(Wn, device=dev)
    t_ok = frame_valid[None, :] & (frames[None, :] != torch.arange(S, device=dev)[:, None])
    need = surv[:, None, :, None] & t_ok[:, :, None, None]                    # [S, Wn, bud, 1]
    samples, real = [], immature.bilinear_gather_frames

    def kept(images_, fidx, u, v):
        samples.append((u, v))
        return real(images_, fidx, u, v)

    immature.bilinear_gather_frames = kept
    try:
        act.gate_compact_activate_plain(*a)
    finally:
        immature.bilinear_gather_frames = real
    taps, n_samples, terms = [], 0, 0
    for u, v in samples:                                                       # [S, Wn, bud, 8]
        m = need & (u > 2) & (v > 2) & (u < Wi - 3) & (v < Hi - 3)
        ix, iy, _, _ = _corners(Hi, Wi, u, v)
        base = ((frames[None, :, None, None] * Hi + iy) * Wi + ix)[m]
        taps += [base, base + 1, base + Wi, base + Wi + 1]
        n_samples += base.numel()
        terms += int(need.sum()) * u.shape[-1]
    pixels = torch.unique(torch.cat(taps)).numel() if taps else 0
    n_valid, n_lm = int(imm.valid.sum()), int(n_surv.sum())
    nb = (S * NI + n_valid * ACT_GATE_BYTES + cells * 4 + n_lm * ACT_LM_BYTES + pixels * 12
          + Wn * (16 + 2 + 1) * 4 + 16 + S * bud * (1 + 4 + 8) + S * NI)
    footprint = dict(survivors=n_lm, samples=n_samples, tap_reads=4 * n_samples,
                     image_pixels=pixels, image_bytes=12 * pixels, map_cells=cells)
    return nb, n_valid * ACT_GATE_OPS + terms * ACT_TERM_OPS, footprint


# K12 / K13 by the names ptxas compiles them under
ACT_PTXAS = {"gate_compact_activate": "gate_cluster_kernel",
             "allocate_insert": "alloc_cluster_kernel"}


def gate_phases(c, mhz: float) -> dict:
    """K12's phase stamps (cycles [S, ranks, 6]: rank 0's gate, compaction
    and writes; each block's cluster barrier; its warp 0's first LM:
    set-up, first pass, the 3 steps; warp 0's LM positions, all of them)
    in us: rank 0's front, the median over the slots; the LM's parts, the
    largest over the blocks; warp 0 from the block's start to its end, the
    longest."""
    us = np.asarray(c, np.float64) / mhz
    span = us[:, :, 1] + us[:, :, 5]
    span[:, 0] += us[:, 0, 0]
    return dict(front_rank0=float(np.median(us[:, 0, 0])),
                barrier_rank0=float(np.median(us[:, 0, 1])), barrier_max=float(us[:, :, 1].max()),
                lm_setup_max=float(us[:, :, 2].max()), lm_first_pass_max=float(us[:, :, 3].max()),
                lm_steps_max=float(us[:, :, 4].max()), lm_warp0_max=float(us[:, :, 5].max()),
                span_max=float(span.max()))


def pool_phases(c, mhz: float) -> dict:
    """K13's phase stamps (cycles [ranks, 4]: rank 0's tables and its warp
    0's part of the walk, each block's start to the barrier and the rest)
    in us."""
    us = np.asarray(c, np.float64) / mhz
    return dict(tables=float(us[0, 0]), walk=float(us[0, 1]),
                to_barrier_max=float(us[:, 2].max()), after_barrier_max=float(us[:, 3].max()),
                span_max=float((us[:, 2] + us[:, 3]).max()))


def act_phase(torch, dev, traffic, build_log):
    """K12 and K13 against their plain versions on the e2e run's fullest
    activation (the call with the most valid candidates): K12's masks
    equal to the plain version's (edge lanes counted), its LM warps the
    sum over slots of min(survivors, budget); K13 bit-equal to it, also at
    the pool's overflow (every participating slot's own segment full; the
    pool all but full); two runs of each bit-equal; each timed (the card's
    own time too) with its bound and ptxas's registers, shared memory and
    spills. Returns the kernel rows."""
    act = traffic.act
    n_valid = [int(a[0].valid.sum()) for a in traffic.gate]
    pick = max(range(len(n_valid)), key=lambda i: (n_valid[i], i))
    g, al = traffic.gate[pick], traffic.alloc[pick]
    S, NI = g[0].valid.shape
    bud = min(g[16], NI)
    print(f"act: the e2e run's activation {pick + 1} of {len(n_valid)}: {n_valid[pick]} "
          f"valid candidates in {S} x {NI}, budget {bud}, window of "
          f"{g[6].shape[0]} frames, pool of {al[0].num_points}", flush=True)
    usage = ptxas_usage(build_log, tuple(ACT_PTXAS.values()))
    print(f"act: ptxas (registers, shared memory, spill stores / loads): {usage}", flush=True)
    rows = []
    # ---- K12
    ran = torch.zeros((S, bud), dtype=torch.uint8, device=dev)
    got = act.gate_compact_activate_cuda(*g, lm_ran=ran)
    want = act.gate_compact_activate_plain(*g)
    again = act.gate_compact_activate_cuda(*g)
    ok_k, id_k, lane_k, drop_k = got
    ok_p, id_p, lane_p, drop_p = want
    same_masks = torch.equal(drop_k, drop_p) and torch.equal(lane_k, lane_p)
    close = torch.isclose(id_k, id_p, rtol=1e-4, atol=1e-5)
    edge = (ok_k != ok_p) | ((ok_k & ok_p) & ~close)
    n_acc, n_edge = int((ok_k | ok_p).sum()), int(edge.sum())
    both = ok_k & ok_p
    err = float(torch.max(torch.abs(id_k - id_p)[both])) if bool(both.any()) else 0.0
    bit_equal = all(torch.equal(bits(x), bits(y)) for x, y in zip(got, again))
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    gate_ok, _ = act._gate_impl(g[0], g[1], f32(g[2]), f32(g[3]), f32(g[4]),
                                torch.as_tensor(np.asarray(g[5], bool), device=dev), g[13],
                                g[14], g[15])
    survivors = gate_ok.sum(1)
    lm_warps, want_warps = int(ran.sum()), int(torch.clamp(survivors, max=bud).sum())
    print(f"K12 gate_compact_activate: drop and lane equal to the plain version: "
          f"{same_masks}; {n_acc} accepted lanes, {n_edge} edge lanes ({int((ok_k != ok_p).sum())} "
          f"accepts differ; idepth of the lanes both accept within rel 1e-4: max abs "
          f"{err:.3g}); two runs bit-equal: {bit_equal}; survivors per slot "
          f"{survivors.tolist()}, LM warps {lm_warps} (the sum of min(survivors, {bud}): "
          f"{want_warps})", flush=True)
    if (not same_masks or n_edge > max(1, n_acc // 100) or not bit_equal
            or lm_warps != want_warps):
        fail(f"K12: masks equal {same_masks}, edge lanes {n_edge} of {n_acc}, "
             f"bit-equal {bit_equal}, LM warps {lm_warps} (want {want_warps})")
    k12 = lambda: act.gate_compact_activate_cuda(*g)
    ms, pms = ab_ms(torch, k12, lambda: act.gate_compact_activate_plain(*g),
                    plain_kw=dict(repeats=5, inner=2))
    dms = device_ms(torch, k12)
    stamps = torch.zeros((S, act.RANKS, act.GATE_STAMPS), dtype=torch.int64, device=dev)
    act.gate_compact_activate_cuda(*g, stamps=stamps)
    torch.cuda.synchronize()
    clock = sm_clock_mhz()
    k12_phases = gate_phases(stamps.cpu().numpy(), clock)
    print(f"K12 gate_compact_activate phases (us at {clock:.0f} MHz): {k12_phases}", flush=True)
    nb, no, fp = act_bytes_ops(torch, act, g)
    print(f"K12 gate_compact_activate: kernel {ms:.4f} ms; on the card {dms} ms; plain "
          f"{pms:.4f} ms; the call "
          f"needs {nb} bytes and {no} f32 operations: "
          f"{fp['image_pixels']} distinct image pixels ({fp['image_bytes']} bytes) under "
          f"{fp['tap_reads']} tap reads of {fp['samples']} in-bounds samples of "
          f"{fp['survivors']} survivors over 4 passes, {fp['map_cells']} map cells", flush=True)
    rep = "direct_stereo_slam_tpu/models/frontend.py:149"
    rows.append(row("gate_compact_activate", "activate.cu", rep, err, ms, pms, nb, no))
    rows[-1].update(device_ms=dms, phases_us=k12_phases, edge_lanes=n_edge,
                    accepted_lanes=n_acc, lm_warps=lm_warps, ptxas=usage.get(ACT_PTXAS[
                        "gate_compact_activate"]), activate_split=traffic.split, **fp)
    # ---- K13, on the recorded call and at the pool's overflow
    st, participate, P = al[0], al[6], al[7]
    cases = {"recorded": st}
    own = st.p_valid.clone()
    for s_ in np.nonzero(participate)[0]:
        own[s_ * P:(s_ + 1) * P] = True
    cases["own_segment_full"] = st._replace(p_valid=own)
    full = torch.ones_like(st.p_valid)
    full[3::401] = False
    cases["pool_full"] = st._replace(p_valid=full)
    flat = lambda r: [bits(x) for x in [getattr(r[0], f) for f in act.POOL_FIELDS]
                      + [r[1].valid, *r[2]]]
    for case, st_c in cases.items():
        a = (st_c,) + tuple(al[1:])
        k = act.allocate_insert_consume_cuda(*a)
        p = act.allocate_insert_consume_plain(*a)
        k2 = act.allocate_insert_consume_cuda(*a)
        equal = all(torch.equal(x, y) for x, y in zip(flat(k), flat(p)))
        twice = all(torch.equal(x, y) for x, y in zip(flat(k), flat(k2)))
        print(f"K13 allocate_insert {case}: {int(p[2][5].sum())} placed of "
              f"{int(al[2].cpu().numpy()[participate].sum())} accepted, "
              f"{int((~st_c.p_valid).sum())} free rows; bit-equal to the plain version: "
              f"{equal}; two runs bit-equal: {twice}", flush=True)
        if not (equal and twice):
            fail(f"K13 {case}: bit-equal to plain {equal}, two runs {twice}")
    k13 = lambda: act.allocate_insert_consume_cuda(*al)
    ms, pms = ab_ms(torch, k13, lambda: act.allocate_insert_consume_plain(*al),
                    plain_kw=dict(repeats=5, inner=2))
    dms = device_ms(torch, k13)
    stamps = torch.zeros((act.RANKS, act.POOL_STAMPS), dtype=torch.int64, device=dev)
    act.allocate_insert_consume_cuda(*al, stamps=stamps)
    torch.cuda.synchronize()
    clock = sm_clock_mhz()
    k13_phases = pool_phases(stamps.cpu().numpy(), clock)
    print(f"K13 allocate_insert phases (us at {clock:.0f} MHz): {k13_phases}", flush=True)
    B, W_ = st.p_res_good.shape
    placed = int(act.allocate_insert_consume_plain(*al)[2][5].sum())
    # reads ok, lane and idepth, drop and the candidates' validity, the
    # placed candidates' u, v, colours and weights, the pool; writes the
    # pool, the validity, the allocation and the consumed mask
    nb = (S * bud * (1 + 8 + 4) + 3 * S * NI + placed * 72
          + 2 * B * (POOL_ROW_BYTES + W_) + 5 * B * 8 + B + S * NI)
    print(f"K13 allocate_insert: kernel {ms:.4f} ms; on the card {dms} ms; plain "
          f"{pms:.4f} ms; {placed} rows placed", flush=True)
    rep = "direct_stereo_slam_tpu/models/frontend.py:190"
    rows.append(row("allocate_insert", "activate.cu", rep, 0.0, ms, pms, nb, 0))
    rows[-1].update(device_ms=dms, phases_us=k13_phases, placed=placed,
                    ptxas=usage.get(ACT_PTXAS["allocate_insert"]))
    return rows


# f32 operations of K14: a lane's phase 1 (the segment and its gates), a
# search tap (the bilinear read, the residual, its square and sum), a
# searched lane's GN refine (3 steps of 8 taps on 3 channels, the sums,
# the step and the second read) and its interval update
TRACE_LANE_OPS, TRACE_TAP_OPS, TRACE_GN_OPS = 80, 18, 1200
# bytes K14 moves of every lane (reads valid, status, the idepth range,
# quality and pixel interval, writes the last five anew), reads of a
# traceable lane (u, v, grad_h) and of a searched lane (its colours)
TRACE_LANE_BYTES, TRACE_TRACEABLE_BYTES, TRACE_COLOR_BYTES = 1 + 4 + 4 * 4 + 20, 2 * 4 + 12, 32
# f32 operations of K15 a cell with weight after dilation (its pooling,
# dilation, normalisation, gates) and of a point's projection; bytes of a
# point in state mode, the path's (p_u, p_v, p_idepth, hdd, its host slot
# as int64 and its flag), and of a list lane (4 floats and its flag)
TEMPLATE_CELL_OPS, TEMPLATE_PROJECT_OPS = 40, 32
TEMPLATE_POINT_BYTES, TEMPLATE_LANE_BYTES = 4 * 4 + 8 + 1, 17
TRACE_PTXAS = {"trace_points_all_compact": "trace_kernel",
               "build_template": "template_kernel"}


def trace_bytes_ops(torch, a, kw) -> tuple:
    """(bytes, f32 operations, footprint) K14 needs on a call, from the
    call's own data: every lane's inputs and outputs, the traceable lanes'
    geometry, the searched lanes' colours, the counts, and each distinct
    pixel under the taps once: 12 bytes (the three planes) under the GN's
    taps, 4 (the intensity) under the search's only; the taps recorded
    from the plain version's run on the same inputs."""
    from direct_stereo_slam_tpu_torch.models import immature
    from direct_stereo_slam_tpu_torch.ops.interp import _corners

    pts, planes = a[0], a[1]
    Hp, Wp = planes.shape[:2]
    taps = {"search": [], "gn": []}
    real1, real3 = immature.bilinear_gather_scalar, immature.bilinear_gather

    def kept1(img, u, v):
        taps["search" if u.dim() == 3 else "gn"].append((u, v))
        return real1(img, u, v)

    def kept3(img, u, v):
        taps["gn"].append((u, v))
        return real3(img, u, v)

    immature.bilinear_gather_scalar, immature.bilinear_gather = kept1, kept3
    lanes = torch.empty(min(kw.get("budget", a[6].trace.search_budget), pts.u.numel()),
                        dtype=torch.int64, device=planes.device)
    try:
        immature.trace_points_all_compact_plain(*a, **kw, lanes=lanes)
    finally:
        immature.bilinear_gather_scalar, immature.bilinear_gather = real1, real3
    live = lanes < pts.u.numel()
    n_searched = int(live.sum())
    n_traceable = int((pts.valid & (pts.status != immature.IPS_OOB)).sum())

    def distinct(pairs):
        cells = []
        for u, v in pairs:
            m = live.reshape((-1,) + (1,) * (u.dim() - 1)).expand_as(u)
            ix, iy, _, _ = _corners(Hp, Wp, u, v)
            base = (iy * Wp + ix)[m]
            cells += [base, base + 1, base + Wp, base + Wp + 1]
        return torch.unique(torch.cat(cells)) if cells else torch.zeros(
            0, dtype=torch.int64, device=planes.device)

    gn = distinct(taps["gn"])
    search = distinct(taps["search"])
    px_gn, px_search = gn.numel(), int((~torch.isin(search, gn)).sum())
    steps = kw.get("num_steps") or a[6].trace.num_steps
    n = pts.u.numel()
    nb = (n * TRACE_LANE_BYTES + n_traceable * TRACE_TRACEABLE_BYTES
          + n_searched * TRACE_COLOR_BYTES + 4 * px_search + 12 * px_gn + 16)
    no = n_traceable * TRACE_LANE_OPS + n_searched * (steps * 8 * TRACE_TAP_OPS + TRACE_GN_OPS)
    return nb, no, dict(searched=n_searched, traceable=n_traceable, steps=steps,
                        search_only_pixels=px_search, gn_pixels=px_gn)


def template_needs(torch, a, kw) -> tuple:
    """(image pixels, cells) K15 needs on a call: the distinct level-0
    pixels of the image under a cell (2^l x 2^l pixels a cell of level l)
    whose other gates (border, weight after dilation, idepth) pass, in
    raster order up to the cell that fills the level's list; and the
    cells of all levels with weight after dilation. The dilated maps are
    recorded from the plain version's run on the same inputs."""
    from direct_stereo_slam_tpu_torch.models import depth_template as dt

    maps, real = [], dt._dilate_once

    def kept(d, w, offsets):
        maps.append(real(d, w, offsets))
        return maps[-1]

    dt._dilate_once = kept
    try:
        dt.build_template_plain(*a, **kw)
    finally:
        dt._dilate_once = real
    img, budgets = a[4], a[6]
    need = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    img_l, weighted = img, 0
    for l, (d, w) in enumerate(maps):
        img_l = img_l if l == 0 else 0.25 * dt._pool(img_l)
        h, wl = d.shape
        weighted += int((w > 0).sum())
        ys = torch.arange(h, device=img.device)[:, None]
        xs = torch.arange(wl, device=img.device)[None, :]
        gates = ((ys >= 2) & (ys < h - 2) & (xs >= 2) & (xs < wl - 2) & (w > 0)
                 & (d / torch.clamp(w, min=1e-12) > 0)).reshape(-1)
        good = torch.nonzero(gates & torch.isfinite(img_l).reshape(-1)).reshape(-1)
        if good.numel() > budgets[l]:
            gates &= torch.arange(h * wl, device=img.device) <= good[budgets[l] - 1]
        s = 1 << l
        need[:h * s, :wl * s] |= gates.reshape(h, wl).repeat_interleave(s, 0) \
            .repeat_interleave(s, 1)
    return int(need.sum()), weighted


def trace_phases(c, mhz: float) -> dict:
    """K14's phase stamps (cycles [grid, 4]: phase 1, the grid barrier, the
    compaction, the searches) in us, the largest over the blocks."""
    us = np.asarray(c, np.float64) / mhz
    names = ("gates", "barrier", "compaction", "search")
    out = {f"{k}_max": float(us[:, i].max()) for i, k in enumerate(names)}
    out["span_max"] = float(us.sum(1).max())
    return out


def template_phases(c, mhz: float) -> dict:
    """K15's phase stamps (block 0's cycles of ``ops/template.py``'s
    STAMP_PHASES, the image's from block 1) in us; ``span`` is block 0's,
    all but the image's."""
    from direct_stereo_slam_tpu_torch.ops.template import STAMP_PHASES

    us = np.asarray(c, np.float64) / mhz
    out = {k: float(us[i]) for i, k in enumerate(STAMP_PHASES)}
    out["span"] = float(sum(v for k, v in out.items() if k != "image"))
    return out


def fullest_template(calls):
    """The recorded template call (``build_template_from_state``'s
    arguments) with the most valid points among those given the BA's
    idepth hessian (a keyframe's; the initialisation re-linearizes)."""
    return max((a for a, _ in calls if a[3] is not None),
               key=lambda a: int(a[0].p_valid.sum()))


def trace_template_phase(torch, dev, traffic, build_log):
    """K14 and K15 against their plain versions on the e2e run's calls: K14
    on its fullest full-shape call, its fullest steady-tier call and the
    full call with the budget at half its searching lanes (an overflow),
    K15 on its fullest template; the statuses, the compacted lanes,
    n_search and n_overflow equal and the four float fields bit-equal
    (K15: every level's lists bit-equal), two runs bit-equal; each timed
    (the wrapper's ms, the card's own ms, the plain version's ms) with its
    bound, phase stamps and ptxas's registers, shared memory and spills.
    Returns the kernel rows."""
    from direct_stereo_slam_tpu_torch.models import depth_template as dt
    from direct_stereo_slam_tpu_torch.models import immature
    from direct_stereo_slam_tpu_torch.ops import _cuda
    from direct_stereo_slam_tpu_torch.ops import template as template_ops
    from direct_stereo_slam_tpu_torch.ops import trace as trace_ops

    usage = ptxas_usage(build_log, tuple(TRACE_PTXAS.values()))
    print(f"trace/template: ptxas (registers, shared memory, spill stores / loads): {usage}",
          flush=True)
    fullest = lambda calls: max(calls, key=lambda c: int(c[0][0].valid.sum()))
    full = fullest([c for c in traffic.trace if "max_reach" not in c[1]])
    steady = fullest([c for c in traffic.trace if "max_reach" in c[1]])
    n_want = int(immature.trace_points_all_compact_plain(*full[0], **full[1])[1])
    over = (full[0], dict(full[1], budget=max(n_want // 2, 1)))
    clock = sm_clock_mhz()
    rows = []
    fields = ("idepth_min", "idepth_max", "quality", "status", "pixel_interval")
    for case, (a, kw) in (("full", full), ("steady", steady), ("overflow", over)):
        S, NI = a[0].u.shape
        bud = min(kw.get("budget", a[6].trace.search_budget), S * NI)
        lk = torch.empty(bud, dtype=torch.int64, device=dev)
        lp = torch.empty(bud, dtype=torch.int64, device=dev)
        got = trace_ops.trace_points_all_compact_cuda(*a, **kw, lanes=lk)
        want = immature.trace_points_all_compact_plain(*a, **kw, lanes=lp)
        again = trace_ops.trace_points_all_compact_cuda(*a, **kw)
        torch.cuda.synchronize()
        counts = (int(got[1]), int(got[2]), int(want[1]), int(want[2]))
        diff = {f: int((bits(getattr(got[0], f)) != bits(getattr(want[0], f))).sum())
                for f in fields}
        twice = all(torch.equal(bits(getattr(got[0], f)), bits(getattr(again[0], f)))
                    for f in fields) and int(again[1]) == counts[0] and int(again[2]) == counts[1]
        same_lanes = torch.equal(lk, lp)
        err = max(float(torch.nan_to_num(torch.abs(getattr(got[0], f) - getattr(want[0], f)),
                                         nan=0.0).max()) for f in fields if f != "status")
        nb, no, fp = trace_bytes_ops(torch, a, kw)
        print(f"K14 trace_points_all_compact {case}: {int(a[0].valid.sum())} valid lanes of "
              f"{S} x {NI}, budget {bud}, {fp['steps']} steps; n_search / n_overflow "
              f"{counts[:2]} (plain {counts[2:]}), {fp['searched']} searched; compacted lanes "
              f"equal: {same_lanes}; lanes differing from the plain version per field: {diff}; "
              f"two runs bit-equal: {twice}", flush=True)
        if (not same_lanes or any(diff.values()) or counts[:2] != counts[2:] or not twice
                or (case == "overflow" and counts[1] <= 0)):
            fail(f"K14 {case}: lanes equal {same_lanes}, counts {counts}, differing {diff}, "
                 f"two runs {twice}")
        k14 = lambda: trace_ops.trace_points_all_compact_cuda(*a, **kw)
        ms, pms = ab_ms(torch, k14, lambda: immature.trace_points_all_compact_plain(*a, **kw),
                        plain_kw=dict(repeats=5, inner=2))
        dms = device_ms(torch, k14)
        grid = _cuda.sm_count(dev)
        stamps = torch.zeros((grid, trace_ops.TRACE_STAMPS), dtype=torch.int64, device=dev)
        trace_ops.trace_points_all_compact_cuda(*a, **kw, stamps=stamps)
        torch.cuda.synchronize()
        ph = trace_phases(stamps.cpu().numpy(), clock)
        print(f"K14 trace_points_all_compact {case}: kernel {ms:.4f} ms, on the card {dms} ms, "
              f"plain {pms:.4f} ms; the call needs {nb} bytes and {no} f32 operations "
              f"({fp['traceable']} traceable lanes, {fp['gn_pixels']} distinct pixels under "
              f"the GN's taps, {fp['search_only_pixels']} more under the search's); phases (us at {clock:.0f} MHz) {ph}",
              flush=True)
        rows.append(row(f"trace_points_all_compact[{case}]", "trace.cu",
                        "direct_stereo_slam_tpu/models/immature.py:479", err, ms, pms, nb, no))
        rows[-1].update(device_ms=dms, phases_us=ph, n_search=counts[0], n_overflow=counts[1],
                        ptxas=usage.get(TRACE_PTXAS["trace_points_all_compact"]), **fp)
    # ---- K15 on the fullest template, in both modes
    from direct_stereo_slam_tpu_torch.models import ba

    st, _, slot, hdd, img, levels, budgets = fullest_template(traffic.template)
    ti = ba.template_inputs(st, None, slot, hdd)
    a, kw = ti[:4] + (img, levels, budgets), dict(valid=ti[4])
    calib, T_rh = ba.template_pose_prep(st, slot)
    sa = (st.p_u, st.p_v, st.p_idepth, st.p_host, st.p_valid, hdd, calib, T_rh, img, levels,
          budgets)

    def state_plain():
        pu, pv, pid, pw, valid = ba.template_project(*sa[:8])
        return dt.build_template_plain(pu, pv, pid, pw, img, levels, budgets, valid=valid)

    k15 = {"points": lambda: template_ops.build_template_cuda(*a, kw["valid"]),
           "state": lambda: template_ops.build_template_from_state_cuda(*sa)}
    plain = {"points": lambda: dt.build_template_plain(*a, **kw), "state": state_plain}
    want = plain["points"]()
    n_pts, counts = a[0].numel(), [int(m.sum()) for m in want[4]]
    timed = {}
    for mode in ("state", "points"):
        got, again = k15[mode](), k15[mode]()
        torch.cuda.synchronize()
        diff = {f"{n}[{l}]": int((bits(x[l]) != bits(y[l])).sum())
                for n, x, y in zip(("pu", "pv", "pid", "pcolor", "pmask"), got, want)
                for l in range(levels)}
        twice = all(torch.equal(bits(x[l]), bits(y[l])) for x, y in zip(got, again)
                    for l in range(levels))
        print(f"K15 build_template ({mode} mode): {n_pts} points ({int(kw['valid'].sum())} "
              f"valid), list counts {counts} of budgets {list(budgets)}; entries differing from "
              f"the plain version {sum(diff.values())} ({ {k: v for k, v in diff.items() if v} });"
              f" two runs bit-equal: {twice}", flush=True)
        if any(diff.values()) or not twice:
            fail(f"K15 {mode} mode: differing {diff}, two runs {twice}")
        ms, pms = ab_ms(torch, k15[mode], plain[mode], plain_kw=dict(repeats=5, inner=2))
        timed[mode] = dict(ms=ms, plain_ms=pms, device_ms=device_ms(torch, k15[mode]))
    stamps = torch.zeros(template_ops.TEMPLATE_STAMPS, dtype=torch.int64, device=dev)
    template_ops.build_template_from_state_cuda(*sa, stamps=stamps)
    torch.cuda.synchronize()
    ph = template_phases(stamps.cpu().numpy(), clock)
    Hi, Wi = img.shape
    cells = sum(h * w for h, w in template_ops.level_shapes(Hi, Wi, levels))
    px_img, weighted = template_needs(torch, a, kw)
    # the path's state mode: each point's inputs, the window's poses and
    # calibration, the image under the gated cells, the lists
    nb = (n_pts * TEMPLATE_POINT_BYTES + T_rh.numel() * 4 + 16 + 4 * px_img
          + sum(budgets[:levels]) * TEMPLATE_LANE_BYTES)
    no = weighted * TEMPLATE_CELL_OPS + n_pts * TEMPLATE_PROJECT_OPS
    grid = _cuda.sm_count(dev)
    print(f"K15 build_template: state mode kernel {timed['state']['ms']:.4f} ms, on the card "
          f"{timed['state']['device_ms']} ms, plain {timed['state']['plain_ms']:.4f} ms; points "
          f"mode kernel {timed['points']['ms']:.4f} ms, on the card "
          f"{timed['points']['device_ms']} ms, plain {timed['points']['plain_ms']:.4f} ms; the "
          f"state call needs {nb} bytes ({px_img} image pixels of {Hi * Wi}) and {no} f32 "
          f"operations ({weighted} cells of {cells} with weight); grid {grid} blocks; phases "
          f"(us at {clock:.0f} MHz) {ph}", flush=True)
    rows.append(row("build_template", "template.cu",
                    "direct_stereo_slam_tpu/models/depth_template.py:80", 0.0,
                    timed["state"]["ms"], timed["state"]["plain_ms"], nb, no))
    rows[-1].update(device_ms=timed["state"]["device_ms"], points_mode=timed["points"],
                    phases_us=ph, points=n_pts, list_counts=counts, image_pixels=px_img,
                    weighted_cells=weighted, template_split=getattr(traffic, "split", None),
                    ptxas=usage.get(TRACE_PTXAS["build_template"]))
    if rows[-1]["template_split"] is not None:
        print("template_split " + json.dumps(dict(
            traffic.split, card_ms=timed["state"]["device_ms"])), flush=True)
    return rows


# the activate span's parts, timed by wrapping them in their modules:
# (label, module, function); "projection" is _halfres_distance_map less K1
ACT_SPLIT = (("host_pose_math", "frontend", "_activation_warps"),
             ("state_reads_poses", "frontend", "_activation_state"),
             ("state_reads_poses", "window", "window_pose"),
             ("projection_and_k1", "frontend", "_halfres_distance_map"),
             ("k1", "frontend", "build_distance_map"),
             ("k12_wrapper", "activate", "gate_compact_activate"),
             ("k13_wrapper", "activate", "allocate_insert_consume"))
# the template span's: the window's pose prep, the plain per-point
# projection (none since K15 projects in its launch), K15's wrapper; the
# card's part is K15's card time on the fullest template
TEMPLATE_SPLIT = (("pose_prep", "ba", "template_pose_prep"),
                  ("projection", "ba", "template_project"),
                  ("k15_wrapper", "template", "build_template_from_state_cuda"))


def act_only(torch, dev, build_log) -> None:
    """``--act``: the e2e sequence (a warm-up pass, then a pass with the
    activation calls recorded), the ``activate`` span's split, then the
    act phase on the fullest call (K12 / K13 against their plain versions,
    timed, phase stamps, ptxas)."""
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    ds, frames, cfg, intr = sequence_setup(dev, E2E_FRAMES, speed=0.4)
    run_sequence(torch, SLAMNode, cfg, intr, ds, frames, dev)
    with ActTraffic() as traffic:
        run_sequence(torch, SLAMNode, cfg, intr, ds, frames, dev)
    traffic.split = activate_split(torch, dev, cfg, intr, ds, frames)
    print("act_rows " + json.dumps(act_phase(torch, dev, traffic, build_log)), flush=True)


def trace_only(torch, dev, build_log) -> None:
    """``--trace``: the e2e sequence (a warm-up pass, then a pass with the
    trace and template calls recorded), the ``template`` span's split,
    then the trace / template phase (K14 and K15 against their plain
    versions, timed, phase stamps, ptxas)."""
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    ds, frames, cfg, intr = sequence_setup(dev, E2E_FRAMES, speed=0.4)
    run_sequence(torch, SLAMNode, cfg, intr, ds, frames, dev)
    with TraceTraffic() as traffic:
        run_sequence(torch, SLAMNode, cfg, intr, ds, frames, dev)
    traffic.split = template_split(torch, dev, cfg, intr, ds, frames)
    print("trace_rows " + json.dumps(trace_template_phase(torch, dev, traffic, build_log)),
          flush=True)


def span_split(torch, dev, cfg, intr, ds, frames, span: str, parts,
               in_span: bool = False, outer_only: bool = False) -> dict:
    """The e2e sequence once more, no synchronize, with a span's parts
    wrapped in their modules ((label, module, function) of the front end,
    the BA, the activation, the template or the scale wrappers, or a
    method of ``FrontEnd``; a part this tree lacks is left out): the span's
    host ms per call and each part's ("other" the rest of the span).
    ``in_span``: a part's time counts only while ``span`` is the innermost
    open span (for parts the front end also calls elsewhere);
    ``outer_only``: a part called inside another counts in the outer one
    only. ``spans``:
    every span's ms per call and count in that run."""
    from direct_stereo_slam_tpu_torch.models import ba, frontend
    from direct_stereo_slam_tpu_torch.models import scale_opt
    from direct_stereo_slam_tpu_torch.ops import activate
    from direct_stereo_slam_tpu_torch.ops import template
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode
    from direct_stereo_slam_tpu_torch.utils import timing

    mods = {"frontend": frontend, "activate": activate, "ba": ba, "template": template,
            "scale_opt": scale_opt, "FrontEnd": frontend.FrontEnd, "window": None}
    if importlib.util.find_spec("direct_stereo_slam_tpu_torch.ops.window") is not None:
        from direct_stereo_slam_tpu_torch.ops import window
        mods["window"] = window
    spent, saved, active = {}, [], []
    opened = timing.StageTimers.span

    @contextmanager
    def tracked(self, name):
        active.append(name)
        try:
            with opened(self, name):
                yield
        finally:
            active.pop()

    depth = [0]

    def timed(label, fn):
        def inner(*a, **kw):
            if (outer_only and depth[0]) or (in_span and not (active and active[-1] == span)):
                return fn(*a, **kw)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
                spent[label] = spent.get(label, 0.0) + time.perf_counter() - t0
        return inner

    present = [(label, mod, name) for label, mod, name in parts
               if mods[mod] is not None and hasattr(mods[mod], name)]
    for label, mod, name in present:
        saved.append((mods[mod], name, getattr(mods[mod], name)))
        setattr(mods[mod], name, timed(label, getattr(mods[mod], name)))
    timing.StageTimers.span = tracked
    try:
        node = run_sequence(torch, SLAMNode, cfg, intr, ds, frames, dev)[0]
    finally:
        timing.StageTimers.span = opened
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    n = max(node.timers.count(span), 1)
    out = {label: 1e3 * spent.get(label, 0.0) / n for label, _, _ in present}
    return dict(span_ms=node.timers.average_ms(span), calls=node.timers.count(span),
                parts_ms=out, spans={k: (node.timers.average_ms(k), node.timers.count(k))
                                     for k in node.timers.times})


def activate_split(torch, dev, cfg, intr, ds, frames) -> dict:
    """The ``activate`` span's split (ACT_SPLIT): the host pose math, the
    window's poses (K16's wrapper; in an older tree the state reads and
    ``inv_ex``), the projection's plain launches, K1's, K12's and K13's
    wrappers, the rest; per keyframe. Each part counts only inside the
    span (K16 also serves the template)."""
    got = span_split(torch, dev, cfg, intr, ds, frames, "activate", ACT_SPLIT, in_span=True)
    parts = got["parts_ms"]
    parts["projection"] = parts.pop("projection_and_k1") - parts["k1"]
    parts["other"] = got["span_ms"] - sum(parts.values())
    out = dict(activate_ms=got["span_ms"], keyframes=got["calls"], parts_ms=parts)
    print("act_split " + json.dumps(out), flush=True)
    return out


def template_split(torch, dev, cfg, intr, ds, frames) -> dict:
    """The ``template`` span's host split (TEMPLATE_SPLIT) per template:
    the pose prep, the plain projection, K15's wrapper, the rest (the
    template's share of the span's other work)."""
    got = span_split(torch, dev, cfg, intr, ds, frames, "template", TEMPLATE_SPLIT)
    parts = got["parts_ms"]
    parts["other"] = got["span_ms"] - sum(parts.values())
    return dict(template_ms=got["span_ms"], templates=got["calls"], parts_ms=parts)


# the keyframe tail's marginalization (the point_marg and frame_marg
# spans): the host's numpy flagging, and the device program's calls (K18
# in a tree that has it; else marginalize_points with its second K9,
# drop_points and marginalize_frame), timed where they are called
MARG_SPLIT = (("host_flagging", "frontend", "_flag_points_for_removal"),
              ("k18_marginalize", "ba", "marginalize"),
              ("marginalize_points", "ba", "marginalize_points"),
              ("drop_points", "ba", "drop_points"),
              ("marginalize_frame", "ba", "marginalize_frame"))
# scale_opt's span: the right image's upload, its pyramid, the dispatch
# (K3-LM's wrapper inside it) and the rest
SCALE_SPLIT = (("right_image_upload", "FrontEnd", "_image"),
               ("right_pyramid", "frontend", "build_pyramid"),
               ("dispatch", "frontend", "dispatch_scale_optimization"),
               ("k3lm_wrapper", "scale_opt", "scale_lm_cuda"))


def marg_split(torch, dev, cfg, intr, ds, frames) -> dict:
    """The ``point_marg`` and ``frame_marg`` spans per keyframe tail, each
    split into the host's part and the device program's calls
    (MARG_SPLIT), from one e2e run."""
    got = span_split(torch, dev, cfg, intr, ds, frames, "point_marg", MARG_SPLIT,
                     outer_only=True)
    n_pm = max(got["calls"], 1)
    fm_ms, n_fm = got["spans"].get("frame_marg", (0.0, 0))
    parts = got["parts_ms"]
    device = {k: v for k, v in parts.items() if k != "host_flagging"}
    # marginalize_frame is called in frame_marg (before K18); per point_marg call here
    frame_dev = device.pop("marginalize_frame", 0.0) * n_pm / max(n_fm, 1)
    out = dict(point_marg=dict(span_ms=got["span_ms"], calls=got["calls"],
                               host_flagging_ms=parts.get("host_flagging", 0.0),
                               device_program_ms=device,
                               host_other_ms=got["span_ms"] - sum(parts.values())
                               + parts.get("marginalize_frame", 0.0)),
               frame_marg=dict(span_ms=fm_ms, calls=n_fm,
                               device_program_ms={"marginalize_frame": frame_dev},
                               host_ms=fm_ms - frame_dev))
    print("marg_split " + json.dumps(out), flush=True)
    return out


def scale_split(torch, dev, cfg, intr, ds, frames) -> dict:
    """The ``scale_opt`` span's host split per keyframe (SCALE_SPLIT, each
    counted only inside the span), and K3-LM's card time per call on the
    run's last call (``device_ms``)."""
    from direct_stereo_slam_tpu_torch.models import scale_opt

    last = []
    inner = scale_opt.scale_lm_cuda

    def kept(*a, **kw):
        last[:] = [(a, kw)]
        return inner(*a, **kw)

    scale_opt.scale_lm_cuda = kept
    try:
        got = span_split(torch, dev, cfg, intr, ds, frames, "scale_opt", SCALE_SPLIT,
                         in_span=True)
    finally:
        scale_opt.scale_lm_cuda = inner
    parts = got["parts_ms"]
    dispatch = parts.pop("dispatch", 0.0)
    parts["dispatch_less_k3lm_wrapper"] = dispatch - parts.get("k3lm_wrapper", 0.0)
    parts["other"] = got["span_ms"] - sum(parts.values())
    card = device_ms(torch, lambda: inner(*last[0][0], **last[0][1])) if last else None
    out = dict(scale_opt_ms=got["span_ms"], keyframes=got["calls"], parts_ms=parts,
               k3lm_card_ms=card)
    print("scale_split " + json.dumps(out), flush=True)
    return out


def ba_bytes_ops(st, D, n_pairs, n_pixels):
    """(bytes, f32 operations) K9 needs on a window: 12 B (value and
    gradient) of each image pixel its live pairs read (``pair_pixels``),
    the point data, and the outputs; BA_RES_OPS per residual (8 a live
    pair)."""
    NP, W = st.num_points, st.num_slots
    point = NP * (4 * 5 + 8 + 2 * 8 * 4 + W)
    out = NP * D * 4 + NP * 8 + NP * W * 6 + D * D * 4 + D * 4 + 8
    return n_pixels * 12 + point + out, n_pairs * 8 * BA_RES_OPS


def ba_step_ops(NP: int, D: int) -> int:
    """f32 operations K10's function needs: Hfd x inv_Hdd once (NP x D),
    one multiply-add per point for each entry of the Schur sums (the
    U = D(D+1)/2 entries of Hfd^T diag(inv_Hdd) Hfd and the D of its b),
    the D x D solve (2 D^3 / 3) and the back-substitution of x_d
    (a D-long dot product a point)."""
    U = D * (D + 1) // 2
    return NP * D + 2 * NP * (U + D) + 2 * D ** 3 // 3 + 2 * NP * D


def pair_pixels(torch, st, valid=None) -> tuple:
    """(live pairs, image pixels they read) of K9's pixel pass over the
    points ``valid`` (default ``st.p_valid``): a live pair is a point
    toward a valid frame other than its host with its residual flag set;
    it reads the 4 bilinear corners of each of its 8 pattern pixels that
    project inside the image, at the current poses. A pixel that two
    residuals (of one point or of two) read counts once."""
    from direct_stereo_slam_tpu_torch.config import PATTERN_OFFSETS

    W = st.num_slots
    valid = st.p_valid if valid is None else valid
    t = torch.arange(W, device=st.p_host.device)
    mask = (valid[:, None] & st.frame_valid[None, :] & (t[None, :] != st.p_host[:, None])
            & st.p_res_good)
    p, tt = torch.nonzero(mask, as_tuple=True)
    if p.numel() == 0:
        return 0, 0
    T = st.T_current().double()
    Tth = T[tt] @ torch.linalg.inv(T[st.p_host[p]])                   # [n, 4, 4]
    fx, fy, cx, cy = st.calib_current().double().unbind(0)
    off = torch.tensor(PATTERN_OFFSETS, dtype=torch.float64, device=T.device)
    idp = st.p_idepth[p].double().clamp(min=1e-6)[:, None]
    u, v = st.p_u[p].double()[:, None] + off[:, 0], st.p_v[p].double()[:, None] + off[:, 1]
    X = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1) / idp[..., None]
    pt = torch.einsum("nij,nkj->nki", Tth[:, :3, :3], X) + Tth[:, None, :3, 3]
    z = pt[..., 2]
    Ku, Kv = fx * pt[..., 0] / z + cx, fy * pt[..., 1] / z + cy
    Hi, Wi = st.images.shape[1], st.images.shape[2]
    inside = (Ku > 1.1) & (Kv > 1.1) & (Ku < Wi - 2.1) & (Kv < Hi - 2.1) & (z > 1e-4)
    x0, y0 = torch.floor(Ku[inside]).long(), torch.floor(Kv[inside]).long()
    f = tt[:, None].expand_as(Ku)[inside]
    keys = torch.cat([(f * Hi + y0 + j) * Wi + x0 + i for i in (0, 1) for j in (0, 1)])
    return int(p.numel()), int(torch.unique(keys).numel())


@contextmanager
def plain_ba():
    """The BA's plain versions on any device while inside: the LM loop
    with its host reads, ``_finish_optimize`` and ``linearize_plain`` in
    place of the resident launch and K9."""
    from direct_stereo_slam_tpu_torch.models import ba

    saved = ba._optimize_device, ba.linearize, ba.optimize_keyframe
    ba._optimize_device = lambda st, cfg, it: ba._finish_optimize(
        *ba._optimize_loop_plain(st, cfg, it))
    ba.linearize = ba.linearize_plain
    # K17's plain version around the plain loop (a tree without K17 has none)
    ba.optimize_keyframe = getattr(ba, "optimize_keyframe_plain", ba.optimize_keyframe)
    try:
        yield
    finally:
        ba._optimize_device, ba.linearize, ba.optimize_keyframe = saved


def reordered(st, ba):
    """The window with its point pool reversed: the same problem, every sum
    over points taken in another order."""
    return st._replace(**{f: getattr(st, f).flip(0) for f in ba._POINT_FIELDS})


def fullest_call(calls):
    """(index, valid slots, (st, cfg, iterations, slot, compact budget)) of
    the keyframe call with the most valid slots (the last of equals)."""
    nvalid = [int(a[0].frame_valid.sum()) for a, _ in calls]
    pick = max(range(len(calls)), key=lambda i: (nvalid[i], i))
    a, kw = calls[pick]
    budget = a[4] if len(a) > 4 else kw.get("compact_budget")
    return pick, nvalid[pick], tuple(a[:4]) + (budget,)


def ba_windows(st_full, ba):
    """The BA phase's two views of a window: the compact view of BA_COMPACT
    points and the full pool."""
    return {BA_COMPACT: ba._compact_points(st_full, BA_COMPACT)[0],
            st_full.num_points: st_full}


def ba_window_only(torch, dev, path: str) -> None:
    """``--ba-window FILE``: one pass of the e2e sequence; its fullest
    keyframe window's ``optimize_keyframe`` arguments saved to FILE (the
    state on the CPU), for ``--ba-split`` on two trees in turns."""
    from direct_stereo_slam_tpu_torch.models import ba
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    ds, frames, cfg, intr = sequence_setup(dev, E2E_FRAMES, speed=0.4)
    with BaTraffic() as traffic:
        run_sequence(torch, SLAMNode, cfg, intr, ds, frames, dev)
    pick, nvalid, args = fullest_call(traffic.calls)
    st = ba.BAState(*[x.cpu() for x in args[0]])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save((st,) + args[1:], path)
    print(f"ba window: keyframe call {pick + 1} of {len(traffic.calls)}, {nvalid} slots "
          f"valid, {int(st.p_valid.sum())} valid points of {st.num_points} -> {path}",
          flush=True)


# K9 and K10's sub-launches, by kernel name, in launch order: this design's
# (K9: lin_pair, lin_finish; K10: step) and the previous one's (K9:
# lin_tile, lin_finish; K10: schur, solve, backsub), so that one list
# times two checkouts in turns
BA_SUB_KERNELS = ("lin_pair_kernel", "lin_tile_kernel", "lin_finish_kernel", "step_kernel",
                  "schur_kernel", "solve_kernel", "backsub_kernel")


def ptxas_usage(build_log: str, names) -> dict:
    """Per kernel whose name a compiled entry holds: registers, shared
    memory bytes, spill stores and loads, as ptxas reported them."""
    found, current, spill = {}, None, (0, 0)
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            # the mangled name carries its length: 11step_kernel, not lm_step_kernel
            current = next((n for n in names if f"{len(n)}{n}" in line), None)
        elif current and "spill stores" in line:
            part = line.split(",")
            spill = tuple(int(p.split("bytes")[0]) for p in part[1:3])
        elif current and "Used" in line and "registers" in line:
            smem = [p for p in line.split(",") if "bytes smem" in p]
            found[current] = dict(
                registers=int(line.split("Used")[1].split("registers")[0]),
                smem=int(smem[0].split("bytes")[0]) if smem else 0,
                spill_stores=spill[0], spill_loads=spill[1])
            current = None
    return found


# which of K9 (0) or K10 (1) a sub-launch belongs to, by kernel name
BA_SUB_OF = {"lin_pair_kernel": 0, "lin_tile_kernel": 0, "lin_finish_kernel": 0,
             "step_kernel": 1, "schur_kernel": 1, "solve_kernel": 1, "backsub_kernel": 1}


def profile_groups(torch, groups, calls: int):
    """Per group (label, fn), the groups alternating K9 and K10 calls: the
    card's time per call of each kernel that ``calls`` calls of fn()
    launch, us by kernel name, from one torch.profiler session. The groups
    are told apart by runs of K9's and K10's kernels in launch order (a
    spin of the card between them keeps the runs apart); None if the
    profiler recorded no device event of the groups."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _, fn in groups:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and any(n in e.name for n in BA_SUB_KERNELS)),
                 key=lambda e: e.time_range.start)
    runs = []
    for e in evs:
        name = next(n for n in BA_SUB_KERNELS if n in e.name)
        if not runs or runs[-1][0] != BA_SUB_OF[name]:
            runs.append((BA_SUB_OF[name], {}))
        runs[-1][1][name] = runs[-1][1].get(name, 0.0) + e.time_range.elapsed_us() / calls
    if len(runs) != len(groups):
        return None
    return {label: run for (label, _), (_, run) in zip(groups, runs)}


# optimize_keyframe's parts, timed by wrapping them in their modules (the
# ones a tree has): the host's ms in each per call, no synchronize inside
BA_SPLIT_PARTS = {
    "models": ("_compact_points", "_optimize_impl", "_optimize_loop_device",
               "_optimize_device", "_finish_optimize", "set_new_frame_energy_th_from_lin",
               "reset_fej_newest", "_scatter_points"),
    "ops": ("optimize_params", "make_params", "empty_lin", "host_groups", "ba_linearize_cuda",
            "ba_step_cuda", "ba_accept_cuda", "ba_optimize_cuda", "pick"),
    "window": ("ba_keyframe_cuda", "_keyframe"),
    "cuda": ("require_cuda", "call")}


def ba_host_split(torch, args, calls: int = 20) -> dict:
    """``optimize_keyframe(*args)``'s split: the synchronized call (ms,
    the median of ``calls``), the card's time of it (``device_ms``), and
    the host's ms per call in each of its parts (BA_SPLIT_PARTS, each
    inclusive of the parts it calls; "epilogue": ``_optimize_impl`` less
    the loop, the tree's Python bookkeeping after it; "wrapper_calls": the
    kernel wrappers' calls per optimize_keyframe)."""
    from direct_stereo_slam_tpu_torch.models import ba
    from direct_stereo_slam_tpu_torch.ops import _cuda
    from direct_stereo_slam_tpu_torch.ops import ba as kb

    import importlib.util

    window = (importlib.import_module("direct_stereo_slam_tpu_torch.ops.window")
              if importlib.util.find_spec("direct_stereo_slam_tpu_torch.ops.window") else None)
    mods = {"models": ba, "ops": kb, "cuda": _cuda, "window": window}
    spent, count, saved = {}, {}, []

    def timed(name, fn):
        def inner(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
                count[name] = count.get(name, 0) + 1
        inner.launches = getattr(fn, "launches", 0)
        return inner

    for key, names in BA_SPLIT_PARTS.items():
        for name in names:
            if mods[key] is not None and hasattr(mods[key], name):
                saved.append((mods[key], name, getattr(mods[key], name)))
                setattr(mods[key], name, timed(name, getattr(mods[key], name)))
    try:
        ba.optimize_keyframe(*args)
        spent.clear()
        count.clear()
        total = call_ms(torch, lambda: ba.optimize_keyframe(*args), calls)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    card = device_ms(torch, lambda: ba.optimize_keyframe(*args), calls=5, samples=3)
    parts = {k: 1e3 * v / calls for k, v in spent.items()}
    loop = parts.get("_optimize_loop_device", parts.get("_optimize_device", 0.0))
    if "_optimize_impl" in parts:
        parts["epilogue"] = parts["_optimize_impl"] - loop
    wrappers = ("ba_linearize_cuda", "ba_step_cuda", "ba_accept_cuda", "ba_optimize_cuda")
    return dict(ms=statistics.median(total), card_ms=card, host_ms=parts,
                wrapper_calls=sum(count.get(w, 0) for w in wrappers) / calls,
                picks=count.get("pick", 0) / calls)


def ba_resident_turns(torch, st, cfg, iters, samples: int = 3) -> dict:
    """The resident launch against the queued chain on one window, both
    whole (the device work of ``_optimize_device`` and of
    ``_optimize_loop_queued`` + ``_finish_optimize``), the card's ms of each
    in turns resident / chain / chain / resident (``device_ms``)."""
    from direct_stereo_slam_tpu_torch.models import ba

    resident = lambda: ba._optimize_device(st, cfg, iters)
    chain = lambda: ba._finish_optimize(*ba._optimize_loop_queued(st, cfg, iters)[:2])
    return {"resident_chain_chain_resident": [
        device_ms(torch, f, calls=5, samples=samples)
        for f in (resident, chain, chain, resident)]}


def ba_split(torch, dev, path: str, calls: int = 50) -> dict:
    """``--ba-split FILE``: K9 (mode 0) and K10 on the window FILE holds
    (``--ba-window``), at both views (``ba_windows``): each call's card time
    (``device_ms``) and each sub-launch's (``profile_groups``), with the
    kernels' registers and spills; with ``--root``, of another checkout's
    kernels. Prints one line ``ba_split {...}`` and returns it."""
    import direct_stereo_slam_tpu_torch as port
    from direct_stereo_slam_tpu_torch.models import ba
    from direct_stereo_slam_tpu_torch.ops import _cuda
    from direct_stereo_slam_tpu_torch.ops import ba as kb

    saved = torch.load(path, weights_only=False)
    st_full = ba.BAState(*[x.to(dev) for x in saved[0]])
    cfg = saved[1]
    groups, whole, phases = [], {}, {}
    for NP, st in ba_windows(st_full, ba).items():
        params = kb.make_params(st, cfg)
        k9 = partial(kb.ba_linearize_cuda, params, 0)
        k9()
        lin = {f: params.bufs.lin[f][0].clone() for f in kb.LIN_FIELDS}
        states = {f: torch.stack([getattr(st, f)] * 2) for f in kb.STATE_FIELDS}
        p10 = kb.make_params(st, cfg, states, {f: torch.stack([v] * 2)
                                                for f, v in lin.items()})
        p10.bufs.ctrl_f[0] = 0.1
        k10 = partial(kb.ba_step_cuda, p10)
        for name, fn in ((f"K9[NP={NP}]", k9), (f"K10[NP={NP}]", k10)):
            groups.append((name, fn))
            whole[name] = device_ms(torch, fn)
        if hasattr(kb, "timer_buffer"):
            # one call of each with the phase stamps on
            buf = kb.timer_buffer(dev)
            params.struct.timers = p10.struct.timers = buf.data_ptr()
            k9()
            k10()
            torch.cuda.synchronize()
            params.struct.timers = p10.struct.timers = None
            D = 4 + 8 * st.num_slots
            phases[f"NP={NP}"] = kb.phase_us(buf, st.num_slots, sm_clock_mhz(),
                                             ((D * (D + 1) // 2 + D + 1) * 8 + 255) // 256)
    split = profile_groups(torch, groups, calls)
    # the whole optimize_keyframe: its host split and card time, and where
    # the tree has it the resident launch against the queued chain
    args = (st_full,) + tuple(saved[1:])
    host = ba_host_split(torch, args)
    resident = {}
    if hasattr(kb, "ba_optimize_cuda"):
        for NP, st in ba_windows(st_full, ba).items():
            resident[f"NP={NP}"] = ba_resident_turns(torch, st, cfg, args[2])
    out = dict(root=os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))),
               card=card_info(), window=st_full.num_points, device_ms=whole,
               optimize_keyframe=host, resident_vs_chain=resident or "not in this tree",
               sub_launch_us=split if split is not None else "not measured",
               phases_us=phases or "not measured",
               host_sizes=[int(x) for x in torch.bincount(st_full.p_host[st_full.p_valid],
                                                          minlength=st_full.num_slots)],
               pool_hosts=[int(x) for x in torch.bincount(st_full.p_host,
                                                          minlength=st_full.num_slots)],
               ptxas=ptxas_usage(_cuda.load_library().build_log,
                                 BA_SUB_KERNELS + ("accept_kernel", "optimize_kernel")))
    print("ba_split " + json.dumps(out), flush=True)
    return out


def ba_split_child(torch, args) -> dict:
    """``ba_split`` on this window as a new process (``--ba-split``: its
    own torch.profiler session, which a process gets only once); its
    ``ba_split`` line is printed and returned."""
    from direct_stereo_slam_tpu_torch.models import ba

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ba_") as tmp:
        path = os.path.join(tmp, "window.pt")
        torch.save((ba.BAState(*[x.cpu() for x in args[0]]),) + tuple(args[1:]), path)
        out = subprocess.run([sys.executable, os.path.join(here, "chip_smoke.py"),
                              "--ba-split", path], capture_output=True, text=True,
                             timeout=600, cwd=here)
    line = next((ln for ln in out.stdout.splitlines() if ln.startswith("ba_split ")), None)
    if out.returncode != 0 or line is None:
        fail(f"ba split: exit {out.returncode}\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    print(line, flush=True)
    return json.loads(line[len("ba_split "):])


def ba_phase(torch, dev, calls):
    """K9-K11 against their plain versions on the e2e run's fullest window
    (the keyframe call with the most valid slots), at the compact view of
    BA_COMPACT points and at the full pool, then the whole
    ``optimize_keyframe`` on the card against the plain BA on the same
    card state, two runs bit-equal, and one run with no host read.
    Returns the kernel rows."""
    from direct_stereo_slam_tpu_torch.models import ba
    from direct_stereo_slam_tpu_torch.ops import ba as kb

    pick, nvalid, (st_full, cfg, iters, slot, budget) = fullest_call(calls)
    W = st_full.num_slots
    D = 4 + 8 * W
    print(f"ba: the e2e run's keyframe call {pick + 1} of {len(calls)}: "
          f"{nvalid} of {W} slots valid, "
          f"{int(st_full.p_valid.sum())} valid points in a pool of {st_full.num_points}, "
          f"{iters} iterations, compact budget {budget}", flush=True)
    rows = []
    windows = ba_windows(st_full, ba)
    lam = 0.1
    for NP, st in windows.items():
        tag = f"NP={NP},W={W}"
        n_pairs, n_pixels = pair_pixels(torch, st)
        # ---- K9
        params = kb.make_params(st, cfg)
        k9 = lambda: kb.ba_linearize_cuda(params, 0)
        k9()
        lk = ba.Linearization(**{f: params.bufs.lin[f][0].clone() for f in kb.LIN_FIELDS})
        lp = ba.linearize_plain(st, cfg)
        # each sum within 1e-4 x max|entry|, or, where it cancels, within
        # 1e-4 x the largest sum of its terms' magnitudes
        mag = ba.linearize_plain(st, cfg, magnitudes=True)
        errs = {n: min(rel_err(torch, getattr(lk, n), getattr(lp, n)),
                       float(torch.max(torch.abs(getattr(lk, n) - getattr(lp, n))))
                       / float(torch.max(getattr(mag, n)).clamp(min=1e-30)))
                for n in ("Hff", "bf", "Hfd", "Hdd", "bd")}
        errs["pair_energy"] = rel_err(torch, lk.pair_energy, lp.pair_energy)
        th = torch.maximum(st.energy_th[st.p_host][:, None], st.energy_th[None, :])
        near = torch.abs(lp.pair_energy - th) <= 1e-5 * th
        flips = {n: int((getattr(lk, n) != getattr(lp, n)).sum()) for n in ("pair_good",
                                                                          "pair_in")}
        far = sum(int(((getattr(lk, n) != getattr(lp, n)) & ~near).sum()) for n in flips)
        again = ba.linearize(st, cfg)
        same = all(torch.equal(x, y) for x, y in zip(lk, again))
        print(f"K9 ba_linearize {tag}: {n_pairs} live pairs; from linearize_plain (x "
              f"max|entry| or, where smaller, x the largest sum of the terms' magnitudes) "
              + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + f"; energy {float(lk.energy):.6g} vs {float(lp.energy):.6g}; num_terms "
              f"{float(lk.num_terms):.0f} vs {float(lp.num_terms):.0f}; pair flips {flips} "
              f"({int(near.sum())} lanes within 1e-5 of their threshold, {far} flips "
              f"outside them); linearize() twice bit-equal: {same}", flush=True)
        if not max(errs.values()) < 1e-4 or far or not same:
            fail(f"K9 at {tag}: rel {errs}, flips outside the threshold band {far}, "
                 f"bit-equal {same}")
        ms, pms = ab_ms(torch, k9, lambda: ba.linearize_plain(st, cfg),
                        plain_kw=dict(repeats=5, inner=2))
        dms = device_ms(torch, k9)
        call = statistics.median(call_ms(torch, lambda: ba.linearize(st, cfg), 10))
        nb, no = ba_bytes_ops(st, D, n_pairs, n_pixels)
        print(f"K9 ba_linearize {tag}: kernel {ms:.4f} ms (queued on the card {dms} ms; "
              f"linearize() with its parameter block built per call {call:.4f} ms), plain "
              f"(index_add_) {pms:.4f} ms", flush=True)
        rows.append(row(f"ba_linearize[{tag}]", "ba.cu",
                        "direct_stereo_slam_tpu/models/ba.py:198",
                        max(float(torch.max(torch.abs(getattr(lk, n) - getattr(lp, n))))
                            for n in ("Hff", "bf", "Hfd", "Hdd", "bd")), ms, pms, nb, no))
        rows[-1].update(device_ms=dms, live_pairs=n_pairs, pixels_read=n_pixels,
                        pair_flips_near_threshold=sum(flips.values()))

        # ---- K10 on K9's linearization
        states = {f: torch.stack([getattr(st, f)] * 2) for f in kb.STATE_FIELDS}
        lins = {f: torch.stack([getattr(lk, f)] * 2) for f in kb.LIN_FIELDS}
        p10 = kb.make_params(st, cfg, states, lins)
        p10.bufs.ctrl_f[0] = lam
        k10 = lambda: kb.ba_step_cuda(p10)
        k10()
        lam_t = torch.tensor(lam, device=dev)

        def k10_plain():
            x, x_d = ba.solve_step(st, lk, lam_t, cfg)
            return x, x_d, ba._step_converged(x, x_d, st, cfg), ba.apply_step(st, x, x_d)

        x, x_d, conv, _ = k10_plain()
        xk, xdk = p10.bufs.scratch["x"].clone(), p10.bufs.scratch["x_d"].clone()
        ex, exd = rel_err(torch, xk, x), rel_err(torch, xdk, x_d)
        ck = bool(p10.bufs.ctrl_i[2])
        print(f"K10 ba_step {tag}: x rel {ex:.2e}, x_d rel {exd:.2e} from solve_step "
              f"(LU with partial pivoting vs solve_ex), converged {ck} vs {bool(conv)}",
              flush=True)
        if not (ex < 1e-3 and exd < 1e-3 and ck == bool(conv)):
            fail(f"K10 at {tag}: x rel {ex:.3g}, x_d rel {exd:.3g}, converged {ck} vs "
                 f"{bool(conv)}")
        ms, pms = ab_ms(torch, k10, k10_plain, plain_kw=dict(repeats=5, inner=2))
        dms = device_ms(torch, k10)
        Hp, bp, _, _ = ba.damped_system(st, lk, lam_t, cfg)
        lib = median_ms(torch, lambda: torch.linalg.solve_ex(Hp, -bp[:, None]))
        print(f"K10 ba_step {tag}: kernel {ms:.4f} ms (queued on the card {dms} ms), plain "
              f"{pms:.4f} ms; torch.linalg.solve_ex on the {D}x{D} system {lib:.4f} ms",
              flush=True)
        rows.append(row(f"ba_step[{tag}]", "ba.cu",
                        "direct_stereo_slam_tpu/models/ba.py:551",
                        max(float(torch.max(torch.abs(xk - x))),
                            float(torch.max(torch.abs(xdk - x_d)))), ms, pms,
                        NP * (D * 4 + 17) + 2 * D * D * 4 + NP * 8 + D * 8,
                        ba_step_ops(NP, D)))
        rows[-1].update(device_ms=dms, library_ms=lib,
                        library=f"torch.linalg.solve_ex on the {D}x{D} damped system")

        # ---- K11 after one K10 -> K9 on the candidate
        kb.ba_accept_cuda(p10, -1)
        e0 = float(p10.bufs.ctrl_f[1])
        e0_plain = float(ba.total_energy(st, lk, cfg))
        kb.ba_linearize_cuda(p10, 1)
        kb.ba_accept_cuda(p10, 0)
        cand = st._replace(**{f: p10.bufs.state[f][1] for f in kb.STATE_FIELDS})
        lin1 = ba.Linearization(**{f: p10.bufs.lin[f][1] for f in kb.LIN_FIELDS})
        e1 = float(ba.total_energy(cand, lin1, cfg))
        accept = e1 < e0_plain and float(lin1.num_terms) >= 0.3 * float(lk.num_terms)
        margin = abs(e1 - e0_plain) / abs(e0_plain)
        cur, lam1 = int(p10.bufs.ctrl_i[0]), float(p10.bufs.ctrl_f[0])
        print(f"K11 ba_accept {tag}: e_old {e0:.7g} vs total_energy {e0_plain:.7g}; the "
              f"candidate's {e1:.7g} (margin {margin:.2e}): kernel {'accepts' if cur else 'rejects'}"
              f" (lam {lam1:.4g}), plain {'accepts' if accept else 'rejects'}", flush=True)
        if abs(e0 - e0_plain) > 1e-5 * abs(e0_plain) or (
                bool(cur) != accept and margin > 1e-5):
            fail(f"K11 at {tag}: e_old {e0} vs {e0_plain}, decision {cur} vs {accept}")
        k11 = lambda: kb.ba_accept_cuda(p10, -1)
        k11_plain = lambda: ba.total_energy(st, lk, cfg) < ba.total_energy(cand, lin1, cfg)
        ms, pms = ab_ms(torch, k11, k11_plain)
        dms = device_ms(torch, k11)
        rows.append(row(f"ba_accept[{tag}]", "ba.cu",
                        "direct_stereo_slam_tpu/models/ba.py:645",
                        abs(e0 - e0_plain), ms, pms, D * D * 4 + 3 * D * 4 + 64,
                        2 * D * D + 6 * D))
        rows[-1].update(device_ms=dms)
        print(f"K11 ba_accept {tag}: kernel {ms:.4f} ms (queued on the card {dms} ms), plain "
              f"(two total energies) {pms:.4f} ms", flush=True)

    # ---- the resident launch against the queued chain, and against the plain loop
    for NP, st in windows.items():
        tag = f"NP={NP},W={W}"
        params = kb.optimize_params(st, cfg)
        got = ba._optimize_device(st, cfg, iters, params)
        q_state, q_lin, q_params = ba._optimize_loop_queued(st, cfg, iters)
        want = ba._finish_optimize(q_state, q_lin)
        diff = [n for n in kb.STATE_FIELDS + ("p_res_good", "p_num_good", "p_last_res")
                if not torch.equal(bits(getattr(got[0], n)), bits(getattr(want[0], n)))]
        diff += [n for n in kb.LIN_FIELDS
                 if not torch.equal(bits(getattr(got[3], n)), bits(getattr(want[3], n)))]
        diff += [n for n, a, b in (("rmse", got[1], want[1]), ("ok", got[2], want[2]),
                                   ("ctrl_i", params.bufs.ctrl_i, q_params.bufs.ctrl_i),
                                   ("ctrl_f", params.bufs.ctrl_f, q_params.bufs.ctrl_f))
                 if not torch.equal(bits(a), bits(b))]
        rounds = int(params.bufs.ctrl_i[3])
        if diff:
            fail(f"the resident BA launch at {tag} differs from the queued chain in {diff}")
        timers = kb.timer_buffer(dev)
        p2 = kb.optimize_params(st, cfg)
        p2.struct.timers = timers.data_ptr()
        again = ba._optimize_device(st, cfg, iters, p2)
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(list(got[0]) + list(got[1:3]),
                                                                 list(again[0]) + list(again[1:3]))):
            fail(f"the resident BA launch at {tag}: the phase stamps changed its output")
        phases = kb.optimize_phases(timers, rounds)
        grid = kb.optimize_grid(W, NP)
        turns = ba_resident_turns(torch, st, cfg, iters)["resident_chain_chain_resident"]
        def plain_loop():
            with plain_ba():
                return ba._optimize_device(st, cfg, iters)

        plain = plain_loop()
        err = float(torch.max(torch.abs(got[0].T_current() - plain[0].T_current())))
        ms, pms = ab_ms(torch, lambda: ba._optimize_device(st, cfg, iters), plain_loop,
                        plain_kw=dict(repeats=3, inner=1))
        print(f"ba resident launch {tag}: bit-equal to the queued chain and _finish_optimize "
              f"(state, linearization, bookkeeping, control); {rounds} rounds of {iters}; "
              f"poses {err:.2e} from the plain loop; the card's ms in turns resident / chain / "
              f"chain / resident {turns}; one launch {ms:.4f} ms, the plain loop {pms:.4f} ms; "
              f"grid {grid}; phase stamps (block 0, us per round) {json.dumps(phases)}",
              flush=True)
        nb9, no9 = ba_bytes_ops(st, D, *pair_pixels(torch, st))
        n_bytes = (1 + rounds) * nb9 + rounds * (NP * (D * 4 + 17) + 2 * D * D * 4)
        n_ops = (1 + rounds) * (no9 + 2 * D * D + 6 * D) + rounds * ba_step_ops(NP, D)
        rows.append(row(f"ba_optimize[{tag}]", "ba.cu",
                        "direct_stereo_slam_tpu/models/ba.py:645", err, ms, pms, n_bytes,
                        n_ops))
        mine = [t for t in (turns[0], turns[3]) if t is not None]
        rows[-1].update(device_ms=sum(mine) / len(mine) if mine else None,
                        chain_device_ms=[turns[1], turns[2]], rounds=rounds, grid=grid,
                        phases_us=phases, iterations=iters)

    # ---- K9's and K10's sub-launches and registers
    args = (st_full, cfg, iters, slot, budget)
    split = ba_split_child(torch, args)
    usage = split["ptxas"]
    print("ba kernels (registers, shared memory bytes, spill stores / loads): " + "; ".join(
        f"{k} {v['registers']} regs, {v['smem']} B smem, spills {v['spill_stores']} / "
        f"{v['spill_loads']}" for k, v in usage.items()), flush=True)
    if any(v["spill_stores"] or v["spill_loads"] for v in usage.values()):
        print("ba kernels: ptxas spilled registers (see above)", flush=True)
    for r in rows:
        name, np_ = r["name"].split("[")[0], r["name"].split("NP=")[1].split(",")[0]
        key = {"ba_linearize": "K9", "ba_step": "K10"}.get(name)
        if key and isinstance(split["sub_launch_us"], dict):
            r["sub_launch_us"] = split["sub_launch_us"][f"{key}[NP={np_}]"]
        r["ptxas"] = {k: v for k, v in usage.items() if k in {
            "ba_linearize": ("lin_pair_kernel", "lin_finish_kernel"),
            "ba_step": ("step_kernel",), "ba_accept": ("accept_kernel",),
            "ba_optimize": ("optimize_kernel",)}[name]}
    print(f"ba optimize_keyframe's split (the e2e window, {iters} iterations, compact budget "
          f"{budget}): {json.dumps(split['optimize_keyframe'])}", flush=True)

    # ---- the whole optimize_keyframe: card against the plain loop
    counters = (kb.ba_linearize_cuda, kb.ba_step_cuda, kb.ba_accept_cuda, kb.ba_optimize_cuda)
    before = [fn.launches for fn in counters]
    card = ba.optimize_keyframe(*args)
    made = [fn.launches - b for fn, b in zip(counters, before)]
    if made != [0, 0, 0, 1]:
        fail(f"optimize_keyframe on the card made launches K9 / K10 / K11 / resident {made}, "
             f"not one resident launch")
    card2 = ba.optimize_keyframe(*args)
    same = all(torch.equal(x, y) for x, y in zip(list(card[0]) + list(card[1:]),
                                                  list(card2[0]) + list(card2[1:])))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ba.optimize_keyframe(*args)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with plain_ba():
        plain = ba.optimize_keyframe(*args)
        plain_rev = ba.optimize_keyframe(reordered(st_full, ba), *args[1:])
        pms = statistics.median(call_ms(torch, lambda: ba.optimize_keyframe(*args), 3))
    kms = statistics.median(call_ms(torch, lambda: ba.optimize_keyframe(*args), 10))

    def gap(ref):
        dT = float(torch.max(torch.abs(card[0].T_current() - ref[0].T_current())))
        dr = abs(float(card[1]) - float(ref[1])) / float(ref[1])
        return dT, dr, bool(card[2]) == bool(ref[2])

    g, g_rev = gap(plain), gap(plain_rev)
    spread = float(torch.max(torch.abs(plain[0].T_current() - plain_rev[0].T_current())))
    ok = lambda gg: gg[0] < 1e-3 and gg[1] < 1e-3 and gg[2]
    print(f"ba optimize_keyframe ({iters} iterations, compact budget {budget}): card vs the "
          f"plain loop on the same card state: poses {g[0]:.2e}, rmse rel {g[1]:.2e}, same ok "
          f"{g[2]} (vs the plain loop on the reversed pool: {g_rev[0]:.2e}, {g_rev[1]:.2e}; "
          f"the plain loop's own spread {spread:.2e}); two card runs bit-equal {same}; no "
          f"host read under set_sync_debug_mode('error'); launches K9 / K10 / K11 / "
          f"resident {made}; "
          f"{kms:.3f} ms on the card vs {pms:.3f} ms plain (synchronized calls)", flush=True)
    if not (ok(g) or ok(g_rev)) or not same:
        fail(f"optimize_keyframe on the card: {g} / {g_rev} from the plain loop, bit-equal "
             f"{same}")
    for r in rows:
        r["optimize_keyframe_ms"] = kms
        r["optimize_keyframe_plain_ms"] = pms
    return rows


# ---------------------------------------------------------------------------
# the BA's state programs: K16 (window_pose), K17 (the keyframe BA's
# prologue and epilogue), K18 (marginalize)
# ---------------------------------------------------------------------------

# f32 operations of K16 a slot (se3_exp ~90, T_all 16 x 7, T_inv 12, T_rh
# 16 x 7, aff 2) and its bytes a slot (T_zero 64 and delta 32 read; T_all,
# T_inv, T_rh 3 x 64 and aff 8 written; aff_zero 8 read)
K16_SLOT_OPS, K16_SLOT_BYTES = 90 + 112 + 12 + 112 + 2, 64 + 32 + 3 * 64 + 8 + 8
# bytes of a pool row K17's prologue copies into the compact view (valid,
# host, u, v, idepth_zero, idepth, 8 colours, 8 weights, prior, num_good, 2
# states) and that its epilogue scatters back (idepth, valid, num_good, 2
# states, Hdd), without the W residual flags
K17_ROW_BYTES = 1 + 8 + 4 * 4 + 32 + 32 + 4 + 4 + 8
# bytes K18 reads of a flagged point (host, u, v, idepth_zero, idepth,
# prior, 8 colours, 8 weights, Hdd) and of a frame (T_zero, aff_zero,
# exposure, energy_th; frame_valid, frame_id and delta read and written)
# K18's points stage against the plain version: HM's and bM's largest
# error over the largest entry of the change the stage made (change_err)
K18_TOL = 1e-5
K18_POINT_BYTES = 8 + 5 * 4 + 32 + 32 + 4
K18_FRAME_BYTES = 64 + 8 + 4 + 4 + 2 * (1 + 4 + 32)
K17_OUT_BYTES = 4 + 1 + 4 + 8 + 4


def window_phase(torch, dev, ba_calls, marg_calls):
    """K16-K18 against their plain versions on the e2e run's fullest
    window (the keyframe call with the most valid slots) and its fullest
    keyframe tail (the most points marginalized): K16 and K17 bit-equal
    to the plain versions (K17: around the same resident launch), K18's
    validity and bookkeeping bit-equal, its points stage's HM / bM within
    K18_TOL of the largest entry of their change and the whole call no
    further from float64 frame marginalizations of its points stage than
    twice the plain version plus K18_TOL of the largest entry, two runs of
    each bit-equal; each timed against its plain
    version in turns (kernel ms: the entry point's launch alone, CUDA
    events around back-to-back calls), its card time (``device_ms``), the
    wrapper's host ms to issue it, and its bound. Returns the kernel
    rows."""
    from direct_stereo_slam_tpu_torch.models import ba
    from direct_stereo_slam_tpu_torch.ops import _cuda
    from direct_stereo_slam_tpu_torch.ops import ba as kb
    from direct_stereo_slam_tpu_torch.ops import window as win

    pick, nvalid, (st, cfg, iters, slot, budget) = fullest_call(ba_calls)
    W, NP = st.num_slots, st.num_points
    D = 4 + 8 * W
    print(f"window: the e2e run's keyframe call {pick + 1} of {len(ba_calls)}: {nvalid} of "
          f"{W} slots valid, {int(st.p_valid.sum())} valid points in a pool of {NP}, compact "
          f"budget {budget}, newest slot {slot}", flush=True)
    usage = ptxas_usage(_cuda.load_library().build_log,
                        ("window_pose_kernel", "ba_prologue_kernel", "ba_epilogue_kernel",
                         "marg_kernel"))
    print(f"window: ptxas (registers, shared memory, spill stores / loads): {usage}",
          flush=True)
    rows = []
    # ---- K16
    pose_args = (st.T_zero, st.delta, st.aff_zero, st.calib_zero, st.calib_delta, slot)
    got = win.window_pose_cuda(*pose_args)
    again = win.window_pose_cuda(*pose_args)
    want = win.window_pose_plain(*pose_args)
    equal = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))
    twice = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again))
    print(f"K16 window_pose: bit-equal to the plain version {equal}; two runs bit-equal "
          f"{twice}", flush=True)
    if not (equal and twice):
        fail(f"K16: bit-equal to plain {equal}, two runs {twice}")
    k16 = lambda: win.window_pose_cuda(*pose_args)
    ms, pms = ab_ms(torch, k16, lambda: win.window_pose_plain(*pose_args),
                    plain_kw=dict(repeats=5, inner=4))
    dms, ims = device_ms(torch, k16), issue_ms(torch, k16)
    print(f"K16 window_pose: kernel {ms:.4f} ms; on the card {dms} ms; wrapper (host issue) "
          f"{ims:.4f} ms; plain {pms:.4f} ms", flush=True)
    rows.append(row("window_pose", "window.cu", "direct_stereo_slam_tpu/models/ba.py:125",
                    0.0, ms, pms, W * K16_SLOT_BYTES + 48, W * K16_SLOT_OPS))
    rows[-1].update(device_ms=dms, wrapper_ms=ims, ptxas=usage.get("window_pose_kernel"),
                    also_replaces=["direct_stereo_slam_tpu/models/ba.py:895",
                                   "direct_stereo_slam_tpu/models/ba.py:988",
                                   "direct_stereo_slam_tpu/models/frontend.py:71"])
    # ---- K17, around the same resident launch as its plain version
    got = ba.optimize_keyframe(st, cfg, iters, slot, budget)
    again = ba.optimize_keyframe(st, cfg, iters, slot, budget)
    want = ba.optimize_keyframe_plain(st, cfg, iters, slot, budget)
    flat = lambda r: [bits(x) for x in list(r[0]) + list(r[1:])]
    equal = all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))
    twice = all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
    print(f"K17 ba_keyframe: the whole optimize_keyframe bit-equal to optimize_keyframe_plain "
          f"around the same resident launch {equal}; two runs bit-equal {twice}", flush=True)
    if not (equal and twice):
        fail(f"K17: bit-equal to plain {equal}, two runs {twice}")
    B = budget if budget is not None and budget < NP else NP
    ws = win._keyframe(st, cfg, B, B < NP)
    pro = lambda: win.ba_prologue_cuda(ws.kf)
    epi = lambda: win.ba_epilogue_cuda(ws.kf)
    # the struct set for this window; its outputs kept alive while the
    # entry points run again into them
    held = ba.optimize_keyframe(st, cfg, iters, slot, budget)

    def pro_plain():
        sub, rows_, _ = ba._compact_points(st, B) if B < NP else (st, None, None)
        kb.host_groups(sub.p_host, W)

    sub, rows_, _ = ba._compact_points(st, B) if B < NP else (st, None, None)
    work, _, _, lin = ba._optimize_device(sub, cfg, iters)
    epi_plain = lambda: ba.keyframe_epilogue_plain(st, work, rows_, lin, slot, cfg)
    whole = lambda: ba.optimize_keyframe(st, cfg, iters, slot, budget)
    ims = issue_ms(torch, whole) - issue_ms(torch, lambda: kb.ba_optimize_cuda(ws.params,
                                                                                iters))
    n2 = 1 << max(B - 1, 1).bit_length()
    for name, fn, plain, nb, no in (
            ("ba_keyframe_prologue", pro, pro_plain,
             NP + B * (2 * K17_ROW_BYTES + 2 * W) + 3 * B * 4 + B * 4 + 4 * (W + 1),
             0),
            ("ba_keyframe_epilogue", epi, epi_plain,
             B * (K17_OUT_BYTES + W + 5) + NP * (2 * K17_OUT_BYTES + 2 * W) + 64 * W,
             n2 // 2 * (n2.bit_length() - 1) * n2.bit_length() // 2 + 200)):
        ms, pms = ab_ms(torch, fn, plain, plain_kw=dict(repeats=5, inner=2))
        dms = device_ms(torch, fn)
        print(f"K17 {name}: kernel {ms:.4f} ms; on the card {dms} ms; plain {pms:.4f} ms",
              flush=True)
        rows.append(row(name, "window.cu", {
            "ba_keyframe_prologue": "direct_stereo_slam_tpu/models/ba.py:908",
            "ba_keyframe_epilogue": "direct_stereo_slam_tpu/models/ba.py:755"}[name],
            0.0, ms, pms, nb, no))
        rows[-1].update(device_ms=dms, ptxas=usage.get(name.replace(
            "ba_keyframe_", "ba_") + "_kernel"), budget=B)
    rows[-2]["wrapper_ms"] = rows[-1]["wrapper_ms"] = ims
    torch.cuda.synchronize()
    del held
    print(f"K17: its wrapper's host ms besides the resident launch's {ims:.4f} "
          f"(prologue and epilogue together)", flush=True)
    # ---- K18 on the fullest keyframe tail
    n_marg = [int(np.asarray(a[2]).sum()) for a in marg_calls]
    mp = max(range(len(n_marg)), key=lambda i: (n_marg[i], len(marg_calls[i][4]), i))
    st_m, lin_m, marg, drop, slots, cfg_m = marg_calls[mp]
    got = ba.marginalize(st_m, lin_m, marg, drop, slots, cfg_m)
    again = ba.marginalize(st_m, lin_m, marg, drop, slots, cfg_m)
    want = ba.marginalize_plain(st_m, lin_m, marg, drop, slots, cfg_m)
    fixed = ("p_valid", "frame_valid", "frame_id", "p_res_good", "delta")
    equal = all(torch.equal(bits(getattr(got, f)), bits(getattr(want, f))) for f in fixed)
    # the points stage alone (no frame), against the plain version's; then
    # each whole result against float64 frame marginalizations of its own
    # points stage
    got_p = ba.marginalize(st_m, lin_m, marg, drop, [], cfg_m)
    want_p = ba.marginalize_plain(st_m, lin_m, marg, drop, [], cfg_m)
    errs = {f: change_err(torch, getattr(got_p, f), getattr(want_p, f), getattr(st_m, f))
            for f in ("HM", "bM")}
    ref_k, ref_p = frames64(torch, got_p, slots), frames64(torch, want_p, slots)
    # (kernel, plain) distances over the largest entry: the frame stage
    # works on the whole prior, so its f32 error scales with it
    f64 = {}
    for f in ("HM", "bM"):
        scale = float(torch.max(torch.abs(ref_p[f])).clamp(min=1e-30))
        f64[f] = (float(torch.max(torch.abs(getattr(got, f).double() - ref_k[f]))) / scale,
                  float(torch.max(torch.abs(getattr(want, f).double() - ref_p[f]))) / scale)
    f64_ok = all(e_k <= 2.0 * e_p + K18_TOL for e_k, e_p in f64.values())
    abs_err = max(float(torch.max(torch.abs(getattr(got, f) - getattr(want, f))))
                  for f in ("HM", "bM"))
    twice = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again))
    print(f"K18 marginalize: the e2e run's tail {mp + 1} of {len(marg_calls)}: "
          f"{n_marg[mp]} points folded in, {int(np.asarray(drop).sum())} dropped, frames "
          f"{list(slots)}; validity and bookkeeping bit-equal to the plain version {equal}; the "
          f"points stage's HM / bM error over the largest entry of their change {errs}; the "
          f"whole call's distance from float64 frames on its own points stage over the "
          f"largest entry (kernel, plain) {f64}; two runs bit-equal {twice}", flush=True)
    if not (equal and twice and f64_ok and all(e <= K18_TOL for e in errs.values())):
        fail(f"K18: bit-equal {equal}, points stage {errs}, float64 {f64}, two runs {twice}")
    k18 = lambda: ba.marginalize(st_m, lin_m, marg, drop, slots, cfg_m)
    ms, pms = ab_ms(torch, k18, lambda: ba.marginalize_plain(st_m, lin_m, marg, drop, slots,
                                                             cfg_m),
                    plain_kw=dict(repeats=5, inner=2))
    dms, ims = device_ms(torch, k18), issue_ms(torch, k18)
    nm, nf = n_marg[mp], len(slots)
    # K9's pixel pass over the flagged points' live pairs (each image pixel
    # they read once), the flagged points' rows, the flags, p_valid and
    # p_res_good read and written, HM and bM read and written, the frames
    marg_d = torch.as_tensor(np.asarray(marg, bool), device=st_m.p_valid.device)
    n_pairs_m, n_pix_m = pair_pixels(torch, st_m, st_m.p_valid & marg_d)
    nb = (n_pix_m * 12 + nm * K18_POINT_BYTES + NP + 2 * NP * (1 + W)
          + 2 * 4 * (D * D + D) + W * K18_FRAME_BYTES + 2 * 4 * 4)
    # operations: the residuals; a multiply-add per entry of each flagged
    # point's outer product Hfd^T Hfd / Hdd over its nonzero columns (the
    # calibration, its host and its live targets) and of its b_sc; per
    # frame the 8x8 inverse and the rank-8 update of HM
    t = torch.arange(W, device=marg_d.device)
    live = ((st_m.p_valid & marg_d)[:, None] & st_m.frame_valid[None, :]
            & (t[None, :] != st_m.p_host[:, None]) & st_m.p_res_good).sum(1)
    cols = torch.where(live > 0, 4 + 8 * (1 + live), torch.zeros_like(live)).double()
    schur = int(torch.sum(cols * (cols + 1) + 2 * cols))
    no = n_pairs_m * 8 * BA_RES_OPS + schur + nf * (16 * D * D + 8 * 8 * 16)
    print(f"K18 marginalize: kernel (with its flags' upload) {ms:.4f} ms; on the card {dms} "
          f"ms; wrapper (host issue) {ims:.4f} ms; plain {pms:.4f} ms", flush=True)
    rows.append(row("marginalize", "window.cu", "direct_stereo_slam_tpu/models/ba.py:796",
                    abs_err, ms, pms, nb, no))
    rows[-1].update(device_ms=dms, wrapper_ms=ims, ptxas=usage.get("marg_kernel"),
                    marginalized_points=nm, live_pairs=n_pairs_m, pixels_read=n_pix_m,
                    frames=nf, points_stage_change_err=errs,
                    frames_float64=f64,
                    also_replaces=["direct_stereo_slam_tpu/models/ba.py:832",
                                   "direct_stereo_slam_tpu/models/ba.py:838"])
    return rows


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
                top = sorted(self.sites.get(kind, {}).items(), key=lambda kv: -kv[1])
                top = top if kind == "keyframe" else top[:6]
                out[kind] = dict(calls=len(w), median=float(np.median(w)),
                                 mean=float(np.mean(w)), max=int(max(w)), sites=dict(top))
        return out


def count_waits(torch, cfg, intr, ds, frames, dev) -> dict:
    """One pass of a fresh SLAMNode over the frames with the host's
    blocking waits on the card counted per call (``WaitCounter``): the
    summary by kind of call (benign, keyframe, other), with the sites."""
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    counter = WaitCounter(torch)
    run_sequence(torch, SLAMNode, cfg, intr, ds, frames, dev, per_call=counter)
    return counter.summary()


FPS_VARIANTS = ("plain_activation", "eager_tail", "idepth_ulp_up", "idepth_ulp_down")


def fps_variant(name: str) -> None:
    """A variant of the port for ``--fps``, to split what moved a run:
    ``plain_activation`` sends the front end's K12 and K13 calls to their
    plain versions on the card (the same function, its sums in another
    order); ``eager_tail`` commits each keyframe tail in the call that
    made the keyframe instead of after the next tracker read;
    ``idepth_ulp_up`` / ``_down`` move every idepth the activation returns
    one f32 step up / down (a perturbation of the size of K12's rounding,
    applied to whichever activation the variants before it left)."""
    if name.startswith("idepth_ulp_"):
        import torch

        from direct_stereo_slam_tpu_torch.ops import activate as act

        inner = act.gate_compact_activate
        to = float("inf") if name.endswith("up") else float("-inf")

        def nudged(*a):
            ok, idepth, lane, drop = inner(*a)
            return ok, torch.nextafter(idepth, torch.full_like(idepth, to)), lane, drop

        act.gate_compact_activate = nudged
    elif name == "plain_activation":
        from direct_stereo_slam_tpu_torch.ops import activate as act

        act.gate_compact_activate = act.gate_compact_activate_plain
        act.allocate_insert_consume = act.allocate_insert_consume_plain
    elif name == "eager_tail":
        from direct_stereo_slam_tpu_torch.models.frontend import FrontEnd

        dispatch = FrontEnd._finalize_keyframe

        def eager(self, *a):
            dispatch(self, *a)
            self.flush_pending()

        FrontEnd._finalize_keyframe = eager


def fps_only(torch, dev, variants=()) -> None:
    """``--fps``: the e2e sequence (a warm-up pass, a timed pass, a pass
    with a device synchronize at the end of every span, one with the
    waits counted) and the 160-frame loop phase (a timed run, then a
    synchronized one: FPS, stages, loops, translation ATE of the odometry
    and of the loop-closed trajectory), not gated. For comparing two trees
    in turns in one call, since host-bound spans move between calls: with
    ``--root``, the port of another checkout (the parent commit, whose
    kernels this script's counters may not know); ``variants`` from
    FPS_VARIANTS. Prints one line ``fps {...}``."""
    import direct_stereo_slam_tpu_torch as port
    from direct_stereo_slam_tpu_torch.runtime.eval import run_sequence as run_loop
    from direct_stereo_slam_tpu_torch.runtime.eval import score_rows, timing_table
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    for name in variants:
        fps_variant(name)
    stages = ("activate", "trace", "template", "dso_opt", "scale_opt", "point_marg",
              "frame_marg", "pose_graph_opt", "icp", "direct_est", "per_frame")
    table = lambda timers: {k: v for k, v in timing_table(timers).items() if k in stages}
    ds, frames, cfg, intr = sequence_setup(dev, E2E_FRAMES, speed=0.4)
    run_sequence(torch, SLAMNode, cfg, intr, ds, frames, dev)
    timed, _, _, e2e_dt = run_sequence(torch, SLAMNode, cfg, intr, ds, frames, dev)
    synced = run_sequence(torch, SLAMNode, cfg, intr, ds, frames, dev, sync_timers=True)[0]
    waits = count_waits(torch, cfg, intr, ds, frames, dev)
    splits = dict(activate=activate_split(torch, dev, cfg, intr, ds, frames),
                  template=template_split(torch, dev, cfg, intr, ds, frames),
                  marg=marg_split(torch, dev, cfg, intr, ds, frames),
                  scale=scale_split(torch, dev, cfg, intr, ds, frames))
    lds, lframes, lcfg = loop_setup(dev, LOOP_FRAMES, LOOP_MARGIN)
    loop = {}
    for mode in ("timed", "synchronized"):
        node, handler, dt = run_loop(lframes, lcfg, lds.K, lds.t_cam1_cam0, levels=LEVELS,
                                     device=dev, sync_timers=mode == "synchronized")
        handler.close()
        gt = lds.poses[:, :3, 3]
        loop[mode] = dict(fps=LOOP_FRAMES / dt, stages=table(node.timers),
                          loops=handler.direct_loop_count + handler.icp_loop_count,
                          direct_loops=handler.direct_loop_count,
                          icp_loops=handler.icp_loop_count, keyframes=node.frontend.num_kfs,
                          ate_sodso=score_rows(handler.odometry_rows(), gt),
                          ate_dslam=score_rows(handler.optimized_rows(), gt))
    print("fps " + json.dumps(dict(
        root=os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))),
        variants=list(variants), e2e_fps=E2E_FRAMES / e2e_dt,
        e2e_stages=table(timed.timers), e2e_synchronized_stages=table(synced.timers),
        e2e_keyframe_waits=waits.get("keyframe"), e2e_splits=splits, loop=loop)), flush=True)


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
        waits[mode] = count_waits(torch, c, intr, ds, frames, dev)

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


# ---------------------------------------------------------------------------
# the reference's own inputs and outputs: rosbag, live topics, checkpoint /
# resume, the viewer and the debug images (each on the e2e phase's frames,
# cut to uint8 as a camera gives them)
# ---------------------------------------------------------------------------

TOPICS = ("/cam0/image_raw", "/cam1/image_raw")
CAMERA_HZ = 10.0        # KITTI's camera rate


def observed_sequence(dev):
    """The e2e phase's rendered sequence, its images cut to uint8."""
    ds, frames, cfg, intr = sequence_setup(dev, E2E_FRAMES, speed=0.4)
    return ds, QuantisedFrames(frames).frames, cfg, intr


def camera_files(ds, out_dir: str):
    """A pinhole camera.txt (no distortion, no crop) and T_stereo.yaml of
    the rendered rig, for the raw-image path (``run_slam --calib0``)."""

    K = ds.K
    calib = os.path.join(out_dir, "camera.txt")
    with open(calib, "w") as f:
        f.write(f"Pinhole {K[0, 0]} {K[1, 1]} {K[0, 2]} {K[1, 2]} 0\n{W} {H}\nfull\n{W} {H}\n")
    stereo = os.path.join(out_dir, "T_stereo.yaml")
    with open(stereo, "w") as f:
        f.write("T_stereo: !!opencv-matrix\n  rows: 4\n  cols: 4\n  dt: d\n  data: ["
                + ", ".join(repr(float(x)) for x in ds.t_cam1_cam0.reshape(-1)) + "]\n")
    return calib, stereo


def zero_counters():
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def read_counters(counters):
    return {name: fn.launches for name, fn in counters.items()}


def ate_of(frames, shells, first=1):
    """(translation ATE of the shells from frame ``first`` on, path length)."""
    est, gt, path = translations(frames, shells)
    errs = np.linalg.norm(est[first:] - gt[first:], axis=1)
    return float(np.sqrt(np.mean(errs ** 2))), path


def bag_phase(torch, dev, seq, tmp: str):
    """The sequence written as a rosbag (uncompressed and bz2) and replayed
    through SLAMNode (``replay_stereo_bag``, the reference's pairing rule),
    in turns with the same uint8 frames fed from memory; then the entry
    point on the bz2 bag with the viewer and the debug images. Returns
    the launches of the last bag pass."""

    from direct_stereo_slam_tpu_torch.io.rosbag import (RosbagReader, replay_stereo_bag,
                                                        write_stereo_bag)
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    ds, frames, cfg, intr = seq
    msgs = [m for f in frames for m in ((TOPICS[0], float(f["timestamp"]), f["img0"]),
                                        (TOPICS[1], float(f["timestamp"]), f["img1"]))]
    bags = {}
    for comp in ("none", "bz2"):
        path = os.path.join(tmp, f"seq_{comp}.bag")
        t0 = time.perf_counter()
        write_stereo_bag(path, msgs, compression=comp)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_img = sum(1 for _ in RosbagReader(path).images(TOPICS))
        decode_ms = 1e3 * (time.perf_counter() - t0) / (n_img / 2)
        bags[comp] = path
        print(f"bag {comp}: {len(frames)} pairs {W}x{H} uint8, {os.path.getsize(path) / 2**20:.2f} "
              f"MiB written in {write_s:.2f} s; read + decode {decode_ms:.3f} ms per pair "
              f"(host)", flush=True)

    runs = []
    for source in ("memory", "none", "bz2"):
        counters = zero_counters()
        node = SLAMNode(cfg, intr, intr, ds.t_cam1_cam0, device=dev)
        shells = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if source == "memory":
            for f in frames:
                shells.append(node.process(f["img0"], f["img1"], float(f["timestamp"])))
            fired = len(frames)
        else:
            fired = replay_stereo_bag(bags[source], *TOPICS, lambda a, b: shells.append(
                node.process(a.data, b.data, a.stamp)))
        node.finish()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs.append((source, fired, shells, dt, read_counters(counters), node))
    kfs_mem = sum(s.is_kf for s in runs[0][2])
    for source, fired, shells, dt, launches, node in runs:
        kfs = sum(s.is_kf for s in shells)
        ate, path = ate_of(frames, shells) if len(shells) == len(frames) else (float("nan"), 0)
        read = "" if source == "memory" else " (bag read and decode included)"
        print(f"bag {source}: {fired} pairs in {dt:.3f} s = {fired / dt:.3f} FPS{read}, {kfs} "
              f"keyframes, ATE {ate:.4f} m over {path:.2f} m; launches {launches}", flush=True)
        if source == "memory":
            continue
        fe = node.frontend
        if fired != len(frames):
            fail(f"bag {source}: {fired} of {len(frames)} pairs fired")
        if not fe.initialized or fe.is_lost or not ate < 0.02 * path:
            fail(f"bag {source}: lost={fe.is_lost} ATE {ate:.4f} m (2% of {path:.2f} m)")
        if abs(kfs - kfs_mem) > 1:
            fail(f"bag {source}: {kfs} keyframes against {kfs_mem} from memory")
        gate_launches(f"bag {source}", launches, E2E_KERNELS)

    # the entry point, as a user runs it on a bag: raw-image path, viewer,
    # debug images, threaded loop handler
    calib, stereo = camera_files(ds, tmp)
    out, dbg = os.path.join(tmp, "run_slam_bag"), os.path.join(tmp, "run_slam_dbg")
    cmd = [sys.executable, "-m", "direct_stereo_slam_tpu_torch.run_slam", "--bag", bags["bz2"],
           "--calib0", calib, "--t-stereo", stereo, "--live", "--debug-dir", dbg,
           "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"bag: run_slam --bag exited {proc.returncode}:\n{(proc.stdout + proc.stderr)[-3000:]}")
    pngs = os.listdir(dbg) if os.path.isdir(dbg) else []
    per_frame = [ln for ln in proc.stdout.splitlines() if ln.startswith("per_frame")]
    print(f"bag: run_slam --bag (bz2) --calib0 --live --debug-dir: exit 0 in {wall:.1f} s "
          f"(a new process: start, kernel library load, {len(frames)} frames, loop thread); "
          f"{per_frame}; {len(pngs)} debug PNGs", flush=True)
    for name in ("sodso.txt", "dslam.txt", "live.html"):
        if not os.path.exists(os.path.join(out, name)):
            fail(f"bag: run_slam --bag wrote no {name}")
    if not pngs:
        fail("bag: run_slam --bag --debug-dir wrote no image")
    return runs[-1][4]


def live_phase(torch, dev, seq):
    """The sequence published at the camera's rate over loopback TCPROS
    (MiniMaster, two ImagePublishers) into StereoTopicSource ->
    SLAMNode.process on the source's thread, under a lock. Returns the
    launches of the run."""
    import threading

    from direct_stereo_slam_tpu_torch.io.ros_transport import (ImagePublisher, MiniMaster,
                                                               StereoTopicSource)
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    ds, frames, cfg, intr = seq
    node = SLAMNode(cfg, intr, intr, ds.t_cam1_cam0, device=dev)
    counter = WaitCounter(torch)
    lock = threading.Lock()
    done, shells = {}, {}
    key = lambda stamp: round(stamp, 4)

    def on_pair(a, b):
        with lock:
            shells[key(a.stamp)] = counter(node, partial(node.process, a.data, b.data, a.stamp))
            done[key(a.stamp)] = time.perf_counter()

    master = MiniMaster()
    pubs = [ImagePublisher(t, master.uri, f"/smoke_pub{i}") for i, t in enumerate(TOPICS)]
    src = StereoTopicSource(master.uri, *TOPICS, on_pair)
    try:
        t0 = time.perf_counter()
        while not all(p.connected for p in pubs):
            if time.perf_counter() - t0 > 30:
                fail("live: the subscribers never connected over loopback")
            time.sleep(0.01)
        counters = zero_counters()
        sent = {}
        start = time.perf_counter()
        for i, f in enumerate(frames):
            time.sleep(max(0.0, start + i / CAMERA_HZ - time.perf_counter()))
            stamp = float(f["timestamp"])
            sent[key(stamp)] = time.perf_counter()
            pubs[0].publish(f["img0"], stamp)
            pubs[1].publish(f["img1"], stamp)
        while len(done) < len(frames) and not src.failed \
                and time.perf_counter() - start < 120:
            time.sleep(0.01)
    finally:
        src.close()                 # raises what the callback raised
        for p in pubs:
            p.close()
        master.close()
    with lock:
        node.finish()
    torch.cuda.synchronize()
    launches = read_counters(counters)
    if len(done) != len(frames):
        fail(f"live: {len(done)} of {len(frames)} pairs processed")
    lags = np.array([done[k] - sent[k] for k in sent])
    span = max(done.values()) - start
    ordered = [shells[key(float(f["timestamp"]))] for f in frames]
    ate, path = ate_of(frames, ordered)
    waits = counter.summary()
    print(f"live: {len(done)} pairs published at {CAMERA_HZ:.0f} Hz over loopback TCPROS, "
          f"processed at {len(done) / span:.3f} FPS (first publish to last process); lag "
          f"publish -> end of process median {1e3 * np.median(lags):.1f} ms, max "
          f"{1e3 * lags.max():.1f} ms (frame {int(np.argmax(lags))}); deepest queue "
          f"{src.max_queue} pairs; {sum(s.is_kf for s in ordered)} keyframes, ATE {ate:.4f} m "
          f"over {path:.2f} m; launches {launches}", flush=True)
    print(f"live: lag per pair (ms): {' '.join(f'{1e3 * x:.0f}' for x in lags)}", flush=True)
    print(f"live: blocking waits per call on the source's thread: {waits}", flush=True)
    fe = node.frontend
    if not fe.initialized or fe.is_lost or not ate < 0.02 * path:
        fail(f"live: lost={fe.is_lost} ATE {ate:.4f} m (2% of {path:.2f} m)")
    if waits.get("benign", {}).get("median", 0) < 1:
        fail(f"live: no blocking wait counted on the source's thread ({waits})")
    gate_launches("live", launches, E2E_KERNELS)
    return launches


def state_tensors(fe):
    trees = [fe.ba_state, fe.immatures, *fe.pyramids.values()]
    if fe.template is not None:
        trees.append(fe.template)
    for tree in trees:
        for v in tree:
            yield from (v if isinstance(v, tuple) else (v,))


def resume_phase(torch, dev, seq, tmp: str):
    """Checkpoint / resume on the card with a threaded LoopHandler, all
    under ``torch.use_deterministic_algorithms``: A and A2 run the 40
    frames uninterrupted; B runs 20 and saves the front end and the
    handler; C, a fresh node, loads them and runs frames 20-39. Then a
    checkpoint written on the CPU resumes on the card for 5 frames.
    Returns the launches of C."""
    import warnings

    from direct_stereo_slam_tpu_torch.loop.handler import LoopHandler
    from direct_stereo_slam_tpu_torch.runtime import checkpoint
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    ds, frames, cfg, intr = seq
    half = len(frames) // 2

    def node_on(device, handler=True):
        h = LoopHandler(cfg, intr, device=device) if handler else None
        return SLAMNode(cfg, intr, intr, ds.t_cam1_cam0, loop_handler=h, device=device)

    def feed(node, lo, hi):
        out = [node.process(f["img0"], f["img1"], float(f["timestamp"])) for f in frames[lo:hi]]
        return out

    def finish(node):
        node.finish()
        node.loop_handler.close()
        torch.cuda.synchronize()

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            full = []
            for _ in range(2):
                node = node_on(dev)
                full.append((feed(node, 0, len(frames)), node))
                finish(node)
            node_b = node_on(dev)
            feed(node_b, 0, half)
            base = os.path.join(tmp, "resume")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save_frontend(base + "_fe", node_b.frontend)
            checkpoint.save_loop_handler(base + "_loop", node_b.loop_handler)
            save_ms = 1e3 * (time.perf_counter() - t0)
            finish(node_b)
            node_c = node_on(dev, handler=False)
            t0 = time.perf_counter()
            checkpoint.load_frontend(base + "_fe", node_c.frontend)
            node_c.loop_handler = checkpoint.load_loop_handler(
                base + "_loop", LoopHandler(cfg, intr, device=dev))
            torch.cuda.synchronize()
            load_ms = 1e3 * (time.perf_counter() - t0)
            node_c.incoming_id = half
            node_c.current_timestamp = float(frames[half - 1]["timestamp"])
            off_card = [t.device for t in state_tensors(node_c.frontend) if t.device.type != "cuda"]
            counters = zero_counters()
            shells_c = feed(node_c, half, len(frames))
            finish(node_c)
            launches = read_counters(counters)
        det = sorted({str(w.message)[:120] for w in caught if "determinis" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
    size = sum(os.path.getsize(base + s) for s in ("_fe.npz", "_fe.json", "_loop.npz",
                                                   "_loop.json"))
    (shells_a, node_a), (shells_a2, _) = full
    est_a = translations(frames, shells_a)[0]
    spread = float(np.max(np.linalg.norm(translations(frames, shells_a2)[0] - est_a, axis=1)))
    est_c = np.stack([np.asarray(s.T_wc)[:3, 3] for s in shells_c])
    diff = np.linalg.norm(est_c - est_a[half:], axis=1)
    kfs_a, kfs_c = node_a.frontend.num_kfs, node_c.frontend.num_kfs
    rows_equal = node_c.loop_handler.odometry_rows() == node_a.loop_handler.odometry_rows()
    print(f"resume: save {save_ms:.1f} ms, load {load_ms:.1f} ms (front end + loop handler, "
          f"npz + json), {size / 2**20:.2f} MiB at frame {half}; deterministic algorithms "
          f"on for A, A2, B and C (their warnings: {det or 'none'})", flush=True)
    print(f"resume: A vs A2 (uninterrupted) max {spread:.3g} m; C (resumed at {half}) vs A "
          f"max {float(diff.max()):.3g} m over frames {half}-{len(frames) - 1}; keyframes A "
          f"{kfs_a}, C {kfs_c}; loop handler odometry rows "
          f"{'equal' if rows_equal else 'differ'}; C launches {launches}", flush=True)
    if off_card:
        fail(f"resume: loaded state tensors off the card: {off_card[:3]}")
    if abs(kfs_c - kfs_a) > 1:
        fail(f"resume: {kfs_c} keyframes against {kfs_a} uninterrupted")
    if not float(diff.max()) <= spread + 1e-3:
        fail(f"resume: C departs from A by {float(diff.max()):.4g} m, beyond A vs A2 "
             f"({spread:.4g} m) + 1e-3 m")
    gate_launches("resume", launches, E2E_KERNELS)

    # the device move: a checkpoint the CPU wrote resumes on the card
    cpu_frames, card_frames = 6, 5
    node_h = node_on(torch.device("cpu"), handler=False)
    t0 = time.perf_counter()
    feed(node_h, 0, cpu_frames)
    cpu_s = time.perf_counter() - t0
    checkpoint.save_frontend(base + "_cpu", node_h.frontend)
    node_d = node_on(dev, handler=False)
    checkpoint.load_frontend(base + "_cpu", node_d.frontend)
    node_d.incoming_id = cpu_frames
    node_d.current_timestamp = float(frames[cpu_frames - 1]["timestamp"])
    off_card = [t.device for t in state_tensors(node_d.frontend) if t.device.type != "cuda"]
    counters = zero_counters()
    shells_d = feed(node_d, cpu_frames, cpu_frames + card_frames)
    node_d.finish()
    torch.cuda.synchronize()
    moved = read_counters(counters)
    gt = np.stack([f["pose_w_c0"][:3, 3] for f in frames[cpu_frames:cpu_frames + card_frames]])
    est = np.stack([np.asarray(s.T_wc)[:3, 3] for s in shells_d])
    err = float(np.max(np.linalg.norm(est - gt, axis=1)))
    print(f"resume: a CPU checkpoint ({cpu_frames} frames on the host CPU in {cpu_s:.1f} s) "
          f"resumed on the card for {card_frames} frames: max error {err:.4f} m against the "
          f"rendered poses; launches {moved}", flush=True)
    fe = node_d.frontend
    if off_card or fe.is_lost or not fe.initialized or not np.all(np.isfinite(est)):
        fail(f"resume (CPU -> card): off the card {off_card[:3]}, lost={fe.is_lost}")
    path = translations(frames, shells_a)[2]
    if not err < 0.02 * path:
        fail(f"resume (CPU -> card): error {err:.4f} m >= 2% of {path:.2f} m")
    for name in ("distance_map", "track_lm"):
        if moved[name] <= 0:
            fail(f"resume (CPU -> card): kernel {name} was never launched")
    return launches


def observe_phase(torch, dev, seq, tmp: str):
    """The sequence with the live viewer and the debug images on, in turns
    with both off (on, off, off, on), then one pass of each with the
    blocking waits counted. Returns the launches of the last pass on."""
    import json
    import re
    import shutil
    import struct

    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    ds, frames, cfg, intr = seq
    page, dbg = os.path.join(tmp, "live.html"), os.path.join(tmp, "dbg")
    cfgs = {"on": with_runtime(cfg, live_view_path=page, debug_dump_dir=dbg), "off": cfg}

    def one_pass(mode, per_call=None):
        """A pass of a fresh node; a pass on starts with no page and no
        images, so the files are its own."""
        shutil.rmtree(dbg, ignore_errors=True)
        if os.path.exists(page):
            os.remove(page)
        return run_sequence(torch, SLAMNode, cfgs[mode], intr, ds, frames, dev,
                            per_call=per_call)

    fps = {"on": [], "off": []}
    for mode in ("on", "off", "off", "on"):
        counters = zero_counters()
        dt = one_pass(mode)[3]
        fps[mode].append(len(frames) / dt)
        if mode == "on":
            launches = read_counters(counters)
    waits = {}
    for mode in ("off", "on"):
        counter = WaitCounter(torch)
        on_node, on_shells, on_resets, _ = one_pass(mode, per_call=counter)
        waits[mode] = counter.summary()
    print(f"observe: FPS viewer + debug images on {' / '.join(f'{x:.3f}' for x in fps['on'])}, "
          f"off {' / '.join(f'{x:.3f}' for x in fps['off'])} (turns on, off, off, on; "
          f"{len(frames)} frames each)", flush=True)
    for mode in ("off", "on"):
        print(f"observe: blocking waits per call, {mode}: {waits[mode]}", flush=True)

    # the files of the last pass, on
    names = sorted(os.listdir(dbg))
    kfs = [i for i, s in enumerate(on_shells) if s.is_kf]
    tracked_kfs = [i for i in kfs if i > 0]           # frame 0 is the stereo initialisation
    idepth = [n for n in names if n.endswith("_idepth.png")]
    window = [n for n in names if n.endswith("_window.png")]
    residual = sorted(int(n[6:11]) for n in names if n.endswith("_residual.png"))
    others = [i for i in range(1, len(frames)) if i not in kfs]
    with open(page) as f:
        state = json.loads(re.search(r"const S = (\{.*?\});\n", f.read(), re.S).group(1))
    import base64
    png = base64.b64decode(state["depth_png"]) if state["depth_png"] else b""
    dims = struct.unpack(">II", png[16:24]) if png[:8] == b"\x89PNG\r\n\x1a\n" else None
    print(f"observe: keyframes {kfs}; {len(idepth)} idepth, {len(window)} window and "
          f"{len(residual)} residual PNGs; live.html {os.path.getsize(page) / 1024:.1f} KiB: "
          f"{len(state['trail'])} poses, {len(state['kfs'])} keyframes, depth pane {dims}; "
          f"launches {launches}", flush=True)
    fe = on_node.frontend
    if not fe.initialized or fe.is_lost or on_resets:
        fail(f"observe: lost={fe.is_lost} resets at {on_resets}")
    if len(idepth) != len(tracked_kfs) or len(window) != len(tracked_kfs):
        fail(f"observe: {len(idepth)} idepth / {len(window)} window PNGs for "
             f"{len(tracked_kfs)} tracked keyframes")
    if residual != others:
        fail(f"observe: residual PNGs at {residual}, non-keyframes at {others}")
    if len(state["trail"]) != len(frames) - 1 or dims != (W, H):
        fail(f"observe: live.html holds {len(state['trail'])} poses (want {len(frames) - 1}: "
             f"every frame after the initialisation), depth pane {dims}")
    on, off = waits["on"].get("benign"), waits["off"].get("benign")
    if not on or not off or on["median"] != off["median"] or on["max"] > off["max"]:
        fail(f"observe: waits per benign frame with the viewer and the dumps on {on} "
             f"against off {off}")
    gate_launches("observe", launches, E2E_KERNELS)
    return launches


# the kernels each path must launch; the per-pass K2, K3 and K4 must not
# (the tracker, the scale optimizer and the loop estimator run K2-LM,
# K3-LM and K4-LM on the card)
# the BA's kernels on every keyframe path: K9 (linearize, marginalization)
# and the resident launch (optimize_keyframe's LM loop); K10 and K11 queued
# are its bit reference, held to it in phase 13, and make no launch on a path
BA_KERNELS = ("ba_linearize", "ba_optimize")
# the BA's state programs: K16 (the window's poses: activate, template,
# views), K17 (around the resident launch), K18 (the keyframe tail)
WINDOW_KERNELS = ("window_pose", "ba_keyframe_prologue", "ba_keyframe_epilogue", "marginalize")
BA_ROWS = ("ba_linearize", "ba_step", "ba_accept", "ba_optimize")
# a keyframe's activation: K12 (gate, compaction, idepth LM), K13 (pool rows)
ACT_KERNELS = ("gate_compact_activate", "allocate_insert")
# every traced frame's K14, every template's K15
TRACE_KERNELS = ("trace_points_all_compact", "build_template")
E2E_KERNELS = (("distance_map", "track_lm", "scale_lm") + BA_KERNELS + ACT_KERNELS
               + TRACE_KERNELS + WINDOW_KERNELS)
# the loop thread's pose graph stays at or below 512 nodes here: K7, one
# launch a dense optimize (K6 and K8 above 512, in the pose-graph phase)
LOOP_KERNELS = E2E_KERNELS + ("loop_pose_lm", "pose_graph_gn")
# DSO mode makes no stereo scale optimization
MONO_KERNELS = (("distance_map", "track_lm") + BA_KERNELS + ACT_KERNELS + TRACE_KERNELS
                + WINDOW_KERNELS)
OFF_PATH = ("pose_residual_pass", "scale_residual_pass", "pose3d_residual_pass")


class ScaleTraffic:
    """K3-LM's calls on a path, by the number of guesses G and by whether
    any guess doubled its cutoff at a level (the output rows' repeat
    factor > 1): scale_opt's kernel wrapper is wrapped for the run and
    each call's rows are kept, then read once after it, so the path makes
    no extra host read."""

    def __init__(self):
        from direct_stereo_slam_tpu_torch.models import scale_opt as so

        self.so, self.calls = so, []

    def __enter__(self):
        self.wrapped = self.so.scale_lm_cuda

        def kept(*a, **kw):
            out = self.wrapped(*a, **kw)
            self.calls.append(out)
            return out

        self.so.scale_lm_cuda = kept
        return self

    def __exit__(self, *exc):
        self.so.scale_lm_cuda = self.wrapped

    def summary(self) -> dict:
        by_g = {}
        for o in self.calls:
            rep = o.repeat.cpu().numpy()
            d = by_g.setdefault(f"G={rep.shape[0]}", dict(calls=0, doubled=0,
                                                          max_repeat=1.0))
            d["calls"] += 1
            d["doubled"] += int((rep > 1.0).any())
            d["max_repeat"] = max(d["max_repeat"], float(rep.max()))
        return by_g


class GraphTraffic:
    """The loop handler's pose graphs: ``loop/pose_graph.optimize`` is
    wrapped for the run and each call's data kept (the handler builds a new
    one per call), to be replayed after it."""

    def __init__(self):
        from direct_stereo_slam_tpu_torch.loop import pose_graph as pg

        self.pg, self.calls = pg, []

    def __enter__(self):
        self.wrapped = self.pg.optimize

        def kept(data, *a, **kw):
            self.calls.append(data)
            return self.wrapped(data, *a, **kw)

        self.pg.optimize = kept
        return self

    def __exit__(self, *exc):
        self.pg.optimize = self.wrapped


def kernel_counters():
    from direct_stereo_slam_tpu_torch.ops import activate as act
    from direct_stereo_slam_tpu_torch.ops import ba as kb
    from direct_stereo_slam_tpu_torch.ops import distance_map as dm
    from direct_stereo_slam_tpu_torch.ops import pose_graph as pgk
    from direct_stereo_slam_tpu_torch.ops import resident_lm as rlm
    from direct_stereo_slam_tpu_torch.ops import residual_hb as rh
    from direct_stereo_slam_tpu_torch.ops import template as template_ops
    from direct_stereo_slam_tpu_torch.ops import trace as trace_ops
    from direct_stereo_slam_tpu_torch.ops import window as win

    return {"distance_map": dm.build_distance_map_cuda,
            "window_pose": win.window_pose_cuda,
            "ba_keyframe_prologue": win.ba_prologue_cuda,
            "ba_keyframe_epilogue": win.ba_epilogue_cuda,
            "marginalize": win.marginalize_cuda,
            "gate_compact_activate": act.gate_compact_activate_cuda,
            "allocate_insert": act.allocate_insert_consume_cuda,
            "trace_points_all_compact": trace_ops.trace_points_all_compact_cuda,
            "build_template": template_ops.build_template_cuda,
            "pose_residual_pass": rh.pose_residual_pass_cuda,
            "scale_residual_pass": rh.scale_residual_pass_cuda,
            "pose3d_residual_pass": rh.pose3d_residual_pass_cuda,
            "track_lm": rlm.track_lm_cuda,
            "scale_lm": rlm.scale_lm_cuda,
            "loop_pose_lm": rlm.loop_pose_lm_cuda,
            "pose_graph_edges": pgk.pose_graph_edges_cuda,
            "pose_graph_gn": pgk.pose_graph_gn_cuda,
            "pose_graph_pcg": pgk.pose_graph_pcg_cuda,
            "pose_graph_cg": pgk.pose_graph_cg_cuda,
            "ba_linearize": kb.ba_linearize_cuda,
            "ba_step": kb.ba_step_cuda,
            "ba_accept": kb.ba_accept_cuda,
            "ba_optimize": kb.ba_optimize_cuda}


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


def loop_setup(dev, n_frames: int, loop_margin: int, pipelined: bool = False):
    """(dataset, frames cut to uint8, config) of the loop room's lap."""
    import dataclasses

    from direct_stereo_slam_tpu_torch.config import make_config
    from direct_stereo_slam_tpu_torch.io.synthetic import (
        SyntheticStereoDataset, _loop_scene, loop_trajectory)

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
    return ds, frames, cfg


def loop_phase(torch, dev, n_frames: int, loop_margin: int, gate: bool = True,
               pipelined: bool = False):
    """The port's SLAMNode + threaded LoopHandler over the loop room.
    Returns the launch count of each kernel during the run, K3-LM's calls
    and the final pose graph (``handler.graph_data()``)."""
    from direct_stereo_slam_tpu_torch.runtime.eval import (
        run_sequence, score_rows, timing_table)

    ds, frames, cfg = loop_setup(dev, n_frames, loop_margin, pipelined)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    with ScaleTraffic() as traffic, GraphTraffic() as graphs:
        node, handler, dt = run_sequence(frames, cfg, ds.K, ds.t_cam1_cam0, levels=LEVELS,
                                         device=dev)
    launches = {name: fn.launches for name, fn in counters.items()}
    handler.close()
    scale_calls = traffic.summary()

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
    print(f"{tag}: K3-LM calls by guesses (calls, those with a doubled cutoff, the "
          f"largest doubling factor): {scale_calls}", flush=True)
    table = timing_table(node.timers)
    scale_ms, scale_n = table.get("scale_opt", (float("nan"), 0))
    if "direct_est" in table:
        ms, n = table["direct_est"]
        print(f"{tag}: direct_est {ms:.3f} ms per try x {n}, K4-LM launches per try "
              f"{launches['loop_pose_lm'] / max(n, 1):.2f}; track "
              f"{table['track'][0]:.3f} ms per frame x {table['track'][1]}; scale_opt "
              f"{scale_ms:.3f} ms per keyframe x {scale_n}", flush=True)
    # the final pose graph alone, with nothing else running, and a few of
    # the run's own graphs: pose_graph_opt before (plain) and after (kernels)
    final, _ = handler.graph_data()
    pose_graph_report(torch, tag, final, graphs.calls, cfg.loop.pgo_iterations)
    if n_frames == 320:
        print(f"{tag} vs EVAL_r05 (JAX package, TPU v5e, PNG ingestion): loops "
              f"{loops} vs {R05['loops']}, direct tries {handler.stats['direct_try']} "
              f"vs {R05['tries']}, ATE sodso {ate_o:.3f} vs {R05['ate_sodso']} m, "
              f"dslam {ate_d:.3f} vs {R05['ate_dslam']} m", flush=True)
    if not gate:
        return launches, scale_calls, final
    if ate_o is None or ate_d is None or not (np.isfinite(ate_o) and np.isfinite(ate_d)):
        fail(f"{tag}: no finite ATE ({ate_o}, {ate_d})")
    if loops < 1:
        fail(f"{tag}: no loop verified")
    if not ate_d < ate_o:
        fail(f"{tag}: dslam ATE {ate_d:.4f} m is not below sodso ATE {ate_o:.4f} m")
    gate_launches(tag, launches, LOOP_KERNELS)
    loop_repeats(torch, tag, n_frames, lambda: run_sequence(
        frames, cfg, ds.K, ds.t_cam1_cam0, levels=LEVELS, device=dev), handler, dt)
    return launches, scale_calls, final


def trajectory(handler):
    """(odometry rows, loop-closed rows, loops) of a drained loop handler."""
    return (np.asarray(handler.odometry_rows(), np.float64),
            np.asarray(handler.optimized_rows(), np.float64),
            handler.direct_loop_count + handler.icp_loop_count)


def loop_repeats(torch, tag, n_frames, run_once, first, first_dt) -> None:
    """The loop run three more times after the gated one, in turns:
    deterministic algorithms on, off (with the host's blocking waits per
    call counted, which also catches the loop thread's), on. Prints the
    FPS of each mode, the waits per keyframe call, and whether two runs of
    one mode give the same trajectories and loops."""
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    runs = {"off": [(first_dt, trajectory(first))], "on": []}
    waits = None
    for mode in ("on", "off", "on"):
        counter = WaitCounter(torch) if mode == "off" else None
        process = SLAMNode.process
        if counter is not None:
            SLAMNode.process = lambda self, *a, **kw: counter(self, partial(process, self, *a,
                                                                            **kw))
        torch.use_deterministic_algorithms(mode == "on")
        try:
            _, handler, dt = run_once()
        finally:
            torch.use_deterministic_algorithms(False)
            SLAMNode.process = process
        handler.close()
        runs[mode].append((dt, trajectory(handler)))
        if counter is not None:
            waits = counter.summary()
    fps = {m: [n_frames / dt for dt, _ in r] for m, r in runs.items()}
    off, on = fps["off"][0], float(np.mean(fps["on"]))
    print(f"{tag}: FPS with torch.use_deterministic_algorithms off {fps['off'][0]:.3f} (the "
          f"gated run; {fps['off'][1]:.3f} with the waits counted), on "
          f"{' / '.join(f'{x:.3f}' for x in fps['on'])} (turns off, on, off, on): the "
          f"deterministic mode costs {100 * (off - on) / off:.1f}% of the FPS", flush=True)
    print(f"{tag}: blocking waits per call (the loop thread's included): {waits}", flush=True)
    # the loop thread's designed reads: a try's best seed and an optimize's
    # result (loop/handler.py); none in the estimator or the graph's build
    kf = (waits or {}).get("keyframe", {})
    stray = [w for w in kf.get("sites", {}) if w.startswith(("pose_estimator.py",
                                                             "pose_graph.py"))]
    if kf.get("mean", 0.0) > 2 or stray:
        fail(f"{tag}: a keyframe call waits a mean {kf.get('mean')} times (> 2) or at "
             f"{stray}")
    for mode, r in runs.items():
        (_, (o1, d1, l1)), (_, (o2, d2, l2)) = r

        def gap(a, b):
            """'bit-equal', or the largest position difference over the
            keyframes both runs made (rows: frame id, x, y, z)."""
            if a.shape == b.shape and np.array_equal(a, b):
                return "bit-equal"
            ids, ia, ib = np.intersect1d(a[:, 0], b[:, 0], return_indices=True)
            d = np.max(np.abs(a[ia, 1:] - b[ib, 1:])) if len(ids) else float("nan")
            return f"differs by up to {d:.3g} m over the {len(ids)} keyframes of both"

        print(f"{tag}: two runs with deterministic algorithms {mode}: loops {l1} / {l2}, "
              f"keyframes {len(o1)} / {len(o2)}, odometry {gap(o1, o2)}, loop-closed "
              f"{gap(d1, d2)}", flush=True)


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


# ---------------------------------------------------------------------------
# the last modules: the sequence axis of K2-LM / K3-LM, the batch evaluation
# over sequences (run_batch), the native prefetching loader, and the disk
# evaluation path (gen_longseq -> eval_kitti)
# ---------------------------------------------------------------------------

SEQ_COUNTS = (8, 11)               # K2-LM / K3-LM rows: S sequences in one launch
BATCH_SEQUENCES, BATCH_FRAMES = (1, 8, 11), 20   # 11 = KITTI 00-10 (BASELINE config 5)
BATCH_PASSES = 40        # ~60-80 ms per pass of 19 steps: a window of seconds
EVAL_FRAMES = 80
# the eval phase's process: eval_kitti as a user runs it, with the launch
# counts set to 0 before and printed (one line) after
EVAL_CHILD = """import json, sys
from chip_smoke import read_counters, zero_counters
from direct_stereo_slam_tpu_torch import eval_kitti
counters = zero_counters()
rc = eval_kitti.main(sys.argv[1:])
print("launches " + json.dumps(read_counters(counters)), flush=True)
sys.exit(rc)
"""


# the ab_policies phase's process: the script as a user runs it, each
# arm's launches counted from 0 and printed (one line per arm)
AB_CHILD = """import json, sys
from chip_smoke import read_counters, zero_counters
from direct_stereo_slam_tpu_torch import ab_policies
run_one = ab_policies.run_one
def counted(scenario, variant, *a, **kw):
    counters = zero_counters()
    out = run_one(scenario, variant, *a, **kw)
    print("launches " + json.dumps(dict(scenario=scenario, variant=variant,
                                        **read_counters(counters))), flush=True)
    return out
ab_policies.run_one = counted
sys.exit(ab_policies.main(sys.argv[1:]))
"""
AB_FRAMES, AB_W, AB_H = 80, 320, 96     # the JAX package's table (PARITY.md:92-112)
# PARITY.md:98-107: (KFs, ATE m, endpoint m, lost, loops) of the JAX package
AB_JAX = {("nominal", "baseline"): (18, 0.073, 0.116, "no", "—"),
          ("nominal", "serial_winner"): (18, 0.069, 0.101, "no", "—"),
          ("nominal", "force_accept"): (18, 0.060, 0.097, "no", "—"),
          ("brightness_jump", "baseline"): (19, 0.100, 0.149, "no", "—"),
          ("brightness_jump", "serial_winner"): (19, 0.098, 0.159, "no", "—"),
          ("brightness_jump", "force_accept"): (18, 0.073, 0.135, "no", "—"),
          ("fast_rotation", "baseline"): (78, 1.153, 0.683, "no", 1),
          ("fast_rotation", "serial_winner"): (78, 0.781, 0.423, "no", 2),
          ("fast_rotation", "force_accept"): (70, "NaN", "NaN", "yes", 0),
          ("fast_rotation", "reference_loop"): (78, 1.153, 0.683, "no", 3)}


def ab_phase(torch, dev, tmp: str) -> dict:
    """``python -m direct_stereo_slam_tpu_torch.ab_policies`` as a new
    process at the JAX package's 320x96, 80 frames (AB_CHILD: each arm's
    launches counted in that process). Gated: exit 0 within its time
    limit (the force-accept arm's NaN poses reach K9-K11 without a crash
    or a hang) and K2-LM, K3-LM and K9-K11 launched in every arm; the
    fast-rotation arms' K4-LM / K6 launches and loops are printed, not
    gated. Prints the table beside the JAX package's. Returns the
    launches summed over the arms."""
    from direct_stereo_slam_tpu_torch.ab_policies import GRID

    out = os.path.join(tmp, "ab_policies.md")
    cmd = [sys.executable, "-c", AB_CHILD, "--frames", str(AB_FRAMES), "--width", str(AB_W),
           "--height", str(AB_H), "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"ab_policies exited {proc.returncode}:\n{(proc.stdout + proc.stderr)[-3000:]}")
    arms = [json.loads(l[len("launches "):]) for l in proc.stdout.splitlines()
            if l.startswith("launches ")]
    if len(arms) != sum(len(variants) for _, variants in GRID):
        fail(f"ab_policies: {len(arms)} arms reported their launches")
    print(f"ab_policies: exit 0 in {wall:.1f} s as a new process ({AB_FRAMES} frames "
          f"{AB_W}x{AB_H})", flush=True)
    for line in proc.stdout.splitlines():
        if line.startswith("["):
            print(f"ab_policies: {line}", flush=True)
    with open(out) as f:
        rows = [l for l in f.read().splitlines() if l.startswith("| ") and "---" not in l][1:]
    print("ab_policies: the port on the card | the JAX package (PARITY.md:98-107: KFs, ATE, "
          "endpoint, lost, loops)", flush=True)
    for line in rows:
        cells = [c.strip() for c in line.strip("|").split("|")]
        print(f"ab_policies:   {line}   JAX: {AB_JAX.get((cells[0], cells[1]))}", flush=True)
    total = {}
    for arm in arms:
        tag = f"ab_policies {arm['scenario']}/{arm['variant']}"
        for name in ("track_lm", "scale_lm") + BA_KERNELS:
            if arm[name] <= 0:
                fail(f"{tag}: kernel {name} was never launched")
        if arm["scenario"] == "fast_rotation":
            print(f"{tag}: K4-LM {arm['loop_pose_lm']}, K6 {arm['pose_graph_edges']}, K7 "
                  f"{arm['pose_graph_gn']} launches", flush=True)
        for k, v in arm.items():
            if isinstance(v, int):
                total[k] = total.get(k, 0) + v
    print(f"ab_policies: launches over the arms {total}", flush=True)
    # the JAX package loses this arm at frame ~70; the port on the card
    # did not: two witnesses without K9-K11 tell a fault of theirs from
    # the lap's own divergence
    from direct_stereo_slam_tpu_torch.ab_policies import run_one

    arm, size = ("fast_rotation", "force_accept", AB_FRAMES), dict(width=AB_W, height=AB_H)
    for tag, device in (("the plain BA on the card", dev), ("the port on the host CPU", "cpu")):
        t0 = time.perf_counter()
        with plain_ba():
            r = run_one(*arm, device=device, **size)
        print(f"ab_policies fast_rotation/force_accept, {tag}: frames {r['frames']}, "
              f"keyframes {r['kfs']}, lost {r['lost']}, ATE {r['ate']:.3f} m, endpoint "
              f"{r['endpoint']:.3f} m, loops {r.get('loops')} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return total


def seq_lm_rows(torch, dev):
    """K2-LM and K3-LM over S = 8 and 11 sequences in one launch, as the
    batched step calls them (one candidate from the identity, one guess at
    scale 1 per sequence): 11 rendered sequences at KITTI size, each with
    its own template of base 8192 (frame 0) and pyramids (frame 1 left,
    frame 0 right). Each sequence's rows must be the bits of a launch on
    that sequence alone, and each sequence is held to the Python loops by
    utils/lm_agreement.py (once: its rows are the same bits at every S).
    Times: the S-sequence launch, the S single launches back to back, the
    plain loops over the sequences."""
    from direct_stereo_slam_tpu_torch.config import make_config
    from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
    from direct_stereo_slam_tpu_torch.io.synthetic import SyntheticStereoDataset
    from direct_stereo_slam_tpu_torch.models import depth_template as dt
    from direct_stereo_slam_tpu_torch.models import scale_opt as so
    from direct_stereo_slam_tpu_torch.models import tracker as tr
    from direct_stereo_slam_tpu_torch.ops import resident_lm as rlm
    from direct_stereo_slam_tpu_torch.ops import residual_hb as rh
    from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid
    from direct_stereo_slam_tpu_torch.parallel.mesh import _T10
    from direct_stereo_slam_tpu_torch.utils import lm_agreement as lma

    rows = []
    cfg = make_config(W, H, preset=0, mode=1)
    gen = np.random.RandomState(3)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    budgets = dt.default_budgets(W, H, LEVELS)
    tmpls, left, right = [], [], []
    for s in range(max(SEQ_COUNTS)):
        ds = SyntheticStereoDataset(n_frames=2, width=W, height=H, speed=0.25 + 0.05 * (s % 4),
                                    yaw_rate=0.004 * (s % 3), device=dev)
        f0, f1 = ds.frame(0), ds.frame(1)
        n = 20000
        us = gen.uniform(3, W - 4, n).astype(np.float32)
        vs = gen.uniform(3, H - 4, n).astype(np.float32)
        z = f0["depth0"][vs.astype(int), us.astype(int)]
        tmpls.append(dt.build_template(t(us), t(vs), t((1.0 / z).astype(np.float32)),
                                       t(np.ones(n, np.float32)), t(f0["img0"]), LEVELS,
                                       budgets))
        left.append(f1["img0"])
        right.append(f0["img1"])
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LEVELS)
    pyr0 = build_pyramid(t(np.stack(left)), LEVELS).data
    pyr1 = build_pyramid(t(np.stack(right)), LEVELS).data
    zero_v = tr.AffLight(0.0, 0.0)
    z0 = torch.zeros((), device=dev)
    zero, one = tr.AffLight(z0, z0), z0 + 1.0
    track_loops = (tr.track_candidates_batch_plain,
                   partial(tr.track_candidates_batch_plain, residual_pass=rh.pose_residual_pass_plain))
    scale_loops = (so.optimize_scale_batch_plain,
                   partial(so.optimize_scale_batch_plain, residual_pass=rh.scale_residual_pass_plain))
    same = lambda a, b: torch.equal(torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0))
    fast = dict(repeats=11, inner=3, warmup=2)
    once = dict(repeats=1, inner=1, warmup=0)
    # per kernel and sequence (differ, order-sensitive, max abs err) against
    # the loops: a sequence's rows are the bits of its own launch at every
    # S, so one check per sequence covers every S it is part of
    checked = {"track": {}, "scale": {}}

    def agreement(kind, S, check):
        for s in range(S):
            if s not in checked[kind]:
                agr = check(s)
                if not agr.ok:
                    fail(f"{kind} LM over sequences, sequence {s}: {agr}")
                checked[kind][s] = (max(agr.differ.values()), agr.sensitive,
                                    max(agr.max_abs_err.values()))
        rows_ = [checked[kind][s] for s in range(S)]
        return dict(differ=sum(r[0] for r in rows_), order_sensitive=sum(r[1] for r in rows_),
                    max_abs_err=max(r[2] for r in rows_))

    for S in SEQ_COUNTS:
        p0 = tuple(x[:S].contiguous() for x in pyr0)
        p1 = tuple(x[:S].contiguous() for x in pyr1)
        tmpl = dt.TrackerTemplate(*[tuple(torch.stack([tm[k][l] for tm in tmpls[:S]])
                                          for l in range(LEVELS)) for k in range(5)])
        own = [(tuple(x[s].contiguous() for x in p0), tuple(x[s].contiguous() for x in p1))
               for s in range(S)]
        T0 = torch.eye(4, device=dev).expand(S, 4, 4).contiguous()
        s0 = torch.ones(S, device=dev)

        # ---- K2-LM: S sequences x 1 candidate
        k2 = lambda: rlm.track_lm_cuda(p0, tmpl, intr, cfg, T0, zero_v, zero_v, 1.0, 1.0)
        k2_singles = lambda: [rlm.track_lm_cuda(own[s][0], tmpls[s], intr, cfg, T0[s:s + 1],
                                                zero_v, zero_v, 1.0, 1.0) for s in range(S)]
        o, singles = k2(), k2_singles()
        torch.cuda.synchronize()
        for s, r in enumerate(singles):
            if not all(same(x[s:s + 1], y) for x, y in zip(o, r)):
                fail(f"K2-LM S={S}: sequence {s}'s rows differ from its own launch")
        if not bool(torch.isfinite(o.T).all()):
            fail(f"K2-LM S={S}: non-finite poses")
        argss = [(own[s][0], tmpls[s], intr, cfg, T0[s:s + 1], zero, zero, one, one)
                 for s in range(S)]

        def track_check(s, o=o):
            a, sl = argss[s], slice(s, s + 1)
            got = tr._gated(o.T[sl], tr.AffLight(o.a[sl], o.b[sl]), o.res[sl], o.x0[sl],
                            o.x1[sl], cfg, zero, one, one)
            refs = {"K2 loop": track_loops[0](*a), "plain": track_loops[1](*a)}
            return lma.check(got, refs, lma.reordered_track_runs(a, track_loops[:1]))

        agree = agreement("track", S, track_check)
        ms = median_ms(torch, k2, **fast)
        singles_ms = median_ms(torch, k2_singles, **fast)
        dev_ms = device_ms(torch, k2)
        plain_ms = median_ms(torch, lambda: [track_loops[1](*a) for a in argss], **once)
        passes = o.passes.cpu().numpy()
        n_bytes, n_ops = lm_bytes_ops(budgets, passes, S)
        n_bytes += (S - 1) * sum(budgets) * POINT_BYTES       # every sequence's points
        r = row(f"track_lm[N=8192,S={S}]", "resident_lm.cu",
                "direct_stereo_slam_tpu/models/tracker.py:316", agree["max_abs_err"], ms,
                plain_ms, n_bytes, n_ops)
        r.update(sequences=S, device_ms=dev_ms, singles_ms=singles_ms,
                 passes_per_call=float(passes.sum()), **{k: v for k, v in agree.items()
                                                           if k != "max_abs_err"})
        rows.append(r)
        print(f"K2-LM track_lm S={S} sequences x 1 candidate, one launch: rows bit-equal to "
              f"{S} single-sequence launches; "
              f"vs the loops per sequence: {agree['differ']} differ, "
              f"{agree['order_sensitive']} order-sensitive, max abs err "
              f"{agree['max_abs_err']:.2e}; passes per sequence (mean) {passes.sum(axis=1).mean():.1f}; kernel {ms:.4f} ms "
              f"(on the card {dev_ms} ms), {S} single launches {singles_ms:.4f} ms, plain loops "
              f"{plain_ms:.2f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})", flush=True)

        # ---- K3-LM: S sequences x 1 guess at scale 1
        k3 = lambda: rlm.scale_lm_cuda(p1, tmpl, s0, intr, intr, _T10, cfg)
        k3_singles = lambda: [rlm.scale_lm_cuda(own[s][1], tmpls[s], s0[s:s + 1], intr, intr,
                                                _T10, cfg) for s in range(S)]
        o, singles = k3(), k3_singles()
        torch.cuda.synchronize()
        for s, r in enumerate(singles):
            if not same(o.rows[s:s + 1], r.rows):
                fail(f"K3-LM S={S}: sequence {s}'s rows differ from its own launch")
        sargs = [(own[s][1], tmpls[s], s0[s:s + 1], intr, intr, _T10, cfg) for s in range(S)]

        def scale_check(s, o=o):
            a = sargs[s]
            got = so.ScaleOptResult(scale=o.scale[s:s + 1], error=o.error[s:s + 1])
            refs = {"K3 loop": scale_loops[0](*a), "plain": scale_loops[1](*a)}
            return lma.check(got, refs, lma.reordered_scale_runs(a, scale_loops))

        agree = agreement("scale", S, scale_check)
        ms = median_ms(torch, k3, **fast)
        singles_ms = median_ms(torch, k3_singles, **fast)
        dev_ms = device_ms(torch, k3)
        plain_ms = median_ms(torch, lambda: [scale_loops[1](*a) for a in sargs], **once)
        run = o.run.cpu().numpy()
        n_bytes, n_ops = lm_bytes_ops(budgets, run, S, SCALE_PASS_OPS, 4 + 112)
        n_bytes += (S - 1) * sum(budgets) * POINT_BYTES
        r = row(f"scale_lm[N=8192,S={S}]", "resident_lm.cu",
                "direct_stereo_slam_tpu/models/scale_opt.py:169", agree["max_abs_err"], ms,
                plain_ms, n_bytes, n_ops)
        r.update(sequences=S, device_ms=dev_ms, singles_ms=singles_ms,
                 passes_per_call=float(run.sum()), **{k: v for k, v in agree.items()
                                                     if k != "max_abs_err"})
        rows.append(r)
        print(f"K3-LM scale_lm S={S} sequences x 1 guess, one launch: rows bit-equal to {S} "
              f"single-sequence launches; "
              f"vs the loops per sequence: {agree['differ']} differ, "
              f"{agree['order_sensitive']} order-sensitive, max abs err "
              f"{agree['max_abs_err']:.2e}; scales {' '.join(f'{v:.3f}' for v in o.scale.tolist())}; passes run per "
              f"sequence (mean) {run.sum(axis=1).mean():.1f}; kernel {ms:.4f} ms (on the card "
              f"{dev_ms} ms), {S} single launches {singles_ms:.4f} ms, plain loops "
              f"{plain_ms:.2f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})", flush=True)
    return rows


def batch_phase(torch, dev):
    """run_batch (B sequences as one program, BASELINE config 5) at
    1232x368, 5 levels, S = 1, 8 and 11 sequences of 20 frames, the 19
    steps stepped through BATCH_PASSES times: one K2-LM and one K3-LM
    launch per step and no other kernel, a finite pose for every sequence
    and step. Returns each kernel's launches per step (the same at every
    S)."""
    from direct_stereo_slam_tpu_torch import run_batch

    steps = (BATCH_FRAMES - 1) * BATCH_PASSES
    per_step = None
    for S in BATCH_SEQUENCES:
        torch.cuda.reset_peak_memory_stats()
        counters = zero_counters()
        r = run_batch.run(S, BATCH_FRAMES, W, H, LEVELS, devices=1, device=dev,
                          passes=BATCH_PASSES)
        launches = read_counters(counters)
        step_ms = 1e3 * np.asarray(r["step_s"][1:])
        pf = np.asarray(r["pass_fps"])
        print(f"batch S={S}: {r['fps']} aggregate FPS ({r['fps_per_sequence']} per "
              f"sequence) over {steps - 1} timed steps of {S} x {W}x{H} in "
              f"{r['seconds']:.3f} s ({BATCH_PASSES} passes of {BATCH_FRAMES - 1} steps; "
              f"the passes' FPS median {np.median(pf)}, min {pf.min()}, max {pf.max()}), "
              f"step median {np.median(step_ms):.3f} ms (min {step_ms.min():.3f}, first step "
              f"{1e3 * r['step_s'][0]:.3f} ms, untimed); tracking error median |t| "
              f"{100 * np.median(r['errs_t']):.3f} cm, median |w| "
              f"{np.degrees(np.median(r['errs_r'])):.4f} deg, max |t| "
              f"{100 * np.max(r['errs_t']):.3f} cm; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches {launches}",
              flush=True)
        if launches["track_lm"] != steps or launches["scale_lm"] != steps:
            fail(f"batch S={S}: {launches['track_lm']} K2-LM and {launches['scale_lm']} K3-LM "
                 f"launches for {steps} steps (one each per step)")
        # the steps' inputs (built once, before the timed steps): a K15
        # template of each sequence's frame a step
        if launches["build_template"] != S * (BATCH_FRAMES - 1):
            fail(f"batch S={S}: {launches['build_template']} K15 launches for the "
                 f"{S * (BATCH_FRAMES - 1)} templates of the inputs")
        if any(v for k, v in launches.items()
               if k not in ("track_lm", "scale_lm", "build_template")):
            fail(f"batch S={S}: another kernel ran: {launches}")
        if not np.all(np.isfinite(r["T"])):
            fail(f"batch S={S}: non-finite poses")
        per_step = {k: v / steps for k, v in launches.items()}
    return per_step


def write_pgm(path: str, img) -> None:
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode() + np.ascontiguousarray(img, np.uint8).tobytes())


def native_phase(torch, dev, seq, tmp: str):
    """The e2e sequence's 40 uint8 pairs as PGM files, read by the native
    prefetching loader (io/native.NativeStereoLoader) and by the
    synchronous reader (io/dataset.StereoDirDataset), each into SLAMNode,
    in turns: the frames bit-equal (to each other and to the frames in
    memory), FPS of both, blocking waits per benign frame. Returns the
    launches of the last loader pass."""
    from direct_stereo_slam_tpu_torch.io.dataset import StereoDirDataset
    from direct_stereo_slam_tpu_torch.io.native import NativeStereoLoader
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

    ds, frames, cfg, intr = seq
    files = ([], [])
    for k, cam in enumerate(("img0", "img1")):
        d = os.path.join(tmp, f"pgm_{k}")
        os.makedirs(d, exist_ok=True)
        for i, f in enumerate(frames):
            files[k].append(os.path.join(d, f"{i:06d}.pgm"))
            write_pgm(files[k][-1], f[cam])
    stamps = [float(f["timestamp"]) for f in frames]
    sources = {
        "dataset": lambda: iter(StereoDirDataset(os.path.dirname(files[0][0]),
                                                 os.path.dirname(files[1][0]))),
        "native": lambda: iter(NativeStereoLoader(files[0], files[1], stamps, (W, H), (W, H),
                                                  capacity=8, n_threads=4)),
    }
    loaded = {name: list(src()) for name, src in sources.items()}
    for i, f in enumerate(frames):
        for cam in ("img0", "img1"):
            want = f[cam].astype(np.float32)
            if not all(np.array_equal(loaded[n][i][cam], want) for n in loaded):
                fail(f"native: pair {i} {cam} differs between the readers and memory")
        if not (loaded["native"][i]["timestamp"] == loaded["dataset"][i]["timestamp"] == stamps[i]
                and loaded["native"][i]["incoming_id"] == i):
            fail(f"native: pair {i}'s stamp or id differs")
    fps, launches, runs = {"dataset": [], "native": []}, None, {}
    for name in ("dataset", "native", "native", "dataset"):
        counters = zero_counters()
        node, shells, resets, dt = run_sequence(torch, SLAMNode, cfg, intr, ds, sources[name](),
                                                dev)
        fps[name].append(len(frames) / dt)
        runs[name] = (node, shells, resets)
        if name == "native":
            launches = read_counters(counters)
    waits = {}
    for name, src in sources.items():
        counter = WaitCounter(torch)
        run_sequence(torch, SLAMNode, cfg, intr, ds, src(), dev, per_call=counter)
        waits[name] = counter.summary()
    print(f"native: {len(frames)} PGM pairs {W}x{H}; frames bit-equal across the loader, the "
          f"synchronous reader and memory; FPS (read and decode included) dataset "
          f"{' / '.join(f'{x:.3f}' for x in fps['dataset'])}, native loader "
          f"{' / '.join(f'{x:.3f}' for x in fps['native'])} (turns d, n, n, d)", flush=True)
    for name in sources:
        print(f"native: blocking waits per call, {name}: {waits[name]}", flush=True)
    node, shells, resets = runs["native"]
    ate, path = ate_of(frames, shells)
    kfs = sum(s.is_kf for s in shells)
    kfs_d = sum(s.is_kf for s in runs["dataset"][1])
    print(f"native: loader pass {kfs} keyframes (dataset {kfs_d}), ATE {ate:.4f} m over "
          f"{path:.2f} m; launches {launches}", flush=True)
    fe = node.frontend
    if not fe.initialized or fe.is_lost or resets or not ate < 0.02 * path:
        fail(f"native: lost={fe.is_lost} resets {resets} ATE {ate:.4f} m (2% of {path:.2f} m)")
    if abs(kfs - kfs_d) > 1:
        fail(f"native: {kfs} keyframes against {kfs_d} through the dataset reader")
    gate_launches("native", launches, E2E_KERNELS)
    return launches


def eval_phase(torch, dev, tmp: str, n_frames: int = EVAL_FRAMES, config: str = "odometry",
               gate: bool = True):
    """The disk evaluation path as a user runs it: gen_longseq renders
    n_frames of the loop room at 1232x368 into the KITTI layout, then
    eval_kitti reads it back (PNG decode, calib.txt, times.txt, poses) as
    a new process (EVAL_CHILD: eval_kitti.main with the launch counts set
    to 0 before and printed after). Gated (``gate``): exit 0, results.json
    read back, the keyframes within 1 of an in-memory run of the same
    uint8 frames (runtime/eval.run_sequence, the same configuration), ATE
    under 2% of the path, and K1, K2-LM and K3-LM launched by the
    eval_kitti process. Returns that process's launches."""
    from direct_stereo_slam_tpu_torch import gen_longseq
    from direct_stereo_slam_tpu_torch.config import make_config
    from direct_stereo_slam_tpu_torch.io.synthetic import (SyntheticStereoDataset, _loop_scene,
                                                           loop_trajectory)
    from direct_stereo_slam_tpu_torch.runtime.eval import run_sequence as run_eval
    from direct_stereo_slam_tpu_torch.runtime.eval import score_rows, timing_table

    root = os.path.join(tmp, f"kitti_{n_frames}")
    t0 = time.perf_counter()
    if gen_longseq.main(["--out", root, "--frames", str(n_frames), "--width", str(W),
                         "--height", str(H)]) != 0:
        fail("eval: gen_longseq failed")
    gen_s = time.perf_counter() - t0
    out = os.path.join(tmp, f"eval_{n_frames}")
    cmd = [sys.executable, "-c", EVAL_CHILD, "--kitti", root, "--seqs", "00", "--config",
           config, "--max-frames", str(n_frames), "--levels", str(LEVELS), "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"eval: eval_kitti exited {proc.returncode}:\n{(proc.stdout + proc.stderr)[-3000:]}")
    counts = [l for l in proc.stdout.splitlines() if l.startswith("launches ")]
    if len(counts) != 1:
        fail(f"eval: the eval_kitti process printed {len(counts)} launch lines")
    launches = json.loads(counts[0][len("launches "):])
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)
    gt = np.loadtxt(os.path.join(root, "poses", "00.txt")).reshape(-1, 3, 4)[:, :, 3]
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    tag = f"eval {n_frames}"
    print(f"{tag}: gen_longseq {n_frames} frames {W}x{H} in {gen_s:.2f} s; eval_kitti --config "
          f"{config} exit 0 in {wall:.1f} s as a new process (start, kernel library load, PNG "
          f"decode); path {path:.2f} m; launches in that process {launches}", flush=True)
    for r in results:
        print(f"{tag} [{r['config']}]: {r['frames']} frames {r['fps']} FPS, {r['kfs']} "
              f"keyframes, {r['loops']} loops, ATE sodso {r.get('ate_sodso')} m, dslam "
              f"{r.get('ate_dslam')} m; stages {r['stages_ms']}", flush=True)
    if not gate:
        return launches
    row0 = results[0]
    ds = SyntheticStereoDataset(n_frames=n_frames, width=W, height=H, scene=_loop_scene(),
                                device=dev)
    ds.poses = loop_trajectory(n_frames, radius=8.0, laps=4.5 * n_frames / 360.0, ease_in=8)
    mem = QuantisedFrames([ds.frame(i) for i in range(n_frames)])
    K = ds.K
    cfg = make_config(int(2 * K[0, 2] + 1), int(2 * K[1, 2] + 1), preset=0, mode=1,
                      scale_opt_thres=15.0, lidar_range=-1.0, scan_context_thres=0.33)
    node, handler, dt = run_eval(mem, cfg, K, ds.t_cam1_cam0, levels=LEVELS, device=dev)
    handler.close()
    kfs_mem = len(handler.odometry_rows())
    ate_mem = score_rows(handler.odometry_rows(), ds.poses[:, :3, 3])
    print(f"{tag}: in memory {n_frames / dt:.3f} FPS, {kfs_mem} keyframes, ATE sodso "
          f"{ate_mem} m", flush=True)
    if row0["ate_sodso"] is None or not row0["ate_sodso"] < 0.02 * path:
        fail(f"{tag}: ATE {row0['ate_sodso']} m from disk, 2% of the path is {0.02 * path:.3f} m")
    if abs(row0["kfs"] - kfs_mem) > 1:
        fail(f"{tag}: {row0['kfs']} keyframes from disk against {kfs_mem} in memory")
    gate_launches(tag, launches, E2E_KERNELS)
    return launches


def lm_digest(torch, dev) -> None:
    """Digests of K2-LM's and K3-LM's single-sequence outputs (the front
    end's calls) on inputs made on the host from a seed, at the main
    path's shapes: 1232x368, 5 levels, templates of base 8192 with the
    last fifth padded, K2-LM at B = 1 / 5 / 78, K3-LM at G = 1 / 8, each
    with the card's time per call (``device_ms``, 15 samples). Run with
    ``--root`` on another checkout of the port to hold two forms of the
    kernels to the same bits and time them."""
    import hashlib

    from direct_stereo_slam_tpu_torch.config import make_config
    from direct_stereo_slam_tpu_torch.geometry import lie
    from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
    from direct_stereo_slam_tpu_torch.models import depth_template as dt
    from direct_stereo_slam_tpu_torch.models import tracker as tr
    from direct_stereo_slam_tpu_torch.ops import resident_lm as rlm
    from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid

    gen = np.random.RandomState(11)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    img = lambda ph: (120 + 50 * np.sin(xs / 9.0 + ph) * np.cos(ys / 7.0 - ph)
                      + 30 * np.sin((xs + ys) / 23.0)).astype(np.float32)
    pyr = lambda a: tuple(x.to(dev) for x in build_pyramid(torch.as_tensor(a), LEVELS).data)
    pyr1, pyr_r = pyr(img(0.3)), pyr(img(0.5))
    cols = {k: [] for k in dt.TrackerTemplate._fields}
    for lvl, n in enumerate(dt.default_budgets(W, H, LEVELS)):
        live = np.arange(n) < 0.8 * n
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        cols["pu"].append(t(gen.uniform(4, (W >> lvl) - 5, n).astype(np.float32)))
        cols["pv"].append(t(gen.uniform(4, (H >> lvl) - 5, n).astype(np.float32)))
        cols["pid"].append(t(np.where(live, gen.uniform(0.05, 0.5, n), 0).astype(np.float32)))
        cols["pcolor"].append(t(np.where(live, gen.uniform(40, 200, n), 0).astype(np.float32)))
        cols["pmask"].append(t(live))
    tmpl = dt.TrackerTemplate(*[tuple(cols[k]) for k in dt.TrackerTemplate._fields])
    cfg = make_config(W, H, preset=0, mode=1)
    K = np.array([[707.0, 0, W / 2 - 0.5], [0, 707.0, H / 2 - 0.5], [0, 0, 1]])
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LEVELS)
    t10 = np.eye(4, dtype=np.float32)
    t10[0, 3] = -0.54
    zero = tr.AffLight(torch.zeros((), device=dev), torch.zeros((), device=dev))
    one = torch.ones((), device=dev)
    digest = lambda ts: hashlib.sha256(b"".join(
        x.contiguous().cpu().numpy().tobytes() for x in ts)).hexdigest()[:16]
    for B in (1, 5, 78):
        xi = 0.02 * gen.randn(B, 6).astype(np.float32)
        T = torch.stack([torch.as_tensor(lie.se3_exp_np(x).astype(np.float32)) for x in xi])
        T = T.to(dev)
        call = lambda: rlm.track_lm_cuda(pyr1, tmpl, intr, cfg, T, zero, zero, one, one)
        print(f"lm digest K2-LM B={B}: {digest(call())}; on the card "
              f"{device_ms(torch, call, samples=15)} ms", flush=True)
    for G in (1, 8):
        s0 = torch.tensor((1.0,) if G == 1 else cfg.scale_opt.grid_guesses, device=dev)
        for kind, tm in (("padded", tmpl), ("live", tmpl._replace(
                pmask=tuple(torch.ones_like(m) for m in tmpl.pmask),
                pid=tuple(torch.where(m, x, 0.2) for x, m in zip(tmpl.pid, tmpl.pmask))))):
            call = lambda: rlm.scale_lm_cuda(pyr_r, tm, s0, intr, intr, t10, cfg)
            print(f"lm digest K3-LM G={G} {kind}: {digest([call().rows])}; on the card "
                  f"{device_ms(torch, call, samples=15)} ms", flush=True)


# ---------------------------------------------------------------------------
# the loop closure's pose graph: K6 (edges), K7 (a dense optimize), K8 (PCG)
# ---------------------------------------------------------------------------

PG_ITERS = 25                     # cfg.loop.pgo_iterations
# ring graphs per bucket (io/synthetic_graphs.py): (nodes, loop
# edge spacing); 512 is the largest dense bucket (6N = 3072), 1024 takes K8
PG_RINGS = {16: (12, 0), 128: (100, 10), 256: (200, 12), 512: (400, 20), 1024: (700, 25)}
# --pg-split's graphs: the dense buckets, 64 and 128 those of the loop run
PG_SPLIT_RINGS = {16: (12, 0), 64: (50, 8), 128: (100, 10), 256: (200, 12), 512: (400, 20)}
PG_REPLAYS = 3                    # the loop run's graphs replayed, spread over it
CG_RUNS = 16                      # resident CG optimizes held bit-equal (steps too)
# f32 operations the edge system needs per edge (not the dual-number
# design's 12 evaluations): two SE(3) inverse-products (~160), se3_log
# (~100), the closed-form 6x12 Jacobian, J_r^-1 and the adjoint product
# (~700), the Huber weight (~20), J^T W J (~1,700) and J^T W r (~150)
PG_EDGE_OPS = 3_000
PG_NODE_OPS = 300                 # T exp(x) per node
PG_ASM_OPS = 156                  # an edge's four 6x6 sub-blocks and two 6-vectors added


def gn_ops(N: int, Ev: int) -> float:
    """f32 operations of one dense Gauss-Newton iteration: the update, the
    valid edges' blocks, their assembly, and the factorization and the two
    triangular solves of the 6N system (n^3 / 3 + 2 n^2)."""
    n = 6 * N
    return N * PG_NODE_OPS + Ev * (PG_EDGE_OPS + PG_ASM_OPS) + n ** 3 / 3 + 2 * n ** 2


def gn_split(torch, pgk, data, iterations: int = PG_ITERS) -> dict:
    """One K7 launch of ``iterations`` with its phase stamps: us per
    iteration of each phase of block 0 and of its waits at the grid
    barriers, the barriers an iteration and the launch's span (ms)."""
    from direct_stereo_slam_tpu_torch.loop import pose_graph as pg

    timers = torch.zeros(len(pgk.GN_STAMPS), dtype=torch.int64, device=data.T_wc.device)
    pgk.pose_graph_gn_cuda(data, iterations, 1.0, pg.LAM, timers=timers)
    st = dict(zip(pgk.GN_STAMPS, timers.tolist()))
    out = {k: st[k] / 1e3 / iterations for k in pgk.GN_STAMPS
           if k not in ("barriers", "total", "final")}
    out.update(barriers_per_iteration=st["barriers"] / iterations, span_ms=st["total"] / 1e6)
    return out


def gn_per_iteration(pgk, data, iterations: int = PG_ITERS):
    """The dense optimize as one K7 launch per iteration (each from the
    previous launch's poses and update), then K6's last update: the form
    the resident launch is measured against."""
    from direct_stereo_slam_tpu_torch.loop import pose_graph as pg

    T, x = data.T_wc, None
    for _ in range(iterations):
        w = pgk.pose_graph_gn_cuda(data, 1, 1.0, pg.LAM, T=T, x=x, stop="solve")
        T, x = w.T, w.x.reshape(-1)
    return pgk.pose_graph_edges_cuda(T, x)


def pg_split(torch, dev) -> dict:
    """``--pg-split``: the dense ``optimize`` on PG_SPLIT_RINGS (host ms a
    call, synchronized, the median of 5; the card's ms by ``device_ms``)
    and, where the port has K7's stamps, their split; with ``--root``, of
    another checkout's port. Prints one line ``pg_split {...}``."""
    import direct_stereo_slam_tpu_torch as port
    from direct_stereo_slam_tpu_torch.io.synthetic_graphs import ring_graph
    from direct_stereo_slam_tpu_torch.loop import pose_graph as pg
    from direct_stereo_slam_tpu_torch.ops import pose_graph as pgk

    out = {}
    for bucket, (n, every) in PG_SPLIT_RINGS.items():
        data = pg.build_data(*ring_graph(n, seed=bucket, loop_every=every), device=dev)
        fn = lambda: pg.optimize(data, PG_ITERS, solver="dense")
        row = dict(ms=statistics.median(call_ms(torch, fn, 5)), device_ms=device_ms(torch, fn))
        if hasattr(pgk, "GN_STAMPS"):
            row["split_us_per_iteration"] = gn_split(torch, pgk, data)
        out[bucket] = row
    # the CG optimize at 1024 (KITTI 00's length): one launch here, K6 -> K8
    # an iteration in the parent
    n, every = PG_RINGS[1024]
    d = pg.build_data(*ring_graph(n, seed=1024, loop_every=every), device=dev)
    fn = lambda: pg.optimize(d, PG_ITERS, solver="cg")
    cg = dict(ms=statistics.median(call_ms(torch, fn, 3)),
              device_ms=device_ms(torch, fn, calls=3, samples=3))
    if hasattr(pgk, "CG_STAMPS"):
        steps = torch.zeros(PG_ITERS, dtype=torch.int32, device=dev)
        t = torch.zeros(len(pgk.CG_STAMPS), dtype=torch.int64, device=dev)
        pgk.pose_graph_cg_cuda(d, PG_ITERS, steps=steps, timers=t)
        s = dict(zip(pgk.CG_STAMPS, t.tolist()))
        cg["cg_steps"] = int(steps.sum())
        cg["split_us_per_step"] = {k: s[k] / 1e3 / max(cg["cg_steps"], 1)
                                   for k in ("node_pass", "update", "barrier")}
    if hasattr(pgk, "PCG_STAMPS"):
        _, H, g = pgk.pose_graph_edges_cuda(d.T_wc, None, d, 1.0)
        steps = torch.zeros(1, dtype=torch.int32, device=dev)
        t = torch.zeros(len(pgk.PCG_STAMPS), dtype=torch.int64, device=dev)
        pgk.pose_graph_pcg_cuda(d, H, g, pgk.incidence(d), pg.LAM + 1e-6, 100, steps, t)
        s = dict(zip(pgk.PCG_STAMPS, t.tolist()))
        cg["k8_split_us_per_step"] = {k: s[k] / 1e3 / max(int(steps), 1) for k in (
            "edge_pass", "node_pass", "update", "barrier")}
        cg["k8_steps"] = int(steps)
    line = dict(root=os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))),
                card=card_info(), iterations=PG_ITERS, buckets=out, cg_1024=cg)
    print("pg_split " + json.dumps(line), flush=True)
    return line


def call_ms(torch, fn, calls: int):
    """ms of each of ``calls`` calls of fn(), each alone (synchronized
    before and after: the call's whole cost, host issue included)."""
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def pg_launches(fn):
    """(result of fn(), the K6 / K7 / K8 / resident CG launches it made)."""
    counters = kernel_counters()
    names = ("pose_graph_edges", "pose_graph_gn", "pose_graph_pcg", "pose_graph_cg")
    before = [counters[k].launches for k in names]
    out = fn()
    return out, {k: counters[k].launches - b for k, b in zip(names, before)}


def pose_graph_report(torch, tag, final, calls, iterations):
    """The loop run's final pose graph alone, plain and kernels in turns
    (plain, kernels, kernels, plain; the two kernel runs bit-equal), and
    PG_REPLAYS of the graphs the run optimized, replayed through both:
    ms per call before (plain) and after (kernels)."""
    from direct_stereo_slam_tpu_torch.loop import pose_graph as pg

    plain = lambda d: pg.optimize_plain(d, iterations)
    kern = lambda d: pg.optimize(d, iterations)
    kern(final)
    out, ms = {}, {"plain": [], "kernels": []}
    for name, fn in (("plain", plain), ("kernels", kern), ("kernels", kern), ("plain", plain)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.setdefault(name, []).append(fn(final))
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0))
    if not torch.equal(out["kernels"][0], out["kernels"][1]):
        fail(f"{tag}: two runs of optimize on the final graph differ")
    err = float(torch.max(torch.abs(out["kernels"][0] - out["plain"][0])))
    if err > 1e-4:
        fail(f"{tag}: the kernels' final graph differs from the plain path by {err:.3g}")
    _, made = pg_launches(lambda: kern(final))
    n = int(final.node_valid.sum())
    print(f"{tag}: the final pose graph ({n} nodes, bucket {final.T_wc.shape[0]}, "
          f"{int(final.edge_valid.sum())} edges in {final.edge_a.shape[0]}) alone, ms per "
          f"optimize in turns plain / kernels / kernels / plain: {ms['plain'][0]:.3f} / "
          f"{ms['kernels'][0]:.3f} / {ms['kernels'][1]:.3f} / {ms['plain'][1]:.3f}; "
          f"two kernel runs bit-equal; max |kernels - plain| {err:.3g}; kernel launches "
          f"per optimize {made}", flush=True)
    if not calls:
        return
    pick = sorted({int(i) for i in np.linspace(0, len(calls) - 1, PG_REPLAYS)})
    before = [call_ms(torch, lambda: plain(calls[i]), 1)[0] for i in pick]
    after = [min(call_ms(torch, lambda: kern(calls[i]), 2)) for i in pick]
    sizes = [f"{int(calls[i].node_valid.sum())}/{calls[i].T_wc.shape[0]}" for i in pick]
    print(f"{tag}: {len(calls)} pose_graph_opt calls in the run; replayed calls {pick} "
          f"(nodes/bucket {sizes}): plain {' '.join(f'{x:.3f}' for x in before)} ms, kernels "
          f"{' '.join(f'{x:.3f}' for x in after)} ms (mean {np.mean(before):.3f} -> "
          f"{np.mean(after):.3f})", flush=True)


def device_kernels_per_optimize(torch, final, cg_data):
    """Device kernels (and memory copies / sets) of one optimize_plain and
    one optimize on ``final``, and of one CG optimize on ``cg_data``, from
    one torch.profiler session (the plain run, a synchronize, the dense
    kernels' run, a synchronize, the CG run: split at the first K6 or K7
    launch and at the first resident CG launch on the card), and the two
    kernel runs' kernel names. None if the profiler recorded no device
    event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from direct_stereo_slam_tpu_torch.loop import pose_graph as pg

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pg.optimize_plain(final, PG_ITERS)
        torch.cuda.synchronize()
        pg.optimize(final, PG_ITERS)
        torch.cuda.synchronize()
        pg.optimize(cg_data, PG_ITERS, solver="cg")
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    # the port's K6 / K7 (not at::native::sign_kernel, whose name holds "gn_kernel")
    ours = [e.time_range.start for e in evs
            if re.search(r"(?<![A-Za-z0-9_])(edges_kernel|gn_kernel)", e.name)]
    cg = [e.time_range.start for e in evs if "cg_opt_kernel" in e.name]
    if not evs or not ours or not cg:
        return None
    split, split2 = min(ours), min(cg)
    mem = lambda e: e.name.startswith(("Memcpy", "Memset"))
    count = lambda part: (sum(1 for e in part if not mem(e)), sum(1 for e in part if mem(e)))
    dense = [e for e in evs if split <= e.time_range.start < split2]
    cg_part = [e for e in evs if e.time_range.start >= split2]
    return (count([e for e in evs if e.time_range.start < split]), count(dense),
            sorted({e.name[:60] for e in dense}), count(cg_part),
            sorted({e.name[:60] for e in cg_part}))


def k7_solve_gate(torch, pg, pgk, data, tag):
    """K7 stopped after one iteration's solve against ``_solve_dense_fixed``
    (rel 1e-5) and a float64 solve of the same f32 system (no further than
    2x ``solve_ex``'s error). Returns (x's error, solve_ex's error), both
    relative to max|x|, and the system."""
    n = 6 * data.T_wc.shape[0]
    w = pgk.pose_graph_gn_cuda(data, 1, 1.0, pg.LAM, stop="solve")
    Hd, rhs = w.A[:n], w.A[n]
    rel = rel_err(torch, w.x, pg._solve_dense_fixed(data, w.H, w.g, pg.LAM))
    x64 = torch.linalg.solve(Hd.double(), rhs.double())
    err = lambda x: float((x.double().reshape(-1) - x64).abs().max() / x64.abs().max())
    e_k, e_lib = err(w.x), err(torch.linalg.solve_ex(Hd, rhs)[0])
    if not (rel < 1e-5 and e_k <= 2 * e_lib):
        fail(f"K7 at {tag}: x rel {rel:.3g} from _solve_dense_fixed, {e_k:.3g} from float64 "
             f"(solve_ex {e_lib:.3g})")
    return e_k, e_lib, Hd, rhs


def pose_graph_phase(torch, dev, final):
    """Ring graphs at PG_RINGS' buckets through optimize and optimize_plain
    (within 1e-4, CG at 1024 within 2e-3 x scale; two kernel runs
    bit-equal; launches per optimize; ms of both; the dense path's split
    and its form as a launch per iteration), the grid barrier's cost, then
    K6 and K7 at the loop phase's final graph and K8 at bucket 1024
    against their plain versions, timed. Returns the kernel rows."""
    from direct_stereo_slam_tpu_torch.geometry import lie
    from direct_stereo_slam_tpu_torch.io.synthetic_graphs import ring_graph
    from direct_stereo_slam_tpu_torch.loop import pose_graph as pg
    from direct_stereo_slam_tpu_torch.ops import _cuda
    from direct_stereo_slam_tpu_torch.ops import pose_graph as pgk

    graphs = {}
    for bucket, (n, every) in PG_RINGS.items():
        data = pg.build_data(*ring_graph(n, seed=bucket, loop_every=every), device=dev)
        graphs[bucket] = data
        T1, made = pg_launches(lambda: pg.optimize(data, PG_ITERS))
        T2 = pg.optimize(data, PG_ITERS)
        if not torch.equal(T1, T2):
            fail(f"pose graph bucket {bucket}: two runs of optimize differ")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T0 = pg.optimize_plain(data, PG_ITERS)
        torch.cuda.synchronize()
        pms = 1e3 * (time.perf_counter() - t0)
        err = float(torch.max(torch.abs(T1 - T0)))
        tol = 1e-4 if bucket <= 512 else 2e-3 * float(torch.max(torch.abs(T0[:, :3, 3])))
        if not err < tol:
            fail(f"pose graph bucket {bucket}: optimize differs from the plain path by "
                 f"{err:.3g} (tolerance {tol:.3g})")
        kms = call_ms(torch, lambda: pg.optimize(data, PG_ITERS), 5)
        print(f"pose graph bucket {bucket} ({n} nodes, {int(data.edge_valid.sum())} edges in "
              f"{data.edge_a.shape[0]}, {'dense' if bucket <= 512 else 'CG'}): optimize "
              f"{statistics.median(kms):.3f} ms (kernels, median of 5) vs {pms:.3f} ms "
              f"(plain, the call checked against); max |kernels - plain| "
              f"{err:.3g} (tolerance {tol:.3g}); two runs bit-equal; kernel launches per "
              f"optimize {made}", flush=True)
        if bucket > 512:
            continue
        # the resident launch against one K7 launch per iteration (the same
        # code: the same bits), card ms in turns
        resident = lambda: pg.optimize(data, PG_ITERS)
        per_it = lambda: gn_per_iteration(pgk, data)
        if not torch.equal(per_it(), T1):
            fail(f"pose graph bucket {bucket}: a launch per iteration differs from one launch")
        turns = [device_ms(torch, f, calls=3, samples=3)
                 for f in (resident, per_it, per_it, resident)]
        split = gn_split(torch, pgk, data)
        print(f"pose graph bucket {bucket}: K7 on the card, in turns one launch / a launch "
              f"per iteration / per iteration / one launch: "
              f"{' / '.join(str(t) for t in turns)} ms an optimize; one launch's split, us "
              f"an iteration (block 0's phase stamps): "
              f"{json.dumps({k: round(v, 3) for k, v in split.items()})}", flush=True)

    timers = torch.zeros(len(pgk.GN_STAMPS), dtype=torch.int64, device=dev)
    pgk.gn_barriers_cuda(10_000, timers)
    st = dict(zip(pgk.GN_STAMPS, timers.tolist()))
    grid = pgk.gn_grid(final.T_wc.shape[0], final.edge_a.shape[0])
    print(f"pose graph: K7's grid barrier {st['total'] / 1e3 / st['barriers']:.3f} us "
          f"(10,000 in one launch; block 0 waits {st['barrier'] / 1e3 / st['barriers']:.3f} "
          f"us of it); grid {grid}; ptxas "
          f"{ptxas_usage(_cuda.load_library().build_log, ('gn_kernel', 'edges_kernel', 'pcg_kernel', 'cg_opt_kernel'))}",
          flush=True)

    rows = []
    N, E = final.T_wc.shape[0], final.edge_a.shape[0]
    n = 6 * N
    Ev = int(final.edge_valid.sum())
    tag = f"final loop graph N={N},E={E}"
    T = final.T_wc
    x = pgk.pose_graph_gn_cuda(final, 1, 1.0, pg.LAM, stop="solve").x.reshape(-1)

    # ---- K6 at the update's poses
    k6 = lambda: pgk.pose_graph_edges_cuda(T, x, final, 1.0)
    k6_plain = lambda: pg._edge_system(final, T @ lie.se3_exp(x.reshape(-1, 6)), 1.0)
    _, Hk, gk = k6()
    Hp, gp = k6_plain()
    rel = max(rel_err(torch, Hk, Hp), rel_err(torch, gk, gp))
    f64 = final._replace(**{k: getattr(final, k).double()
                            for k in ("T_wc", "edge_Z", "edge_w_t", "edge_w_r")})
    H6, g6 = pg._edge_system(f64, T.double() @ lie.se3_exp(x.reshape(-1, 6).double()), 1.0)
    k64 = max(rel_err(torch, Hk.double(), H6), rel_err(torch, gk.double(), g6))
    p64 = max(rel_err(torch, Hp.double(), H6), rel_err(torch, gp.double(), g6))
    if not (rel < 1e-4 or k64 <= 2 * p64):
        fail(f"K6 at the {tag}: H / b rel {rel:.3g} from the plain version, {k64:.3g} from "
             f"float64 (the plain version {p64:.3g})")
    ms, pms = ab_ms(torch, k6, k6_plain, plain_kw=dict(repeats=5, inner=2))
    dms = device_ms(torch, k6)
    print(f"K6 pose_graph_edges {tag}: H / b rel {rel:.2e} from the plain version "
          f"(float64: kernel {k64:.2e}, plain {p64:.2e}); kernel {ms:.4f} ms (on the card "
          f"{dms} ms), plain (se3_exp update + jvp) {pms:.4f} ms", flush=True)
    rows.append(row(f"pose_graph_edges[N={N},E={E}]", "pose_graph.cu",
                    "direct_stereo_slam_tpu/loop/pose_graph.py:68",
                    max(float(torch.max(torch.abs(Hk - Hp))), float(torch.max(torch.abs(gk - gp)))),
                    ms, pms, E * (64 + 16 + 8 + 1 + 576 + 48) + N * (64 + 24 + 64),
                    E * PG_EDGE_OPS + N * PG_NODE_OPS))
    rows[-1]["device_ms"] = dms

    # ---- K7: its edge phase and assembly, its solve, the whole optimize
    w1 = pgk.pose_graph_gn_cuda(final, 1, 1.0, pg.LAM, stop="assembly")
    _, H0, g0 = pgk.pose_graph_edges_cuda(T, None, final, 1.0)
    w2 = pgk.pose_graph_gn_cuda(final, 2, 1.0, pg.LAM, stop="assembly")
    T1, H1, g1 = pgk.pose_graph_edges_cuda(T, x, final, 1.0)
    if not (torch.equal(w1.H, H0) and torch.equal(w1.g, g0) and torch.equal(w2.T, T1)
            and torch.equal(w2.H, H1) and torch.equal(w2.g, g1)):
        fail(f"K7 at the {tag}: its edge phase differs from K6 at the same poses")
    Hk7, rk7 = w1.A[:n], w1.A[n]
    Hp7, rp7 = pg._assemble_dense(final, w1.H, w1.g, pg.LAM)
    Hf7, rf7 = pg._assemble_dense_fixed(final, w1.H, w1.g, pg.LAM)
    # b near convergence is the difference of large opposite terms: its
    # order of sums is held against the sum of the terms' magnitudes
    b_scale = float(pg._scatter_b(final, w1.g.abs(), N).max())
    e7 = max(rel_err(torch, Hk7, Hp7), float(torch.max(torch.abs(rk7 - rp7))) / b_scale)
    if not e7 < 1e-4 or not (torch.equal(Hk7, Hf7) and torch.equal(rk7, rf7)):
        fail(f"K7 at the {tag}: its system rel {e7:.3g} from the plain version, bit-equal to "
             f"the fixed-order form: {torch.equal(Hk7, Hf7) and torch.equal(rk7, rf7)}")
    solve_errs = {"final": k7_solve_gate(torch, pg, pgk, final, f"the {tag}")[:2]}
    for bucket in (16, 128, 512):
        solve_errs[bucket] = k7_solve_gate(torch, pg, pgk, graphs[bucket], f"bucket {bucket}")[:2]
    k7 = lambda: pg.optimize(final, PG_ITERS)
    k7_plain = lambda: pg.optimize_plain(final, PG_ITERS, solver="dense")
    ms, pms = ab_ms(torch, k7, k7_plain, plain_kw=dict(repeats=2, inner=1, warmup=1))
    dms = device_ms(torch, k7, calls=5, samples=3)
    e_opt = float(torch.max(torch.abs(k7() - k7_plain())))
    lib = median_ms(torch, lambda: torch.linalg.solve_ex(Hk7, rk7))
    print(f"K7 pose_graph_gn {tag}: edge phase bit-equal to K6; system rel {e7:.2e} from "
          f"index_add_, bit-equal to the fixed-order plain form; one iteration's x from "
          f"float64 (relative to max|x|), kernel / solve_ex: "
          f"{ {k: f'{a:.2e} / {b:.2e}' for k, (a, b) in solve_errs.items()} }; optimize "
          f"({PG_ITERS} iterations, one launch) {ms:.4f} ms (on the card {dms} ms), plain "
          f"{pms:.4f} ms, max |kernel - plain| {e_opt:.3g}; torch.linalg.solve_ex on one "
          f"iteration's system {lib:.4f} ms", flush=True)
    rows.append(row(f"pose_graph_gn[N={N},E={E},iterations={PG_ITERS}]", "pose_graph.cu",
                    "direct_stereo_slam_tpu/loop/pose_graph.py:96", e_opt, ms, pms,
                    E * (64 + 16 + 8 + 1) + N * (64 + 1 + 64) + 8,
                    PG_ITERS * gn_ops(N, Ev)))
    rows[-1].update(device_ms=dms, library_ms=PG_ITERS * lib, solve_errs=solve_errs,
                    library=f"{PG_ITERS} x torch.linalg.solve_ex on one iteration's system "
                            f"(the solves a dense optimize needs)")

    # ---- K8 at bucket 1024
    d = graphs[1024]
    N8, E8 = d.T_wc.shape[0], d.edge_a.shape[0]
    Ev8 = int(d.edge_valid.sum())
    _, H8, g8 = pgk.pose_graph_edges_cuda(d.T_wc, None, d, 1.0)
    inc = pgk.incidence(d)
    steps = torch.zeros(1, dtype=torch.int32, device=dev)
    k8 = lambda: pgk.pose_graph_pcg_cuda(d, H8, g8, inc, pg.LAM + 1e-6, 100, steps)
    k8_plain = lambda: pg._solve_cg(d, H8, g8, pg.LAM, 100)
    x8, x8p = k8(), k8_plain()
    e8 = rel_err(torch, x8, x8p)
    if not e8 < 1e-3:
        fail(f"K8 at bucket 1024: x rel {e8:.3g} from _solve_cg")
    n_steps = int(steps)
    ms, pms = ab_ms(torch, k8, k8_plain, plain_kw=dict(repeats=3, inner=1))
    dms = device_ms(torch, k8)
    print(f"K8 pose_graph_pcg N={N8},E={E8} ({Ev8} valid edges): x rel {e8:.2e} from "
          f"_solve_cg; {n_steps} CG steps; kernel {ms:.4f} ms (on the card {dms} ms), "
          f"plain {pms:.4f} ms", flush=True)
    rows.append(row(f"pose_graph_pcg[N={N8},E={E8}]", "pose_graph.cu",
                    "direct_stereo_slam_tpu/loop/pose_graph.py:122",
                    float(torch.max(torch.abs(x8 - x8p))), ms, pms,
                    E8 * (576 + 48 + 17 + 8) + N8 * (1 + 24 + 4) + 8,
                    n_steps * (312 * Ev8 + 156 * N8) + 156 * Ev8 + 800 * N8))
    rows[-1].update(device_ms=dms, cg_steps=n_steps)
    # K8's phase stamps (block 0): us per CG step of each phase
    t8 = torch.zeros(len(pgk.PCG_STAMPS), dtype=torch.int64, device=dev)
    x8t = pgk.pose_graph_pcg_cuda(d, H8, g8, inc, pg.LAM + 1e-6, 100, steps, t8)
    if not torch.equal(x8t, x8):
        fail("K8: the phase stamps changed its output")
    s8 = dict(zip(pgk.PCG_STAMPS, t8.tolist()))
    k8_split = {k: s8[k] / 1e3 / max(n_steps, 1) for k in ("edge_pass", "node_pass", "update",
                                                           "barrier")}
    k8_split.update(setup_us=s8["setup"] / 1e3, barriers=s8["barriers"],
                    span_us=s8["total"] / 1e3)
    rows[-1]["phases_us_per_step"] = k8_split
    print(f"K8 pose_graph_pcg N={N8}: phase stamps (block 0, us per CG step; the cluster "
          f"barriers' waits apart): {json.dumps(k8_split)}", flush=True)

    # ---- the resident CG optimize (K8's redesign): CG_RUNS runs bit-equal
    # (steps too), the queued chain, the plain optimize
    cg_steps = torch.zeros(CG_RUNS, PG_ITERS, dtype=torch.int32, device=dev)
    runs = [pgk.pose_graph_cg_cuda(d, PG_ITERS, 1.0, pg.LAM + 1e-6, 100, steps=cg_steps[k])
            for k in range(CG_RUNS)]
    if not (all(torch.equal(T, runs[0]) for T in runs)
            and torch.equal(cg_steps, cg_steps[:1].expand_as(cg_steps))):
        fail(f"the resident CG optimize at bucket 1024: {CG_RUNS} runs differ")
    cg_steps = cg_steps[0]
    T_chain = pg.optimize_cg_queued(d, PG_ITERS)
    if not torch.equal(runs[0], T_chain):
        fail("the resident CG optimize at bucket 1024 differs from the queued K6 -> K8 chain")
    T_res = pg.optimize(d, PG_ITERS, solver="cg")
    T_plain = pg.optimize_plain(d, PG_ITERS, solver="cg")
    e_cg = float(torch.max(torch.abs(T_res - T_plain)))
    scale = float(torch.max(torch.abs(T_plain[:, :3, 3])))
    if not e_cg < 1e-3 * scale:
        fail(f"the resident CG optimize at bucket 1024: {e_cg:.3g} from optimize_plain "
             f"(solver cg), more than 1e-3 x the translation scale {scale:.3g}")
    total_steps = int(cg_steps.sum())
    chain_turns = [device_ms(torch, f, calls=3, samples=3) for f in (
        lambda: pg.optimize(d, PG_ITERS, solver="cg"), lambda: pg.optimize_cg_queued(d, PG_ITERS),
        lambda: pg.optimize_cg_queued(d, PG_ITERS), lambda: pg.optimize(d, PG_ITERS, solver="cg"))]
    tcg = torch.zeros(len(pgk.CG_STAMPS), dtype=torch.int64, device=dev)
    if not torch.equal(pgk.pose_graph_cg_cuda(d, PG_ITERS, timers=tcg), T_res):
        fail("the resident CG optimize: the phase stamps changed its output")
    scg = dict(zip(pgk.CG_STAMPS, tcg.tolist()))
    cg_split = {k: scg[k] / 1e3 / max(total_steps, 1) for k in ("node_pass", "update",
                                                               "barrier")}
    cg_split.update({f"{k}_us_per_iteration": scg[k] / 1e3 / PG_ITERS
                     for k in ("edges", "setup")},
                    incidence_us=scg["incidence"] / 1e3, barriers=scg["barriers"],
                    span_ms=scg["total"] / 1e6)
    ms, pms = ab_ms(torch, lambda: pg.optimize(d, PG_ITERS, solver="cg"),
                    lambda: pg.optimize_plain(d, PG_ITERS, solver="cg"),
                    plain_kw=dict(repeats=2, inner=1, warmup=1))
    print(f"pose graph CG optimize N={N8},E={E8} ({PG_ITERS} iterations, {total_steps} CG "
          f"steps, per iteration {cg_steps.tolist()}): one launch, {CG_RUNS} runs bit-equal, "
          f"bit-equal to the queued K6 -> K8 chain; {e_cg:.3g} from optimize_plain (scale "
          f"{scale:.3g}); card ms in turns one launch / chain / chain / one launch "
          f"{chain_turns}; {ms:.4f} ms a call, plain {pms:.4f} ms; "
          f"phase stamps (block 0, us per CG step unless named) {json.dumps(cg_split)}",
          flush=True)
    rows.append(row(f"pose_graph_cg[N={N8},E={E8},iterations={PG_ITERS}]", "pose_graph.cu",
                    "direct_stereo_slam_tpu/loop/pose_graph.py:122", e_cg, ms, pms,
                    E8 * (64 + 16 + 8 + 1) + N8 * (64 + 1 + 64) + 8,
                    PG_ITERS * (Ev8 * PG_EDGE_OPS + N8 * (PG_NODE_OPS + 800) + 156 * Ev8)
                    + total_steps * (312 * Ev8 + 156 * N8)))
    rows[-1].update(device_ms=chain_turns[0], chain_device_ms=[chain_turns[1], chain_turns[2]],
                    cg_steps=total_steps, phases_us_per_step=cg_split)

    counts = device_kernels_per_optimize(torch, final, d)
    if counts is None:
        print(f"pose graph: device kernels per optimize at the {tag}: not measured (the "
              f"profiler recorded no device event)", flush=True)
    else:
        (pk, pm), (kk, km), names, (ck, cm), cg_names = counts
        print(f"pose graph: device kernels per optimize at the {tag} (torch.profiler): plain "
              f"{pk} kernels + {pm} copies/sets, kernels {kk} kernels + {km} copies/sets "
              f"({names}); a CG optimize at bucket 1024: {ck} kernels + {cm} copies/sets "
              f"({cg_names})", flush=True)
        if kk != 1 or km != 0:
            fail(f"pose graph: a dense optimize ran {kk} kernels + {km} copies/sets on the "
                 f"card, not one K7 launch: {names}")
        if ck != 1 or cm != 0:
            fail(f"pose graph: a CG optimize ran {ck} kernels + {cm} copies/sets on the "
                 f"card, not one launch: {cg_names}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one more end-to-end pass; table to DIR")
    ap.add_argument("--long", action="store_true",
                    help="also run the 160-frame loop phase pipelined, the "
                         "320-frame loop protocol and longer KITTI-size "
                         "sequences on the card and on the host CPU (reported, "
                         "not gated)")
    ap.add_argument("--lm-digest", action="store_true",
                    help="only print digests of K2-LM's and K3-LM's single-sequence "
                         "outputs on seeded inputs (with --root: of another checkout)")
    ap.add_argument("--fps", action="store_true",
                    help="only time the e2e and 160-frame loop sequences (FPS, the BA's "
                         "synchronized stages, waits per keyframe call), to compare "
                         "this tree with another checkout (--root) in turns in one call")
    ap.add_argument("--fps-variant", action="append", default=[], choices=FPS_VARIANTS,
                    help="with --fps: time a variant of this tree's port (repeatable)")
    ap.add_argument("--ba-window", metavar="FILE",
                    help="only run the e2e sequence once and save its fullest BA window "
                         "to FILE")
    ap.add_argument("--ba-split", metavar="FILE",
                    help="only time K9's and K10's calls and sub-launches on the BA "
                         "window FILE (--ba-window; with --root: another checkout's)")
    ap.add_argument("--act", action="store_true",
                    help="only run the e2e sequence, the activate span's split and the act "
                         "phase (K12 / K13 against their plain versions)")
    ap.add_argument("--trace", action="store_true",
                    help="only run the e2e sequence, the template span's split and the "
                         "trace / template phase (K14 / K15 against their plain versions)")
    ap.add_argument("--pg-split", action="store_true",
                    help="only time the dense pose-graph optimize on ring graphs and, where "
                         "the port has K7's stamps, its split (with --root: another "
                         "checkout's)")
    ap.add_argument("--root", help="with --lm-digest, --fps, --ba-split, --pg-split or --act: "
                                   "the checkout whose port to load")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))

    # cuBLAS is bit-reproducible only with a fixed workspace, set before
    # its first handle: the resume phase runs under
    # torch.use_deterministic_algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card")
    try:
        from direct_stereo_slam_tpu_torch.ops import _cuda
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py ({e}); run the script "
             f"from the repository's root")
    dev = torch.device("cuda", 0)
    print(card_info(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    import importlib.util
    print("image and plot modules (the port needs none of them): " + ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'missing'}"
        for m in ("cv2", "PIL", "matplotlib")), flush=True)

    t0 = time.perf_counter()
    lib = _cuda.load_library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s -> {lib.path.name}",
          flush=True)
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    if args.lm_digest:
        lm_digest(torch, dev)
        return 0
    if args.fps:
        fps_only(torch, dev, args.fps_variant)
        return 0
    if args.ba_window:
        ba_window_only(torch, dev, args.ba_window)
        return 0
    if args.ba_split:
        ba_split(torch, dev, args.ba_split)
        return 0
    if args.pg_split:
        pg_split(torch, dev)
        return 0
    if args.act:
        act_only(torch, dev, lib.build_log)
        return 0
    if args.trace:
        trace_only(torch, dev, lib.build_log)
        return 0
    usage = lm_usage(lib.build_log)
    print(f"resident LM kernels (registers, bytes spilled, 8-block clusters resident at "
          f"once): {usage}", flush=True)

    t_run = time.perf_counter()
    elapsed = lambda phase: print(f"[{phase} done at {time.perf_counter() - t_run:.1f} s]",
                                  flush=True)
    rows = kernel_phase(torch, dev)
    elapsed("kernels")
    for r in rows:
        name = r["name"].split("[")[0]
        if name in usage:
            r.update(registers=usage[name][0], resident_clusters=usage[name][2])
    # each path's kernels count in that path's run: K1, K2-LM and K3-LM in
    # the e2e pass, K4-LM in the loop phase; the per-pass K2, K3 and K4 run
    # on none of the paths (every phase gates that they stay at 0)
    (launches, e2e_scale_calls, ba_calls, e2e_kfs, act_calls, trace_calls,
     marg_calls) = e2e_phase(torch, dev, args.profile)
    rows += act_phase(torch, dev, act_calls, lib.build_log)
    rows += trace_template_phase(torch, dev, trace_calls, lib.build_log)
    rows += ba_phase(torch, dev, ba_calls)
    rows += window_phase(torch, dev, ba_calls, marg_calls.calls)
    rows[-1].update(marg_split=marg_calls.split, scale_split=marg_calls.scale)
    elapsed("e2e, act, ba")
    pl_launches = pipelined_phase(torch, dev)
    mono_launches = mono_phase(torch, dev)
    undistort_phase(torch, dev)
    elapsed("e2e, pipelined, mono, undistort")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        seq = observed_sequence(dev)
        io_launches = {"bag": bag_phase(torch, dev, seq, tmp),
                       "live": live_phase(torch, dev, seq),
                       "resume": resume_phase(torch, dev, seq, tmp),
                       "observe": observe_phase(torch, dev, seq, tmp),
                       "native": native_phase(torch, dev, seq, tmp),
                       "eval": eval_phase(torch, dev, tmp),
                       "ab_policies": ab_phase(torch, dev, tmp)}
        if args.long:
            eval_phase(torch, dev, tmp, 320, "both", gate=False)
    elapsed("bag, live, resume, observe, native, eval, ab_policies")
    batch_per_step = batch_phase(torch, dev)
    elapsed("batch")
    loop_launches, loop_scale_calls, final_graph = loop_phase(torch, dev, LOOP_FRAMES,
                                                              LOOP_MARGIN)
    elapsed("loop")
    rows += pose_graph_phase(torch, dev, final_graph)
    elapsed("pose graph")
    if args.long:
        mono_sweep(torch, dev)
        loop_phase(torch, dev, LOOP_FRAMES, LOOP_MARGIN, gate=False, pipelined=True)
        loop_phase(torch, dev, 320, 100, gate=False)
        long_phase(torch, dev)
    launches.update({k: loop_launches[k] for k in (
        "loop_pose_lm", "pose3d_residual_pass", "pose_graph_edges", "pose_graph_gn",
        "pose_graph_pcg", "pose_graph_cg")})
    for r in rows:
        name = r["name"].split("[")[0]
        r["launches"] = launches[name]
        r["pipelined_launches"] = pl_launches[name]
        r["pipelined_launches_per_frame"] = pl_launches[name] / E2E_FRAMES
        r["mono_launches"] = mono_launches[name]
        for phase, counts in io_launches.items():
            r[f"{phase}_launches"] = counts[name]
        r["batch_launches_per_step"] = batch_per_step[name]
        r["loop_launches_per_frame"] = loop_launches[name] / LOOP_FRAMES
        if name == "scale_lm":
            r["path_calls"] = dict(e2e=e2e_scale_calls, loop=loop_scale_calls)
        if name in BA_ROWS + ACT_KERNELS + WINDOW_KERNELS:
            r["e2e_launches_per_keyframe"] = launches[name] / max(e2e_kfs, 1)
        r["e2e_launches_per_frame"] = launches[name] / E2E_FRAMES
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
