"""Loop handler: place recognition, loop correction and the pose graph
(port of loop/handler.py).

Consumes marginalized keyframes, keeps the rolling nearby point cloud and
the ringkey database, runs Scan Context retrieval, refines the PCA seed
with ICP, verifies with direct multi-seed alignment (kernel K4), adds
odometry and loop edges with the reference's information weighting
(LoopHandler.h:36-64), optimizes the pose graph on each accepted loop,
and records both trajectories (sodso / dslam).

Synchronous with ``threaded=False``; otherwise a background thread serves
a queue, like the reference's ``run()`` loop. On a card, that thread
launches K4 and the pose-graph solve on its current stream, which is the
default stream, the one the tracking thread uses too: the two threads'
device work is ordered on one stream, which is correct, though it does
not overlap. Each queued keyframe pins its pyramid (about 7 MB at
1232x368) until the thread has processed it.

A failure in the thread is not swallowed, as the reference's log-and-go-on
does: the thread keeps the first exception, only drains the queue after
it (so ``queue.join`` cannot deadlock), and ``join()`` / ``close()``
raise it, so the run that published the keyframes fails.
"""

from __future__ import annotations

import math
import queue
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import SLAMConfig
from ..geometry.camera import PyramidIntrinsics
from ..models.frontend import MarginalizedKF
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.timing import StageTimers
from . import icp as icp_mod
from . import pose_estimator, pose_graph, retrieval, scan, scancontext


@dataclass
class LoopFrame:
    kf_id: int
    incoming_id: int
    T_wc: np.ndarray               # current (pose-graph) estimate, float64
    t_wc_orig: np.ndarray          # original translation (sodso record)
    dso_error: float
    scale_error: float
    signature: Optional[np.ndarray] = None
    tfm_pca_rig: Optional[np.ndarray] = None
    pts_cam: Optional[np.ndarray] = None       # sparse points, camera frame
    pts_colors: Optional[np.ndarray] = None    # [K, L]
    pts_spherical: Optional[np.ndarray] = None # scan, camera frame
    exposure: float = 1.0                      # KF exposure time
    edges: List = field(default_factory=list)  # (other_idx, Z, w_t, w_r)


class LoopHandler:
    def __init__(self, cfg: SLAMConfig, intr: PyramidIntrinsics,
                 timers: Optional[StageTimers] = None,
                 threaded: Optional[bool] = None, device=DEFAULT_DEVICE):
        """``threaded=None`` resolves from cfg.runtime.multi_threading.
        ``device`` holds the pose graph and the large-database retrieval
        buffer; the direct estimate runs where the keyframe's pyramid is."""
        if threaded is None:
            threaded = cfg.runtime.multi_threading
        self.cfg = cfg
        self.intr = intr
        self.device = resolve_device(device)
        self.timers = timers if timers is not None else StageTimers()
        self.frames: List[LoopFrame] = []
        self.cloud = scan.NearbyPointCloud(cfg)
        self.ringkeys = retrieval.RingkeyDatabase(
            cfg.loop.knn, cfg.loop.loop_margin, cfg.loop.ringkey_thres,
            device=self.device)
        self.signatures: List[np.ndarray] = []
        # ringkey-database ordinal -> self.frames index: frames that skip the
        # Scan Context stage never enter the database (the reference indexes
        # its frames with database indices, LoopHandler.cpp:246-262)
        self.db_to_frame: List[int] = []
        self.direct_loop_count = 0
        self.icp_loop_count = 0
        self.cur_id = -1
        # how far each KF got through the funnel, and the best SC distance
        self.stats: Dict[str, int] = {
            "scan": 0, "ringkey_cand": 0, "sc_pass": 0, "direct_try": 0}
        self.min_sc_diff = float("inf")
        # per direct try: (best pose_error, best inlier_ratio, n seeds ok,
        # ok_res, ok_inlier, ok_aff, aff_a, aff_b, cur incoming_id,
        # matched incoming_id)
        self.try_log: List[Tuple] = []
        # optional hook: fn(cur_loopframe, matched_loopframe) -> iterable of
        # extra [4, 4] seeds appended to the stack
        self.debug_seed_hook = None
        self.viewer = None            # optional LiveViewer (set by SLAMNode)

        self.threaded = threaded
        if threaded:
            self._error: Optional[BaseException] = None
            self._q: "queue.Queue[MarginalizedKF]" = queue.Queue()
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------

    def publish_keyframe(self, mkf: MarginalizedKF):
        """Reference publishKeyframes (LoopHandler.cpp:144-196)."""
        if mkf.kf_id <= self.cur_id:   # keep id increasing (cpp:148-151)
            return
        self.cur_id = mkf.kf_id
        if self.threaded:
            self._q.put(mkf)
        else:
            self._process(mkf)

    def join(self):
        """Wait until the thread has taken every queued keyframe; raise if
        processing one failed."""
        if self.threaded:
            self._q.join()
            self._raise_failure()

    def close(self):
        """Drain the queue, stop the thread; raise if processing failed."""
        if self.threaded:
            self._q.join()
            self._stop.set()
            self._thread.join(timeout=2.0)
            self._raise_failure()

    def _raise_failure(self):
        if self._error is not None:
            raise RuntimeError("the loop thread failed to process a keyframe"
                               ) from self._error

    def _run(self):
        while not self._stop.is_set():
            try:
                mkf = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                if self._error is None:
                    self._process(mkf)
            except Exception as e:  # noqa: BLE001 — kept for join()/close()
                self._error = e
            finally:
                self._q.task_done()

    # ------------------------------------------------------------------

    def _icp(self, matched, pts_spherical, tfm_pca):
        lp = self.cfg.loop
        with self.timers.span("icp"):
            return icp_mod.icp(matched.pts_spherical, pts_spherical, tfm_pca,
                               lp.icp_max_iterations, lp.icp_max_corr_dist,
                               lp.icp_transformation_eps, lp.icp_thres)

    def _process(self, mkf: MarginalizedKF):
        lp = self.cfg.loop
        lc_enabled = lp.lidar_range > 0 and mkf.scale_error > 0

        pts_spherical = np.zeros((0, 3))
        if lc_enabled:
            with self.timers.span("pts_generation"):
                pts_world = mkf.pts_cam @ mkf.T_wc[:3, :3].T + mkf.T_wc[:3, 3]
                self.cloud.add_keyframe_points(mkf.kf_id, mkf.T_wc, pts_world)
                pts_spherical = self.cloud.generate_scan(np.linalg.inv(mkf.T_wc))

        lf = LoopFrame(
            kf_id=mkf.kf_id,
            incoming_id=mkf.incoming_id,
            T_wc=np.asarray(mkf.T_wc, np.float64).copy(),
            t_wc_orig=np.asarray(mkf.T_wc[:3, 3], np.float64).copy(),
            dso_error=mkf.dso_error * lp.dso_error_scale,
            scale_error=mkf.scale_error * lp.scale_error_scale,
            pts_cam=mkf.pts_cam,
            pts_colors=mkf.pts_colors,
            pts_spherical=pts_spherical,
            exposure=mkf.exposure,
        )
        idx = len(self.frames)
        self.frames.append(lf)
        self.signatures.append(np.zeros(lp.num_sectors * lp.num_rings))

        if self.viewer is not None:
            # final-only KF publish (PangolinLoopViewer.cpp:151-175)
            self.viewer.publish_keyframe(mkf.kf_id, lf.T_wc, mkf.pts_cam)

        # odometry edge to the previous keyframe (cpp:214-222); a NaN
        # dso_error marks a sequence restart -> no constraint (cpp:119-121)
        if idx > 0 and math.isfinite(lf.dso_error):
            prev = self.frames[idx - 1]
            Z = np.linalg.inv(lf.T_wc) @ prev.T_wc   # T_cur^-1 T_prev
            w_t = (1.0 / lf.scale_error if lf.scale_error > 0 else 1e-9) / max(lf.dso_error, 1e-12)
            w_r = lp.pose_r_weight / max(lf.dso_error, 1e-12)
            lf.edges.append((idx - 1, Z, w_t, w_r))

        if not lc_enabled or len(pts_spherical) < 10:
            return

        # ---- Scan Context + retrieval (cpp:231-259) ----------------------
        self.stats["scan"] += 1
        with self.timers.span("sc_generation"):
            sc = scancontext.generate(
                pts_spherical, lp.lidar_range, lp.num_sectors, lp.num_rings,
                binary=lp.sc_binary_signature)
        lf.signature = sc.signature
        lf.tfm_pca_rig = sc.tfm_pca_rig
        self.signatures[idx] = sc.signature

        with self.timers.span("search_ringkey"):
            db_candidates = self.ringkeys.search_and_insert(sc.ringkey)
            self.db_to_frame.append(idx)
        if not db_candidates:
            return
        candidates = [self.db_to_frame[c] for c in db_candidates
                      if self.frames[self.db_to_frame[c]].tfm_pca_rig is not None]
        if not candidates:
            return

        self.stats["ringkey_cand"] += 1
        with self.timers.span("search_sc"):
            match_idx, sc_diff = retrieval.search_signatures(
                sc.signature, self.signatures, candidates, lp.num_sectors)
        self.min_sc_diff = min(self.min_sc_diff, float(sc_diff))
        if sc_diff >= lp.scan_context_thres:
            return
        self.stats["sc_pass"] += 1

        matched = self.frames[match_idx]
        # initial guess from the PCA alignment (cpp:267-268)
        tfm_pca = np.linalg.inv(sc.tfm_pca_rig) @ matched.tfm_pca_rig

        # Acceptance policy (the reference package's default): ICP refines
        # the PCA seed, then direct alignment from the ICP (or PCA) seed, the
        # odometry seed and yaw perturbations is the gate whenever the
        # current pyramid exists. reference_acceptance=True is the
        # reference's order: direct from the PCA seed alone, then ICP-only.
        ref_mode = lp.reference_acceptance
        tfm_odo = np.linalg.inv(lf.T_wc) @ matched.T_wc

        icp_ok, tfm_icp, fitness = False, tfm_pca, float("inf")
        if not ref_mode:
            icp_ok, tfm_icp, fitness = self._icp(matched, pts_spherical, tfm_pca)

        direct_ok = False
        tfm_cur_matched = tfm_icp if icp_ok else tfm_pca
        pose_error = float("inf")
        if mkf.pyr is not None and matched.pts_cam is not None and len(matched.pts_cam) >= 8:
            self.stats["direct_try"] += 1
            with self.timers.span("direct_est"):
                res, n_ok = self._direct(mkf, lf, matched, tfm_pca, tfm_icp,
                                         tfm_odo, icp_ok, ref_mode)
                self.try_log.append((
                    res["pose_error"], res["inlier_ratio"], n_ok,
                    res["ok_res"], res["ok_inlier"], res["ok_aff"],
                    res["aff_a"], res["aff_b"],
                    int(lf.incoming_id), int(matched.incoming_id)))
                if res["ok"]:
                    direct_ok = True
                    tfm_cur_matched = res["T"].astype(np.float64)
                    pose_error = res["pose_error"] * lp.direct_error_scale
        if not ref_mode and mkf.pyr is not None and not direct_ok:
            # with a pyramid, photometric verification is the gate: ICP
            # fitness alone does not accept (also when direct never ran)
            icp_ok = False
        if ref_mode and not direct_ok:
            # reference fallback: ICP from the PCA seed, accepted on fitness
            # alone (LoopHandler.cpp:286-296)
            icp_ok, tfm_icp, fitness = self._icp(matched, pts_spherical, tfm_pca)
        if not direct_ok and icp_ok:
            tfm_cur_matched = tfm_icp
            pose_error = fitness * lp.icp_error_scale

        if not (direct_ok or icp_ok):
            return
        if direct_ok:
            self.direct_loop_count += 1
        else:
            self.icp_loop_count += 1

        # loop edge (cpp:306-310)
        w_t = (1.0 / matched.scale_error if matched.scale_error > 0 else 1e-9) \
            / max(pose_error, 1e-12)
        w_r = lp.pose_r_weight / max(pose_error, 1e-12)
        lf.edges.append((match_idx, tfm_cur_matched, w_t, w_r))

        if self.viewer is not None:
            # green current / red matched scan pair (refreshLidarData)
            m_in_cur = matched.pts_spherical @ tfm_cur_matched[:3, :3].T \
                + tfm_cur_matched[:3, 3]
            self.viewer.refresh_lidar_data(pts_spherical, m_in_cur)

        # ---- pose-graph optimization (cpp:314-329) ------------------------
        with self.timers.span("pose_graph_opt"):
            self._optimize()
        if self.viewer is not None:
            self.viewer.modify_keyframe_poses(
                {f.kf_id: f.T_wc for f in self.frames},
                loop_pair=(lf.kf_id, matched.kf_id),
                n_direct=self.direct_loop_count, n_icp=self.icp_loop_count)

    def _direct(self, mkf, lf, matched, tfm_pca, tfm_icp, tfm_odo, icp_ok,
                ref_mode):
        """Direct multi-seed estimate of the matched KF's points against the
        current KF's pyramid. Returns the best seed's values on the host and
        the number of seeds that passed."""
        lp = self.cfg.loop
        K = matched.pts_cam
        kmax = lp.max_loop_points
        k = min(len(K), kmax)
        px = np.zeros(kmax, np.float32)
        py = np.zeros(kmax, np.float32)
        pz = np.ones(kmax, np.float32)
        cols = np.zeros((kmax, self.cfg.tracker.pyr_levels), np.float32)
        mask = np.zeros(kmax, bool)
        px[:k], py[:k], pz[:k] = K[:k, 0], K[:k, 1], K[:k, 2]
        ncols = matched.pts_colors.shape[1]
        # the matched KF's intensities in the current frame's exposure (the
        # aligner's own affine handles the residual drift)
        exp_gain = lf.exposure / max(matched.exposure, 1e-9)
        cols[:k, :ncols] = matched.pts_colors[:k] * exp_gain
        if ncols < cols.shape[1]:
            cols[:k, ncols:] = cols[:k, ncols - 1: ncols]
        mask[:k] = True
        if ref_mode:
            primary, extras = tfm_pca, ()
        elif icp_ok:
            primary, extras = tfm_icp, (tfm_odo,)
        else:
            primary, extras = tfm_pca, (tfm_odo,)
        perturb = () if ref_mode else tuple(lp.seed_yaw_perturb_deg)
        if self.debug_seed_hook is not None:
            extras = tuple(extras) + tuple(self.debug_seed_hook(lf, matched))
        stack = pose_estimator.make_seed_stack(primary, extras, perturb)
        dev = mkf.pyr[0].device
        t = lambda a: torch.as_tensor(a, device=dev)
        bres = pose_estimator.estimate_batch(
            tuple(mkf.pyr), t(px), t(py), t(pz), t(cols), t(mask), t(stack),
            self.intr, self.cfg)
        b = bres.best
        # one host read of everything the policy and the log need
        vals = torch.cat([b.pose_error[None], b.inlier_ratio[None],
                          b.aff.a[None], b.aff.b[None],
                          torch.stack([b.ok, b.ok_res, b.ok_inlier, b.ok_aff]).float(),
                          bres.seed_ok.float().sum()[None],
                          b.T.reshape(16)]).cpu().numpy()
        res = dict(pose_error=float(vals[0]), inlier_ratio=float(vals[1]),
                   aff_a=float(vals[2]), aff_b=float(vals[3]),
                   ok=bool(vals[4]), ok_res=bool(vals[5]), ok_inlier=bool(vals[6]),
                   ok_aff=bool(vals[7]), T=vals[9:].reshape(4, 4))
        return res, int(vals[8])

    def graph_data(self):
        """(PoseGraphData of every frame and edge, the f32 poses it holds)."""
        edges = []
        for i, lf in enumerate(self.frames):
            for (j, Z, w_t, w_r) in lf.edges:
                edges.append((i, j, np.asarray(Z, np.float32), w_t, w_r))
        poses32 = np.stack([lf.T_wc for lf in self.frames]).astype(np.float32)
        data = pose_graph.build_data(poses32, edges, fixed_node=len(self.frames) - 1,
                                     device=self.device)
        return data, poses32

    def _optimize(self):
        data, poses32 = self.graph_data()
        T_opt = pose_graph.optimize(data, self.cfg.loop.pgo_iterations).cpu().numpy()
        # apply the float32 solve as a DELTA on the float64 poses: writing
        # T_opt back would quantize every pose to float32 absolute resolution
        # on every accepted loop; the delta's float32 error is relative to
        # the correction, not the position
        for i, lf in enumerate(self.frames):
            delta = T_opt[i].astype(np.float64) @ np.linalg.inv(
                poses32[i].astype(np.float64))
            lf.T_wc = delta @ lf.T_wc

    # ------------------------------------------------------------------
    # trajectory export (savePose, LoopHandler.cpp:60-80)
    # ------------------------------------------------------------------

    def odometry_rows(self):
        return [(lf.incoming_id, *lf.t_wc_orig) for lf in self.frames]

    def optimized_rows(self):
        return [(lf.incoming_id, *lf.T_wc[:3, 3]) for lf in self.frames]
