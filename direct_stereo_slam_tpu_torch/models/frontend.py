"""Visual-odometry front end: the host orchestrator (port of
models/frontend.py).

Per-frame coarse tracking with the staged motion-model try-list, the
keyframe decision, and the keyframe pipeline: trace -> flag frames for
marginalization -> insert -> activate -> windowed BA -> template ->
stereo scale optimization -> point removal -> new traces -> frame
marginalization. Numeric work runs in the port's device functions on
``device``; this module owns the control flow and the fixed-slot
bookkeeping. Every front-end mode of the reference runs: the synchronous
path, pipelined tracking (``cfg.runtime.pipelined_tracking``: frame N's
track is launched before frame N-1 is consumed, see
``_process_pipelined``) and the monocular bootstrap
(``cfg.runtime.mono_initializer``, ``models/mono_init.py``).

Host arrays reach the card through pinned memory without waiting for the
stream (``utils.device.to_device``), so the device's results are read at
a few chosen points only, as the reference's design has it: on every
frame the one read of the tracker's outputs; on a keyframe, bundle 3 (the
BA's gates, the post-BA views, the template's count and the scale LM's
results). The activation (K1, K12, K13) reads nothing; the keyframe tail
is dispatched with its copy to the host started, and committed
(``flush_pending``) right after the next frame's tracker read. The host
views of the window are patched after the rescale and the tail, not read
again.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import SLAMConfig
from ..geometry.camera import PyramidIntrinsics
from ..ops import activate
from ..ops import window as win
from ..ops.distance_map import build_distance_map
from ..ops.interp import bilinear_gather, bilinear_gather_scalar
from ..ops.pyramid import Pyramid, build_pyramid
from ..ops.select import adapt_potential, make_selection_map
from ..utils.device import DEFAULT_DEVICE, HostCopy, resolve_device, to_device, to_host
from ..utils.timing import StageTimers
from . import ba, immature, initializer, mono_init
from .depth_template import (TrackerTemplate, build_template_from_state, default_budgets,
                             scale_template_idepth)
from .scale_opt import ScaleState, decide_scale_optimization, dispatch_scale_optimization
from .tracker import (AffLight, TrackResult, make_motion_tries, select_winner,
                      select_winner_serial, track_candidates_batch)


def _const_motion_candidate(T_rn_last: torch.Tensor, T_rn_prelast: torch.Tensor):
    """The constant-motion hypothesis (make_motion_tries' stage1[0]) on the
    device: with T_rn the warp ref -> frame, the reference's
    ``inv(slast_2_sprelast) @ lastF_2_slast`` reduces to
    ``Tl @ inv(Tp) @ Tl``, so a pipelined dispatch needs no host value of
    the previous frames. ``inv_ex``: ``inv`` checks for errors, which
    reads the device."""
    return T_rn_last @ torch.linalg.inv_ex(T_rn_prelast)[0] @ T_rn_last


def _pack_track(r: TrackResult, counts: torch.Tensor) -> torch.Tensor:
    """A tracked batch and the per-slot immature counts as one flat f32
    tensor, so one copy brings them to the host: per candidate
    [res_per_level (L), flow (3), T (16), a, b, ok], then the counts."""
    B = r.T.shape[0]
    rows = torch.cat([r.res_per_level, r.flow, r.T.reshape(B, 16),
                      torch.stack([r.aff.a, r.aff.b, r.ok.to(torch.float32)], -1)], 1)
    return torch.cat([rows.reshape(-1), counts.to(torch.float32)])


def _unpack_track(flat: np.ndarray, levels: int, n_slots: int):
    """_pack_track's layout back into (TrackResultNp, counts [S])."""
    rows = flat[:flat.shape[0] - n_slots].reshape(-1, levels + 22)
    L = levels
    res = TrackResultNp(res_per_level=rows[:, :L], flow=rows[:, L:L + 3],
                        T=rows[:, L + 3:L + 19].reshape(-1, 4, 4),
                        aff=rows[:, L + 19:L + 21], ok=rows[:, L + 21] > 0.5)
    return res, flat[flat.shape[0] - n_slots:].astype(np.int64)


def _host_f32(x) -> float:
    """A host number rounded to f32: how the tracker takes a scalar by
    value (``ops/resident_lm._scalar``), with no upload."""
    return float(np.float32(x))


def _host_aff(ab) -> AffLight:
    return AffLight(_host_f32(ab[0]), _host_f32(ab[1]))


def _activation_warps(K: np.ndarray, T_cw_new: np.ndarray, T_all_old, slots, S: int):
    """Per slot, the warp of its candidates into the new keyframe at half
    resolution (host 4x4 math): (KRKi1 [S, 3, 3], Kt1 [S, 3]); the
    identity for a slot not in ``slots``."""
    K1i = np.linalg.inv(K)
    KRKi1 = np.tile(np.eye(3, dtype=np.float32), (S, 1, 1))
    Kt1 = np.zeros((S, 3), np.float32)
    for slot in slots:
        T_nh1 = T_cw_new @ np.linalg.inv(T_all_old[slot])
        KRKi1[slot] = K @ T_nh1[:3, :3] @ K1i
        Kt1[slot] = K @ T_nh1[:3, 3]
    return KRKi1, Kt1


def _halfres_distance_map(state: ba.BAState, K1: torch.Tensor, h2: int, w2: int,
                          T_nh: torch.Tensor, calib: torch.Tensor):
    """Project every active point into the new KF at half resolution and
    build the activation distance map (kernel K1 on the card); ``T_nh``
    [W, 4, 4] takes each host into the new keyframe (K16's T_rh toward
    it), ``calib`` the intrinsics."""
    fx0, fy0, cx0, cy0 = calib.unbind(0)
    Xh = torch.stack([(state.p_u - cx0) / fx0, (state.p_v - cy0) / fy0,
                      torch.ones_like(state.p_u)], -1) / torch.clamp(state.p_idepth, min=1e-6)[:, None]
    R = T_nh[state.p_host, :3, :3]
    t = T_nh[state.p_host, :3, 3]
    pt = (R @ Xh[..., None])[..., 0] + t
    pu2 = K1[0, 0] * pt[:, 0] / pt[:, 2] + K1[0, 2]
    pv2 = K1[1, 1] * pt[:, 1] / pt[:, 2] + K1[1, 2]
    proj_ok = state.p_valid & (pt[:, 2] > 0)
    return build_distance_map(pu2, pv2, proj_ok, h2, w2)


def _flag_points_for_removal(p_valid, pid_a, n_good, Hdd, pair_good, p_num_good,
                             p_last_res, host_flagged, flagged, cfg: SLAMConfig):
    """flagPointsForRemoval on host arrays: (bad, leaving, marg, drop, rules)."""
    mgar = cfg.ba.min_good_active_res_for_marg
    mgr = cfg.ba.min_good_res_for_marg
    bad = p_valid & ((pid_a < 0) | (n_good == 0))
    vis_in_marg = (pair_good[:, flagged].sum(1) if len(flagged) else np.zeros_like(n_good))
    rule_support = ((n_good >= mgar) & (p_num_good > mgr + 10)
                    & (n_good - vis_in_marg < mgar))
    rule_oob = p_last_res[:, 0] == ba.RES_OOB
    rule_out2 = ((n_good >= 2) & (p_last_res[:, 0] == ba.RES_OUTLIER)
                 & (p_last_res[:, 1] == ba.RES_OUTLIER))
    is_oob = rule_support | rule_oob | rule_out2
    leaving = p_valid & ~bad & (host_flagged | is_oob)
    inlier_new = (n_good >= mgar) & (p_num_good >= mgr)
    marg = leaving & inlier_new & (Hdd > cfg.ba.min_idepth_h_marg)
    drop = bad | (leaving & ~marg)
    proactive = leaving & ~host_flagged
    rules = {
        "bad": int(bad.sum()),
        "support_concentration": int((proactive & rule_support).sum()),
        "newest_oob": int((proactive & rule_oob & ~rule_support).sum()),
        "two_outliers": int((proactive & rule_out2 & ~rule_support & ~rule_oob).sum()),
        "host_leaving": int((leaving & host_flagged).sum()),
    }
    return bad, leaving, marg, drop, rules


def _gather_level_colors(pyr_data, u, v) -> torch.Tensor:
    """Level-0 pixel coords [K] -> per-level interpolated intensity [K, L]."""
    cols = []
    for lvl, planes in enumerate(pyr_data):
        ul = (u + 0.5) / (1 << lvl) - 0.5
        vl = (v + 0.5) / (1 << lvl) - 0.5
        cols.append(bilinear_gather_scalar(planes[..., 0], ul, vl))
    return torch.stack(cols, -1)


@dataclass
class TrackResultNp:
    """Host copy of the tracker-batch outputs."""

    res_per_level: np.ndarray    # [N, L]
    flow: np.ndarray             # [N, 3]
    T: np.ndarray                # [N, 4, 4]
    aff: np.ndarray              # [N, 2]
    ok: np.ndarray               # [N]


@dataclass
class FrameShell:
    """Host record per processed frame (DSO FrameShell)."""

    incoming_id: int
    timestamp: float
    T_wc: np.ndarray                  # camToWorld
    aff: np.ndarray                   # (a, b)
    tracking_ref_kf: int = -1
    is_kf: bool = False
    exposure: float = 1.0


@dataclass
class MarginalizedKF:
    """Record handed to the loop handler when a KF leaves the window."""

    kf_id: int
    incoming_id: int
    timestamp: float
    T_wc: np.ndarray
    dso_error: float
    scale_error: float
    pts_cam: np.ndarray               # [K, 3] camera frame
    pts_colors: np.ndarray            # [K, L]
    pyr: Optional[tuple] = None
    exposure: float = 1.0


class FrontEnd:
    def __init__(self, cfg: SLAMConfig, intr0: PyramidIntrinsics,
                 intr1: PyramidIntrinsics, t_cam1_cam0: np.ndarray,
                 prev_kf_count: int = 0, timers: Optional[StageTimers] = None,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.intr0 = intr0
        self.intr1 = intr1
        self.t_cam1_cam0 = np.asarray(t_cam1_cam0, np.float32)
        self.levels = cfg.tracker.pyr_levels

        self.n_slots = cfg.ba.max_frames + 1
        self.pool = self.n_slots * cfg.ba.max_points_per_frame
        H, W = intr0.h[0], intr0.w[0]
        calib = np.array([intr0.fx[0], intr0.fy[0], intr0.cx[0], intr0.cy[0]], np.float32)
        self.ba_state = ba.empty_state(self.n_slots, self.pool, H, W, calib, self.device)
        self.budgets = default_budgets(W, H, self.levels)

        self.imm_budget = cfg.ba.max_immature_per_frame
        self.immatures = immature.empty_batch(self.n_slots, self.imm_budget, self.device)
        self.imm_slots: set = set()
        self.pyramids: Dict[int, Pyramid] = {}
        self.slot_stats: Dict[int, Dict[str, int]] = {}
        self.removal_stats: Dict[str, int] = {}
        self.template: Optional[TrackerTemplate] = None
        self.template_kf_slot = -1
        self.template_ref_aff = AffLight(self._f32(0.0), self._f32(0.0))
        self.template_ref_aff_np = np.zeros(2, np.float32)
        self.template_ref_exposure = self._f32(1.0)
        self.template_ref_exposure_np = 1.0
        self.first_coarse_rmse = -1.0
        self.last_coarse_rmse = 1e9

        self.all_frames: List[FrameShell] = []
        self.kf_shells: List[FrameShell] = []
        self.prev_kf_count = prev_kf_count
        self.num_kfs = prev_kf_count       # global KF id counter (see reference)

        self.initialized = False
        self.is_lost = False
        self.init_failed = False
        self.cur_pose = np.eye(4, dtype=np.float32)   # camToWorld

        self.scale_state = ScaleState()
        self.scale_errors: Dict[int, float] = {}
        self.slot_exposure: Dict[int, float] = {}
        self._cur_exposure = 1.0
        self.last_dso_error = 10e5
        self.current_min_act_dist = 2.0
        self.pot = 5

        self.marginalized_queue: List[MarginalizedKF] = []
        # a keyframe tail dispatched and not yet committed (flush_pending)
        self._pending_finalize = None
        self._trace_overflow_acc = None
        self._frames_since_kf = 0
        self._marg_export_acc: Dict[int, list] = {}
        self.timers = timers if timers is not None else StageTimers()
        self._views_cache_key = None
        self._views_cache = None
        self._track_imm_counts = None
        self._track_imm_counts_key = None
        # pipelined tracking: the frame in flight, the device motion state
        # (T_rn_last, T_rn_prelast, aff_last), and the two pinned host
        # buffers its outputs are copied into, used in turn
        self._pl_inflight = None
        self._pl_state = None
        self._pl_bufs: List[Optional[torch.Tensor]] = [None, None]
        self._pl_next_buf = 0
        # staged escalations and flush retracks actually exercised
        self.pl_escalations = 0
        self.pl_retracks = 0
        # newest fully processed shell: in pipelined mode add_stereo_frame
        # returns the in-flight shell, whose pose and is_kf are
        # placeholders until it is consumed one frame later
        self.last_completed_shell: Optional[FrameShell] = None
        # monocular bootstrap (cfg.runtime.mono_initializer)
        self.mono_state: Optional[mono_init.MonoInitState] = None
        self._mono_first_pyr: Optional[Pyramid] = None
        self._mono_first_shell: Optional[FrameShell] = None
        self._mono_frames = 0
        self._post_init_T_hint: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _upload(self, a) -> torch.Tensor:
        """A host array on the device, without waiting for the stream."""
        return to_device(a, self.device)

    def _f32(self, x) -> torch.Tensor:
        return self._upload(np.float32(x))

    def _views_np(self):
        """Host copies of ba.current_views in one device-to-host copy,
        cached per BAState instance (states are replaced, never mutated, so
        identity is a sound key)."""
        st = self.ba_state
        if self._views_cache_key is not st:
            self._set_views(st, to_host(ba.current_views(st)))
        return self._views_cache

    def _set_views(self, st, views, pose=None, frames_out=(), points_out=None):
        """Key the host views cache to ``st`` without a read: ``views``, a
        host copy of ``ba.current_views`` of ``st`` or of the state it was
        made from, with what that change moved: ``pose`` (slot, T_cw), a
        slot's new current pose; ``frames_out``, the slots marginalized
        (invalid, id -1; their pose and affine rows go stale, and nothing
        reads an invalid slot's); ``points_out`` [NP], the points removed."""
        T, aff, calib, frame_valid, frame_id, p_valid, p_host = views
        if pose is not None:
            T = T.copy()
            T[pose[0]] = pose[1]
        if len(frames_out):
            frame_valid, frame_id = frame_valid.copy(), frame_id.copy()
            frame_valid[list(frames_out)] = False
            frame_id[list(frames_out)] = -1
        if points_out is not None:
            p_valid = p_valid & ~points_out
        self._views_cache = (T, aff, calib, frame_valid, frame_id, p_valid, p_host)
        self._views_cache_key = st

    def _free_slot(self) -> int:
        valid = self._views_np()[3]
        for i in range(self.n_slots):
            if not valid[i]:
                return i
        raise RuntimeError("no free keyframe slot")

    def _newest_slot(self) -> int:
        views = self._views_np()
        return int(np.argmax(np.where(views[3], views[4], -1)))

    def _active_slots(self) -> List[int]:
        views = self._views_np()
        valid, fid = views[3], views[4]
        return sorted([i for i in range(self.n_slots) if valid[i]], key=lambda s: fid[s])

    def _kf_pose(self, slot: int) -> np.ndarray:
        """camToWorld of a window KF (current estimate)."""
        return np.linalg.inv(self._views_np()[0][slot])

    def _image(self, img) -> torch.Tensor:
        """A [H, W] intensity image (numpy or tensor) as f32 on the device."""
        if isinstance(img, torch.Tensor):
            return img.to(device=self.device, dtype=torch.float32)
        return self._upload(np.asarray(img, np.float32))

    def _imm_counts_np(self) -> np.ndarray:
        return self.immatures.valid.sum(dim=1).cpu().numpy()

    def _read_track(self, r: TrackResult):
        """One blocking copy of a tracked batch and the per-slot immature
        counts: (TrackResultNp, counts [S])."""
        packed = _pack_track(r, self.immatures.valid.sum(dim=1))
        return _unpack_track(packed.cpu().numpy(), self.levels, self.n_slots)

    # ------------------------------------------------------------------
    # main entry (reference addActiveStereoFrame)
    # ------------------------------------------------------------------

    def add_stereo_frame(self, img0, img1, incoming_id: int, timestamp: float,
                         exposure: float = 1.0) -> FrameShell:
        """``img0``/``img1``: [H, W] intensities (numpy or tensors);
        ``exposure`` is the left image's exposure time (1.0 when unknown)."""
        self._cur_exposure = max(float(exposure), 1e-6)
        pyr0 = build_pyramid(self._image(img0), self.levels)
        if not self.initialized:
            shell = self._initialize(pyr0, img1, incoming_id, timestamp)
            if not self.initialized or getattr(shell, "_flow", None) is None:
                return shell
            # the mono bootstrap just finished and tracked this frame: it
            # takes the keyframe decision like any other frame
        elif (self.cfg.runtime.pipelined_tracking
              and self.cfg.tracker.winner_policy != "serial"):
            return self._process_pipelined(pyr0, img1, incoming_id, timestamp)
        else:
            shell = self._track_frame(pyr0, incoming_id, timestamp)
        if not self.is_lost:
            self._finish_frame(shell, pyr0, img1)
        return shell

    def _finish_frame(self, shell: FrameShell, pyr0: Pyramid, img1) -> bool:
        """The keyframe decision and the keyframe / non-keyframe pipeline of
        a tracked frame; returns whether it became a keyframe."""
        is_kf = self._keyframe_decision(shell)
        if is_kf:
            self._make_keyframe(shell, pyr0, img1)
        else:
            self._make_non_keyframe(shell, pyr0)
        self.last_completed_shell = shell
        return is_kf

    # ------------------------------------------------------------------
    # initialization (stereo)
    # ------------------------------------------------------------------

    def _initialize(self, pyr0: Pyramid, img1, incoming_id, timestamp) -> FrameShell:
        if self.cfg.runtime.mono_initializer:
            return self._initialize_mono(pyr0, incoming_id, timestamp)
        pyr1 = build_pyramid(self._image(img1), self.levels)
        res = initializer.initialize_from_stereo(
            pyr0, pyr1, self.intr0, self.t_cam1_cam0, self.cfg,
            budget=self.cfg.ba.max_immature_per_frame, pot=self.pot)
        shell = FrameShell(incoming_id, timestamp, self.cur_pose.copy(),
                           np.zeros(2, np.float32), exposure=self._cur_exposure)
        self.all_frames.append(shell)
        if not res.ok:
            return shell

        # subsample to the desired density
        valid = res.valid.cpu().numpy()
        n_have = valid.sum()
        keep_frac = min(1.0, self.cfg.ba.desired_point_density / max(n_have, 1))
        rng = np.random.RandomState(0)
        keep = valid & (rng.rand(len(valid)) < keep_frac)

        slot = 0
        T_cw = np.linalg.inv(self.cur_pose).astype(np.float32)
        self.ba_state = ba.add_frame(self.ba_state, slot, self.num_kfs, T_cw,
                                     np.zeros(2, np.float32), shell.exposure, pyr0.data[0])
        self.slot_exposure[slot] = shell.exposure
        P = self.cfg.ba.max_points_per_frame
        cap = min(P, len(valid))
        k = min(cap, int(keep.sum()))
        src = np.zeros(P, np.int64)
        src[:k] = np.nonzero(keep)[0][:k]
        src_t = self._upload(src)
        self.ba_state = ba.add_points(
            self.ba_state, torch.arange(P, device=self.device), slot,
            res.u[src_t], res.v[src_t], res.idepth[src_t], res.color[src_t],
            res.weight[src_t], self._upload(np.arange(P) < k),
            prior=torch.full((P,), self.cfg.ba.idepth_fix_prior, dtype=torch.float32,
                             device=self.device))
        self.slot_stats[slot] = {"out": 0, "marg": 0}
        self.pyramids[slot] = pyr0
        shell.is_kf = True
        shell.tracking_ref_kf = self.num_kfs
        self.kf_shells.append(shell)
        self.num_kfs += 1
        self._make_new_traces(slot, pyr0)
        self._build_template(slot, pyr0)
        self.initialized = True
        return shell

    def _new_shell(self, incoming_id, timestamp) -> FrameShell:
        """A frame's shell at the current pose, appended to all_frames."""
        shell = FrameShell(incoming_id, timestamp, self.cur_pose.copy(),
                           np.zeros(2, np.float32), exposure=self._cur_exposure)
        self.all_frames.append(shell)
        return shell

    def _mono_restart(self, pyr0: Pyramid, incoming_id, timestamp) -> FrameShell:
        """(Re)start the bootstrap with this frame as its first."""
        self.mono_state = mono_init.create(
            pyr0, self.cfg, budget=self.cfg.ba.max_immature_per_frame, pot=self.pot)
        self._mono_first_pyr = pyr0
        self._mono_frames = 0
        self._mono_first_shell = self._new_shell(incoming_id, timestamp)
        return self._mono_first_shell

    def _initialize_mono(self, pyr0: Pyramid, incoming_id, timestamp) -> FrameShell:
        """The monocular bootstrap (reference FrontEnd.cpp:607-623, 842-934):
        track frames against the first until the initializer has snapped
        and confirmed (``mono_init.is_done``), then make the FIRST frame
        keyframe 0 with the converged point field (rescaled to mean idepth
        1) and track the current frame normally. The right camera is never
        read; metric scale comes later from the stereo scale optimizer, or
        never (DSO mode, ``scale_opt.accept_thres`` < 0)."""
        if self.mono_state is None:
            return self._mono_restart(pyr0, incoming_id, timestamp)

        self.mono_state = mono_init.track_frame(
            self.mono_state, tuple(pyr0.data), self.intr0, self.cfg)
        self._mono_frames += 1
        if not mono_init.is_done(self.mono_state):
            if self._mono_frames > self.cfg.runtime.mono_init_max_frames:
                # a stale bootstrap restarts from the current frame
                return self._mono_restart(pyr0, incoming_id, timestamp)
            return self._new_shell(incoming_id, timestamp)

        # ---- snapped: the first frame becomes keyframe 0 --------------------
        u, v, idepth, T_first_new, _ = mono_init.to_points(self.mono_state)
        # the first tracked frame starts from the bootstrap's pose
        self._post_init_T_hint = np.asarray(T_first_new, np.float64)
        if len(u) < 8:
            # degenerate convergence: restart from the next frame
            self.mono_state = None
            self._mono_first_pyr = None
            return self._new_shell(incoming_id, timestamp)
        first_pyr = self._mono_first_pyr
        slot = 0
        T_cw = np.linalg.inv(self.cur_pose).astype(np.float32)
        first_exp = self._mono_first_shell.exposure
        self.ba_state = ba.add_frame(self.ba_state, slot, self.num_kfs, T_cw,
                                     np.zeros(2, np.float32), first_exp, first_pyr.data[0])
        self.slot_exposure[slot] = first_exp
        # pattern colours and gradient weights at the converged points
        P = self.cfg.ba.max_points_per_frame
        keep_frac = min(1.0, self.cfg.ba.desired_point_density / max(len(u), 1))
        rng = np.random.RandomState(0)
        keep = rng.rand(len(u)) < keep_frac
        k = min(P, int(keep.sum()))
        src = np.zeros(P, np.int64)
        src[:k] = np.nonzero(keep)[0][:k]
        uu = self._upload(np.asarray(u[src], np.float32))
        vv = self._upload(np.asarray(v[src], np.float32))
        pu8, pv8 = ba._pattern_uv(uu, vv)
        hit = bilinear_gather(first_pyr.data[0], pu8, pv8)     # [P, 8, 3]
        c2 = self.cfg.ba.outlier_th_sum_component
        weight = torch.sqrt(c2 / (c2 + (hit[..., 1] ** 2 + hit[..., 2] ** 2)))
        self.ba_state = ba.add_points(
            self.ba_state, torch.arange(P, device=self.device), slot, uu, vv,
            self._upload(np.asarray(idepth[src], np.float32)), hit[..., 0], weight,
            self._upload(np.arange(P) < k),
            prior=torch.full((P,), self.cfg.ba.idepth_fix_prior, dtype=torch.float32,
                             device=self.device))
        self.slot_stats[slot] = {"out": 0, "marg": 0}
        self.pyramids[slot] = first_pyr
        first_shell = self._mono_first_shell
        first_shell.is_kf = True
        first_shell.tracking_ref_kf = self.num_kfs
        self.kf_shells.append(first_shell)
        self.num_kfs += 1
        self._make_new_traces(slot, first_pyr)
        self._build_template(slot, first_pyr)
        self.initialized = True
        self.mono_state = None
        self._mono_first_pyr = None
        # the current frame goes through the normal tracking path; the
        # keyframe decision fires on the bootstrap's parallax
        return self._track_frame(pyr0, incoming_id, timestamp)

    # ------------------------------------------------------------------
    # tracking (reference trackNewCoarse)
    # ------------------------------------------------------------------

    def _track_frame(self, pyr0: Pyramid, incoming_id, timestamp) -> FrameShell:
        ref_slot = self.template_kf_slot
        T_w_ref = self._kf_pose(ref_slot)
        if len(self.all_frames) >= 2 and self.all_frames[-1].tracking_ref_kf >= 0:
            slast = self.all_frames[-1]
            sprelast = self.all_frames[-2]
            slast_2_sprelast = np.linalg.inv(sprelast.T_wc) @ slast.T_wc
            lastF_2_slast = np.linalg.inv(slast.T_wc) @ T_w_ref
            aff_init = _host_aff(slast.aff)
            stage1, stage2 = make_motion_tries(np.eye(4), lastF_2_slast,
                                               slast_2_sprelast, self.cfg)
        else:
            # first tracked frame after initialization: no motion history
            # (the reference's 2-frame try list is empty, a known quirk).
            # After the mono bootstrap its converged first-to-current pose
            # is the primary candidate, identity the second.
            seed = self._post_init_T_hint
            if seed is not None:
                stage1 = np.stack([seed.astype(np.float32), np.eye(4, dtype=np.float32)])
                self._post_init_T_hint = None
            else:
                stage1 = np.stack([np.eye(4, dtype=np.float32)])
            _, stage2 = make_motion_tries(np.eye(4), np.eye(4), np.eye(4), self.cfg)
            aff_init = _host_aff((0.0, 0.0))

        with self.timers.span("track"):
            thr = self.cfg.tracker.re_track_threshold * self.last_coarse_rmse

            def run(batch, selector=select_winner):
                r = track_candidates_batch(
                    tuple(pyr0.data), self.template, self.intr0, self.cfg,
                    self._upload(np.asarray(batch, np.float32)), aff_init,
                    self.template_ref_aff, self.template_ref_exposure,
                    _host_f32(self._cur_exposure))
                r_np, self._track_imm_counts = self._read_track(r)
                self._track_imm_counts_key = self.immatures
                # the previous keyframe's tail: its copy landed before this
                # track ran, so the commit waits for nothing
                self.flush_pending()
                i, g = selector(r_np, self.last_coarse_rmse, self.cfg)
                return r_np, i, g

            if self.cfg.tracker.winner_policy == "serial":
                res, idx, good = run(np.concatenate([stage1, stage2], axis=0),
                                     selector=select_winner_serial)
            else:
                res, idx, good = run(stage1[:1])
                if not good or float(res.res_per_level[idx, 0]) > thr:
                    res5, idx5, good5 = run(stage1, selector=select_winner_serial)
                    if good5 and (not good or float(res5.res_per_level[idx5, 0])
                                  < float(res.res_per_level[idx, 0])):
                        res, idx, good = res5, idx5, good5
                if not good or float(res.res_per_level[idx, 0]) > thr:
                    res2, idx2, good2 = run(stage2, selector=select_winner_serial)
                    if good2 and (not good or float(res2.res_per_level[idx2, 0])
                                  < float(res.res_per_level[idx, 0])):
                        res, idx, good = res2, idx2, good2

        shell = FrameShell(incoming_id, timestamp, self.cur_pose.copy(),
                           np.zeros(2, np.float32), exposure=self._cur_exposure)
        self.all_frames.append(shell)
        r0 = float(res.res_per_level[idx, 0])
        flow = res.flow[idx]
        if not math.isfinite(r0) or not np.all(np.isfinite(flow)):
            self.is_lost = True
            return shell
        if not good:
            # "BIG ERROR": take the predicted pose (candidate 0)
            idx = 0
            flow = np.zeros(3, np.float32)
            r0 = float(res.res_per_level[0, 0])
        T_ref_new = res.T[idx]
        shell.T_wc = (T_w_ref @ np.linalg.inv(T_ref_new)).astype(np.float32)
        shell.aff = res.aff[idx].copy()
        shell.tracking_ref_kf = int(self._views_np()[4][ref_slot])
        shell._T_ref_new = T_ref_new
        shell._flow = flow
        shell._res0 = r0
        self.cur_pose = shell.T_wc
        if self.first_coarse_rmse < 0:
            self.first_coarse_rmse = r0
        self.last_coarse_rmse = r0
        return shell

    # ------------------------------------------------------------------
    # pipelined tracking (cfg.runtime.pipelined_tracking)
    # ------------------------------------------------------------------
    # Frame N's track is launched at once with the constant-motion
    # candidate computed on the device from the previous dispatch's
    # results, its outputs start their copy into a pinned host buffer, and
    # only then is frame N-1 consumed: its buffer read (the one wait of a
    # benign frame) and its host work run while frame N's track runs on
    # the card.
    #
    # Semantics against the synchronous path (every deviation one frame
    # deep, as in the reference):
    #  - frame N-1's keyframe decision and pipeline run with frame N in
    #    flight, so frame N tracks against the pre-keyframe template; its
    #    world pose is composed from the reference pose it was tracked
    #    against.
    #  - escalation (the staged try list) is detected one frame late and
    #    runs synchronously; a keyframe, escalation, BIG ERROR or loss
    #    flushes the pipeline: the in-flight successor is retracked
    #    synchronously and the device motion state reseeded from the host
    #    shells.
    #  - is_lost / init_failed surface one frame late (the node checks
    #    every frame); on loss the in-flight placeholder shell is popped.

    def _process_pipelined(self, pyr0: Pyramid, img1, incoming_id,
                           timestamp) -> FrameShell:
        if self._pl_state is None:
            # no device motion state yet (after init, a flush reset or an
            # escalation): one synchronous frame, then seed
            shell = self._track_frame(pyr0, incoming_id, timestamp)
            if not self.is_lost:
                self._finish_frame(shell, pyr0, img1)
                self._pl_seed()
            return shell

        with self.timers.span("track"):
            inf = self._pl_dispatch(pyr0)
        self.flush_pending()
        prev = self._pl_inflight
        shell = self._new_shell(incoming_id, timestamp)
        inf.update(shell=shell, pyr=pyr0, img1=img1, frame_idx=len(self.all_frames) - 1)
        self._pl_inflight = inf

        # ---- consume frame N-1 ----------------------------------------------
        if prev is not None:
            flushed = self._pl_consume(prev)
            if self.is_lost or self.init_failed:
                self._pl_reset()
                return shell
            if flushed:
                # the in-flight successor's template or candidate is stale:
                # retrack it synchronously against the current template
                inf = self._pl_inflight
                self._pl_inflight = None
                self._pl_consume(inf, retrack=True)
                if self.is_lost or self.init_failed:
                    self._pl_reset()
                    return shell
                self._pl_seed()
        return shell

    def _pl_dispatch(self, pyr0: Pyramid) -> dict:
        """Launch frame N's track (one candidate, K2-LM on the card) from
        the device motion state and start the copy of its outputs; nothing
        here waits for the device. Returns the in-flight record's track
        fields. The host reads of the window come first: after the launch
        a read would wait for it."""
        ref_slot = self.template_kf_slot
        inf = {"ref_slot": ref_slot, "ref_kf_id": int(self._views_np()[4][ref_slot]),
               "T_w_ref": self._kf_pose(ref_slot), "counts_key": self.immatures}
        Tl, Tp, aff = self._pl_state
        r = track_candidates_batch(
            tuple(pyr0.data), self.template, self.intr0, self.cfg,
            _const_motion_candidate(Tl, Tp)[None], aff, self.template_ref_aff,
            self.template_ref_exposure, _host_f32(self._cur_exposure))
        inf["out"] = self._pl_transfer(_pack_track(r, self.immatures.valid.sum(dim=1)))
        # optimistic device state: the primary candidate wins on almost
        # every frame; an escalation reseeds
        self._pl_state = (r.T[0], Tl, AffLight(r.aff.a[0], r.aff.b[0]))
        return inf

    def _pl_transfer(self, packed: torch.Tensor) -> HostCopy:
        """Start the copy of a dispatch's packed outputs to the host, on the
        card into the next of two pinned buffers (frame N's copy is queued
        while frame N-1's buffer may still be read)."""
        i = self._pl_next_buf
        self._pl_next_buf ^= 1
        copy = HostCopy([packed], buf=self._pl_bufs[i])
        self._pl_bufs[i] = copy.buf
        return copy

    def _pl_read(self, out: HostCopy):
        """Wait for a transfer and unpack it: (TrackResultNp, counts)."""
        return _unpack_track(out.wait()[0], self.levels, self.n_slots)

    def _pl_consume(self, inf, retrack: bool = False) -> bool:
        """Complete a pipelined frame: read its track result, accept or
        escalate, the shell bookkeeping, the keyframe decision and the
        keyframe / non-keyframe pipeline. Returns True when the pipeline
        must flush (keyframe, escalation, BIG ERROR or loss): the
        in-flight successor's context is stale. ``retrack=True`` discards
        the in-flight result and tracks the frame again against the
        current template."""
        shell = inf["shell"]
        with self.timers.span("track"):
            if retrack:
                self.pl_retracks += 1
                res, counts = self._pl_retrack(inf)
            else:
                res, counts = self._pl_read(inf["out"])
        # dispatch-time immature counts, keyed by the dispatch-time
        # immatures: if a trace ran since, _make_keyframe reads them anew
        self._track_imm_counts = counts
        self._track_imm_counts_key = inf["counts_key"]
        res_l, flow, T, affab = res.res_per_level[0], res.flow[0], res.T[0], res.aff[0]

        # thr from the current last_coarse_rmse (frame N-2's r0), as the
        # synchronous path has it
        thr = self.cfg.tracker.re_track_threshold * self.last_coarse_rmse
        r0 = float(res_l[0])
        good = bool(res.ok[0]) and math.isfinite(r0) and bool(np.all(np.isfinite(flow)))
        flushed = False
        if not good or r0 > thr:
            # trouble: the staged try list, synchronously, against the
            # current template
            flushed = True
            self.pl_escalations += 1
            esc, idx, good = self._pl_escalate(inf)
            T, affab, flow = esc.T[idx], esc.aff[idx], esc.flow[idx]
            r0 = float(esc.res_per_level[idx, 0])
            self._pl_rebase(inf)

        if not (math.isfinite(r0) and np.all(np.isfinite(flow))):
            self.is_lost = True
            return True
        if not good:
            # BIG ERROR: keep the motion-model result
            flow = np.zeros(3, np.float32)

        # compose against the reference KF's current estimate while it is
        # in the window (BA and scale refinements fold in), else against
        # the dispatch-time snapshot
        if (inf["ref_slot"] in self._active_slots()
                and int(self._views_np()[4][inf["ref_slot"]]) == inf["ref_kf_id"]):
            T_w_ref = self._kf_pose(inf["ref_slot"])
        else:
            T_w_ref = inf["T_w_ref"]
        shell.T_wc = (T_w_ref @ np.linalg.inv(T)).astype(np.float32)
        shell.aff = np.asarray(affab, np.float32).copy()
        shell.tracking_ref_kf = inf["ref_kf_id"]
        shell._T_ref_new = T
        shell._flow = np.asarray(flow, np.float32)
        shell._res0 = r0
        self.cur_pose = shell.T_wc
        if self.first_coarse_rmse < 0:
            self.first_coarse_rmse = r0
        self.last_coarse_rmse = r0

        is_kf = self._finish_frame(shell, inf["pyr"], inf["img1"])
        return flushed or is_kf or self.is_lost or self.init_failed

    def _pl_rebase(self, inf):
        """Point an in-flight record at the current template's keyframe
        (after a synchronous track against it)."""
        inf["ref_slot"] = self.template_kf_slot
        inf["ref_kf_id"] = int(self._views_np()[4][self.template_kf_slot])
        inf["T_w_ref"] = self._kf_pose(self.template_kf_slot)

    def _pl_motion(self, inf):
        """(lastF_2_slast, slast_2_sprelast, aff_init) of a flushed frame
        from the host shells before it, against the current template."""
        idx = inf["frame_idx"]
        fs = self.all_frames
        if idx < 2:
            return np.eye(4), np.eye(4), _host_aff((0.0, 0.0))
        slast, sprelast = fs[idx - 1], fs[idx - 2]
        T_w_ref = self._kf_pose(self.template_kf_slot)
        return (np.linalg.inv(slast.T_wc) @ T_w_ref,
                np.linalg.inv(sprelast.T_wc) @ slast.T_wc, _host_aff(slast.aff))

    def _pl_track(self, inf, batch: np.ndarray, aff_init: AffLight):
        """A synchronous track of a pipelined frame's candidates against
        the current template: (TrackResultNp, counts)."""
        r = track_candidates_batch(
            tuple(inf["pyr"].data), self.template, self.intr0, self.cfg,
            self._upload(np.asarray(batch, np.float32)), aff_init,
            self.template_ref_aff, self.template_ref_exposure,
            _host_f32(max(inf["shell"].exposure, 1e-6)))
        return self._read_track(r)

    def _pl_retrack(self, inf):
        """Fresh single-candidate track of a flushed frame against the
        current template (the constant-motion candidate from the host
        shells, the last frame's affine); the record's reference fields
        move to the current template."""
        lastF_2_slast, slast_2_sprelast, aff_init = self._pl_motion(inf)
        if inf["frame_idx"] >= 2:
            T_cand = make_motion_tries(np.eye(4), lastF_2_slast, slast_2_sprelast,
                                       self.cfg)[0][:1]
        else:
            T_cand = np.eye(4, dtype=np.float32)[None]
        out = self._pl_track(inf, T_cand, aff_init)
        inf["counts_key"] = self.immatures
        self._pl_rebase(inf)
        return out

    def _pl_escalate(self, inf):
        """The full ordered try list (stage1 + stage2, 83 candidates) for a
        pipelined frame whose primary candidate failed, walked with the
        reference's serial rule: (TrackResultNp, winner, good)."""
        lastF_2_slast, slast_2_sprelast, aff_init = self._pl_motion(inf)
        stage1, stage2 = make_motion_tries(np.eye(4), lastF_2_slast, slast_2_sprelast,
                                           self.cfg)
        res, _ = self._pl_track(inf, np.concatenate([stage1, stage2], axis=0), aff_init)
        idx, good = select_winner_serial(res, self.last_coarse_rmse, self.cfg)
        return res, idx, good

    def _pl_seed(self):
        """(Re)seed the device motion state from the host shells: needs two
        frames and a template."""
        fs = self.all_frames
        if len(fs) < 2 or self.template is None or self.template_kf_slot < 0:
            self._pl_state = None
            return
        T_w_ref = self._kf_pose(self.template_kf_slot)
        Tl = np.linalg.inv(fs[-1].T_wc) @ T_w_ref
        Tp = np.linalg.inv(fs[-2].T_wc) @ T_w_ref
        self._pl_state = (self._upload(Tl.astype(np.float32)),
                          self._upload(Tp.astype(np.float32)), _host_aff(fs[-1].aff))

    def _pl_reset(self):
        """Drop the in-flight frame on loss or init failure (its successor
        never reaches the reinitialized front end) and pop its placeholder
        shell, so the trajectory has no bogus row."""
        inf = self._pl_inflight
        if inf is not None and self.all_frames and self.all_frames[-1] is inf["shell"]:
            self.all_frames.pop()
        self._pl_inflight = None
        self._pl_state = None

    def flush_pipeline(self):
        """Consume any in-flight pipelined frame synchronously (before the
        newest pose is read or the run ends)."""
        inf = self._pl_inflight
        if inf is None:
            return
        self._pl_inflight = None
        self._pl_consume(inf)
        if not (self.is_lost or self.init_failed):
            self._pl_seed()
        else:
            self._pl_reset()

    # ------------------------------------------------------------------
    # keyframe decision
    # ------------------------------------------------------------------

    def _keyframe_decision(self, shell: FrameShell) -> bool:
        kc = self.cfg.keyframe
        if kc.keyframes_per_second > 0:
            return (shell.timestamp - self.kf_shells[-1].timestamp) > 0.95 / kc.keyframes_per_second
        w, h = self.intr0.w[0], self.intr0.h[0]
        ref_aff = self.template_ref_aff_np
        a_rel = math.exp(shell.aff[0] - ref_aff[0]) * (
            shell.exposure / max(self.template_ref_exposure_np, 1e-9))
        flow_t, _, flow_rt = shell._flow
        score = (
            kc.kf_global_weight * kc.max_shift_weight_t * math.sqrt(max(flow_t, 0.0)) / (w + h)
            + kc.kf_global_weight * kc.max_shift_weight_r * 0.0
            + kc.kf_global_weight * kc.max_shift_weight_rt * math.sqrt(max(flow_rt, 0.0)) / (w + h)
            + kc.kf_global_weight * kc.max_affine_weight * abs(math.log(max(a_rel, 1e-9)))
        )
        return score > 1.0 or 2.0 * self.first_coarse_rmse < shell._res0

    # ------------------------------------------------------------------
    # non-keyframe: trace immatures
    # ------------------------------------------------------------------

    def _make_non_keyframe(self, shell: FrameShell, pyr0: Pyramid):
        self.flush_pending()        # a no-op unless no tracker read ran
        self._frames_since_kf += 1
        tc = self.cfg.trace
        steady = tc.steady_after > 0 and self._frames_since_kf >= tc.steady_after
        with self.timers.span("trace"):
            self._trace_all(shell.T_wc, pyr0.data[0], shell.aff, shell.exposure,
                            steady=steady)

    def _trace_all(self, T_wc_new: np.ndarray, target_planes, new_aff,
                   new_exposure: float = 1.0, steady: bool = False):
        """traceOn over every window slot in one batched call."""
        if not self.imm_slots:
            return
        K = np.asarray(self.intr0.K(0), np.float32)
        Ki = np.linalg.inv(K)
        T_cw_new = np.linalg.inv(T_wc_new)
        aff_all = self._views_np()[1]
        S = self.n_slots
        KRKi = np.tile(np.eye(3, dtype=np.float32), (S, 1, 1))
        Kt = np.zeros((S, 3), np.float32)
        a_rel = np.ones(S, np.float32)
        b_rel = np.zeros(S, np.float32)
        for slot in self.imm_slots:
            T_nh = T_cw_new @ self._kf_pose(slot)
            KRKi[slot] = K @ T_nh[:3, :3] @ Ki
            Kt[slot] = K @ T_nh[:3, 3]
            a_rel[slot] = np.exp(np.clip(new_aff[0] - aff_all[slot, 0], -20.0, 20.0)) * (
                new_exposure / max(self.slot_exposure.get(slot, 1.0), 1e-9))
            b_rel[slot] = new_aff[1] - a_rel[slot] * aff_all[slot, 1]
        tc = self.cfg.trace
        tier = (dict(num_steps=tc.steady_num_steps, budget=tc.steady_budget,
                     max_reach=tc.steady_max_reach) if steady else {})
        # host values: K14 takes them in its launch's parameters
        self.immatures, _, n_overflow = immature.trace_points_all_compact(
            self.immatures, target_planes, KRKi, Kt, a_rel, b_rel, self.cfg, **tier)
        self._trace_overflow_acc = (n_overflow if self._trace_overflow_acc is None
                                    else self._trace_overflow_acc + n_overflow)

    # ------------------------------------------------------------------
    # keyframe pipeline
    # ------------------------------------------------------------------

    def _make_keyframe(self, shell: FrameShell, pyr0: Pyramid, img1):
        cfg = self.cfg
        self.flush_pending()        # a no-op unless no tracker read ran
        shell.is_kf = True
        self._frames_since_kf = 0
        self.kf_shells.append(shell)

        counts = (self._track_imm_counts if self._track_imm_counts_key is self.immatures
                  else self._imm_counts_np())
        imm_counts = {s: int(counts[s]) for s in self.imm_slots}
        pre_views = self._views_np()          # pre-insert snapshot

        with self.timers.span("trace"):
            self._trace_all(shell.T_wc, pyr0.data[0], shell.aff, shell.exposure)

        flagged = self._flag_frames_for_marginalization(shell, imm_counts)

        # ---- insert the new KF into the window ----------------------------
        slot = self._free_slot()
        T_cw = np.linalg.inv(shell.T_wc).astype(np.float32)
        prev_newest = self._newest_slot()
        n_active_before = int(np.asarray(pre_views[3]).sum())
        st = ba.add_frame(self.ba_state, slot, self.num_kfs, T_cw, shell.aff,
                          shell.exposure, pyr0.data[0])
        energy_th = st.energy_th.clone()
        energy_th[slot] = st.energy_th[prev_newest]
        self.ba_state = st._replace(energy_th=energy_th)
        self.slot_exposure[slot] = shell.exposure
        self.slot_stats[slot] = {"out": 0, "marg": 0}
        self.pyramids[slot] = pyr0
        self.scale_errors[slot] = -1.0
        self.num_kfs += 1

        # ---- activate candidate points ------------------------------------
        with self.timers.span("activate"):
            self._activate_points(slot, T_cw, pre_views, flagged)

        # ---- windowed BA ----------------------------------------------------
        n_active_frames = n_active_before + 1
        iters = cfg.ba.max_opt_iterations
        if n_active_frames < 3:
            iters = 20
        elif n_active_frames < 4:
            iters = 15
        scale_enabled = (cfg.scale_opt.accept_thres > 0
                         and len(self.kf_shells) > cfg.scale_opt.min_kfs_before_scale)
        st_pre_ba = self.ba_state

        def run_ba_chain(compact_budget):
            """BA -> template -> scale, redone full-shape on compact overflow."""
            with self.timers.span("dso_opt"):
                st, rmse, ok, hdd, ndrop = ba.optimize_keyframe(
                    st_pre_ba, cfg, iters, slot, compact_budget)
            with self.timers.span("template"):
                # K16 once for the template (T_rh toward the new keyframe) and
                # bundle 3's views
                pose = win.window_pose(st, slot)
                tmpl = build_template_from_state(st, cfg, slot, hdd, pyr0.data[0][..., 0],
                                                 self.levels, self.budgets, pose=pose)
            scale = ()
            if scale_enabled:
                with self.timers.span("scale_opt"):
                    pyr1 = build_pyramid(self._image(img1), self.levels)
                    out = dispatch_scale_optimization(
                        tuple(pyr1.data), tmpl, self.intr0, self.intr1,
                        self.t_cam1_cam0, cfg, self.scale_state)
                    scale = (out.scale, out.error)
            # bundle 3, the keyframe's one blocking read: rmse, ok, the
            # template's level-0 count, the compact view's overflow, the
            # post-BA views and the scale LM's results
            host = to_host((rmse, ok, tmpl.pmask[0].sum(), ndrop)
                           + ba.current_views(st, pose) + scale)
            return st, tmpl, host

        cb = cfg.ba.compact_budget
        cb = cb if 0 < cb < self.pool else None
        st, tmpl, host = run_ba_chain(cb)
        if cb is not None and int(host[3]) > 0:
            st, tmpl, host = run_ba_chain(None)
        rmse, ok, pmask_count = float(host[0]), bool(host[1]), int(host[2])
        self.ba_state = st
        self._set_views(st, host[4:11])

        # ---- init-failure / lost gates ------------------------------------------
        gates = self.cfg.runtime.init_rmse_gates
        nk = len(self.kf_shells)
        if (nk == 2 and rmse > gates[0]) or (nk == 3 and rmse > gates[1]) or \
                (nk == 4 and rmse > gates[2]):
            self.init_failed = True
            return
        if not ok:
            self.is_lost = True
            return

        self._refresh_kf_shells()
        shell.T_wc = self._kf_pose(slot)
        self.cur_pose = shell.T_wc

        # ---- adopt the template --------------------------------------------------
        self.template = tmpl
        if pmask_count < 8:
            self.is_lost = True
        self.template_kf_slot = slot
        aff = self._views_np()[1][slot]
        self.template_ref_aff = AffLight(self._f32(aff[0]), self._f32(aff[1]))
        self.template_ref_aff_np = np.asarray(aff[:2], np.float32)
        self.template_ref_exposure = self._f32(shell.exposure)
        self.template_ref_exposure_np = shell.exposure
        self.first_coarse_rmse = -1.0
        self.last_coarse_rmse = 1e9

        # ---- stereo scale decision ---------------------------------------------
        scale_error = -1.0
        if scale_enabled:
            accepted, new_scale, scale_error, self.scale_state = decide_scale_optimization(
                host[11], host[12], cfg, self.scale_state)
            if accepted:
                self._apply_scale(new_scale, slot)
        self.scale_errors[slot] = scale_error

        self._finalize_keyframe(flagged, slot, pyr0)

    # ------------------------------------------------------------------

    def flush_pending(self):
        """Commit a deferred keyframe tail (``_finalize_keyframe``); a no-op
        when nothing is pending. Runs right after the next frame's tracker
        read, by which time the tail's copy has landed, and before any host
        read of the tail's outputs (the node's hand-off of marginalized
        keyframes, the end of a run, checkpoints)."""
        pending = self._pending_finalize
        if pending is None:
            return
        self._pending_finalize = None
        copy, slots, lin, st, flagged, new_slot = pending
        host = copy.wait()
        bundle = (host[:7], host[7:17], int(host[17]), dict(zip(slots, host[18:])))
        self._finalize_keyframe_commit(bundle, lin, st, flagged, new_slot)

    def _finalize_keyframe(self, flagged: List[int], new_slot: int, pyr0: Pyramid):
        """Keyframe tail, dispatch half: one linearization of the
        post-BA/post-scale state feeds point flagging, dso_error and the
        marginalized-point exports; new immature traces for the new KF. The
        device work is queued, the immature updates (which the next frame's
        trace and counts read) are made at once, and the bundle starts its
        copy to the host without a wait; ``flush_pending`` commits it at
        the next frame's tracker read, as the reference does."""
        cfg = self.cfg
        st = self.ba_state
        lin = ba.linearize(st, cfg)
        n_good = torch.sum(lin.pair_good, dim=1)
        sel_map, sel_count = make_selection_map(
            pyr0.abs_grad[0], pyr0.abs_grad[1], pyr0.abs_grad[2], self.pot, cfg)
        colors_by_slot = {s: _gather_level_colors(tuple(self.pyramids[s].data), st.p_u, st.p_v)
                          for s in self.pyramids}
        with self.timers.span("feature_detect"):
            self.immatures = immature.set_slot(
                self.immatures, new_slot,
                immature.create_points(pyr0.data[0], sel_map, self.imm_budget,
                                       cfg.ba.outlier_th_sum_component))
            self.imm_slots.add(new_slot)
            if flagged:
                clear = np.zeros(self.n_slots, bool)
                clear[flagged] = True
                self.immatures = immature.clear_slots(
                    self.immatures, self._upload(clear))
                for mslot in flagged:
                    self.imm_slots.discard(mslot)
        # the views, the bundle's arrays, the selection count and the
        # colours in one device-to-host copy, started now
        slots = list(colors_by_slot)
        copy = HostCopy(ba.current_views(st)
                        + (st.p_u, st.p_v, st.p_idepth, n_good, lin.Hdd, lin.pair_good,
                           lin.pair_energy, st.p_color, st.p_num_good, st.p_last_res,
                           sel_count) + tuple(colors_by_slot[s] for s in slots))
        self._pending_finalize = (copy, slots, lin, st, flagged, new_slot)

    def _finalize_keyframe_commit(self, bundle, lin, st, flagged: List[int],
                                  new_slot: int):
        """Host bookkeeping half of the keyframe tail."""
        cfg = self.cfg
        assert st is self.ba_state, "BA state replaced while the keyframe tail was pending"
        views = bundle[0]
        (pu_a, pv_a, pid_a, n_good, Hdd, pair_good, pair_e, p_color,
         p_num_good, p_last_res) = bundle[1]
        got = bundle[2]
        colors_by_slot = bundle[3]
        p_valid, p_host = views[5], views[6]
        fx0, fy0, cx0, cy0 = views[2]

        with self.timers.span("point_marg"):
            host_flagged = np.isin(p_host, flagged)
            bad, leaving, marg, drop, rules = _flag_points_for_removal(
                p_valid, pid_a, n_good, Hdd, pair_good, p_num_good, p_last_res,
                host_flagged, flagged, cfg)
            removed = marg | drop
            for k, v in rules.items():
                self.removal_stats[k] = self.removal_stats.get(k, 0) + v
            for s in set(p_host[marg]):
                self.slot_stats.setdefault(int(s), {"out": 0, "marg": 0})[
                    "marg"] += int((marg & (p_host == s)).sum())
            for s in set(p_host[drop & p_valid]):
                self.slot_stats.setdefault(int(s), {"out": 0, "marg": 0})[
                    "out"] += int((drop & (p_host == s)).sum())
            exp_mask = leaving if cfg.loop.densify_scans else marg
            stay = exp_mask & ~host_flagged
            if stay.any():
                for s in set(p_host[stay]):
                    m = stay & (p_host == s)
                    pid = np.maximum(pid_a[m], 1e-6)
                    pts_cam = np.stack([(pu_a[m] - cx0) / fx0 / pid,
                                        (pv_a[m] - cy0) / fy0 / pid, 1.0 / pid], -1)
                    col = (colors_by_slot[s][m] if s in colors_by_slot
                           else p_color[m][:, 4:5])
                    self.removal_stats["stay_export"] = (
                        self.removal_stats.get("stay_export", 0) + int(m.sum()))
                    self._marg_export_acc.setdefault(int(s), []).append((pts_cam, col))
            last_marg_mask = exp_mask & host_flagged
            # the device program: the flagged points folded into the prior,
            # the dropped ones invalidated, the flagged frames marginalized
            # in order (K18, one launch on the card). What follows reads the
            # host bundle only, never the state it writes.
            if marg.any() or drop.any() or flagged:
                self.ba_state = ba.marginalize(self.ba_state, lin, marg, drop, flagged, cfg)

        self.pot = adapt_potential(self.pot, got, cfg.ba.desired_immature_density)

        with self.timers.span("frame_marg"):
            for mslot in flagged:
                restart = math.isnan(self.last_dso_error)
                tgt = pair_good[:, mslot] & ~removed
                cnt = int(tgt.sum())
                if cnt > 0:
                    dso_error = float(pair_e[tgt, mslot].sum()) / cnt / cnt
                elif restart:
                    dso_error = 10e5
                else:
                    dso_error = 10.0 * self.last_dso_error
                self.last_dso_error = dso_error
                if restart:
                    dso_error = float("nan")

                sel = last_marg_mask & (p_host == mslot)
                pid = np.maximum(pid_a[sel], 1e-6)
                pts_cam = np.stack([(pu_a[sel] - cx0) / fx0 / pid,
                                    (pv_a[sel] - cy0) / fy0 / pid, 1.0 / pid], -1)
                if mslot in colors_by_slot and sel.any():
                    colors = colors_by_slot[mslot][sel]
                else:
                    colors = p_color[sel][:, 4:5]
                acc = self._marg_export_acc.pop(mslot, None)
                if acc:
                    acc_pts = np.concatenate([a[0] for a in acc], 0)
                    acc_col = np.concatenate([a[1] for a in acc], 0)
                    L = colors.shape[1] if colors.size else acc_col.shape[1]
                    if acc_col.shape[1] < L:
                        acc_col = np.concatenate(
                            [acc_col] + [acc_col[:, -1:]] * (L - acc_col.shape[1]), 1)
                    elif colors.size and colors.shape[1] < acc_col.shape[1]:
                        colors = np.concatenate(
                            [colors] + [colors[:, -1:]] * (acc_col.shape[1] - colors.shape[1]), 1)
                    pts_cam = np.concatenate([pts_cam, acc_pts], 0)
                    colors = np.concatenate([colors, acc_col], 0) if colors.size else acc_col

                fid = int(views[4][mslot])
                k = fid - self.prev_kf_count
                shell = self.kf_shells[k] if 0 <= k < len(self.kf_shells) else None
                self.marginalized_queue.append(MarginalizedKF(
                    kf_id=fid,
                    incoming_id=shell.incoming_id if shell else -1,
                    timestamp=shell.timestamp if shell else 0.0,
                    T_wc=np.linalg.inv(views[0][mslot]),
                    dso_error=dso_error,
                    scale_error=self.scale_errors.get(mslot, -1.0),
                    pts_cam=pts_cam, pts_colors=colors,
                    pyr=tuple(self.pyramids[mslot].data) if mslot in self.pyramids else None,
                    exposure=self.slot_exposure.get(mslot, 1.0),
                ))
                self.pyramids.pop(mslot, None)
                self.slot_stats.pop(mslot, None)
                self.scale_errors.pop(mslot, None)
                self.slot_exposure.pop(mslot, None)

        # the host views of the new state, patched instead of read: the
        # tail changes validity only
        self._set_views(self.ba_state, views, frames_out=flagged, points_out=removed)

    # ------------------------------------------------------------------

    def _flag_frames_for_marginalization(self, shell, imm_counts) -> List[int]:
        """FrontEndMarginalize.cpp:62-146, on the host views."""
        cfg = self.cfg.ba
        slots = self._active_slots()
        if len(slots) < 2:
            return []
        newest = slots[-1]
        views = self._views_np()
        aff_all = views[1]
        p_valid, p_host = views[5], views[6]
        flagged: List[int] = []
        for s in slots:
            n_in = int((p_valid & (p_host == s)).sum())
            n_in += int(imm_counts.get(s, 0))
            n_out = self.slot_stats.get(s, {}).get("out", 0) + \
                self.slot_stats.get(s, {}).get("marg", 0)
            a_rel = math.exp(aff_all[newest, 0] - aff_all[s, 0]) * (
                self.slot_exposure.get(newest, 1.0) / max(self.slot_exposure.get(s, 1.0), 1e-9))
            if (n_in < cfg.min_points_remaining * (n_in + n_out)
                    or abs(math.log(max(a_rel, 1e-9))) > cfg.max_log_aff_fac_in_window) \
                    and len(slots) - len(flagged) > cfg.min_frames:
                flagged.append(s)
        if len(slots) - len(flagged) >= cfg.max_frames:
            fid = views[4]
            latest_id = fid[newest]
            poses = {s: self._kf_pose(s) for s in slots}
            best_score, best_slot = 1.0, None
            for s in slots:
                if fid[s] > latest_id - cfg.min_frame_age or fid[s] == 0 or s in flagged:
                    continue
                dist_score = 0.0
                for t in slots:
                    if t == s or fid[t] > latest_id - cfg.min_frame_age + 1:
                        continue
                    d = np.linalg.norm(poses[s][:3, 3] - poses[t][:3, 3])
                    dist_score += 1.0 / (1e-5 + d)
                d_latest = np.linalg.norm(poses[s][:3, 3] - poses[newest][:3, 3])
                dist_score *= -math.sqrt(max(d_latest, 1e-12))
                if dist_score < best_score:
                    best_score, best_slot = dist_score, s
            if best_slot is not None:
                flagged.append(best_slot)
        return flagged

    # ------------------------------------------------------------------

    def _activate_points(self, new_slot: int, T_cw_new: np.ndarray, pre_views,
                         flagged_slots=()):
        """Density-adaptive distance-map gating (K1 on the card), the gate,
        compaction and batched 1-D idepth optimization (K12) and the pool-row
        allocation with the insertion (K13): no host read."""
        cfg = self.cfg
        want = cfg.ba.desired_point_density
        have = int(np.asarray(pre_views[5]).sum())
        d = self.current_min_act_dist
        if have < want * 0.66:
            d -= 0.8
        if have < want * 0.8:
            d -= 0.5
        elif have < want * 0.9:
            d -= 0.2
        elif have < want:
            d -= 0.1
        if have > want * 1.5:
            d += 0.8
        if have > want * 1.3:
            d += 0.5
        if have > want * 1.15:
            d += 0.2
        if have > want:
            d += 0.1
        self.current_min_act_dist = float(np.clip(d, 0.0, 4.0))

        # host 4x4 math from the pre-insert snapshot (the old slots' poses
        # have not moved since) and the new KF's host-known pose
        K = np.asarray(self.intr0.K(1), np.float32)   # level-1 intrinsics
        h2, w2 = self.intr0.h[1], self.intr0.w[1]
        slots_todo = [s for s in self.imm_slots if s != new_slot]
        S = self.n_slots
        KRKi1, Kt1 = _activation_warps(K, T_cw_new, pre_views[0], slots_todo, S)
        host_flagged = np.zeros(S, bool)
        host_flagged[list(flagged_slots)] = True
        participate = np.zeros(S, bool)
        participate[slots_todo] = True

        # on the card: K16 (the window's poses, their inverses and each
        # host's transform into the new keyframe), K1, then K12 (gate,
        # compaction, idepth LM) and K13 (pool rows, insertion,
        # consumption), with no host read
        if not slots_todo:
            return
        st = self.ba_state
        pose = win.window_pose(st, new_slot)
        dist_map = _halfres_distance_map(st, self._upload(K), h2, w2, pose.T_rh, pose.calib)
        ok_d, idepth_d, lane_d, drop_d = activate.gate_compact_activate(
            self.immatures, dist_map, KRKi1, Kt1, self.current_min_act_dist, host_flagged,
            st.images, st.frame_valid, pose.T_all, pose.T_inv, pose.aff, pose.calib,
            st.exposure, cfg, w2, h2, cfg.ba.act_budget)
        self.ba_state, self.immatures, _ = activate.allocate_insert_consume(
            st, self.immatures, ok_d, idepth_d, lane_d, drop_d, participate,
            cfg.ba.max_points_per_frame)

    # ------------------------------------------------------------------

    def _refresh_kf_shells(self):
        """Push optimized window poses back into the shells."""
        fid = self._views_np()[4]
        for s in self._active_slots():
            k = int(fid[s]) - self.prev_kf_count
            if 0 <= k < len(self.kf_shells):
                self.kf_shells[k].T_wc = self._kf_pose(s)

    def _build_template(self, ref_slot: int, pyr_ref: Pyramid):
        """Tracker template for the initialization path."""
        self.template = build_template_from_state(self.ba_state, self.cfg, ref_slot, None,
                                                  pyr_ref.data[0][..., 0], self.levels,
                                                  self.budgets)
        if int(self.template.pmask[0].sum()) < 8:
            self.is_lost = True
        self.template_kf_slot = ref_slot
        aff = self._views_np()[1][ref_slot]
        self.template_ref_aff = AffLight(self._f32(aff[0]), self._f32(aff[1]))
        self.template_ref_aff_np = np.asarray(aff[:2], np.float32)
        ref_exp = self.slot_exposure.get(ref_slot, 1.0)
        self.template_ref_exposure = self._f32(ref_exp)
        self.template_ref_exposure_np = ref_exp
        self.first_coarse_rmse = -1.0
        self.last_coarse_rmse = 1e9

    def _apply_scale(self, new_scale: float, newest_slot: int):
        """Rescale template, window idepths, and the newest KF's translation
        to its tracking reference."""
        s = float(new_scale)
        self.template = scale_template_idepth(self.template, self._f32(s))
        views = self._views_np()     # bundle 3's: the poses before the rescale
        st = self.ba_state
        new_idepth = torch.where(st.p_valid, st.p_idepth / s, st.p_idepth)
        st = st._replace(p_idepth=new_idepth, p_idepth_zero=new_idepth)
        shell = self.kf_shells[-1]
        ref_kf = shell.tracking_ref_kf - self.prev_kf_count
        pose = None
        if 0 <= ref_kf < len(self.kf_shells) - 1:
            T_w_ref = self.kf_shells[ref_kf].T_wc
            T_ref_new = np.linalg.inv(T_w_ref) @ shell.T_wc
            T_ref_new[:3, 3] *= s
            shell.T_wc = (T_w_ref @ T_ref_new).astype(np.float32)
            T_cw = np.linalg.inv(shell.T_wc).astype(np.float32)
            T_zero = st.T_zero.clone()
            T_zero[newest_slot] = self._upload(T_cw)
            delta = st.delta.clone()
            delta[newest_slot, :6] = 0.0
            st = st._replace(T_zero=T_zero, delta=delta)
            self.cur_pose = shell.T_wc
            # its delta is zero, so its current pose is T_cw itself
            pose = (newest_slot, T_cw)
        self.ba_state = st
        # the rescale moves only the newest slot's pose among the views
        self._set_views(st, views, pose=pose)

    def _make_new_traces(self, slot: int, pyr0: Pyramid):
        """makeNewTraces with density feedback (initialization path)."""
        cfg = self.cfg
        sel, count = make_selection_map(pyr0.abs_grad[0], pyr0.abs_grad[1],
                                        pyr0.abs_grad[2], self.pot, cfg)
        self.pot = adapt_potential(self.pot, int(count), cfg.ba.desired_immature_density)
        self.immatures = immature.set_slot(
            self.immatures, slot,
            immature.create_points(pyr0.data[0], sel, self.imm_budget,
                                   cfg.ba.outlier_th_sum_component))
        self.imm_slots.add(slot)
