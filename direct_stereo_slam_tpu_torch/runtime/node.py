"""SLAM node driver (port of runtime/node.py).

Owns the undistorters, the front end on ``device`` and the loop handler;
feeds synced stereo pairs (through the undistorters, when given); hands
each marginalized keyframe to the loop handler; detects new sequences by
timestamp gap; reinitializes the front end on loss or init-failure while
preserving the current pose, the keyframe-count offset and the loop
handler (a pipelined in-flight frame is dropped); prints the per-stage
timing table. With ``cfg.runtime.live_view_path`` it keeps the live
viewer (``viz/live.py``, also handed to the loop handler), with
``cfg.runtime.debug_dump_dir`` it writes the debug images
(``viz/debug.py``), and with ``cfg.runtime.step_by_step`` it waits for
Enter after every frame. The viewer and the dumps read the newest
completed frame (``frontend.last_completed_shell``), once per frame: in
pipelined mode that is the previous call's frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import SLAMConfig
from ..geometry.camera import PyramidIntrinsics
from ..models.frontend import FrontEnd
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.timing import StageTimers
from ..viz import debug
from ..viz.live import LiveViewer

# the reference's stage names, in its table's order (main.cpp:181-201)
STAGE_NAMES = (
    "feature_detect", "scale_opt", "dso_opt", "track", "trace",
    "activate", "template", "point_marg", "frame_marg",
    "pts_generation", "sc_generation", "search_ringkey", "search_sc",
    "direct_est", "icp", "pose_graph_opt", "per_frame",
)


class SLAMNode:
    def __init__(self, cfg: SLAMConfig, intr0: PyramidIntrinsics,
                 intr1: PyramidIntrinsics, t_cam1_cam0: np.ndarray,
                 loop_handler=None, undistorter0=None, undistorter1=None,
                 device=DEFAULT_DEVICE, sync_timers: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        for und in (undistorter0, undistorter1):
            if und is not None and und.device != self.device:
                raise ValueError(f"an undistorter made for {und.device} given to a node "
                                 f"on {self.device}: make it with device={self.device}")
        self.undistorter0 = undistorter0
        self.undistorter1 = undistorter1
        self.intr0 = intr0
        self.intr1 = intr1
        self.t_cam1_cam0 = np.asarray(t_cam1_cam0, np.float32)
        self.loop_handler = loop_handler
        self.timers = StageTimers(sync=sync_timers)
        self.frontend = FrontEnd(cfg, intr0, intr1, self.t_cam1_cam0,
                                 timers=self.timers, device=self.device)
        self.incoming_id = 0
        self.current_timestamp = -1.0
        self._last_published_shell = None
        # the live viewer (the reference's PangolinLoopViewer panes)
        self.viewer = None
        if cfg.runtime.live_view_path:
            self.viewer = LiveViewer(cfg.runtime.live_view_path)
            if loop_handler is not None:
                loop_handler.viewer = self.viewer

    def process(self, img0, img1, timestamp: float, exposure: float = 1.0):
        """One synced stereo pair; ``exposure`` is the left frame's
        exposure time when the dataset provides one."""
        if (self.current_timestamp > 0 and abs(timestamp - self.current_timestamp)
                > self.cfg.runtime.sequence_gap_seconds):
            self.frontend.is_lost = True
        self.current_timestamp = timestamp

        if self.frontend.init_failed or self.frontend.is_lost:
            # tracking was lost: any pipelined in-flight frame is dropped
            self.frontend._pl_reset()
            self.frontend.flush_pending()
            last_pose = self.frontend.cur_pose
            prev_kf = self.frontend.num_kfs
            queue = self.frontend.marginalized_queue
            self.frontend = FrontEnd(self.cfg, self.intr0, self.intr1, self.t_cam1_cam0,
                                     prev_kf_count=prev_kf, timers=self.timers,
                                     device=self.device)
            self.frontend.cur_pose = last_pose
            self.frontend.marginalized_queue = queue
            # sequence-restart marker: the first marginalized KF of the new
            # sequence carries dso_error = NaN (no odometry edge)
            self.frontend.last_dso_error = float("nan")

        if self.undistorter0 is not None:
            img0 = self.undistorter0(img0)
        if self.undistorter1 is not None:
            img1 = self.undistorter1(img1)

        with self.timers.span("per_frame"):
            shell = self.frontend.add_stereo_frame(img0, img1, self.incoming_id,
                                                   timestamp, exposure=exposure)
        self.incoming_id += 1
        self._observe(shell, img0)
        if self.cfg.runtime.step_by_step:
            # goStepByStep (FrontEnd.cpp:689-700): block until Enter
            input(f"[step] frame {self.incoming_id - 1} "
                  f"kf={shell.is_kf} — Enter to continue ")
        self._publish_marginalized()
        return shell

    def _observe(self, shell, img0):
        """The viewer's pose and KF depth pane and the debug dumps, from
        the newest fully processed frame, once per frame (in pipelined
        mode ``shell`` is in flight: its pose and is_kf are final one call
        later)."""
        done = self.frontend.last_completed_shell
        if done is None or done is self._last_published_shell:
            return
        self._last_published_shell = done
        fe = self.frontend
        if self.viewer is not None:
            self.viewer.publish_cam_pose(done.T_wc)
            if done.is_kf and fe.template is not None:
                self.viewer.publish_depth_image(debug.render_template_idepth(
                    fe.template, fe.pyramids.get(fe.template_kf_slot)))
        out = self.cfg.runtime.debug_dump_dir
        if not out or fe.template is None:
            return
        if done.is_kf:
            kf_id = fe.num_kfs - 1
            debug.dump_template_idepth(out, kf_id, fe.template,
                                       fe.pyramids.get(fe.template_kf_slot))
            debug.dump_window_stitch(out, kf_id, fe)
        elif done is shell and getattr(done, "_T_ref_new", None) is not None:
            # the residual of the accepted pose against the unchanged
            # template (TrackerAndScaler.cpp:730-734); it needs the frame's
            # own image, so only when the completed frame is this call's
            ra = fe.template_ref_aff_np
            a_rel = math.exp(done.aff[0] - ra[0]) * (
                done.exposure / max(fe.template_ref_exposure_np, 1e-9))
            b_rel = done.aff[1] - a_rel * ra[1]
            debug.dump_tracking_residual(out, self.incoming_id - 1, img0, fe.template,
                                         self.intr0, np.asarray(done._T_ref_new),
                                         a_rel, b_rel)

    def _publish_marginalized(self):
        """Hand marginalized KFs to the loop handler; without one, still
        drain (each record pins its KF's full pyramid)."""
        while self.frontend.marginalized_queue:
            mkf = self.frontend.marginalized_queue.pop(0)
            if self.loop_handler is not None:
                self.loop_handler.publish_keyframe(mkf)

    def finish(self):
        """Flush (a pipelined in-flight frame is consumed first); returns
        the odometry trajectory rows (incoming_id x y z), the reference's
        sodso.txt content, once the loop handler has processed every
        keyframe. The viewer's page is rewritten last, so that it shows
        the run's end (the reference leaves it as its last rate-limited
        write had it)."""
        self.frontend.flush_pipeline()
        self.frontend.flush_pending()
        self._publish_marginalized()
        rows = []
        if self.loop_handler is not None:
            self.loop_handler.join()     # drain the threaded handler's queue
            rows = self.loop_handler.odometry_rows()
        if self.viewer is not None:
            self.viewer.flush()          # the page's last frames and loops
        return rows

    def timing_report(self) -> str:
        rep = self.timers.report([n for n in STAGE_NAMES if n in self.timers.times])
        acc = self.frontend._trace_overflow_acc
        if acc is not None:
            rep += f"\ntrace_overflow {int(acc)}"
        return rep


def write_trajectory(path: str, rows):
    """Write `incoming_id x y z` rows (sodso.txt/dslam.txt format)."""
    with open(path, "w") as f:
        for r in rows:
            f.write(f"{r[0]} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f}\n")
