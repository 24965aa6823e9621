"""SLAM node driver (port of runtime/node.py).

Owns the front end on ``device`` and the loop handler; feeds synced
stereo pairs; hands each marginalized keyframe to the loop handler;
detects new sequences by timestamp gap; reinitializes the front end on
loss or init-failure while preserving the current pose, the
keyframe-count offset and the loop handler; prints the per-stage timing
table. The undistorters, the live viewer and the debug dumps are not
ported yet: asking for any of them raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SLAMConfig
from ..geometry.camera import PyramidIntrinsics
from ..models.frontend import FrontEnd
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.timing import StageTimers

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
        if undistorter0 is not None or undistorter1 is not None:
            raise NotImplementedError("undistortion is not ported yet")
        rt = cfg.runtime
        if rt.live_view_path or rt.debug_dump_dir or rt.step_by_step:
            raise NotImplementedError("viewer / debug dumps / step mode are not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.intr0 = intr0
        self.intr1 = intr1
        self.t_cam1_cam0 = np.asarray(t_cam1_cam0, np.float32)
        self.loop_handler = loop_handler
        self.timers = StageTimers(sync=sync_timers)
        self.frontend = FrontEnd(cfg, intr0, intr1, self.t_cam1_cam0,
                                 timers=self.timers, device=self.device)
        self.incoming_id = 0
        self.current_timestamp = -1.0

    def process(self, img0, img1, timestamp: float, exposure: float = 1.0):
        """One synced stereo pair; ``exposure`` is the left frame's
        exposure time when the dataset provides one."""
        if (self.current_timestamp > 0 and abs(timestamp - self.current_timestamp)
                > self.cfg.runtime.sequence_gap_seconds):
            self.frontend.is_lost = True
        self.current_timestamp = timestamp

        if self.frontend.init_failed or self.frontend.is_lost:
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

        with self.timers.span("per_frame"):
            shell = self.frontend.add_stereo_frame(img0, img1, self.incoming_id,
                                                   timestamp, exposure=exposure)
        self.incoming_id += 1
        self._publish_marginalized()
        return shell

    def _publish_marginalized(self):
        """Hand marginalized KFs to the loop handler; without one, still
        drain (each record pins its KF's full pyramid)."""
        while self.frontend.marginalized_queue:
            mkf = self.frontend.marginalized_queue.pop(0)
            if self.loop_handler is not None:
                self.loop_handler.publish_keyframe(mkf)

    def finish(self):
        """Flush; returns the odometry trajectory rows (incoming_id x y z),
        the reference's sodso.txt content, once the loop handler has
        processed every keyframe."""
        self.frontend.flush_pending()
        self._publish_marginalized()
        if self.loop_handler is None:
            return []
        self.loop_handler.join()     # drain the threaded handler's queue
        return self.loop_handler.odometry_rows()

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
