"""The front end's epipolar trace on the card: kernel K14
(``csrc/trace.cu``; port of the JAX package's models/immature.py
``trace_points_all_compact``).

One cooperative launch over the window's stacked [S, NI] candidates: the segment's
geometry and the OOB / SKIPPED / BADCONDITION gates on every lane, the
row-major compaction of the searching lanes into ``budget`` lanes (with
the steady tier's ``max_reach`` deferral), on those lanes the
``num_steps``-point search, the second best, the quality, the 3-step GN
refine and the interval update, and the scatter back into new tensors.
The host-known inputs (``KRKi`` [S, 3, 3], ``Kt`` [S, 3], ``aff_a``,
``aff_b`` [S]) go in the launch's parameters, so nothing is uploaded and
nothing is read from the card. Its plain version is
``models/immature.py::trace_points_all_compact_plain``; the kernel
computes each of its elementwise operations as that version does on the
card, so the two give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..config import SLAMConfig
from . import _cuda

_P = ctypes.c_void_p
MAX_SLOTS = 32          # csrc/trace.cu's kMaxSlots
MAX_STEPS = 128         # kMaxSteps
TRACE_STAMPS = 4        # kTraceStamps


class TraceParams(ctypes.Structure):
    """csrc/trace.cu's ``TraceParams``, field for field."""

    _fields_ = [(n, ctypes.c_int) for n in ("S", "NI", "H", "W", "budget", "num_steps",
                                            "gn_iters", "has_reach")] + \
        [(n, ctypes.c_float) for n in ("max_pix", "slack", "min_improve", "outlier_e",
                                       "max_reach", "step_size", "inv_steps", "umax",
                                       "vmax")] + \
        [(n, _P) for n in ("valid", "u", "v", "idepth_min", "idepth_max", "color", "grad_h",
                           "quality", "status", "pixel_interval", "planes", "o_idepth_min",
                           "o_idepth_max", "o_quality", "o_status", "o_pixel_interval",
                           "counts", "lanes", "stamps", "flags")] + \
        [("slot", ctypes.c_float * (MAX_SLOTS * 14))]


def _host(x, name: str) -> np.ndarray:
    if torch.is_tensor(x):
        if x.is_cuda:
            raise ValueError(f"trace_points_all_compact: {name} must be a host value (reading "
                             f"it from the card would wait for the stream)")
        x = x.numpy()
    return np.asarray(x, np.float32)


def trace_points_all_compact_cuda(pts, target_planes: torch.Tensor, KRKi, Kt, aff_a, aff_b,
                                  cfg: SLAMConfig, num_steps: Optional[int] = None,
                                  budget: Optional[int] = None,
                                  max_reach: Optional[float] = None, lanes=None, stamps=None):
    """Launch K14 (``dsslam_trace``, a cooperative grid): returns
    (points, n_search, n_overflow) as the plain version does, the counts
    as int64 device scalars. ``lanes``, an int64 [budget] tensor, gets the
    compacted lanes (flat S x NI indices in row-major order, S * NI past
    the searching lanes); ``stamps``, an int64 [grid, TRACE_STAMPS]
    tensor (``_cuda.sm_count``' blocks), gets each block's phase cycles
    (kTraceStamps)."""
    S, NI = pts.u.shape
    H, W = target_planes.shape[:2]
    dev = target_planes.device
    tc = cfg.trace
    num_steps = tc.num_steps if num_steps is None else int(num_steps)
    budget = min(tc.search_budget if budget is None else int(budget), S * NI)
    if S > MAX_SLOTS:
        raise ValueError(f"trace_points_all_compact: at most {MAX_SLOTS} slots, got {S}")
    if not 2 <= num_steps <= MAX_STEPS:
        raise ValueError(f"trace_points_all_compact: num_steps in [2, {MAX_STEPS}], "
                         f"got {num_steps}")
    if tuple(target_planes.shape) != (H, W, 3):
        raise ValueError("trace_points_all_compact: target_planes must be [H, W, 3]")
    ins = {"valid": pts.valid, "u": pts.u, "v": pts.v, "idepth_min": pts.idepth_min,
           "idepth_max": pts.idepth_max, "color": pts.color, "grad_h": pts.grad_h,
           "quality": pts.quality, "status": pts.status, "pixel_interval": pts.pixel_interval,
           "planes": target_planes}
    ins = {k: t.contiguous() for k, t in ins.items()}
    grid = _cuda.sm_count(dev)
    for key, t, shape in (("lanes", lanes, (budget,)), ("stamps", stamps, (grid, TRACE_STAMPS))):
        if t is not None:
            if tuple(t.shape) != shape or not t.is_contiguous() or t.dtype != torch.int64:
                raise ValueError(f"trace_points_all_compact: {key} must be a contiguous int64 "
                                 f"{shape}")
            ins[key] = t
    dtypes = {"valid": torch.bool, "status": torch.int32, "lanes": torch.int64,
              "stamps": torch.int64}
    for key, t in ins.items():
        if t.dtype != dtypes.get(key, torch.float32):
            raise TypeError(f"trace_points_all_compact: {key} must be "
                            f"{dtypes.get(key, torch.float32)}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"trace_points_all_compact: {key} must be on {dev}, got {t.device}")
    if ins["color"].shape != (S, NI, 8) or ins["grad_h"].shape != (S, NI, 3):
        raise ValueError("trace_points_all_compact: color [S, NI, 8], grad_h [S, NI, 3]")
    slot = (ctypes.c_float * (MAX_SLOTS * 14))()
    slot[:S * 14] = np.concatenate([_host(KRKi, "KRKi").reshape(S, 9),
                                    _host(Kt, "Kt").reshape(S, 3),
                                    _host(aff_a, "aff_a").reshape(S, 1),
                                    _host(aff_b, "aff_b").reshape(S, 1)], 1).reshape(-1).tolist()
    out = {k: torch.empty(S, NI, dtype=torch.float32, device=dev)
           for k in ("o_idepth_min", "o_idepth_max", "o_quality", "o_pixel_interval")}
    out["o_status"] = torch.empty(S, NI, dtype=torch.int32, device=dev)
    counts = torch.empty(2, dtype=torch.int64, device=dev)
    flags = torch.empty(S * NI, dtype=torch.uint8, device=dev)
    f32 = lambda x: float(np.float32(x))
    ptr = {k: (t.view(torch.uint8) if t.dtype == torch.bool else t).data_ptr()
           for k, t in ins.items()}
    p = TraceParams(
        S=S, NI=NI, H=H, W=W, budget=budget, num_steps=num_steps,
        gn_iters=int(tc.trace_gn_iterations), has_reach=int(max_reach is not None),
        max_pix=f32(tc.max_pix_search_frac * (H + W)), slack=f32(tc.trace_slack_interval),
        min_improve=f32(tc.trace_min_improvement_factor),
        outlier_e=f32(8.0 * 12.0 * 12.0 * tc.trace_extra_slack_on_th),
        max_reach=f32(0.0 if max_reach is None else max_reach),
        step_size=f32(tc.trace_step_size),
        inv_steps=float(np.float32(1.0) / np.float32(num_steps - 1)),
        umax=f32(W - 1.001), vmax=f32(H - 1.001), slot=slot, counts=counts.data_ptr(),
        flags=flags.data_ptr(),
        **ptr, **{k: t.data_ptr() for k, t in out.items()})
    _cuda.call("dsslam_trace", ctypes.addressof(p), grid)
    trace_points_all_compact_cuda.launches += 1
    return pts._replace(idepth_min=out["o_idepth_min"], idepth_max=out["o_idepth_max"],
                        quality=out["o_quality"], status=out["o_status"],
                        pixel_interval=out["o_pixel_interval"]), counts[0], counts[1]


trace_points_all_compact_cuda.launches = 0
