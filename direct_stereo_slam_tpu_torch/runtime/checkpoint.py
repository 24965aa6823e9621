"""Checkpoint / resume (port of runtime/checkpoint.py).

Saves and restores the BA window, the front end's host bookkeeping
(shells, immature points, template, per-slot pyramids, scale / trap state,
counters) and the loop handler's frames, edges and databases: enough to
stop a run mid-sequence and continue on the same inputs (bit for bit on
the CPU).

The file format is the JAX package's: one ``.npz`` of every array (the
same keys, the JAX package's dtypes: index fields int32) plus a JSON
sidecar of scalars and structure. So a checkpoint written by either
package loads into the other. The front end's device state comes to the
host in one packed copy (``utils.device.to_host``) and goes back with
``utils.device.to_device`` onto the *target* front end's device: a
checkpoint written on the CPU resumes on the card, and the reverse.

Differences from the reference, none of them in the file: the port has
no ``_last_marg_mask`` (its mask lives inside one keyframe's commit), so
the key is written all False, as the reference writes it by default,
and ignored on load; loading clears the port's caches of host views;
``save_loop_handler`` waits for a threaded handler to drain its queue
first. As in the reference, a monocular bootstrap in progress
(``mono_state``) is not carried.
"""

from __future__ import annotations

import json
from collections import deque
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models import ba, immature
from ..models.depth_template import TrackerTemplate
from ..models.frontend import FrameShell, FrontEnd
from ..models.scale_opt import ScaleState
from ..models.tracker import AffLight
from ..ops.pyramid import Pyramid
from ..utils.convert import INDEX_FIELDS
from ..utils.device import to_device, to_host


def _save_namedtuples(items, arrays: Dict[str, np.ndarray],
                      extra: Tuple[torch.Tensor, ...] = ()) -> tuple:
    """Every tensor of the (prefix, NamedTuple) ``items`` into ``arrays``
    (a tuple field as ``key.i`` plus ``key.__len__``; index fields int32,
    the JAX package's dtype), brought to the host in one packed copy with
    the ``extra`` tensors, whose host copies are returned."""
    keys: List[Tuple[str, str]] = []
    tensors: List[torch.Tensor] = []
    for prefix, nt in items:
        for field, val in zip(nt._fields, nt):
            key = f"{prefix}.{field}"
            if isinstance(val, tuple):
                arrays[f"{key}.__len__"] = np.asarray(len(val))
                keys += [(f"{key}.{i}", field) for i in range(len(val))]
                tensors += list(val)
            else:
                keys.append((key, field))
                tensors.append(val)
    host = to_host(tensors + list(extra))
    for (key, field), a in zip(keys, host):
        arrays[key] = a.astype(np.int32) if field in INDEX_FIELDS else a
    return host[len(keys):]


def _load_namedtuple(prefix: str, cls, arrays, device: torch.device):
    def tensor(a, field):
        t = to_device(a, device)
        return t.to(torch.int64) if field in INDEX_FIELDS else t

    vals = []
    for field in cls._fields:
        key = f"{prefix}.{field}"
        if f"{key}.__len__" in arrays:
            n = int(arrays[f"{key}.__len__"])
            vals.append(tuple(tensor(arrays[f"{key}.{i}"], field) for i in range(n)))
        else:
            vals.append(tensor(arrays[key], field))
    return cls(*vals)


def save_frontend(path: str, fe: FrontEnd):
    fe.flush_pipeline()  # consume any pipelined in-flight frame first
    fe.flush_pending()   # then commit any deferred keyframe tail
    arrays: Dict[str, np.ndarray] = {}
    items = [("ba", fe.ba_state)]
    if fe.template is not None:
        items.append(("template", fe.template))
    # stacked [S, NI] candidate pytree (one entry, not per-slot)
    items.append(("imm", fe.immatures))
    # per-slot pyramids: without them a resumed run exports pyr=None for
    # later-marginalized KFs, which moves the loop handler onto its
    # ICP-only acceptance branch
    items += [(f"pyr.{slot}", pyr) for slot, pyr in fe.pyramids.items()]
    acc = fe._trace_overflow_acc
    extra = _save_namedtuples(items, arrays, () if acc is None else (acc,))
    arrays["last_marg_mask"] = np.zeros(fe.pool, bool)
    # isOOB staying-host export accumulator (frontend._marg_export_acc)
    acc_slots = []
    for slot, entries in fe._marg_export_acc.items():
        acc_slots.append((int(slot), len(entries)))
        for j, (pts, cols) in enumerate(entries):
            arrays[f"margacc.{slot}.{j}.pts"] = pts
            arrays[f"margacc.{slot}.{j}.cols"] = cols

    meta = {
        "immature_slots": sorted(fe.imm_slots),
        "pyramid_slots": sorted(fe.pyramids.keys()),
        "has_template": fe.template is not None,
        "template_kf_slot": fe.template_kf_slot,
        "template_ref_aff": [float(a) for a in fe.template_ref_aff_np],
        "template_ref_exposure": float(fe.template_ref_exposure_np),
        "slot_exposure": {str(k): v for k, v in fe.slot_exposure.items()},
        "first_coarse_rmse": fe.first_coarse_rmse,
        "last_coarse_rmse": fe.last_coarse_rmse,
        "prev_kf_count": fe.prev_kf_count,
        "num_kfs": fe.num_kfs,
        "initialized": fe.initialized,
        "is_lost": fe.is_lost,
        "init_failed": fe.init_failed,
        "scale_state": {"trapped": fe.scale_state.trapped,
                        "consecutive_fails": fe.scale_state.consecutive_fails},
        "scale_errors": {str(k): v for k, v in fe.scale_errors.items()},
        "last_dso_error": fe.last_dso_error,
        "current_min_act_dist": fe.current_min_act_dist,
        "pot": fe.pot,
        # the trace tier gate depends on frames since the last keyframe
        "frames_since_kf": int(fe._frames_since_kf),
        "trace_overflow_acc": None if acc is None else int(extra[0]),
        "slot_stats": {str(k): v for k, v in fe.slot_stats.items()},
        "removal_stats": dict(fe.removal_stats),
        "marg_acc_slots": acc_slots,
        "all_frames": [
            {"incoming_id": s.incoming_id, "timestamp": s.timestamp,
             "T_wc": np.asarray(s.T_wc).tolist(), "aff": np.asarray(s.aff).tolist(),
             "tracking_ref_kf": s.tracking_ref_kf, "is_kf": s.is_kf,
             "exposure": s.exposure}
            for s in fe.all_frames
        ],
        "kf_indices": [fe.all_frames.index(s) for s in fe.kf_shells],
        "cur_pose": np.asarray(fe.cur_pose).tolist(),
    }
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_frontend(path: str, fe: FrontEnd) -> FrontEnd:
    """Restore into a freshly constructed FrontEnd (same config and
    intrinsics), its tensors on ``fe.device``."""
    with open(path + ".json") as f:
        meta = json.load(f)
    dev = fe.device

    # a pipelined in-flight frame and a deferred tail belong to the
    # replaced state
    fe._pl_reset()
    fe.flush_pending()
    with np.load(path + ".npz") as arrays:
        fe.ba_state = _load_namedtuple("ba", ba.BAState, arrays, dev)
        if meta["has_template"]:
            fe.template = _load_namedtuple("template", TrackerTemplate, arrays, dev)
        fe.immatures = _load_namedtuple("imm", immature.ImmaturePoints, arrays, dev)
        fe.pyramids = {int(s): _load_namedtuple(f"pyr.{s}", Pyramid, arrays, dev)
                       for s in meta.get("pyramid_slots", [])}
        fe._marg_export_acc = {
            int(slot): [(arrays[f"margacc.{slot}.{j}.pts"],
                         arrays[f"margacc.{slot}.{j}.cols"]) for j in range(n)]
            for slot, n in meta.get("marg_acc_slots", [])
        }
    fe.imm_slots = {int(s) for s in meta["immature_slots"]}
    # host views cached per state object (a loaded state is a new object,
    # but clear them all the same)
    fe._views_cache = fe._views_cache_key = None
    fe._track_imm_counts = fe._track_imm_counts_key = None
    fe.template_kf_slot = meta["template_kf_slot"]
    a, b = meta["template_ref_aff"]
    fe.template_ref_aff = AffLight(fe._f32(a), fe._f32(b))
    fe.template_ref_aff_np = np.asarray([a, b], np.float32)
    ref_exp = meta.get("template_ref_exposure", 1.0)
    fe.template_ref_exposure = fe._f32(ref_exp)
    fe.template_ref_exposure_np = ref_exp
    fe.slot_exposure = {int(k): v for k, v in meta.get("slot_exposure", {}).items()}
    fe.first_coarse_rmse = meta["first_coarse_rmse"]
    fe.last_coarse_rmse = meta["last_coarse_rmse"]
    fe.prev_kf_count = meta["prev_kf_count"]
    fe.num_kfs = meta["num_kfs"]
    fe.initialized = meta["initialized"]
    fe.is_lost = meta["is_lost"]
    fe.init_failed = meta["init_failed"]
    fe.scale_state = ScaleState(**meta["scale_state"])
    fe.scale_errors = {int(k): v for k, v in meta["scale_errors"].items()}
    fe.last_dso_error = meta["last_dso_error"]
    fe.current_min_act_dist = meta["current_min_act_dist"]
    fe.pot = meta["pot"]
    fe._frames_since_kf = int(meta.get("frames_since_kf", 0))
    toa = meta.get("trace_overflow_acc", None)
    fe._trace_overflow_acc = None if toa is None else to_device(np.int64(toa), dev)
    fe.slot_stats = {int(k): v for k, v in meta["slot_stats"].items()}
    fe.removal_stats = dict(meta.get("removal_stats", {}))
    fe.all_frames = [
        FrameShell(
            incoming_id=s["incoming_id"], timestamp=s["timestamp"],
            T_wc=np.asarray(s["T_wc"], np.float32),
            aff=np.asarray(s["aff"], np.float32),
            tracking_ref_kf=s["tracking_ref_kf"], is_kf=s["is_kf"],
            exposure=s.get("exposure", 1.0),
        )
        for s in meta["all_frames"]
    ]
    fe.kf_shells = [fe.all_frames[i] for i in meta["kf_indices"]]
    fe.cur_pose = np.asarray(meta["cur_pose"], np.float32)
    return fe


def save_loop_handler(path: str, handler):
    """The loop handler's frames, edges, retrieval database, nearby cloud
    and counters; a threaded handler first processes every queued
    keyframe (and raises if one failed)."""
    handler.join()
    arrays: Dict[str, np.ndarray] = {}
    meta = {"frames": [], "n": len(handler.frames),
            "direct_loop_count": handler.direct_loop_count,
            "icp_loop_count": handler.icp_loop_count,
            "cur_id": handler.cur_id,
            "db_to_frame": list(handler.db_to_frame)}
    for i, lf in enumerate(handler.frames):
        meta["frames"].append({
            "kf_id": lf.kf_id, "incoming_id": lf.incoming_id,
            "dso_error": lf.dso_error, "scale_error": lf.scale_error,
            "exposure": float(lf.exposure),
            "edges": [
                {"j": int(j), "w_t": float(w_t), "w_r": float(w_r), "idx": k}
                for k, (j, Z, w_t, w_r) in enumerate(lf.edges)
            ],
            "has_sc": lf.tfm_pca_rig is not None,
            "has_pts": lf.pts_cam is not None,
        })
        arrays[f"f{i}.T_wc"] = lf.T_wc
        arrays[f"f{i}.t_orig"] = lf.t_wc_orig
        for k, (j, Z, w_t, w_r) in enumerate(lf.edges):
            arrays[f"f{i}.e{k}.Z"] = np.asarray(Z)
        if lf.tfm_pca_rig is not None:
            arrays[f"f{i}.pca"] = lf.tfm_pca_rig
            arrays[f"f{i}.sig"] = lf.signature
        if lf.pts_cam is not None:
            arrays[f"f{i}.pts"] = lf.pts_cam
            arrays[f"f{i}.cols"] = lf.pts_colors
        if lf.pts_spherical is not None:
            arrays[f"f{i}.sph"] = lf.pts_spherical
    # retrieval state
    arrays["rk.db"] = (np.stack(handler.ringkeys.db)
                       if handler.ringkeys.db else np.zeros((0, 1)))
    arrays["rk.pending"] = (np.stack(list(handler.ringkeys.pending))
                            if handler.ringkeys.pending else np.zeros((0, 1)))
    arrays["cloud.pts"] = handler.cloud.pts
    arrays["cloud.ids"] = handler.cloud.ids
    meta["cloud_poses"] = {str(k): np.asarray(v).tolist()
                           for k, v in handler.cloud.id_pose_wc.items()}
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_loop_handler(path: str, handler):
    """Restore into a freshly constructed LoopHandler."""
    from ..loop.handler import LoopFrame

    handler.join()
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path + ".npz") as npz:
        arrays = {k: npz[k] for k in npz.files}
    handler.frames = []
    handler.signatures = []
    for i, fm in enumerate(meta["frames"]):
        lf = LoopFrame(
            kf_id=fm["kf_id"], incoming_id=fm["incoming_id"],
            T_wc=arrays[f"f{i}.T_wc"], t_wc_orig=arrays[f"f{i}.t_orig"],
            dso_error=fm["dso_error"], scale_error=fm["scale_error"],
            exposure=fm.get("exposure", 1.0),
        )
        for e in fm["edges"]:
            lf.edges.append((e["j"], arrays[f"f{i}.e{e['idx']}.Z"],
                             e["w_t"], e["w_r"]))
        if fm["has_sc"]:
            lf.tfm_pca_rig = arrays[f"f{i}.pca"]
            lf.signature = arrays[f"f{i}.sig"]
        if fm["has_pts"]:
            lf.pts_cam = arrays[f"f{i}.pts"]
            lf.pts_colors = arrays[f"f{i}.cols"]
        if f"f{i}.sph" in arrays:
            lf.pts_spherical = arrays[f"f{i}.sph"]
        handler.frames.append(lf)
        handler.signatures.append(
            lf.signature if lf.signature is not None
            else np.zeros(handler.cfg.loop.num_sectors * handler.cfg.loop.num_rings))
    rk = handler.ringkeys
    rk.db = list(arrays["rk.db"]) if arrays["rk.db"].size else []
    rk.pending = deque(list(arrays["rk.pending"]) if arrays["rk.pending"].size else [])
    rk._buf = None                  # the device mirror is rebuilt on demand
    handler.cloud.pts = arrays["cloud.pts"]
    handler.cloud.ids = arrays["cloud.ids"]
    handler.cloud.id_pose_wc = {
        int(k): np.asarray(v) for k, v in meta["cloud_poses"].items()}
    handler.direct_loop_count = meta["direct_loop_count"]
    handler.icp_loop_count = meta["icp_loop_count"]
    handler.cur_id = meta["cur_id"]
    handler.db_to_frame = [int(x) for x in meta.get("db_to_frame", [])]
    return handler
