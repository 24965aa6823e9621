"""A keyframe's activation of immature candidates: kernels K12 and K13
(``csrc/activate.cu``; port of the JAX package's models/frontend.py
``_gate_impl``, ``_gate_compact_activate``, ``_allocate_candidates``,
``_insert_candidates_all`` and ``_consume_candidates``, with
models/immature.py ``activate_points_all``).

- K12 ``gate_compact_activate``: the activation gate on every [S, NI]
  candidate lane, the stable lane-order compaction of each slot's
  survivors into ``budget`` lanes, and the 1-D inverse-depth LM on those
  lanes. Returns (ok [S, budget], idepth [S, budget], lane [S, budget],
  drop [S, NI]). On the card the LM runs on the survivors only, and a
  position past them has idepth NaN (the plain version's LM result there
  is discarded by its ``ok`` = 0 as well).
- K13 ``allocate_insert_consume``: the accepted lanes into free rows of
  the point pool (slots in ascending order, a slot's own segment first,
  capped by the pool), the rows written, the consumed candidates out of
  the immature set. Returns (state, immatures, allocation), the
  allocation as ``allocate_candidates`` returns it.

For CUDA tensors each entry point launches its kernel (and counts it in
``.launches`` of the ``*_cuda`` wrapper); the ``*_plain`` versions, the
front end's former PyTorch code, run for CPU tensors and, called by name,
on the card. The host-known inputs (the relative warps ``KRKi1`` / ``Kt1``,
the threshold, the flagged and participating slots) are host values: the
kernels take them by value, in the launch's parameters, so neither entry
point reads the card or uploads anything.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import SLAMConfig
from ..models import ba, immature
from ..utils.device import to_device
from . import _cuda

_P = ctypes.c_void_p


def _to_int(x: torch.Tensor) -> torch.Tensor:
    """Float -> int64 as the reference's f32 -> int32 cast behaves on the
    values that matter (NaN reads as 0, out-of-range saturates)."""
    return torch.nan_to_num(x, nan=0.0).clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int64)


def halfres_cells(pts: immature.ImmaturePoints, KRKi1, Kt1, w2: int, h2: int):
    """Each of the stacked [S, NI] candidates projected into the new KF at
    half res with its mid idepth: (ptp [S, NI, 3], the distance map's cell
    gu, gv it reads (clamped), in_b the unclipped bounds test)."""
    u1 = (pts.u + 0.5) / 2.0 - 0.5
    v1 = (pts.v + 0.5) / 2.0 - 0.5
    id_mid = 0.5 * (pts.idepth_min + torch.clamp(pts.idepth_max, max=1e3))
    xyz = torch.stack([u1, v1, torch.ones_like(u1)], -1)             # [S, NI, 3]
    ptp = xyz @ KRKi1.transpose(1, 2) + Kt1[:, None, :] * id_mid[..., None]
    z = ptp[..., 2]
    zs = torch.where(z == 0, torch.full_like(z, 1e-9), z)
    gu_raw = _to_int(torch.floor(ptp[..., 0] / zs + 0.5))
    gv_raw = _to_int(torch.floor(ptp[..., 1] / zs + 0.5))
    gu = torch.clamp(gu_raw, 0, w2 - 1)
    gv = torch.clamp(gv_raw, 0, h2 - 1)
    in_b = ((z > 0) & (gu_raw > 0) & (gv_raw > 0) & (gu_raw < w2 - 1)
            & (gv_raw < h2 - 1))
    return ptp, gu, gv, in_b


def _gate_impl(pts: immature.ImmaturePoints, dist_map, KRKi1, Kt1, min_act_dist,
              host_flagged, cfg: SLAMConfig, w2: int, h2: int):
    """Activation gate over the stacked [S, NI] candidates: project each
    candidate into the new KF at half res with its mid idepth, look up the
    distance map; returns (gate_ok, drop) masks (see the reference for the
    deletion policy and the frac() dither quirk)."""
    can = immature.can_activate(pts, cfg)
    ptp, gu, gv, in_b = halfres_cells(pts, KRKi1, Kt1, w2, h2)
    dither = ptp[..., 0] - torch.floor(ptp[..., 0])
    gate = dist_map[gv, gu] + dither >= min_act_dist * pts.my_type
    gate_ok = can & in_b & gate
    never_traced = ~torch.isfinite(pts.idepth_max) & (pts.status != immature.IPS_UNINITIALIZED)
    drop = pts.valid & (
        never_traced
        | (pts.status == immature.IPS_OUTLIER)
        | (~can & (host_flagged[:, None] | (pts.status == immature.IPS_OOB)))
        | (can & ~in_b))
    return gate_ok, drop


def gate_compact_activate_plain(imm, dist_map, KRKi1: np.ndarray, Kt1: np.ndarray,
                                min_act_dist: float, host_flagged: np.ndarray, images,
                                frame_valid, T_cw, T_wc, aff, calib, exposure, cfg: SLAMConfig,
                                w2: int, h2: int, budget: int):
    """K12's plain version: cheap gates on all lanes, then the idepth LM
    only on the first ``budget`` survivors of each slot (lane order).
    Returns (ok [S,B], idepth [S,B], lane [S,B], drop [S,NI]). ``T_wc``
    is the inverse of ``T_cw`` that the kernel reads too (K16's), so both
    warp with the same bits."""
    dev = dist_map.device
    t = lambda a: to_device(a, dev)
    gate_ok, drop = _gate_impl(imm, dist_map, t(np.asarray(KRKi1, np.float32)),
                              t(np.asarray(Kt1, np.float32)), t(np.float32(min_act_dist)),
                              t(np.asarray(host_flagged, bool)), cfg, w2, h2)
    lane = torch.sort((~gate_ok).to(torch.int8), dim=1, stable=True).indices[:, :budget]
    sel_ok = torch.gather(gate_ok, 1, lane)

    def take(a):
        idx = lane
        while idx.dim() < a.dim():
            idx = idx[..., None]
        return torch.gather(a, 1, idx.expand(idx.shape[:2] + a.shape[2:]))

    sub = immature.ImmaturePoints(*[take(a) for a in imm])
    S = gate_ok.shape[0]
    acts = immature.activate_points_all(
        sub, torch.arange(S, device=images.device), images, frame_valid, T_cw,
        T_wc, aff, calib, exposure, cfg)
    return sel_ok & acts.ok, acts.idepth, lane, drop


MAX_SLOTS = 32          # csrc/activate.cu's kMaxSlots: the slot bitmasks' width
GATE_STAMPS, POOL_STAMPS, RANKS = 6, 4, 8   # kGateStamps, kPoolStamps, kRanks


class GateParams(ctypes.Structure):
    """csrc/activate.cu's ``GateParams``, field for field."""

    _fields_ = [(n, ctypes.c_int) for n in ("S", "NI", "budget", "h2", "w2", "Wn", "Himg",
                                            "Wimg", "host_flagged")] + \
        [(n, ctypes.c_float) for n in ("min_act_dist", "min_trace_quality", "th", "min_h_act",
                                       "umax", "vmax")] + \
        [(n, _P) for n in ("valid", "u", "v", "idepth_min", "idepth_max", "color", "weight",
                           "quality", "my_type", "status", "pixel_interval", "dist",
                           "images", "frame_valid", "T_cw", "T_wc", "aff", "calib", "exposure",
                           "pat_u", "pat_v", "ok", "idepth", "lane", "drop", "lm_ran",
                           "stamps")] + \
        [("proj", ctypes.c_float * (MAX_SLOTS * 12))]


# the point pool's fields K13 copies and writes, in AllocParams' order
POOL_FIELDS = ("p_valid", "p_host", "p_u", "p_v", "p_idepth", "p_idepth_zero", "p_color",
               "p_weight", "p_prior", "p_res_good", "p_num_good", "p_last_res")
ALLOC_FIELDS = ("src_slot", "src_sub", "src_lane", "dst", "host", "alloc_valid", "consumed")


class AllocParams(ctypes.Structure):
    """csrc/activate.cu's ``AllocParams``, field for field."""

    _fields_ = [(n, ctypes.c_int) for n in ("S", "budget", "NI", "P", "B", "W",
                                            "participate")] + \
        [(n, _P) for n in ("ok", "lane", "drop", "idepth", "u", "v", "color", "weight",
                           "imm_valid") + POOL_FIELDS + tuple("o_" + f[2:] for f in POOL_FIELDS)
         + ("o_imm_valid",) + ALLOC_FIELDS + ("stamps",)]


def _bitmask(flags) -> int:
    flags = np.asarray(flags, bool)
    if flags.shape[0] > MAX_SLOTS:
        raise ValueError(f"at most {MAX_SLOTS} slots, got {flags.shape[0]}")
    return int(sum(1 << i for i in np.nonzero(flags)[0]))


def _u8(t: torch.Tensor) -> torch.Tensor:
    """A bool tensor's bytes (0 / 1)."""
    return t.contiguous().view(torch.uint8)


def _check(name, tensors: dict, dtypes: dict, dev) -> None:
    for key, t in tensors.items():
        want = dtypes.get(key, torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name}: {key} must be {want}, got {t.dtype}")
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: {key} must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def gate_compact_activate_cuda(imm, dist_map, KRKi1: np.ndarray, Kt1: np.ndarray,
                               min_act_dist: float, host_flagged: np.ndarray, images,
                               frame_valid, T_cw, T_wc, aff, calib, exposure, cfg: SLAMConfig,
                               w2: int, h2: int, budget: int, lm_ran=None, stamps=None):
    """Launch K12 (``dsslam_gate_activate``, one 8-block cluster a slot):
    the gate and the compaction once a slot, the idepth LM on the gate's
    survivors only; the outputs as the plain version's, except the idepth
    of a position past the slot's survivors, which is NaN (its ``ok`` is
    0: nothing reads it). ``lm_ran``, a uint8 [S, budget] tensor, gets 1
    where a warp ran the LM and 0 elsewhere: its sum is the LM warps of
    the launch, the sum over slots of min(survivors, budget). ``stamps``,
    an int64 [S, RANKS, GATE_STAMPS] tensor, gets each block's phase
    cycles (``csrc/activate.cu``'s kGateStamps)."""
    S, NI = imm.valid.shape
    Wn, Himg, Wimg = images.shape[0], images.shape[1], images.shape[2]
    budget = min(int(budget), NI)
    dev = dist_map.device
    ins = {"valid": imm.valid, "u": imm.u, "v": imm.v, "idepth_min": imm.idepth_min,
           "idepth_max": imm.idepth_max, "color": imm.color, "weight": imm.weight,
           "quality": imm.quality, "my_type": imm.my_type, "status": imm.status,
           "pixel_interval": imm.pixel_interval, "dist": dist_map, "images": images,
           "frame_valid": frame_valid, "T_cw": T_cw, "T_wc": T_wc, "aff": aff,
           "calib": calib, "exposure": exposure}
    ins = {k: t.contiguous() for k, t in ins.items()}
    for key, t, shape in (("lm_ran", lm_ran, (S, budget)), ("stamps", stamps,
                                                             (S, RANKS, GATE_STAMPS))):
        if t is not None:
            if tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"gate_compact_activate: {key} must be a contiguous {shape}")
            ins[key] = t
    _check("gate_compact_activate", ins, {"valid": torch.bool, "status": torch.int32,
                                          "frame_valid": torch.bool, "lm_ran": torch.uint8,
                                          "stamps": torch.int64}, dev)
    if (tuple(dist_map.shape) != (h2, w2) or tuple(T_cw.shape) != (Wn, 4, 4)
            or T_wc.shape != T_cw.shape):
        raise ValueError("gate_compact_activate: dist_map [h2, w2], T_cw and T_wc [W, 4, 4]")
    if S > MAX_SLOTS:
        raise ValueError(f"gate_compact_activate: at most {MAX_SLOTS} slots, got {S}")
    # the warps go in by value, in the launch's parameters: no upload
    proj = (ctypes.c_float * (MAX_SLOTS * 12))()
    proj[:S * 12] = np.concatenate([np.asarray(KRKi1, np.float32).reshape(S, 9),
                                    np.asarray(Kt1, np.float32).reshape(S, 3)],
                                   1).reshape(-1).tolist()
    pat_u, pat_v = immature._pattern(dev)
    ok = torch.empty(S, budget, dtype=torch.bool, device=dev)
    idepth = torch.empty(S, budget, dtype=torch.float32, device=dev)
    lane = torch.empty(S, budget, dtype=torch.int64, device=dev)
    drop = torch.empty(S, NI, dtype=torch.bool, device=dev)
    ptr = {k: (_u8(v) if v.dtype == torch.bool else v).data_ptr() for k, v in ins.items()}
    p = GateParams(
        S=S, NI=NI, budget=budget, h2=h2, w2=w2, Wn=Wn, Himg=Himg, Wimg=Wimg,
        host_flagged=_bitmask(host_flagged),
        min_act_dist=float(np.float32(min_act_dist)),
        min_trace_quality=float(np.float32(cfg.trace.min_trace_quality)),
        th=float(np.float32(8.0 * cfg.trace.outlier_th)),
        min_h_act=float(np.float32(cfg.ba.min_idepth_h_act)),
        umax=float(np.float32(Wimg - 1.001)), vmax=float(np.float32(Himg - 1.001)),
        proj=proj, pat_u=pat_u.data_ptr(), pat_v=pat_v.data_ptr(),
        ok=ok.data_ptr(), idepth=idepth.data_ptr(), lane=lane.data_ptr(),
        drop=drop.data_ptr(), **ptr)
    _cuda.call("dsslam_gate_activate", ctypes.addressof(p))
    gate_compact_activate_cuda.launches += 1
    return ok, idepth, lane, drop


gate_compact_activate_cuda.launches = 0


def gate_compact_activate(imm, dist_map, KRKi1, Kt1, min_act_dist, host_flagged, images,
                          frame_valid, T_cw, T_wc, aff, calib, exposure, cfg: SLAMConfig,
                          w2: int, h2: int, budget: int):
    """K12 on the card, its plain version for CPU tensors. ``KRKi1`` [S, 3,
    3], ``Kt1`` [S, 3], ``host_flagged`` [S] and ``min_act_dist`` are host
    values; ``T_wc`` is the inverse of ``T_cw`` (the front end has both
    from K16, ``ops/window.py``), which the kernel and the plain version
    both read, so that their warps have the same bits."""
    fn = gate_compact_activate_cuda if dist_map.is_cuda else gate_compact_activate_plain
    return fn(imm, dist_map, KRKi1, Kt1, min_act_dist, host_flagged, images, frame_valid,
              T_cw, T_wc, aff, calib, exposure, cfg, w2, h2, budget)


def allocate_candidates(ok, lane, drop, p_valid, participate: np.ndarray, P: int):
    """Activation insertion allocator (plain): slots in ascending order;
    each slot's accepted candidates (compacted lane order) take the slot's
    own free pool segment rows first, then any other free rows, capped by
    the remaining capacity. Accepted-but-unplaced candidates stay immature;
    dropped candidates are consumed regardless. Returns (src_slot, src_sub,
    src_lane, dst, host, valid) each [B] plus consumed [S, NI]."""
    S, BUD = ok.shape
    NI = drop.shape[1]
    B = p_valid.shape[0]
    dev = ok.device
    i64 = dict(dtype=torch.int64, device=dev)
    rows = torch.arange(B, **i64)
    free = torch.cat([~p_valid, torch.zeros(1, dtype=torch.bool, device=dev)])
    n_fill = torch.zeros((), **i64)
    out = {k: torch.zeros(B + 1, **i64) for k in ("slot", "sub", "lane", "dst", "host")}
    valid = torch.zeros(B + 1, dtype=torch.bool, device=dev)
    consumed = torch.zeros(S, NI, dtype=torch.bool, device=dev)
    sub = torch.arange(BUD, **i64)
    for s in range(S):
        if not participate[s]:
            continue
        accs = ok[s]
        n_acc = torch.sum(accs)
        outside = (rows < s * P) | (rows >= (s + 1) * P)
        key = rows + outside.to(torch.int64) * B + (~free[:B]).to(torch.int64) * (4 * B)
        order = torch.argsort(key)
        n_free = torch.sum(free[:B])
        k = torch.minimum(torch.minimum(n_free, n_acc), B - n_fill)
        rank = torch.cumsum(accs.to(torch.int64), 0) - 1
        take = accs & (rank < k)
        gpos = torch.where(take, n_fill + rank, torch.full_like(rank, B))
        dstrow = order[torch.clamp(rank, 0, B - 1)]
        out["slot"][gpos] = s
        out["sub"][gpos] = sub
        out["lane"][gpos] = lane[s]
        out["dst"][gpos] = dstrow
        out["host"][gpos] = s
        valid[gpos] = True
        free[torch.where(take, dstrow, torch.full_like(dstrow, B))] = False
        row = torch.cat([drop[s], torch.zeros(1, dtype=torch.bool, device=dev)])
        row[torch.where(take, lane[s], torch.full_like(lane[s], NI))] = True
        consumed[s] = row[:NI]
        n_fill = n_fill + k
    return (out["slot"][:B], out["sub"][:B], out["lane"][:B], out["dst"][:B],
            out["host"][:B], valid[:B], consumed)


def allocate_insert_consume_plain(state: ba.BAState, imm: immature.ImmaturePoints, ok,
                                  idepth, lane, drop, participate: np.ndarray, P: int):
    """K13's plain version: ``allocate_candidates``, the insertion of the
    placed candidates into the pool (``ba.add_points``) and their
    consumption. Returns (state, immatures, allocation)."""
    alloc = allocate_candidates(ok, lane, drop, state.p_valid, participate, P)
    src_slot, src_sub, src_lane, dst, host, valid, consumed = alloc
    state = ba.add_points(
        state, dst, host, imm.u[src_slot, src_lane], imm.v[src_slot, src_lane],
        idepth[src_slot, src_sub], imm.color[src_slot, src_lane],
        imm.weight[src_slot, src_lane], valid)
    return state, imm._replace(valid=imm.valid & ~consumed), alloc


def allocate_insert_consume_cuda(state: ba.BAState, imm: immature.ImmaturePoints, ok,
                                 idepth, lane, drop, participate: np.ndarray, P: int,
                                 stamps=None):
    """Launch K13 (``dsslam_allocate_insert``, one 8-block cluster: one
    warp's walk of the slots over bit masks, the pool's rows written by
    all 8 blocks): the allocation, the pool's new rows and the immature
    set's new validity in one launch, into new tensors (states are
    replaced, never written in place). ``stamps``, an int64 [RANKS,
    POOL_STAMPS] tensor, gets each block's phase cycles (kPoolStamps)."""
    S, BUD = ok.shape
    NI = drop.shape[1]
    B, W = state.p_res_good.shape
    dev = ok.device
    pool = {f: getattr(state, f).contiguous() for f in POOL_FIELDS}
    ins = {"ok": ok, "lane": lane, "drop": drop, "idepth": idepth, "u": imm.u, "v": imm.v,
           "color": imm.color, "weight": imm.weight, "imm_valid": imm.valid}
    ins = {**{k: t.contiguous() for k, t in ins.items()}, **pool}
    if stamps is not None:
        if tuple(stamps.shape) != (RANKS, POOL_STAMPS) or not stamps.is_contiguous():
            raise ValueError(f"allocate_insert_consume: stamps must be a contiguous "
                             f"{(RANKS, POOL_STAMPS)}")
        ins["stamps"] = stamps
    _check("allocate_insert_consume", ins,
           {"ok": torch.bool, "lane": torch.int64, "drop": torch.bool,
            "imm_valid": torch.bool, "p_valid": torch.bool, "p_host": torch.int64,
            "p_res_good": torch.bool, "p_last_res": torch.int32, "stamps": torch.int64}, dev)
    if imm.valid.shape != drop.shape or idepth.shape != ok.shape or lane.shape != ok.shape:
        raise ValueError("allocate_insert_consume: mismatched shapes")
    new = {f: torch.empty_like(t) for f, t in pool.items()}
    imm_valid = torch.empty_like(imm.valid)
    i64 = dict(dtype=torch.int64, device=dev)
    alloc = [torch.empty(B, **i64) for _ in range(5)] + [
        torch.empty(B, dtype=torch.bool, device=dev),
        torch.empty(S, NI, dtype=torch.bool, device=dev)]
    addr = lambda t: (_u8(t) if t.dtype == torch.bool else t).data_ptr()
    p = AllocParams(S=S, budget=BUD, NI=NI, P=int(P), B=B, W=W,
                    participate=_bitmask(participate),
                    o_imm_valid=addr(imm_valid),
                    **{k: addr(t) for k, t in ins.items()},
                    **{"o_" + f[2:]: addr(t) for f, t in new.items()},
                    **dict(zip(ALLOC_FIELDS, map(addr, alloc))))
    _cuda.call("dsslam_allocate_insert", ctypes.addressof(p))
    allocate_insert_consume_cuda.launches += 1
    return state._replace(**new), imm._replace(valid=imm_valid), tuple(alloc)


allocate_insert_consume_cuda.launches = 0


def allocate_insert_consume(state: ba.BAState, imm: immature.ImmaturePoints, ok, idepth,
                            lane, drop, participate: np.ndarray, P: int):
    """K13 on the card, its plain version for CPU tensors; ``participate``
    [S] is a host mask."""
    fn = allocate_insert_consume_cuda if ok.is_cuda else allocate_insert_consume_plain
    return fn(state, imm, ok, idepth, lane, drop, participate, P)
