"""Semi-dense inverse-depth template for the coarse tracker (port of
models/depth_template.py).

Active window points projected into the newest keyframe are scatter-added
into a level-0 idepth/weight map, 2x2 sum-pooled up the pyramid,
hole-dilated (diagonal neighbours on levels 0-1, axis neighbours above),
normalised, and compacted in raster order into fixed-budget per-level
point lists.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import SLAMConfig
from ..ops import template as template_ops
from ..utils.compact import nonzero_fixed
from . import ba


class TrackerTemplate(NamedTuple):
    """Per-level fixed-budget point lists (the tracker's reference data)."""

    pu: Tuple[torch.Tensor, ...]      # [B_l] pixel x at level l
    pv: Tuple[torch.Tensor, ...]      # [B_l]
    pid: Tuple[torch.Tensor, ...]     # [B_l] inverse depth
    pcolor: Tuple[torch.Tensor, ...]  # [B_l] reference intensity
    pmask: Tuple[torch.Tensor, ...]   # [B_l] bool

    @property
    def levels(self) -> int:
        return len(self.pu)


def default_budgets(w: int, h: int, levels: int, base: int = 8192) -> Tuple[int, ...]:
    out = []
    for l in range(levels):
        hw = (w >> l) * (h >> l)
        b = min(hw, max(base >> l, 128))
        out.append(((b + 127) // 128) * 128)
    return tuple(out)


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift with zero padding: out[y, x] = in[y+dy, x+dx]."""
    h, w = x.shape
    out = torch.zeros_like(x)
    ys = slice(max(dy, 0), h + min(dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    out[yd, xd] = x[ys, xs]
    return out


def _dilate_once(idepth, weight, offsets):
    """Fill weight<=0 holes with the mean of neighbours that have weight>0."""
    s = torch.zeros_like(idepth)
    n = torch.zeros_like(weight)
    cnt = torch.zeros_like(weight)
    for dy, dx in offsets:
        w_s = _shift2d(weight, dy, dx)
        i_s = _shift2d(idepth, dy, dx)
        m = (w_s > 0).to(torch.float32)
        s = s + i_s * m
        n = n + w_s * m
        cnt = cnt + m
    fill = (weight <= 0) & (cnt > 0)
    cnt_safe = torch.clamp(cnt, min=1.0)
    return (torch.where(fill, s / cnt_safe, idepth),
            torch.where(fill, n / cnt_safe, weight))


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 sum-pooling (odd edges dropped), each cell's four in a fixed
    order, ((top left + top right) + bottom left) + bottom right, which K15
    reproduces (a reduction's order on the card is its own)."""
    h2, w2 = x.shape[0] // 2, x.shape[1] // 2
    x = x[: 2 * h2, : 2 * w2]
    return ((x[0::2, 0::2] + x[0::2, 1::2]) + x[1::2, 0::2]) + x[1::2, 1::2]


def _pixel_sums(key: torch.Tensor, vals: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Per cell, the sum of the values whose key is that cell, added to 0
    in ascending point order (the order index_put_(accumulate=True) takes
    on the CPU): a stable sort by key, then one gather-add-scatter per rank
    within a cell, so every cell's chain has a fixed order on any device.
    vals: [K, N] -> [K, n_cells]."""
    out = torch.zeros(vals.shape[0], n_cells + 1, dtype=vals.dtype, device=vals.device)
    n = key.shape[0]
    if n == 0:
        return out[:, :n_cells]
    order = torch.sort(key, stable=True).indices
    sk, sv = key[order], vals[:, order]
    pos = torch.arange(n, device=key.device)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
    for r in range(int(rank.max()) + 1):        # the most points on one cell
        idx = torch.where(rank == r, sk, torch.full_like(sk, n_cells))
        # a cell once a rank (but the trash cell n_cells)
        out.index_copy_(1, idx, out.index_select(1, idx) + sv)
    return out[:, :n_cells]


def build_template_plain(proj_u, proj_v, proj_id, proj_w, ref_img, levels: int,
                         budgets: Tuple[int, ...], valid=None) -> TrackerTemplate:
    """K15's plain version (see ``build_template``)."""
    H, W = ref_img.shape
    dev = ref_img.device
    if valid is None:
        valid = torch.ones_like(proj_u, dtype=torch.bool)
    # (proj + 0.5).astype(int32) truncates toward zero; clip afterwards.
    # Lanes that are not ok carry zero weight, so where their (possibly
    # non-finite) coordinates land is irrelevant; nan_to_num only keeps
    # the integer conversion defined.
    ui = torch.clamp(torch.nan_to_num(proj_u + 0.5).clamp(-2**30, 2**30)
                     .to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.nan_to_num(proj_v + 0.5).clamp(-2**30, 2**30)
                     .to(torch.int64), 0, H - 1)
    ok = (valid & (proj_id > 0) & (proj_u >= 0) & (proj_v >= 0)
          & (proj_u < W) & (proj_v < H))
    wgt = torch.where(ok, proj_w, torch.zeros_like(proj_w))

    # the per-pixel sums, each pixel's points in ascending order; no
    # atomics: two runs give the same bits
    sums = _pixel_sums(vi * W + ui, torch.stack([proj_id * wgt, wgt]), H * W)
    idepth0, weight0 = sums[0].reshape(H, W), sums[1].reshape(H, W)

    idepths, weights, imgs = [idepth0], [weight0], [ref_img]
    img = ref_img
    for _ in range(1, levels):
        idepths.append(_pool(idepths[-1]))
        weights.append(_pool(weights[-1]))
        img = 0.25 * _pool(img)
        imgs.append(img)

    diag = [(1, 1), (-1, -1), (1, -1), (-1, 1)]
    axes = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    for l in range(min(2, levels)):
        idepths[l], weights[l] = _dilate_once(idepths[l], weights[l], diag)
    for l in range(2, levels):
        idepths[l], weights[l] = _dilate_once(idepths[l], weights[l], axes)

    pu, pv, pid, pcolor, pmask = [], [], [], [], []
    for l in range(levels):
        d, wsum, img_l = idepths[l], weights[l], imgs[l]
        h_l, w_l = d.shape
        ys = torch.arange(h_l, device=dev)[:, None]
        xs = torch.arange(w_l, device=dev)[None, :]
        border_ok = (ys >= 2) & (ys < h_l - 2) & (xs >= 2) & (xs < w_l - 2)
        idn = d / torch.clamp(wsum, min=1e-12)
        good = border_ok & (wsum > 0) & (idn > 0) & torch.isfinite(img_l)

        B = budgets[l]
        flat_good = good.reshape(-1)
        idx = nonzero_fixed(flat_good, B, 0)
        count = torch.sum(flat_good)
        lane_ok = torch.arange(B, device=dev) < count
        zero = torch.zeros(B, dtype=torch.float32, device=dev)
        pu.append(torch.where(lane_ok, (idx % w_l).to(torch.float32), zero))
        pv.append(torch.where(lane_ok, (idx // w_l).to(torch.float32), zero))
        pid.append(torch.where(lane_ok, idn.reshape(-1)[idx], zero))
        pcolor.append(torch.where(lane_ok, img_l.reshape(-1)[idx], zero))
        pmask.append(lane_ok)
    return TrackerTemplate(tuple(pu), tuple(pv), tuple(pid), tuple(pcolor),
                           tuple(pmask))


def build_template(proj_u, proj_v, proj_id, proj_w, ref_img, levels: int,
                   budgets: Tuple[int, ...], valid=None) -> TrackerTemplate:
    """proj_*: [N] points projected into the reference KF (level 0);
    ref_img: [H, W] reference intensity (coarser levels re-derived by 2x2
    mean, as the pyramid builder does; a strided view is read as it is).
    On the card one launch of K15 (``ops/template.py``), for CPU tensors
    the plain version; either way a new template object."""
    if ref_img.is_cuda:
        return TrackerTemplate(*template_ops.build_template_cuda(
            proj_u, proj_v, proj_id, proj_w, ref_img, levels, budgets, valid))
    return build_template_plain(proj_u, proj_v, proj_id, proj_w, ref_img, levels, budgets,
                                valid)


def build_template_from_state_plain(state: ba.BAState, cfg: SLAMConfig, ref_slot: int, hdd,
                                   ref_img, levels: int,
                                   budgets: Tuple[int, ...]) -> TrackerTemplate:
    """K15's state mode's plain version: ``build_template_plain`` on
    ``ba.template_inputs`` (``hdd`` None re-linearizes)."""
    ti = ba.template_inputs(state, cfg, ref_slot, hdd)
    return build_template_plain(ti[0], ti[1], ti[2], ti[3], ref_img, levels, budgets,
                                valid=ti[4])


def build_template_from_state(state: ba.BAState, cfg: SLAMConfig, ref_slot: int, hdd,
                              ref_img, levels: int, budgets: Tuple[int, ...]) -> TrackerTemplate:
    """The template of the BA window's points in reference slot
    ``ref_slot``, weighted by the idepth hessian ``hdd`` (None:
    re-linearize). On the card the window's pose prep
    (``ba.template_pose_prep``, a few plain launches) and one launch of
    K15 in state mode, which projects each point itself; for CPU tensors
    the plain version; either way a new template object."""
    if not ref_img.is_cuda:
        return build_template_from_state_plain(state, cfg, ref_slot, hdd, ref_img, levels,
                                               budgets)
    if hdd is None:
        hdd = ba.linearize(state, cfg).Hdd
    calib, T_rh = ba.template_pose_prep(state, ref_slot)
    return TrackerTemplate(*template_ops.build_template_from_state_cuda(
        state.p_u, state.p_v, state.p_idepth, state.p_host, state.p_valid, hdd, calib, T_rh,
        ref_img, levels, budgets))


def scale_template_idepth(template: TrackerTemplate, scale) -> TrackerTemplate:
    """Divide all template inverse depths by the accepted stereo scale."""
    return template._replace(pid=tuple(p / scale for p in template.pid))
