"""The coarse tracker's template on the card: kernel K15
(``csrc/template.cu``; port of the JAX package's
models/depth_template.py ``build_template``).

One cooperative launch: the points' per-pixel sums (each pixel's points
in ascending order, summed at its first point), the 2x2 sum
pyramid and the image's 2x2 means, one dilation pass a level, the
normalisation and the gates, and per level the raster-order compaction
into the level's budget. Its plain version is
``models/depth_template.py::build_template_plain``, whose summation
orders it keeps: the lists are bit-equal. The level-0 image is read
through its strides (``pyr.data[0][..., 0]`` is not copied).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _cuda

_P = ctypes.c_void_p
MAX_LEVELS = 8                    # csrc/template.cu's kMaxLevels
MAX_POINTS = 48 * 1024            # kMaxPoints
TEMPLATE_STAMPS = MAX_LEVELS + 3  # kTemplateStamps


class TemplateParams(ctypes.Structure):
    """csrc/template.cu's ``TemplateParams``, field for field."""

    _fields_ = [(n, ctypes.c_int) for n in ("N", "H", "W", "levels", "img_row", "img_col",
                                            "grid")] + \
        [(n, ctypes.c_int * MAX_LEVELS) for n in ("h", "w", "budget")] + \
        [(n, _P) for n in ("pu", "pv", "pid", "pw", "valid", "img", "psum", "pwsum",
                           "plead")] + \
        [(n, _P * MAX_LEVELS) for n in ("sum", "wsum", "limg", "idn", "good")] + \
        [("counts", _P)] + \
        [(n, _P * MAX_LEVELS) for n in ("o_pu", "o_pv", "o_pid", "o_pcolor", "o_pmask")] + \
        [("stamps", _P)]


def level_shapes(H: int, W: int, levels: int):
    """Each level's (h, w): 2x2 pooling drops an odd row or column."""
    shapes = [(H, W)]
    for _ in range(1, levels):
        h, w = shapes[-1]
        shapes.append((h // 2, w // 2))
    return shapes


def build_template_cuda(proj_u, proj_v, proj_id, proj_w, ref_img, levels: int,
                        budgets: Tuple[int, ...], valid=None, stamps=None):
    """Launch K15 (``dsslam_template``): returns the lists (pu, pv, pid,
    pcolor, pmask), each a tuple over the levels, as the plain version
    does. ``stamps``, an int64 [TEMPLATE_STAMPS] tensor, gets block 0's
    phase cycles (kTemplateStamps)."""
    H, W = ref_img.shape
    dev = ref_img.device
    N = proj_u.shape[0]
    if not 1 <= levels <= MAX_LEVELS or len(budgets) < levels:
        raise ValueError(f"build_template: 1 to {MAX_LEVELS} levels with a budget each")
    if N > MAX_POINTS:
        raise ValueError(f"build_template: at most {MAX_POINTS} points, got {N}")
    if valid is None:
        valid = torch.ones(N, dtype=torch.bool, device=dev)
    pts = {"pu": proj_u, "pv": proj_v, "pid": proj_id, "pw": proj_w}
    pts = {k: t.contiguous() for k, t in pts.items()}
    valid = valid.contiguous()
    for key, t in list(pts.items()) + [("valid", valid), ("ref_img", ref_img)]:
        want = torch.bool if key == "valid" else torch.float32
        if t.dtype != want or t.device != dev:
            raise TypeError(f"build_template: {key} must be {want} on {dev}, got {t.dtype} "
                            f"on {t.device}")
        if key not in ("ref_img",) and tuple(t.shape) != (N,):
            raise ValueError(f"build_template: {key} must be [N], got {tuple(t.shape)}")
    shapes = level_shapes(H, W, levels)
    if min(min(s) for s in shapes) < 1:
        raise ValueError(f"build_template: {levels} levels of {H}x{W} leave an empty level")
    grid = _cuda.sm_count(dev)
    sizes = [h * w for h, w in shapes]
    # scratch: sum, wsum and idn for every level, the image above level 0,
    # each point's pixel sums and first flag
    maps = 3 * sum(sizes) + sum(sizes[1:])
    work = torch.empty(maps + 2 * N, dtype=torch.float32, device=dev)
    plead = torch.empty(N, dtype=torch.uint8, device=dev)
    good = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
    counts = torch.empty(levels * grid, dtype=torch.int32, device=dev)
    views, at = {k: [] for k in ("sum", "wsum", "idn", "limg")}, 0
    for l, n in enumerate(sizes):
        for k in ("sum", "wsum", "idn") + (("limg",) if l else ()):
            views[k].append(work[at:at + n])
            at += n
    goods, at = [], 0
    for n in sizes:
        goods.append(good[at:at + n])
        at += n
    f32 = lambda n: torch.empty(n, dtype=torch.float32, device=dev)
    out = {"o_pu": [f32(budgets[l]) for l in range(levels)],
           "o_pv": [f32(budgets[l]) for l in range(levels)],
           "o_pid": [f32(budgets[l]) for l in range(levels)],
           "o_pcolor": [f32(budgets[l]) for l in range(levels)],
           "o_pmask": [torch.empty(budgets[l], dtype=torch.bool, device=dev)
                       for l in range(levels)]}
    if stamps is not None and (tuple(stamps.shape) != (TEMPLATE_STAMPS,)
                               or stamps.dtype != torch.int64 or not stamps.is_contiguous()):
        raise ValueError(f"build_template: stamps must be a contiguous int64 "
                         f"[{TEMPLATE_STAMPS}]")
    arr = lambda ts, ctype: (ctype * MAX_LEVELS)(*[t.data_ptr() for t in ts])
    ints = lambda xs: (ctypes.c_int * MAX_LEVELS)(*xs)
    p = TemplateParams(
        N=N, H=H, W=W, levels=levels, img_row=ref_img.stride(0), img_col=ref_img.stride(1),
        grid=grid, h=ints([h for h, _ in shapes]), w=ints([w for _, w in shapes]),
        psum=work[maps:].data_ptr(), pwsum=work[maps + N:].data_ptr(), plead=plead.data_ptr(),
        budget=ints([int(b) for b in budgets[:levels]]),
        valid=valid.view(torch.uint8).data_ptr(), img=ref_img.data_ptr(),
        counts=counts.data_ptr(), stamps=0 if stamps is None else stamps.data_ptr(),
        limg=(_P * MAX_LEVELS)(0, *[t.data_ptr() for t in views["limg"]]),
        good=arr(goods, _P), o_pmask=arr([t.view(torch.uint8) for t in out["o_pmask"]], _P),
        **{k: t.data_ptr() for k, t in pts.items()},
        **{k: arr(views[k], _P) for k in ("sum", "wsum", "idn")},
        **{k: arr(out[k], _P) for k in ("o_pu", "o_pv", "o_pid", "o_pcolor")})
    _cuda.call("dsslam_template", ctypes.addressof(p))
    build_template_cuda.launches += 1
    return tuple(tuple(out[k]) for k in ("o_pu", "o_pv", "o_pid", "o_pcolor", "o_pmask"))


build_template_cuda.launches = 0
