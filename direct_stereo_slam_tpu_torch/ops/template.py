"""The coarse tracker's template on the card: kernel K15
(``csrc/template.cu``; port of the JAX package's
models/depth_template.py ``build_template`` and, in its state mode, of the
per-point part of models/ba.py ``template_inputs``).

One cooperative launch that touches only the occupied cells: the points'
per-pixel sums (each pixel's points in ascending order; the pixels with
two live points or more through a list ranked by (pixel, point)), a 2x2
pyramid of occupancy bits and sums, the image's 2x2 means,
one dilation pass a level over the occupied cells and their neighbours,
the normalisation and the gates, and per level the raster-order
compaction into the level's budget. Points mode takes the projected
points; state mode takes the BA state's point arrays, the idepth hessian,
the calibration and the host-to-reference transforms and projects each
point first. Their plain versions are
``models/depth_template.py::build_template_plain`` (after
``models/ba.py::template_project``), whose orders the kernel keeps: the
lists are bit-equal. The level-0 image is read through its strides
(``pyr.data[0][..., 0]`` is not copied).

The wrapper keeps, per (device, stream, point capacity, image shape,
levels, budgets), the kernel's buffers and its parameter struct; a call
sets the inputs' and outputs' pointers and launches. A launch's buffers
are reused only in its stream's order (the kernel leaves its bit words
zeroed for the next). The outputs of a call are views of one new
allocation.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _cuda

_P = ctypes.c_void_p
MAX_LEVELS = 8                    # csrc/template.cu's kMaxLevels
MAX_POINTS = 48 * 1024            # kMaxPoints
MIN_CAP = 4096                    # the smallest point capacity of a buffer
# kTemplateStamps (block 0's cycles): the points, block 1's image tiles,
# the wait at the first grid barrier, the lone points (with their
# barrier), the duplicates' ranks and sums (with theirs), the pooling (with
# its barriers), the candidates, the wait at their barrier, the lists
STAMP_PHASES = ("points", "image", "barrier", "lone", "duplicates", "pool", "candidates",
                "barrier2", "lists")
TEMPLATE_STAMPS = len(STAMP_PHASES)


class TemplateParams(ctypes.Structure):
    """csrc/template.cu's ``TemplateParams``, field for field."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "N", "H", "W", "levels", "img_row", "img_col", "grid", "mode", "n_slots", "cap",
        "trh_slot", "trh_row", "trh_col", "bits_total", "n_lanes", "chunk")] + \
        [(n, ctypes.c_int * MAX_LEVELS) for n in ("h", "w", "budget", "nw", "bits_off",
                                                  "boff")] + \
        [(n, _P) for n in ("pu", "pv", "pid", "pw", "valid", "host", "trh", "calib", "img",
                           "maps", "bits", "pts", "out", "out_mask", "stamps")] + \
        [(n, _P * MAX_LEVELS) for n in ("sum", "wsum", "idn", "col", "limg")]


def level_shapes(H: int, W: int, levels: int):
    """Each level's (h, w): 2x2 pooling drops an odd row or column."""
    shapes = [(H, W)]
    for _ in range(1, levels):
        h, w = shapes[-1]
        shapes.append((h // 2, w // 2))
    return shapes


class _Launch:
    """A shape's parameter struct (shapes and buffers set) and its buffers."""

    def __init__(self, dev, cap: int, H: int, W: int, levels: int, budgets):
        if min(min(s) for s in level_shapes(H, W, levels)) < 1:
            raise ValueError(f"build_template: {levels} levels of {H}x{W} leave an empty level")
        grid = _cuda.sm_count(dev)
        sizes = (ctypes.c_longlong * 3)()
        err = _cuda.load_library().lib.dsslam_template_sizes(H, W, levels, grid, cap, sizes)
        if err != 0:
            raise RuntimeError(f"dsslam_template_sizes: CUDA error {err}")
        self.maps = torch.empty(sizes[0], dtype=torch.float32, device=dev)
        self.bits = torch.zeros(sizes[1], dtype=torch.int32, device=dev)   # zero between launches
        self.pts = torch.empty(sizes[2], dtype=torch.int32, device=dev)
        self.budgets = budgets
        self.n_lanes = sum(budgets)
        self.sizes = list(budgets) * 4      # the four float lists' levels, one after another
        self.params = p = TemplateParams(
            H=H, W=W, levels=levels, grid=grid, cap=cap,
            budget=(ctypes.c_int * MAX_LEVELS)(*budgets), maps=self.maps.data_ptr(),
            bits=self.bits.data_ptr(), pts=self.pts.data_ptr())
        self.addr = ctypes.addressof(p)

    def __call__(self, N: int, mode: int, ptrs, trh_strides, ref_img, stamps, dev):
        """Launch on the inputs' pointers; the lists (pu, pv, pid, pcolor,
        pmask), each a tuple over the levels."""
        p, n, L = self.params, self.n_lanes, len(self.budgets)
        p.N, p.mode = N, mode
        (p.pu, p.pv, p.pid, p.pw, p.valid, p.host, p.trh, p.calib, p.n_slots) = ptrs
        p.trh_slot, p.trh_row, p.trh_col = trh_strides
        p.img = ref_img.data_ptr()
        p.img_row, p.img_col = ref_img.stride()
        out = torch.empty(17 * n, dtype=torch.uint8, device=dev)
        p.out = out.data_ptr()
        p.out_mask = p.out + 16 * n
        p.stamps = 0 if stamps is None else stamps.data_ptr()
        _cuda.call("dsslam_template", self.addr)
        build_template_cuda.launches += 1
        f = out[:16 * n].view(torch.float32).split(self.sizes)
        return tuple(f[k * L:(k + 1) * L] for k in range(4)) + (
            out[16 * n:].view(torch.bool).split(self.budgets),)


_launches = {}


def _launch(dev, N: int, ref_img, levels: int, budgets) -> _Launch:
    if not 1 <= levels <= MAX_LEVELS or len(budgets) < levels:
        raise ValueError(f"build_template: 1 to {MAX_LEVELS} levels with a budget each")
    if N > MAX_POINTS:
        raise ValueError(f"build_template: at most {MAX_POINTS} points, got {N}")
    if ref_img.dtype != torch.float32 or ref_img.dim() != 2:
        raise TypeError("build_template: ref_img must be a float32 [H, W]")
    budgets = tuple(int(b) for b in budgets[:levels])
    # the points' buffer for the next power of two of points
    cap = MIN_CAP if N <= MIN_CAP else min(1 << (N - 1).bit_length(), MAX_POINTS)
    H, W = ref_img.shape
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream, cap, H, W, levels, budgets)
    got = _launches.get(key)
    if got is None:
        got = _launches[key] = _Launch(dev, cap, H, W, levels, budgets)
    return got


def _check(name: str, dev, tensors, N: int) -> None:
    for key, t, want in tensors:
        if t.dtype != want or t.device != dev or t.shape != (N,) or not t.is_contiguous():
            raise TypeError(f"{name}: {key} must be a contiguous {want} [{N}] on {dev}, got "
                            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_stamps(stamps) -> None:
    if stamps is not None and (tuple(stamps.shape) != (TEMPLATE_STAMPS,)
                               or stamps.dtype != torch.int64 or not stamps.is_contiguous()):
        raise ValueError(f"build_template: stamps must be a contiguous int64 [{TEMPLATE_STAMPS}]")


def build_template_cuda(proj_u, proj_v, proj_id, proj_w, ref_img, levels: int,
                        budgets: Tuple[int, ...], valid=None, stamps=None):
    """Launch K15 (``dsslam_template``) in points mode: returns the lists
    (pu, pv, pid, pcolor, pmask), each a tuple over the levels, as the
    plain version does. ``stamps``, an int64 [TEMPLATE_STAMPS] tensor,
    gets block 0's phase cycles (STAMP_PHASES).
    ``build_template_cuda.launches`` counts K15's launches in both modes."""
    dev = ref_img.device
    N = proj_u.shape[0]
    f32 = torch.float32
    ins = [("proj_u", proj_u, f32), ("proj_v", proj_v, f32), ("proj_id", proj_id, f32),
           ("proj_w", proj_w, f32)] + ([] if valid is None else [("valid", valid, torch.bool)])
    _check("build_template", dev, ins, N)
    _check_stamps(stamps)
    launch = _launch(dev, N, ref_img, levels, budgets)
    ptrs = (proj_u.data_ptr(), proj_v.data_ptr(), proj_id.data_ptr(), proj_w.data_ptr(),
            0 if valid is None else valid.data_ptr(), 0, 0, 0, 0)
    return launch(N, 0, ptrs, (0, 0, 0), ref_img, stamps, dev)


def build_template_from_state_cuda(p_u, p_v, p_idepth, p_host, p_valid, hdd, calib, T_rh,
                                   ref_img, levels: int, budgets: Tuple[int, ...],
                                   stamps=None):
    """Launch K15 in state mode: each of the pool's points projected into
    the reference keyframe (``T_rh`` [W, 4, 4] the host-to-reference
    transforms, ``calib`` [4] fx, fy, cx, cy, both read on the card) and
    weighted by its idepth hessian ``hdd``, then the template as
    ``build_template_cuda`` builds it. T_rh is read through its
    strides."""
    dev = ref_img.device
    N = p_u.shape[0]
    f32 = torch.float32
    _check("build_template_from_state", dev,
           [("p_u", p_u, f32), ("p_v", p_v, f32), ("p_idepth", p_idepth, f32),
            ("hdd", hdd, f32), ("p_valid", p_valid, torch.bool), ("p_host", p_host, torch.int64)],
           N)
    n_slots = T_rh.shape[0]
    if (T_rh.dtype != f32 or T_rh.shape[1:] != (4, 4) or calib.dtype != f32
            or calib.shape != (4,) or T_rh.device != dev or calib.device != dev):
        raise TypeError(f"build_template_from_state: T_rh must be a float32 [W, 4, 4] and "
                        f"calib a float32 [4] on {dev}")
    calib = calib.contiguous()
    _check_stamps(stamps)
    launch = _launch(dev, N, ref_img, levels, budgets)
    ptrs = (p_u.data_ptr(), p_v.data_ptr(), p_idepth.data_ptr(), hdd.data_ptr(),
            p_valid.data_ptr(), p_host.data_ptr(), T_rh.data_ptr(), calib.data_ptr(), n_slots)
    # T_rh read through its strides (einsum's is a permuted view)
    return launch(N, 1, ptrs, T_rh.stride(), ref_img, stamps, dev)


build_template_cuda.launches = 0
