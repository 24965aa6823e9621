"""Launch wrappers of the pose-graph kernels (``csrc/pose_graph.cu``):
K6 ``dsslam_pose_graph_edges``, the edges' Gauss-Newton blocks (and the
previous iteration's update T <- T exp(x)); K7 ``dsslam_pose_graph_gn``,
every Gauss-Newton iteration of a dense optimize in one cooperative
launch (K6's edge phase, the fixed-order assembly, a panel Cholesky, the
solves and one step of refinement); ``dsslam_pose_graph_cg``, K8's
redesign, every Gauss-Newton iteration of a CG optimize in one launch
(K6's edge phase, the block-Jacobi set-up, the PCG loop); K8
``dsslam_pose_graph_pcg``, one block-Jacobi PCG solve in one launch (with
K6, the queued form: the resident one's bit reference). None reads the
card from the host.

``loop/pose_graph.optimize`` calls them for CUDA tensors; for CPU tensors
it takes the plain versions there (``_edge_system``, ``_solve_dense``,
``_solve_cg``). Each wrapper counts its launches in ``.launches`` (K6's
update-only call counts as a K6 launch).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _cuda

_KINDS = (torch.float32, torch.uint8, torch.int64, torch.int32)


def _require(name, f32=(), u8=(), i64=(), i32=()):
    """``_cuda.require_cuda`` on all the tensors (one device, contiguous),
    and each group's own dtype: data f32, masks uint8, edge indices int64,
    incidence lists int32."""
    groups = ((f32, torch.float32), (u8, torch.uint8), (i64, torch.int64), (i32, torch.int32))
    _cuda.require_cuda(name, *(t for ts, _ in groups for t in ts), dtypes=_KINDS)
    for ts, dtype in groups:
        for t in ts:
            if t.dtype != dtype:
                raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _u8(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(torch.bool).contiguous().view(torch.uint8)


def pose_graph_edges_cuda(T: torch.Tensor, x: Optional[torch.Tensor] = None, data=None,
                          huber_delta: float = 1.0):
    """K6. ``T`` [N, 4, 4] f32, ``x`` [N * 6] the previous iteration's
    update or None. With ``data`` (a ``PoseGraphData``): returns (T exp(x),
    Hblk [E, 12, 12], bblk [E, 12]), the blocks linearized at T exp(x)
    (``T`` itself when ``x`` is None). Without: T exp(x) only."""
    N = T.shape[0]
    T = T.contiguous()
    x = None if x is None else x.contiguous()
    T_out = T if x is None else torch.empty_like(T)
    if data is None:
        if x is None:
            return T
        _require("pose_graph_edges", f32=(T, x))
        _cuda.call("dsslam_pose_graph_edges", T.data_ptr(), x.data_ptr(), T_out.data_ptr(),
                   N, None, None, None, None, None, None, 0, 1.0, 1.0, None, None)
        pose_graph_edges_cuda.launches += 1
        return T_out
    E = data.edge_a.shape[0]
    valid = _u8(data.edge_valid)
    Z, ea, eb = data.edge_Z.contiguous(), data.edge_a.contiguous(), data.edge_b.contiguous()
    wt, wr = data.edge_w_t.contiguous(), data.edge_w_r.contiguous()
    _require("pose_graph_edges", f32=(T, Z, wt, wr) + (() if x is None else (x,)),
             u8=(valid,), i64=(ea, eb))
    H = torch.empty(E, 12, 12, dtype=torch.float32, device=T.device)
    g = torch.empty(E, 12, dtype=torch.float32, device=T.device)
    if E == 0 and x is None:
        return T_out, H, g        # nothing to compute: no launch
    _cuda.call("dsslam_pose_graph_edges", T.data_ptr(), _ptr(x), T_out.data_ptr(), N,
               Z.data_ptr(), ea.data_ptr(), eb.data_ptr(), wt.data_ptr(), wr.data_ptr(),
               valid.data_ptr(), E, float(huber_delta), float(huber_delta) ** 2,
               H.data_ptr(), g.data_ptr())
    pose_graph_edges_cuda.launches += 1
    return T_out, H, g


pose_graph_edges_cuda.launches = 0


def _graph_tensors(data):
    return (data.edge_a.contiguous(), data.edge_b.contiguous(), _u8(data.edge_valid),
            _u8(data.node_valid), data.fixed_node.contiguous())


class GnWork(NamedTuple):
    """K7's workspace after a launch that stopped early (``stop``): the
    poses the last iteration linearized at, its edge blocks, the system
    A [6N + 1, 6N] (-b in the last row), its factor L (lower triangle,
    and once factored L^T above the diagonal and L^-1 (-b) in the last
    row), and x [N, 6] (after ``stop=1``: the previous iteration's)."""

    T: torch.Tensor
    H: torch.Tensor
    g: torch.Tensor
    A: torch.Tensor
    L: torch.Tensor
    x: torch.Tensor


STOPS = {None: 0, "assembly": 1, "solve": 2}
# K7's phase stamps (csrc/pose_graph.cu GnPhase): ns that block 0 spends in
# each phase over a launch, the ns it waits at grid barriers, their count,
# and the launch's span
GN_STAMPS = ("edges", "assembly", "panel", "update", "solve", "residual", "refine", "final",
             "barrier", "barriers", "total")


def pose_graph_gn_cuda(data, iterations: int, huber_delta: float = 1.0, lam: float = 1e-4,
                       T: Optional[torch.Tensor] = None, x: Optional[torch.Tensor] = None,
                       stop: Optional[str] = None, timers: Optional[torch.Tensor] = None):
    """K7: ``iterations`` Gauss-Newton steps of the dense solver in one
    launch, from the poses ``T`` exp(``x``) (default: ``data.T_wc``, x
    None: as they are). Returns the optimized poses [N, 4, 4]; with
    ``stop`` ("assembly" or "solve") the last iteration stops there and a
    ``GnWork`` is returned. ``timers``: an int64 [len(GN_STAMPS)] tensor on
    the card that the launch adds its phase stamps to."""
    T = data.T_wc if T is None else T
    N, E = T.shape[0], data.edge_a.shape[0]
    if iterations == 0 and stop is None and x is None:
        return T                                  # nothing to optimize: no launch
    if iterations < 1:
        raise ValueError("pose_graph_gn: needs an iteration")
    T = T.contiguous()
    x = None if x is None else x.contiguous()
    ea, eb, valid, nvalid, fixed = _graph_tensors(data)
    Z, wt, wr = data.edge_Z.contiguous(), data.edge_w_t.contiguous(), data.edge_w_r.contiguous()
    _require("pose_graph_gn", f32=(T, Z, wt, wr) + (() if x is None else (x,)),
             u8=(valid, nvalid), i64=(ea, eb, fixed) + (() if timers is None else (timers,)))
    n = 6 * N
    f32 = dict(dtype=torch.float32, device=T.device)
    P = torch.empty(2, N, 4, 4, **f32)
    xw = torch.empty(N, 6, **f32)
    r = torch.empty(n, **f32)
    words = torch.empty(n, dtype=torch.int64, device=T.device)
    H = torch.empty(E, 12, 12, **f32)
    g = torch.empty(E, 12, **f32)
    A = torch.empty(n + 1, n, **f32)
    L = torch.empty(n + 1, n, **f32)
    T_out = torch.empty_like(T)
    _cuda.call("dsslam_pose_graph_gn", T.data_ptr(), _ptr(x), N, Z.data_ptr(), ea.data_ptr(),
               eb.data_ptr(), wt.data_ptr(), wr.data_ptr(), valid.data_ptr(), E,
               float(huber_delta), float(huber_delta) ** 2, nvalid.data_ptr(), fixed.data_ptr(),
               float(lam), int(iterations), STOPS[stop], P.data_ptr(), xw.data_ptr(),
               r.data_ptr(), words.data_ptr(), H.data_ptr(), g.data_ptr(), A.data_ptr(),
               L.data_ptr(), T_out.data_ptr(), _ptr(timers))
    pose_graph_gn_cuda.launches += 1
    if stop is None:
        return T_out
    k = iterations - 1
    return GnWork(T if k == 0 and x is None else P[k & 1], H, g, A, L, xw)


pose_graph_gn_cuda.launches = 0


def gn_barriers_cuda(count: int, timers: torch.Tensor) -> None:
    """``count`` of K7's grid barriers and nothing else, in one launch on
    ``timers``' card (their cost; not counted as a K7 launch)."""
    _require("pose_graph_gn", i64=(timers,))
    _cuda.call("dsslam_pose_graph_gn", None, None, 1, None, None, None, None, None, None, 0,
               1.0, 1.0, None, None, 1.0, int(count), 3, None, None, None, None, None, None,
               None, None, None, timers.data_ptr())


def gn_grid(N: int, E: int) -> dict:
    """K7's launch at these sizes: blocks, blocks an SM, registers, dynamic
    shared memory bytes (host calls only)."""
    out = (ctypes.c_int * 4)()
    err = _cuda.load_library().lib.dsslam_pose_graph_gn_grid(int(N), int(E), out)
    if err != 0:
        raise RuntimeError(f"dsslam_pose_graph_gn_grid: CUDA error {err}")
    return dict(zip(("blocks", "blocks_per_sm", "registers", "smem"), list(out)))


def incidence(data):
    """Each node's valid edge ends in ascending edge index, as K8 reads
    them: (offsets [N + 1] int32, entries int32), entry 2 e + side (side 0:
    the edge's ``a`` end, 1: its ``b`` end); node n's are
    entries[offsets[n]:offsets[n + 1]]. Made once per optimize, on the
    data's device, with no host read."""
    N = data.T_wc.shape[0]
    node = torch.stack([data.edge_a, data.edge_b], 1).reshape(-1)
    node = torch.where(data.edge_valid.repeat_interleave(2), node, torch.full_like(node, N))
    key, order = torch.sort(node, stable=True)
    off = torch.searchsorted(key, torch.arange(N + 1, device=node.device, dtype=key.dtype))
    return off.to(torch.int32), order.to(torch.int32)


# K8's phase stamps (csrc/pose_graph.cu PcgPhase): block 0's ns in each
# phase and at the cluster barriers, their count, the CG steps, the span
PCG_STAMPS = ("setup", "edge_pass", "node_pass", "update", "barrier", "barriers", "steps",
              "total")


def pose_graph_pcg_cuda(data, Hblk: torch.Tensor, bblk: torch.Tensor, inc, damp: float,
                        cg_iters: int, steps: Optional[torch.Tensor] = None,
                        timers: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8: ``_solve_cg``'s block-Jacobi PCG in one launch; ``inc`` is
    ``incidence(data)``. Returns x [N, 6]; writes the number of CG steps
    it ran into ``steps`` (an int32 [1] tensor on the card) when given;
    ``timers`` (int64 [len(PCG_STAMPS)] on the card) gets its phase stamps
    added."""
    N, E = data.T_wc.shape[0], data.edge_a.shape[0]
    ea, eb, valid, nvalid, fixed = _graph_tensors(data)
    Hblk, bblk = Hblk.contiguous(), bblk.contiguous()
    off, ent = (t.contiguous() for t in inc)
    _require("pose_graph_pcg", f32=(Hblk, bblk), u8=(valid, nvalid),
             i64=(ea, eb, fixed) + (() if timers is None else (timers,)),
             i32=(off, ent) + (() if steps is None else (steps,)))
    dev = Hblk.device
    work = torch.empty(4 * 6 * N + 36 * N + 12 * E, dtype=torch.float32, device=dev)
    x = torch.empty(N, 6, dtype=torch.float32, device=dev)
    _cuda.call("dsslam_pose_graph_pcg", Hblk.data_ptr(), bblk.data_ptr(), ea.data_ptr(),
               eb.data_ptr(), valid.data_ptr(), E, off.data_ptr(), ent.data_ptr(),
               nvalid.data_ptr(), fixed.data_ptr(), N, float(damp), int(cg_iters),
               work.data_ptr(), x.data_ptr(), _ptr(steps), _ptr(timers))
    pose_graph_pcg_cuda.launches += 1
    return x


pose_graph_pcg_cuda.launches = 0


# the resident CG optimize's phase stamps (csrc/pose_graph.cu CgPhase):
# block 0's ns in each phase and at the barriers, their count, the CG steps
# over all iterations, the span
CG_STAMPS = ("edges", "incidence", "setup", "node_pass", "update", "final", "barrier",
             "barriers", "steps", "total")


def pose_graph_cg_cuda(data, iterations: int, huber_delta: float = 1.0, damp: float = 1e-4 + 1e-6,
                       cg_iters: int = 100,
                       steps: Optional[torch.Tensor] = None,
                       timers: Optional[torch.Tensor] = None,
                       x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The resident CG optimize: ``iterations`` Gauss-Newton steps of
    ``optimize(solver="cg")`` in one launch (each: the previous update and
    K6's edge phase, then the block-Jacobi PCG at damping ``damp``), then
    the last update; the launch makes ``incidence(data)``'s lists itself
    (so an optimize is one device kernel). Returns the optimized poses
    [N, 4, 4]. ``steps``: an int32 [iterations] tensor
    that gets each iteration's CG steps; ``timers``: an int64
    [len(CG_STAMPS)] tensor that gets the phase stamps added; ``x``: an f32
    [N, 6] tensor that gets the last iteration's update."""
    T = data.T_wc.contiguous()
    N, E = T.shape[0], data.edge_a.shape[0]
    if iterations == 0:
        return T                                  # nothing to optimize: no launch
    ea, eb, valid, nvalid, fixed = _graph_tensors(data)
    Z, wt, wr = data.edge_Z.contiguous(), data.edge_w_t.contiguous(), data.edge_w_r.contiguous()
    dev = T.device
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.empty(N, 6, **f32) if x is None else x
    _require("pose_graph_cg", f32=(T, Z, wt, wr, x), u8=(valid, nvalid),
             i64=(ea, eb, fixed) + (() if timers is None else (timers,)),
             i32=() if steps is None else (steps,))
    lib = _cuda.load_library().lib
    work = torch.empty(lib.dsslam_pose_graph_cg_work(N), **f32)
    inc = torch.empty(2 * N + 1 + 10 * E, dtype=torch.int32, device=dev)
    H = torch.empty(E, 12, 12, **f32)
    g = torch.empty(E, 12, **f32)
    T_out = torch.empty_like(T)
    _cuda.call("dsslam_pose_graph_cg", T.data_ptr(), N, Z.data_ptr(), ea.data_ptr(),
               eb.data_ptr(), wt.data_ptr(), wr.data_ptr(), valid.data_ptr(), E,
               float(huber_delta), float(huber_delta) ** 2, nvalid.data_ptr(), fixed.data_ptr(),
               float(damp), int(iterations), int(cg_iters), work.data_ptr(), inc.data_ptr(), H.data_ptr(), g.data_ptr(), x.data_ptr(),
               T_out.data_ptr(), _ptr(steps), _ptr(timers))
    pose_graph_cg_cuda.launches += 1
    return T_out


pose_graph_cg_cuda.launches = 0
