"""Launch wrappers of the pose-graph kernels (``csrc/pose_graph.cu``):
K6 ``dsslam_pose_graph_edges``, the edges' Gauss-Newton blocks (and the
previous iteration's update T <- T exp(x)); K7
``dsslam_pose_graph_assemble``, the dense damped system in a fixed order;
K8 ``dsslam_pose_graph_pcg``, a whole block-Jacobi PCG solve in one
launch. None reads the card from the host.

``loop/pose_graph.optimize`` calls them for CUDA tensors; for CPU tensors
it takes the plain versions there (``_edge_system``, ``_assemble_dense``,
``_solve_cg``). Each wrapper counts its launches in ``.launches`` (K6's
update-only call counts as a K6 launch).
"""

from __future__ import annotations

from typing import Optional

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


def pose_graph_assemble_cuda(data, Hblk: torch.Tensor, bblk: torch.Tensor, lam: float):
    """K7: (Hd [6N, 6N], rhs [6N]) of ``_assemble_dense``, every entry's
    edges added in ascending edge index."""
    N, E = data.T_wc.shape[0], data.edge_a.shape[0]
    ea, eb, valid, nvalid, fixed = _graph_tensors(data)
    Hblk, bblk = Hblk.contiguous(), bblk.contiguous()
    _require("pose_graph_assemble", f32=(Hblk, bblk), u8=(valid, nvalid), i64=(ea, eb, fixed))
    Hd = torch.empty(6 * N, 6 * N, dtype=torch.float32, device=Hblk.device)
    rhs = torch.empty(6 * N, dtype=torch.float32, device=Hblk.device)
    _cuda.call("dsslam_pose_graph_assemble", Hblk.data_ptr(), bblk.data_ptr(), ea.data_ptr(),
               eb.data_ptr(), valid.data_ptr(), E, nvalid.data_ptr(), fixed.data_ptr(), N,
               float(lam), Hd.data_ptr(), rhs.data_ptr())
    pose_graph_assemble_cuda.launches += 1
    return Hd, rhs


pose_graph_assemble_cuda.launches = 0


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


def pose_graph_pcg_cuda(data, Hblk: torch.Tensor, bblk: torch.Tensor, inc, damp: float,
                        cg_iters: int, steps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8: ``_solve_cg``'s block-Jacobi PCG in one launch; ``inc`` is
    ``incidence(data)``. Returns x [N, 6]; writes the number of CG steps
    it ran into ``steps`` (an int32 [1] tensor on the card) when given."""
    N, E = data.T_wc.shape[0], data.edge_a.shape[0]
    ea, eb, valid, nvalid, fixed = _graph_tensors(data)
    Hblk, bblk = Hblk.contiguous(), bblk.contiguous()
    off, ent = (t.contiguous() for t in inc)
    _require("pose_graph_pcg", f32=(Hblk, bblk), u8=(valid, nvalid), i64=(ea, eb, fixed),
             i32=(off, ent) + (() if steps is None else (steps,)))
    dev = Hblk.device
    work = torch.empty(4 * 6 * N + 36 * N + 12 * E, dtype=torch.float32, device=dev)
    x = torch.empty(N, 6, dtype=torch.float32, device=dev)
    _cuda.call("dsslam_pose_graph_pcg", Hblk.data_ptr(), bblk.data_ptr(), ea.data_ptr(),
               eb.data_ptr(), valid.data_ptr(), E, off.data_ptr(), ent.data_ptr(),
               nvalid.data_ptr(), fixed.data_ptr(), N, float(damp), int(cg_iters),
               work.data_ptr(), x.data_ptr(), _ptr(steps))
    pose_graph_pcg_cuda.launches += 1
    return x


pose_graph_pcg_cuda.launches = 0
