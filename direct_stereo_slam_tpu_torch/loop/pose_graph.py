"""SE(3) pose-graph optimization (port of loop/pose_graph.py).

The reference's g2o glue: vertices are keyframe poses (camToWorld), edges
odometry and loop constraints with a Huber kernel and block-diagonal
information (translation weight on r[0:3], rotation weight on r[3:6]),
the newest vertex fixed, Gauss-Newton with a light constant damping.

On the card ``optimize`` runs the hand-written kernels
(``ops/pose_graph.py``, ``csrc/pose_graph.cu``): the dense solver is one
K7 launch for all iterations (each: K6's edge phase after the previous
update, the dense system with every entry summed in ascending edge
index, a panel Cholesky and one step of refinement: ``_solve_dense_fixed``
in plain PyTorch); the CG solver is one launch too (K8's redesign: each
iteration the update, K6's edge phase and a whole block-Jacobi PCG
solve). No host read, no library solve and no atomics: the same data
gives the same bits. For CPU tensors it runs the plain versions below
(``optimize_plain``):

- per-edge residuals r = log(Z^-1 T_a^-1 T_b) and their Jacobians with
  respect to right-multiplied tangents from forward-mode autodiff through
  the port's Lie ops at xi = 0 (``torch.func.jvp``, as the reference uses
  ``jax.jacfwd``); the series branches of ``lie`` keep them finite there;
- "dense": the [6N, 6N] system assembled with ``index_add_`` and solved
  with ``torch.linalg.solve`` (the reference calls ``jnp.linalg.solve``);
- "cg": matrix-free block-Jacobi preconditioned conjugate gradients; a
  system that has converged keeps its iterate (a masked update).

"auto" is dense up to 512 nodes and CG above.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import lie
from ..ops import pose_graph as pgk

LAM = 1e-4      # the reference's constant damping


class PoseGraphData(NamedTuple):
    """Fixed-size (bucketed) problem arrays."""

    T_wc: torch.Tensor        # [N, 4, 4] initial node poses
    node_valid: torch.Tensor  # [N]
    edge_a: torch.Tensor      # [E] node index (the "cur" side)
    edge_b: torch.Tensor      # [E] node index (the "from"/matched side)
    edge_Z: torch.Tensor      # [E, 4, 4] measurement: expected T_a^-1 T_b
    edge_w_t: torch.Tensor    # [E] translation information weight
    edge_w_r: torch.Tensor    # [E] rotation information weight
    edge_valid: torch.Tensor  # [E]
    fixed_node: torch.Tensor  # scalar index


def _edge_residual(T_a, T_b, Z):
    return lie.se3_log(lie.se3_inverse(Z) @ lie.se3_inverse(T_a) @ T_b)


def _edge_res_jac(T_a, T_b, Z):
    """Residuals [E, 6] and Jacobians [E, 6, 12] wrt right-multiplied
    tangents of (a, b): one forward-mode pass over the edges repeated 12
    times, each copy pushing one basis direction. (Under a vmap over the
    edges the per-edge angles would be 0-dim, where PyTorch's forward AD
    promotes a tangent divided by a Python float to float64.)"""
    E = T_a.shape[0]
    rep = lambda x: x.repeat(12, 1, 1)

    def f(xi_ab):
        return _edge_residual(rep(T_a) @ lie.se3_exp(xi_ab[:, :6]),
                              rep(T_b) @ lie.se3_exp(xi_ab[:, 6:]), rep(Z))

    eye = torch.eye(12, dtype=T_a.dtype, device=T_a.device)
    basis = eye[:, None, :].expand(12, E, 12).reshape(12 * E, 12)
    r, J = torch.func.jvp(f, (torch.zeros_like(basis),), (basis,))
    return r[:E], J.reshape(12, E, 6).permute(1, 2, 0)


def _edge_system(data: PoseGraphData, T, huber_delta):
    """Per-edge Gauss-Newton blocks at the current poses.
    Returns (Hblk [E, 12, 12], bblk [E, 12])."""
    r, J = _edge_res_jac(T[data.edge_a], T[data.edge_b], data.edge_Z)
    E = r.shape[0]
    info = torch.cat([data.edge_w_t[:, None].expand(E, 3),
                      data.edge_w_r[:, None].expand(E, 3)], dim=1)   # [E, 6]
    chi2 = torch.sum(info * r * r, dim=1)
    hw = torch.where(chi2 <= huber_delta ** 2, torch.ones_like(chi2),
                     huber_delta / torch.sqrt(torch.clamp(chi2, min=1e-12)))
    w = info * (hw * data.edge_valid.to(torch.float32))[:, None]
    Jw = J * w[:, :, None]
    Hblk = Jw.transpose(1, 2) @ J
    bblk = (Jw.transpose(1, 2) @ r[:, :, None])[..., 0]
    return Hblk, bblk


def _free_mask(data: PoseGraphData):
    idx = torch.arange(data.T_wc.shape[0], device=data.T_wc.device)
    return data.node_valid & (idx != data.fixed_node)


def _scatter_b(data, bblk, N):
    b = torch.zeros(N, 6, dtype=bblk.dtype, device=bblk.device)
    b.index_add_(0, data.edge_a, bblk[:, :6])
    b.index_add_(0, data.edge_b, bblk[:, 6:])
    return b


def _assemble_dense(data, Hblk, bblk, lam):
    """The damped [6N, 6N] system and its right-hand side -b (the plain
    version of K7): fixed and invalid nodes eliminated (unit diagonal),
    ``lam`` on the free diagonal, then + 1e-6 I."""
    N = data.T_wc.shape[0]
    dev = Hblk.device
    ar = torch.arange(6, device=dev)
    H = torch.zeros(6 * N * 6 * N, dtype=Hblk.dtype, device=dev)
    for (rows, cols, lo_r, lo_c) in ((data.edge_a, data.edge_a, 0, 0),
                                     (data.edge_a, data.edge_b, 0, 6),
                                     (data.edge_b, data.edge_a, 6, 0),
                                     (data.edge_b, data.edge_b, 6, 6)):
        r = 6 * rows[:, None, None] + ar[None, :, None]          # [E, 6, 1]
        c = 6 * cols[:, None, None] + ar[None, None, :]          # [E, 1, 6]
        H.index_add_(0, (r * (6 * N) + c).reshape(-1),
                     Hblk[:, lo_r:lo_r + 6, lo_c:lo_c + 6].reshape(-1))
    return _mask_and_damp(data, H.reshape(6 * N, 6 * N),
                          _scatter_b(data, bblk, N).reshape(6 * N), lam)


def _mask_and_damp(data, Hd, bd, lam):
    # fix the newest vertex and invalid nodes: eliminate their variables
    free = torch.repeat_interleave(_free_mask(data), 6)
    Hd = torch.where(free[:, None] & free[None, :], Hd, torch.zeros_like(Hd))
    # light LM damping on free vars; unit diagonal keeps fixed vars solvable
    Hd = Hd + torch.diag(torch.where(free, torch.full_like(bd, lam),
                                     torch.ones_like(bd)))
    Hd = Hd + 1e-6 * torch.eye(Hd.shape[0], dtype=Hd.dtype, device=Hd.device)
    bd = torch.where(free, bd, torch.zeros_like(bd))
    return Hd, -bd


def _assemble_dense_fixed(data, Hblk, bblk, lam):
    """``_assemble_dense`` with K7's order of sums, in plain PyTorch (for
    tests): every entry adds its valid edges' sub-blocks in ascending edge
    index (an edge's aa, ab, ba, bb in that order); an invalid edge's blocks
    are zero and are skipped."""
    N = data.T_wc.shape[0]
    H = torch.zeros(N, 6, N, 6, dtype=Hblk.dtype, device=Hblk.device)
    b = torch.zeros(N, 6, dtype=bblk.dtype, device=bblk.device)
    for e, (a, c, ok) in enumerate(zip(data.edge_a.tolist(), data.edge_b.tolist(),
                                       data.edge_valid.tolist())):
        if not ok:
            continue
        H[a, :, a, :] += Hblk[e, :6, :6]
        H[a, :, c, :] += Hblk[e, :6, 6:]
        H[c, :, a, :] += Hblk[e, 6:, :6]
        H[c, :, c, :] += Hblk[e, 6:, 6:]
        b[a] += bblk[e, :6]
        b[c] += bblk[e, 6:]
    return _mask_and_damp(data, H.reshape(6 * N, 6 * N), b.reshape(6 * N), lam)


def _solve_dense(data, Hblk, bblk, lam):
    """Materialized [6N, 6N] solve."""
    Hd, rhs = _assemble_dense(data, Hblk, bblk, lam)
    return torch.linalg.solve(Hd, rhs).reshape(-1, 6)


PANEL = 32      # the dense kernel's panel width (csrc/pose_graph.cu kPanel)


def _cholesky_bordered(Hd, rhs, nb=PANEL):
    """Right-looking Cholesky of the system's lower triangle in panels of
    ``nb`` columns, with -b as a border row: returns [n + 1, n] holding L
    (lower, diagonal included) and, in row n, L^-1 rhs. Each panel is
    factored a column at a time (the pivot's reciprocal square root r,
    L_jj = d r, the column times r, a rank-1 update of the panel's later
    columns), then the trailing rows take its product."""
    n = Hd.shape[0]
    A = torch.cat([Hd, rhs[None]], 0)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        P = A[k0:, k0:k1]
        d = torch.diagonal(P[:k1 - k0]).clone()
        for j in range(k1 - k0):
            inv = torch.rsqrt(d[j])
            P[j + 1:, j] = P[j + 1:, j] * inv
            P[j, j] = d[j] * inv
            col = P[j + 1:, j]
            P[j + 1:, j + 1:] -= col[:, None] * col[None, :k1 - k0 - j - 1]
            d[j + 1:] -= col[:k1 - k0 - j - 1] * col[:k1 - k0 - j - 1]
        A[k1:, k1:] -= A[k1:, k0:k1] @ A[k1:n, k0:k1].T
    return A


def _forward_sub(L, v, nb=PANEL):
    """L^-1 v by panels in ascending order, as the kernel solves it: a
    panel's unknowns a column at a time (times the diagonal's
    reciprocal), then pushed into the later rows."""
    n = L.shape[1]
    z = v.clone()
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        t = z[k0:k1]
        for c in range(k1 - k0):
            t[c] = t[c] * (1 / L[k0 + c, k0 + c])
            t[c + 1:] -= L[k0 + c + 1:k1, k0 + c] * t[c]
        z[k1:] -= L[k1:n, k0:k1] @ t
    return z


def _back_sub(L, v, nb=PANEL):
    """L^-T v by panels from the last, as the kernel solves it: a panel's
    unknowns a column at a time, then pushed into the earlier columns."""
    n = L.shape[1]
    x = v.clone()
    for k0 in reversed(range(0, n, nb)):
        k1 = min(k0 + nb, n)
        t = x[k0:k1]
        for c in reversed(range(k1 - k0)):
            t[c] = t[c] * (1 / L[k0 + c, k0 + c])
            t[:c] -= L[k0 + c, k0:k0 + c] * t[c]
        x[:k0] -= L[k0:k1, :k0].T @ t
    return x


def _solve_dense_fixed(data, Hblk, bblk, lam):
    """``_solve_dense`` as the dense kernel (K7) computes it, in plain
    PyTorch (for tests): K7's fixed-order assembly, a panel Cholesky of its
    lower triangle with -b as a border row (the forward solve), the back
    substitution, then one step of refinement on the whole assembled
    matrix: r = rhs - Hd x in twice f32's precision (the kernel carries
    each sum as a pair of floats; here float64, rounded once), x +=
    L^-T L^-1 r. The system is symmetric positive definite by
    construction, but the f32 blocks J^T W J are symmetric only to
    rounding: the refinement takes x to the solution of the whole system,
    as LU solves it, and from the Cholesky's f32 error (more than 2x LU's
    on small, well-conditioned graphs) to ~1e-8 x max|x| of a float64
    solve."""
    Hd, rhs = _assemble_dense_fixed(data, Hblk, bblk, lam)
    n = Hd.shape[0]
    F = _cholesky_bordered(Hd.clone(), rhs.clone())
    L = torch.tril(F[:n])
    x = _back_sub(L, F[n])
    r = (rhs.double() - Hd.double() @ x.double()).float()
    x = x + _back_sub(L, _forward_sub(L, r))
    return x.reshape(-1, 6)


def _edge_Hx(ea, eb, Hblk, x):
    """The edges' Gauss-Newton blocks times x [N, 6], summed per node."""
    xa, xb = x[ea][..., None], x[eb][..., None]
    y = torch.zeros_like(x)
    y.index_add_(0, ea, (Hblk[:, :6, :6] @ xa + Hblk[:, :6, 6:] @ xb)[..., 0])
    y.index_add_(0, eb, (Hblk[:, 6:, :6] @ xa + Hblk[:, 6:, 6:] @ xb)[..., 0])
    return y


def _edge_diag(ea, eb, Hblk, N):
    """The edges' diagonal 6x6 blocks summed per node: [N, 6, 6]."""
    D = torch.zeros(N, 6, 6, dtype=Hblk.dtype, device=Hblk.device)
    D.index_add_(0, ea, Hblk[:, :6, :6])
    D.index_add_(0, eb, Hblk[:, 6:, 6:])
    return D


def _pcg(b, edge_Hx, D, free, damp, cg_iters):
    """Block-Jacobi preconditioned CG for (H + damp I) x = b on the free
    nodes (``free`` [N, 1]): ``edge_Hx(x)`` is H x, ``D`` H's diagonal
    blocks [N, 6, 6]."""
    def Hx(x):
        x = x * free
        return (edge_Hx(x) + damp * x) * free

    eye6 = torch.eye(6, dtype=D.dtype, device=D.device)
    Dinv = torch.linalg.inv(D + damp * eye6[None])

    def Minv(x):
        return (Dinv @ x[..., None])[..., 0] * free

    x = torch.zeros_like(b)
    r = b
    z = Minv(r)
    p = z
    rz = torch.sum(r * z)
    bb = torch.clamp(torch.sum(b * b), min=1e-20)
    for _ in range(cg_iters):
        # the reference's while-loop condition, as a mask: a converged
        # system keeps its carry
        go = torch.sum(r * r) > 1e-10 * bb
        Hp = Hx(p)
        alpha = rz / torch.clamp(torch.sum(p * Hp), min=1e-20)
        x_n = x + alpha * p
        r_n = r - alpha * Hp
        z_n = Minv(r_n)
        rz_n = torch.sum(r_n * z_n)
        p_n = z_n + rz_n / torch.clamp(rz, min=1e-20) * p
        x, r, z, p, rz = [torch.where(go, new, old) for new, old in
                          ((x_n, x), (r_n, r), (z_n, z), (p_n, p), (rz_n, rz))]
    return x


def _solve_cg(data, Hblk, bblk, lam, cg_iters):
    """Matrix-free block-Jacobi preconditioned CG on the free subsystem."""
    N = data.T_wc.shape[0]
    ea, eb = data.edge_a, data.edge_b
    free = _free_mask(data).to(Hblk.dtype)[:, None]          # [N, 1]
    b = -_scatter_b(data, bblk, N) * free
    return _pcg(b, lambda x: _edge_Hx(ea, eb, Hblk, x), _edge_diag(ea, eb, Hblk, N), free,
                lam + 1e-6, cg_iters)


def edge_system(data: PoseGraphData, T, huber_delta):
    """(Hblk [E, 12, 12], bblk [E, 12]) at T: K6 on the card, the plain
    ``_edge_system`` for CPU tensors."""
    if T.is_cuda:
        return pgk.pose_graph_edges_cuda(T, None, data, huber_delta)[1:]
    return _edge_system(data, T, huber_delta)


def optimize(data: PoseGraphData, iterations: int = 25, huber_delta: float = 1.0,
             solver: str = "auto", cg_iters: int = 100) -> torch.Tensor:
    """Returns optimized [N, 4, 4] poses. solver: "dense", "cg", or "auto"
    (dense up to 512 nodes, CG beyond). On the card one launch either way
    (K7, or the resident CG optimize; no host read); for CPU tensors
    ``optimize_plain``."""
    N = data.T_wc.shape[0]
    if solver == "auto":
        solver = "dense" if N <= 512 else "cg"
    if not data.T_wc.is_cuda:
        return optimize_plain(data, iterations, huber_delta, solver, cg_iters)
    if solver != "cg":
        return pgk.pose_graph_gn_cuda(data, iterations, huber_delta, LAM)
    return pgk.pose_graph_cg_cuda(data, iterations, huber_delta, LAM + 1e-6, cg_iters)


def optimize_cg_queued(data: PoseGraphData, iterations: int = 25, huber_delta: float = 1.0,
                       cg_iters: int = 100) -> torch.Tensor:
    """``optimize(solver="cg")`` as queued launches, K6 -> K8 an iteration
    and K6's last update: not the main path (one launch runs the same
    arithmetic), its bit reference where N <= 4096, for tests and
    ``chip_smoke.py``."""
    T, x = data.T_wc, None
    inc = pgk.incidence(data)
    for _ in range(iterations):
        # K6 applies the previous iteration's update, then linearizes
        T, Hblk, bblk = pgk.pose_graph_edges_cuda(T, x, data, huber_delta)
        x = pgk.pose_graph_pcg_cuda(data, Hblk, bblk, inc, LAM + 1e-6, cg_iters)
    return pgk.pose_graph_edges_cuda(T, x)


def optimize_plain(data: PoseGraphData, iterations: int = 25, huber_delta: float = 1.0,
                   solver: str = "auto", cg_iters: int = 100) -> torch.Tensor:
    """``optimize`` in plain PyTorch, on any device (the kernels' plain
    version)."""
    if solver == "auto":
        solver = "dense" if data.T_wc.shape[0] <= 512 else "cg"
    T = data.T_wc
    for _ in range(iterations):
        Hblk, bblk = _edge_system(data, T, huber_delta)
        if solver == "cg":
            x = _solve_cg(data, Hblk, bblk, LAM, cg_iters)
        else:
            x = _solve_dense(data, Hblk, bblk, LAM)
        T = T @ lie.se3_exp(x)
    return T


def next_bucket(n: int) -> int:
    """Problem sizes in powers of two from 16 (the reference's jit buckets)."""
    b = 16
    while b < n:
        b *= 2
    return b


def build_data(poses_wc: np.ndarray, edges, fixed_node: int,
               device="cpu") -> PoseGraphData:
    """``poses_wc`` [n, 4, 4]; ``edges`` a list of (a, b, Z [4, 4], w_t, w_r)."""
    n = len(poses_wc)
    N = next_bucket(n)
    E = next_bucket(max(len(edges), 1))
    T = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    T[:n] = poses_wc
    node_valid = np.zeros(N, bool)
    node_valid[:n] = True
    ea = np.zeros(E, np.int64)
    eb = np.zeros(E, np.int64)
    Z = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    wt = np.zeros(E, np.float32)
    wr = np.zeros(E, np.float32)
    ev = np.zeros(E, bool)
    for i, (a, b, z, w_t, w_r) in enumerate(edges):
        ea[i], eb[i] = a, b
        Z[i] = z
        wt[i], wr[i] = w_t, w_r
        ev[i] = True
    t = lambda a: torch.as_tensor(a, device=device)
    return PoseGraphData(T_wc=t(T), node_valid=t(node_valid), edge_a=t(ea),
                         edge_b=t(eb), edge_Z=t(Z), edge_w_t=t(wt), edge_w_r=t(wr),
                         edge_valid=t(ev), fixed_node=t(np.int64(fixed_node)))
