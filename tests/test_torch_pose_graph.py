"""The pose graph's plain versions, which the card kernels K6-K8
(csrc/pose_graph.cu) are held to, against the JAX package on the CPU.

- The edges' residuals and Jacobians (``_edge_res_jac``, forward-mode
  autodiff through the port's Lie functions: K6 evaluates the same
  functions on dual numbers, branch for branch) against ``jax.jacfwd`` in
  the JAX package's ``_edge_res_jac``: on the edges of the four graphs of
  test_torch_loop_components.py, and on edges on each side of every
  branch point (the Taylor switch at theta^2 = 1e-4, so3_log's theta =
  1e-5 and theta = pi - 1e-2). Residuals within 2e-5 x (1 + max|r|);
  Jacobians within 1e-5 x max|J|, except where f32 cancels: just past the
  Taylor switch (1 - cos t) / t^2 keeps ~3 digits and just below the
  near-pi switch theta / sin(theta) amplifies sin's last bit, so the two
  frameworks' sin and cos differ there by up to ~2.4e-4 x max|J| (bound
  1e-3 x max|J|).
- K7's fixed order (``_assemble_dense_fixed``: every entry adds its edges
  in ascending edge index) against the ``index_add_`` assembly
  (``_assemble_dense``): within 1e-6 x max|entry| (the order of the f32
  sums), and the same masked, damped diagonal.
- K7's solve (``_solve_dense_fixed``: a panel Cholesky of the fixed-order
  system with -b as a border row, the back substitution and one step of
  refinement on the whole matrix with its residual in twice f32's
  precision, in the kernel's block order) on the same graphs and a ring
  with a wrong near-pi loop: x no further from a float64 solve of the
  same f32 system than 2x ``torch.linalg.solve``'s own f32 error (the
  reference's LU; without the refinement the Cholesky is more than 2x it
  on small graphs, which a test shows), and within 2x the JAX package's
  own f32 error of its ``_solve_dense`` (LU, given the same blocks); the
  factor's pieces (L L^T the lower triangle, the border row L^-1 (-b), the
  substitutions); a NaN pose makes x NaN wherever ``_solve_dense``'s is.
- K8's incidence lists (``ops/pose_graph.incidence``, plain PyTorch that
  the queued K8 reads; the resident CG launch makes the same lists itself)
  and the CPU dispatch of ``optimize`` (dense and CG: no kernel entry
  point is reached) and ``edge_system``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu.loop import pose_graph as pg_j
from direct_stereo_slam_tpu_torch.io.synthetic_graphs import (BRANCH_CASES, branch_edges,
                                                              branch_graph, ring_graph,
                                                              with_bad_loop)
from direct_stereo_slam_tpu_torch.loop import pose_graph as pg_t
from direct_stereo_slam_tpu_torch.ops import pose_graph as pgk
from test_torch_loop_components import GRAPHS
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# f32 cancellation next to a branch point (see the module docstring)
LOOSE = {"taylor_over", "near_pi_under"}
# every case padded to one shape with identity edges: one JAX compile
PAD = 64
_jac_j = jax.jit(jax.vmap(pg_j._edge_res_jac))


def _graph_edges(name):
    """(T_a, T_b, Z) of a GRAPHS graph's edges at its initial poses."""
    poses, edges, _, _ = GRAPHS[name]()
    Ta = np.stack([poses[a] for a, _, _, _, _ in edges]).astype(np.float32)
    Tb = np.stack([poses[b] for _, b, _, _, _ in edges]).astype(np.float32)
    Z = np.stack([z for _, _, z, _, _ in edges]).astype(np.float32)
    return Ta, Tb, Z


CASES = [f"graph_{g}" for g in GRAPHS] + list(BRANCH_CASES)


@pytest.mark.parametrize("case", CASES)
def test_edge_res_jac_matches_jacfwd(case):
    if case.startswith("graph_"):
        Ta, Tb, Z = _graph_edges(case[len("graph_"):])
    else:
        Ta, Tb, Z = branch_edges(BRANCH_CASES[case])
        theta = np.linalg.norm([pg_t.lie.se3_log_np(np.linalg.inv(z) @ np.linalg.inv(a) @ b)[3:]
                                for a, b, z in zip(Ta, Tb, Z)], axis=1)
        np.testing.assert_allclose(theta, BRANCH_CASES[case], rtol=1e-4, atol=1e-6)
    n = len(Ta)
    pad = lambda x: np.concatenate([x, np.tile(np.eye(4, dtype=np.float32), (PAD - n, 1, 1))])
    rj, Jj = _jac_j(*(jnp.asarray(pad(x)) for x in (Ta, Tb, Z)))
    rj, Jj = np.asarray(rj)[:n], np.asarray(Jj)[:n]
    rt, Jt = pg_t._edge_res_jac(*(torch.as_tensor(x) for x in (Ta, Tb, Z)))
    assert rt.shape == (len(Ta), 6) and Jt.shape == (len(Ta), 6, 12)
    assert np.isfinite(Jj).all() and np.isfinite(Jt.numpy()).all()
    np.testing.assert_allclose(rt.numpy(), rj, rtol=0, atol=2e-5 * (1 + np.abs(rj).max()))
    tol = 1e-3 if case in LOOSE else 1e-5
    np.testing.assert_allclose(Jt.numpy(), Jj, rtol=0, atol=tol * np.abs(Jj).max())


def _blocks(poses, edges, fixed):
    data = pg_t.build_data(poses, edges, fixed)
    return data, pg_t._edge_system(data, data.T_wc, 1.0)


FIXED_ORDER_GRAPHS = {
    **{g: (lambda g=g: GRAPHS[g]()[:3]) for g in GRAPHS},
    "ring_loops": lambda: ring_graph(100, seed=2, loop_every=10),
    "fixed_inside": lambda: ring_graph(40, seed=3, loop_every=8, fixed=5),
    "near_pi": lambda: branch_graph(BRANCH_CASES["near_pi_over"]),
}


@pytest.mark.parametrize("name", list(FIXED_ORDER_GRAPHS))
def test_fixed_order_assembly_matches_index_add(name):
    data, (Hblk, bblk) = _blocks(*FIXED_ORDER_GRAPHS[name]())
    Hf, rf = pg_t._assemble_dense_fixed(data, Hblk, bblk, pg_t.LAM)
    Hi, ri = pg_t._assemble_dense(data, Hblk, bblk, pg_t.LAM)
    scale = float(Hi.abs().max())
    np.testing.assert_allclose(Hf.numpy(), Hi.numpy(), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(rf.numpy(), ri.numpy(), rtol=0,
                               atol=1e-6 * max(float(ri.abs().max()), 1e-30))
    # fixed and padding nodes: a unit diagonal, no coupling, no gradient
    pinned = ~np.repeat(pg_t._free_mask(data).numpy(), 6)
    assert pinned.any()
    Hn = Hf.numpy()
    off = Hn - np.diag(np.diag(Hn))
    assert (off[pinned] == 0).all() and (off[:, pinned] == 0).all()
    np.testing.assert_array_equal(np.diag(Hn)[pinned], np.float32(1.0) + np.float32(1e-6))
    np.testing.assert_array_equal(rf.numpy()[pinned], 0)


SOLVE_GRAPHS = {
    **FIXED_ORDER_GRAPHS,
    "ring_16": lambda: ring_graph(12, seed=16),
    "bad_loop": lambda: with_bad_loop(ring_graph(12, seed=16), 11, 5,
                                      BRANCH_CASES["near_pi_under"]),
}


def _system(name):
    data, (Hblk, bblk) = _blocks(*SOLVE_GRAPHS[name]())
    Hd, rhs = pg_t._assemble_dense_fixed(data, Hblk, bblk, pg_t.LAM)
    return data, Hblk, bblk, Hd, rhs


@pytest.mark.parametrize("name", list(SOLVE_GRAPHS))
def test_solve_dense_fixed_matches_float64_and_jax(name):
    data, Hblk, bblk, Hd, rhs = _system(name)
    x64 = torch.linalg.solve(Hd.double(), rhs.double()).numpy()
    scale = np.abs(x64).max()
    err = lambda x: np.abs(np.asarray(x, np.float64).reshape(-1) - x64).max() / scale
    x = pg_t._solve_dense_fixed(data, Hblk, bblk, pg_t.LAM)
    assert x.shape == (data.T_wc.shape[0], 6) and x.dtype == torch.float32
    e_fixed, e_lu = err(x.numpy()), err(torch.linalg.solve(Hd, rhs).numpy())
    assert e_fixed <= 2 * e_lu, (e_fixed, e_lu)
    poses, edges, fixed = SOLVE_GRAPHS[name]()
    xj = np.asarray(pg_j._solve_dense(pg_j.build_data(poses, edges, fixed),
                                      jnp.asarray(Hblk.numpy()), jnp.asarray(bblk.numpy()),
                                      pg_t.LAM))
    e_jax = err(xj)
    assert np.abs(x.numpy() - xj).max() / scale <= 2 * e_jax, (e_fixed, e_jax)


@pytest.mark.parametrize("name", ["ring_loops", "fixed_inside", "near_pi"])
def test_bordered_cholesky_pieces(name):
    """L L^T is the system's lower triangle, the border row L^-1 (-b), and
    the substitutions invert L and L^T (float64 checks of the f32 form)."""
    _, _, _, Hd, rhs = _system(name)
    n = Hd.shape[0]
    F = pg_t._cholesky_bordered(Hd.clone(), rhs.clone())
    L = torch.tril(F[:n]).double()
    sym = torch.tril(Hd.double()) + torch.tril(Hd.double(), -1).T
    assert float((L @ L.T - sym).abs().max()) < 1e-5 * float(sym.abs().max())
    y = torch.linalg.solve_triangular(L, rhs.double()[:, None], upper=False)[:, 0]
    assert float((F[n].double() - y).abs().max()) < 1e-4 * float(y.abs().max())
    Lf = torch.tril(F[:n])
    z = pg_t._forward_sub(Lf, rhs)
    assert float((L @ z.double() - rhs.double()).abs().max()) < 1e-5 * float(rhs.abs().max())
    x = pg_t._back_sub(Lf, z)
    assert float((L.T @ x.double() - z.double()).abs().max()) < 1e-5 * float(z.abs().max())


def test_solve_dense_fixed_needs_its_refinement():
    """Why the kernel refines: the panel Cholesky alone (the lower triangle,
    f32) is further from float64 than 2x LU's f32 error on small graphs,
    and one step of refinement with a residual in twice f32's precision
    brings it below LU's."""
    ratios = {}
    for name in ("chain", "info_r", "near_pi"):
        data, Hblk, bblk, Hd, rhs = _system(name)
        n = Hd.shape[0]
        x64 = torch.linalg.solve(Hd.double(), rhs.double())
        err = lambda x: float((x.double().reshape(-1) - x64).abs().max() / x64.abs().max())
        F = pg_t._cholesky_bordered(Hd.clone(), rhs.clone())
        e_lu = err(torch.linalg.solve(Hd, rhs))
        ratios[name] = err(pg_t._back_sub(torch.tril(F[:n]), F[n])) / e_lu
        assert err(pg_t._solve_dense_fixed(data, Hblk, bblk, pg_t.LAM)) <= e_lu
    assert max(ratios.values()) > 2, ratios


def test_solve_dense_fixed_spreads_a_nan_pose():
    data = pg_t.build_data(*ring_graph(40, seed=3, loop_every=8))
    T = data.T_wc.clone()
    T[7, 0, 3] = float("nan")
    Hblk, bblk = pg_t._edge_system(data, T, 1.0)
    lu = torch.isnan(pg_t._solve_dense(data, Hblk, bblk, pg_t.LAM))
    fixed = torch.isnan(pg_t._solve_dense_fixed(data, Hblk, bblk, pg_t.LAM))
    assert lu.any() and bool((fixed | ~lu).all())


@pytest.mark.parametrize("name", ["chain", "ring"])
def test_incidence_lists_each_nodes_valid_edges_in_order(name):
    poses, edges, fixed, _ = GRAPHS[name]()
    data = pg_t.build_data(poses, edges, fixed)
    off, ent = pgk.incidence(data)
    assert off.dtype == ent.dtype == torch.int32
    N = data.T_wc.shape[0]
    want = [[] for _ in range(N)]
    for e, (a, b, *_rest) in enumerate(edges):
        want[a].append(2 * e)
        want[b].append(2 * e + 1)
    got = [ent[off[n]:off[n + 1]].tolist() for n in range(N)]
    assert got == want
    assert int(off[-1]) == 2 * len(edges)


@pytest.mark.parametrize("solver", ["auto", "cg"])
def test_optimize_on_the_cpu_is_the_plain_version(solver, monkeypatch):
    poses, edges, fixed, iters = GRAPHS["ring"]()
    data = pg_t.build_data(poses, edges, fixed)

    def refuse(*a, **kw):
        raise AssertionError("a CPU graph reached the kernel library")

    monkeypatch.setattr(pgk._cuda, "call", refuse)
    monkeypatch.setattr(pgk._cuda, "load_library", refuse)
    counters = (pgk.pose_graph_edges_cuda, pgk.pose_graph_gn_cuda, pgk.pose_graph_pcg_cuda,
                pgk.pose_graph_cg_cuda)
    before = [f.launches for f in counters]
    assert torch.equal(pg_t.optimize(data, iters, solver=solver),
                       pg_t.optimize_plain(data, iters, solver=solver))
    assert [f.launches for f in counters] == before
    H, b = pg_t.edge_system(data, data.T_wc, 1.0)
    H0, b0 = pg_t._edge_system(data, data.T_wc, 1.0)
    assert torch.equal(H, H0) and torch.equal(b, b0)
