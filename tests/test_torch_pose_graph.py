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
- K8's incidence lists (``ops/pose_graph.incidence``, plain PyTorch that
  the card runs too) and the CPU dispatch of ``optimize`` and
  ``edge_system``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu.loop import pose_graph as pg_j
from direct_stereo_slam_tpu_torch.io.synthetic_graphs import (BRANCH_CASES, branch_edges,
                                                              branch_graph, ring_graph)
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


def test_optimize_on_the_cpu_is_the_plain_version():
    poses, edges, fixed, iters = GRAPHS["ring"]()
    data = pg_t.build_data(poses, edges, fixed)
    assert torch.equal(pg_t.optimize(data, iters), pg_t.optimize_plain(data, iters))
    H, b = pg_t.edge_system(data, data.T_wc, 1.0)
    H0, b0 = pg_t._edge_system(data, data.T_wc, 1.0)
    assert torch.equal(H, H0) and torch.equal(b, b0)
