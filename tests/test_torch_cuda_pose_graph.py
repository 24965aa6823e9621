"""The pose-graph kernels K6-K8 (csrc/pose_graph.cu) against their plain
PyTorch versions on the card (loop/pose_graph.py):

- K6 (the edges' 12x12 blocks and 12-vectors, forward-mode dual numbers)
  against ``_edge_system`` on edges at each side of every branch point of
  the Lie functions and on ring graphs, H and b per entry within 1e-4 x
  max|entry|. Two cases sit where f32 cancels (``LOOSE``: theta^2 just
  past the Taylor switch, where (1 - cos t) / t^2 keeps ~3 digits, and
  theta just below pi - 1e-2, where theta / sin(theta) amplifies sin's
  last bit): there the plain version is itself up to 6e-3 (H) and 2e-2 (b)
  x max|entry| from the float64 Jacobian, so K6 is held within 1e-3 of it
  and no further from the float64 blocks than 2x the plain version's
  distance. Its update T exp(x) against ``T @ lie.se3_exp(x)`` within
  1e-6 per entry;
- K7 (the dense system in a fixed order) against ``_assemble_dense``,
  H within the same bound and b within 1e-4 x the largest sum of its
  terms' magnitudes (near convergence b is a difference of large terms),
  and bit-equal to ``_assemble_dense_fixed``, the same order in plain
  PyTorch;
- ``optimize`` through K6 / K7 / ``solve_ex`` against ``optimize_plain``
  within 1e-4 per pose entry after 25 iterations at buckets 16, 128 and
  512; through K6 / K8 at bucket 1024 within 2e-3 x scale of the dense
  plain result (test_pose_graph_cg_matches_dense's bound), one K8 solve
  within 1e-3 x max|x| of ``_solve_cg`` (the CG iterates' order of sums);
- an empty edge list (all padding, and zero-length edge arrays, where
  the first K6 call launches nothing), all-invalid padding, a fixed node
  that is not the last, each wrapper's dtype checks, a wrong loop edge
  whose residual is near pi; two runs bit-equal without
  ``torch.use_deterministic_algorithms``; one ``optimize`` with no host
  read (``torch.cuda.set_sync_debug_mode("error")``) and its launches.

These tests need a CUDA card and skip elsewhere. They import nothing of
JAX, so on the card's machine they run without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_pose_graph.py
"""

import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu_torch.geometry import lie
from direct_stereo_slam_tpu_torch.io.synthetic_graphs import (BRANCH_CASES, branch_graph,
                                                              ring_graph, with_bad_loop)
from direct_stereo_slam_tpu_torch.loop import pose_graph as pg
from direct_stereo_slam_tpu_torch.ops import pose_graph as pgk

pytestmark = pytest.mark.cuda

# ring graphs per bucket: (nodes, loop edge spacing); buckets 16 ... 1024
RINGS = {16: (12, 0), 128: (100, 10), 512: (400, 20), 1024: (700, 25)}
# f32 cancellation next to a branch point (see the module docstring)
LOOSE = {"taylor_over", "near_pi_under"}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _rel(got, want):
    scale = float(torch.max(torch.abs(want)).clamp(min=1e-30))
    return float(torch.max(torch.abs(got - want))) / scale


def _data(graph, dev):
    return pg.build_data(*graph, device=dev)


def _ring(bucket, dev, **kw):
    n, every = RINGS[bucket]
    data = _data(ring_graph(n, seed=bucket, loop_every=every, **kw), dev)
    assert data.T_wc.shape[0] == bucket
    return data


@pytest.mark.parametrize("case", list(BRANCH_CASES) + ["ring_128", "ring_1024"])
def test_k6_matches_edge_system(dev, case):
    if case.startswith("ring_"):
        data = _ring(int(case[5:]), dev)
    else:
        data = _data(branch_graph(BRANCH_CASES[case]), dev)
    T = data.T_wc
    T_out, H, g = pgk.pose_graph_edges_cuda(T, None, data, 1.0)
    H0, g0 = pg._edge_system(data, T, 1.0)
    torch.cuda.synchronize()
    assert T_out is T and torch.isfinite(H).all() and torch.isfinite(g).all()
    if case not in LOOSE:
        assert _rel(H, H0) < 1e-4 and _rel(g, g0) < 1e-4
        return
    assert _rel(H, H0) < 1e-3 and _rel(g, g0) < 1e-3
    d64 = data._replace(**{k: getattr(data, k).double()
                           for k in ("T_wc", "edge_Z", "edge_w_t", "edge_w_r")})
    H6, g6 = pg._edge_system(d64, d64.T_wc, 1.0)
    for got, plain, exact in ((H, H0, H6), (g, g0, g6)):
        assert _rel(got.double(), exact) <= 2 * _rel(plain.double(), exact)


def test_k6_update_matches_se3_exp(dev):
    data = _ring(128, dev)
    N = data.T_wc.shape[0]
    x = torch.as_tensor(np.random.RandomState(4).randn(N, 6).astype(np.float32) * 0.05,
                        device=dev)
    x[:, 3:] *= 0.1
    T1, H, g = pgk.pose_graph_edges_cuda(data.T_wc, x.reshape(-1), data, 1.0)
    T_want = data.T_wc @ lie.se3_exp(x)
    assert float(torch.max(torch.abs(T1 - T_want))) < 1e-6 * float(T_want.abs().max())
    # the blocks are linearized at the updated poses
    H0, g0 = pg._edge_system(data, T1, 1.0)
    assert _rel(H, H0) < 1e-4 and _rel(g, g0) < 1e-4
    # update only: the same poses, bit for bit
    assert torch.equal(pgk.pose_graph_edges_cuda(data.T_wc, x.reshape(-1)), T1)


@pytest.mark.parametrize("bucket", [16, 128, 512])
def test_k7_matches_assembly(dev, bucket):
    data = _ring(bucket, dev)
    _, H, g = pgk.pose_graph_edges_cuda(data.T_wc, None, data, 1.0)
    Hd, rhs = pgk.pose_graph_assemble_cuda(data, H, g, pg.LAM)
    Hi, ri = pg._assemble_dense(data, H, g, pg.LAM)
    # b can be a difference of large opposite terms (a converged graph):
    # its order of sums is held against the sum of the terms' magnitudes
    b_scale = float(pg._scatter_b(data, g.abs(), data.T_wc.shape[0]).max())
    assert _rel(Hd, Hi) < 1e-4 and float((rhs - ri).abs().max()) < 1e-4 * b_scale
    Hf, rf = pg._assemble_dense_fixed(data, H, g, pg.LAM)
    assert torch.equal(Hd, Hf) and torch.equal(rhs, rf)


@pytest.mark.parametrize("bucket", [16, 128, 512])
def test_optimize_dense_matches_plain(dev, bucket):
    data = _ring(bucket, dev)
    T = pg.optimize(data, 25)
    T0 = pg.optimize_plain(data, 25)
    assert float(torch.max(torch.abs(T - T0))) < 1e-4
    fixed = int(data.fixed_node)
    assert torch.equal(T[fixed], data.T_wc[fixed])


def test_k8_matches_cg(dev):
    data = _ring(1024, dev)
    _, H, g = pgk.pose_graph_edges_cuda(data.T_wc, None, data, 1.0)
    x = pgk.pose_graph_pcg_cuda(data, H, g, pgk.incidence(data), pg.LAM + 1e-6, 100)
    x0 = pg._solve_cg(data, H, g, pg.LAM, 100)
    assert _rel(x, x0) < 1e-3
    T = pg.optimize(data, 25)                      # "auto": K8 above 512 nodes
    T_dense = pg.optimize_plain(data, 25, solver="dense")
    scale = float(torch.max(torch.abs(T_dense[:, :3, 3])))
    assert float(torch.max(torch.abs(T - T_dense))) < 2e-3 * scale


def test_empty_edge_list_leaves_the_poses(dev):
    poses, _, _ = ring_graph(10, seed=1)
    data = pg.build_data(poses, [], 9, device=dev)
    assert torch.equal(pg.optimize(data, 25), data.T_wc)
    assert torch.equal(pg.optimize(data, 25, solver="cg"), data.T_wc)


def test_no_edges_counts_only_launches(dev):
    """With zero-length edge arrays K6 has nothing to linearize: the first
    iteration launches nothing, the 24 updates and the last update do."""
    poses, _, _ = ring_graph(10, seed=1)
    data = pg.build_data(poses, [], 9, device=dev)
    data = data._replace(**{k: getattr(data, k)[:0] for k in (
        "edge_a", "edge_b", "edge_Z", "edge_w_t", "edge_w_r", "edge_valid")})
    n = pgk.pose_graph_edges_cuda.launches
    T, H, g = pgk.pose_graph_edges_cuda(data.T_wc, None, data)
    assert pgk.pose_graph_edges_cuda.launches == n
    assert T is data.T_wc and H.shape == (0, 12, 12) and g.shape == (0, 12)
    assert torch.equal(pg.optimize(data, 25), data.T_wc)
    assert pgk.pose_graph_edges_cuda.launches == n + 25


def test_wrappers_check_each_dtype(dev):
    """Data must be f32, masks uint8, edge indices int64: a tensor of
    another type raises instead of being read as f32."""
    data = _ring(16, dev)
    _, H, g = pgk.pose_graph_edges_cuda(data.T_wc, None, data)
    with pytest.raises(TypeError):
        pgk.pose_graph_edges_cuda(data.T_wc, None, data._replace(edge_w_t=data.edge_w_t.int()))
    with pytest.raises(TypeError):
        pgk.pose_graph_edges_cuda(data.T_wc.double(), None, data)
    with pytest.raises(TypeError):
        pgk.pose_graph_assemble_cuda(data, H.to(torch.int32), g, pg.LAM)
    with pytest.raises(TypeError):
        pgk.pose_graph_assemble_cuda(data._replace(edge_a=data.edge_a.int()), H, g, pg.LAM)
    with pytest.raises(TypeError):
        pgk.pose_graph_pcg_cuda(data, H, g.to(torch.int64), pgk.incidence(data), 1e-4, 10)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_padding_and_a_fixed_node_inside(dev, solver):
    """3 nodes in a bucket of 16 and 3 edges in 16 (the rest padding), and
    a 40-node ring fixed at node 5."""
    poses, edges, _ = ring_graph(3, seed=5)
    for data in (pg.build_data(poses, edges, 2, device=dev),
                 pg.build_data(*ring_graph(40, seed=3, loop_every=8, fixed=5), device=dev)):
        T = pg.optimize(data, 25, solver=solver)
        T0 = pg.optimize_plain(data, 25, solver=solver)
        tol = 1e-4 if solver == "dense" else 2e-3 * float(T0[:, :3, 3].abs().max())
        assert float(torch.max(torch.abs(T - T0))) < tol
        fixed = int(data.fixed_node)
        assert torch.equal(T[fixed], data.T_wc[fixed])
        pad = ~data.node_valid
        assert torch.equal(T[pad], data.T_wc[pad])


@pytest.mark.parametrize("case", ["near_pi_under", "near_pi_over"])
def test_wrong_loop_near_pi(dev, case):
    data = _data(with_bad_loop(ring_graph(12, seed=16), 11, 5, BRANCH_CASES[case]), dev)
    T = pg.optimize(data, 25)
    T0 = pg.optimize_plain(data, 25)
    assert torch.isfinite(T).all()
    assert float(torch.max(torch.abs(T - T0))) < 1e-4


@pytest.mark.parametrize("bucket", [128, 1024])
def test_two_runs_are_bit_equal(dev, bucket):
    assert not torch.are_deterministic_algorithms_enabled()
    data = _ring(bucket, dev)
    assert torch.equal(pg.optimize(data, 25), pg.optimize(data, 25))


@pytest.mark.parametrize("bucket", [128, 1024])
def test_optimize_makes_no_host_read(dev, bucket):
    data = _ring(bucket, dev)
    pg.optimize(data, 2)                  # build and load the kernels first
    torch.cuda.synchronize()
    counts = {f: f.launches for f in (pgk.pose_graph_edges_cuda, pgk.pose_graph_assemble_cuda,
                                      pgk.pose_graph_pcg_cuda)}
    torch.cuda.set_sync_debug_mode("error")
    try:
        T = pg.optimize(data, 25)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    made = [f.launches - n for f, n in counts.items()]
    assert made == ([26, 25, 0] if bucket <= 512 else [26, 0, 25])
    assert torch.isfinite(T).all()
