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
- K7 (a dense optimize in one cooperative launch), stopped after an
  iteration's assembly: its edge phase bit-equal to K6 at the same poses
  (the first iteration's, and the second's after the first update), the
  system against ``_assemble_dense``, H within the same bound and b within
  1e-4 x the largest sum of its terms' magnitudes (near convergence b is a
  difference of large terms), and bit-equal to ``_assemble_dense_fixed``,
  the same order in plain PyTorch; stopped after an iteration's solve at
  buckets 16, 128 and 512: x within 1e-5 x max|x| of ``_solve_dense_fixed``
  (the same arithmetic, other roundings; both refine with a residual in
  twice f32's precision, so both sit ~1e-8 from float64) and no further
  from a float64
  solve of the same f32 system than 2x ``torch.linalg.solve_ex``'s error,
  L L^T the system's lower triangle within 1e-5 x max|entry|; a NaN pose
  makes x NaN wherever the plain ``_solve_dense``'s LU makes it NaN
  (``solve_ex``: ``torch.linalg.solve`` raises on the card's NaN system);
- ``optimize`` through K7 against ``optimize_plain`` within 1e-4 per pose
  entry after 25 iterations at buckets 16, 128, 256 and 512, and at 10
  and 40 nodes not padded to a bucket (K7's partial panels); through the
  resident CG launch at bucket 1024 within 2e-3 x scale of the dense plain
  result (test_pose_graph_cg_matches_dense's bound), one K8 solve within
  1e-3 x max|x| of ``_solve_cg`` (the CG iterates' order of sums), with its
  phase stamps on the same bits;
- the resident CG optimize (``solver="cg"``, one launch) in both its forms
  (one cluster, a cooperative grid) bit-equal to the queued K6 -> K8 chain
  (``optimize_cg_queued``: the same order of sums while N <= 4096) on
  rings at buckets 256 and 1024, a padded graph and a fixed node inside,
  within 1e-3 x the translation scale of ``optimize_plain(solver="cg")``;
  its CG steps per iteration and its phase stamps;
- an empty edge list (all padding, and zero-length edge arrays, where
  K6 launches nothing), all-invalid padding, a fixed node that is not the
  last, each wrapper's dtype checks, a wrong loop edge whose residual is
  near pi; two runs bit-equal without ``torch.use_deterministic_algorithms``;
  one ``optimize`` with no host read
  (``torch.cuda.set_sync_debug_mode("error")``) and its launches: one K7
  launch a dense optimize, one resident CG launch a CG optimize, and the
  profiler's device kernels of each only that one (no library solve,
  copy or fill).

These tests need a CUDA card and skip elsewhere. They import nothing of
JAX, so on the card's machine they run without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_pose_graph.py
"""

import re

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
RINGS = {16: (12, 0), 128: (100, 10), 256: (200, 12), 512: (400, 20), 1024: (700, 25)}
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
    n = 6 * data.T_wc.shape[0]
    w = pgk.pose_graph_gn_cuda(data, 1, 1.0, pg.LAM, stop="assembly")
    H, g = w.H, w.g
    Hd, rhs = w.A[:n], w.A[n]
    Hi, ri = pg._assemble_dense(data, H, g, pg.LAM)
    # b can be a difference of large opposite terms (a converged graph):
    # its order of sums is held against the sum of the terms' magnitudes
    b_scale = float(pg._scatter_b(data, g.abs(), data.T_wc.shape[0]).max())
    assert _rel(Hd, Hi) < 1e-4 and float((rhs - ri).abs().max()) < 1e-4 * b_scale
    Hf, rf = pg._assemble_dense_fixed(data, H, g, pg.LAM)
    assert torch.equal(Hd, Hf) and torch.equal(rhs, rf)
    # the factor's input: the same lower triangle and border row
    assert torch.equal(torch.tril(w.L[:n]), torch.tril(Hd)) and torch.equal(w.L[n], rhs)


@pytest.mark.parametrize("bucket", [16, 128])
def test_k7_edge_phase_is_k6(dev, bucket):
    """K7's edge phase and update are K6's code: the same bits at the first
    iteration's poses and, after one update, at the second's."""
    data = _ring(bucket, dev)
    w0 = pgk.pose_graph_gn_cuda(data, 1, 1.0, pg.LAM, stop="assembly")
    T0, H0, g0 = pgk.pose_graph_edges_cuda(data.T_wc, None, data, 1.0)
    assert w0.T is data.T_wc and torch.equal(w0.H, H0) and torch.equal(w0.g, g0)
    w1 = pgk.pose_graph_gn_cuda(data, 2, 1.0, pg.LAM, stop="assembly")
    x0 = pgk.pose_graph_gn_cuda(data, 1, 1.0, pg.LAM, stop="solve").x
    assert torch.equal(w1.x, x0)                  # the first iteration's update
    T1, H1, g1 = pgk.pose_graph_edges_cuda(data.T_wc, x0.reshape(-1), data, 1.0)
    assert torch.equal(w1.T, T1) and torch.equal(w1.H, H1) and torch.equal(w1.g, g1)


@pytest.mark.parametrize("bucket", [16, 128, 512])
def test_k7_solve_matches_plain_and_float64(dev, bucket):
    data = _ring(bucket, dev)
    n = 6 * data.T_wc.shape[0]
    w = pgk.pose_graph_gn_cuda(data, 1, 1.0, pg.LAM, stop="solve")
    Hd, rhs = w.A[:n], w.A[n]
    x_plain = pg._solve_dense_fixed(data, w.H, w.g, pg.LAM)
    assert torch.isfinite(w.x).all() and _rel(w.x, x_plain) < 1e-5
    x64 = torch.linalg.solve(Hd.double(), rhs.double())
    err = lambda x: float((x.double().reshape(-1) - x64).abs().max() / x64.abs().max())
    lib = torch.linalg.solve_ex(Hd, rhs)[0]
    assert err(w.x) <= 2 * err(lib), (err(w.x), err(lib))
    L = torch.tril(w.L[:n]).double()
    sym = torch.tril(Hd.double()) + torch.tril(Hd.double(), -1).T
    assert float((L @ L.T - sym).abs().max()) < 1e-5 * float(sym.abs().max())


def test_k7_spreads_a_nan_pose(dev):
    data = _ring(128, dev)
    T = data.T_wc.clone()
    T[7, 0, 3] = float("nan")
    data = data._replace(T_wc=T)
    w = pgk.pose_graph_gn_cuda(data, 1, 1.0, pg.LAM, stop="solve")
    # _solve_dense's LU without its singularity check, which raises here
    lu = torch.isnan(torch.linalg.solve_ex(*pg._assemble_dense(data, w.H, w.g, pg.LAM))[0])
    assert lu.any() and bool((torch.isnan(w.x.reshape(-1)) | ~lu).all())


@pytest.mark.parametrize("n", [10, 40])
def test_k7_at_a_size_off_the_buckets(dev, n):
    """A graph of n nodes not padded to a bucket (6n = 60, 240: a last
    panel and chunk narrower than 32) through K7's partial-width paths."""
    poses, edges, fixed = ring_graph(n, seed=n, loop_every=8)
    data = pg.build_data(poses, edges, fixed, device=dev)
    data = data._replace(T_wc=data.T_wc[:n].contiguous(), node_valid=data.node_valid[:n])
    T = pg.optimize(data, 25)
    assert T.shape == (n, 4, 4)
    assert float(torch.max(torch.abs(T - pg.optimize_plain(data, 25)))) < 1e-4
    w = pgk.pose_graph_gn_cuda(data, 1, 1.0, pg.LAM, stop="solve")
    Hd, rhs = w.A[:6 * n], w.A[6 * n]
    assert torch.equal(Hd, pg._assemble_dense_fixed(data, w.H, w.g, pg.LAM)[0])
    x64 = torch.linalg.solve(Hd.double(), rhs.double())
    err = lambda x: float((x.double().reshape(-1) - x64).abs().max() / x64.abs().max())
    assert err(w.x) <= 2 * err(torch.linalg.solve_ex(Hd, rhs)[0])


@pytest.mark.parametrize("bucket", [16, 128, 256, 512])
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
    steps = torch.zeros(1, dtype=torch.int32, device=dev)
    timers = torch.zeros(len(pgk.PCG_STAMPS), dtype=torch.int64, device=dev)
    x2 = pgk.pose_graph_pcg_cuda(data, H, g, pgk.incidence(data), pg.LAM + 1e-6, 100, steps,
                                 timers)
    stamps = dict(zip(pgk.PCG_STAMPS, timers.tolist()))
    assert torch.equal(x2, x) and stamps["steps"] == int(steps) and stamps["total"] > 0
    assert stamps["barriers"] == 1 + 3 * int(steps)
    T = pg.optimize(data, 25)                      # "auto": CG above 512 nodes
    T_dense = pg.optimize_plain(data, 25, solver="dense")
    scale = float(torch.max(torch.abs(T_dense[:, :3, 3])))
    assert float(torch.max(torch.abs(T - T_dense))) < 2e-3 * scale


def test_empty_edge_list_leaves_the_poses(dev):
    poses, _, _ = ring_graph(10, seed=1)
    data = pg.build_data(poses, [], 9, device=dev)
    assert torch.equal(pg.optimize(data, 25), data.T_wc)
    assert torch.equal(pg.optimize(data, 25, solver="cg"), data.T_wc)


def test_no_edges_counts_only_launches(dev):
    """With zero-length edge arrays K6 has nothing to linearize and
    launches nothing; the CG path's 24 updates and its last update do, and
    the dense path is one K7 launch."""
    poses, _, _ = ring_graph(10, seed=1)
    data = pg.build_data(poses, [], 9, device=dev)
    data = data._replace(**{k: getattr(data, k)[:0] for k in (
        "edge_a", "edge_b", "edge_Z", "edge_w_t", "edge_w_r", "edge_valid")})
    n, n7 = pgk.pose_graph_edges_cuda.launches, pgk.pose_graph_gn_cuda.launches
    T, H, g = pgk.pose_graph_edges_cuda(data.T_wc, None, data)
    assert pgk.pose_graph_edges_cuda.launches == n
    assert T is data.T_wc and H.shape == (0, 12, 12) and g.shape == (0, 12)
    assert torch.equal(pg.optimize(data, 25), data.T_wc)
    assert pgk.pose_graph_edges_cuda.launches == n and pgk.pose_graph_gn_cuda.launches == n7 + 1
    n8 = pgk.pose_graph_cg_cuda.launches
    assert torch.equal(pg.optimize(data, 25, solver="cg"), data.T_wc)
    # one resident CG launch, no K6 (the queued form: 24 updates and the last)
    assert pgk.pose_graph_edges_cuda.launches == n and pgk.pose_graph_cg_cuda.launches == n8 + 1


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
        pgk.pose_graph_gn_cuda(data._replace(edge_Z=data.edge_Z.double()), 1)
    with pytest.raises(TypeError):
        pgk.pose_graph_gn_cuda(data._replace(edge_a=data.edge_a.int()), 1)
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
    counts = {f: f.launches for f in (pgk.pose_graph_edges_cuda, pgk.pose_graph_gn_cuda,
                                      pgk.pose_graph_pcg_cuda, pgk.pose_graph_cg_cuda)}
    torch.cuda.set_sync_debug_mode("error")
    try:
        T = pg.optimize(data, 25)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    made = [f.launches - n for f, n in counts.items()]
    # a dense optimize is one K7 launch, a CG one one resident CG launch
    # (the queued CG form: 26 K6 and 25 K8)
    assert made == ([0, 1, 0, 0] if bucket <= 512 else [0, 0, 0, 1])
    assert torch.isfinite(T).all()


def test_dense_optimize_is_one_device_kernel(dev):
    """The profiler's device work of one dense optimize: K7's launch and
    nothing else (no library solve, copy or fill); and of one CG optimize
    in the same session (a process records device events in its first
    session only): the resident CG launch alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    data, cg_data = _ring(128, dev), _ring(1024, dev)
    pg.optimize(data, 2)                  # build and load the kernels first
    pg.optimize(cg_data, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pg.optimize(data, 25)
        torch.cuda.synchronize()
        pg.optimize(cg_data, 25)
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    names = [e.name for e in evs]
    if not names:
        pytest.skip("the profiler recorded no device event in this process")
    assert len(names) == 2, names
    assert re.search(r"(?<![A-Za-z0-9_])gn_kernel", names[0]), names
    assert "cg_opt_kernel" in names[1], names


def _cg_graph(name, dev):
    if name == "padded":
        poses, edges, _ = ring_graph(3, seed=5)
        return pg.build_data(poses, edges, 2, device=dev)
    if name == "fixed_inside":
        return pg.build_data(*ring_graph(40, seed=3, loop_every=8, fixed=5), device=dev)
    return _ring(int(name.split("_")[1]), dev)


@pytest.mark.parametrize("name", ["ring_1024", "ring_256", "padded", "fixed_inside"])
def test_cg_optimize_is_the_queued_chain(dev, name):
    data = _cg_graph(name, dev)
    steps = torch.zeros(25, dtype=torch.int32, device=dev)
    T = pgk.pose_graph_cg_cuda(data, 25, 1.0, pg.LAM + 1e-6, 100, steps=steps)
    assert torch.equal(T, pg.optimize_cg_queued(data, 25))
    assert torch.equal(T, pg.optimize(data, 25, solver="cg"))
    T0 = pg.optimize_plain(data, 25, solver="cg")
    scale = max(float(T0[:, :3, 3].abs().max()), 1.0)
    assert float(torch.max(torch.abs(T - T0))) < 1e-3 * scale
    s = steps.tolist()
    assert all(0 <= k <= 100 for k in s) and s[0] > 0, s
    fixed = int(data.fixed_node)
    assert torch.equal(T[fixed], data.T_wc[fixed])


@pytest.mark.parametrize("name", ["ring_1024", "fixed_inside"])
def test_cg_optimize_many_runs_are_bit_equal(dev, name):
    """Many resident CG optimizes back to back give the same poses and the
    same CG steps: every block reads each dot product's partials before
    any block writes them again, so no warp leaves the loop on other bits
    (which would hang the grid or change the result)."""
    data = _cg_graph(name, dev)
    steps = torch.zeros(64, 25, dtype=torch.int32, device=dev)
    Ts = [pgk.pose_graph_cg_cuda(data, 25, steps=steps[k]) for k in range(64)]
    for k in range(1, 64):
        assert torch.equal(Ts[k], Ts[0]), k
    assert torch.equal(steps, steps[:1].expand_as(steps))


def test_cg_optimize_stamps(dev):
    """The resident CG optimize's phase stamps on the same bits (two
    barriers a CG step, two an iteration, one for the incidence lists)."""
    data = _ring(1024, dev)
    steps = torch.zeros(25, dtype=torch.int32, device=dev)
    timers = torch.zeros(len(pgk.CG_STAMPS), dtype=torch.int64, device=dev)
    T = pgk.pose_graph_cg_cuda(data, 25, steps=steps, timers=timers)
    stamps = dict(zip(pgk.CG_STAMPS, timers.tolist()))
    assert torch.equal(T, pg.optimize(data, 25, solver="cg"))
    assert stamps["steps"] == int(steps.sum()) and stamps["total"] > 0
    assert stamps["barriers"] == 2 * 25 + 1 + 2 * stamps["steps"]


def test_k7_grid_is_resident(dev):
    """K7's cooperative grid: every block resident, at most kGnBlocksPerSm
    blocks an SM, at the largest dense bucket too."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for N, E in ((16, 16), (128, 256), (512, 1024)):
        grid = pgk.gn_grid(N, E)
        assert grid["blocks_per_sm"] >= 1 and grid["blocks"] == sms * min(grid["blocks_per_sm"], 1)
    timers = torch.zeros(len(pgk.GN_STAMPS), dtype=torch.int64, device=dev)
    pgk.gn_barriers_cuda(100, timers)
    stamps = dict(zip(pgk.GN_STAMPS, timers.tolist()))
    assert stamps["barriers"] == 100 and stamps["total"] > 0
