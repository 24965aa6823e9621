"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at shapes chip_smoke.py does not reach: empty and tiny point
lists, lists that are not a multiple of the block size, grids that are
not a multiple of the K1 tile, half-pixel ties, and the tracker's 78-pose
escalation batch, and for K4 (the loop estimator's pass over metric
points) stacks of 1 and 6 seeds over 8 and 2048 points, a list with every
lane masked and a seed of NaN. Tolerances are chip_smoke's: K1 bit-equal;
K2/K3/K4 H and b per entry within 1e-4 x max|entry|, statistics within
rel 1e-5.

These tests need a CUDA card and skip elsewhere. They import nothing of
JAX, so on the card's machine they run without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu_torch.geometry import lie
from direct_stereo_slam_tpu_torch.ops import distance_map as dm
from direct_stereo_slam_tpu_torch.ops import residual_hb as rh

pytestmark = pytest.mark.cuda

W, H = 160, 96
FX, FY, CX, CY = 120.0, 120.0, W / 2 - 0.5, H / 2 - 0.5
HUBER = 9.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _rel(got, want):
    scale = float(torch.max(torch.abs(want)).clamp(min=1e-30))
    return float(torch.max(torch.abs(got - want))) / scale


def _image(seed, dev):
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    img = (80 + 40 * np.sin(xs / 7.0 + rng.rand()) + 30 * np.cos(ys / 5.0)
           + 20 * rng.rand(H, W)).astype(np.float32)
    dx = np.zeros_like(img)
    dy = np.zeros_like(img)
    dx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    dy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return torch.as_tensor(np.stack([img, dx, dy], -1), device=dev)


def _points(seed, n, dev, live_frac=1.0):
    rng = np.random.RandomState(seed)
    pu = rng.uniform(3, W - 4, n).astype(np.float32)
    pv = rng.uniform(3, H - 4, n).astype(np.float32)
    pid = rng.uniform(0.05, 0.6, n).astype(np.float32)
    pc = rng.uniform(20, 230, n).astype(np.float32)
    live = np.arange(n) < int(n * live_frac)
    pid[~live] = 0.0
    return [torch.as_tensor(a, device=dev) for a in (pu, pv, pid, pc, live)]


@pytest.mark.parametrize("h2,w2,n", [(7, 9, 0), (33, 65, 50), (48, 80, 3000),
                                     (184, 616, 8192)])
def test_distance_map_bit_equal(dev, h2, w2, n):
    rng = np.random.RandomState(h2 * w2 + n)
    pu = rng.uniform(-5, w2 + 5, n).astype(np.float32)
    pv = rng.uniform(-5, h2 + 5, n).astype(np.float32)
    pu[: n // 4] = np.floor(pu[: n // 4]) + 0.5      # round-half-to-even ties
    args = [torch.as_tensor(a, device=dev) for a in (pu, pv, rng.rand(n) < 0.7)]
    before = dm.build_distance_map_cuda.launches
    got = dm.build_distance_map(*args, h2, w2)
    assert dm.build_distance_map_cuda.launches == before + 1
    assert torch.equal(got, dm.build_distance_map_plain(*args, h2, w2))
    cpu = dm.build_distance_map_plain(*[a.cpu() for a in args], h2, w2)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("n,B,flow", [(1, 1, True), (300, 5, True),
                                      (8192 + 17, 1, True), (2048, 78, False)])
def test_pose_pass_matches_plain(dev, n, B, flow):
    img = _image(n, dev)
    pts = _points(n, n, dev, live_frac=0.8)
    Ki = torch.linalg.inv(torch.tensor([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]],
                                       device=dev))
    gen = torch.Generator().manual_seed(B)
    xi = 0.03 * torch.randn(B, 6, generator=gen)
    T = torch.stack([lie.se3_exp(x) for x in xi]).to(dev)
    args = (img, *pts, T[:, :3, :3] @ Ki, Ki, T[:, :3, 3],
            torch.linspace(0.9, 1.1, B, device=dev), torch.linspace(-3, 3, B, device=dev),
            torch.tensor(1.5, device=dev), FX, FY, CX, CY, HUBER,
            torch.linspace(15.0, 60.0, B, device=dev), flow)
    got = rh.pose_residual_pass(*args)
    want = rh.pose_residual_pass_plain(*args)
    assert _rel(got.H, want.H) <= 1e-4 and _rel(got.b, want.b) <= 1e-4
    for g, w in zip(list(got.stats) + [got.num_in], list(want.stats) + [want.num_in]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,G", [(1, 1), (300, 8), (4096 + 5, 8)])
def test_scale_pass_matches_plain(dev, n, G):
    img = _image(n + 1, dev)
    pts = _points(n + 1, n, dev)
    Ki = torch.linalg.inv(torch.tensor([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]],
                                       device=dev))
    scales = torch.linspace(0.5, 2.0, G, device=dev)
    args = (img, *pts, Ki, Ki, torch.tensor([-0.54, 0.01, 1e-3], device=dev),
            scales if G > 1 else scales[0], FX, FY, CX, CY, HUBER,
            torch.full((G,), 20.0, device=dev) if G > 1 else 20.0)
    got = rh.scale_residual_pass(*args)
    want = rh.scale_residual_pass_plain(*args)
    assert torch.isfinite(want.H).all()
    assert _rel(got.H, want.H) <= 1e-4 and _rel(got.b, want.b) <= 1e-4
    for g, w in zip(got.stats, want.stats):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_nan_coordinate_propagates_like_plain(dev):
    """A NaN pixel coordinate on one lane (masked or not) makes the plain
    version's sums NaN (0 * NaN); the kernels must give NaN in the same
    entries, not clamp the coordinate to 0."""
    img = _image(3, dev)
    pts = _points(3, 300, dev)
    pts[0][7] = float("nan")
    Ki = torch.linalg.inv(torch.tensor([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]],
                                       device=dev))
    pose = (img, *pts, Ki, Ki, torch.zeros(3, device=dev), torch.tensor(1.0, device=dev),
            torch.tensor(0.0, device=dev), torch.tensor(0.0, device=dev), FX, FY, CX, CY,
            HUBER, torch.tensor(20.0, device=dev), True)
    scale = (img, *pts, Ki, Ki, torch.tensor([-0.54, 0.01, 1e-3], device=dev),
             torch.linspace(0.5, 2.0, 8, device=dev), FX, FY, CX, CY, HUBER,
             torch.full((8,), 20.0, device=dev))
    for got, want in ((rh.pose_residual_pass(*pose), rh.pose_residual_pass_plain(*pose)),
                      (rh.scale_residual_pass(*scale), rh.scale_residual_pass_plain(*scale))):
        assert torch.isnan(want.H).any()
        for g, w in ((got.H, want.H), (got.b, want.b), (got.stats.E, want.stats.E)):
            assert torch.equal(torch.isnan(g), torch.isnan(w))


def test_wrappers_raise_on_non_f32(dev):
    """The kernels read f32: a float64 point list raises instead of being
    read as garbage."""
    img = _image(0, dev)
    pts = _points(0, 64, dev)
    pts[0] = pts[0].double()
    Ki = torch.eye(3, device=dev)
    with pytest.raises(TypeError):
        rh.pose_residual_pass(img, *pts, Ki, Ki, torch.zeros(3, device=dev), 1.0,
                              0.0, 0.0, FX, FY, CX, CY, HUBER, 20.0)


def test_wrappers_raise_on_mixed_devices(dev):
    """A CUDA image with points left on the CPU raises; nothing falls back."""
    img = _image(0, dev)
    pts = _points(0, 64, torch.device("cpu"))
    Ki = torch.eye(3, device=dev)
    with pytest.raises(ValueError):
        rh.pose_residual_pass(img, *pts, Ki, Ki, torch.zeros(3, device=dev), 1.0,
                              0.0, 0.0, FX, FY, CX, CY, HUBER, 20.0)
    with pytest.raises(ValueError):
        dm.build_distance_map(torch.zeros(4, device=dev), torch.zeros(4),
                              torch.ones(4, dtype=torch.bool, device=dev), 8, 8)


def _points3d(seed, n, dev, live_frac=1.0):
    """Metric points in front of the camera; padded lanes as the loop
    handler pads them (x = y = 0, z = 1, colour 0, mask False)."""
    rng = np.random.RandomState(seed)
    z = rng.uniform(2.0, 15.0, n)
    px = ((rng.uniform(3, W - 4, n) - CX) / FX * z).astype(np.float32)
    py = ((rng.uniform(3, H - 4, n) - CY) / FY * z).astype(np.float32)
    pz = z.astype(np.float32)
    pc = rng.uniform(20, 230, n).astype(np.float32)
    live = np.arange(n) < int(n * live_frac)
    px[~live] = py[~live] = pc[~live] = 0.0
    pz[~live] = 1.0
    return [torch.as_tensor(a, device=dev) for a in (px, py, pz, pc, live)]


def _seed_stack(S, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    xi = 0.05 * torch.randn(S, 6, generator=gen)
    xi[0] = 0.0
    return torch.stack([lie.se3_exp(x) for x in xi]).to(dev)


def _pose3d_args(img, pts, T, dev):
    S = T.shape[0]
    return (img, *pts, T[:, :3, :3].contiguous(), T[:, :3, 3].contiguous(),
            torch.linspace(0.95, 1.05, S, device=dev),
            torch.linspace(-2.0, 2.0, S, device=dev), torch.zeros((), device=dev),
            FX, FY, CX, CY, HUBER, torch.linspace(20.0, 60.0, S, device=dev))


def _check_pose3d(got, want):
    assert _rel(got.H, want.H) <= 1e-4 and _rel(got.b, want.b) <= 1e-4
    for g, w in zip(list(got.stats) + [got.num_in], list(want.stats) + [want.num_in]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S", [1, 6])
@pytest.mark.parametrize("n,live_frac", [(8, 1.0), (2048, 1.0), (2048, 0.7)])
def test_pose3d_pass_matches_plain(dev, S, n, live_frac):
    img = _image(n + S, dev)
    pts = _points3d(n + S, n, dev, live_frac)
    args = _pose3d_args(img, pts, _seed_stack(S, dev, S), dev)
    before = rh.pose3d_residual_pass_cuda.launches
    got = rh.pose3d_residual_pass(*args)
    assert rh.pose3d_residual_pass_cuda.launches == before + 1
    want = rh.pose3d_residual_pass_plain(*args)
    assert float(want.num_in.min()) > 0
    _check_pose3d(got, want)


def test_pose3d_pass_all_lanes_masked(dev):
    """No live lane: every sum is zero, as in the plain version."""
    img = _image(5, dev)
    pts = _points3d(5, 2048, dev, live_frac=0.0)
    args = _pose3d_args(img, pts, _seed_stack(6, dev), dev)
    got = rh.pose3d_residual_pass(*args)
    want = rh.pose3d_residual_pass_plain(*args)
    assert float(torch.abs(want.H).max()) == 0.0
    assert torch.equal(got.H, want.H) and torch.equal(got.b, want.b)
    for g, w in zip(list(got.stats) + [got.num_in], list(want.stats) + [want.num_in]):
        assert torch.equal(g, w)


def test_pose3d_pass_nan_seed(dev):
    """A seed of NaN (a diverged LM step) gives NaN exactly where the plain
    version does, and leaves the other seeds' sums untouched."""
    img = _image(6, dev)
    pts = _points3d(6, 2048, dev)
    T = _seed_stack(6, dev)
    T[3] = float("nan")
    args = _pose3d_args(img, pts, T, dev)
    got = rh.pose3d_residual_pass(*args)
    want = rh.pose3d_residual_pass_plain(*args)
    for g, w in ((got.H, want.H), (got.b, want.b), (got.stats.E, want.stats.E),
                 (got.num_in, want.num_in)):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
    ok = torch.arange(6, device=dev) != 3
    _check_pose3d(type(got)(*[type(f)(*[x[ok] for x in f]) if isinstance(f, tuple)
                              else f[ok] for f in got]),
                  type(want)(*[type(f)(*[x[ok] for x in f]) if isinstance(f, tuple)
                               else f[ok] for f in want]))
