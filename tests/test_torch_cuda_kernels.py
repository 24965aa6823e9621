"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at shapes chip_smoke.py does not reach: empty and tiny point
lists, lists that are not a multiple of the block size, grids that are
not a multiple of the K1 tile, half-pixel ties, points clipped onto the
border and points in a neighbouring tile's halo, and the tracker's
78-pose escalation batch, and for K4 (the loop estimator's pass over
metric points) stacks of 1 and 6 seeds over 8 and 2048 points, a list
with every lane masked and a seed of NaN. Tolerances are chip_smoke's: K1
bit-equal; K2/K3/K4 H and b per entry within 1e-4 x max|entry|,
statistics within rel 1e-5. K1 and K3-LM are also shown to be one kernel
launch with no host synchronisation. The resident LM kernels' part is
described below, and last the pipelined front end's dispatch of K2-LM
(no host synchronisation, a double buffer that two queued dispatches do
not overwrite).

These tests need a CUDA card and skip elsewhere. They import nothing of
JAX, so on the card's machine they run without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

from functools import partial

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


# aten operators that make views or allocate, and launch no kernel
KERNEL_FREE = {"aten::view", "aten::view.dtype", "aten::detach", "aten::alias",
               "aten::empty.memory_format", "aten::select.int", "aten::slice.Tensor",
               "aten::_reshape_alias", "aten::as_strided"}


def _launches(fn):
    """(the port's kernel entry points fn() calls, the aten operators it
    dispatches): with the second all in KERNEL_FREE, the first is every
    kernel fn() launches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from direct_stereo_slam_tpu_torch.ops import _cuda

    entries, ops = [], []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.name())
            return func(*args, **(kwargs or {}))

    call = _cuda.call

    def counted(name, *args):
        entries.append(name)
        return call(name, *args)

    _cuda.call = counted
    try:
        with Record():
            fn()
    finally:
        _cuda.call = call
    assert set(ops) <= KERNEL_FREE, ops
    return entries


def _no_sync(fn):
    """fn() with every host synchronisation an error."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("h2,w2", [(70, 100), (184, 616)])
def test_distance_map_edges_one_launch(dev, h2, w2):
    """Points on and beside the 32-px tile borders (a neighbour's halo
    carries them), at half-pixel ties on the borders, far outside the grid
    (clipped onto its border rows and columns) and masked ones: bit-equal,
    in one kernel launch and no host synchronisation."""
    xs = np.array([31.4, 31.5, 32.5, 15.9, 16.1, 47.6, 48.4, 63.5, 64.5, -40.0,
                   w2 + 30.0, w2 - 0.5, 0.49, -0.5, 95.5, w2 - 1.5], np.float32)
    ys = np.array([0.5, 31.5, 33.0, 47.5, 16.5, -3.0, h2 + 7.0, 1.5, 32.5, 12.0,
                   40.0, h2 - 0.5, 63.49, 64.5, 2.5, -0.5], np.float32)
    mask = np.ones(len(xs), bool)
    mask[5] = False
    args = [torch.as_tensor(a, device=dev) for a in (xs, ys, mask)]
    got = _no_sync(lambda: dm.build_distance_map(*args, h2, w2))
    assert torch.equal(got, dm.build_distance_map_plain(*args, h2, w2))
    assert float(got.min()) == 0.0 and float(got.max()) == 16.0
    assert _launches(lambda: dm.build_distance_map(*args, h2, w2)) == ["dsslam_distance_map"]


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


# ---------------------------------------------------------------------------
# K2-LM / K4-LM: the resident LM kernels against their plain loops
# ---------------------------------------------------------------------------
#
# A rendered pair (320x192, 3 levels): the tracker's template from frame 0
# and frame 1's pyramid; the loop estimator's metric points from frame 0
# against frame 1's pyramid. Each kernel is held two ways: against the
# Python loop that drives the per-pass kernel (K2 / K4) on the card, and
# against the same loop over the plain passes. Tolerances (a candidate's
# sums are reduced in another order than the per-pass kernels reduce
# them, ~1e-6 relative, and the 8x8 solve and se3_exp run in another
# order than torch's): residuals per level within 1e-3 relative, poses
# within 1e-3 per matrix entry (m and rotation entries), the same `ok`;
# a candidate that sees no point keeps inf in both. In the 78-candidate
# escalation batch, rotation tries that start far from the optimum often
# run out of iterations at a coarse level, and one near-tie accept/reject
# decided the other way sends a candidate down another path. The rule is
# utils/lm_agreement.py's, as in chip_smoke.py: a candidate may differ
# only if the loops themselves differ on it when the points' lane order
# changes (measured in each test), and the winner must be the same.

from direct_stereo_slam_tpu_torch.config import make_config  # noqa: E402
from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics  # noqa: E402
from direct_stereo_slam_tpu_torch.io.synthetic import SyntheticStereoDataset  # noqa: E402
from direct_stereo_slam_tpu_torch.loop import pose_estimator as pe  # noqa: E402
from direct_stereo_slam_tpu_torch.models import depth_template as dt  # noqa: E402
from direct_stereo_slam_tpu_torch.models import tracker as tr  # noqa: E402
from direct_stereo_slam_tpu_torch.ops import resident_lm as rlm  # noqa: E402
from direct_stereo_slam_tpu_torch.ops.interp import bilinear_gather_scalar  # noqa: E402
from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid  # noqa: E402
from direct_stereo_slam_tpu_torch.utils import lm_agreement as lma  # noqa: E402

LW, LH, LL = 320, 192, 3
MODES = [(0.0, 0.0), (-1.0, -1.0), (0.0, -1.0), (-1.0, 0.0)]


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    dev = torch.device("cuda")
    ds = SyntheticStereoDataset(n_frames=2, width=LW, height=LH, speed=0.25, device=dev)
    f0, f1 = ds.frame(0), ds.frame(1)
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], LW, LH, LL)
    cfg = make_config(LW, LH, preset=0, mode=1)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=LL,
                                                    max_iterations=(10, 20, 50)))
    rng = np.random.RandomState(0)
    n = 3000
    us = rng.uniform(3, LW - 4, n).astype(np.float32)
    vs = rng.uniform(3, LH - 4, n).astype(np.float32)
    depth = f0["depth0"][vs.astype(int), us.astype(int)]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    tmpl = dt.build_template(t(us), t(vs), t((1.0 / depth).astype(np.float32)),
                             t(np.ones(n, np.float32)), t(f0["img0"]), LL,
                             dt.default_budgets(LW, LH, LL))
    pyr1 = tuple(build_pyramid(t(f1["img0"]), LL).data)
    pyr0 = tuple(build_pyramid(t(f0["img0"]), LL).data)
    T_true = (np.linalg.inv(f1["pose_w_c0"]) @ f0["pose_w_c0"]).astype(np.float32)
    # metric points of frame 0 with their intensity at every level
    k = 2048
    K0 = intr.K(0)
    z = depth[:k].astype(np.float64)
    xyz = np.stack([(us[:k] - K0[0, 2]) / K0[0, 0] * z,
                    (vs[:k] - K0[1, 2]) / K0[1, 1] * z, z], -1).astype(np.float32)
    cols = torch.stack([bilinear_gather_scalar(pyr0[l][..., 0], t(us[:k] / 2 ** l),
                                               t(vs[:k] / 2 ** l)) for l in range(LL)], 1)
    return dict(dev=dev, cfg=cfg, intr=intr, tmpl=tmpl, pyr1=pyr1, T_true=T_true,
                xyz=t(xyz), cols=cols.contiguous(), t=t)


def _with_modes(cfg, ma, mb, **kw):
    import dataclasses
    return cfg.replace(tracker=dataclasses.replace(cfg.tracker, affine_mode_a=ma,
                                                   affine_mode_b=mb, **kw))


def _candidates(sc, B):
    """The frontend's batches: the first try, the 5 motion tries and the
    78 rotation tries around the true motion, plus one candidate 100 m
    behind the points (every point behind the camera: no term, NaN step)."""
    slast = lie.se3_exp_np([0.02, -0.01, 0.05, 0.01, -0.005, 0.002])
    stage1, stage2 = tr.make_motion_tries(np.eye(4), sc["T_true"].astype(np.float64),
                                          slast, sc["cfg"])
    batch = {1: stage1[:1], 5: stage1, 78: stage2}[B].copy()
    if B > 1:
        batch[-1, 2, 3] -= 100.0
    return sc["t"](batch)


def _track_args(sc, cfg, T, tmpl=None):
    dev = sc["dev"]
    zero = torch.zeros((), device=dev)
    aff0 = tr.AffLight(torch.tensor(0.01, device=dev), torch.tensor(-0.5, device=dev))
    return (sc["pyr1"], tmpl or sc["tmpl"], sc["intr"], cfg, T, aff0,
            tr.AffLight(zero, zero + 0.3), torch.tensor(1.0, device=dev),
            torch.tensor(1.1, device=dev))


def _winner(r, cfg):
    """select_winner on host copies, as the front end calls it."""
    host = tr.TrackResult(T=r.T.cpu().numpy(), aff=None,
                          res_per_level=r.res_per_level.cpu().numpy(),
                          flow=r.flow.cpu().numpy(), ok=r.ok.cpu().numpy())
    return tr.select_winner(host, 1e9, cfg)


TRACK_LOOPS = (tr.track_candidates_batch_plain,
               partial(tr.track_candidates_batch_plain,
                       residual_pass=rh.pose_residual_pass_plain))


def _same_track(got, args, cfg):
    """K2-LM's batch against the Python loop over K2 and over plain passes
    by the measured rule, and the same winner."""
    refs = {"K2 loop": TRACK_LOOPS[0](*args), "plain": TRACK_LOOPS[1](*args)}
    agr = lma.check(got, refs, lma.reordered_track_runs(args, TRACK_LOOPS))
    assert agr.ok, str(agr)
    for ref in refs.values():
        assert _winner(got, cfg) == _winner(ref, cfg)
    return str(agr)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B", [1, 5, 78])
def test_track_lm_matches_loops(scene, mode, B):
    cfg = _with_modes(scene["cfg"], *mode)
    args = _track_args(scene, cfg, _candidates(scene, B))
    k2, lm = rh.pose_residual_pass_cuda.launches, rlm.track_lm_cuda.launches
    got = tr.track_candidates_batch(*args)
    assert rlm.track_lm_cuda.launches == lm + 1
    assert rh.pose_residual_pass_cuda.launches == k2
    print(B, mode, _same_track(got, args, cfg))
    if B > 1:
        assert bool(torch.isinf(got.res_per_level[-1]).all())   # behind the camera
        assert not bool(got.ok[-1])
    assert _winner(got, cfg)[1]


def test_track_lm_cutoff_doubling_and_level_repeat(scene):
    """A cutoff of 5 gray levels saturates most residuals: the pre-loop
    doubles it and the level repeat runs. For one candidate the kernel
    runs as many passes per level as the Python loop does."""
    cfg = _with_modes(scene["cfg"], 0.0, 0.0, coarse_cutoff_th=5.0)
    args = _track_args(scene, cfg, _candidates(scene, 1))
    got = tr.track_candidates_batch(*args)
    calls = []

    def counted(*a, **kw):
        calls.append((a[0].shape[0], float(a[-1])))     # level height, cutoff
        return rh.pose_residual_pass(*a, **kw)

    tr.track_candidates_batch_plain(*args, residual_pass=counted)
    _same_track(got, args, cfg)
    assert max(c for _, c in calls) > 5.0                   # the cutoff doubled
    o = rlm.track_lm_cuda(*args)
    per_level = [sum(1 for h, _ in calls if h == scene["pyr1"][l].shape[0])
                 for l in range(LL)]
    assert o.passes[0].tolist() == per_level


def test_track_lm_masked_level(scene):
    """A level whose lanes are all masked has no term: res = inf there."""
    t = scene["tmpl"]
    masks = list(t.pmask)
    masks[1] = torch.zeros_like(masks[1])
    tmpl = t._replace(pmask=tuple(masks))
    args = _track_args(scene, scene["cfg"], _candidates(scene, 5), tmpl)
    got = tr.track_candidates_batch(*args)
    assert bool(torch.isinf(got.res_per_level[:, 1]).all())
    assert not bool(got.ok.any())
    _same_track(got, args, scene["cfg"])
    # the masked level's LM never breaks (its step is NaN): max_iterations
    o = rlm.track_lm_cuda(*args)
    assert float(o.passes[0, 1]) == 1 + scene["cfg"].tracker.max_iterations[1]


@pytest.mark.parametrize("B", [1, 78])
def test_track_lm_bit_equal_run_to_run(scene, B):
    args = _track_args(scene, scene["cfg"], _candidates(scene, B))
    a, b = rlm.track_lm_cuda(*args), rlm.track_lm_cuda(*args)
    for x, y in zip(a, b):
        assert torch.equal(torch.nan_to_num(x, 7.0), torch.nan_to_num(y, 7.0))


def _seeds(sc, S):
    T = sc["T_true"].astype(np.float64)
    behind = T.copy()
    behind[2, 3] -= 100.0
    stack = pe.make_seed_stack(T, (behind,), (3.0, -3.0, 6.0, -6.0))
    return sc["t"](stack[:S])


def _loop_args(sc, cfg, S, k=2048):
    xyz, cols = sc["xyz"], sc["cols"]
    live = torch.arange(xyz.shape[0], device=sc["dev"]) < k
    x = torch.where(live[:, None], xyz, torch.tensor([0.0, 0.0, 1.0], device=sc["dev"]))
    c = torch.where(live[:, None], cols, torch.zeros_like(cols))
    return (sc["pyr1"], x[:, 0].contiguous(), x[:, 1].contiguous(), x[:, 2].contiguous(),
            c.contiguous(), live, _seeds(sc, S), sc["intr"], cfg)


SEED_LOOPS = (pe.estimate_seeds_plain,
              partial(pe.estimate_seeds_plain, residual_pass=rh.pose3d_residual_pass_plain))


def _same_seeds(got, args):
    """K4-LM's stack against the Python loop over K4 and over plain passes
    by the measured rule."""
    refs = {"K4 loop": SEED_LOOPS[0](*args), "plain": SEED_LOOPS[1](*args)}
    agr = lma.check(got, refs, lma.reordered_seed_runs(args, SEED_LOOPS))
    assert agr.ok, (str(agr), got.pose_error, [r.pose_error for r in refs.values()])
    return str(agr)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("S,k", [(1, 2048), (6, 2048), (6, 1500)])
def test_loop_pose_lm_matches_loops(scene, mode, S, k):
    cfg = _with_modes(scene["cfg"], *mode)
    args = _loop_args(scene, cfg, S, k)
    k4, lm = rh.pose3d_residual_pass_cuda.launches, rlm.loop_pose_lm_cuda.launches
    got = pe.estimate_seeds(*args)
    assert rlm.loop_pose_lm_cuda.launches == lm + 1
    assert rh.pose3d_residual_pass_cuda.launches == k4
    print(S, k, mode, _same_seeds(got, args))
    assert bool(got.ok[0])
    if S == 6:
        assert float(got.inlier_ratio[1]) == 0.0 and not bool(got.ok[1])


def test_loop_pose_lm_bit_equal_and_one_launch_per_batch(scene):
    args = _loop_args(scene, scene["cfg"], 6)
    a, b = rlm.loop_pose_lm_cuda(*args), rlm.loop_pose_lm_cuda(*args)
    for x, y in zip(a, b):
        assert torch.equal(torch.nan_to_num(x, 7.0), torch.nan_to_num(y, 7.0))
    lm = rlm.loop_pose_lm_cuda.launches
    pe.estimate_batch(*args)
    assert rlm.loop_pose_lm_cuda.launches == lm + 1


def test_lm_clusters_fit(scene):
    """Several 8-block clusters of each LM kernel fit on the card at once."""
    assert rlm.max_active_clusters("track", 8192) >= 2
    assert rlm.max_active_clusters("scale", 8192) >= 2
    assert rlm.max_active_clusters("loop_pose", 2048) >= 2


# ---------------------------------------------------------------------------
# K3-LM: the stereo scale LM against its plain loops
# ---------------------------------------------------------------------------
#
# Frame 0 of the rendered pair: templates of the left image on budgets of
# base 8192 and 512, against the right image's pyramid. "live" templates
# have every lane live at sub-pixel positions with idepths wrong by 1.6, so
# the LM moves; "padded" ones are the same with the last fifth of each
# level padded as build_template pads (pid = 0, colour 0, mask False),
# which makes every pass's H and b NaN (each step zeroed and rejected).
# Sub-pixel positions keep rows off the strict Kv bounds, where one
# rounding of the plain passes' unfused multiply-adds could move a whole
# row (ROADMAP §3, exact-row ties). One guess (the trapped case) and the
# front end's grid of 8. K3-LM is held against the Python loop over the
# per-pass K3 and over plain passes by utils/lm_agreement.py's rule (scale
# and error within 1e-3 relative; a guess may differ only where the loops
# differ among themselves when the lanes are reordered), with the same
# accept/trap decision and the chosen scale and error within 1e-3.

from direct_stereo_slam_tpu_torch.models import scale_opt as so  # noqa: E402

SCALE_LOOPS = (so.optimize_scale_batch_plain,
               partial(so.optimize_scale_batch_plain,
                       residual_pass=rh.scale_residual_pass_plain))


@pytest.fixture(scope="module")
def scale_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    dev = torch.device("cuda")
    ds = SyntheticStereoDataset(n_frames=1, width=LW, height=LH, device=dev)
    f0 = ds.frame(0)
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], LW, LH, LL)
    cfg = make_config(LW, LH, preset=0, mode=1)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=LL,
                                                    max_iterations=(10, 20, 50)))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    img0 = t(f0["img0"])
    pyr0 = tuple(build_pyramid(img0, LL).data)
    depth = f0["depth0"]
    rng = np.random.RandomState(5)
    templates = {}
    for base in (8192, 512):
        budgets = dt.default_budgets(LW, LH, LL, base=base)
        cols = {k: [] for k in dt.TrackerTemplate._fields}
        for lvl, n in enumerate(budgets):
            u = rng.uniform(4, (LW >> lvl) - 5, n).astype(np.float32)
            v = rng.uniform(4, (LH >> lvl) - 5, n).astype(np.float32)
            d = depth[(v * (1 << lvl)).astype(int), (u * (1 << lvl)).astype(int)]
            cols["pu"].append(t(u))
            cols["pv"].append(t(v))
            cols["pid"].append(t((1.6 / d).astype(np.float32)))
            cols["pcolor"].append(bilinear_gather_scalar(pyr0[lvl][..., 0], t(u), t(v)))
            cols["pmask"].append(torch.ones(n, dtype=torch.bool, device=dev))
        live = dt.TrackerTemplate(*[tuple(cols[k]) for k in dt.TrackerTemplate._fields])
        pad = [torch.arange(len(x), device=dev) >= 0.8 * len(x) for x in live.pu]
        templates[("live", base)] = live
        templates[("padded", base)] = live._replace(
            pid=tuple(torch.where(m, 0.0, x) for x, m in zip(live.pid, pad)),
            pcolor=tuple(torch.where(m, 0.0, x) for x, m in zip(live.pcolor, pad)),
            pmask=tuple(~m for m in pad))
    return dict(dev=dev, cfg=cfg, intr=intr, templates=templates, t10=ds.t_cam1_cam0,
                pyr_r=tuple(build_pyramid(t(f0["img1"]), LL).data))


def _scale_args(sc, kind, base, G, cfg=None):
    cfg = cfg or sc["cfg"]
    guesses = (1.0,) if G == 1 else cfg.scale_opt.grid_guesses
    return (sc["pyr_r"], sc["templates"][(kind, base)],
            torch.tensor(guesses, dtype=torch.float32, device=sc["dev"]), sc["intr"],
            sc["intr"], sc["t10"], cfg)


def _decision(r, cfg, trapped):
    """decide_scale_optimization on host copies: (accepted, the state
    after it, the chosen scale and error)."""
    state = so.ScaleState(trapped=trapped)
    accepted, scale, error, state = so.decide_scale_optimization(
        r.scale.cpu().numpy(), r.error.cpu().numpy(), cfg, state)
    return accepted, vars(state), (scale, error)


def _same_scale(got, args):
    """K3-LM's guesses against both loops by the measured rule, the same
    accept/trap decision and the same chosen scale and error."""
    refs = {"K3 loop": SCALE_LOOPS[0](*args), "plain": SCALE_LOOPS[1](*args)}
    agr = lma.check(got, refs, lma.reordered_scale_runs(args, SCALE_LOOPS))
    assert agr.ok, (str(agr), got.scale, [r.scale for r in refs.values()])
    cfg, trapped = args[-1], args[2].shape[0] == 1
    mine = _decision(got, cfg, trapped)
    for ref in refs.values():
        theirs = _decision(ref, cfg, trapped)
        assert mine[:2] == theirs[:2]
        assert mine[2] == pytest.approx(theirs[2], rel=1e-3)
    return agr


@pytest.mark.parametrize("kind", ["live", "padded"])
@pytest.mark.parametrize("base", [8192, 512])
@pytest.mark.parametrize("G", [1, 8])
def test_scale_lm_matches_loops(scale_scene, kind, base, G):
    args = _scale_args(scale_scene, kind, base, G)
    k3, lm = rh.scale_residual_pass_cuda.launches, rlm.scale_lm_cuda.launches
    got = so.optimize_scale_batch(*args)
    assert rlm.scale_lm_cuda.launches == lm + 1
    assert rh.scale_residual_pass_cuda.launches == k3
    _same_scale(got, args)
    if kind == "padded":             # NaN H and b: no guess moves
        assert torch.equal(got.scale, args[2])
    else:                            # the guess 1.0 recovers the factor 1.6
        one = list(args[2].tolist()).index(1.0)
        assert abs(float(got.scale[one]) - 1.6) / 1.6 < 0.05


@pytest.mark.parametrize("kind,cutoff", [("live", 2.0), ("padded", 20.0)])
def test_scale_lm_passes_per_level(scale_scene, kind, cutoff):
    """One guess runs as many passes per level as the Python loop: with a
    cutoff of 2 gray levels the pre-loop doubles it and the doubled level
    runs again (the one-shot repeat); on the padded template every pass's H
    is NaN, so every LM step is zeroed and rejected."""
    import dataclasses
    cfg = scale_scene["cfg"]
    cfg = cfg.replace(tracker=dataclasses.replace(cfg.tracker, coarse_cutoff_th=cutoff))
    args = _scale_args(scale_scene, kind, 8192, 1, cfg)
    calls = []

    def counted(*a, **kw):
        out = rh.scale_residual_pass(*a, **kw)
        calls.append((a[0].shape[0], float(a[-1]), bool(torch.isnan(out.H).all())))
        return out

    so.optimize_scale_batch_plain(*args, residual_pass=counted)
    o = rlm.scale_lm_cuda(*args)
    _same_scale(so.optimize_scale_batch(*args), args)
    per_level = [sum(1 for h, _, _ in calls if h == scale_scene["pyr_r"][l].shape[0])
                 for l in range(LL)]
    assert o.passes[0].tolist() == per_level
    if kind == "live":
        assert max(c for _, c, _ in calls) > cutoff and float(o.repeat[0].max()) > 1.0
    else:
        assert all(nan for _, _, nan in calls)


@pytest.mark.parametrize("G", [1, 8])
def test_scale_lm_bit_equal_one_launch_no_host_read(scale_scene, G):
    """Two launches give the same bits; optimize_scale_batch, and the front
    end's dispatch once its guesses are on the card, are one kernel launch
    with no host synchronisation."""
    args = _scale_args(scale_scene, "live", 8192, G)
    a, b = rlm.scale_lm_cuda(*args), rlm.scale_lm_cuda(*args)
    for x, y in zip(a, b):
        assert torch.equal(torch.nan_to_num(x, 7.0), torch.nan_to_num(y, 7.0))
    out = _no_sync(lambda: so.optimize_scale_batch(*args))
    assert torch.equal(out.scale, a.scale)
    assert _launches(lambda: so.optimize_scale_batch(*args)) == ["dsslam_scale_lm"]
    state = so.ScaleState(trapped=G == 1)
    disp = (args[0], args[1], args[3], args[4], args[5], args[6], state)
    so.dispatch_scale_optimization(*disp)            # puts the guesses on the card
    got = _no_sync(lambda: so.dispatch_scale_optimization(*disp))
    assert torch.equal(got.scale, a.scale)


# ---- pipelined tracking: the dispatch of frame N on the card -----------------
# A pipelined dispatch (frontend._pl_dispatch) launches K2-LM from the
# device motion state, packs the outputs and starts their copy into a
# pinned host buffer, without waiting for the device; two buffers are
# used in turn, so a second dispatch queued before the first is consumed
# does not overwrite it.

from direct_stereo_slam_tpu_torch.models import frontend as fe_mod  # noqa: E402
from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode  # noqa: E402


@pytest.fixture(scope="module")
def pl_frames():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    dev = torch.device("cuda")
    ds = SyntheticStereoDataset(n_frames=11, width=LW, height=LH, speed=0.25, device=dev)
    cfg = make_config(LW, LH, preset=0, mode=1)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=LL),
                      runtime=cfg.runtime.__class__(pipelined_tracking=True))
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], LW, LH, LL)
    return dict(dev=dev, ds=ds, cfg=cfg, intr=intr, frames=[ds.frame(i) for i in range(11)])


def _pipelined_front_end(pf):
    """A pipelined node on the card after 8 frames, with a device motion
    state; the three frames after them."""
    node = SLAMNode(pf["cfg"], pf["intr"], pf["intr"], pf["ds"].t_cam1_cam0, device=pf["dev"])
    for i, f in enumerate(pf["frames"][:8]):
        node.process(f["img0"], f["img1"], 0.1 * i)
    fe = node.frontend
    assert fe.initialized and not fe.is_lost and fe._pl_state is not None
    fe._views_np()                  # the host views the dispatch reads are current
    pyrs = [build_pyramid(fe._image(f["img0"]), LL) for f in pf["frames"][8:]]
    torch.cuda.synchronize()
    return fe, pyrs


def test_pipelined_dispatch_does_not_wait(pl_frames):
    """One dispatch (image upload included) runs with every host
    synchronisation an error, launches K2-LM once, and returns while the
    card is still busy with earlier work."""
    import time

    fe, pyrs = _pipelined_front_end(pl_frames)
    fe._pl_read(fe._pl_dispatch(pyrs[0])["out"])          # warm-up
    before = rlm.track_lm_cuda.launches
    img = pl_frames["frames"][9]["img0"]
    inf = _no_sync(lambda: fe._pl_dispatch(build_pyramid(fe._image(img), LL)))
    assert rlm.track_lm_cuda.launches == before + 1
    res, counts = fe._pl_read(inf["out"])
    assert np.isfinite(res.res_per_level).all() and bool(res.ok[0])
    assert counts.shape == (fe.n_slots,)
    # behind a ~0.2 s spin of the card, the dispatch returns long before it
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    inf = fe._pl_dispatch(pyrs[2])
    host = time.perf_counter() - t0
    assert not inf["out"][1].query() and host < 0.05, host
    fe._pl_read(inf["out"])


def test_two_dispatches_before_a_consume(pl_frames):
    """Frames N and N+1 both dispatched before either is read give what two
    synchronous tracks of the same candidates give, bit for bit: the
    second copy goes to the other pinned buffer."""
    fe, pyrs = _pipelined_front_end(pl_frames)
    Tl, Tp, aff = fe._pl_state
    exposure = fe_mod._host_f32(fe._cur_exposure)

    def track(pyr, T, a):
        r = tr.track_candidates_batch(tuple(pyr.data), fe.template, fe.intr0, fe.cfg, T[None],
                                      a, fe.template_ref_aff, fe.template_ref_exposure,
                                      exposure)
        return r, fe._read_track(r)

    ra_dev, (want_a, counts_a) = track(pyrs[0], fe_mod._const_motion_candidate(Tl, Tp), aff)
    _, (want_b, _) = track(pyrs[1], fe_mod._const_motion_candidate(ra_dev.T[0], Tl),
                           tr.AffLight(ra_dev.aff.a[0], ra_dev.aff.b[0]))
    ia = fe._pl_dispatch(pyrs[0])
    ib = fe._pl_dispatch(pyrs[1])
    assert ia["out"][0].data_ptr() != ib["out"][0].data_ptr()
    assert ia["out"][0].is_pinned() and ib["out"][0].is_pinned()
    (got_a, got_counts), (got_b, _) = fe._pl_read(ia["out"]), fe._pl_read(ib["out"])
    for got, want in ((got_a, want_a), (got_b, want_b)):
        for field in ("res_per_level", "flow", "T", "aff", "ok"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(got_counts, counts_a)
