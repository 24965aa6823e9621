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
described below, then the pipelined front end's dispatch of K2-LM
(no host synchronisation, a double buffer that two queued dispatches do
not overwrite), a CPU checkpoint resumed on the card, and last K2-LM and
K3-LM over S stacked sequences in one launch (S = 1, 3, 8: each
sequence's rows the bits of its own launch; strides 0 the bits of a
stack of one; the batched step one launch of each).

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
from torch_k1_cases import K1_CASES, K1_GRIDS, k1_points

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


@pytest.mark.parametrize("h2,w2,n,case", [(7, 9, 0, "random"), (33, 65, 50, "random"),
                                          (48, 80, 3000, "random"),
                                          (184, 616, 8192, "random")]
                         + [(h, w, 0, c) for h, w in K1_GRIDS for c in K1_CASES]
                         + [(184, 616, 0, c) for c in K1_CASES[3:]])
def test_distance_map_bit_equal(dev, h2, w2, n, case):
    if case == "random":
        rng = np.random.RandomState(h2 * w2 + n)
        pu = rng.uniform(-5, w2 + 5, n).astype(np.float32)
        pv = rng.uniform(-5, h2 + 5, n).astype(np.float32)
        pu[: n // 4] = np.floor(pu[: n // 4]) + 0.5      # round-half-to-even ties
        pts = (pu, pv, rng.rand(n) < 0.7)
    else:
        pts = k1_points(case, h2, w2)
    args = [torch.as_tensor(a, device=dev) for a in pts]
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


# The redesigned step: every thread of K2-LM / K4-LM solves the damped
# system in registers. The test entry point runs the same device solve on
# a batch of systems, one thread each, against the plain
# models/tracker._solve_inc (torch.linalg.solve_ex, LAPACK's getrf) in f32
# on the CPU. Tolerance: the two LUs round in other places (LAPACK scales
# a column by the pivot's reciprocal; the kernel divides, and fuses
# multiply-adds), so on well-conditioned systems each increment agrees
# within 1e-4 x the largest |entry| of the system's increment.


def _systems(seed, n):
    """n damped systems like the tracker's: H = J^T J / m over 40 random
    rows, g = J^T r / m, lam in [1e-3, 1]."""
    rng = np.random.RandomState(seed)
    J = rng.randn(n, 40, 8).astype(np.float32)
    J[..., 6] *= 0.3
    r = rng.randn(n, 40).astype(np.float32)
    H = np.einsum("nki,nkj->nij", J, J) / 40.0
    g = np.einsum("nki,nk->ni", J, r) / 40.0
    lam = 10.0 ** rng.uniform(-3, 0, n)
    return [torch.as_tensor(a.astype(np.float32)) for a in (H, g, lam)]


def _plain_solve(H, g, lam, mode):
    cfg = _with_modes(make_config(LW, LH), *mode)
    return tr._solve_inc(H, g, lam, cfg)


def _lu_pivots(A):
    """The pivot rows of partial pivoting that takes the first largest
    |pivot| (LAPACK's isamax), in float64."""
    A = np.array(A, np.float64)
    m = A.shape[0]
    piv = []
    for k in range(m):
        p = k + int(np.argmax(np.abs(A[k:, k])))
        piv.append(p)
        A[[k, p]] = A[[p, k]]
        A[k + 1:, k:] -= np.outer(A[k + 1:, k] / A[k, k], A[k, k:])
    return piv


def _sub(mode):
    free = list(range(6)) + [6] * (mode[0] >= 0) + [7] * (mode[1] >= 0)
    return free


@pytest.mark.parametrize("mode", MODES)
def test_lm_solve_matches_solve_inc(dev, mode):
    H, g, lam = _systems(0, 257)
    got, piv = rlm.lm_solve_cuda(H.to(dev), g.to(dev), lam.to(dev), *mode)
    want = _plain_solve(H, g, lam, mode)
    got = got.cpu()
    scale = want.abs().amax(dim=1, keepdim=True)
    assert bool(((got - want).abs() <= 1e-4 * scale).all()), float(
        ((got - want).abs() / scale).max())
    free = _sub(mode)
    assert bool((got[:, [k for k in range(8) if k not in free]] == 0).all())
    # the pivots: those of the first largest |pivot| over the damped block
    for i in range(0, 257, 32):
        Hl = H[i] + lam[i] * torch.diag(torch.diagonal(H[i]))
        expect = _lu_pivots(Hl[free][:, free].numpy())
        assert piv[i, :len(free)].tolist() == expect
        assert piv[i, len(free):].tolist() == [-1] * (8 - len(free))


def test_lm_solve_singular_is_rejected(dev):
    """A system with a zero row and column (a parameter no residual sees)
    is singular also after damping: the increment is non-finite in the
    kernel and in the plain solve, so the LM's isfinite guard rejects the
    step in both."""
    H, g, lam = _systems(1, 8)
    H[:, 3, :] = 0.0
    H[:, :, 3] = 0.0
    for mode in MODES:
        got, _ = rlm.lm_solve_cuda(H.to(dev), g.to(dev), lam.to(dev), *mode)
        want = _plain_solve(H, g, lam, mode)
        assert not bool(torch.isfinite(got.sum(dim=1)).any())
        assert not bool(torch.isfinite(want.sum(dim=1)).any())


def test_lm_solve_tied_pivots_take_the_first(dev):
    """Column 0 holds +5 and -5 in rows 1 and 2 (and 1 on the diagonal):
    the kernel pivots on row 1, the first largest, and its increment
    agrees with the plain solve."""
    rng = np.random.RandomState(2)
    A = rng.uniform(-1, 1, (16, 8, 8)).astype(np.float32) + 4 * np.eye(8, dtype=np.float32)
    A[:, 0, 0] = 1.0
    A[:, 1, 0] = 5.0
    A[:, 2, 0] = -5.0
    H = torch.as_tensor(A)
    g = torch.as_tensor(rng.randn(16, 8).astype(np.float32))
    lam = torch.full((16,), 1e-3)
    got, piv = rlm.lm_solve_cuda(H.to(dev), g.to(dev), lam.to(dev), 0.0, 0.0)
    assert piv[:, 0].tolist() == [1] * 16
    for i in range(16):
        Hl = H[i] + lam[i] * torch.diag(torch.diagonal(H[i]))
        assert piv[i].tolist() == _lu_pivots(Hl.numpy())
    want = _plain_solve(H, g, lam, (0.0, 0.0))
    scale = want.abs().amax(dim=1, keepdim=True)
    assert bool(((got.cpu() - want).abs() <= 1e-4 * scale).all())


def test_lm_solve_ill_conditioned(dev):
    """H = Q diag(1 .. 1e-6) Q^T (condition 1e6): the kernel's LU is
    backward stable as the plain one is (relative residual |H x + g| /
    (|H| |x|) below 1e-5 in float64), and its increment is as close to the
    float64 solution as the plain f32 solve's, within 10x plus 1e-3."""
    rng = np.random.RandomState(3)
    n = 32
    Q = np.linalg.qr(rng.randn(n, 8, 8))[0]
    H = np.einsum("nij,j,nkj->nik", Q, np.logspace(0, -6, 8), Q).astype(np.float32)
    g = rng.randn(n, 8).astype(np.float32)
    lam = np.zeros(n, np.float32)
    H64, g64 = H.astype(np.float64), g.astype(np.float64)
    exact = np.linalg.solve(H64, -g64[..., None])[..., 0]
    Ht, gt, lt = (torch.as_tensor(a) for a in (H, g, lam))
    got, _ = rlm.lm_solve_cuda(Ht.to(dev), gt.to(dev), lt.to(dev), 0.0, 0.0)
    want = _plain_solve(Ht, gt, lt, (0.0, 0.0)).numpy().astype(np.float64)
    got = got.cpu().numpy().astype(np.float64)
    for x in (got, want):
        res = np.linalg.norm(np.einsum("nij,nj->ni", H64, x) + g64, axis=1)
        rel = res / (np.linalg.norm(H64, axis=(1, 2)) * np.linalg.norm(x, axis=1))
        assert np.all(rel < 1e-5), rel
    err = lambda x: np.linalg.norm(x - exact, axis=1) / np.linalg.norm(exact, axis=1)
    assert np.all(err(got) <= 10 * err(want) + 1e-3), (err(got), err(want))


def _lm_call(request, which, B):
    """(arguments, wrapper) of a resident LM call: K2-LM on B candidates,
    K4-LM on B seeds or K3-LM on B guesses (the live template of base
    8192)."""
    if which == "scale":
        return _scale_args(request.getfixturevalue("scale_scene"), "live", 8192, B), \
            rlm.scale_lm_cuda
    sc = request.getfixturevalue("scene")
    if which == "track":
        return _track_args(sc, sc["cfg"], _candidates(sc, B)), rlm.track_lm_cuda
    return _loop_args(sc, sc["cfg"], B), rlm.loop_pose_lm_cuda


@pytest.mark.parametrize("which,B", [("track", 1), ("track", 5), ("track", 78),
                                     ("loop_pose", 1), ("loop_pose", 6),
                                     ("scale", 1), ("scale", 8)])
def test_lm_bit_equal_with_phase_counters_on_and_off(request, which, B):
    """Two launches on the same inputs give the same bits, and so does a
    launch with the phase counters on; the counters are filled."""
    args, launch = _lm_call(request, which, B)
    a, b = launch(*args), launch(*args)
    timers = rlm.timer_buffer(B, torch.device("cuda"))
    c = launch(*args, timers=timers)
    for x, y, z in zip(a, b, c):
        x, y, z = (torch.nan_to_num(v, 7.0) for v in (x, y, z))
        assert torch.equal(x, y) and torch.equal(x, z)
    assert bool((timers[:, -2:] > 0).all())
    assert bool((timers[:, :-2].sum(dim=1) > 0).all())


def test_lm_one_launch_no_host_read(scene):
    """K2-LM and K4-LM are one kernel launch each with no host
    synchronisation."""
    targs = _track_args(scene, scene["cfg"], _candidates(scene, 5))
    largs = _loop_args(scene, scene["cfg"], 6)
    _no_sync(lambda: rlm.track_lm_cuda(*targs))
    _no_sync(lambda: rlm.loop_pose_lm_cuda(*largs))
    assert _launches(lambda: rlm.track_lm_cuda(*targs)) == ["dsslam_track_lm"]
    assert _launches(lambda: rlm.loop_pose_lm_cuda(*largs)) == ["dsslam_loop_pose_lm"]


def _sm_clock_mhz():
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


@pytest.mark.parametrize("which,B", [("track", 1), ("scale", 1), ("scale", 8)])
def test_phase_counters_cover_a_call(request, which, B):
    """The phase counters of a call (K2-LM on one candidate, K3-LM on one
    guess or the grid of 8), converted at the SM clock nvidia-smi reports,
    sum to within [0.8, 1.05] of the call's time on the card by CUDA
    events (median of 5), for the candidate whose phases take longest
    (the clusters run side by side). The call is queued behind a spin of
    the card, so the events time the card alone (the launch included),
    not the host's issue."""
    args, launch = _lm_call(request, which, B)
    timers = rlm.timer_buffer(B, torch.device("cuda"))
    ratios = []
    for _ in range(5):
        launch(*args)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(50_000_000)
        start.record()
        launch(*args, timers=timers)
        end.record()
        end.synchronize()
        phase_us = float(timers[:, :-2].sum(dim=1).max()) / _sm_clock_mhz()
        ratios.append(phase_us / (1e3 * start.elapsed_time(end)))
    assert 0.8 <= float(np.median(ratios)) <= 1.05, ratios


def test_track_lm_all_masked_level_runs_the_loops_passes(scene):
    """One candidate on a template whose level 1 is all masked: no term
    there (res inf, a NaN step rejected every iteration), and the kernel
    runs as many passes per level as the Python loop does."""
    t = scene["tmpl"]
    masks = list(t.pmask)
    masks[1] = torch.zeros_like(masks[1])
    tmpl = t._replace(pmask=tuple(masks))
    args = _track_args(scene, scene["cfg"], _candidates(scene, 1), tmpl)
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape[0])                       # the level's height
        return rh.pose_residual_pass(*a, **kw)

    ref = tr.track_candidates_batch_plain(*args, residual_pass=counted)
    o = rlm.track_lm_cuda(*args)
    got = tr.track_candidates_batch(*args)
    _same_track(got, args, scene["cfg"])
    assert bool(torch.isinf(got.res_per_level[:, 1]).all())
    assert bool(torch.isinf(ref.res_per_level[:, 1]).all())
    per_level = [sum(1 for h in calls if h == scene["pyr1"][l].shape[0]) for l in range(LL)]
    assert o.passes[0].tolist() == per_level


def test_loop_pose_lm_all_masked(scene):
    """Seeds over a point list whose lanes are all masked: every level has
    no term, each runs its pre-loop pass and max_iterations rejected steps,
    as the Python loops do, and no seed is ok."""
    args = list(_loop_args(scene, scene["cfg"], 6))
    args[5] = torch.zeros_like(args[5])
    got = pe.estimate_seeds(*args)
    o = rlm.loop_pose_lm_cuda(*args)
    assert not bool(got.ok.any())
    _same_seeds(got, tuple(args))
    its = scene["cfg"].tracker.max_iterations
    assert o.passes.tolist() == [[1 + its[l] for l in range(LL)]] * 6


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


@pytest.mark.parametrize("base", [8192, 512])
@pytest.mark.parametrize("G", [1, 8])
def test_scale_lm_skips_known_passes(scale_scene, base, G):
    """On the padded template every step is zeroed, so each level's trial
    would rerun the pass whose sums K3-LM holds: it runs fewer passes than
    the reference's loop counts (which it still reports per level), and
    its outputs are the loops' and the guesses themselves."""
    args = _scale_args(scale_scene, "padded", base, G)
    o = rlm.scale_lm_cuda(*args)
    _same_scale(o, args)
    assert torch.equal(o.scale, args[2])
    assert bool((o.run >= 1).all()) and bool((o.run < o.passes).all()), (o.run, o.passes)


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


# ---------------------------------------------------------------------------
# Checkpoint / resume across devices (runtime/checkpoint.py): a checkpoint
# the CPU wrote loads into a front end on the card, every state tensor
# moved there, and continues as the CPU front end continues. The loaded
# template is new to K2-LM's and K3-LM's parameter caches (they key on the
# template by weak reference), so the card's first track after the load
# builds its parameters afresh. The card's state saved again loads back
# onto the CPU bit for bit.

from direct_stereo_slam_tpu_torch.models.frontend import FrontEnd  # noqa: E402
from direct_stereo_slam_tpu_torch.runtime import checkpoint  # noqa: E402


def _state_tensors(fe):
    for tree in (fe.ba_state, fe.template, fe.immatures, *fe.pyramids.values()):
        for v in tree:
            yield from (v if isinstance(v, tuple) else (v,))


def test_cpu_checkpoint_resumes_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    dev = torch.device("cuda")
    ds = SyntheticStereoDataset(n_frames=11, width=LW, height=LH, speed=0.25)
    cfg = make_config(LW, LH, preset=0, mode=1)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=LL))
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], LW, LH, LL)
    frames = [ds.frame(i) for i in range(11)]

    def front_end(device):
        return FrontEnd(cfg, intr, intr, ds.t_cam1_cam0, device=device)

    def feed(fe, lo, hi):
        for i in range(lo, hi):
            fe.add_stereo_frame(frames[i]["img0"], frames[i]["img1"], i, 0.1 * i)

    host = front_end("cpu")
    feed(host, 0, 6)
    checkpoint.save_frontend(str(tmp_path / "cpu"), host)
    card = checkpoint.load_frontend(str(tmp_path / "cpu"), front_end(dev))
    tensors = list(_state_tensors(card))
    assert len(tensors) > 20 and all(t.device.type == "cuda" for t in tensors)
    before = rlm.track_lm_cuda.launches
    feed(card, 6, 11)
    feed(host, 6, 11)
    assert rlm.track_lm_cuda.launches - before >= 5
    assert card.initialized and not card.is_lost
    assert [s.is_kf for s in card.all_frames] == [s.is_kf for s in host.all_frames]
    t_card = np.stack([s.T_wc[:3, 3] for s in card.all_frames[6:]])
    t_host = np.stack([s.T_wc[:3, 3] for s in host.all_frames[6:]])
    assert np.abs(t_card - t_host).max() <= 1e-2

    checkpoint.save_frontend(str(tmp_path / "card"), card)
    back = checkpoint.load_frontend(str(tmp_path / "card"), front_end("cpu"))
    for a, b in zip(_state_tensors(back), _state_tensors(card)):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b.cpu()) or (a.is_floating_point() and torch.equal(
            torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b.cpu(), nan=7.0)))


# ---------------------------------------------------------------------------
# The sequence axis of K2-LM and K3-LM (parallel/mesh.py's batched step):
# S rendered sequences, each with its own template (frame 0) and pyramid
# (frame 1, and frame 0's right image for the scale), stacked [S, ...]. One
# launch over the stack must give, row for row, the bits of S launches on
# one sequence each (a sequence's clusters run the same code on the same
# data, only their pointers moved), and a stride of 0 (the front end's
# single-sequence call) the bits of a stack of one.

from direct_stereo_slam_tpu_torch.parallel import mesh as pm  # noqa: E402


@pytest.fixture(scope="module")
def seq_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    dev = torch.device("cuda")
    S = 8
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    budgets = dt.default_budgets(LW, LH, LL)
    rng = np.random.RandomState(9)
    tmpls, left, right, T_true = [], [], [], []
    for s in range(S):
        ds = SyntheticStereoDataset(n_frames=2, width=LW, height=LH, speed=0.2 + 0.04 * s,
                                    yaw_rate=0.004 * (s % 3), device=dev)
        f0, f1 = ds.frame(0), ds.frame(1)
        n = 3000
        us = rng.uniform(3, LW - 4, n).astype(np.float32)
        vs = rng.uniform(3, LH - 4, n).astype(np.float32)
        depth = f0["depth0"][vs.astype(int), us.astype(int)]
        tmpls.append(dt.build_template(t(us), t(vs), t((1.0 / depth).astype(np.float32)),
                                       t(np.ones(n, np.float32)), t(f0["img0"]), LL, budgets))
        left.append(f1["img0"])
        right.append(f0["img1"])
        T_true.append(np.linalg.inv(f1["pose_w_c0"]) @ f0["pose_w_c0"])
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], LW, LH, LL)
    cfg = make_config(LW, LH, preset=0, mode=1)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=LL))
    stack = dt.TrackerTemplate(*[tuple(torch.stack([tm[k][l] for tm in tmpls])
                                       for l in range(LL)) for k in range(5)])
    return dict(dev=dev, S=S, cfg=cfg, intr=intr, tmpl=stack, t10=ds.t_cam1_cam0,
                img0=t(np.stack(left)), img1=t(np.stack(right)),
                pyr0=tuple(build_pyramid(t(np.stack(left)), LL).data),
                pyr1=tuple(build_pyramid(t(np.stack(right)), LL).data),
                T_true=t(np.stack(T_true).astype(np.float32)))


def _first(sc, S):
    """The first S sequences: the stacked pyramid levels and template
    lists, and sequence s alone (contiguous copies of its slices)."""
    cut = lambda x: x[:S].contiguous()
    tmpl = dt.TrackerTemplate(*[tuple(cut(x) for x in leaf) for leaf in sc["tmpl"]])
    one = lambda s, pyr: (tuple(x[s].contiguous() for x in pyr),
                          dt.TrackerTemplate(*[tuple(x[s].contiguous() for x in leaf)
                                               for leaf in tmpl]))
    return tuple(cut(x) for x in sc["pyr0"]), tuple(cut(x) for x in sc["pyr1"]), tmpl, one


def _rows_equal(a, b):
    return torch.equal(torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0))


@pytest.mark.parametrize("S,C", [(1, 1), (3, 1), (3, 5), (8, 1)])
def test_track_lm_sequence_axis(seq_scene, S, C):
    """K2-LM over S sequences x C candidates in one launch: each sequence's
    rows are the bits of a launch on that sequence alone."""
    sc = seq_scene
    pyr0, _, tmpl, one = _first(sc, S)
    xi = torch.as_tensor(0.01 * np.random.RandomState(C).randn(S * C, 6).astype(np.float32),
                         device=sc["dev"])
    T = sc["T_true"][:S].repeat_interleave(C, 0) @ lie.se3_exp(xi)
    zero = tr.AffLight(0.0, 0.0)
    before = rlm.track_lm_cuda.launches
    got = rlm.track_lm_cuda(pyr0, tmpl, sc["intr"], sc["cfg"], T, zero, zero, 1.0, 1.0)
    assert rlm.track_lm_cuda.launches == before + 1
    for s in range(S):
        p, tm = one(s, pyr0)
        ref = rlm.track_lm_cuda(p, tm, sc["intr"], sc["cfg"], T[s * C:(s + 1) * C], zero,
                                zero, 1.0, 1.0)
        for x, y in zip(got, ref):
            assert _rows_equal(x[s * C:(s + 1) * C], y), s
    assert bool(torch.isfinite(got.res).all())


@pytest.mark.parametrize("S,G", [(1, 1), (3, 1), (3, 8), (8, 1)])
def test_scale_lm_sequence_axis(seq_scene, S, G):
    """K3-LM over S sequences x G guesses in one launch: each sequence's
    rows are the bits of a launch on that sequence alone."""
    sc = seq_scene
    _, pyr1, tmpl, one = _first(sc, S)
    guesses = (1.0,) if G == 1 else sc["cfg"].scale_opt.grid_guesses
    s0 = torch.tensor(guesses * S, dtype=torch.float32, device=sc["dev"])
    before = rlm.scale_lm_cuda.launches
    got = rlm.scale_lm_cuda(pyr1, tmpl, s0, sc["intr"], sc["intr"], sc["t10"], sc["cfg"])
    assert rlm.scale_lm_cuda.launches == before + 1
    for s in range(S):
        p, tm = one(s, pyr1)
        ref = rlm.scale_lm_cuda(p, tm, s0[s * G:(s + 1) * G], sc["intr"], sc["intr"],
                                sc["t10"], sc["cfg"])
        assert _rows_equal(got.rows[s * G:(s + 1) * G], ref.rows), s


def test_lm_stride_zero_is_a_stack_of_one(seq_scene):
    """The front end's call (levels [H, W, 3], lists [N]: strides 0) gives
    the bits of the same sequence as a stack of one."""
    sc = seq_scene
    pyr0, pyr1, tmpl, one = _first(sc, 1)
    p0, tm = one(0, pyr0)
    p1, _ = one(0, pyr1)
    zero = tr.AffLight(0.0, 0.0)
    T = sc["T_true"][:1]
    a = rlm.track_lm_cuda(p0, tm, sc["intr"], sc["cfg"], T, zero, zero, 1.0, 1.0)
    b = rlm.track_lm_cuda(pyr0, tmpl, sc["intr"], sc["cfg"], T, zero, zero, 1.0, 1.0)
    assert all(_rows_equal(x, y) for x, y in zip(a, b))
    s0 = torch.ones(1, device=sc["dev"])
    a = rlm.scale_lm_cuda(p1, tm, s0, sc["intr"], sc["intr"], sc["t10"], sc["cfg"])
    b = rlm.scale_lm_cuda(pyr1, tmpl, s0, sc["intr"], sc["intr"], sc["t10"], sc["cfg"])
    assert _rows_equal(a.rows, b.rows)
    p = rlm._track_params(p0, tm, sc["intr"], sc["cfg"])
    assert all(p.lv[l].img_stride == 0 and p.lv[l].pt_stride == 0 for l in range(LL))


def test_batched_step_one_launch_each(seq_scene):
    """make_batched_step on the card: one K2-LM and one K3-LM launch for the
    S sequences, and per sequence the single-sequence path's pose,
    residual, scale and error (track_candidate, optimize_scale_single on
    that sequence's own pyramid: within the LM agreement rule's 1e-3)."""
    sc = seq_scene
    S = sc["S"]
    step = pm.make_batched_step(sc["intr"], sc["cfg"], LL)
    T0 = torch.eye(4, device=sc["dev"]).expand(S, 4, 4)
    k2, k3 = rlm.track_lm_cuda.launches, rlm.scale_lm_cuda.launches
    out = step(sc["img0"], sc["img1"], sc["tmpl"], T0)
    assert (rlm.track_lm_cuda.launches - k2, rlm.scale_lm_cuda.launches - k3) == (1, 1)
    z = torch.zeros((), device=sc["dev"])
    for s in range(S):
        tm = dt.TrackerTemplate(*[tuple(x[s] for x in leaf) for leaf in sc["tmpl"]])
        r = tr.track_candidate(build_pyramid(sc["img0"][s], LL).data, tm, sc["intr"],
                               sc["cfg"], T0[s], tr.AffLight(z, z), tr.AffLight(z, z),
                               z + 1, z + 1)
        o = so.optimize_scale_single(build_pyramid(sc["img1"][s], LL).data, tm, sc["intr"],
                                     sc["intr"], pm._T10, sc["cfg"], 1.0)
        assert torch.allclose(out.T[s], r.T, atol=1e-3, rtol=0), s
        assert torch.allclose(out.res[s], r.res_per_level[0], rtol=1e-3), s
        assert torch.allclose(out.scale[s], o.scale, rtol=1e-3), s
        assert torch.allclose(out.scale_err[s], o.error, rtol=1e-3), s
