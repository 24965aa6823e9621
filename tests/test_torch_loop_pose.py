"""Parity of the loop pose estimator with the JAX package.

1. Kernel K4's plain version (``pose3d_residual_pass_plain``, what the CPU
   takes) against the JAX ``pose3d_residual_pass`` seed by seed, for a
   stack of 1 and of 6 seeds, with padded lanes (mask False, z = 1) and a
   seed that projects no point: H and b per entry within 1e-4 x
   max|entry|, statistics within rel 1e-5 (K2's tolerances).
2. ``estimate_batch`` against the JAX version on keyframes of
   ``test_loop_handler.make_loop_stream`` (256x80, 4 levels), with the
   handler's seed stack (primary, odometry seed, 4 yaw perturbations):
   the same ``seed_ok`` and best seed, T within 1e-3 m / 1e-3 rad and
   pose_error within 1e-3 relative.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from direct_stereo_slam_tpu.geometry import lie as lie_j
from direct_stereo_slam_tpu.loop import pose_estimator as pe_j
from direct_stereo_slam_tpu.ops import residual_hb as rh_j
from direct_stereo_slam_tpu_torch.loop import pose_estimator as pe_t
from direct_stereo_slam_tpu_torch.ops import residual_hb as rh_t
from test_loop_handler import make_loop_stream
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W, H = 96, 64
FX, FY, CX, CY = 80.0, 80.0, W / 2 - 0.5, H / 2 - 0.5
HUBER = 9.0


def _image(seed):
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    img = (80 + 40 * np.sin(xs / 7.0 + rng.rand()) + 30 * np.cos(ys / 5.0)
           + 20 * rng.rand(H, W)).astype(np.float32)
    dx = np.zeros_like(img)
    dy = np.zeros_like(img)
    dx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    dy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return np.stack([img, dx, dy], -1)


def _points(seed, n=320, n_live=320):
    """Metric points in front of the camera; padded lanes as the handler
    pads them (x = y = 0, z = 1, colour 0, mask False)."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(3, W - 4, n)
    v = rng.uniform(3, H - 4, n)
    z = rng.uniform(2.0, 15.0, n)
    px = ((u - CX) / FX * z).astype(np.float32)
    py = ((v - CY) / FY * z).astype(np.float32)
    pz = z.astype(np.float32)
    pc = rng.uniform(20, 230, n).astype(np.float32)
    live = np.arange(n) < n_live
    px[~live] = py[~live] = pc[~live] = 0.0
    pz[~live] = 1.0
    return px, py, pz, pc, live


SEEDS = [np.zeros(6), [0.05, -0.02, 0.1, 0.01, -0.03, 0.005],
         [-0.1, 0.04, -0.2, -0.02, 0.05, 0.01], [0.2, 0.0, 0.3, 0.0, 0.1, 0.0],
         [0.0, 0.1, -0.1, 0.03, 0.0, -0.02],
         [0.0, 0.0, -100.0, 0.0, 0.0, 0.0]]    # all points behind the camera


@pytest.mark.parametrize("S", [1, 6])
@pytest.mark.parametrize("n_live", [320, 200])
def test_pose3d_pass_matches_reference(S, n_live):
    img = _image(S + n_live)
    px, py, pz, pc, live = _points(S, n_live=n_live)
    Ts = np.stack([np.asarray(lie_j.se3_exp(jnp.asarray(x, jnp.float32)))
                   for x in SEEDS[:S]])
    a = np.linspace(0.95, 1.05, S).astype(np.float32)
    b = np.linspace(-2.0, 2.0, S).astype(np.float32)
    cut = np.linspace(20.0, 60.0, S).astype(np.float32)
    t = lambda x: torch.as_tensor(x)
    out = rh_t.pose3d_residual_pass(t(img), t(px), t(py), t(pz), t(pc), t(live),
                                    t(Ts[:, :3, :3]), t(Ts[:, :3, 3]), t(a), t(b), 0.0,
                                    FX, FY, CX, CY, HUBER, t(cut))
    for s in range(S):
        ref = rh_j.pose3d_residual_pass(
            *[jnp.asarray(x) for x in (img, px, py, pz, pc, live, Ts[s, :3, :3],
                                       Ts[s, :3, 3])],
            jnp.float32(a[s]), jnp.float32(b[s]), jnp.float32(0.0), FX, FY, CX, CY,
            HUBER, jnp.float32(cut[s]))
        for got, want in ((out.H[s], ref.H), (out.b[s], ref.b)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-4 * max(np.abs(want).max(), 1e-30))
        for got, want in zip([x[s] for x in out.stats] + [out.num_in[s]],
                             list(ref.stats) + [ref.num_in]):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    if S == 6:
        # the seed behind the camera sees nothing: no terms, H = 0
        assert float(out.stats.num_terms[5]) == 0.0 and float(out.num_in[5]) == 0.0
        assert float(torch.abs(out.H[5]).max()) == 0.0


def test_pose3d_pass_unbatched_and_cpu_only():
    """A [3, 3] rotation gives unbatched outputs equal to the stack's row,
    and CPU tensors never touch the kernel's launch counter."""
    before = rh_t.pose3d_residual_pass_cuda.launches
    img = torch.as_tensor(_image(9))
    pts = [torch.as_tensor(x) for x in _points(9, n_live=250)]
    T = torch.as_tensor(np.array(lie_j.se3_exp(jnp.asarray(SEEDS[1], jnp.float32))))
    one = rh_t.pose3d_residual_pass(img, *pts, T[:3, :3], T[:3, 3], 1.0, 0.0, 0.0,
                                    FX, FY, CX, CY, HUBER, 30.0)
    stack = rh_t.pose3d_residual_pass(img, *pts, T[None, :3, :3], T[None, :3, 3],
                                      torch.ones(1), torch.zeros(1), 0.0,
                                      FX, FY, CX, CY, HUBER, torch.full((1,), 30.0))
    assert one.H.shape == (8, 8) and stack.H.shape == (1, 8, 8)
    assert torch.equal(one.H, stack.H[0]) and torch.equal(one.b, stack.b[0])
    assert rh_t.pose3d_residual_pass_cuda.launches == before


@pytest.fixture(scope="module")
def loop_stream():
    return make_loop_stream()


def _seed_stack(gt, est, cur, matched, cfg, noise):
    """The handler's stack: a primary near the true relative pose, the
    odometry seed, then yaw perturbations of the primary."""
    true_rel = np.linalg.inv(gt[cur]) @ gt[matched]
    D = np.asarray(lie_j.se3_exp(jnp.asarray(noise, jnp.float32)), np.float64)
    odo = np.linalg.inv(est[cur]).astype(np.float64) @ est[matched]
    return pe_t.make_seed_stack(true_rel @ D, (odo,), cfg.loop.seed_yaw_perturb_deg)


def _matched_points(mkf, cfg):
    kmax = cfg.loop.max_loop_points
    k = min(len(mkf.pts_cam), kmax)
    px = np.zeros(kmax, np.float32)
    py = np.zeros(kmax, np.float32)
    pz = np.ones(kmax, np.float32)
    cols = np.zeros((kmax, cfg.tracker.pyr_levels), np.float32)
    mask = np.zeros(kmax, bool)
    px[:k], py[:k], pz[:k] = mkf.pts_cam[:k, 0], mkf.pts_cam[:k, 1], mkf.pts_cam[:k, 2]
    cols[:k] = mkf.pts_colors[:k]
    mask[:k] = True
    return px, py, pz, cols, mask


def _angle(dR):
    """Rotation angle of a near-identity f32-composed matrix, from its
    skew part (the trace form is swamped by the loss of orthonormality)."""
    return float(np.linalg.norm(0.5 * np.array(
        [dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])))


def _best_index(errors, best_error):
    return int(np.flatnonzero(np.asarray(errors) == float(best_error))[0])


# (current KF, matched KF, noise on the primary): a revisit whose seeds
# mostly pass, one whose primary is off by a few degrees, a pair the
# handler tries and rejects (partial overlap: the fallback rule picks the
# seed closest to acceptance), and a pair that shares no view at all
@pytest.mark.parametrize("cur,matched,noise", [
    (30, 4, [0.05, 0.0, -0.05, 0.0, 0.01, 0.0]),
    (34, 8, [0.2, 0.02, 0.1, 0.01, 0.06, 0.0]),
    (11, 3, [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]),
    (20, 3, [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]),
])
def test_estimate_batch_matches_reference(loop_stream, cur, matched, noise):
    cfg, intr, stream, gt, est = loop_stream
    stack = _seed_stack(gt, est, cur, matched, cfg, noise)
    pts = _matched_points(stream[matched], cfg)
    pyr = stream[cur].pyr
    rj = pe_j.estimate_batch(tuple(pyr), *[jnp.asarray(x) for x in pts],
                             jnp.asarray(stack), intr, cfg)
    rt = pe_t.estimate_batch(tuple(torch.as_tensor(np.array(p)) for p in pyr),
                             *[torch.as_tensor(x) for x in pts],
                             torch.as_tensor(stack), intr, cfg)
    assert rt.seed_ok.tolist() == np.asarray(rj.seed_ok).tolist()
    assert _best_index(rt.seed_errors, rt.best.pose_error) == \
        _best_index(rj.seed_errors, rj.best.pose_error)
    assert bool(rt.best.ok) == bool(rj.best.ok)
    Tj = np.asarray(rj.best.T, np.float64)
    Tt = rt.best.T.numpy().astype(np.float64)
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 1e-3
    assert _angle(Tt[:3, :3].T @ Tj[:3, :3]) <= 1e-3
    np.testing.assert_allclose(float(rt.best.pose_error), float(rj.best.pose_error),
                               rtol=1e-3)
    np.testing.assert_allclose(float(rt.best.inlier_ratio),
                               float(rj.best.inlier_ratio), rtol=1e-3)


def test_estimate_single_seed_matches_reference(loop_stream):
    """``estimate``, the reference_acceptance path's single-seed call."""
    cfg, intr, stream, gt, est = loop_stream
    stack = _seed_stack(gt, est, 30, 4, cfg, [0.05, 0.0, -0.05, 0.0, 0.01, 0.0])
    pts = _matched_points(stream[4], cfg)
    pyr = stream[30].pyr
    rj = pe_j.estimate(tuple(pyr), *[jnp.asarray(x) for x in pts],
                       jnp.asarray(stack[0]), intr, cfg)
    rt = pe_t.estimate(tuple(torch.as_tensor(np.array(p)) for p in pyr),
                       *[torch.as_tensor(x) for x in pts], torch.as_tensor(stack[0]),
                       intr, cfg)
    assert bool(rt.ok) == bool(rj.ok)
    assert (bool(rt.ok_res), bool(rt.ok_inlier), bool(rt.ok_aff)) == \
        (bool(rj.ok_res), bool(rj.ok_inlier), bool(rj.ok_aff))
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-3)
    # converged to ~0.03 gray levels, where sum-order differences move the
    # last LM steps by ~0.5%: 1e-3 gray levels absolute (1e-4 of res_thres)
    np.testing.assert_allclose(float(rt.pose_error), float(rj.pose_error), rtol=1e-3,
                               atol=1e-3)
