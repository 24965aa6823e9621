"""Parity of kernels K2 (pose pass) and K3 (scale pass) — here their plain
PyTorch versions, which the CPU takes — with the JAX package's passes.

H and b must agree per entry within 1e-4 x max|entry| (float32 sums in
another order), the statistics within rel 1e-5, and the flow statistics
on the every-32nd-point subsample. Padded template lanes (pid = 0, mask
False) make the reference's scale-pass H and b NaN; the port reproduces
that too.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from direct_stereo_slam_tpu.geometry import lie as lie_j
from direct_stereo_slam_tpu.ops import residual_hb as rh_j
from direct_stereo_slam_tpu_torch.ops import residual_hb as rh_t

pytestmark = pytest.mark.smoke

W, H = 96, 64
FX, FY, CX, CY = 80.0, 80.0, W / 2 - 0.5, H / 2 - 0.5
K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]], np.float32)
KI = np.linalg.inv(K).astype(np.float32)
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


def _points(seed, n=320, n_live=256):
    rng = np.random.RandomState(seed)
    pu = rng.uniform(3, W - 4, n).astype(np.float32)
    pv = rng.uniform(3, H - 4, n).astype(np.float32)
    pid = rng.uniform(0.05, 0.6, n).astype(np.float32)
    pc = rng.uniform(20, 230, n).astype(np.float32)
    live = np.arange(n) < n_live
    pu[~live] = pv[~live] = pid[~live] = pc[~live] = 0.0
    return pu, pv, pid, pc, live


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    got = np.asarray(got)
    np.testing.assert_allclose(got, want, atol=rel * max(np.abs(want).max(), 1e-30), rtol=0)


def _stats_close(st_t, st_j, rel=1e-5):
    for a, b in zip(st_t, st_j):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rel, atol=1e-6)


POSES = [np.zeros(6), [0.02, -0.01, 0.05, 0.01, -0.02, 0.005],
         [-0.05, 0.03, -0.1, -0.03, 0.01, 0.02]]


@pytest.mark.parametrize("k", range(len(POSES)))
def test_pose_pass_matches(k):
    img = _image(k)
    pu, pv, pid, pc, live = _points(k)
    T = np.asarray(lie_j.se3_exp(jnp.asarray(POSES[k], jnp.float32)))
    RKi = (T[:3, :3] @ KI).astype(np.float32)
    t = T[:3, 3].astype(np.float32)
    args_j = [jnp.asarray(a) for a in (img, pu, pv, pid, pc, live, RKi, KI, t)]
    args_t = [torch.as_tensor(a) for a in (img, pu, pv, pid, pc, live, RKi, KI, t)]
    for cutoff in (20.0, 60.0):
        oj = rh_j.pose_residual_pass(*args_j, jnp.float32(1.05), jnp.float32(2.0),
                                     jnp.float32(1.5), FX, FY, CX, CY, HUBER,
                                     jnp.float32(cutoff))
        ot = rh_t.pose_residual_pass(*args_t, 1.05, 2.0, 1.5, FX, FY, CX, CY, HUBER,
                                     cutoff)
        _close(ot.H, oj.H)
        _close(ot.b, oj.b)
        _stats_close(ot.stats, oj.stats)
        assert float(ot.num_in) == float(oj.num_in)
    # flow statistics come from the every-32nd-point subsample: moving a
    # non-subsampled point must not change them
    assert float(ot.stats.flow_t) > 0 or np.allclose(POSES[k], 0)


def test_pose_pass_batch_equals_singles():
    img = torch.as_tensor(_image(5))
    pu, pv, pid, pc, live = [torch.as_tensor(a) for a in _points(5)]
    Ki = torch.as_tensor(KI)
    Ts = [np.asarray(lie_j.se3_exp(jnp.asarray(p, jnp.float32))) for p in POSES]
    RKi = torch.as_tensor(np.stack([T[:3, :3] @ KI for T in Ts]).astype(np.float32))
    t = torch.as_tensor(np.stack([T[:3, 3] for T in Ts]).astype(np.float32))
    a = torch.tensor([1.0, 1.05, 0.95])
    b = torch.tensor([0.0, 2.0, -3.0])
    cut = torch.tensor([20.0, 40.0, 80.0])
    batch = rh_t.pose_residual_pass(img, pu, pv, pid, pc, live, RKi, Ki, t, a, b, 1.5,
                                    FX, FY, CX, CY, HUBER, cut)
    for i in range(3):
        one = rh_t.pose_residual_pass(img, pu, pv, pid, pc, live, RKi[i], Ki, t[i],
                                      a[i], b[i], 1.5, FX, FY, CX, CY, HUBER, cut[i])
        _close(batch.H[i], one.H, 1e-6)
        _close(batch.b[i], one.b, 1e-6)
        _stats_close([s[i] for s in batch.stats], one.stats, 1e-6)


def test_flow_uses_every_32nd_point():
    img = torch.as_tensor(_image(6))
    pu, pv, pid, pc, live = [torch.as_tensor(a) for a in _points(6)]
    T = np.asarray(lie_j.se3_exp(jnp.asarray(POSES[1], jnp.float32)))
    args = (torch.as_tensor((T[:3, :3] @ KI).astype(np.float32)), torch.as_tensor(KI),
            torch.as_tensor(T[:3, 3].astype(np.float32)), 1.0, 0.0, 0.0,
            FX, FY, CX, CY, HUBER, 20.0)
    base = rh_t.pose_residual_pass(img, pu, pv, pid, pc, live, *args)
    pid2 = pid.clone()
    pid2[1:32] *= 3.0             # lanes 1..31 are outside the subsample
    moved = rh_t.pose_residual_pass(img, pu, pv, pid2, pc, live, *args)
    assert float(moved.stats.flow_t) == float(base.stats.flow_t)
    pid2[32] *= 3.0               # lane 32 is in it
    moved = rh_t.pose_residual_pass(img, pu, pv, pid2, pc, live, *args)
    assert float(moved.stats.flow_t) != float(base.stats.flow_t)


@pytest.mark.parametrize("n_live", [320, 256])
def test_scale_pass_matches(n_live):
    img = _image(7)
    pu, pv, pid, pc, live = _points(7, n_live=n_live)
    R01 = np.eye(3, dtype=np.float32)
    t01 = np.array([-0.54, 0.0, 1e-9], np.float32)
    R01Ki = (R01 @ KI).astype(np.float32)
    scales = np.array([0.5, 1.0, 1.6], np.float32)
    ot = rh_t.scale_residual_pass(*[torch.as_tensor(a) for a in
                                    (img, pu, pv, pid, pc, live, R01Ki, KI, t01)],
                                  torch.as_tensor(scales), FX, FY, CX, CY, HUBER,
                                  torch.full((3,), 20.0))
    for g, s in enumerate(scales):
        oj = rh_j.scale_residual_pass(*[jnp.asarray(a) for a in
                                        (img, pu, pv, pid, pc, live, R01Ki, KI, t01)],
                                      jnp.float32(s), FX, FY, CX, CY, HUBER,
                                      jnp.float32(20.0))
        _stats_close([x[g] for x in ot.stats], oj.stats)
        if n_live < len(pu):
            # padded lanes: the reference's masked sums give NaN
            assert np.isnan(float(oj.H)) and np.isnan(float(ot.H[g]))
            assert np.isnan(float(oj.b)) and np.isnan(float(ot.b[g]))
        else:
            np.testing.assert_allclose(float(ot.H[g]), float(oj.H), rtol=1e-4)
            np.testing.assert_allclose(float(ot.b[g]), float(oj.b), rtol=1e-4,
                                       atol=1e-4 * abs(float(oj.b)))


def test_wrappers_take_plain_version_only_on_cpu():
    """CPU tensors run the plain version and leave the launch counters at 0."""
    k2, k3 = rh_t.pose_residual_pass_cuda.launches, rh_t.scale_residual_pass_cuda.launches
    img = torch.as_tensor(_image(8))
    pts = [torch.as_tensor(a) for a in _points(8)]
    rh_t.pose_residual_pass(img, *pts, torch.as_tensor(KI), torch.as_tensor(KI),
                            torch.zeros(3), 1.0, 0.0, 0.0, FX, FY, CX, CY, HUBER, 20.0)
    rh_t.scale_residual_pass(img, *pts, torch.as_tensor(KI), torch.as_tensor(KI),
                             torch.tensor([-0.54, 0.0, 1e-9]), 1.0, FX, FY, CX, CY,
                             HUBER, 20.0)
    assert (rh_t.pose_residual_pass_cuda.launches, rh_t.scale_residual_pass_cuda.launches) == (k2, k3)
