"""Parity of the PyTorch port's geometry (lie, camera) with the JAX package.

Inputs come from a seeded numpy RandomState and go through both packages;
outputs must agree to atol 1e-6 (float32 arithmetic, same formulas), and
the float64 numpy twins exactly.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from direct_stereo_slam_tpu.geometry import camera as cam_j
from direct_stereo_slam_tpu.geometry import lie as lie_j
from direct_stereo_slam_tpu_torch.geometry import camera as cam_t
from direct_stereo_slam_tpu_torch.geometry import lie as lie_t

pytestmark = pytest.mark.smoke

ATOL = 1e-6


def _both(fn_name, x, module_j=lie_j, module_t=lie_t):
    a = np.asarray(getattr(module_j, fn_name)(jnp.asarray(x)))
    b = getattr(module_t, fn_name)(torch.as_tensor(x)).numpy()
    return a, b


def _tangents(seed, scale, n):
    return (np.random.RandomState(seed).randn(n, 6) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 0.5, 2.0])
def test_se3_exp_log_match(scale):
    xi = _tangents(0, scale, 32)
    a, b = _both("se3_exp", xi)
    np.testing.assert_allclose(b, a, atol=ATOL)
    a, b = _both("se3_log", a)
    np.testing.assert_allclose(b, a, atol=ATOL * max(1.0, scale))


def test_so3_exp_log_near_pi_and_mixed_signs():
    axes = [np.array([1.0, 2.0, 0.5]), np.array([0.0, 1.0, -1.0]),
            np.array([1e-5, 0.7, -0.7]), np.array([-1.0, 0.0, 1.0]),
            np.array([0.0, 0.0, -1.0])]
    ws = []
    for axis in axes:
        axis = axis / np.linalg.norm(axis)
        for eps in (1e-4, 1e-3, 9e-3):
            ws.append(axis * (np.pi - eps))
    w = np.asarray(ws, np.float32)
    Rj, Rt = _both("so3_exp", w)
    np.testing.assert_allclose(Rt, Rj, atol=ATOL)
    # near pi, log is ill-conditioned (axis from sqrt of a ~0 ratio): the
    # comparison is on the rotation it reproduces, in float32
    lj, lt = _both("so3_log", Rj)
    np.testing.assert_allclose(lie_t.so3_exp(torch.as_tensor(lt)).numpy(),
                               np.asarray(lie_j.so3_exp(jnp.asarray(lj))), atol=1e-5)


def test_inverse_adjoint_transform_match():
    T = np.asarray(lie_j.se3_exp(jnp.asarray(_tangents(1, 0.6, 8))))
    for name in ("se3_inverse", "se3_adjoint"):
        a, b = _both(name, T)
        np.testing.assert_allclose(b, a, atol=ATOL)
    pts = np.random.RandomState(2).randn(8, 5, 3).astype(np.float32)
    a = np.asarray(lie_j.transform_points(jnp.asarray(T), jnp.asarray(pts)))
    b = lie_t.transform_points(torch.as_tensor(T), torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-5 * np.abs(a).max())


def test_log_tiny_rotation_no_nan():
    delta = np.eye(4, dtype=np.float32)
    delta[0, 1], delta[1, 0] = 8.12189537e-05, -8.12268700e-05
    delta[0, 2], delta[2, 0] = -4.16595321e-05, 4.16670591e-05
    delta[1, 2], delta[2, 1] = 1.12816444e-04, -1.12835049e-04
    delta[:3, 3] = [3.12426477e-04, -1.12885993e-03, 1.43307447e-03]
    a, b = _both("se3_log", delta)
    assert np.all(np.isfinite(b))
    np.testing.assert_allclose(b, a, atol=ATOL)


def test_numpy_twins_identical():
    rng = np.random.RandomState(3)
    for scale in (1e-9, 1e-3, 0.7, 3.0):
        xi = rng.randn(6) * scale
        np.testing.assert_array_equal(lie_t.se3_exp_np(xi), lie_j.se3_exp_np(xi))
        T = lie_j.se3_exp_np(xi)
        np.testing.assert_array_equal(lie_t.se3_log_np(T), lie_j.se3_log_np(T))


def test_camera_intrinsics_project_backproject():
    args = (230.0, 231.0, 159.5, 47.5, 320, 96, 4)
    assert cam_t.make_pyramid_intrinsics(*args) == tuple(cam_j.make_pyramid_intrinsics(*args))
    intr = cam_t.make_pyramid_intrinsics(*args)
    np.testing.assert_array_equal(intr.K(2), cam_j.make_pyramid_intrinsics(*args).K(2))
    assert cam_t.num_usable_levels(1232, 368) == cam_j.num_usable_levels(1232, 368)
    rng = np.random.RandomState(4)
    u = rng.uniform(0, 320, 50).astype(np.float32)
    v = rng.uniform(0, 96, 50).astype(np.float32)
    idp = rng.uniform(0.05, 1.0, 50).astype(np.float32)
    c = (230.0, 231.0, 159.5, 47.5)
    pj = np.asarray(cam_j.backproject(jnp.asarray(u), jnp.asarray(v), jnp.asarray(idp), *c))
    pt = cam_t.backproject(torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(idp), *c)
    np.testing.assert_allclose(pt.numpy(), pj, atol=1e-6 * np.abs(pj).max())
    qj = np.asarray(cam_j.project(jnp.asarray(pj), *c))
    qt = cam_t.project(pt, *c).numpy()
    np.testing.assert_allclose(qt, qj, atol=1e-6 * np.abs(qj).max())
    np.testing.assert_allclose(qt, np.stack([u, v], -1), atol=1e-3)
