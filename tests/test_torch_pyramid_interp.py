"""Parity of the port's pyramid builder and bilinear sampler with the JAX
package, on 0-255 intensities from a seeded numpy RandomState (atol 1e-4:
the 2x2 means and central differences are the same float32 sums)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from direct_stereo_slam_tpu.ops import interp as interp_j
from direct_stereo_slam_tpu.ops import pyramid as pyr_j
from direct_stereo_slam_tpu_torch.ops import interp as interp_t
from direct_stereo_slam_tpu_torch.ops import pyramid as pyr_t

pytestmark = pytest.mark.smoke

ATOL = 1e-4


@pytest.mark.parametrize("shape", [(48, 96), (50, 70)])
def test_build_pyramid_matches(shape):
    img = (np.random.RandomState(0).rand(*shape) * 255).astype(np.float32)
    a = pyr_j.build_pyramid(jnp.asarray(img), 3)
    b = pyr_t.build_pyramid(torch.as_tensor(img), 3)
    assert b.levels == a.levels == 3
    for la, lb in zip(a.data, b.data):
        assert tuple(lb.shape) == la.shape
        np.testing.assert_allclose(lb.numpy(), np.asarray(la), atol=ATOL)
    for la, lb in zip(a.abs_grad, b.abs_grad):
        np.testing.assert_allclose(lb.numpy(), np.asarray(la), rtol=1e-5, atol=ATOL)


def test_bilinear_gather_matches_including_clamped():
    rng = np.random.RandomState(1)
    img = (rng.rand(24, 40, 3) * 255).astype(np.float32)
    us = rng.uniform(-5, 45, (7, 11)).astype(np.float32)   # includes clamped
    vs = rng.uniform(-5, 29, (7, 11)).astype(np.float32)
    a = np.asarray(interp_j.bilinear_gather(jnp.asarray(img), jnp.asarray(us), jnp.asarray(vs)))
    b = interp_t.bilinear_gather(torch.as_tensor(img), torch.as_tensor(us),
                                 torch.as_tensor(vs)).numpy()
    assert b.shape == a.shape == (7, 11, 3)
    np.testing.assert_allclose(b, a, atol=ATOL)
    a = np.asarray(interp_j.bilinear_gather_scalar(jnp.asarray(img[..., 0]),
                                                   jnp.asarray(us), jnp.asarray(vs)))
    b = interp_t.bilinear_gather_scalar(torch.as_tensor(img[..., 0]), torch.as_tensor(us),
                                        torch.as_tensor(vs)).numpy()
    np.testing.assert_allclose(b, a, atol=ATOL)


def test_bilinear_gather_frames_matches():
    rng = np.random.RandomState(2)
    imgs = (rng.rand(3, 24, 40, 3) * 255).astype(np.float32)
    n = 300
    us = rng.uniform(-2, 42, n).astype(np.float32)
    vs = rng.uniform(-2, 26, n).astype(np.float32)
    fidx = rng.randint(0, 3, n)
    a = interp_j.bilinear_gather_frames(jnp.asarray(imgs), jnp.asarray(fidx, jnp.int32),
                                        jnp.asarray(us), jnp.asarray(vs))
    b = interp_t.bilinear_gather_frames(torch.as_tensor(imgs), torch.as_tensor(fidx),
                                        torch.as_tensor(us), torch.as_tensor(vs))
    for ca, cb in zip(a, b):
        np.testing.assert_allclose(cb.numpy(), np.asarray(ca), atol=ATOL)


def test_bilinear_nan_lane_stays_in_bounds():
    """A NaN coordinate (a lane the caller masks) must not index out of
    range: the sample is NaN, the gather itself is safe."""
    img = torch.ones(8, 8, 3)
    out = interp_t.bilinear_gather(img, torch.tensor([float("nan"), 2.5]),
                                   torch.tensor([1.0, float("inf")]))
    assert torch.isnan(out[0]).all() and torch.isfinite(out[1]).all()
