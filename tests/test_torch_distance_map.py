"""Kernel K1 (activation distance map) — its plain PyTorch version here —
against the JAX package: bit-equal to the XLA form, to the Pallas kernel
run in interpret mode (as tests/test_distance_map.py runs it), and to a
brute-force capped Chebyshev distance; empty mask; rounding half to even."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from direct_stereo_slam_tpu.ops import distance_map as dm_j
from direct_stereo_slam_tpu_torch.ops import distance_map as dm_t

pytestmark = pytest.mark.smoke


def _brute_force(pu, pv, mask, h2, w2):
    ui = np.clip(np.round(pu).astype(int), 0, w2 - 1)
    vi = np.clip(np.round(pv).astype(int), 0, h2 - 1)
    occ = np.zeros((h2, w2), bool)
    occ[vi[mask], ui[mask]] = True
    ys, xs = np.nonzero(occ)
    if len(ys) == 0:
        return np.full((h2, w2), float(dm_t.MAX_DIST), np.float32)
    gy, gx = np.mgrid[0:h2, 0:w2]
    d = np.min(np.maximum(np.abs(gy[..., None] - ys), np.abs(gx[..., None] - xs)), -1)
    return np.minimum(d, dm_t.MAX_DIST).astype(np.float32)


def _port(pu, pv, mask, h2, w2):
    return dm_t.build_distance_map(torch.as_tensor(pu), torch.as_tensor(pv),
                                   torch.as_tensor(mask), h2, w2).numpy()


@pytest.mark.parametrize("seed,n,h2,w2", [(0, 60, 48, 80), (1, 25, 40, 64), (2, 400, 46, 154)])
def test_matches_xla_pallas_and_brute_force(seed, n, h2, w2):
    rng = np.random.RandomState(seed)
    # some points project outside the grid (clipped onto the border)
    pu = (rng.rand(n) * (w2 + 10) - 5).astype(np.float32)
    pv = (rng.rand(n) * (h2 + 10) - 5).astype(np.float32)
    mask = rng.rand(n) < 0.7
    got = _port(pu, pv, mask, h2, w2)
    args = (jnp.asarray(pu), jnp.asarray(pv), jnp.asarray(mask), h2, w2)
    np.testing.assert_array_equal(got, np.asarray(dm_j.build_distance_map(*args, False)))
    np.testing.assert_array_equal(got, np.asarray(dm_j.build_distance_map(*args, "interpret")))
    np.testing.assert_array_equal(got, _brute_force(pu, pv, mask, h2, w2))


def test_empty_mask_is_all_max():
    got = _port(np.zeros(4, np.float32), np.zeros(4, np.float32), np.zeros(4, bool), 16, 24)
    assert got.dtype == np.float32 and np.all(got == dm_t.MAX_DIST)
    ref = np.asarray(dm_j.build_distance_map(jnp.zeros(4), jnp.zeros(4),
                                             jnp.zeros(4, bool), 16, 24))
    np.testing.assert_array_equal(got, ref)


def test_round_half_to_even():
    pu = np.array([2.5, 5.5], np.float32)   # -> 2 and 6, as jnp.round
    pv = np.array([3.5, 3.5], np.float32)   # -> 4
    got = _port(pu, pv, np.ones(2, bool), 10, 10)
    assert got[4, 2] == 0 and got[4, 6] == 0 and got[4, 3] == 1 and got[4, 4] == 2
    ref = np.asarray(dm_j.build_distance_map(jnp.asarray(pu), jnp.asarray(pv),
                                             jnp.ones(2, bool), 10, 10))
    np.testing.assert_array_equal(got, ref)


def test_cpu_takes_plain_version():
    before = dm_t.build_distance_map_cuda.launches
    _port(np.zeros(3, np.float32), np.zeros(3, np.float32), np.ones(3, bool), 8, 8)
    assert dm_t.build_distance_map_cuda.launches == before
