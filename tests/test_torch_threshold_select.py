"""K17's energy threshold as its epilogue computes it (``csrc/window.cu``,
``ba_epilogue_kernel``'s block 0), written here as a plain integer model:
the energies' order-preserving keys (NaN last), the non-NaN count, the f32
rank, truncated and ceiled, the key of rank ``below`` by a bit-serial
select (32 rounds from the top bit, each counting the keys that share the
bits chosen so far and have this one clear), the key of rank ``above``
from the count of the keys up to it or else the least key above it, then
ATen's lerp (a fused multiply-add), the square root, the fallback and the
threshold's three steps, each rounded to f32.

The model against the port's plain version
(``models/ba.py::set_new_frame_energy_th_from_lin``, ``torch.nanquantile``)
bit for bit, its order statistics against a sort, and against the JAX
package's ``set_new_frame_energy_th_from_lin`` (``jnp.nanquantile``, whose
lerp is low (1 - w) + high w: within rel 1e-6, as
``test_torch_window_state.py`` holds the two packages' thresholds): seeded
energies, with ties, with NaNs and pairs not in, all NaN and one key, for
B of 1, 2559, 2560, 4096 and 8192 rows.
"""

from fractions import Fraction
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu.config import make_config
from direct_stereo_slam_tpu.models import ba as ba_j
from direct_stereo_slam_tpu_torch.models import ba as ba_t
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax as port_cfg
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

NAN_KEY = 0xFFFFFFFF
W, NEWEST = 2, 1


def sort_key(e: np.ndarray) -> np.ndarray:
    """csrc/window.cu's sort_key: the f32 bits made unsigned-ordered, NaN
    last."""
    u = np.asarray(e, np.float32).view(np.uint32)
    k = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return np.where(np.isnan(e), np.uint32(NAN_KEY), k)


def key_value(k: int) -> np.float32:
    if k == NAN_KEY:
        return np.float32(np.nan)
    u = k & 0x7FFFFFFF if k & 0x80000000 else ~k & 0xFFFFFFFF
    return np.array([u], np.uint32).view(np.float32)[0]


def select(keys: np.ndarray, rank: int) -> int:
    """The key of rank ``rank`` (0-based, ascending), one bit a round."""
    sel = 0
    for bit in range(31, -1, -1):
        hi = ~((2 << bit) - 1) & 0xFFFFFFFF
        same = ((keys ^ np.uint32(sel)) & np.uint32(hi)) == 0
        clear = ((keys >> np.uint32(bit)) & np.uint32(1)) == 0
        n = int(np.count_nonzero(same & clear))
        if rank >= n:
            rank -= n
            sel |= 1 << bit
    return sel


def f32(x) -> np.float32:
    return np.float32(x)


def fma32(a, b, c) -> np.float32:
    """a b + c rounded once to f32 (exact in fractions, ties to even)."""
    a, b, c = f32(a), f32(b), f32(c)
    if not (np.isfinite(a) and np.isfinite(b) and np.isfinite(c)):
        return f32(np.float64(a) * np.float64(b) + np.float64(c))
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    g = f32(float(x))
    cands = [np.nextafter(g, f32(-np.inf)), g, np.nextafter(g, f32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.array([v], np.float32).view(np.uint32)[0]) & 1))


def aten_lerp(a, b, w) -> np.float32:
    d = f32(f32(b) - f32(a))
    if abs(w) < 0.5:
        return fma32(w, d, a)
    return fma32(-d, f32(f32(1.0) - f32(w)), b)


def threshold_model(energy: np.ndarray, cfg) -> tuple:
    """(threshold, (key below, key above)) as K17's epilogue computes them
    from the newest slot's energies (NaN where a pair is not in)."""
    keys = sort_key(energy)
    count = int(np.count_nonzero(keys != NAN_KEY))
    rank = f32(f32(cfg.ba.frame_energy_th_n) * f32(count - 1))
    if rank < 0:
        rank = f32(0.0)
    below, above = int(rank), int(np.ceil(rank))
    k_below = select(keys, below)
    k_above = k_below
    if above != below and int(np.count_nonzero(keys <= k_below)) <= above:
        k_above = int(keys[keys > k_below].min())
    w = f32(rank - f32(below))
    nth = aten_lerp(key_value(k_below), key_value(k_above), w)
    th = np.sqrt(nth, dtype=np.float32) if np.isfinite(nth) else f32(12.0 * 8.0 ** 0.5)
    cw = cfg.ba.frame_energy_th_const_weight
    th = f32(th * f32(cfg.ba.frame_energy_th_fac_median))
    th = f32(f32(th * f32(1.0 - cw)) + f32(26.0 * cw))
    th = f32(f32(th * th) * f32(cfg.ba.overall_energy_th_weight ** 2))
    return th, (k_below, k_above)


class _State(NamedTuple):
    energy_th: object
    delta: object

    @property
    def num_slots(self) -> int:
        return self.energy_th.shape[0]


class _Lin(NamedTuple):
    pair_energy: object
    pair_in: object


def _energies(kind: str, B: int, seed: int):
    """pair_energy [B, W] and pair_in [B, W] of one seeded case."""
    rng = np.random.RandomState(seed)
    e = (rng.gamma(2.0, 40.0, (B, W)) * rng.choice([1e-2, 1.0, 30.0], (B, W))).astype(np.float32)
    pin = rng.rand(B, W) < 0.9
    if kind == "ties":
        e = rng.choice(np.array([0.0, 1.5, 7.25, 7.25, 100.0], np.float32), (B, W))
    elif kind == "nans":
        e[rng.rand(B, W) < 0.2] = np.nan
        pin &= rng.rand(B, W) < 0.6
    elif kind == "all_nan":
        e[:, NEWEST] = np.nan
    elif kind == "one_key":
        pin[:, NEWEST] = False
        pin[rng.randint(B), NEWEST] = True
    return e, pin


@pytest.fixture(scope="module")
def cfgs():
    cfg = make_config(96, 48, preset=0, mode=1)
    return cfg, port_cfg(cfg)


@pytest.mark.parametrize("B", [1, 2559, 2560, 4096, 8192])
@pytest.mark.parametrize("kind", ["random", "ties", "nans", "all_nan", "one_key"])
def test_select_model_matches_nanquantile(cfgs, kind, B):
    cfg_j, cfg_t = cfgs
    e, pin = _energies(kind, B, 7 * B + len(kind))
    col = np.where(pin[:, NEWEST], e[:, NEWEST], np.float32(np.nan))
    th, (k_below, k_above) = threshold_model(col, cfg_t)
    # the order statistics against a sort of the keys (NaN last)
    keys = np.sort(sort_key(col))
    count = int(np.count_nonzero(~np.isnan(col)))
    rank = f32(f32(cfg_t.ba.frame_energy_th_n) * f32(count - 1))
    rank = max(rank, f32(0.0))
    assert (k_below, k_above) == (int(keys[int(rank)]), int(keys[int(np.ceil(rank))]))
    # the port's plain version (torch.nanquantile), bit for bit
    energy_th = np.full(W, 3.0, np.float32)
    st_t = _State(torch.tensor(energy_th), torch.zeros(W, 8))
    got = ba_t.set_new_frame_energy_th_from_lin(
        st_t, _Lin(torch.tensor(e), torch.tensor(pin)), NEWEST, cfg_t).energy_th.numpy()
    assert got[NEWEST].view(np.uint32) == np.float32(th).view(np.uint32), (got[NEWEST], th)
    assert got[0] == energy_th[0]
    # the JAX package's (jnp.nanquantile)
    want = ba_j.set_new_frame_energy_th_from_lin(
        _State(jnp.asarray(energy_th), jnp.zeros((W, 8))),
        _Lin(jnp.asarray(e), jnp.asarray(pin)), NEWEST, cfg_j).energy_th
    np.testing.assert_allclose(th, np.asarray(want)[NEWEST], rtol=1e-6)
