"""The stereo scale LM of the port against the JAX package, through the
port's plain loop ``optimize_scale_batch_plain`` (what the card's K3-LM is
held against), at 96x48 with 3 levels: one guess (the trapped case) and
the front end's grid of 8, a padded template (its NaN H and b leave every
guess where it started), and a small cutoff that makes the pre-loop double
it and the doubled level run again (the one-shot level repeat).

Tolerances: scales rel 1e-4 and errors rel 1e-3 (the LM takes the same
steps on H, b that agree to float32 rounding); the padded case's error
rel 5e-3 (exact-row ties, see test_torch_tracker_scale_template.py);
the accept/trap decision identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu.models import scale_opt as so_j
from direct_stereo_slam_tpu.ops.pyramid import build_pyramid as pyr_j
from direct_stereo_slam_tpu_torch.models import scale_opt as so_t
from direct_stereo_slam_tpu_torch.ops import residual_hb as rh_t
from direct_stereo_slam_tpu_torch.ops import resident_lm as rlm
from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid as pyr_t
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax as port_cfg
from direct_stereo_slam_tpu_torch.utils.convert import to_numpy, to_torch
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_tracker_scale_template import LVLS, _full_template, _templates, setup  # noqa: F401

pytestmark = pytest.mark.smoke


def _both(setup, cfg, tj, guesses, residual_pass=rh_t.scale_residual_pass):
    """The same template, right-image pyramid and guesses through the JAX
    optimizer and the port's plain loop; returns (JAX result, port result)."""
    ds, frames, intr, _ = setup
    img1 = frames[0]["img1"]
    t10 = ds.t_cam1_cam0
    oj = so_j.optimize_scale_batch(tuple(pyr_j(jnp.asarray(img1), LVLS).data), tj,
                                   jnp.asarray(guesses), intr, intr, jnp.asarray(t10), cfg)
    ot = so_t.optimize_scale_batch_plain(
        tuple(pyr_t(torch.as_tensor(img1), LVLS).data), to_torch(to_numpy(tj)),
        torch.as_tensor(guesses), intr, intr, t10, port_cfg(cfg), residual_pass=residual_pass)
    return oj, ot


def _same_decision(oj, ot, cfg, trapped=False, rtol=1e-3):
    st_j, st_t = so_j.ScaleState(trapped=trapped), so_t.ScaleState(trapped=trapped)
    dec_j = so_j.decide_scale_optimization(np.asarray(oj.scale), np.asarray(oj.error), cfg, st_j)
    dec_t = so_t.decide_scale_optimization(ot.scale.numpy(), ot.error.numpy(), port_cfg(cfg),
                                           st_t)
    assert dec_t[0] == dec_j[0] and vars(st_t) == vars(st_j)
    np.testing.assert_allclose(dec_t[1:3], dec_j[1:3], rtol=rtol)
    return dec_t


@pytest.mark.parametrize("G", [1, 8])
def test_plain_loop_matches_jax(setup, G):
    """Idepths wrong by a factor 1.6: the guess 1.0 (alone, as when
    trapped, or in the grid) recovers it; every guess's scale and error
    match, and so does the accept/trap decision."""
    ds, frames, intr, cfg = setup
    tj = _full_template(frames[0], intr)
    guesses = np.array([1.0] if G == 1 else cfg.scale_opt.grid_guesses, np.float32)
    oj, ot = _both(setup, cfg, tj, guesses)
    np.testing.assert_allclose(ot.scale.numpy(), np.asarray(oj.scale), rtol=1e-4)
    np.testing.assert_allclose(ot.error.numpy(), np.asarray(oj.error), rtol=1e-3)
    one = int(np.argmax(guesses == 1.0))
    assert abs(float(ot.scale[one]) - 1.6) / 1.6 < 0.05
    _same_decision(oj, ot, cfg, trapped=G == 1)


def test_padded_template_keeps_the_guesses(setup):
    """build_template's padded lanes (pid = 0) make every pass's H and b
    NaN: each LM step is zeroed and rejected, so all 8 guesses end where
    they started, in both packages, and only the grid chooses."""
    ds, frames, intr, cfg = setup
    tj, _ = _templates(frames[0], n=1500, scale=1.6)
    guesses = np.array(cfg.scale_opt.grid_guesses, np.float32)
    Hs = []

    def recorded(*a, **kw):
        out = rh_t.scale_residual_pass(*a, **kw)
        Hs.append(out.H)
        return out

    oj, ot = _both(setup, cfg, tj, guesses, recorded)
    np.testing.assert_array_equal(np.asarray(oj.scale), guesses)
    np.testing.assert_array_equal(ot.scale.numpy(), guesses)
    np.testing.assert_allclose(ot.error.numpy(), np.asarray(oj.error), rtol=5e-3)
    assert all(bool(torch.isnan(H).all()) for H in Hs)
    _same_decision(oj, ot, cfg, rtol=5e-3)


def test_cutoff_doubling_and_level_repeat(setup):
    """A cutoff of 2 gray levels saturates most residuals at the coarsest
    level: the pre-loop doubles it, and that level then runs a second time
    from the cutoff of 2 (the one-shot repeat)."""
    ds, frames, intr, cfg = setup
    cfg = cfg.replace(tracker=dataclasses.replace(cfg.tracker, coarse_cutoff_th=2.0))
    tj = _full_template(frames[0], intr)
    calls = []

    def counted(*a, **kw):
        calls.append((a[0].shape[0], float(torch.max(torch.as_tensor(a[-1])))))
        return rh_t.scale_residual_pass(*a, **kw)

    guesses = np.array([1.0, 5.0], np.float32)
    oj, ot = _both(setup, cfg, tj, guesses, counted)
    np.testing.assert_allclose(ot.scale.numpy(), np.asarray(oj.scale), rtol=1e-4)
    np.testing.assert_allclose(ot.error.numpy(), np.asarray(oj.error), rtol=1e-3)
    coarsest = intr.h[LVLS - 1]
    assert max(c for h, c in calls if h == coarsest) > 2.0          # doubled
    # the level's initial pass at the base cutoff ran twice: the repeat
    assert sum(1 for h, c in calls if h == coarsest and c == 2.0) == 2
    _same_decision(oj, ot, cfg)


def test_cpu_tensors_take_the_plain_loop(setup):
    """On the CPU optimize_scale_batch is the plain loop, bit for bit, and
    counts no launch of K3-LM or of the per-pass K3."""
    ds, frames, intr, cfg = setup
    tt = to_torch(to_numpy(_full_template(frames[0], intr)))
    args = (tuple(pyr_t(torch.as_tensor(frames[0]["img1"]), LVLS).data), tt,
            torch.tensor([0.5, 1.0]), intr, intr, ds.t_cam1_cam0, port_cfg(cfg))
    counts = (rlm.scale_lm_cuda.launches, rh_t.scale_residual_pass_cuda.launches)
    a, b = so_t.optimize_scale_batch(*args), so_t.optimize_scale_batch_plain(*args)
    assert torch.equal(a.scale, b.scale) and torch.equal(a.error, b.error)
    assert counts == (rlm.scale_lm_cuda.launches, rh_t.scale_residual_pass_cuda.launches)
