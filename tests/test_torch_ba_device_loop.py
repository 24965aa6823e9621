"""The windowed BA's LM loop (``models/ba.py::_optimize_impl``, whose CPU
form is the plain loop beside the card's K9-K11) against the JAX package's
``optimize_keyframe`` at 96x48, on the window of
``test_torch_select_immature_ba.py`` (3 keyframes in 4 slots, 256 points):

- the energy-gated loop at 6 iterations and at 20 (the loop is done
  early: the step converges) and DSO's force-accept
  (``solver_force_accept_step``): rmse within rel 1e-3, the same ok,
  poses within tangent norm 1e-4 (force-accept: 1e-3, its steps are not
  damped by a rejection), the same valid points and residual states;
- a window with a NaN pose (what a diverged force-accept step leaves):
  the same ok and the same NaN pattern in poses and idepths as the JAX
  package, in both modes;
- the loop's bookkeeping alone (``_finish_optimize``, the resident
  launch's last phase: at 0 iterations the loop is one linearization):
  p_res_good, p_last_res and p_num_good equal to the JAX package's, rmse
  within rel 1e-5, the same ok, on the window, on one perturbed 5x more
  and with a NaN pose (which makes every pair of the window not good:
  the JAX package's one-hot gather of the hosts' relative poses spreads
  it), and the NaN pose's linearization (pair flags, energies, NaN
  pattern);
- the dispatch: a CPU state never reaches the kernel library
  (``linearize``, ``optimize_keyframe``, ``marginalize_points``; none of
  the queued or resident entry points counts a launch).
"""

import dataclasses

import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu.models import ba as ba_j
from direct_stereo_slam_tpu_torch.models import ba as ba_t
from direct_stereo_slam_tpu_torch.ops import _cuda
from direct_stereo_slam_tpu_torch.ops import ba as kb
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax as port_cfg
from test_torch_select_immature_ba import _ba_window, _pose_err, _to_port, scene  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _force(cfg):
    return cfg.replace(ba=dataclasses.replace(cfg.ba, solver_force_accept_step=True))


def _nan_pose(st_j):
    return st_j._replace(delta=st_j.delta.at[1, 0].set(float("nan")))


@pytest.mark.parametrize("mode,iters", [("gated", 6), ("gated", 20), ("force", 6)])
def test_optimize_keyframe_matches_jax(scene, mode, iters):
    _, frames, cfg = scene
    if mode == "force":
        cfg = _force(cfg)
    st_j = _ba_window(frames, cfg)
    rj = ba_j.optimize_keyframe(st_j, cfg, iters, 2, None)
    rt = ba_t.optimize_keyframe(_to_port(st_j), port_cfg(cfg), iters, 2, None)
    np.testing.assert_allclose(float(rt[1]), float(rj[1]), rtol=1e-3)
    assert bool(rt[2]) == bool(rj[2])
    Tj, Tt = np.asarray(rj[0].T_current()), rt[0].T_current().numpy()
    tol = 1e-3 if mode == "force" else 1e-4
    for i in range(3):
        assert _pose_err(Tt[i], Tj[i]) < tol, i
    np.testing.assert_array_equal(rt[0].p_valid.numpy(), np.asarray(rj[0].p_valid))
    np.testing.assert_array_equal(rt[0].p_last_res.numpy(), np.asarray(rj[0].p_last_res))


@pytest.mark.parametrize("mode", ["gated", "force"])
def test_nan_pose_matches_jax(scene, mode):
    _, frames, cfg = scene
    if mode == "force":
        cfg = _force(cfg)
    st_j = _nan_pose(_ba_window(frames, cfg))
    rj = ba_j.optimize_keyframe(st_j, cfg, 6, 2, None)
    rt = ba_t.optimize_keyframe(_to_port(st_j), port_cfg(cfg), 6, 2, None)
    assert bool(rt[2]) == bool(rj[2])
    for got, want in ((rt[0].T_current().numpy(), np.asarray(rj[0].T_current())),
                      (rt[0].p_idepth.numpy(), np.asarray(rj[0].p_idepth))):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(rt[0].T_current().numpy()).any()
    assert np.isnan(float(rt[1])) == np.isnan(float(rj[1]))


@pytest.mark.parametrize("perturb,seed,nan", [
    pytest.param(2e-3, 0, False, id="0.002-0"), pytest.param(1e-2, 3, False, id="0.01-3"),
    pytest.param(2e-3, 0, True, id="nan_pose")])
def test_bookkeeping_at_zero_iterations_matches_jax(scene, perturb, seed, nan):
    """nan_pose: the JAX package's one-hot gather of the hosts' relative
    poses spreads a NaN pose to every pair, so no pair of the window is
    good and every masked pair adds its threshold."""
    _, frames, cfg = scene
    st_j = _ba_window(frames, cfg, perturb=perturb, seed=seed)
    if nan:
        st_j = _nan_pose(st_j)
    rj = ba_j.optimize_keyframe(st_j, cfg, 0, 2, None)
    rt = ba_t.optimize_keyframe(_to_port(st_j), port_cfg(cfg), 0, 2, None)
    assert bool(rt[2]) == bool(rj[2])
    rmse_j, rmse_t = float(rj[1]), float(rt[1])
    if np.isnan(rmse_j):
        assert np.isnan(rmse_t)
    else:
        np.testing.assert_allclose(rmse_t, rmse_j, rtol=1e-5)
    for name in ("p_res_good", "p_last_res", "p_num_good", "p_valid"):
        np.testing.assert_array_equal(getattr(rt[0], name).numpy(),
                                      np.asarray(getattr(rj[0], name)), err_msg=name)


def test_linearize_with_a_nan_pose_matches_jax(scene):
    """The linearization itself at a NaN pose: the same pair flags, pair
    energies, energy and terms, and NaN where the JAX package has NaN, in
    every entry of Hff too (its placement einsum makes all of Hff NaN from
    one non-finite block entry; the port follows it)."""
    _, frames, cfg = scene
    st_j = _nan_pose(_ba_window(frames, cfg))
    lj = ba_j.linearize(st_j, cfg)
    lt = ba_t.linearize(_to_port(st_j), port_cfg(cfg))
    for name in ("pair_good", "pair_in"):
        np.testing.assert_array_equal(getattr(lt, name).numpy(), np.asarray(getattr(lj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(lt.pair_energy.numpy(), np.asarray(lj.pair_energy), rtol=1e-5)
    np.testing.assert_allclose(float(lt.energy), float(lj.energy), rtol=1e-5)
    assert float(lt.num_terms) == float(lj.num_terms)
    for name in ("Hff", "bf", "Hfd", "Hdd", "bd"):
        np.testing.assert_array_equal(np.isnan(getattr(lt, name).numpy()),
                                      np.isnan(np.asarray(getattr(lj, name))), err_msg=name)


def test_cpu_state_never_reaches_the_kernels(scene, monkeypatch):
    _, frames, cfg = scene
    st = _to_port(_ba_window(frames, cfg))
    pc = port_cfg(cfg)

    def refuse(*a, **kw):
        raise AssertionError("a CPU state reached the kernel library")

    monkeypatch.setattr(_cuda, "call", refuse)
    monkeypatch.setattr(_cuda, "load_library", refuse)
    counters = (kb.ba_linearize_cuda, kb.ba_step_cuda, kb.ba_accept_cuda, kb.ba_optimize_cuda)
    before = [fn.launches for fn in counters]
    lin = ba_t.linearize(st, pc)
    out = ba_t.optimize_keyframe(st, pc, 3, 2, 160)
    marg = torch.zeros(st.num_points, dtype=torch.bool)
    marg[:10] = True
    ba_t.marginalize_points(out[0], marg, pc)
    assert [fn.launches for fn in counters] == before
    assert float(lin.num_terms) > 0 and bool(out[2])
