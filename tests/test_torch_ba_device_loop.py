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
- the dispatch: a CPU state never reaches the kernel library
  (``linearize``, ``optimize_keyframe``, ``marginalize_points``).
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


def test_cpu_state_never_reaches_the_kernels(scene, monkeypatch):
    _, frames, cfg = scene
    st = _to_port(_ba_window(frames, cfg))
    pc = port_cfg(cfg)

    def refuse(*a, **kw):
        raise AssertionError("a CPU state reached the kernel library")

    monkeypatch.setattr(_cuda, "call", refuse)
    monkeypatch.setattr(_cuda, "load_library", refuse)
    counters = (kb.ba_linearize_cuda, kb.ba_step_cuda, kb.ba_accept_cuda)
    before = [fn.launches for fn in counters]
    lin = ba_t.linearize(st, pc)
    out = ba_t.optimize_keyframe(st, pc, 3, 2, 160)
    marg = torch.zeros(st.num_points, dtype=torch.bool)
    marg[:10] = True
    ba_t.marginalize_points(out[0], marg, pc)
    assert [fn.launches for fn in counters] == before
    assert float(lin.num_terms) > 0 and bool(out[2])
