"""The windowed BA's state programs (``ops/window.py``: K16 the window's
poses, K17 ``optimize_keyframe``'s compaction, energy threshold and FEJ
reset, K18 the keyframe tail's marginalization): their plain versions, which
the CPU runs, against the JAX package at 96x48 on the window of
``test_torch_select_immature_ba.py`` (3 keyframes in 4 slots, 256 points).

- K16 (``window_pose_plain``) with deltas on every slot (a rotation on the
  Taylor branch of se3_exp and two past it): T_all against
  ``BAState.T_current``, T_inv against ``jnp.linalg.inv`` of the JAX
  package's T_current, T_rh against ``template_inputs``' einsum, within
  1e-5 x max|entry| (the plain version is a rigid inverse and a fixed
  order of f32 products and sums where the JAX package runs an LU
  inverse and HIGHEST matmuls); aff and calib equal; ``current_views``
  within the same bound.
- K17 (``optimize_keyframe_plain``, the compact view of 160 rows): rmse
  within rel 1e-3, the newest slot's energy threshold within rel 1e-3,
  its FEJ pose within tangent norm 1e-4 and its pose delta zero, the same
  valid points and residual states, Hdd within 1e-3 x max; alone, the
  threshold on the same linearization in both packages within rel 1e-6 and
  the FEJ reset within 1e-6 x max|entry|.
- K18 (``marginalize_plain``: flagged points folded in, others dropped, a
  frame marginalized) on the anchor slot and on another slot: HM and bM
  within 2e-3 x max|entry| (the anchor's 1e8 prior makes its 8x8 block
  ill-conditioned: f32 inverses differ there), validity, ids, residual
  flags and deltas equal; an empty point mask leaves HM and bM untouched;
  a mask that also flags invalid points folds in only the valid ones (the
  host lists' points, as the JAX package's ``marg & p_valid``).
- On the CPU none of the three kernels is launched, and the ctypes
  structs are the C source's, field for field.
"""

import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu.config import make_config
from direct_stereo_slam_tpu.models import ba as ba_j
from direct_stereo_slam_tpu_torch.models import ba as ba_t
from direct_stereo_slam_tpu_torch.ops import window as win
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax as port_cfg
from direct_stereo_slam_tpu_torch.utils.convert import to_numpy
from test_torch_select_immature_ba import H, N_POINTS, W, _pose_err, _to_port
from torch_ba_window import ba_window
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CSRC = Path(win.__file__).resolve().parents[1] / "csrc" / "window.cu"


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * max(float(np.abs(want).max()), 1e-30), rtol=0)


def _with_deltas(st_j):
    """Deltas on every valid slot: slot 0's rotation on se3_exp's Taylor
    branch (theta^2 < 1e-4), slots 1 and 2 past it."""
    delta = np.zeros((4, 8), np.float32)
    delta[0] = [1e-3, -2e-3, 5e-4, 2e-3, -1e-3, 3e-3, 0.01, -0.5]
    delta[1] = [-0.02, 0.01, 0.03, 0.04, -0.05, 0.02, -0.03, 1.5]
    delta[2] = [0.05, -0.04, 0.02, -0.2, 0.1, 0.15, 0.02, 0.25]
    return st_j._replace(delta=jnp.asarray(delta),
                         calib_delta=jnp.asarray([0.5, -0.25, 0.125, 0.3], jnp.float32))


@pytest.fixture(scope="module")
def cfg():
    """The JAX package's config of the window (``ba_window``'s)."""
    return make_config(W, H, preset=0, mode=1)


@pytest.fixture(scope="module")
def window(cfg):
    """(base window, the window with deltas and a prior (HM, bM), the
    port's linearization of it as JAX arrays), built once for the module:
    the window of
    ``test_torch_select_immature_ba.py::_ba_window`` as the port builds it
    (``torch_ba_window.ba_window``), handed to the JAX package."""
    base = ba_j.BAState(*[jnp.asarray(x) for x in to_numpy(ba_window()[0])])
    rng = np.random.RandomState(5)
    D = 4 + 8 * 4
    A = rng.randn(D, D).astype(np.float32)
    moved = _with_deltas(base)._replace(HM=jnp.asarray(A @ A.T * 1e3),
                                        bM=jnp.asarray(rng.randn(D).astype(np.float32)))
    lin = ba_t.linearize(_to_port(moved), port_cfg(cfg))
    return base, moved, ba_j.Linearization(*[jnp.asarray(x.numpy()) for x in lin])


@jax.jit
def _poses_j(st, ref):
    """The JAX package's T_current, its inverse, template_inputs' T_rh,
    aff_current, calib_current and current_views' last outputs, in one
    program."""
    T = st.T_current()
    inv = jnp.linalg.inv(T)
    return (T, inv, jnp.einsum("ij,hjk->hik", T[ref], inv, precision="highest"),
            st.aff_current(), st.calib_current()) + tuple(ba_j.current_views(st)[3:])


def test_window_pose_matches_jax(window):
    st_j = window[1]
    st_t = _to_port(st_j)
    for ref in (0, 2):
        T_j, inv_j, rh_j, aff_j, calib_j, *views_j = (np.asarray(x) for x in
                                                       _poses_j(st_j, ref))
        pose = win.window_pose(st_t, ref)
        _close(pose.T_all.numpy(), T_j, 1e-5)
        _close(pose.T_inv.numpy(), inv_j, 1e-5)
        _close(pose.T_inv.numpy(), np.linalg.inv(T_j.astype(np.float64)), 1e-5)
        _close(pose.T_rh.numpy(), rh_j, 1e-5)
        np.testing.assert_array_equal(pose.aff.numpy(), aff_j)
        np.testing.assert_array_equal(pose.calib.numpy(), calib_j)
    views = ba_t.current_views(st_t)
    _close(views[0].numpy(), T_j, 1e-5)
    for got, want in zip(views[1:], [aff_j, calib_j] + views_j):
        np.testing.assert_array_equal(got.numpy(), want)
    # the template's pose prep is K16's toward its reference slot
    calib, T_rh = ba_t.template_pose_prep(st_t, 1)
    assert torch.equal(T_rh, win.window_pose(st_t, 1).T_rh)
    assert torch.equal(calib, st_t.calib_current())


def test_optimize_keyframe_compact_matches_jax(cfg, window):
    st_j = window[0]
    rj = ba_j.optimize_keyframe(st_j, cfg, 3, 2, 160)
    rt = ba_t.optimize_keyframe(_to_port(st_j), port_cfg(cfg), 3, 2, 160)
    np.testing.assert_allclose(float(rt[1]), float(rj[1]), rtol=1e-3)
    assert bool(rt[2]) == bool(rj[2])
    assert int(rt[4]) == int(rj[4]) == 0
    np.testing.assert_allclose(rt[0].energy_th.numpy(), np.asarray(rj[0].energy_th), rtol=1e-3)
    assert _pose_err(rt[0].T_zero[2].numpy(), np.asarray(rj[0].T_zero[2])) < 1e-4
    assert float(rt[0].delta[2, :6].abs().max()) == 0.0
    for i in range(3):
        assert _pose_err(rt[0].T_current()[i].numpy(), np.asarray(rj[0].T_current()[i])) < 1e-4
    for name in ("p_valid", "p_last_res", "p_res_good"):
        np.testing.assert_array_equal(getattr(rt[0], name).numpy(),
                                      np.asarray(getattr(rj[0], name)), err_msg=name)
    _close(rt[3].numpy(), rj[3], 1e-3)


def test_energy_threshold_and_fej_reset_match_jax(cfg, window):
    """K17's epilogue parts alone, both packages on the same inputs."""
    _, st_j, lj = window
    st_t = _to_port(st_j)
    lin_t = ba_t.Linearization(*[torch.as_tensor(np.array(x)) for x in lj])
    for newest in (1, 2):
        got = ba_t.set_new_frame_energy_th_from_lin(st_t, lin_t, newest, port_cfg(cfg))
        want = ba_j.set_new_frame_energy_th_from_lin(st_j, lj, jnp.int32(newest), cfg)
        np.testing.assert_allclose(got.energy_th.numpy(), np.asarray(want.energy_th), rtol=1e-6)
        got = ba_t.reset_fej_newest(st_t, newest)
        want = ba_j.reset_fej_newest(st_j, jnp.int32(newest))
        _close(got.T_zero.numpy(), want.T_zero, 1e-6)
        np.testing.assert_array_equal(got.delta.numpy(), np.asarray(want.delta))


def _views(st):
    """Host copies of the state's validity and hosts (the front end's
    bundle holds them)."""
    return st.p_valid.cpu().numpy(), st.p_host.cpu().numpy()


def _marg_masks(st_j):
    valid = np.asarray(st_j.p_valid)
    idx = np.flatnonzero(valid)
    marg = np.zeros(N_POINTS, bool)
    drop = np.zeros(N_POINTS, bool)
    marg[idx[::7]] = True
    drop[idx[3::11]] = True
    drop &= ~marg
    return marg, drop


@pytest.mark.parametrize("slot", [0, 1], ids=["anchor", "other"])
def test_marginalize_matches_jax(cfg, window, slot):
    _, st_j, lj = window
    st_t = _to_port(st_j)
    marg, drop = _marg_masks(st_j)
    want = ba_j.marginalize_frame(
        ba_j.drop_points(ba_j.marginalize_points(st_j, jnp.asarray(marg), cfg, lj),
                         jnp.asarray(drop)), jnp.int32(slot))
    lt = ba_t.Linearization(*[torch.as_tensor(np.array(x)) for x in lj])
    got = ba_t.marginalize(st_t, lt, marg, drop, [slot], port_cfg(cfg), _views(st_t))
    _close(got.HM.numpy(), want.HM, 2e-3)
    _close(got.bM.numpy(), want.bM, 2e-3)
    for name in ("p_valid", "frame_valid", "frame_id", "p_res_good", "delta"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    # no point flagged: the prior is the frame's Schur complement alone
    none = np.zeros(N_POINTS, bool)
    only = ba_t.marginalize(st_t, lt, none, none, [], port_cfg(cfg), _views(st_t))
    assert torch.equal(only.HM, st_t.HM) and torch.equal(only.bM, st_t.bM)
    assert torch.equal(only.p_valid, st_t.p_valid)


def test_marginalize_folds_only_valid_flagged_points(cfg, window):
    """K18's plain path takes the points it folds in from the host lists
    (``marg_lists``: flagged and valid): a mask that also flags invalid
    points gives the JAX package's result (its ``marg & p_valid``)."""
    _, st_j, lj = window
    st_t = _to_port(st_j)
    marg, drop = _marg_masks(st_j)
    invalid = np.flatnonzero(~np.asarray(st_j.p_valid))
    marg[invalid[::3]] = True
    drop &= ~marg
    want = ba_j.marginalize_frame(
        ba_j.drop_points(ba_j.marginalize_points(st_j, jnp.asarray(marg), cfg, lj),
                         jnp.asarray(drop)), jnp.int32(1))
    lt = ba_t.Linearization(*[torch.as_tensor(np.array(x)) for x in lj])
    got = ba_t.marginalize(st_t, lt, marg, drop, [1], port_cfg(cfg), _views(st_t))
    _close(got.HM.numpy(), want.HM, 2e-3)
    _close(got.bM.numpy(), want.bM, 2e-3)
    for name in ("p_valid", "frame_valid", "frame_id", "p_res_good", "delta"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_no_kernel_on_the_cpu(cfg, window):
    st_t = _to_port(window[0])
    counters = (win.window_pose_cuda, win.ba_prologue_cuda, win.ba_epilogue_cuda,
                win.marginalize_cuda)
    before = [fn.launches for fn in counters]
    pc = port_cfg(cfg)
    out = ba_t.optimize_keyframe(st_t, pc, 1, 2, 160)
    ba_t.current_views(out[0])
    lin = ba_t.linearize(out[0], pc)
    marg = np.zeros(N_POINTS, bool)
    marg[:4] = True
    ba_t.marginalize(out[0], lin, marg, np.zeros(N_POINTS, bool), [0], pc, _views(out[0]))
    assert [fn.launches for fn in counters] == before
    np.testing.assert_array_equal(win.pack_flags([True, False, True], [False, True, True]),
                                  np.array([1, 2, 3], np.uint8))


def _c_fields(src: str, name: str):
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        for part in line.rstrip(";").split(","):
            names.append(re.sub(r"[\*\s]|\[\w+\]", "", part.split()[-1]))
    return names


@pytest.mark.parametrize("cls", ["PoseParams", "KfParams", "MargParams"])
def test_params_structs_match_the_c_source(cls):
    names = _c_fields(CSRC.read_text(), cls)
    assert [n for n, _ in getattr(win, cls)._fields_] == names


def test_wrappers_reject_a_pool_past_the_counters():
    """K17's prologue and K18 count a pool's points in 16 bits: the C entry
    points reject a larger pool, and the wrappers raise for it before they
    build anything."""
    assert CSRC.read_text().count(f"NP >= {win.NP_MAX + 1}") == 2
    big = types.SimpleNamespace(num_slots=4, num_points=win.NP_MAX + 1)
    with pytest.raises(ValueError, match="pool"):
        win.ba_keyframe_cuda(big, None, 1, 0, 2560)
    with pytest.raises(ValueError, match="pool"):
        win.marginalize_cuda(big, None, None, [0], None)


def test_every_entry_point_has_its_signature():
    """ctypes passes a pointer argument of an entry point without argtypes
    as a 32-bit int: every exported entry needs its C signature."""
    from direct_stereo_slam_tpu_torch.ops import _cuda

    names = set(re.findall(r"DSSLAM_API int (dsslam_\w+)\(", CSRC.read_text()))
    assert names == {"dsslam_window_pose", "dsslam_ba_prologue", "dsslam_ba_epilogue",
                     "dsslam_marginalize"}
    assert names <= set(_cuda._SIGNATURES), sorted(names - set(_cuda._SIGNATURES))
