"""Parity of the port's pixel selector, immature points (create, trace,
activate) and windowed BA with the JAX package, at a small size (96x48).

The BA window is built once with the JAX package and carried into the
port by ``utils/convert.py``; both then run the same steps. Tolerances:
selection maps and statuses equal; trace intervals rel 1e-4; activated
idepths rel 1e-4 or abs 1e-5 (a 3-step 1-D LM on sums over window x
pattern taken in another order); linearized
H/b per entry within 1e-3 x max|entry| (sums over ~10^4 residual pixels
in another order); one ``optimize_keyframe`` gives poses within tangent
norm 1e-4 and energies within rel 1e-3.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from direct_stereo_slam_tpu.config import PATTERN_OFFSETS, make_config
from direct_stereo_slam_tpu.geometry import lie as lie_j
from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
from direct_stereo_slam_tpu.models import ba as ba_j
from direct_stereo_slam_tpu.models import immature as im_j
from direct_stereo_slam_tpu.ops import select as sel_j
from direct_stereo_slam_tpu.ops.pyramid import build_pyramid as pyr_j
from direct_stereo_slam_tpu_torch.models import ba as ba_t
from direct_stereo_slam_tpu_torch.models import immature as im_t
from direct_stereo_slam_tpu_torch.ops import select as sel_t
from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid as pyr_t
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax as port_cfg
from direct_stereo_slam_tpu_torch.utils.convert import to_numpy, to_torch

pytestmark = pytest.mark.smoke

W, H = 96, 48
N_SLOTS, N_POINTS = 4, 256


@pytest.fixture(scope="module")
def scene():
    ds = SyntheticStereoDataset(n_frames=3, width=W, height=H, speed=0.25, yaw_rate=0.01)
    frames = [ds.frame(i) for i in range(3)]
    cfg = make_config(W, H, preset=0, mode=1)
    return ds, frames, cfg


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * max(float(np.abs(want).max()), 1e-30), rtol=0)


def _pose_err(Ta, Tb):
    return float(np.linalg.norm(lie_j.se3_log_np(np.linalg.inv(Ta) @ Tb)))


@pytest.mark.parametrize("pot", [1, 3])
def test_selection_map_matches(scene, pot):
    ds, frames, cfg = scene
    img = frames[0]["img0"]
    pj = pyr_j(jnp.asarray(img), 3)
    pt = pyr_t(torch.tensor(img), 3)
    mj, cj = sel_j.make_selection_map(pj.abs_grad[0], pj.abs_grad[1], pj.abs_grad[2], pot, cfg)
    mt, ct = sel_t.make_selection_map(pt.abs_grad[0], pt.abs_grad[1], pt.abs_grad[2], pot, port_cfg(cfg))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert int(ct) == int(cj) > 0
    for got, want in ((10, 100.0), (60, 100.0), (100, 100.0), (200, 100.0), (500, 100.0)):
        assert sel_t.adapt_potential(pot, got, want) == sel_j.adapt_potential(pot, got, want)


def _immatures(frame, cfg, budget=96):
    pj = pyr_j(jnp.asarray(frame["img0"]), 3)
    mj, _ = sel_j.make_selection_map(pj.abs_grad[0], pj.abs_grad[1], pj.abs_grad[2], 2, cfg)
    ij = im_j.create_points(pj.data[0], mj, budget)
    it = im_t.create_points(torch.tensor(np.asarray(pj.data[0])), torch.tensor(np.asarray(mj)),
                            budget)
    return pj, ij, it


def test_create_points_matches(scene):
    ds, frames, cfg = scene
    _, ij, it = _immatures(frames[0], cfg)
    for name in im_t.ImmaturePoints._fields:
        a, b = np.asarray(getattr(ij, name)), getattr(it, name).numpy()
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def _window_transforms(frames, slots_from, target):
    """KRKi, Kt of each host slot (frame index) into ``target``."""
    K = SyntheticStereoDataset(n_frames=1, width=W, height=H).K.astype(np.float32)
    Ki = np.linalg.inv(K)
    T_cw_t = np.linalg.inv(frames[target]["pose_w_c0"])
    KRKi, Kt = [], []
    for h in slots_from:
        T = T_cw_t @ frames[h]["pose_w_c0"]
        KRKi.append(K @ T[:3, :3] @ Ki)
        Kt.append(K @ T[:3, 3])
    return np.asarray(KRKi, np.float32), np.asarray(Kt, np.float32)


def test_trace_and_activate_match(scene):
    ds, frames, cfg = scene
    _, ij0, _ = _immatures(frames[0], cfg)
    _, ij1, _ = _immatures(frames[1], cfg)
    # two slots of candidates (hosted in frames 0 and 1), traced into frame 2
    stack_j = im_j.empty_batch(2, ij0.u.shape[0])
    stack_j = im_j.set_slot(stack_j, jnp.int32(0), ij0)
    stack_j = im_j.set_slot(stack_j, jnp.int32(1), ij1)
    stack_t = to_torch(to_numpy(to_torch(stack_j)))
    KRKi, Kt = _window_transforms(frames, [0, 1], 2)
    a = np.array([1.0, 1.02], np.float32)
    b = np.array([0.0, -1.5], np.float32)
    planes = pyr_j(jnp.asarray(frames[2]["img0"]), 1).data[0]
    out_j, ns_j, no_j = im_j.trace_points_all_compact(
        stack_j, planes, jnp.asarray(KRKi), jnp.asarray(Kt), jnp.asarray(a), jnp.asarray(b),
        cfg, budget=128)
    out_t, ns_t, no_t = im_t.trace_points_all_compact(
        stack_t, torch.tensor(np.asarray(planes)), torch.tensor(KRKi), torch.tensor(Kt),
        torch.tensor(a), torch.tensor(b), port_cfg(cfg), budget=128)
    assert int(ns_t) == int(ns_j) > 0 and int(no_t) == int(no_j)
    np.testing.assert_array_equal(out_t.status.numpy(), np.asarray(out_j.status))
    for name in ("idepth_min", "idepth_max", "quality", "pixel_interval"):
        a_, b_ = np.asarray(getattr(out_j, name)), getattr(out_t, name).numpy()
        fin = np.isfinite(a_)
        np.testing.assert_array_equal(np.isfinite(b_), fin, err_msg=name)
        np.testing.assert_allclose(b_[fin], a_[fin], rtol=1e-4, atol=1e-5, err_msg=name)
    assert (out_t.status.numpy() == im_t.IPS_GOOD).sum() > 10

    # activation of the traced candidates against a 3-frame window
    images = jnp.stack([pyr_j(jnp.asarray(f["img0"]), 1).data[0] for f in frames])
    T_cw = jnp.asarray(np.stack([np.linalg.inv(f["pose_w_c0"]) for f in frames]), jnp.float32)
    aff = jnp.zeros((3, 2), jnp.float32)
    K = ds.K
    calib = jnp.asarray([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], jnp.float32)
    fv = jnp.ones(3, bool)
    expo = jnp.ones(3, jnp.float32)
    slots = jnp.arange(2, dtype=jnp.int32)
    acts_j = im_j.activate_points_all(out_j, slots, images, fv, T_cw, aff, calib, expo, cfg)
    acts_t = im_t.activate_points_all(to_torch(to_numpy(to_torch(out_j))), torch.arange(2),
                                      *[torch.tensor(np.asarray(x)) for x in
                                        (images, fv, T_cw, aff, calib, expo)], port_cfg(cfg))
    np.testing.assert_array_equal(acts_t.ok.numpy(), np.asarray(acts_j.ok))
    np.testing.assert_array_equal(acts_t.num_good.numpy(), np.asarray(acts_j.num_good))
    ok = np.asarray(acts_j.ok)
    assert ok.sum() > 5
    np.testing.assert_allclose(acts_t.idepth.numpy()[ok], np.asarray(acts_j.idepth)[ok],
                               rtol=1e-4, atol=1e-5)
    ca_j, ca_t = im_j.can_activate(out_j, cfg), im_t.can_activate(out_t, port_cfg(cfg))
    np.testing.assert_array_equal(ca_t.numpy(), np.asarray(ca_j))


def _ba_window(frames, cfg, perturb=2e-3, seed=0):
    """A 3-frame window with points hosted in every frame, poses perturbed,
    built with the JAX package."""
    K = SyntheticStereoDataset(n_frames=1, width=W, height=H).K
    calib = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)
    st = ba_j.empty_state(N_SLOTS, N_POINTS, H, W, calib)
    rng = np.random.RandomState(seed)
    for i, f in enumerate(frames):
        T = np.linalg.inv(f["pose_w_c0"]).astype(np.float32)
        if i > 0:
            xi = rng.randn(6) * perturb
            xi[3:] *= 0.3
            T = np.asarray(lie_j.se3_exp(jnp.asarray(xi, jnp.float32))) @ T
        st = ba_j.add_frame(st, i, i, T, np.zeros(2), 1.0, pyr_j(jnp.asarray(f["img0"]), 1).data[0])
    P = N_POINTS // N_SLOTS
    per = 48
    for h, f in enumerate(frames):
        us = rng.randint(4, W - 5, per).astype(np.float32)
        vs = rng.randint(4, H - 5, per).astype(np.float32)
        idepth = (1.0 / f["depth0"][vs.astype(int), us.astype(int)]).astype(np.float32)
        idepth *= 1.0 + 0.02 * rng.randn(per).astype(np.float32)
        img = f["img0"]
        color = np.stack([img[np.clip((vs + dv).astype(int), 0, H - 1),
                              np.clip((us + du).astype(int), 0, W - 1)]
                          for du, dv in PATTERN_OFFSETS], -1).astype(np.float32)
        st = ba_j.add_points(st, jnp.arange(h * P, h * P + per), h, jnp.asarray(us),
                             jnp.asarray(vs), jnp.asarray(idepth), jnp.asarray(color),
                             jnp.ones((per, 8), jnp.float32), jnp.ones(per, bool))
    for i in range(1, len(frames)):
        st = ba_j.set_new_frame_energy_th(st, jnp.int32(i), cfg)
    return st


def _to_port(st_j):
    return to_torch(to_numpy(to_torch(st_j)))


def test_linearize_and_solve_match(scene):
    ds, frames, cfg = scene
    st_j = _ba_window(frames, cfg)
    st_t = _to_port(st_j)
    lj, lt = ba_j.linearize(st_j, cfg), ba_t.linearize(st_t, port_cfg(cfg))
    np.testing.assert_array_equal(lt.pair_good.numpy(), np.asarray(lj.pair_good))
    np.testing.assert_array_equal(lt.pair_in.numpy(), np.asarray(lj.pair_in))
    for name in ("Hff", "bf", "Hfd", "Hdd", "bd"):
        _close(getattr(lt, name).numpy(), getattr(lj, name), 1e-3)
    np.testing.assert_allclose(float(lt.energy), float(lj.energy), rtol=1e-5)
    assert float(lt.num_terms) == float(lj.num_terms) > 0
    xj, xdj = ba_j.solve_step(st_j, lj, jnp.float32(0.1), cfg)
    xt, xdt = ba_t.solve_step(st_t, lt, torch.tensor(0.1), port_cfg(cfg))
    _close(xt.numpy(), xj, 1e-3)
    _close(xdt.numpy(), xdj, 1e-3)
    views_j = ba_j.current_views(st_j)
    views_t = ba_t.current_views(st_t)
    for a, b in zip(views_j, views_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_optimize_keyframe_and_marginalization_match(scene):
    ds, frames, cfg = scene
    st_j = _ba_window(frames, cfg)
    st_t = _to_port(st_j)
    rj = ba_j.optimize_keyframe(st_j, cfg, 6, 2, None)
    rt = ba_t.optimize_keyframe(st_t, port_cfg(cfg), 6, 2, None)
    np.testing.assert_allclose(float(rt[1]), float(rj[1]), rtol=1e-3)       # rmse
    assert bool(rt[2]) == bool(rj[2])
    Tj, Tt = np.asarray(rj[0].T_current()), rt[0].T_current().numpy()
    for i in range(3):
        assert _pose_err(Tt[i], Tj[i]) < 1e-4, i
    np.testing.assert_allclose(rt[0].energy_th.numpy(), np.asarray(rj[0].energy_th), rtol=1e-3)
    np.testing.assert_array_equal(rt[0].p_valid.numpy(), np.asarray(rj[0].p_valid))
    np.testing.assert_array_equal(rt[0].p_last_res.numpy(), np.asarray(rj[0].p_last_res))
    _close(rt[3].numpy(), rj[3], 1e-3)                                     # Hdd

    # template inputs, then point and frame marginalization on the result
    ti_j = ba_j.template_inputs(rj[0], cfg, jnp.int32(2), rj[3])
    ti_t = ba_t.template_inputs(rt[0], port_cfg(cfg), 2, rt[3])
    np.testing.assert_array_equal(ti_t[4].numpy(), np.asarray(ti_j[4]))
    for a, b in zip(ti_j[:4], ti_t[:4]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3, atol=1e-3)
    marg = np.zeros(N_POINTS, bool)
    marg[:20] = True
    mj = ba_j.marginalize_frame(ba_j.marginalize_points(rj[0], jnp.asarray(marg), cfg), jnp.int32(0))
    mt = ba_t.marginalize_frame(ba_t.marginalize_points(rt[0], torch.tensor(marg), port_cfg(cfg)), 0)
    _close(mt.HM.numpy(), mj.HM, 2e-3)
    _close(mt.bM.numpy(), mj.bM, 2e-3)
    np.testing.assert_array_equal(mt.p_valid.numpy(), np.asarray(mj.p_valid))
    np.testing.assert_array_equal(mt.frame_valid.numpy(), np.asarray(mj.frame_valid))


def test_compact_optimize_equals_full(scene):
    """The compact (valid-rows-first) BA view gives the full-pool result."""
    ds, frames, cfg = scene
    st_t = _to_port(_ba_window(frames, cfg))
    full = ba_t.optimize_keyframe(st_t, port_cfg(cfg), 3, 2, None)
    comp = ba_t.optimize_keyframe(st_t, port_cfg(cfg), 3, 2, 160)
    assert int(comp[4]) == 0
    np.testing.assert_allclose(comp[0].T_current().numpy(), full[0].T_current().numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(comp[0].p_valid.numpy(), full[0].p_valid.numpy())


def test_activation_allocator_matches():
    """The activation insertion allocator (own pool segment first, then any
    free row, capped by capacity) picks the same rows as the reference's."""
    from direct_stereo_slam_tpu.models import frontend as fe_j
    from direct_stereo_slam_tpu_torch.models import frontend as fe_t

    rng = np.random.RandomState(4)
    S, BUD, NI, P = 4, 24, 32, 16
    B = S * P
    ok = rng.rand(S, BUD) < 0.6
    lane = np.stack([np.sort(rng.choice(NI, BUD, replace=False)) for _ in range(S)])
    drop = rng.rand(S, NI) < 0.2
    p_valid = rng.rand(B) < 0.5
    participate = np.array([True, False, True, True])
    out_j = fe_j._allocate_candidates(jnp.asarray(ok), jnp.asarray(lane, jnp.int32),
                                      jnp.asarray(drop), jnp.asarray(p_valid),
                                      jnp.asarray(participate), P)
    out_t = fe_t._allocate_candidates(torch.tensor(ok), torch.tensor(lane), torch.tensor(drop),
                                      torch.tensor(p_valid), participate, P)
    valid = np.asarray(out_j[5])
    np.testing.assert_array_equal(out_t[5].numpy(), valid)
    assert valid.sum() > 0
    for a, b in zip(out_j[:5], out_t[:5]):
        np.testing.assert_array_equal(b.numpy()[valid], np.asarray(a)[valid])
    np.testing.assert_array_equal(out_t[6].numpy(), np.asarray(out_j[6]))
