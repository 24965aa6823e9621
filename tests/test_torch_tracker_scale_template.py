"""Parity of the port's depth template, coarse tracker and stereo scale
optimizer with the JAX package, on small rendered frames (96x48, 3
levels).

Tolerances: template masks equal and idepths rel 1e-6 (same float32
scatter-add, pooling and dilation); tracked pose within tangent norm 1e-4
(the LM runs the same schedule on H, b that agree to float32 rounding);
scales within rel 1e-4.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from direct_stereo_slam_tpu.config import make_config
from direct_stereo_slam_tpu.geometry import lie as lie_j
from direct_stereo_slam_tpu.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
from direct_stereo_slam_tpu.models import depth_template as dt_j
from direct_stereo_slam_tpu.models import scale_opt as so_j
from direct_stereo_slam_tpu.models import tracker as tr_j
from direct_stereo_slam_tpu.ops import interp as interp_j
from direct_stereo_slam_tpu.ops.pyramid import build_pyramid as pyr_j
from direct_stereo_slam_tpu_torch.models import depth_template as dt_t
from direct_stereo_slam_tpu_torch.models import scale_opt as so_t
from direct_stereo_slam_tpu_torch.models import tracker as tr_t
from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid as pyr_t
from direct_stereo_slam_tpu_torch.utils.convert import to_numpy, to_torch

pytestmark = pytest.mark.smoke

W, H, LVLS = 96, 48, 3


@pytest.fixture(scope="module")
def setup():
    ds = SyntheticStereoDataset(n_frames=3, width=W, height=H, speed=0.25)
    frames = [ds.frame(i) for i in range(3)]
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LVLS)
    cfg = make_config(W, H, preset=0, mode=1)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=LVLS,
                                                    max_iterations=(10, 20, 20)))
    return ds, frames, intr, cfg


def _template_inputs(frame, n=600, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    us = rng.uniform(3, W - 4, n).astype(np.float32)
    vs = rng.uniform(3, H - 4, n).astype(np.float32)
    depth = np.asarray(frame["depth0"])[vs.astype(int), us.astype(int)]
    pid = (scale / depth).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    valid = rng.rand(n) < 0.95
    return us, vs, pid, w, valid


def _templates(frame, **kw):
    us, vs, pid, w, valid = _template_inputs(frame, **kw)
    budgets = dt_j.default_budgets(W, H, LVLS)
    tj = dt_j.build_template(jnp.asarray(us), jnp.asarray(vs), jnp.asarray(pid),
                             jnp.asarray(w), jnp.asarray(frame["img0"]), LVLS, budgets,
                             valid=jnp.asarray(valid))
    tt = dt_t.build_template(*[torch.as_tensor(a) for a in (us, vs, pid, w)],
                             torch.as_tensor(frame["img0"]), LVLS, budgets,
                             valid=torch.as_tensor(valid))
    return tj, tt


def test_template_matches(setup):
    ds, frames, intr, cfg = setup
    tj, tt = _templates(frames[0])
    assert dt_t.default_budgets(1232, 368, 5) == dt_j.default_budgets(1232, 368, 5)
    for lvl in range(LVLS):
        np.testing.assert_array_equal(tt.pmask[lvl].numpy(), np.asarray(tj.pmask[lvl]))
        np.testing.assert_array_equal(tt.pu[lvl].numpy(), np.asarray(tj.pu[lvl]))
        np.testing.assert_array_equal(tt.pv[lvl].numpy(), np.asarray(tj.pv[lvl]))
        np.testing.assert_allclose(tt.pid[lvl].numpy(), np.asarray(tj.pid[lvl]), rtol=1e-6)
        np.testing.assert_allclose(tt.pcolor[lvl].numpy(), np.asarray(tj.pcolor[lvl]),
                                   rtol=1e-6)
    scaled = dt_t.scale_template_idepth(tt, torch.tensor(2.0))
    np.testing.assert_allclose(scaled.pid[0].numpy(), tt.pid[0].numpy() / 2.0, rtol=1e-6)


def _pose_err(Ta, Tb):
    return float(np.linalg.norm(lie_j.se3_log_np(np.linalg.inv(Ta) @ Tb)))


def test_track_candidate_and_batch_match(setup):
    ds, frames, intr, cfg = setup
    tj, _ = _templates(frames[0])
    tt = to_torch(to_numpy(tj))           # the same template carried across
    pyr1_j = pyr_j(jnp.asarray(frames[1]["img0"]), LVLS)
    pyr1_t = pyr_t(torch.as_tensor(frames[1]["img0"]), LVLS)
    stage1, stage2 = tr_t.make_motion_tries(np.eye(4), np.eye(4), np.eye(4), cfg)
    s1j, s2j = tr_j.make_motion_tries(np.eye(4), np.eye(4), np.eye(4), cfg)
    np.testing.assert_array_equal(stage1, s1j)
    np.testing.assert_array_equal(stage2, s2j)
    batch = np.concatenate([stage1[:2], stage2[:2]])
    zero = AffJ = tr_j.AffLight(jnp.float32(0.0), jnp.float32(0.0))
    rj = tr_j.track_candidates_batch(tuple(pyr1_j.data), tj, intr, cfg, jnp.asarray(batch),
                                     AffJ, zero, jnp.float32(1.0), jnp.float32(1.0))
    zt = tr_t.AffLight(torch.tensor(0.0), torch.tensor(0.0))
    rt = tr_t.track_candidates_batch(tuple(pyr1_t.data), tt, intr, cfg,
                                     torch.as_tensor(batch), zt, zt, torch.tensor(1.0), 1.0)
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    for i in range(len(batch)):
        assert _pose_err(rt.T[i].numpy(), np.asarray(rj.T[i])) < 1e-4, i
    np.testing.assert_allclose(rt.res_per_level.numpy(), np.asarray(rj.res_per_level),
                               rtol=1e-3)
    np.testing.assert_allclose(rt.flow.numpy(), np.asarray(rj.flow), rtol=1e-3, atol=1e-4)
    # the tracker recovers the true motion (ref -> frame 1 warp)
    T_true = np.linalg.inv(frames[1]["pose_w_c0"]) @ frames[0]["pose_w_c0"]
    i_best, good = tr_t.select_winner(rt, 1e9, cfg)
    assert good and _pose_err(rt.T[i_best].numpy(), T_true) < 0.02
    assert tr_t.select_winner(rt, 1e9, cfg) == tr_j.select_winner(rj, 1e9, cfg)
    assert (tr_t.select_winner_serial(rt, 1e9, cfg)
            == tr_j.select_winner_serial(rj, 1e9, cfg))
    # single candidate = batch of one
    one = tr_t.track_candidate(tuple(pyr1_t.data), tt, intr, cfg, torch.as_tensor(batch[1]),
                               zt, zt, torch.tensor(1.0), 1.0)
    assert _pose_err(one.T.numpy(), rt.T[1].numpy()) < 1e-6


def _full_template(frame, intr, seed=1, scale=1.6):
    """A template whose every lane is live, at sub-pixel positions (the
    scale LM then moves; see test_scale_on_padded_template for why a
    padded template does not)."""
    rng = np.random.RandomState(seed)
    cols = {k: [] for k in ("pu", "pv", "pid", "pcolor", "pmask")}
    img = pyr_j(jnp.asarray(frame["img0"]), LVLS)
    for lvl in range(LVLS):
        n = 512 >> lvl
        wl, hl = intr.w[lvl], intr.h[lvl]
        u = rng.uniform(4, wl - 5, n).astype(np.float32)
        v = rng.uniform(4, hl - 5, n).astype(np.float32)
        s_ = 1 << lvl
        d = np.asarray(frame["depth0"])[(v * s_).astype(int), (u * s_).astype(int)]
        cols["pu"].append(u)
        cols["pv"].append(v)
        cols["pid"].append((scale / d).astype(np.float32))
        cols["pcolor"].append(np.asarray(interp_j.bilinear_gather_scalar(
            img.data[lvl][..., 0], jnp.asarray(u), jnp.asarray(v))))
        cols["pmask"].append(np.ones(n, bool))
    return dt_j.TrackerTemplate(*[tuple(jnp.asarray(a) for a in cols[k])
                                  for k in dt_j.TrackerTemplate._fields])


def test_scale_batch_matches(setup):
    ds, frames, intr, cfg = setup
    f0 = frames[0]
    tj = _full_template(f0, intr)          # idepths wrong by a factor 1.6
    tt = to_torch(to_numpy(tj))
    t10 = ds.t_cam1_cam0
    pyr1_j = pyr_j(jnp.asarray(f0["img1"]), LVLS)
    pyr1_t = pyr_t(torch.as_tensor(f0["img1"]), LVLS)
    guesses = np.array([0.5, 1.0, 5.0], np.float32)
    oj = so_j.optimize_scale_batch(tuple(pyr1_j.data), tj, jnp.asarray(guesses), intr,
                                   intr, jnp.asarray(t10), cfg)
    ot = so_t.optimize_scale_batch(tuple(pyr1_t.data), tt, torch.as_tensor(guesses), intr,
                                   intr, torch.as_tensor(t10), cfg)
    np.testing.assert_allclose(ot.scale.numpy(), np.asarray(oj.scale), rtol=1e-4)
    np.testing.assert_allclose(ot.error.numpy(), np.asarray(oj.error), rtol=1e-4)
    assert abs(float(ot.scale[1]) - 1.6) / 1.6 < 0.05
    st_t, st_j = so_t.ScaleState(), so_j.ScaleState()
    dec_t = so_t.decide_scale_optimization(ot.scale.numpy(), ot.error.numpy(), cfg, st_t)
    dec_j = so_j.decide_scale_optimization(np.asarray(oj.scale), np.asarray(oj.error),
                                           cfg, st_j)
    assert dec_t[0] == dec_j[0] and vars(st_t) == vars(st_j)
    np.testing.assert_allclose(dec_t[1:3], dec_j[1:3], rtol=1e-4)


def test_scale_on_padded_template(setup):
    """build_template pads its lists with pid = 0 lanes; in the reference's
    scale pass those make H and b NaN (0 * NaN in the masked sums), so the
    LM step is rejected and each guess keeps its value. The port does the
    same. The final error is compared at rel 5e-3: with R01 = I the warp
    maps template rows onto themselves, rows 2 and H-3 sit exactly on the
    strict bounds, and one float32 rounding moves a whole row in or out —
    the JAX package's own jitted and eager passes differ by 0.13% here."""
    ds, frames, intr, cfg = setup
    f0 = frames[0]
    tj, _ = _templates(f0, n=1500, scale=1.6)
    tt = to_torch(to_numpy(tj))
    t10 = ds.t_cam1_cam0
    guesses = np.array([0.5, 1.0, 5.0], np.float32)
    oj = so_j.optimize_scale_batch(tuple(pyr_j(jnp.asarray(f0["img1"]), LVLS).data), tj,
                                   jnp.asarray(guesses), intr, intr, jnp.asarray(t10), cfg)
    ot = so_t.optimize_scale_batch(tuple(pyr_t(torch.as_tensor(f0["img1"]), LVLS).data), tt,
                                   torch.as_tensor(guesses), intr, intr,
                                   torch.as_tensor(t10), cfg)
    np.testing.assert_array_equal(np.asarray(oj.scale), guesses)
    np.testing.assert_array_equal(ot.scale.numpy(), guesses)
    np.testing.assert_allclose(ot.error.numpy(), np.asarray(oj.error), rtol=5e-3)
