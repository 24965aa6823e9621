"""The port's batch evaluation over sequences (``parallel/mesh.py``)
against the JAX package's, on the CPU.

``make_batched_step`` on ``tests/test_parallel.py``'s inputs (64x32, 2
levels, 3 sequences, ``max_iterations=(4, 4)``): poses within 2e-4, the
finest residual within rel 2e-3 (that test's own tolerances), the scale
and its error within rel 1e-3; on the CPU the step is the plain loop of
``track_candidate`` and ``optimize_scale_single`` per sequence, bit for
bit. Each ``shard_*`` function on ``__graft_entry__._dryrun_impl``'s
inputs cut to tiny sizes, the JAX package's over the conftest's 8 virtual
CPU devices and the port's over a mesh of 1 and of 8 ``cpu`` entries:
the batched step as above; BA windows within the tolerances of
``test_torch_select_immature_ba.py`` (rmse rel 1e-3, poses within tangent
norm 1e-4); the candidate re-track's residuals within rel 2e-3, the same
``ok`` and winner; the scale grid's best scale and error within rel 1e-3;
the edge-split pose graph within 1e-4 per pose entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from direct_stereo_slam_tpu.config import make_config
from direct_stereo_slam_tpu.geometry import lie as lie_j
from direct_stereo_slam_tpu.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu.models.depth_template import TrackerTemplate
from direct_stereo_slam_tpu.parallel import mesh as mj
from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics as intr_t
from direct_stereo_slam_tpu_torch.models import scale_opt as so_t
from direct_stereo_slam_tpu_torch.models import tracker as tr_t
from direct_stereo_slam_tpu_torch.models.depth_template import TrackerTemplate as TT
from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid as pyr_t
from direct_stereo_slam_tpu_torch.parallel import mesh as mt
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax, to_torch
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W, H, LEVELS = 64, 32, 2


def _inputs(B, seed, budgets, max_iterations):
    cfg = make_config(W, H)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=LEVELS,
                                                    max_iterations=max_iterations))
    rng = np.random.RandomState(seed)
    img0 = rng.rand(B, H, W).astype(np.float32) * 255
    img1 = rng.rand(B, H, W).astype(np.float32) * 255
    leaves = dict(
        pu=[rng.uniform(3, (W >> l) - 4, (B, budgets[l])).astype(np.float32) for l in range(LEVELS)],
        pv=[rng.uniform(3, (H >> l) - 4, (B, budgets[l])).astype(np.float32) for l in range(LEVELS)],
        pid=[rng.uniform(0.1, 1.0, (B, budgets[l])).astype(np.float32) for l in range(LEVELS)],
        pcolor=[rng.uniform(0, 255, (B, budgets[l])).astype(np.float32) for l in range(LEVELS)],
        pmask=[np.ones((B, budgets[l]), bool) for l in range(LEVELS)])
    T_init = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    intr = make_pyramid_intrinsics(40.0, 40.0, W / 2 - 0.5, H / 2 - 0.5, W, H, LEVELS)
    jax_args = (jnp.asarray(img0), jnp.asarray(img1),
                TrackerTemplate(**{k: tuple(jnp.asarray(x) for x in v) for k, v in leaves.items()}),
                jnp.asarray(T_init))
    port_args = (torch.as_tensor(img0), torch.as_tensor(img1),
                 TT(**{k: tuple(torch.as_tensor(x) for x in v) for k, v in leaves.items()}),
                 torch.as_tensor(T_init))
    port_intr = intr_t(40.0, 40.0, W / 2 - 0.5, H / 2 - 0.5, W, H, LEVELS)
    return cfg, intr, port_intr, jax_args, port_args


def _same_step(got, want):
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.res.numpy(), np.asarray(want.res), rtol=2e-3)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-3)
    np.testing.assert_allclose(got.scale_err.numpy(), np.asarray(want.scale_err), rtol=1e-3)


def test_batched_step_matches_jax_and_the_per_sequence_loop():
    cfg, intr, intr_p, ja, pa = _inputs(3, 3, (96, 96), (4, 4))
    want = jax.jit(mj.make_batched_step(intr, cfg, LEVELS))(*ja)
    cfg_p = config_from_jax(cfg)
    got = mt.make_batched_step(intr_p, cfg_p, LEVELS)(*pa)
    assert tuple(got.T.shape) == (3, 4, 4) and got.res.shape == (3,)
    _same_step(got, want)
    img0, img1, tmpl, T_init = pa
    z = torch.zeros(())
    for s in range(3):
        tm = TT(*[tuple(x[s] for x in leaf) for leaf in tmpl])
        tr = tr_t.track_candidate(pyr_t(img0[s], LEVELS).data, tm, intr_p, cfg_p, T_init[s],
                                  tr_t.AffLight(z, z), tr_t.AffLight(z, z), z + 1, z + 1)
        sc = so_t.optimize_scale_single(pyr_t(img1[s], LEVELS).data, tm, intr_p, intr_p,
                                        mt._T10, cfg_p, 1.0)
        assert torch.equal(got.T[s], tr.T) and torch.equal(got.res[s], tr.res_per_level[0])
        assert torch.equal(got.scale[s], sc.scale) and torch.equal(got.scale_err[s], sc.error)


@pytest.fixture(scope="module")
def dryrun():
    """_dryrun_impl's batched-step inputs (8 sequences, budgets 128,
    max_iterations (2, 2)) and its JAX mesh of 8 devices."""
    assert len(jax.devices()) >= 8
    cfg, intr, intr_p, ja, pa = _inputs(8, 0, (128, 128), (2, 2))
    mesh = mj.make_mesh(8)
    step = mj.shard_batched_step(mj.make_batched_step(intr, cfg, LEVELS), mesh)
    return dict(cfg=cfg, cfg_p=config_from_jax(cfg), intr=intr, intr_p=intr_p, ja=ja, pa=pa,
                mesh=mesh, step_out=step(*ja))


@pytest.mark.parametrize("n", [1, 8])
def test_make_mesh(n):
    mesh = mt.make_mesh(n, device="cpu")
    assert mesh.size == n and mesh.axis_names == ("seq",)
    assert all(d == torch.device("cpu") for d in mesh.devices)


@pytest.mark.parametrize("n", [1, 8])
def test_shard_batched_step(dryrun, n):
    want = dryrun["step_out"]
    step = mt.make_batched_step(dryrun["intr_p"], dryrun["cfg_p"], LEVELS)
    got = mt.shard_batched_step(step, mt.make_mesh(n, device="cpu"))(*dryrun["pa"])
    _same_step(got, want)
    with pytest.raises(ValueError):
        mt.shard_batched_step(step, mt.make_mesh(3, device="cpu"))(*dryrun["pa"])


def _ba_states(B):
    from direct_stereo_slam_tpu.models import ba as ba_mod

    W_SLOTS, POOL, Hb, Wb = 4, 64, 24, 32
    calib = np.array([20.0, 20.0, Wb / 2 - 0.5, Hb / 2 - 0.5], np.float32)

    def make_state(seed):
        r = np.random.RandomState(seed)
        st = ba_mod.empty_state(W_SLOTS, POOL, Hb, Wb, calib)
        P = POOL // W_SLOTS
        for s in range(W_SLOTS):
            img = jnp.asarray(r.rand(Hb, Wb, 3).astype(np.float32) * 255)
            T = np.eye(4)
            T[2, 3] = -0.1 * s
            st = ba_mod.add_frame(st, s, s, T, np.zeros(2), 1.0, img)
            st = ba_mod.add_points(
                st, jnp.arange(s * P, (s + 1) * P), s,
                jnp.asarray(r.uniform(4, Wb - 5, P).astype(np.float32)),
                jnp.asarray(r.uniform(4, Hb - 5, P).astype(np.float32)),
                jnp.asarray(r.uniform(0.2, 1.0, P).astype(np.float32)),
                jnp.asarray(r.rand(P, 8).astype(np.float32) * 255),
                jnp.ones((P, 8), jnp.float32), jnp.ones(P, bool))
        return st

    return jax.tree_util.tree_map(lambda *leaves: jnp.stack(leaves),
                                  *[make_state(s) for s in range(B)])


def test_shard_ba_optimize(dryrun):
    from direct_stereo_slam_tpu_torch.models import ba as ba_t

    states = _ba_states(8)
    st_j, rmse_j, ok_j = mj.shard_ba_optimize(dryrun["cfg"], dryrun["mesh"], 2)(states)
    port_states = to_torch(ba_t.BAState(*[np.asarray(x) for x in states]))
    T_j = np.asarray(jax.vmap(lambda s: s.T_current())(st_j))
    for n in (1, 8):
        st, rmse, ok = mt.shard_ba_optimize(dryrun["cfg_p"], mt.make_mesh(n, device="cpu"),
                                            2)(port_states)
        assert rmse.shape == (8,) and bool(ok.all()) == bool(np.asarray(ok_j).all())
        np.testing.assert_allclose(rmse.numpy(), np.asarray(rmse_j), rtol=1e-3)
        for b in range(8):
            Tt = ba_t.BAState(*[x[b] for x in st]).T_current().numpy()
            for i in range(4):
                d = lie_j.se3_log_np(np.linalg.inv(T_j[b, i]) @ Tt[i])
                assert np.linalg.norm(d) < 1e-4, (n, b, i)


def test_shard_candidate_retrack(dryrun):
    from direct_stereo_slam_tpu.models.tracker import make_motion_tries
    from direct_stereo_slam_tpu.ops.pyramid import build_pyramid

    img0_j, _, tmpl_j, _ = dryrun["ja"]
    img0_t, _, tmpl_t, _ = dryrun["pa"]
    _, stage2 = make_motion_tries(np.eye(4), np.eye(4), np.eye(4), dryrun["cfg"])
    C = (stage2.shape[0] + 7) // 8 * 8
    T_cands = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    T_cands[:stage2.shape[0]] = stage2
    res_j, ok_j, win_j = mj.shard_candidate_retrack(dryrun["intr"], dryrun["cfg"],
                                                     dryrun["mesh"])(
        tuple(build_pyramid(img0_j[0], LEVELS).data),
        jax.tree_util.tree_map(lambda x: x[0], tmpl_j), jnp.asarray(T_cands))
    tm = TT(*[tuple(x[0] for x in leaf) for leaf in tmpl_t])
    for n in (1, 8):
        res, ok, win = mt.shard_candidate_retrack(dryrun["intr_p"], dryrun["cfg_p"],
                                                  mt.make_mesh(n, device="cpu"))(
            pyr_t(img0_t[0], LEVELS).data, tm, torch.as_tensor(T_cands))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
        np.testing.assert_allclose(res.numpy(), np.asarray(res_j), rtol=2e-3)
        assert win.shape == (n,) and int(win[0]) == int(np.asarray(win_j)[0])
        assert bool((win == win[0]).all())


def test_shard_scale_grid(dryrun):
    from direct_stereo_slam_tpu.ops.pyramid import build_pyramid

    _, img1_j, tmpl_j, _ = dryrun["ja"]
    _, img1_t, tmpl_t, _ = dryrun["pa"]
    guesses = np.resize(np.array(dryrun["cfg"].scale_opt.grid_guesses, np.float32), 8)
    t10 = np.eye(4, dtype=np.float32)
    t10[0, 3] = -0.54
    s_j, e_j = mj.shard_scale_grid(dryrun["intr"], dryrun["intr"], dryrun["cfg"],
                                   dryrun["mesh"])(
        tuple(build_pyramid(img1_j[0], LEVELS).data),
        jax.tree_util.tree_map(lambda x: x[0], tmpl_j), jnp.asarray(t10), jnp.asarray(guesses))
    tm = TT(*[tuple(x[0] for x in leaf) for leaf in tmpl_t])
    for n in (1, 8):
        s, e = mt.shard_scale_grid(dryrun["intr_p"], dryrun["intr_p"], dryrun["cfg_p"],
                                   mt.make_mesh(n, device="cpu"))(
            pyr_t(img1_t[0], LEVELS).data, tm, torch.as_tensor(t10), torch.as_tensor(guesses))
        assert s.shape == (n,) and bool((s == s[0]).all())
        np.testing.assert_allclose(float(s[0]), float(np.asarray(s_j)[0]), rtol=1e-3)
        np.testing.assert_allclose(float(e[0]), float(np.asarray(e_j)[0]), rtol=1e-3)


def test_shard_posegraph_optimize(dryrun):
    from direct_stereo_slam_tpu.loop.pose_graph import build_data as build_j
    from direct_stereo_slam_tpu_torch.loop.pose_graph import build_data as build_t

    n_pg = 256
    rng = np.random.RandomState(1)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_pg, 1, 1))
    for i in range(1, n_pg):
        poses[i] = poses[i - 1].copy()
        poses[i][:3, 3] += np.array([0.1, 0.0, 0.0]) + rng.normal(0, 0.002, 3)
    edges = []
    for i in range(1, n_pg):
        Z = np.linalg.inv(poses[i]) @ poses[i - 1]
        Z[:3, 3] += rng.normal(0, 0.001, 3)
        edges.append((i, i - 1, Z.astype(np.float32), 1.0, 1e4))
    Zl = np.eye(4, dtype=np.float32)
    Zl[0, 3] = -0.1 * (n_pg - 1)
    edges.append((n_pg - 1, 0, Zl, 10.0, 1e4))
    want = np.asarray(mj.shard_posegraph_optimize(dryrun["mesh"], iterations=4, cg_iters=50)(
        build_j(poses, edges, fixed_node=n_pg - 1)))
    data = build_t(poses, edges, fixed_node=n_pg - 1)
    for n in (1, 8):
        got = mt.shard_posegraph_optimize(mt.make_mesh(n, device="cpu"), iterations=4,
                                          cg_iters=50)(data)
        assert got.shape == (data.T_wc.shape[0], 4, 4)
        np.testing.assert_allclose(got.numpy()[:n_pg], want[:n_pg], atol=1e-4, rtol=0)
