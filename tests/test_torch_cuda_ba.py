"""The windowed BA's kernels K9-K11 (csrc/ba.cu) against their plain
PyTorch versions on the card (models/ba.py), on windows built with the
port alone (``torch_ba_window.py``, 96x48):

- K9 (``linearize`` on a CUDA state) against ``linearize_plain`` at edge
  shapes: 1 to 8 slots, 129 / 200 / 300 points (no multiple of K9's
  rounds of 32 points or its 8 chunks of a host's points), a pool in
  random order (not grouped by host), a pool of 12500 (K10's rows beyond
  what one cluster's shared memory holds), a point whose pattern projects
  out of the image, a NaN pose. Hff, bf, Hfd, Hdd and bd within 1e-4 x max|entry|, or,
  where a sum cancels, x the largest sum of its terms' magnitudes
  (``linearize_plain(magnitudes=True)``; sums of ~10^4 products in
  another order), the energy within rel 1e-5, the same
  num_terms; pair_good / pair_in equal except on lanes within 1e-5
  relative of their energy threshold; the same NaN pattern;
- K10 against ``solve_step`` / ``apply_step`` / ``_step_converged``: x
  and x_d within 1e-3 x max|entry| (Gauss-Jordan with partial pivoting
  against torch.linalg.solve_ex on a system damped by lam: 0.1, and 1e-6
  where the scale direction is nearly free), the same convergence flag,
  at 1 to 8 slots (the padded system of 8 W - 4 free unknowns), the
  anchor moved to slot 1 (slot 0 invalid, frozen at 1e12), an empty slot
  frozen at 1e12, a pool in random order, 12500 points (each block's rows
  in chunks) and a NaN pose (x all NaN); two launches bit-equal;
- ``optimize_keyframe`` with the LM loop on the card against the same
  call with the plain loop on the same card state: rmse within rel 1e-3, poses within 1e-3 per
  entry, the same ok; energy-gated at 6 and 20 iterations, DSO's
  force-accept, and a NaN pose (the same NaN pattern and ok);
- the resident launch (``optimize_keyframe``'s LM loop and bookkeeping
  in one launch) bit-equal to the queued K9 -> K11, K10 -> K9 -> K11
  chain and ``_finish_optimize`` (state, linearization, p_res_good,
  p_num_good, p_last_res, rmse, ok, the final control and the rounds
  run) at 1 to 8 slots and pools of 129 to 12500 points (2560 and 4096:
  the keyframe path's sizes), energy-gated and force-accept, at 0, 1, 6
  and 20 iterations (20: the loop leaves early), with a NaN pose and a
  shuffled pool; its grid every block resident;
- two runs bit-equal (K9, and ``optimize_keyframe``) without
  ``torch.use_deterministic_algorithms``; ``optimize_keyframe`` with no
  host read (``torch.cuda.set_sync_debug_mode("error")``) and its
  launches: one resident launch, no queued K9, K10 or K11;
- the ``parallel/mesh.py`` shard functions on ``make_mesh(1)`` against
  the same call on CPU tensors (BA windows as above; the candidate
  re-track's ok equal, residuals within rel 2e-3; the scale grid within
  rel 1e-3; the one-shard pose graph, one resident CG launch, within 2e-3
  x the translation scale of the CPU's CG and the same bits on two runs).

These tests need a CUDA card and skip elsewhere. They import nothing of
JAX, so on the card's machine they run without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_ba.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu_torch.models import ba
from direct_stereo_slam_tpu_torch.ops import ba as kb
from torch_ba_window import ba_window, with_nan_pose

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _rel(got, want):
    scale = float(torch.max(torch.abs(want)).clamp(min=1e-30))
    return float(torch.max(torch.abs(got - want))) / scale


def _window(dev, n_slots=4, n_points=256, **kw):
    n_frames = kw.pop("n_frames", min(n_slots, 5 if n_slots > 4 else 3))
    per = min(48, n_points // n_slots)
    return ba_window(n_slots, n_points, n_frames=n_frames, per=per, device=dev, **kw)


def _same_lin(got, want, st, cfg):
    mag = ba.linearize_plain(st, cfg, magnitudes=True)
    for name in ("Hff", "bf", "Hfd", "Hdd", "bd", "pair_energy"):
        a, b = getattr(got, name), getattr(want, name)
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        fin = ~torch.isnan(b)
        if fin.any():
            # where a sum cancels: 1e-4 x the largest sum of its terms' magnitudes
            scale = max(float(torch.max(torch.abs(b[fin]))), float(torch.max(
                getattr(mag, name)[fin])) if name != "pair_energy" else 0.0)
            err = float(torch.max(torch.abs(a[fin] - b[fin])))
            assert err <= 1e-4 * scale, (name, err, scale)
    assert torch.equal(torch.isnan(got.energy), torch.isnan(want.energy))
    if torch.isfinite(want.energy):
        assert abs(float(got.energy) - float(want.energy)) <= 1e-5 * abs(float(want.energy))
    # a pair may flip only where its energy sits on its threshold
    th = torch.maximum(st.energy_th[st.p_host][:, None], st.energy_th[None, :])
    near = torch.abs(want.pair_energy - th) <= 1e-5 * th
    for name in ("pair_good", "pair_in"):
        diff = getattr(got, name) != getattr(want, name)
        assert not bool((diff & ~near).any()), name
    if not bool((got.pair_good != want.pair_good).any()):
        assert float(got.num_terms) == float(want.num_terms)


def _shuffled(st, seed=0):
    """The window with its point pool in a random order: the hosts' points
    interleaved, every sum over points taken in another order."""
    perm = torch.as_tensor(np.random.RandomState(seed).permutation(st.num_points),
                           device=st.p_host.device)
    return st._replace(**{f: getattr(st, f)[perm] for f in ba._POINT_FIELDS})


def _case(st, case):
    if case == "nan_pose":
        return with_nan_pose(st)
    if case == "shuffled":
        return _shuffled(st)
    return st


@pytest.mark.parametrize("n_slots,n_points,case", [
    (4, 256, "base"), (4, 200, "base"), (2, 200, "base"), (8, 200, "base"),
    (8, 256, "base"), (4, 200, "outside"), (4, 256, "nan_pose"), (1, 200, "base"),
    (3, 200, "base"), (5, 300, "base"), (6, 129, "base"), (7, 200, "base"),
    (8, 256, "shuffled"), (8, 256, "nan_pose"), (8, 12500, "base")])
def test_k9_matches_linearize_plain(dev, n_slots, n_points, case):
    st, cfg = _window(dev, n_slots, n_points, outside=case == "outside")
    st = _case(st, case)
    got, want = ba.linearize(st, cfg), ba.linearize_plain(st, cfg)
    _same_lin(got, want, st, cfg)
    if case == "nan_pose":
        assert bool(torch.isnan(got.Hff).any()) and bool(torch.isfinite(got.energy))
    again = ba.linearize(st, cfg)
    for a, b in zip(got, again):
        assert torch.equal(torch.nan_to_num(a.float(), 7.0), torch.nan_to_num(b.float(), 7.0))


def _k10(st, lin, lam, cfg):
    states = {f: torch.stack([getattr(st, f)] * 2) for f in kb.STATE_FIELDS}
    lins = {f: torch.stack([getattr(lin, f)] * 2) for f in kb.LIN_FIELDS}
    params = kb.make_params(st, cfg, states, lins)
    params.bufs.ctrl_f[0] = lam
    kb.ba_step_cuda(params)
    return params


@pytest.mark.parametrize("n_slots,n_points,case", [
    (4, 256, "base"), (4, 256, "lam_small"), (4, 256, "anchor_moved"), (4, 256, "nan_pose"),
    (1, 200, "base"), (2, 200, "base"), (3, 200, "base"), (5, 300, "base"),
    (6, 129, "base"), (7, 200, "base"), (8, 256, "base"), (8, 256, "shuffled"),
    (8, 256, "nan_pose"), (8, 12500, "base")])
def test_k10_matches_solve_step(dev, n_slots, n_points, case):
    st, cfg = _window(dev, n_slots, n_points)
    lam = 1e-6 if case == "lam_small" else 0.1
    if case == "anchor_moved":
        fv = st.frame_valid.clone()
        fv[0] = False
        st = st._replace(frame_valid=fv, p_valid=st.p_valid & (st.p_host != 0))
    st = _case(st, case)
    if n_slots == 4:
        assert not bool(st.frame_valid[3])      # an empty slot, frozen at 1e12
    lin = ba.linearize_plain(st, cfg)
    x, x_d = ba.solve_step(st, lin, torch.tensor(lam, device=dev), cfg)
    conv = ba._step_converged(x, x_d, st, cfg)
    new = ba.apply_step(st, x, x_d)
    p = _k10(st, lin, lam, cfg)
    xk, xdk = p.bufs.scratch["x"], p.bufs.scratch["x_d"]
    again = _k10(st, lin, lam, cfg)
    for a, b in ((xk, again.bufs.scratch["x"]), (xdk, again.bufs.scratch["x_d"]),
                 (p.bufs.state["p_idepth"][1], again.bufs.state["p_idepth"][1]),
                 (p.bufs.state["delta"][1], again.bufs.state["delta"][1]),
                 (p.bufs.ctrl_i, again.bufs.ctrl_i)):
        assert torch.equal(torch.nan_to_num(a.float(), 7.0), torch.nan_to_num(b.float(), 7.0))
    if case == "nan_pose":
        assert bool(torch.isnan(x).all()) and bool(torch.isnan(xk).all())
        return
    assert _rel(xk, x) < 1e-3 and _rel(xdk, x_d) < 1e-3, (_rel(xk, x), _rel(xdk, x_d))
    assert bool(p.bufs.ctrl_i[2]) == bool(conv)
    assert _rel(p.bufs.state["delta"][1], new.delta) < 1e-3
    assert _rel(p.bufs.state["p_idepth"][1] - st.p_idepth, new.p_idepth - st.p_idepth) < 1e-3
    a = int(ba.anchor_slot(st))
    assert float(xk[4 + 8 * a: 12 + 8 * a].abs().max()) == 0.0


@pytest.mark.parametrize("case,iters", [("gated", 6), ("gated", 20), ("force", 6),
                                        ("nan_pose", 6), ("nan_force", 6), ("w8_shuffled", 6)])
def test_device_loop_matches_plain_loop(dev, case, iters, monkeypatch):
    st, cfg = _window(dev, 8, 256) if case == "w8_shuffled" else _window(dev)
    if case == "w8_shuffled":
        st = _shuffled(st)
    if case in ("force", "nan_force"):
        cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, solver_force_accept_step=True))
    if case.startswith("nan"):
        st = with_nan_pose(st)
    state, rmse, ok, _, _ = ba.optimize_keyframe(st, cfg, iters, 2, None)
    with monkeypatch.context() as m:
        m.setattr(ba, "_optimize_device",
                  lambda s, c, it: ba._finish_optimize(*ba._optimize_loop_plain(s, c, it)))
        sp, rmse_p, ok_p, _, _ = ba.optimize_keyframe(st, cfg, iters, 2, None)
    assert bool(ok) == bool(ok_p)
    Tc, Tp = state.T_current(), sp.T_current()
    assert torch.equal(torch.isnan(Tc), torch.isnan(Tp))
    fin = ~torch.isnan(Tp)
    assert float(torch.max(torch.abs(Tc[fin] - Tp[fin]))) < 1e-3
    if bool(torch.isnan(rmse_p)):
        assert bool(torch.isnan(rmse))
    else:
        assert abs(float(rmse) - float(rmse_p)) <= 1e-3 * float(rmse_p)


def test_two_runs_bit_equal_no_host_read_and_launches(dev):
    st, cfg = _window(dev)
    counters = (kb.ba_linearize_cuda, kb.ba_step_cuda, kb.ba_accept_cuda, kb.ba_optimize_cuda)
    first = ba.optimize_keyframe(st, cfg, 6, 2, 160)
    torch.cuda.synchronize()
    before = [fn.launches for fn in counters]
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = ba.optimize_keyframe(st, cfg, 6, 2, 160)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the whole LM loop is one resident launch (the queued form's 7 / 6 / 7)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [0, 0, 0, 1]
    for a, b in zip(list(first[0]) + list(first[1:]), list(second[0]) + list(second[1:])):
        assert torch.equal(a, b)


def _bits(t):
    """A tensor's bits (NaN equal to the same NaN)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("n_slots,n_points,mode,iters,case", [
    (1, 200, "gated", 6, "base"), (2, 200, "gated", 6, "base"), (3, 200, "gated", 6, "base"),
    (4, 256, "gated", 0, "base"), (4, 256, "gated", 1, "base"), (4, 256, "gated", 6, "base"),
    (4, 256, "gated", 20, "base"), (5, 300, "gated", 6, "base"), (6, 129, "gated", 6, "base"),
    (7, 200, "gated", 6, "base"), (8, 256, "gated", 6, "base"), (8, 2560, "gated", 6, "base"),
    (8, 4096, "gated", 20, "base"), (8, 12500, "gated", 6, "base"),
    (4, 256, "force", 6, "base"), (8, 4096, "force", 20, "base"),
    (4, 256, "gated", 6, "nan_pose"), (4, 256, "force", 6, "nan_pose"),
    (8, 256, "gated", 6, "shuffled")])
def test_resident_launch_bit_equal_to_queued_chain(dev, n_slots, n_points, mode, iters, case):
    st, cfg = _window(dev, n_slots, n_points)
    st = _case(st, case)
    if mode == "force":
        cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, solver_force_accept_step=True))
    params = kb.optimize_params(st, cfg)
    got = ba._optimize_device(st, cfg, iters, params)
    q_state, q_lin, q_params = ba._optimize_loop_queued(st, cfg, iters)
    want = ba._finish_optimize(q_state, q_lin)
    for name in kb.STATE_FIELDS + ("p_res_good", "p_num_good", "p_last_res"):
        assert torch.equal(_bits(getattr(got[0], name)), _bits(getattr(want[0], name))), name
    for name in kb.LIN_FIELDS:
        assert torch.equal(_bits(getattr(got[3], name)), _bits(getattr(want[3], name))), name
    assert torch.equal(_bits(got[1]), _bits(want[1])) and bool(got[2]) == bool(want[2])
    assert torch.equal(params.bufs.ctrl_i, q_params.bufs.ctrl_i)
    assert torch.equal(_bits(params.bufs.ctrl_f), _bits(q_params.bufs.ctrl_f))
    rounds = int(params.bufs.ctrl_i[3])
    if case == "nan_pose":
        assert bool(torch.isnan(got[0].delta).any())
    elif mode == "gated" and iters == 20 and n_points == 256:
        assert 0 < rounds < iters and bool(params.bufs.ctrl_i[1])   # left early, done
    else:
        assert rounds == iters or bool(params.bufs.ctrl_i[1])


def test_resident_grid_is_resident(dev):
    """The resident launch's grid: one block an SM, every block resident,
    at least K10's ranks, at the keyframe path's sizes."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for W, NP in ((4, 256), (8, 2560), (8, 4096), (8, 12500)):
        grid = kb.optimize_grid(W, NP)
        assert grid["blocks_per_sm"] >= 1 and grid["blocks"] == sms
        assert grid["ranks"] in (8, 16) and grid["blocks"] >= grid["ranks"]


# ---- the shard functions on a one-card mesh ----------------------------------


def test_shard_ba_optimize_one_card(dev):
    from direct_stereo_slam_tpu_torch.parallel import mesh as mt

    wins = [_window("cpu", seed=s)[0] for s in (0, 1)]
    cfg = _window("cpu")[1]
    states = ba.BAState(*[torch.stack(leaves) for leaves in zip(*wins)])
    st_c, rmse_c, ok_c = mt.shard_ba_optimize(cfg, mt.make_mesh(1, device="cpu"), 2)(states)
    st_g, rmse_g, ok_g = mt.shard_ba_optimize(cfg, mt.make_mesh(1), 2)(
        ba.BAState(*[x.to(dev) for x in states]))
    assert torch.equal(ok_g.cpu(), ok_c)
    assert torch.allclose(rmse_g.cpu(), rmse_c, rtol=1e-3, atol=0)
    for b in range(2):
        Tg = ba.BAState(*[x[b] for x in st_g]).T_current().cpu()
        Tc = ba.BAState(*[x[b] for x in st_c]).T_current()
        assert float(torch.max(torch.abs(Tg - Tc))) < 1e-3


@pytest.fixture
def track_scene(dev):
    from direct_stereo_slam_tpu_torch.config import make_config
    from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
    from direct_stereo_slam_tpu_torch.io.synthetic import SyntheticStereoDataset
    from direct_stereo_slam_tpu_torch.models import depth_template as dt

    w, h, levels = 160, 64, 3
    ds = SyntheticStereoDataset(n_frames=2, width=w, height=h, speed=0.25)
    f0, f1 = ds.frame(0), ds.frame(1)
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], w, h, levels)
    cfg = make_config(w, h, preset=0, mode=1)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=levels,
                                                    max_iterations=(10, 20, 50)))
    rng = np.random.RandomState(0)
    n = 1500
    us = rng.uniform(3, w - 4, n).astype(np.float32)
    vs = rng.uniform(3, h - 4, n).astype(np.float32)
    depth = f0["depth0"][vs.astype(int), us.astype(int)]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    tmpl = dt.build_template(t(us), t(vs), t((1.0 / depth).astype(np.float32)),
                             t(np.ones(n, np.float32)), t(f0["img0"]), levels,
                             dt.default_budgets(w, h, levels))
    T_true = (np.linalg.inv(f1["pose_w_c0"]) @ f0["pose_w_c0"]).astype(np.float32)
    return dict(intr=intr, cfg=cfg, tmpl=tmpl, f1=f1, T_true=T_true, levels=levels)


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        leaves = [_to(v, dev) for v in x]
        return type(x)(*leaves) if hasattr(x, "_fields") else tuple(leaves)
    return x


def test_shard_candidate_retrack_one_card(dev, track_scene):
    from direct_stereo_slam_tpu_torch.geometry import lie
    from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid
    from direct_stereo_slam_tpu_torch.parallel import mesh as mt

    sc = track_scene
    rng = np.random.RandomState(3)
    T = np.stack([lie.se3_exp_np(0.01 * rng.randn(6)).astype(np.float32) @ sc["T_true"]
                  for _ in range(8)])
    pyr = build_pyramid(torch.as_tensor(sc["f1"]["img0"]), sc["levels"]).data
    args = (tuple(pyr), sc["tmpl"], torch.as_tensor(T))
    res_c, ok_c, win_c = mt.shard_candidate_retrack(sc["intr"], sc["cfg"],
                                                    mt.make_mesh(1, device="cpu"))(*args)
    res_g, ok_g, win_g = mt.shard_candidate_retrack(sc["intr"], sc["cfg"], mt.make_mesh(1))(
        *_to(args, dev))
    assert torch.equal(ok_g.cpu(), ok_c) and bool(ok_c.any())
    assert torch.allclose(res_g.cpu()[ok_c], res_c[ok_c], rtol=2e-3, atol=0)
    assert abs(float(res_g[win_g[0]]) - float(res_c[win_c[0]])) <= 2e-3 * float(res_c[win_c[0]])


def test_shard_scale_grid_one_card(dev, track_scene):
    from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid
    from direct_stereo_slam_tpu_torch.parallel import mesh as mt

    sc = track_scene
    t10 = np.eye(4, dtype=np.float32)
    t10[0, 3] = -0.54
    guesses = torch.tensor(sc["cfg"].scale_opt.grid_guesses, dtype=torch.float32)
    pyr = build_pyramid(torch.as_tensor(sc["f1"]["img1"]), sc["levels"]).data
    s_c, e_c = mt.shard_scale_grid(sc["intr"], sc["intr"], sc["cfg"],
                                   mt.make_mesh(1, device="cpu"))(tuple(pyr), sc["tmpl"],
                                                                  t10, guesses)
    s_g, e_g = mt.shard_scale_grid(sc["intr"], sc["intr"], sc["cfg"], mt.make_mesh(1))(
        _to(tuple(pyr), dev), _to(sc["tmpl"], dev), t10, guesses.to(dev))
    assert abs(float(s_g[0]) - float(s_c[0])) <= 1e-3 * abs(float(s_c[0]))
    assert abs(float(e_g[0]) - float(e_c[0])) <= 1e-3 * abs(float(e_c[0]))


def test_shard_posegraph_optimize_one_card(dev):
    from direct_stereo_slam_tpu_torch.io.synthetic_graphs import ring_graph
    from direct_stereo_slam_tpu_torch.loop import pose_graph as pg
    from direct_stereo_slam_tpu_torch.ops import pose_graph as pgk
    from direct_stereo_slam_tpu_torch.parallel import mesh as mt

    graph = ring_graph(200, seed=7, loop_every=12)
    step_c = mt.shard_posegraph_optimize(mt.make_mesh(1, device="cpu"), iterations=4,
                                         cg_iters=50)
    step_g = mt.shard_posegraph_optimize(mt.make_mesh(1), iterations=4, cg_iters=50)
    want = step_c(pg.build_data(*graph, device="cpu"))
    data = pg.build_data(*graph, device=dev)
    before = pgk.pose_graph_pcg_cuda.launches, pgk.pose_graph_cg_cuda.launches
    got = step_g(data)
    # the four iterations are one resident CG launch (the queued form: 4 x K6 -> K8)
    assert (pgk.pose_graph_pcg_cuda.launches - before[0],
            pgk.pose_graph_cg_cuda.launches - before[1]) == (0, 1)
    assert torch.equal(got, step_g(data))
    scale = float(torch.max(torch.abs(want[:, :3, 3])))
    assert float(torch.max(torch.abs(got.cpu() - want))) < 2e-3 * scale
