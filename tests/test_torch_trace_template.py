"""The plain versions of K14 (``trace_points_all_compact``) and K15
(``build_template``) against the JAX package on the CPU, at 96x48 and 3
levels, the inputs made from a numpy seed; and their dispatch: CPU
tensors take the plain version and launch nothing.

Tolerances:
- the trace: statuses, ``n_search`` and ``n_overflow`` equal; the finite
  ``idepth_min``, ``idepth_max``, ``quality`` and ``pixel_interval``
  within rel 1e-4 (abs 1e-5), the same lanes finite. The port's sums are
  left-to-right chains and its step is the segment times 1 / (steps - 1)
  rounded to f32, where the JAX package's reductions and division take
  XLA's order: rounding apart, not a different search;
- the template: masks, ``pu`` and ``pv`` equal; ``pid`` and ``pcolor``
  within rel 1e-6 (the pooled sums in a fixed order against XLA's).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from direct_stereo_slam_tpu.config import make_config
from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
from direct_stereo_slam_tpu.models import depth_template as dt_j
from direct_stereo_slam_tpu.models import immature as im_j
from direct_stereo_slam_tpu.ops import select as sel_j
from direct_stereo_slam_tpu.ops.pyramid import build_pyramid as pyr_j
from direct_stereo_slam_tpu_torch.models import depth_template as dt_t
from direct_stereo_slam_tpu_torch.models import immature as im_t
from direct_stereo_slam_tpu_torch.ops import template as template_ops
from direct_stereo_slam_tpu_torch.ops import trace as trace_ops
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax as port_cfg
from direct_stereo_slam_tpu_torch.utils.convert import to_torch

from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

W, H, LVLS = 96, 48, 3
NI = 128


@pytest.fixture(scope="module")
def window():
    """Four slots of candidates hosted in frames 0 and 1 and traced into
    frame 2: slots 0-1 fresh (idepth [0, inf)), slots 2-3 the same pixels
    with intervals bracketing the true depth, some lanes OOB or invalid."""
    ds = SyntheticStereoDataset(n_frames=3, width=W, height=H, speed=0.25, yaw_rate=0.01)
    frames = [ds.frame(i) for i in range(3)]
    cfg = make_config(W, H, preset=0, mode=1)
    rng = np.random.RandomState(7)
    slots = []
    for host in (0, 1, 0, 1):
        pj = pyr_j(jnp.asarray(frames[host]["img0"]), 3)
        mj, _ = sel_j.make_selection_map(pj.abs_grad[0], pj.abs_grad[1], pj.abs_grad[2], 2, cfg)
        slots.append({k: np.array(v) for k, v in im_j.create_points(pj.data[0], mj, NI)
                      ._asdict().items()})
    for s in (2, 3):
        d = slots[s]
        depth = np.asarray(frames[s - 2]["depth0"])[d["v"].astype(int), d["u"].astype(int)]
        true_id = (1.0 / depth).astype(np.float32)
        d["idepth_min"] = (true_id * rng.uniform(0.2, 0.9, NI)).astype(np.float32)
        d["idepth_max"] = (true_id * rng.uniform(1.1, 4.0, NI)).astype(np.float32)
        d["status"] = rng.choice([im_j.IPS_GOOD, im_j.IPS_SKIPPED, im_j.IPS_OOB],
                                 NI, p=[0.8, 0.1, 0.1]).astype(np.int32)
        d["quality"] = rng.uniform(1.0, 20.0, NI).astype(np.float32)
        d["valid"] = d["valid"] & (rng.rand(NI) < 0.95)
    stack = im_j.ImmaturePoints(**{k: np.stack([d[k] for d in slots])
                                   for k in im_j.ImmaturePoints._fields})
    K = ds.K.astype(np.float32)
    Ki = np.linalg.inv(K)
    T_cw = np.linalg.inv(frames[2]["pose_w_c0"])
    KRKi, Kt = [], []
    for host in (0, 1, 0, 1):
        T = T_cw @ frames[host]["pose_w_c0"]
        KRKi.append(K @ T[:3, :3] @ Ki)
        Kt.append(K @ T[:3, 3])
    a = np.array([1.0, 1.02, 0.98, 1.0], np.float32)
    b = np.array([0.0, -1.5, 2.0, 0.5], np.float32)
    planes = np.asarray(pyr_j(jnp.asarray(frames[2]["img0"]), 1).data[0])
    return stack, planes, np.asarray(KRKi, np.float32), np.asarray(Kt, np.float32), a, b, cfg


# (num_steps, budget, max_reach): a full call, the steady tier with its
# deferral (at 96x48 the search's cap is 0.027 x 144 = 3.9 px, so the reach
# is cut below it), and a budget the searching lanes overflow
TRACE_CASES = {"full": (None, None, None), "steady": (16, 1024, 3.0),
               "overflow": (None, 24, None)}


def _trace_both(window, case):
    stack, planes, KRKi, Kt, a, b, cfg = window
    steps, budget, reach = TRACE_CASES[case]
    out_j, ns_j, no_j = im_j.trace_points_all_compact(
        im_j.ImmaturePoints(*[jnp.asarray(x) for x in stack]), jnp.asarray(planes),
        jnp.asarray(KRKi), jnp.asarray(Kt), jnp.asarray(a), jnp.asarray(b), cfg, steps, budget,
        reach)
    out_t, ns_t, no_t = im_t.trace_points_all_compact_plain(
        to_torch(stack), torch.as_tensor(planes), KRKi, Kt, a, b, port_cfg(cfg), steps, budget,
        reach)
    return (out_j, int(ns_j), int(no_j)), (out_t, int(ns_t), int(no_t))


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_trace_plain_matches_jax(window, case):
    (out_j, ns_j, no_j), (out_t, ns_t, no_t) = _trace_both(window, case)
    assert ns_t == ns_j > 0 and no_t == no_j
    if case == "full":
        assert no_j == 0
    else:
        assert no_j > 0
    np.testing.assert_array_equal(out_t.status.numpy(), np.asarray(out_j.status))
    for name in ("idepth_min", "idepth_max", "quality", "pixel_interval"):
        want, got = np.asarray(getattr(out_j, name)), getattr(out_t, name).numpy()
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=name)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-5, err_msg=name)
    traced = (out_t.idepth_max.numpy() != window[0].idepth_max).sum()
    print(f"{case}: {ns_t} searching, {no_t} deferred or over the budget, {traced} traced")
    assert traced >= (50 if case == "full" else 5)


def test_trace_on_cpu_takes_the_plain_version(window):
    stack, planes, KRKi, Kt, a, b, cfg = window
    pts = to_torch(stack)
    before = trace_ops.trace_points_all_compact_cuda.launches
    got, ns, no = im_t.trace_points_all_compact(pts, torch.as_tensor(planes), KRKi, Kt, a, b,
                                                port_cfg(cfg), budget=24)
    lanes = torch.empty(24, dtype=torch.int64)
    want, ns_p, no_p = im_t.trace_points_all_compact_plain(
        pts, torch.as_tensor(planes), torch.as_tensor(KRKi), torch.as_tensor(Kt),
        torch.as_tensor(a), torch.as_tensor(b), port_cfg(cfg), budget=24, lanes=lanes)
    assert trace_ops.trace_points_all_compact_cuda.launches == before
    for name in ("idepth_min", "idepth_max", "quality", "status", "pixel_interval"):
        x, y = getattr(got, name), getattr(want, name)
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), name
        assert getattr(pts, name) is not x            # new tensors, the input kept
    assert int(ns) == int(ns_p) and int(no) == int(no_p)
    # the compacted lanes: ascending flat indices, then the fill S * NI
    live = lanes[lanes < 4 * NI]
    assert live.numel() == 24 and bool((live[1:] > live[:-1]).all())


def _template_points(case, rng):
    """Points with several on one pixel (in shuffled order), some out of
    bounds, invalid lanes with NaN coordinates; or none; or more than the
    level budgets hold."""
    if case == "empty":
        z = np.zeros(0, np.float32)
        return z, z, z, z, np.zeros(0, bool)
    n = 600 if case != "over_budget" else 2500
    us = rng.uniform(-4, W + 4, n).astype(np.float32)
    vs = rng.uniform(-4, H + 4, n).astype(np.float32)
    dup = rng.choice(n, n // 4)
    us[dup] = us[rng.choice(n, n // 4)].round() + rng.uniform(-0.4, 0.4, n // 4)
    vs[dup] = vs[rng.choice(n, n // 4)].round() + rng.uniform(-0.4, 0.4, n // 4)
    pid = rng.uniform(0.05, 2.0, n).astype(np.float32)
    pid[rng.rand(n) < 0.05] = -0.5
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    valid = rng.rand(n) < 0.9
    us[~valid & (rng.rand(n) < 0.5)] = np.nan
    vs[~valid & (rng.rand(n) < 0.5)] = np.nan
    perm = rng.permutation(n)
    return us[perm], vs[perm], pid[perm], w[perm], valid[perm]


TEMPLATE_CASES = ("duplicates_oob", "empty", "over_budget", "odd_size")


@pytest.mark.parametrize("case", TEMPLATE_CASES)
def test_template_plain_matches_jax(case):
    rng = np.random.RandomState(11)
    h, w = (H - 1, W - 3) if case == "odd_size" else (H, W)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)[:h, :w].copy()
    us, vs, pid, wt, valid = _template_points(case, rng)
    budgets = (512, 128, 128) if case == "over_budget" else dt_j.default_budgets(w, h, LVLS)
    tj = dt_j.build_template(jnp.asarray(us), jnp.asarray(vs), jnp.asarray(pid),
                             jnp.asarray(wt), jnp.asarray(img), LVLS, budgets,
                             valid=jnp.asarray(valid))
    planes = torch.as_tensor(np.stack([img, img, img], -1))      # read through a strided view
    tt = dt_t.build_template_plain(*[torch.as_tensor(x) for x in (us, vs, pid, wt)],
                                   planes[..., 0], LVLS, budgets, valid=torch.as_tensor(valid))
    for lvl in range(LVLS):
        np.testing.assert_array_equal(tt.pmask[lvl].numpy(), np.asarray(tj.pmask[lvl]))
        np.testing.assert_array_equal(tt.pu[lvl].numpy(), np.asarray(tj.pu[lvl]))
        np.testing.assert_array_equal(tt.pv[lvl].numpy(), np.asarray(tj.pv[lvl]))
        np.testing.assert_allclose(tt.pid[lvl].numpy(), np.asarray(tj.pid[lvl]), rtol=1e-6)
        np.testing.assert_allclose(tt.pcolor[lvl].numpy(), np.asarray(tj.pcolor[lvl]),
                                   rtol=1e-6)
    count = int(tt.pmask[0].sum())
    if case == "empty":
        assert count == 0
    elif case == "over_budget":
        assert count == budgets[0]
    else:
        assert 0 < count < budgets[0]


def test_template_on_cpu_takes_the_plain_version():
    rng = np.random.RandomState(3)
    us, vs, pid, wt, valid = _template_points("duplicates_oob", rng)
    img = torch.as_tensor(rng.uniform(0, 255, (H, W)).astype(np.float32))
    args = [torch.as_tensor(x) for x in (us, vs, pid, wt)]
    budgets = dt_t.default_budgets(W, H, LVLS)
    before = template_ops.build_template_cuda.launches
    got = dt_t.build_template(*args, img, LVLS, budgets, valid=torch.as_tensor(valid))
    want = dt_t.build_template_plain(*args, img, LVLS, budgets, valid=torch.as_tensor(valid))
    assert template_ops.build_template_cuda.launches == before
    assert isinstance(got, dt_t.TrackerTemplate) and got is not want
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    # each pixel's points are added in ascending order: the sums are those
    # of index_put_(accumulate=True), which adds them one by one on the CPU
    key = (torch.clamp(torch.nan_to_num(args[1] + 0.5).clamp(-2**30, 2**30).long(), 0, H - 1)
           * W + torch.clamp(torch.nan_to_num(args[0] + 0.5).clamp(-2**30, 2**30).long(), 0,
                             W - 1))
    vals = torch.as_tensor(rng.uniform(-1, 1, (2, key.shape[0])).astype(np.float32))
    ref = torch.zeros(2, H * W).index_put_((torch.arange(2)[:, None], key[None, :]), vals,
                                           accumulate=True)
    assert torch.equal(dt_t._pixel_sums(key, vals, H * W), ref)


@pytest.fixture(scope="module")
def ba_window():
    """A 3-frame BA window (``test_torch_select_immature_ba._ba_window``)
    with every slot's tangent moved off its FEJ pose, and per-point idepth
    hessians (some below the clamp, one NaN), in both packages."""
    from direct_stereo_slam_tpu.models import ba as ba_j
    from test_torch_select_immature_ba import _ba_window, _to_port

    ds = SyntheticStereoDataset(n_frames=3, width=W, height=H, speed=0.25, yaw_rate=0.01)
    cfg = make_config(W, H, preset=0, mode=1)
    st_j = _ba_window([ds.frame(i) for i in range(3)], cfg)
    rng = np.random.RandomState(17)
    delta = np.zeros(np.asarray(st_j.delta).shape, np.float32)
    delta[:3, :6] = rng.randn(3, 6).astype(np.float32) * 1e-3
    st_j = st_j._replace(delta=jnp.asarray(delta))
    hdd = rng.uniform(-1.0, 50.0, st_j.p_u.shape[0]).astype(np.float32)
    hdd[5] = np.nan
    return ba_j, st_j, _to_port(st_j), hdd, cfg


def test_template_inputs_match_jax(ba_window):
    """The port's fixed-order ``template_inputs`` against the JAX package's
    (its einsum's and divisions' order XLA's): ``valid`` equal, the rest
    within rel 1e-5."""
    from direct_stereo_slam_tpu_torch.models import ba as ba_t

    ba_j, st_j, st_t, hdd, cfg = ba_window
    want = ba_j.template_inputs(st_j, cfg, jnp.int32(2), jnp.asarray(hdd))
    got = ba_t.template_inputs(st_t, port_cfg(cfg), 2, torch.as_tensor(hdd))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert 0 < int(got[4].sum()) < got[4].numel()
    for name, x, y in zip(("proj_u", "proj_v", "new_id", "w"), got[:4], want[:4]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=0, err_msg=name)


def test_template_from_state_plain_is_build_template_on_its_inputs(ba_window):
    """``build_template_from_state_plain`` is ``build_template_plain`` on
    ``template_inputs``, bit for bit (the hessian given, and re-linearized
    when it is None); on CPU tensors ``build_template_from_state`` takes it
    and launches nothing."""
    from direct_stereo_slam_tpu_torch.models import ba as ba_t

    _, _, st_t, hdd, cfg = ba_window
    img = st_t.images[2, ..., 0]
    budgets = dt_t.default_budgets(W, H, LVLS)
    c = port_cfg(cfg)
    for h in (torch.as_tensor(hdd), None):
        ti = ba_t.template_inputs(st_t, c, 2, h)
        want = dt_t.build_template_plain(*ti[:4], img, LVLS, budgets, valid=ti[4])
        before = template_ops.build_template_cuda.launches
        got = dt_t.build_template_from_state(st_t, c, 2, h, img, LVLS, budgets)
        plain = dt_t.build_template_from_state_plain(st_t, c, 2, h, img, LVLS, budgets)
        assert template_ops.build_template_cuda.launches == before
        assert isinstance(got, dt_t.TrackerTemplate) and got is not plain
        for field in range(5):
            for x, y, z in zip(got[field], plain[field], want[field]):
                assert torch.equal(_bits(x), _bits(z)) and torch.equal(_bits(y), _bits(z))
        assert int(want.pmask[0].sum()) > 0


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t
