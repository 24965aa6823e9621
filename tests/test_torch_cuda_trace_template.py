"""The trace and template kernels K14 and K15 (csrc/trace.cu,
csrc/template.cu) against their plain PyTorch versions on the card, on
the calls the port's own SLAMNode makes over 24 rendered frames at 320x96
(preset 0: 8 slots of 1024 candidates) and on edge cases made from them:

- K14 (``trace_points_all_compact``): the statuses, the compacted lanes,
  ``n_search`` and ``n_overflow`` equal and ``idepth_min``,
  ``idepth_max``, ``quality`` and ``pixel_interval`` bit-equal to the
  plain version (the kernel rounds each of its operations as the plain
  version does on the card) on the fullest full-shape and steady-tier
  calls and on TRACE_CASES: every lane OOB, the budget exactly met and
  exceeded, non-finite ``idepth_max``, lanes at the border, a flat image
  (every energy ties: the first index wins), segments under the slack;
  two runs bit-equal, and 32 runs of the fullest call;
- K15: every level's lists bit-equal to the plain version, two runs
  bit-equal, in points mode (``build_template``) on the fullest recorded
  call's projected points and on TEMPLATE_CASES: duplicate pixels in
  shuffled point order, NaN coordinates of invalid lanes, no point, level
  0 over its budget, odd H and W, every point on one pixel, points on the
  last row and column of an odd image (dropped from every level above),
  20000 points (the sort through global memory), every level's list
  full; and in state mode (``build_template_from_state``, the projection
  in the launch) on the fullest recorded state, with a NaN host pose and
  NaN hessians, and on an odd image;
- a non-keyframe frame's ``_trace_all`` and the front end's template step
  with no host read (``torch.cuda.set_sync_debug_mode("error")``): one
  launch of K14, one of K15.

These tests need a CUDA card and skip elsewhere. They import nothing of
JAX, so on the card's machine they run without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_trace_template.py
"""

import pytest
import torch

from direct_stereo_slam_tpu_torch.config import make_config
from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu_torch.io.synthetic import SyntheticStereoDataset
from direct_stereo_slam_tpu_torch.models import ba
from direct_stereo_slam_tpu_torch.models import depth_template as dt
from direct_stereo_slam_tpu_torch.models import immature
from direct_stereo_slam_tpu_torch.models.frontend import FrontEnd
from direct_stereo_slam_tpu_torch.ops import template as template_ops
from direct_stereo_slam_tpu_torch.ops import trace as trace_ops
from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

pytestmark = pytest.mark.cuda

W, H, N_FRAMES = 320, 96, 24


@pytest.fixture(scope="module")
def calls():
    """The port's node over the frames on the card, its trace and template
    calls recorded (candidate sets are replaced, never written in place)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    dev = torch.device("cuda")
    ds = SyntheticStereoDataset(n_frames=N_FRAMES, width=W, height=H, speed=0.3, device=dev)
    cfg = make_config(W, H, preset=0, mode=1)
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H,
                                   cfg.tracker.pyr_levels)
    rec = {"trace": [], "template": [], "trace_all": []}
    from direct_stereo_slam_tpu_torch.models import frontend
    trace, template, trace_all = (immature.trace_points_all_compact,
                                  frontend.build_template_from_state, FrontEnd._trace_all)

    def trace_kept(*a, **kw):
        rec["trace"].append((a, kw))
        return trace(*a, **kw)

    def template_kept(*a, **kw):
        rec["template"].append((a, kw))
        return template(*a, **kw)

    def trace_all_kept(self, *a, **kw):
        rec["trace_all"].append((self.immatures, set(self.imm_slots), self.ba_state,
                                 dict(self.slot_exposure), a, kw))
        return trace_all(self, *a, **kw)

    immature.trace_points_all_compact = trace_kept
    frontend.build_template_from_state = template_kept
    FrontEnd._trace_all = trace_all_kept
    try:
        node = SLAMNode(cfg, intr, intr, ds.t_cam1_cam0, device=dev)
        for i in range(N_FRAMES):
            f = ds.frame(i)
            node.process(f["img0"], f["img1"], float(f["timestamp"]))
        node.finish()
    finally:
        immature.trace_points_all_compact = trace
        frontend.build_template_from_state = template
        FrontEnd._trace_all = trace_all
    torch.cuda.synchronize()
    assert len(rec["trace"]) >= 10 and len(rec["template"]) >= 3
    return dict(rec, cfg=cfg, intr=intr, t=ds.t_cam1_cam0, dev=dev)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _fullest(recorded, steady):
    """The recorded trace call with the most valid candidates, of the
    full shape or of the steady tier."""
    pick = [c for c in recorded if ("max_reach" in c[1]) == steady]
    return max(pick, key=lambda c: int(c[0][0].valid.sum()))


def _trace_case(calls, case):
    a, kw = _fullest(calls["trace"], case == "steady")
    pts, planes = a[0], a[1]
    rest, kw = a[2:], dict(kw)
    if case == "steady":                    # a reach under the search's cap (11 px at 320x96)
        kw["max_reach"] = 6.0
    elif case == "all_oob":
        pts = pts._replace(status=torch.full_like(pts.status, immature.IPS_OOB))
    elif case in ("budget_met", "budget_exceeded"):
        n = int(immature.trace_points_all_compact_plain(pts, planes, *rest, **kw)[1])
        assert n > 2
        kw["budget"] = n if case == "budget_met" else n // 2
    elif case == "nonfinite_max":
        imax = pts.idepth_max.clone()
        imax[:, 0::3] = float("inf")
        imax[:, 1::7] = float("nan")
        pts = pts._replace(idepth_max=imax)
    elif case == "border":
        u, v = pts.u.clone(), pts.v.clone()
        u[:, 0::2] = torch.where(u[:, 0::2] < W / 2, 4.0 + u[:, 0::2] % 3, W - 6 - u[:, 0::2] % 3)
        v[:, 1::2] = torch.where(v[:, 1::2] < H / 2, 4.0 + v[:, 1::2] % 3, H - 6 - v[:, 1::2] % 3)
        pts = pts._replace(u=u, v=v)
    elif case == "flat_image":
        planes = torch.zeros_like(planes)
        planes[..., 0] = 100.0
    elif case == "under_slack":
        imax = torch.where(torch.isfinite(pts.idepth_max), pts.idepth_min * 1.0001 + 1e-6,
                           pts.idepth_max)
        pts = pts._replace(idepth_max=imax)
    return (pts, planes) + tuple(rest), kw


TRACE_CASES = ("full", "steady", "all_oob", "budget_met", "budget_exceeded", "nonfinite_max",
               "border", "flat_image", "under_slack")
FIELDS = ("idepth_min", "idepth_max", "quality", "status", "pixel_interval")


def _trace_pair(a, kw):
    S, NI = a[0].u.shape
    bud = min(kw.get("budget", a[6].trace.search_budget), S * NI)
    lk = torch.full((bud,), -1, dtype=torch.int64, device=a[1].device)
    lp = torch.full((bud,), -2, dtype=torch.int64, device=a[1].device)
    got = trace_ops.trace_points_all_compact_cuda(*a, **kw, lanes=lk)
    want = immature.trace_points_all_compact_plain(*a, **kw, lanes=lp)
    return got, want, lk, lp


@pytest.mark.parametrize("case", TRACE_CASES)
def test_trace_kernel_is_the_plain_version(calls, case):
    a, kw = _trace_case(calls, case)
    got, want, lk, lp = _trace_pair(a, kw)
    again = trace_ops.trace_points_all_compact_cuda(*a, **kw)
    torch.cuda.synchronize()
    assert torch.equal(lk, lp)
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])
    for name in FIELDS:
        x, y, z = (_bits(getattr(r[0], name)) for r in (got, want, again))
        assert torch.equal(x, y), f"{name}: {int((x != y).sum())} lanes differ"
        assert torch.equal(x, z), name
    assert int(again[1]) == int(got[1]) and int(again[2]) == int(got[2])
    n_search, n_over = int(got[1]), int(got[2])
    searched = int((lk < a[0].u.numel()).sum())
    print(f"K14 {case}: {n_search} searching, {n_over} overflow, {searched} searched, "
          f"{int((got[0].status == immature.IPS_GOOD).sum())} good")
    if case == "all_oob":
        assert n_search == 0 and searched == 0
    elif case == "budget_met":
        assert searched == n_search and n_over == 0
    elif case == "budget_exceeded":
        assert n_over == n_search - searched > 0
    elif case == "steady":
        assert n_over > 0
    elif case == "under_slack":
        assert int((got[0].status == immature.IPS_SKIPPED).sum()) > 0
    else:
        assert searched > 0


def test_trace_many_runs_are_bit_equal(calls):
    a, kw = _trace_case(calls, "full")
    want = immature.trace_points_all_compact_plain(*a, **kw)
    runs = [trace_ops.trace_points_all_compact_cuda(*a, **kw) for _ in range(32)]
    torch.cuda.synchronize()
    for got in runs:
        for name in FIELDS:
            assert torch.equal(_bits(getattr(got[0], name)), _bits(getattr(want[0], name))), name


def test_trace_all_reads_nothing_from_the_card(calls):
    imm, slots, st, expo, args, kw = next(c for c in calls["trace_all"][::-1]
                                          if not c[5].get("steady"))
    fe = FrontEnd(calls["cfg"], calls["intr"], calls["intr"], calls["t"], device=calls["dev"])
    fe.immatures, fe.imm_slots, fe.ba_state, fe.slot_exposure = imm, slots, st, expo
    fe._views_np()                          # the host views, read once per state as on the path
    before = trace_ops.trace_points_all_compact_cuda.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fe._trace_all(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert trace_ops.trace_points_all_compact_cuda.launches - before == 1
    assert fe.immatures is not imm


def _fullest_state(calls):
    """The recorded template call (the front end's state mode) with the
    most valid points, with its idepth hessian (a keyframe's, not the
    initialisation's re-linearization)."""
    return max((c for c in calls["template"] if c[0][3] is not None),
               key=lambda c: int(c[0][0].p_valid.sum()))[0]


def _recorded_points(calls):
    """The fullest state call's projected points (``ba.template_inputs``)."""
    st, cfg, slot, hdd, img, levels, budgets = _fullest_state(calls)
    u, v, pid, w, valid = ba.template_inputs(st, cfg, slot, hdd)
    return u, v, pid, w, img, levels, budgets, valid


def _template_case(calls, case):
    u, v, pid, w, img, levels, budgets, valid = _recorded_points(calls)
    gen = torch.Generator(device="cpu").manual_seed(5)
    rand = lambda n: torch.rand(n, generator=gen).to(u.device)
    if case == "duplicates_shuffled":
        reps = torch.randint(0, u.numel(), (u.numel() // 3,), generator=gen).to(u.device)
        perm = torch.randperm(u.numel() + reps.numel(), generator=gen).to(u.device)
        cat = lambda x: torch.cat([x, x[reps]])[perm]
        jit = (rand(reps.numel()) - 0.5) * 0.6
        u = torch.cat([u, u[reps].round() + jit])[perm]
        v = torch.cat([v, v[reps].round() - jit])[perm]
        pid, w, valid = cat(pid), cat(w), cat(valid)
    elif case == "nan_invalid":
        u, v, valid = u.clone(), v.clone(), valid.clone()
        valid[0::4] = False
        u[0::8] = float("nan")
        v[4::8] = float("nan")
        u[2::8] = float("inf")
    elif case == "empty":
        u, v, pid, w, valid = (x[:0] for x in (u, v, pid, w, valid))
    elif case == "level0_over_budget":
        budgets = (256,) + tuple(budgets[1:])
    elif case == "odd_size":
        img = img[:H - 3, :W - 5]
    elif case == "one_pixel":                # every point on pixel (20, 37)
        u, v = torch.full_like(u, 37.3), torch.full_like(v, 20.1)
    elif case == "odd_edges":                # half the points on the last row or column
        img = img[:H - 3, :W - 5]
        h, wd = img.shape
        u, v = u.clone(), v.clone()
        u[0::4] = wd - 1 + 0.4 * rand(u[0::4].numel())
        v[1::4] = h - 1 + 0.4 * rand(v[1::4].numel())
        u[2::4], v[2::4] = wd - 0.8, h - 0.8
    elif case == "n20000":                   # the points repeated, jittered, to 20000
        idx = torch.randint(0, u.numel(), (20000,), generator=gen).to(u.device)
        u = u[idx] + (rand(20000) - 0.5) * 8.0
        v = v[idx] + (rand(20000) - 0.5) * 8.0
        pid, w, valid = pid[idx], w[idx], valid[idx] & (rand(20000) < 0.9)
    elif case == "lists_full":               # each level's budget half its good cells
        counts = [int(m.sum()) for m in dt.build_template_plain(
            u, v, pid, w, img, levels, budgets, valid).pmask]
        assert min(counts) > 1, counts
        budgets = tuple(c // 2 for c in counts)
    return (u, v, pid, w, img, levels, budgets), valid


TEMPLATE_CASES = ("recorded", "duplicates_shuffled", "nan_invalid", "empty",
                  "level0_over_budget", "odd_size", "one_pixel", "odd_edges", "n20000",
                  "lists_full")
LISTS = ("pu", "pv", "pid", "pcolor", "pmask")


def _same_lists(got, want, again, levels):
    for name, x, y, z in zip(LISTS, got, want, again):
        for lvl in range(levels):
            assert torch.equal(_bits(x[lvl]), _bits(y[lvl])), (
                f"{name}[{lvl}]: {int((_bits(x[lvl]) != _bits(y[lvl])).sum())} entries differ")
            assert torch.equal(_bits(x[lvl]), _bits(z[lvl])), f"{name}[{lvl}]"


@pytest.mark.parametrize("case", TEMPLATE_CASES)
def test_template_kernel_is_the_plain_version(calls, case):
    a, valid = _template_case(calls, case)
    got = template_ops.build_template_cuda(*a, valid)
    again = template_ops.build_template_cuda(*a, valid)
    want = dt.build_template_plain(*a, valid)
    torch.cuda.synchronize()
    _same_lists(got, want, again, a[5])
    counts = [int(m.sum()) for m in want[4]]
    print(f"K15 {case}: {a[0].numel()} points, list counts {counts} of {list(a[6])}")
    if case == "empty":
        assert counts[0] == 0
    elif case == "level0_over_budget":
        assert counts[0] == 256
    elif case == "lists_full":
        assert counts == list(a[6])
    else:
        assert counts[0] > 0


def _state_case(calls, case):
    """The fullest state call's inputs to the state mode: the pool's point
    arrays, ``hdd``, the window's calibration and T_rh."""
    st, cfg, slot, hdd, img, levels, budgets = _fullest_state(calls)
    calib, T_rh = ba.template_pose_prep(st, slot)
    pts = [st.p_u, st.p_v, st.p_idepth, st.p_host, st.p_valid, hdd]
    if case == "nan_pose_hdd":               # a NaN host pose, NaN hessians
        host = int(st.p_host[st.p_valid][0])
        T_rh = T_rh.clone()
        T_rh[host, 1, 2] = float("nan")
        pts[5] = hdd.clone()
        pts[5][3::7] = float("nan")
    elif case == "odd_size":
        img = img[:H - 3, :W - 5]
    return pts, calib, T_rh, img, levels, budgets


STATE_CASES = ("recorded", "nan_pose_hdd", "odd_size")


@pytest.mark.parametrize("case", STATE_CASES)
def test_template_state_mode_is_the_plain_version(calls, case):
    pts, calib, T_rh, img, levels, budgets = _state_case(calls, case)
    got = template_ops.build_template_from_state_cuda(*pts, calib, T_rh, img, levels, budgets)
    again = template_ops.build_template_from_state_cuda(*pts, calib, T_rh, img, levels, budgets)
    ti = ba.template_project(*pts, calib, T_rh)
    want = dt.build_template_plain(*ti[:4], img, levels, budgets, valid=ti[4])
    torch.cuda.synchronize()
    _same_lists(got, want, again, levels)
    counts = [int(m.sum()) for m in want[4]]
    print(f"K15 state {case}: {pts[0].numel()} points ({int(ti[4].sum())} valid), list "
          f"counts {counts} of {list(budgets)}")
    assert counts[0] > 0
    if case == "nan_pose_hdd":
        assert not bool(torch.isfinite(ti[1]).all()) and not bool(torch.isfinite(ti[3]).all())


def test_template_step_reads_nothing_from_the_card(calls):
    """The front end's template step (``run_ba_chain``'s call) queues the
    pose prep and one K15 launch, and waits for nothing."""
    a = _fullest_state(calls)
    want = dt.build_template_from_state_plain(*a)
    before = template_ops.build_template_cuda.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = dt.build_template_from_state(*a)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert template_ops.build_template_cuda.launches - before == 1
    assert isinstance(got, dt.TrackerTemplate)
    _same_lists(got, want, got, a[5])
