"""The host side of the resident LM kernels (``ops/resident_lm.py``) on the
CPU: the ctypes mirrors of the kernels' parameter structs have the layouts
``csrc/resident_lm.cu`` asserts (the module also checks them against the
built library before a launch), K3-LM's struct carries each level's
camera-1 intrinsics, ``R01 K0^-1`` and iterations, the slice sizes match
the kernel's, scalars pass by address or by value, CPU tensors take the
plain LM loops without touching the kernels' launch counters, and the
rule that holds the kernels to those loops (``utils/lm_agreement.py``)
passes the loops in other lane orders and catches a candidate that moved."""

import ctypes
import weakref

import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu_torch.config import make_config
from direct_stereo_slam_tpu_torch.geometry import lie
from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu_torch.loop import pose_estimator as pe
from direct_stereo_slam_tpu_torch.models import scale_opt as so
from direct_stereo_slam_tpu_torch.models import tracker as tr
from direct_stereo_slam_tpu_torch.models.depth_template import TrackerTemplate
from direct_stereo_slam_tpu_torch.ops import resident_lm as rlm
from direct_stereo_slam_tpu_torch.ops import residual_hb as rh
from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid
from direct_stereo_slam_tpu_torch.utils import lm_agreement as lma

pytestmark = pytest.mark.smoke

W, H, L = 64, 48, 2


def test_struct_layout_matches_the_kernel():
    assert ctypes.sizeof(rlm._Level) == 152
    assert rlm._Level.img_stride.offset == 136 and rlm._Level.pt_stride.offset == 144
    assert ctypes.sizeof(rlm._Scalar) == 16
    assert ctypes.sizeof(rlm.LmParams) == 1432
    assert rlm.LmParams.out.offset == 1224 and rlm.LmParams.timers.offset == 1232
    assert rlm.LmParams.pre.offset == 1336 and rlm.LmParams.chunk.offset == 1420
    assert rlm.LmParams.per_seq.offset == 1424
    assert rlm.TIMER_WORDS == rlm.MAX_LEVELS * len(rlm.PHASES) + 2


def test_phase_breakdown_of_synthetic_counters():
    """Two candidates, two levels: the counters (SM cycles per level and
    phase, then the run's cycles and nanoseconds) become microseconds per
    pass and shares at the clock given; the kernel's own clock is cycles
    over nanoseconds."""
    P = len(rlm.PHASES)
    t = np.zeros((2, rlm.TIMER_WORDS), np.int64)
    t[0, :P] = [100, 200, 300, 400, 500, 500]            # level 0: 2000 cycles
    t[1, :P] = [100, 200, 300, 400, 500, 500]
    t[0, P:2 * P] = [0, 1000, 0, 0, 0, 0]                # level 1: 1000 cycles
    t[:, -2] = [4000, 2000]                             # the runs' cycles
    t[:, -1] = [2000, 1000]                             # and nanoseconds
    passes = torch.tensor([[4.0, 1.0], [4.0, 0.0]])
    ph = rlm.phase_breakdown(torch.as_tensor(t), passes, clock_mhz=1000.0)
    assert ph["passes"] == 9.0 and ph["clock_mhz"] == 1000.0
    assert ph["us_per_pass"] == pytest.approx(5000 / 1000 / 9)
    assert ph["phase_us"] == pytest.approx(5000 / 1000 / 2)
    assert ph["run_us"] == pytest.approx(3.0) and ph["kernel_mhz"] == pytest.approx(2000.0)
    assert ph["shares"]["points"] == pytest.approx(1400 / 5000)
    assert sum(ph["shares"].values()) == pytest.approx(1.0)
    l0, l1 = ph["levels"]
    assert l0["passes"] == 8.0 and l0["us_per_pass"] == pytest.approx(4000 / 1000 / 8)
    assert l0["shares"]["step"] == pytest.approx(0.25)
    assert l1["passes"] == 1.0 and l1["shares"] == dict.fromkeys(rlm.PHASES, 0.0) | {"points": 1.0}
    # host arrays give the same numbers
    assert rlm.phase_breakdown(t, passes.numpy(), 1000.0) == ph


def test_timers_must_fit_the_batch():
    p = rlm.LmParams()
    dev = torch.device("cpu")
    rlm._timers(p, None, 2, dev)
    assert p.timers is None
    buf = rlm.timer_buffer(2, dev)
    rlm._timers(p, buf, 2, dev)
    assert p.timers == buf.data_ptr()
    for bad in (rlm.timer_buffer(3, dev), buf.to(torch.int32), buf[:, :-1]):
        with pytest.raises(ValueError):
            rlm._timers(p, bad, 2, dev)


def test_scale_struct_layout_matches_the_kernel():
    assert ctypes.sizeof(rlm.ScaleLmParams) == 1304
    assert rlm.ScaleLmParams.s_init.offset == 1216
    assert rlm.ScaleLmParams.timers.offset == 1232
    assert rlm.ScaleLmParams.t01.offset == 1240
    assert rlm.ScaleLmParams.huber.offset == 1252
    assert rlm.ScaleLmParams.levels.offset == 1288
    assert rlm.ScaleLmParams.G.offset == 1292
    assert rlm.ScaleLmParams.per_seq.offset == 1296
    assert rlm.SCALE_OUT == 28 and rlm._SOUT_RUN == 20


@pytest.mark.parametrize("n,per", [(0, 0), (1, 4), (8, 4), (33, 8), (512, 64),
                                   (2048, 256), (8192, 1024), (8200, 1028)])
def test_slice_len(n, per):
    assert rlm.slice_len(n) == per
    assert rlm.CLUSTER * per >= n and per % 4 == 0


def test_scalars_by_address_or_value():
    s = rlm._scalar(1.5, torch.device("cpu"))
    assert s.ptr is None and s.value == 1.5
    x = torch.tensor(2.0)
    assert rlm._scalar(x, torch.device("cpu")).ptr == x.data_ptr()
    for bad in (torch.tensor(2.0, dtype=torch.float64), torch.ones(2)):
        with pytest.raises(ValueError):
            rlm._scalar(bad, torch.device("cpu"))


def _image(seed):
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    img = 100 + 40 * np.sin(xs / 5.0 + rng.rand()) + 30 * np.cos(ys / 4.0)
    return torch.as_tensor(img.astype(np.float32))


def _lm_args():
    """A tracker batch (two candidates, two levels) and a loop-estimator
    stack (two seeds, 64 points) on the CPU."""
    cfg = make_config(W, H)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=L, max_iterations=(5, 5)))
    intr = make_pyramid_intrinsics(60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5, W, H, L)
    pyr = tuple(build_pyramid(_image(0), L).data)
    rng = np.random.RandomState(1)
    cols = {k: [] for k in TrackerTemplate._fields}
    for lvl in range(L):
        n = 128 >> lvl
        cols["pu"].append(torch.as_tensor(rng.uniform(3, (W >> lvl) - 4, n).astype(np.float32)))
        cols["pv"].append(torch.as_tensor(rng.uniform(3, (H >> lvl) - 4, n).astype(np.float32)))
        cols["pid"].append(torch.as_tensor(rng.uniform(0.1, 0.5, n).astype(np.float32)))
        cols["pcolor"].append(torch.as_tensor(rng.uniform(60, 180, n).astype(np.float32)))
        cols["pmask"].append(torch.ones(n, dtype=torch.bool))
    tmpl = TrackerTemplate(*[tuple(cols[k]) for k in TrackerTemplate._fields])
    T = torch.stack([lie.se3_exp(torch.tensor(x, dtype=torch.float32)) for x in
                     ([0.0] * 6, [0.01, 0.0, -0.02, 0.0, 0.01, 0.0])])
    zero = tr.AffLight(torch.tensor(0.0), torch.tensor(0.0))
    args = (pyr, tmpl, intr, cfg, T, zero, zero, torch.tensor(1.0), 1.0)
    px, py, pz = [torch.as_tensor(rng.uniform(lo, hi, 64).astype(np.float32))
                  for lo, hi in ((-2, 2), (-1, 1), (4, 8))]
    pc = torch.as_tensor(rng.uniform(60, 180, (64, L)).astype(np.float32))
    largs = (pyr, px, py, pz, pc, torch.ones(64, dtype=torch.bool), T, intr, cfg)
    return args, largs


def test_cpu_tensors_take_the_plain_loops():
    """On the CPU the public functions equal their plain loops and never
    count a kernel launch."""
    args, largs = _lm_args()
    counts = (rlm.track_lm_cuda.launches, rlm.loop_pose_lm_cuda.launches,
              rh.pose_residual_pass_cuda.launches, rh.pose3d_residual_pass_cuda.launches)
    a, b = tr.track_candidates_batch(*args), tr.track_candidates_batch_plain(*args)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert all(torch.equal(u, v) for u, v in zip(x, y))
        else:
            assert torch.equal(x, y)
    c, d = pe.estimate_seeds(*largs), pe.estimate_seeds_plain(*largs)
    assert torch.equal(c.T, d.T) and torch.equal(c.pose_error, d.pose_error)
    assert counts == (rlm.track_lm_cuda.launches, rlm.loop_pose_lm_cuda.launches,
                      rh.pose_residual_pass_cuda.launches,
                      rh.pose3d_residual_pass_cuda.launches)


@pytest.mark.parametrize("which", ["track", "seeds"])
def test_agreement_passes_reordered_loops_and_catches_a_moved_candidate(which):
    """The plain loop, run again over the points in other lane orders,
    passes the rule against itself; the same run with one candidate's pose
    moved by 1e-2 (ten times the tolerance) fails it."""
    args, largs = _lm_args()
    if which == "track":
        loop, reordered = tr.track_candidates_batch_plain, lma.reordered_track_runs
    else:
        loop, reordered = pe.estimate_seeds_plain, lma.reordered_seed_runs
        args = largs
    ref = loop(*args)
    runs = reordered(args, [loop])
    assert len(runs) == lma.ORDERS
    agr = lma.check(ref, {"loop": ref}, runs)
    assert agr.ok and agr.differ == {"loop": 0} and agr.n == 2
    for run in runs:
        assert lma.check(run, {"loop": ref}, runs).ok
    T = ref.T.clone()
    T[1, 0, 3] += 1e-2
    bad = lma.check(ref._replace(T=T), {"loop": ref}, runs)
    assert agr.sensitive == 0 and not bad.ok
    assert bad.differ == {"loop": 1} and bad.outside == {"loop": 1}


def _run(res, ok, T=None):
    res = torch.tensor(res, dtype=torch.float32)
    T = torch.eye(4).repeat(res.shape[0], 1, 1) if T is None else T
    return tr.TrackResult(T=T, aff=None, res_per_level=res, flow=None,
                          ok=torch.tensor(ok))


def test_agreement_allows_only_order_sensitive_candidates():
    """Three reference runs that split on candidate 2 (an inf level, as a
    near-tie that ran a candidate out of view) make it order-sensitive:
    the kernel may differ there, and nowhere else."""
    inf = float("inf")
    base = [[1.0, 2.0], [1.5, 2.5], [3.0, 4.0]]
    ok = [True, True, False]
    refs = {"a": _run(base, ok), "b": _run(base, ok)}
    other = _run([[1.0, 2.0], [1.5, 2.5], [3.0, inf]], ok)
    # the same residuals within 1e-3 relative agree; the kernel follows `other`
    assert lma.check(_run([[1.0005, 2.0], [1.5, 2.5], [3.0, 4.0]], ok), refs, [other]).ok
    agr = lma.check(other, refs, [other])
    assert agr.ok and agr.sensitive == 1 and agr.differ == {"a": 1, "b": 1}
    # moving candidate 0 (not order-sensitive) fails, however few differ
    bad = lma.check(_run([[1.01, 2.0], [1.5, 2.5], [3.0, 4.0]], ok), refs, [other])
    assert not bad.ok and bad.outside == {"a": 1, "b": 1}
    # so does another ok, or a NaN where the reference is finite
    assert not lma.check(_run(base, [True, False, False]), refs, [other]).ok
    assert not lma.check(_run([[1.0, float("nan")], [1.5, 2.5], [3.0, 4.0]], ok),
                         refs, [other]).ok
    # and a pose entry off by more than 1e-3 where every level saw points
    T = torch.eye(4).repeat(3, 1, 1)
    T[1, 2, 3] = 2e-3
    assert not lma.check(_run(base, ok, T), refs, [other]).ok


def _scale_args():
    """The tracker batch's template and pyramid as a scale problem: camera
    1's intrinsics differ from camera 0's, and the extrinsics rotate."""
    args, _ = _lm_args()
    pyr, tmpl, intr0, cfg = args[:4]
    intr1 = make_pyramid_intrinsics(62.0, 61.0, W / 2 + 0.5, H / 2 - 1.5, W, H, L)
    T10 = np.eye(4, dtype=np.float32)
    T10[:3, :3] = lie.se3_exp_np([0.0, 0.0, 0.0, 0.01, -0.02, 0.005])[:3, :3]
    T10[:3, 3] = [-0.54, 0.01, 1e-3]
    return (pyr, tmpl, torch.tensor([0.5, 1.0, 2.0]), intr0, intr1, T10, cfg)


def test_scale_params_per_level():
    """Each level of K3-LM's struct: camera 1's image, size, bounds and
    intrinsics, the template's lists, R01 K0^-1 formed in f32 as the plain
    loop forms it, and the level's iterations; t01, the LM's scalars, the
    guesses beside them."""
    pyr, tmpl, s0, intr0, intr1, T10, cfg = args = _scale_args()
    out = torch.empty(3, rlm.SCALE_OUT)
    p = rlm.scale_lm_params(*args, out)
    assert (p.levels, p.G, p.s_init, p.out) == (L, 3, s0.data_ptr(), out.data_ptr())
    np.testing.assert_array_equal(np.array(p.t01), T10[:3, 3])
    tc = cfg.tracker
    assert (p.huber, p.coarse_cutoff, p.cutoff_repeat_max) == (
        tc.huber_th, tc.coarse_cutoff_th, tc.cutoff_repeat_max)
    assert p.lambda_lim == pytest.approx(tc.lambda_extrapolation_limit, rel=1e-7)
    for lvl in range(L):
        lv = p.lv[lvl]
        assert (lv.H, lv.W, lv.N) == (H >> lvl, W >> lvl, 128 >> lvl)
        assert lv.img == pyr[lvl].data_ptr() and lv.p2 == tmpl.pid[lvl].data_ptr()
        assert lv.pmask == tmpl.pmask[lvl].data_ptr() and lv.color_stride == 1
        assert (lv.fx, lv.fy, lv.cx, lv.cy) == pytest.approx(
            (intr1.fx[lvl], intr1.fy[lvl], intr1.cx[lvl], intr1.cy[lvl]))
        assert lv.umax == np.float32((W >> lvl) - 1.001)
        R01Ki = (torch.as_tensor(T10)[:3, :3]
                 @ torch.as_tensor(intr0.Ki(lvl), dtype=torch.float32)).numpy()
        np.testing.assert_allclose(np.array(lv.Ki), R01Ki.reshape(9), rtol=1e-6, atol=1e-9)
        assert lv.max_iters == tc.max_iterations[lvl] and lv.compute_flow == 0


@pytest.mark.parametrize("sizes,smem", [
    ((8192, 4096, 2048, 1024, 512), 17408 + 8704 + 4352 + 2176 + 1088),
    ((512, 256, 128, 128, 128), 1088 + 544 + 3 * 272),
    ((5, 33), 80 + 144)])
def test_scale_smem(sizes, smem):
    """K3-LM's shared memory a block: every level's slice (an eighth of
    its points rounded up to 4, 17 bytes a point, each level 16-byte
    aligned)."""
    assert rlm.scale_smem(sizes) == smem


def test_scale_struct_filled_from_a_prototype(monkeypatch):
    """A call's K3-LM struct is a copy of a prototype kept per image and
    template sizes, intrinsics, extrinsics and configuration, with the
    call's pointers filled in: it has the bytes of a fresh build
    for the same arguments. Another template or pyramid of the same sizes
    only changes the pointers; other sizes, another configuration or other
    extrinsics build a new prototype."""
    monkeypatch.setattr(rlm, "_scale_proto", [None])
    pyr, tmpl, s0, intr0, intr1, T10, cfg = args = _scale_args()
    out = torch.empty(3, rlm.SCALE_OUT)
    fresh = lambda *a: bytes(rlm.scale_lm_params(*a, out))
    assert bytes(rlm._scale_params(*args, out)) == fresh(*args)
    proto = rlm._scale_proto[0]
    other = (tuple(x.clone() for x in pyr), tmpl._replace(pu=tuple(x.clone() for x in tmpl.pu),
                                                           pmask=tuple(x.clone() for x in tmpl.pmask)),
             torch.tensor([1.0, 2.0]), intr0, intr1, T10.copy(), cfg)
    p = rlm._scale_params(*other, out)
    assert rlm._scale_proto[0] is proto and bytes(p) == fresh(*other)
    assert (p.lv[0].img, p.lv[1].p0, p.lv[0].pmask, p.G) == (
        other[0][0].data_ptr(), other[1].pu[1].data_ptr(), other[1].pmask[0].data_ptr(), 2)
    T11 = T10.copy()
    T11[0, 3] += 0.01
    small = tmpl._replace(**{k: tuple(x[:96] for x in getattr(tmpl, k))
                             for k in ("pu", "pv", "pid", "pcolor", "pmask")})
    for changed in ((pyr, small, s0, intr0, intr1, T10, cfg),
                    (pyr, tmpl, s0, intr0, intr1, T10, make_config(W, H)),
                    (pyr, tmpl, s0, intr0, intr1, T11, cfg)):
        p = rlm._scale_params(*changed, out)
        assert rlm._scale_proto[0] is not proto and bytes(p) == fresh(*changed)
        proto = rlm._scale_proto[0]


def test_scale_template_checked_once(monkeypatch):
    """K3-LM checks a template's tensors once per template (the same
    tensors) and the pyramid and guesses every call; the check keeps no
    template alive."""
    checked = []
    monkeypatch.setattr(rlm._cuda, "require_cuda", lambda name, *ts: checked.append(len(ts)))
    monkeypatch.setattr(rlm, "_scale_checked", [None])
    _, tmpl = _scale_args()[:2]
    dev = torch.device("cpu")
    for t in (tmpl, tmpl, tmpl._replace(pu=tuple(x.clone() for x in tmpl.pu)), tmpl):
        rlm._check_template(t, dev)
    assert checked == [5 * L] * 3
    with pytest.raises(ValueError):
        rlm._check_template(tmpl, torch.device("meta"))
    other = tmpl._replace(pid=tuple(x.clone() for x in tmpl.pid))
    rlm._check_template(other, dev)
    gone = weakref.ref(other.pid[0])
    del other
    assert gone() is None and len(checked) == 4


def test_scale_out_names_the_rows():
    """K3-LM's output rows by name: each field a view of its slot(s), the
    per-level ones as wide as the template's levels, in NamedTuple order
    when iterated."""
    rows = torch.arange(3 * rlm.SCALE_OUT, dtype=torch.float32).reshape(3, rlm.SCALE_OUT)
    o = rlm.ScaleLmOut(rows, L)
    want = (rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 4:4 + L],
            rows[:, 12:12 + L], rows[:, 20:20 + L])
    got = (o.scale, o.error, o.E, o.n, o.repeat, o.passes, o.run)
    for x, y, z in zip(got, want, o):
        assert torch.equal(x, y) and torch.equal(z, y)
        assert x.data_ptr() == y.data_ptr()          # a view, no copy
    assert len(list(o)) == 7


def test_scale_cpu_tensors_take_the_plain_loop():
    """optimize_scale_batch on CPU tensors is the plain loop and counts no
    launch of K3-LM or of the per-pass K3."""
    args = _scale_args()
    counts = (rlm.scale_lm_cuda.launches, rh.scale_residual_pass_cuda.launches)
    a, b = so.optimize_scale_batch(*args), so.optimize_scale_batch_plain(*args)
    assert torch.equal(a.scale, b.scale) and torch.equal(a.error, b.error)
    assert counts == (rlm.scale_lm_cuda.launches, rh.scale_residual_pass_cuda.launches)


def test_agreement_on_scale_results():
    """The rule on scale results: scale and error within 1e-3 relative,
    ok where the error counts (> 0); the reordered plain loops pass, a
    guess moved by 1e-2 relative fails."""
    args = _scale_args()
    ref = so.optimize_scale_batch_plain(*args)
    runs = lma.reordered_scale_runs(args, [so.optimize_scale_batch_plain])
    assert len(runs) == lma.ORDERS
    assert lma.check(ref, {"loop": ref}, runs).ok
    moved = ref._replace(scale=ref.scale * torch.tensor([1.0, 1.01, 1.0]))
    bad = lma.check(moved, {"loop": ref}, runs)
    assert not bad.ok and bad.differ == {"loop": 1}


def test_track_struct_built_once_per_template(monkeypatch):
    """K2-LM's per-level fields and schedule are built once per template
    and copied per call (only the images change); the copy equals a fresh
    build, and another template, configuration or image size rebuilds
    it."""
    monkeypatch.setattr(rlm._cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(rlm, "_track_proto", [None])
    args, _ = _lm_args()
    pyr, tmpl, intr, cfg = args[:4]
    p = rlm._track_params(pyr, tmpl, intr, cfg)
    proto = rlm._track_proto[0]
    assert (p.levels, p.chunk, p.lv[0].compute_flow, p.lv[1].compute_flow) == (
        L, rlm.slice_len(128), 1, 0)
    assert p.lv[1].p0 == tmpl.pu[1].data_ptr() and p.lv[1].N == 64
    assert list(p.pre) == pytest.approx([float(v) for v in rh.POSE_PRECOND])
    other = tuple(x.clone() for x in pyr)
    q = rlm._track_params(other, tmpl, intr, cfg)
    assert rlm._track_proto[0] is proto
    assert [q.lv[l].img for l in range(L)] == [x.data_ptr() for x in other]
    assert bytes(q.lv[1])[8:] == bytes(p.lv[1])[8:]          # all but the image
    for changed in ((pyr, tmpl._replace(pu=tuple(x.clone() for x in tmpl.pu)), intr, cfg),
                    (pyr, tmpl, intr, make_config(W, H))):
        rlm._track_params(*changed)
        assert rlm._track_proto[0] is not proto
        proto = rlm._track_proto[0]
    monkeypatch.setattr(rlm, "_track_proto", [None])
    assert bytes(rlm._track_params(pyr, tmpl, intr, cfg)) == bytes(p)


def _stacked(S):
    """The tracker batch's pyramid and template stacked S times: levels
    [S, H, W, 3], lists [S, N] (parallel/mesh.py's batched step)."""
    args, _ = _lm_args()
    pyr, tmpl = args[:2]
    stack = lambda xs: tuple(torch.stack([x] * S) for x in xs)
    return stack(pyr), TrackerTemplate(*[stack(leaf) for leaf in tmpl]), args


@pytest.mark.parametrize("S", [1, 3])
def test_sequence_strides_in_the_structs(monkeypatch, S):
    """Stacked sequences set each level's strides (the elements between two
    sequences' images and point lists) and the candidates (guesses) per
    sequence; one sequence's call leaves the strides at 0."""
    monkeypatch.setattr(rlm._cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(rlm, "_track_proto", [None])
    pyr, tmpl, args = _stacked(S)
    intr, cfg = args[2], args[3]
    p = rlm._track_params(pyr, tmpl, intr, cfg)
    rlm._batch(p, torch.zeros(2 * S, 4, 4), torch.empty(2 * S, rlm.OUT), rlm.n_sequences(pyr))
    assert (p.B, p.per_seq) == (2 * S, 2)
    for lvl in range(L):
        h, w, n = H >> lvl, W >> lvl, 128 >> lvl
        assert (p.lv[lvl].H, p.lv[lvl].W, p.lv[lvl].N) == (h, w, n)
        assert (p.lv[lvl].img_stride, p.lv[lvl].pt_stride) == (h * w * 3, n)
    one = rlm._track_params(args[0], args[1], intr, cfg)
    assert all((one.lv[l].img_stride, one.lv[l].pt_stride) == (0, 0) for l in range(L))
    out = torch.empty(3 * S, rlm.SCALE_OUT)
    q = rlm.scale_lm_params(pyr, tmpl, torch.ones(3 * S), intr, intr, np.eye(4), cfg, out)
    assert (q.G, q.per_seq, q.lv[1].pt_stride) == (3 * S, 3, 64)
    with pytest.raises(ValueError, match="over"):
        rlm._batch(p, torch.zeros(2 * S + 1, 4, 4), torch.empty(1, rlm.OUT), S + 1)


def test_sequence_shapes_must_agree(monkeypatch):
    """Stacked levels need stacked lists of the same S, and one
    sequence's levels need lists of one."""
    monkeypatch.setattr(rlm._cuda, "require_cuda", lambda *a: None)
    pyr, tmpl, args = _stacked(3)
    _, tmpl2, _ = _stacked(2)
    for p, t in ((pyr, tmpl2), (pyr, args[1]), (args[0], tmpl)):
        with pytest.raises(ValueError, match="lists"):
            rlm._check_sequences("track_lm", p, t)
    assert rlm._check_sequences("track_lm", pyr, tmpl) == 3
    assert rlm._check_sequences("track_lm", args[0], args[1]) == 1
