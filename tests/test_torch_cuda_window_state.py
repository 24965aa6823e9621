"""K16-K18 (``csrc/window.cu``, ``ops/window.py``) on the card against
their plain versions on the same card tensors:

- K16 (``window_pose_cuda``) bit-equal to ``window_pose_plain`` at 1 to 8
  slots, every slot as reference, rotations on se3_exp's Taylor branch and
  past it, and with a NaN in a pose's delta (the same NaN pattern);
- K17 (``optimize_keyframe``: its prologue, the resident launch, its
  epilogue) bit-equal to ``optimize_keyframe_plain`` around the same
  resident launch (the stable sort, ``host_groups``, ``torch.nanquantile``
  and the indexed scatter): every field of the state, rmse, ok, Hdd and
  the overflow count, at 2, 4 and 8 slots, compact and full-pool, a
  shuffled pool, a NaN pose, an overflowing budget, each slot as the
  newest, equal energies, no pair in toward the newest slot, B = 1, B =
  NP and B past 8192;
- K18 (``marginalize_cuda``) against ``marginalize_plain``: validity, ids,
  residual flags and deltas bit-equal (their order is fixed); the points
  stage alone (no frame): HM and bM within 1e-5 of the largest entry of
  the change it made, not of the prior it kept (the plain version's
  matmuls sum in cuBLAS's order), and that gate fails when the kernel
  skips the last flagged point; the whole call no further from float64
  frame marginalizations of its own points stage than twice the plain
  version plus 1e-5 of the largest entry (an 8x8 block with the anchor's
  1e8 prior, or one the points leave nearly singular, is ill-conditioned);
  a frame-only marginalization of the anchor against float64 (twice the
  plain version's error plus 1e-7 of the largest entry); an empty point
  mask; several frames in one launch; flagged points on one host, on
  every host and on none, the anchor's frame with points, each on grids
  of 1, 8 and 132 blocks with the same bits;
- two runs of each give the same bits, with no host read (under
  ``torch.cuda.set_sync_debug_mode("error")``), and each is one launch;
  K18's calls queued behind a busy card, as many as its staging buffers,
  wait for no event.

They need a CUDA card and skip elsewhere; they import nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_window_state.py
"""

import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu_torch.geometry import lie
from direct_stereo_slam_tpu_torch.models import ba
from direct_stereo_slam_tpu_torch.ops import window as win
from torch_ba_window import ba_window, with_nan_pose

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _bits(t):
    """A tensor's bits (NaN equal to the same NaN)."""
    if t.dtype == torch.float32:
        return t.contiguous().view(torch.int32)
    return t


def _same(a, b, name=""):
    assert a.shape == b.shape and a.dtype == b.dtype, name
    assert torch.equal(_bits(a), _bits(b)), name


def _poses(W, seed, nan=False):
    rng = np.random.RandomState(seed)
    T_zero = np.stack([lie.se3_exp_np(rng.randn(6) * [1, 1, 1, .3, .3, .3]) for _ in range(W)])
    delta = (rng.randn(W, 8) * 0.05).astype(np.float32)
    delta[::2, 3:6] *= 1e-3                    # every other slot on the Taylor branch
    if nan:
        delta[W // 2, 0] = np.nan
    aff = rng.randn(W, 2).astype(np.float32)
    calib = np.array([300.0, 301.0, 160.0, 120.0], np.float32)
    cdelta = rng.randn(4).astype(np.float32)
    return tuple(torch.tensor(np.asarray(a, np.float32))
                 for a in (T_zero, delta, aff, calib, cdelta))


@pytest.mark.parametrize("W", range(1, 9))
@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
def test_window_pose_bit_equal(dev, W, nan):
    args = tuple(a.to(dev) for a in _poses(W, 10 + W, nan and W > 1))
    for ref in range(W):
        got = win.window_pose_cuda(*args, ref)
        want = win.window_pose_plain(*args, ref)
        for name, a, b in zip(win.WindowPose._fields, got, want):
            _same(a, b, name)


def _window(dev, W=4, NP=256, shuffle=False, nan=False, case="plain"):
    st, cfg = ba_window(W, NP, n_frames=min(W, 5 if W > 4 else 3), per=min(48, NP // W),
                        device=dev)
    if shuffle:
        perm = torch.as_tensor(np.random.RandomState(3).permutation(NP), device=dev)
        st = st._replace(**{f: getattr(st, f)[perm] for f in ba._POINT_FIELDS})
    if nan:
        st = with_nan_pose(st)
    if case == "ties":
        # one gray level, one colour, one weight: the pairs in bounds have
        # equal energies
        st = st._replace(images=torch.full_like(st.images, 0.5),
                         p_color=torch.full_like(st.p_color, 0.25),
                         p_weight=torch.ones_like(st.p_weight))
    elif case == "no_pair":
        # no good residual toward the newest slot: no pair is in, the
        # threshold falls back
        newest = min(W, 5 if W > 4 else 3) - 1
        rg = st.p_res_good.clone()
        rg[:, newest] = False
        st = st._replace(p_res_good=rg)
    return st, cfg


def _same_keyframe(got, want):
    for name in ("T_zero", "delta", "calib_delta", "energy_th", "p_idepth", "p_valid",
                 "p_res_good", "p_num_good", "p_last_res", "HM", "bM", "frame_valid"):
        _same(getattr(got[0], name), getattr(want[0], name), name)
    for name, a, b in zip(("rmse", "ok", "hdd", "n_dropped"), got[1:], want[1:]):
        _same(a, b, name)


@pytest.mark.parametrize("W,NP,budget,case", [
    (2, 128, None, "plain"), (4, 256, 160, "plain"), (4, 256, None, "plain"),
    (8, 512, 300, "shuffled"), (4, 256, 160, "nan_pose"), (4, 256, 100, "overflow"),
    (8, 4096, 2560, "plain"), (4, 256, 160, "ties"), (4, 256, 160, "no_pair"),
    (4, 256, 1, "plain"), (8, 4096, None, "plain"), (8, 12288, None, "plain"),
    (8, 12288, 9000, "shuffled")])
def test_keyframe_bit_equal(dev, W, NP, budget, case):
    """B = NP, B = 1 and B past the 8192 keys a sort held in shared
    memory; equal energies; NaN energies (a NaN pose); no pair in toward
    the newest slot (the fallback)."""
    st, cfg = _window(dev, W, NP, shuffle=case == "shuffled", nan=case == "nan_pose",
                      case=case)
    newest = min(W, 5 if W > 4 else 3) - 1
    for slot in sorted({newest, 0}):
        got = ba.optimize_keyframe(st, cfg, 6, slot, budget)
        want = ba.optimize_keyframe_plain(st, cfg, 6, slot, budget)
        _same_keyframe(got, want)
    if case == "overflow":
        assert int(got[4]) > 0


def _marg_case(st, seed):
    rng = np.random.RandomState(seed)
    valid = st.p_valid.cpu().numpy()
    marg = valid & (rng.rand(valid.size) < 0.15)
    drop = valid & ~marg & (rng.rand(valid.size) < 0.1)
    return marg, drop


# K18's points stage against the plain version: HM's and bM's largest
# error over the largest entry of the change the stage made (_change_err)
K18_TOL = 1e-5
MARG_CASES = [(4, [0], True), (4, [1], True), (4, [0, 1], True), (4, [], True),
              (4, [0], False), (2, [1], True), (8, [0, 3], True), (8, [], False)]


def _change_err(got, want, base):
    """max|got - want| over max|want - base|, in float64."""
    d = max(float((want.double() - base.double()).abs().max()), 1e-30)
    return float((got.double() - want.double()).abs().max()) / d


def _marg_window(dev, W, points):
    """A window with a prior to fold into (A A^T x 1e3), its masks and
    its linearization."""
    st, cfg = _window(dev, W, 64 * W)
    rng = np.random.RandomState(W)
    D = 4 + 8 * W
    A = torch.tensor(rng.randn(D, D).astype(np.float32), device=dev)
    st = st._replace(HM=A @ A.T * 1e3, bM=torch.tensor(rng.randn(D).astype(np.float32),
                                                      device=dev))
    marg, drop = _marg_case(st, W)
    if not points:
        marg[:] = False
    return st, cfg, marg, drop, ba.linearize(st, cfg)


def _views(st):
    """Host copies of the state's validity and hosts (the front end's
    bundle holds them)."""
    return st.p_valid.cpu().numpy(), st.p_host.cpu().numpy()


def _frames64(state, slots):
    """marginalize_frame of each slot in order on ``state``'s HM and bM, in
    float64 (the anchor of each step from the frames still valid)."""
    H, b = state.HM, state.bM
    fv, fid = state.frame_valid.cpu().numpy().copy(), state.frame_id.cpu().numpy().copy()
    for slot in slots:
        anchor = int(np.argmin(np.where(fv, fid, 2 ** 30)))
        H, b = (torch.as_tensor(x) for x in _frame_marg64(H, b, slot, anchor == slot))
        fv[slot], fid[slot] = False, -1
    return {"HM": H.double().cpu(), "bM": b.double().cpu()}


def _k18_errors(st, lin, marg, drop, slots, cfg, got, want):
    """K18's result ``got`` against the plain version's ``want``: the
    points stage alone (both with no frame) as _change_err of HM and bM;
    then each whole result's distance from float64 frame marginalizations
    of its own points stage, the kernel's and the plain version's (an 8x8
    block with the anchor's 1e8 prior, or one the points leave nearly
    singular, is ill-conditioned: f32 inverses differ there, so each is
    held to float64, as K6 is)."""
    got_p = ba.marginalize(st, lin, marg, drop, [], cfg, _views(st))
    want_p = ba.marginalize_plain(st, lin, marg, drop, [], cfg)
    points = {n: _change_err(getattr(got_p, n), getattr(want_p, n), getattr(st, n))
              for n in ("HM", "bM")}
    ref_k, ref_p = _frames64(got_p, slots), _frames64(want_p, slots)
    frames = {n: (float((getattr(got, n).double().cpu() - ref_k[n]).abs().max()),
                  float((getattr(want, n).double().cpu() - ref_p[n]).abs().max()),
                  float(ref_p[n].abs().max()))
              for n in ("HM", "bM")}
    return points, frames


def _frames_ok(e_k, e_p, scale):
    """The kernel no further from float64 than twice the plain version,
    plus K18_TOL of the largest entry (the frame stage works on the whole
    prior, so its f32 error scales with it)."""
    return e_k <= 2.0 * e_p + K18_TOL * scale


@pytest.mark.parametrize("W,slots,points", MARG_CASES)
def test_marginalize_matches_plain(dev, W, slots, points):
    st, cfg, marg, drop, lin = _marg_window(dev, W, points)
    got = ba.marginalize(st, lin, marg, drop, slots, cfg, _views(st))
    want = ba.marginalize_plain(st, lin, marg, drop, slots, cfg)
    for name in ("p_valid", "frame_valid", "frame_id", "p_res_good", "delta"):
        _same(getattr(got, name), getattr(want, name), name)
    for name in ("HM", "bM"):
        assert torch.equal(torch.isnan(getattr(got, name)), torch.isnan(getattr(want, name)))
    points_err, frames_err = _k18_errors(st, lin, marg, drop, slots, cfg, got, want)
    assert all(e <= K18_TOL for e in points_err.values()), points_err
    assert all(_frames_ok(*e) for e in frames_err.values()), frames_err
    if not points and not slots:
        _same(got.HM, st.HM)
        _same(got.bM, st.bM)


def _last_live(st, marg):
    """The last flagged point with a residual toward a valid frame other
    than its host."""
    t = torch.arange(st.num_slots, device=st.p_host.device)
    live = (st.p_res_good & st.frame_valid[None, :] & (t[None, :] != st.p_host[:, None]))
    return int(np.flatnonzero(marg & live.any(1).cpu().numpy())[-1])


@pytest.mark.parametrize("W", sorted({c[0] for c in MARG_CASES if c[2]}))
def test_marginalize_gate_sees_a_skipped_point(dev, W):
    """The points-stage gate above fails for a K18 that leaves out the
    last flagged point with a live pair: the kernel run without it against
    the plain version with it."""
    st, cfg, marg, drop, lin = _marg_window(dev, W, True)
    short = marg.copy()
    short[_last_live(st, marg)] = False
    got_p = ba.marginalize(st, lin, short, drop, [], cfg, _views(st))
    want_p = ba.marginalize_plain(st, lin, marg, drop, [], cfg)
    errs = [_change_err(getattr(got_p, n), getattr(want_p, n), getattr(st, n))
            for n in ("HM", "bM")]
    assert max(errs) > K18_TOL, errs


def _host_case(st, case):
    """(marg, drop, slots) of a K18 case: flagged points on one host, on
    every valid frame's host, on none (a frame alone), or the anchor's
    frame marginalized with points."""
    marg, drop = _marg_case(st, 5)
    host = st.p_host.cpu().numpy()
    anchor = int(ba.anchor_slot(st))
    if case == "one_host":
        marg &= host == 1
        return marg, drop, [1]
    if case == "all_hosts":
        for h in range(int(st.frame_valid.sum())):
            assert (marg & (host == h)).any()
        return marg, drop, [2]
    if case == "none":
        marg[:] = False
        return marg, drop, [1]
    return marg, drop, [anchor]


@pytest.mark.parametrize("case", ["one_host", "all_hosts", "none", "anchor"])
def test_marginalize_hosts_and_grids(dev, case):
    """K18 on grids of 1, 8 and 132 blocks gives the same bits (every sum
    in an order of its own, not the grid's), and each held to the plain
    version as above."""
    st, cfg, _, _, lin = _marg_window(dev, 4, True)
    marg, drop, slots = _host_case(st, case)
    lists = win.marg_lists(marg, drop, *_views(st), st.num_slots)
    runs = [win.marginalize_cuda(st, lin.Hdd, lists, slots, cfg, grid=g) for g in (1, 8, 132)]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            _same(a, b)
    want = ba.marginalize_plain(st, lin, marg, drop, slots, cfg)
    got = runs[0]
    for name in ("p_valid", "frame_valid", "frame_id", "p_res_good", "delta"):
        _same(getattr(got, name), getattr(want, name), name)
    points_err, frames_err = _k18_errors(st, lin, marg, drop, slots, cfg, got, want)
    assert all(e <= K18_TOL for e in points_err.values()), points_err
    assert all(_frames_ok(*e) for e in frames_err.values()), frames_err


def _frame_marg64(HM, bM, slot, anchor):
    """marginalize_frame's HM, bM in float64."""
    HM, bM = HM.double().cpu().numpy().copy(), bM.double().cpu().numpy()
    i0 = 4 + 8 * slot
    sel = np.arange(i0, i0 + 8)
    keep = np.ones(HM.shape[0], bool)
    keep[sel] = False
    if anchor:
        HM[sel, sel] += 1e8
    Hbb = HM[np.ix_(sel, sel)] + 1e-8 * np.eye(8)
    Hab = HM[:, sel] * keep[:, None]
    inv = np.linalg.inv(Hbb)
    H = (HM - Hab @ inv @ Hab.T) * (keep[:, None] & keep[None, :])
    b = (bM - Hab @ (inv @ bM[sel])) * keep
    return H, b


def test_anchor_inverse_against_float64(dev):
    st, cfg = _window(dev, 4, 256)
    lin = ba.linearize(st, cfg)
    st = ba.marginalize_points(st, torch.as_tensor(_marg_case(st, 1)[0], device=dev), cfg, lin)
    none = np.zeros(st.num_points, bool)
    anchor = int(ba.anchor_slot(st))
    got = ba.marginalize(st, lin, none, none, [anchor], cfg, _views(st))
    want = ba.marginalize_plain(st, lin, none, none, [anchor], cfg)
    H64, b64 = _frame_marg64(st.HM, st.bM, anchor, True)
    for name, ref in (("HM", H64), ("bM", b64)):
        ref = torch.as_tensor(ref)
        e_k = float((getattr(got, name).double().cpu() - ref).abs().max())
        e_p = float((getattr(want, name).double().cpu() - ref).abs().max())
        assert e_k <= 2.0 * e_p + 1e-7 * float(ref.abs().max()), (name, e_k, e_p)


def test_two_runs_same_bits_no_host_read(dev):
    st, cfg = _window(dev, 4, 256)
    marg, drop = _marg_case(st, 2)
    lin = ba.linearize(st, cfg)
    runs = []
    counters = (win.window_pose_cuda, win.ba_prologue_cuda, win.ba_epilogue_cuda,
                win.marginalize_cuda)
    kf0 = ba.optimize_keyframe(st, cfg, 6, 2, 160)[0]
    # the host copies of the validity and hosts the front end's bundle holds
    views = _views(kf0)
    ba.marginalize(kf0, lin, marg, drop, [0], cfg, views)
    for _ in range(2):                     # (the buffers built above)
        torch.cuda.synchronize()
        before = [fn.launches for fn in counters]
        torch.cuda.set_sync_debug_mode("error")
        try:
            pose = win.window_pose(st, 2)
            kf = ba.optimize_keyframe(st, cfg, 6, 2, 160)
            mg = ba.marginalize(kf[0], lin, marg, drop, [0], cfg, views)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 1, 1, 1]
        runs.append(list(pose) + list(kf[0]) + list(kf[1:]) + list(mg))
    for a, b in zip(runs[0], runs[1]):
        _same(a, b)


def test_marginalize_queues_without_waiting(dev):
    """K18 calls queued behind a busy card (several in flight, as a timing
    loop issues them) wait for no event and read nothing back: each takes
    the next of its key's staging buffers, and all give the same bits."""
    st, cfg, marg, drop, lin = _marg_window(dev, 4, True)
    views = _views(st)
    ba.marginalize(st, lin, marg, drop, [1], cfg, views)      # the key's buffers
    torch.cuda.synchronize()
    waits = [0]
    event_sync = torch.cuda.Event.synchronize

    def counted(ev):
        waits[0] += 1
        return event_sync(ev)

    torch.cuda.Event.synchronize = counted
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda._sleep(50_000_000)
        runs = [ba.marginalize(st, lin, marg, drop, [1], cfg, views)
                for _ in range(win._RING)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.Event.synchronize = event_sync
    assert waits[0] == 0
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            _same(a, b)
