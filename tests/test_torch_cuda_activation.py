"""The activation kernels K12 and K13 (csrc/activate.cu) against their
plain PyTorch versions on the card (ops/activate.py), on the calls the
port's own SLAMNode makes over 24 rendered frames at 320x96 (preset 0: 8
slots of 1024 candidates, a budget of 256, a pool of 4096 rows):

- K12 (``gate_compact_activate``): ``drop`` and ``lane`` equal (the gate
  is computed operation by operation as the plain version computes it);
  ``ok`` and the accepted idepths (rel 1e-4 or 1e-5 absolute) equal but
  on edge lanes, which are counted: a lane whose accept flips or whose
  idepth moves further (the LM's sums over 64 terms in another order can
  turn a near-tie of energies or the Hessian's threshold), at most 1% of
  the accepted lanes;
- K13 (``allocate_insert_consume``) bit-equal to the plain version (all
  integer: the allocation, the pool's rows, the candidates' validity) on
  a recorded call, with every participating slot's own segment full, and
  with the pool all but full (the cap);
- two runs of each bit-equal (no atomics);
- one front-end ``_activate_points`` call with no host read
  (``torch.cuda.set_sync_debug_mode("error")``): one launch each of K1,
  K12 and K13;
- both kernels against the plain version on the recorded calls and on
  edge cases (GATE_CASES, ALLOC_CASES: a slot's survivors past the
  budget, no survivor, a slot without survivors, a slot that does not
  participate, a full pool, S = 1, NI = 1000 and 1500, no own segment,
  20 flags a pool row, own segments that are not whole free-mask words):
  K12's ``drop`` and ``lane`` equal to the plain version's and ``ok`` /
  the accepted idepths equal but on counted edge lanes, its LM-warp
  count the sum over slots of min(survivors, budget); K13 bit-equal to
  the plain version; two runs bit-equal; K13 64 times, each the plain
  version's bits.

These tests need a CUDA card and skip elsewhere. They import nothing of
JAX, so on the card's machine they run without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_activation.py
"""

import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu_torch.config import make_config
from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu_torch.io.synthetic import SyntheticStereoDataset
from direct_stereo_slam_tpu_torch.models import immature
from direct_stereo_slam_tpu_torch.models.frontend import FrontEnd
from direct_stereo_slam_tpu_torch.ops import activate as act
from direct_stereo_slam_tpu_torch.ops import distance_map as dm
from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode

pytestmark = pytest.mark.cuda

W, H, N_FRAMES = 320, 96, 24


@pytest.fixture(scope="module")
def calls():
    """The port's node over the frames on the card, its activation calls
    recorded (states are replaced, never written in place, so the
    arguments stay as they were)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    dev = torch.device("cuda")
    ds = SyntheticStereoDataset(n_frames=N_FRAMES, width=W, height=H, speed=0.3, device=dev)
    cfg = make_config(W, H, preset=0, mode=1)
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H,
                                   cfg.tracker.pyr_levels)
    rec = {"gate": [], "alloc": [], "activate": []}
    gate, alloc, activate = (act.gate_compact_activate, act.allocate_insert_consume,
                             FrontEnd._activate_points)

    def gate_kept(*a):
        rec["gate"].append(a)
        return gate(*a)

    def alloc_kept(*a):
        rec["alloc"].append(a)
        return alloc(*a)

    def activate_kept(self, *a):
        rec["activate"].append((self.ba_state, self.immatures, set(self.imm_slots),
                                self.current_min_act_dist, a))
        return activate(self, *a)

    act.gate_compact_activate, act.allocate_insert_consume = gate_kept, alloc_kept
    FrontEnd._activate_points = activate_kept
    try:
        node = SLAMNode(cfg, intr, intr, ds.t_cam1_cam0, device=dev)
        for i in range(N_FRAMES):
            f = ds.frame(i)
            node.process(f["img0"], f["img1"], float(f["timestamp"]))
        node.finish()
    finally:
        act.gate_compact_activate, act.allocate_insert_consume = gate, alloc
        FrontEnd._activate_points = activate
    torch.cuda.synchronize()
    assert len(rec["gate"]) >= 3 and len(rec["alloc"]) == len(rec["gate"])
    return dict(rec, cfg=cfg, intr=intr, t=ds.t_cam1_cam0, dev=dev)


@pytest.mark.parametrize("which", [0, 1, -1])
def test_gate_activate_matches_plain(calls, which):
    a = calls["gate"][which]
    got = act.gate_compact_activate_cuda(*a)
    want = act.gate_compact_activate_plain(*a)
    torch.cuda.synchronize()
    ok_k, id_k, lane_k, drop_k = got
    ok_p, id_p, lane_p, drop_p = want
    assert torch.equal(drop_k, drop_p)
    assert torch.equal(lane_k, lane_p)
    close = torch.isclose(id_k, id_p, rtol=1e-4, atol=1e-5)
    edge = (ok_k != ok_p) | ((ok_k & ok_p) & ~close)
    n_acc = int((ok_k | ok_p).sum())
    n_edge = int(edge.sum())
    print(f"K12 call {which}: {n_acc} accepted lanes, {n_edge} edge lanes "
          f"({int((ok_k != ok_p).sum())} accepts differ)")
    assert n_acc > 0
    assert n_edge <= max(1, n_acc // 100)


def _alloc_args(calls, case):
    # the call that accepts the most candidates
    fullest = max(calls["alloc"], key=lambda a: int(a[2].sum()))
    state, imm, ok, idepth, lane, drop, participate, P = fullest
    if case != "recorded":
        p_valid = state.p_valid.clone()
        if case == "own_segment_full":
            for s in np.nonzero(participate)[0]:
                p_valid[s * P:(s + 1) * P] = True
        else:
            p_valid[:] = True
            p_valid[3::401] = False
        state = state._replace(p_valid=p_valid)
    return state, imm, ok, idepth, lane, drop, participate, P


@pytest.mark.parametrize("case", ["recorded", "own_segment_full", "pool_full"])
def test_allocate_insert_matches_plain(calls, case):
    a = _alloc_args(calls, case)
    st_k, imm_k, alloc_k = act.allocate_insert_consume_cuda(*a)
    st_p, imm_p, alloc_p = act.allocate_insert_consume_plain(*a)
    torch.cuda.synchronize()
    for name in act.POOL_FIELDS:
        assert torch.equal(getattr(st_k, name), getattr(st_p, name)), name
    assert torch.equal(imm_k.valid, imm_p.valid)
    for name, k, p in zip(act.ALLOC_FIELDS, alloc_k, alloc_p):
        assert torch.equal(k, p), name
    placed = int(alloc_p[5].sum())
    if case == "pool_full":
        accepted = int(a[2].cpu().numpy()[a[6]].sum())
        assert placed == int((~a[0].p_valid).sum()) < accepted
    else:
        assert placed > 0


def test_two_runs_are_bit_equal(calls):
    g = calls["gate"][-1]
    one, two = act.gate_compact_activate_cuda(*g), act.gate_compact_activate_cuda(*g)
    a = calls["alloc"][-1]
    three, four = act.allocate_insert_consume_cuda(*a), act.allocate_insert_consume_cuda(*a)
    torch.cuda.synchronize()
    for x, y in zip(one, two):
        assert torch.equal(_bits(x), _bits(y))       # the idepth past the survivors is NaN
    for x, y in zip(list(three[0]) + [three[1].valid, *three[2]],
                    list(four[0]) + [four[1].valid, *four[2]]):
        assert torch.equal(x, y)


def test_activate_points_reads_nothing_from_the_card(calls):
    state, imm, slots, mad, args = calls["activate"][-1]
    fe = FrontEnd(calls["cfg"], calls["intr"], calls["intr"], calls["t"], device=calls["dev"])
    fe.ba_state, fe.immatures, fe.imm_slots, fe.current_min_act_dist = state, imm, slots, mad
    counters = (dm.build_distance_map_cuda, act.gate_compact_activate_cuda,
                act.allocate_insert_consume_cuda)
    before = [fn.launches for fn in counters]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fe._activate_points(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 1, 1]
    assert int(fe.ba_state.p_valid.sum()) >= int(state.p_valid.sum())


# K12's edge cases, made from the recorded call with the most valid
# candidates (argument 4 the activation distance, 16 the budget)
GATE_CASES = ("recorded_first", "recorded_fullest", "overflow", "no_survivor",
              "slot_without_survivors", "one_slot", "ni_1000", "ni_1500")


def _fullest_gate(calls):
    return max(calls["gate"], key=lambda a: int(a[0].valid.sum()))


def _slots(a, sl):
    """The gate arguments of slots ``sl`` only."""
    imm = immature.ImmaturePoints(*[f[sl] for f in a[0]])
    return (imm, a[1], a[2][sl], a[3][sl], a[4], np.asarray(a[5])[sl]) + tuple(a[6:])


def _gate_case(calls, case):
    a = calls["gate"][0] if case == "recorded_first" else _fullest_gate(calls)
    if case == "overflow":                  # every gate-passing lane survives; budget 32
        a = a[:4] + (0.0,) + a[5:16] + (32,)
    elif case == "no_survivor":
        a = a[:4] + (1e9,) + a[5:]
    elif case == "slot_without_survivors":
        valid = a[0].valid.clone()
        valid[int(torch.argmax(valid.sum(1)))] = False
        a = (a[0]._replace(valid=valid),) + a[1:]
    elif case == "one_slot":
        s = int(torch.argmax(a[0].valid.sum(1)))
        a = _slots(a, slice(s, s + 1))
    elif case == "ni_1000":
        a = (immature.ImmaturePoints(*[f[:, :1000].contiguous() for f in a[0]]),) + a[1:]
    elif case == "ni_1500":                 # more lanes than a block: the gate in two passes
        a = (immature.ImmaturePoints(*[torch.cat([f, f[:, :476]], 1) for f in a[0]]),) + a[1:]
    return a


def _survivors(a):
    """Per slot, the lanes that pass the gate (the plain version's gate)."""
    dev = a[1].device
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    gate_ok, _ = act._gate_impl(a[0], a[1], f32(a[2]), f32(a[3]), f32(a[4]),
                                torch.as_tensor(np.asarray(a[5], bool), device=dev), a[13],
                                a[14], a[15])
    return gate_ok.sum(1)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("case", GATE_CASES)
def test_gate_cluster_matches_plain_masks(calls, case):
    a = _gate_case(calls, case)
    S, NI = a[0].valid.shape
    bud = min(a[16], NI)
    ran = torch.full((S, bud), 7, dtype=torch.uint8, device=a[1].device)
    new = act.gate_compact_activate_cuda(*a, lm_ran=ran)
    again = act.gate_compact_activate_cuda(*a)
    plain = act.gate_compact_activate_plain(*a)
    n_ok = _survivors(a)
    torch.cuda.synchronize()
    ok, idepth, lane, drop = new
    assert torch.equal(drop, plain[3]) and torch.equal(lane, plain[2])
    close = torch.isclose(idepth, plain[1], rtol=1e-4, atol=1e-5)
    edge = (ok != plain[0]) | ((ok & plain[0]) & ~close)
    assert int(edge.sum()) <= max(1, int((ok | plain[0]).sum()) // 100)
    for x, y in zip(new, again):
        assert torch.equal(_bits(x), _bits(y))
    n_lm = torch.clamp(n_ok, max=bud)
    assert int(ran.sum()) == int(n_lm.sum())
    pos = torch.arange(bud, device=ran.device)[None, :]
    assert torch.equal(ran.bool(), pos < n_lm[:, None])
    # a position past the survivors: not accepted, idepth NaN
    assert not bool(ok[pos >= n_lm[:, None]].any())
    assert bool(torch.isnan(idepth[pos >= n_ok[:, None]]).all())
    print(f"K12 {case}: survivors {n_ok.tolist()}, budget {bud}, LM warps {int(ran.sum())}, "
          f"accepted {int(ok.sum())}")
    if case == "overflow":
        assert int(n_ok.max()) > bud
    if case == "no_survivor":
        assert int(n_ok.sum()) == 0 and int(ran.sum()) == 0
    if case == "slot_without_survivors":
        assert int(n_ok.min()) == 0 < int(n_ok.max())


ALLOC_CASES = ("recorded", "own_segment_full", "pool_full", "slot_not_participating",
               "no_own_segment", "one_slot", "ni_1000", "ni_1500", "overflow", "wide_window",
               "unaligned_segments")


def _alloc_case(calls, case):
    if case in ("recorded", "own_segment_full", "pool_full"):
        return _alloc_args(calls, case)
    state, imm, ok, idepth, lane, drop, participate, P = _alloc_args(calls, "recorded")
    if case == "slot_not_participating":
        participate = participate.copy()
        participate[int(np.argmax(ok.sum(1).cpu().numpy() * participate))] = False
    elif case == "no_own_segment":
        P = 0
    elif case == "one_slot":
        s = int(np.argmax(ok.sum(1).cpu().numpy() * participate))
        sl = slice(s, s + 1)
        imm = immature.ImmaturePoints(*[f[sl] for f in imm])
        ok, idepth, lane, drop = ok[sl], idepth[sl], lane[sl], drop[sl]
        participate = np.ones(1, bool)
    elif case in ("ni_1000", "ni_1500", "overflow"):
        g = _gate_case(calls, case)
        imm = g[0]
        ok, idepth, lane, drop = act.gate_compact_activate_cuda(*g)
    elif case == "wide_window":             # more res_good flags a row than K13 holds in registers
        state = state._replace(p_res_good=torch.cat([state.p_res_good,
                                                     ~state.p_res_good[:, :12]], 1))
    elif case == "unaligned_segments":      # neighbouring slots' own segments share free-mask words
        P = P - 5
    return state, imm, ok, idepth, lane, drop, participate, P


def _alloc_flat(r):
    return [getattr(r[0], f) for f in act.POOL_FIELDS] + [r[1].valid, *r[2]]


@pytest.mark.parametrize("case", ALLOC_CASES)
def test_allocate_cluster_matches_plain(calls, case):
    a = _alloc_case(calls, case)
    new = _alloc_flat(act.allocate_insert_consume_cuda(*a))
    again = _alloc_flat(act.allocate_insert_consume_cuda(*a))
    plain = act.allocate_insert_consume_plain(*a)
    torch.cuda.synchronize()
    names = list(act.POOL_FIELDS) + ["imm_valid"] + list(act.ALLOC_FIELDS)
    for name, x, y, w in zip(names, new, again, _alloc_flat(plain)):
        assert torch.equal(_bits(x), _bits(y)), name
        assert torch.equal(_bits(x), _bits(w)), name
    placed = int(plain[2][5].sum())
    accepted = int(a[2].cpu().numpy()[a[6]].sum())
    if case == "unaligned_segments":
        assert a[7] % 32 != 0
    print(f"K13 {case}: {placed} placed of {accepted} accepted, "
          f"{int((~a[0].p_valid).sum())} free rows")
    if case == "pool_full":
        assert placed == int((~a[0].p_valid).sum()) < accepted
    elif case != "slot_not_participating":
        assert placed > 0


@pytest.mark.parametrize("case", ["recorded", "own_segment_full", "unaligned_segments"])
def test_allocate_cluster_many_runs_are_bit_equal(calls, case):
    # rank 0's walk shares its bit words between warps: 64 launches, each
    # the plain version's bits (a race would show as a launch that differs;
    # only the barriers' order proves one absent)
    a = _alloc_case(calls, case)
    want = _alloc_flat(act.allocate_insert_consume_plain(*a))
    runs = [_alloc_flat(act.allocate_insert_consume_cuda(*a)) for _ in range(64)]
    torch.cuda.synchronize()
    names = list(act.POOL_FIELDS) + ["imm_valid"] + list(act.ALLOC_FIELDS)
    for got in runs:
        for name, x, w in zip(names, got, want):
            assert torch.equal(_bits(x), _bits(w)), name
