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
  K12 and K13.

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
        assert torch.equal(x, y)
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
