"""A keyframe's activation (``ops/activate.py``: K12 the gate, compaction
and idepth LM, K13 the pool-row allocation, insertion and consumption)
and the deferred keyframe tail, on the CPU against the JAX package at the
smoke size of test_torch_marginalized_kf.py (96x48, 3 levels, a window
of 4 keyframes, 128 candidates a slot, 24 frames).

The JAX SLAMNode's run records the inputs and outputs of its
``_gate_compact_activate`` and ``_allocate_candidates`` and the front
end's state around each ``_activate_points``; the port is fed the same
numpy values:

- K12's plain version: ``ok``, ``lane`` and ``drop`` equal, ``idepth``
  of the accepted lanes within rel 1e-4 or 1e-5 absolute (a 3-step 1-D
  LM whose sums over frames x pattern pixels are taken in another order,
  as test_torch_select_immature_ba.py allows the activation), finite
  where the JAX package's is;
- the allocator: equal, on a recorded call, with every participating
  slot's own segment full, and with the pool all but full (the cap);
- one whole ``_activate_points`` call: the pool's rows and
  ``immatures.valid`` after the insertion equal (idepths within the
  tolerance above);
- the deferred tail: both nodes on the same frames hand the same
  MarginalizedKF records to the loop handler in the same calls (one call
  after the keyframe that marginalized them), with the same keyframes
  and per-frame translation within 1e-2 m (test_torch_slice_e2e.py's
  tolerance); a checkpoint taken while a tail is pending resumes
  bit-exact on the CPU;
- the host views cache, patched instead of read, against the state's
  views at every keying of a run and after every frame;
- the CPU dispatch (no CPU tensor reaches the kernel library) and the
  ctypes parameter blocks against ``csrc/activate.cu``'s structs.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu.config import make_config
from direct_stereo_slam_tpu.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
from direct_stereo_slam_tpu.models import frontend as fe_j
from direct_stereo_slam_tpu.runtime.node import SLAMNode as NodeJ
from direct_stereo_slam_tpu_torch.models import ba as ba_t
from direct_stereo_slam_tpu_torch.models.frontend import FrontEnd as FrontEndT
from direct_stereo_slam_tpu_torch.ops import _cuda
from direct_stereo_slam_tpu_torch.ops import activate as act
from direct_stereo_slam_tpu_torch.runtime import checkpoint as ckpt_t
from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode as NodeT
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax as port_cfg
from direct_stereo_slam_tpu_torch.utils.convert import to_torch
from direct_stereo_slam_tpu_torch.utils.device import to_host
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W, H, LVLS = 96, 48, 3
N_FRAMES = 24
CSRC = Path(act.__file__).resolve().parents[1] / "csrc" / "activate.cu"


def _config():
    cfg = make_config(W, H)
    return cfg.replace(
        tracker=cfg.tracker.__class__(pyr_levels=LVLS, max_iterations=(10, 20, 20)),
        ba=cfg.ba.__class__(max_frames=4, min_frames=3, max_points_per_frame=64,
                            max_immature_per_frame=128, desired_point_density=150.0,
                            desired_immature_density=100.0))


class Recorder:
    """Stands in for a loop handler: each record with the node call that
    handed it over."""

    def __init__(self):
        self.call = -1
        self.records = []

    def publish_keyframe(self, mkf):
        self.records.append((self.call, mkf))

    def join(self):
        pass

    def odometry_rows(self):
        return []


def _host(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _run(node, rec, frames):
    shells = []
    for i, f in enumerate(frames):
        rec.call = i
        shells.append(node.process(f["img0"], f["img1"], timestamp=0.1 * i))
    rec.call = len(frames)
    node.finish()
    return shells


@pytest.fixture(scope="module")
def runs():
    """The JAX node over the frames with its activation calls recorded,
    and the port's node over the same frames."""
    ds = SyntheticStereoDataset(n_frames=N_FRAMES, width=W, height=H, speed=0.2)
    frames = [ds.frame(i) for i in range(N_FRAMES)]
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LVLS)
    cfg = _config()
    rec = {"gate": [], "alloc": [], "activate": []}
    gate, alloc, activate = (fe_j._gate_compact_activate, fe_j._allocate_candidates,
                             fe_j.FrontEnd._activate_points)

    def gate_kept(*a):
        out = gate(*a)
        rec["gate"].append((_host(a[:12]), a[12:], _host(out)))
        return out

    def alloc_kept(*a):
        out = alloc(*a)
        rec["alloc"].append((_host(a[:5]), a[5], _host(out)))
        return out

    def activate_kept(self, *a):
        before = (_host(self.ba_state), _host(self.immatures), set(self.imm_slots),
                  self.current_min_act_dist)
        out = activate(self, *a)
        rec["activate"].append((before, a, _host(self.ba_state), _host(self.immatures)))
        return out

    fe_j._gate_compact_activate, fe_j._allocate_candidates = gate_kept, alloc_kept
    fe_j.FrontEnd._activate_points = activate_kept
    try:
        rec_j = Recorder()
        shells_j = _run(NodeJ(cfg, intr, intr, ds.t_cam1_cam0, loop_handler=rec_j), rec_j,
                        frames)
    finally:
        fe_j._gate_compact_activate, fe_j._allocate_candidates = gate, alloc
        fe_j.FrontEnd._activate_points = activate
    rec_t = Recorder()
    shells_t = _run(NodeT(port_cfg(cfg), intr, intr, ds.t_cam1_cam0, loop_handler=rec_t,
                          device="cpu"), rec_t, frames)
    return dict(frames=frames, intr=intr, t=ds.t_cam1_cam0, cfg=cfg, rec=rec,
                jax=(shells_j, rec_j.records), torch=(shells_t, rec_t.records))


def _port_gate(args, static, cfg):
    imm, dist, KRKi1, Kt1, mad, flagged, images, fv, T_cw, aff, calib, expo = args
    w2, h2, budget = static[1:]
    t = torch.as_tensor
    return act.gate_compact_activate(
        to_torch(imm), t(dist), KRKi1, Kt1, float(mad), flagged, t(images), t(fv), t(T_cw),
        torch.linalg.inv_ex(t(T_cw))[0], t(aff), t(calib), t(expo), port_cfg(cfg), w2, h2,
        budget)


@pytest.mark.parametrize("call", [0, 1, 2])
def test_gate_compact_activate_matches_jax(runs, call):
    """ok, lane and drop equal; accepted idepths within rel 1e-4 or 1e-5
    absolute."""
    assert len(runs["rec"]["gate"]) >= 3
    args, static, want = runs["rec"]["gate"][call]
    got = [x.numpy() for x in _port_gate(args, static, runs["cfg"])]
    ok_j, id_j, lane_j, drop_j = want
    np.testing.assert_array_equal(got[0], ok_j)
    np.testing.assert_array_equal(got[2], lane_j)
    np.testing.assert_array_equal(got[3], drop_j)
    assert ok_j.sum() > 0 and drop_j.sum() > 0
    np.testing.assert_array_equal(np.isfinite(got[1]), np.isfinite(id_j))
    # the accepted lanes' idepths, the ones that reach the pool (a rejected
    # lane's LM may run on a weak Hessian, where the order of the sums moves
    # the steps more)
    np.testing.assert_allclose(got[1][ok_j], id_j[ok_j], rtol=1e-4, atol=1e-5)


def _alloc_case(runs, case):
    """A recorded allocator call, or one whose pool rows are taken: every
    participating slot's own segment, or all rows but a few."""
    (ok, lane, drop, p_valid, participate), P, _ = runs["rec"]["alloc"][0]
    p_valid = p_valid.copy()
    if case == "own_segment_full":
        for s in np.nonzero(participate)[0]:
            p_valid[s * P:(s + 1) * P] = True
    elif case == "pool_full":
        p_valid[:] = True
        p_valid[np.arange(3, p_valid.shape[0], 41)] = False
    return ok, lane, drop, p_valid, participate, P


@pytest.mark.parametrize("case", ["recorded", "own_segment_full", "pool_full"])
def test_allocate_candidates_matches_jax(runs, case):
    ok, lane, drop, p_valid, participate, P = _alloc_case(runs, case)
    want = _host(fe_j._allocate_candidates(ok, lane, drop, p_valid, participate, P))
    got = act.allocate_candidates(torch.as_tensor(ok), torch.as_tensor(lane, dtype=torch.int64),
                                  torch.as_tensor(drop), torch.as_tensor(p_valid), participate, P)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    placed = want[5].sum()
    if case == "pool_full":
        assert placed == (~p_valid).sum() < ok[participate].sum()
    else:
        assert placed > 0


def _assert_pool_equal(got, want):
    for name in ("p_valid", "p_host", "p_u", "p_v", "p_color", "p_weight", "p_prior",
                 "p_res_good", "p_num_good", "p_last_res"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name),
                                      err_msg=name)
    for name in ("p_idepth", "p_idepth_zero"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_activate_points_matches_jax(runs):
    """One whole ``_activate_points`` call from the JAX front end's state:
    the pool's rows and the candidates' validity after the insertion."""
    calls = [c for c in runs["rec"]["activate"] if c[0][0].p_valid.sum() < c[2].p_valid.sum()]
    assert calls
    (st, imm, slots, mad), args, st_after, imm_after = calls[0]
    fe = FrontEndT(port_cfg(runs["cfg"]), runs["intr"], runs["intr"], runs["t"],
                   device="cpu")
    fe.ba_state, fe.immatures = to_torch(st), to_torch(imm)
    fe.imm_slots, fe.current_min_act_dist = set(slots), mad
    new_slot, T_cw_new, pre_views, flagged = args
    fe._activate_points(new_slot, T_cw_new, _host(pre_views), flagged)
    _assert_pool_equal(fe.ba_state, st_after)
    np.testing.assert_array_equal(fe.immatures.valid.numpy(), imm_after.valid)
    rest = [f for f in st._fields if not f.startswith("p_")]
    for name in rest:
        np.testing.assert_array_equal(getattr(fe.ba_state, name).numpy(), getattr(st, name),
                                      err_msg=name)


def test_deferred_tail_matches_jax(runs):
    """The same records handed over in the same calls, one call after the
    keyframe whose tail marginalized them; the same keyframes; positions
    within 1e-2 m."""
    (shells_j, recs_j), (shells_t, recs_t) = runs["jax"], runs["torch"]
    kf_j = [i for i, s in enumerate(shells_j) if s.is_kf]
    assert [i for i, s in enumerate(shells_t) if s.is_kf] == kf_j
    assert len(recs_j) >= 2
    assert [(c, m.kf_id) for c, m in recs_t] == [(c, m.kf_id) for c, m in recs_j]
    for call, _ in recs_j:
        assert call - 1 in kf_j
    for (_, mt), (_, mj) in zip(recs_t, recs_j):
        assert np.linalg.norm(mt.T_wc[:3, 3] - mj.T_wc[:3, 3]) < 1e-2
    est = np.stack([s.T_wc[:3, 3] for s in shells_t])
    ref = np.stack([s.T_wc[:3, 3] for s in shells_j])
    assert np.max(np.linalg.norm(est - ref, axis=1)) < 1e-2


def test_checkpoint_mid_deferral_resumes_bit_exact(runs, tmp_path):
    """Saved right after a keyframe, with its tail pending: the resumed
    front end gives the uninterrupted run's poses and marginalized records,
    bit for bit."""
    frames, intr, t = runs["frames"], runs["intr"], runs["t"]
    new = lambda: FrontEndT(port_cfg(runs["cfg"]), intr, intr, t, device="cpu")

    def feed(fe, lo, hi):
        return [fe.add_stereo_frame(f["img0"], f["img1"], i, 0.1 * i)
                for i, f in enumerate(frames[lo:hi], lo)]

    whole = new()
    shells = feed(whole, 0, N_FRAMES)
    whole.flush_pending()
    kfs = [i for i, s in enumerate(shells) if s.is_kf]
    stop = next(i for i in kfs if i >= N_FRAMES // 3) + 1
    first = new()
    feed(first, 0, stop)
    assert first._pending_finalize is not None
    ckpt_t.save_frontend(str(tmp_path / "mid"), first)
    resumed = ckpt_t.load_frontend(str(tmp_path / "mid"), new())
    later = feed(resumed, stop, N_FRAMES)
    resumed.flush_pending()
    for a, b in zip(later, shells[stop:]):
        np.testing.assert_array_equal(a.T_wc, b.T_wc)
        assert a.is_kf == b.is_kf
    got = first.marginalized_queue + resumed.marginalized_queue
    assert [m.kf_id for m in got] == [m.kf_id for m in whole.marginalized_queue]
    for a, b in zip(got, whole.marginalized_queue):
        np.testing.assert_array_equal(a.T_wc, b.T_wc)
        np.testing.assert_array_equal(a.pts_cam, b.pts_cam)


def _assert_views_of(st, views):
    """``views`` equal ``ba.current_views(st)`` on the valid slots and
    points (an invalid slot's pose and affine rows, and an invalid point's
    host, are left stale by design)."""
    T, aff, calib, frame_valid, frame_id, p_valid, p_host = to_host(ba_t.current_views(st))
    np.testing.assert_array_equal(views[3], frame_valid)
    np.testing.assert_array_equal(views[4], frame_id)
    np.testing.assert_array_equal(views[2], calib)
    np.testing.assert_array_equal(views[0][frame_valid], T[frame_valid])
    np.testing.assert_array_equal(views[1][frame_valid], aff[frame_valid])
    np.testing.assert_array_equal(views[5], p_valid)
    np.testing.assert_array_equal(views[6][p_valid], p_host[p_valid])


def test_views_cache_matches_the_state(runs, monkeypatch):
    """The host views cache, keyed to a state without a read (bundle 3's
    copy, the rescale's and the tail's patches), holds that state's
    ``ba.current_views``: checked at every keying of a run and after every
    frame."""
    sites = {"read": 0, "pose": 0, "tail": 0}
    real = FrontEndT._set_views

    def checked(self, st, views, pose=None, frames_out=(), points_out=None):
        real(self, st, views, pose, frames_out, points_out)
        site = ("pose" if pose is not None else
                "tail" if points_out is not None else "read")
        sites[site] += 1
        _assert_views_of(st, self._views_cache)

    monkeypatch.setattr(FrontEndT, "_set_views", checked)
    fe = FrontEndT(port_cfg(runs["cfg"]), runs["intr"], runs["intr"], runs["t"], device="cpu")
    for i, f in enumerate(runs["frames"]):
        fe.add_stereo_frame(f["img0"], f["img1"], i, 0.1 * i)
        _assert_views_of(fe.ba_state, fe._views_np())
    fe.flush_pending()
    _assert_views_of(fe.ba_state, fe._views_np())
    assert min(sites.values()) > 0, sites


def test_cpu_tensors_never_reach_the_kernels(runs, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_cuda, "call", refuse)
    monkeypatch.setattr(_cuda, "load_library", refuse)
    before = (act.gate_compact_activate_cuda.launches,
              act.allocate_insert_consume_cuda.launches)
    args, static, _ = runs["rec"]["gate"][0]
    ok, idepth, lane, drop = _port_gate(args, static, runs["cfg"])
    (st, imm, slots, _), a, _, _ = runs["rec"]["activate"][0]
    participate = np.zeros(ok.shape[0], bool)
    participate[list(slots)] = True
    act.allocate_insert_consume(to_torch(st), to_torch(imm), ok, idepth, lane, drop,
                                participate, runs["cfg"].ba.max_points_per_frame)
    assert (act.gate_compact_activate_cuda.launches,
            act.allocate_insert_consume_cuda.launches) == before


def _c_fields(struct: str):
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, CSRC.read_text(), re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = re.sub(r"\[.*?\]", "", line.split("//")[0]).strip().rstrip(";")
        if not decl:
            continue
        first, *rest = decl.split(",")
        names.append(first.split()[-1].lstrip("*"))
        names += [r.strip().lstrip("*") for r in rest]
    return names


@pytest.mark.parametrize("struct", ["GateParams", "AllocParams"])
def test_params_struct_matches_the_c_source(struct):
    cls = getattr(act, struct)
    assert [n for n, _ in cls._fields_] == _c_fields(struct)
