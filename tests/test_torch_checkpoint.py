"""Checkpoint / resume in the port (``runtime/checkpoint.py``), on the
CPU at the smoke size of test_torch_slice_e2e.py (96x48, 3 levels, 12
frames, stopped after frame 6):

- the port's resume is bit-exact, as tests/test_checkpoint.py holds the
  JAX package's (every later ``T_wc`` within 1e-6, the same keyframes),
  and the loaded tensors lie on the target front end's device with the
  port's dtypes;
- both packages write the same file format (the same keys, dtypes and
  shapes in the ``.npz``, the same JSON keys);
- a checkpoint the JAX package writes resumes in the port, which then
  continues as the JAX front end continues, and a checkpoint the port
  writes resumes in the JAX front end: the same keyframes and per-frame
  translation within 1e-2 m (the tolerance of test_torch_slice_e2e.py);
- the loop handler round-trips mid-stream (threaded, on the keyframe
  stream of test_loop_handler.py): frames, edges, the ring-key database,
  the cloud and the counters equal, and the resumed handler ends where
  the uninterrupted one does.
"""

import json

import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
from direct_stereo_slam_tpu.models.frontend import FrontEnd as FrontEndJ
from direct_stereo_slam_tpu.runtime import checkpoint as ckpt_j
from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu_torch.loop.handler import LoopHandler
from direct_stereo_slam_tpu_torch.models.frontend import FrontEnd as FrontEndT
from direct_stereo_slam_tpu_torch.runtime import checkpoint as ckpt_t
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax as port_cfg
from direct_stereo_slam_tpu_torch.utils.convert import to_torch
from test_torch_slice_e2e import LVLS, H, W, _config
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N_FRAMES, STOP = 12, 6


def _frontend(pkg, intr, t_stereo):
    if pkg == "torch":
        return FrontEndT(port_cfg(_config()), intr, intr, t_stereo, device="cpu")
    return FrontEndJ(_config(), intr, intr, t_stereo)


def _feed(fe, frames, start):
    for i, f in enumerate(frames[start:], start):
        fe.add_stereo_frame(f["img0"], f["img1"], i, 0.1 * i)
    return fe


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's front end over the 12 frames, checkpointed after
    frame 6 (the uninterrupted run goes on after the save)."""
    ds = SyntheticStereoDataset(n_frames=N_FRAMES, width=W, height=H, speed=0.2)
    frames = [ds.frame(i) for i in range(N_FRAMES)]
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LVLS)
    out = dict(frames=frames, intr=intr, t=ds.t_cam1_cam0)
    base = tmp_path_factory.mktemp("ckpt")
    for pkg, mod in (("jax", ckpt_j), ("torch", ckpt_t)):
        fe = _feed(_frontend(pkg, intr, ds.t_cam1_cam0), frames[:STOP], 0)
        path = str(base / pkg)
        mod.save_frontend(path, fe)
        out[pkg] = (_feed(fe, frames, STOP), path)
    return out


def _resume(runs, writer, loader):
    fe = _frontend(loader, runs["intr"], runs["t"])
    fe = {"jax": ckpt_j, "torch": ckpt_t}[loader].load_frontend(runs[writer][1], fe)
    return _feed(fe, runs["frames"], STOP)


def _state_tensors(*trees):
    for tree in trees:
        for v in tree:
            yield from (v if isinstance(v, tuple) else (v,))


def test_port_resume_is_bit_exact(runs):
    ref = runs["torch"][0]
    fe = _resume(runs, "torch", "torch")
    assert len(fe.all_frames) == len(ref.all_frames) == N_FRAMES
    for a, b in zip(ref.all_frames[STOP:], fe.all_frames[STOP:]):
        np.testing.assert_allclose(b.T_wc, a.T_wc, atol=1e-6)
    assert fe.num_kfs == ref.num_kfs
    assert [s.is_kf for s in fe.all_frames] == [s.is_kf for s in ref.all_frames]
    assert any(s.is_kf for s in ref.all_frames[STOP:])       # a keyframe after it
    assert vars(fe.scale_state) == vars(ref.scale_state) and fe.pot == ref.pot


def test_loaded_tensors_on_the_target_device(runs):
    """Every state tensor of a loaded front end lies on its device, with
    the dtype of the front end that wrote it (index fields int64 again)."""
    fresh = _frontend("torch", runs["intr"], runs["t"])
    fe = ckpt_t.load_frontend(runs["torch"][1], fresh)
    ref = runs["torch"][0]
    got = list(_state_tensors(fe.ba_state, fe.template, fe.immatures))
    want = list(_state_tensors(ref.ba_state, ref.template, ref.immatures))
    assert len(got) == len(want) > 20
    for g, w in zip(got, want):
        assert g.device == fe.device and g.dtype == w.dtype
    pyramids = list(_state_tensors(*fe.pyramids.values()))
    assert pyramids and all(p.device == fe.device and p.dtype == torch.float32
                            for p in pyramids)
    assert fe.ba_state.p_host.dtype == torch.int64
    assert fe.template_ref_aff.a.device == fe.device
    assert fe._views_cache is None and fe._track_imm_counts is None


def test_both_packages_write_one_format(runs):
    files = {}
    for pkg in ("jax", "torch"):
        with np.load(runs[pkg][1] + ".npz") as z:
            files[pkg] = {k: (z[k].dtype, z[k].shape) for k in z.files}
    assert files["torch"] == files["jax"]
    assert files["torch"]["ba.p_host"][0] == np.int32
    metas = [json.load(open(runs[pkg][1] + ".json")) for pkg in ("jax", "torch")]
    assert metas[0].keys() == metas[1].keys()
    assert [f.keys() for f in metas[0]["all_frames"]] == \
        [f.keys() for f in metas[1]["all_frames"]]


@pytest.mark.parametrize("writer,loader", [("jax", "torch"), ("torch", "jax")])
def test_checkpoints_resume_across_packages(runs, writer, loader):
    """Resumed in the other package, the run continues as the writer's
    own front end continues: the same keyframes, translations within
    1e-2 m on every later frame."""
    ref = runs[writer][0]
    fe = _resume(runs, writer, loader)
    assert fe.initialized and not fe.is_lost
    assert [s.is_kf for s in fe.all_frames] == [s.is_kf for s in ref.all_frames]
    t_ref = np.stack([np.asarray(s.T_wc)[:3, 3] for s in ref.all_frames[STOP:]])
    t_got = np.stack([np.asarray(s.T_wc)[:3, 3] for s in fe.all_frames[STOP:]])
    assert np.abs(t_got - t_ref).max() <= 1e-2, np.abs(t_got - t_ref).max(axis=1)
    assert fe.num_kfs == ref.num_kfs


def test_loop_handler_round_trip(tmp_path):
    """A threaded handler saved after the stream's first loop (keyframe
    31 of 39) and loaded into a fresh one: the state equals, and both go
    on to the same end."""
    from test_loop_handler import make_loop_stream

    cfg, intr, stream, _, _ = make_loop_stream()
    stream = [to_torch(m) for m in stream]
    cut = 31

    def handler():
        return LoopHandler(port_cfg(cfg), intr, threaded=True, device="cpu")

    a = handler()
    for mkf in stream[:cut]:
        a.publish_keyframe(mkf)
    path = str(tmp_path / "loop")
    ckpt_t.save_loop_handler(path, a)          # waits for the queue
    b = ckpt_t.load_loop_handler(path, handler())
    assert a.direct_loop_count + a.icp_loop_count >= 1
    assert (b.direct_loop_count, b.icp_loop_count, b.cur_id, b.db_to_frame) == \
        (a.direct_loop_count, a.icp_loop_count, a.cur_id, a.db_to_frame)
    assert len(b.frames) == len(a.frames) == cut
    for fa, fb in zip(a.frames, b.frames):
        assert (fb.kf_id, fb.incoming_id, fb.dso_error, fb.scale_error) == \
            (fa.kf_id, fa.incoming_id, fa.dso_error, fa.scale_error)
        np.testing.assert_array_equal(fb.T_wc, fa.T_wc)
        assert [e[0] for e in fb.edges] == [e[0] for e in fa.edges]
        for ea, eb in zip(fa.edges, fb.edges):
            np.testing.assert_array_equal(eb[1], ea[1])
            assert eb[2:] == ea[2:]
        for name in ("signature", "tfm_pca_rig", "pts_cam", "pts_colors", "pts_spherical"):
            x, y = getattr(fa, name), getattr(fb, name)
            assert (x is None) == (y is None) and (x is None or np.array_equal(x, y))
    np.testing.assert_array_equal(np.stack(b.ringkeys.db), np.stack(a.ringkeys.db))
    np.testing.assert_array_equal(np.stack(b.ringkeys.pending), np.stack(a.ringkeys.pending))
    np.testing.assert_array_equal(b.cloud.pts, a.cloud.pts)
    np.testing.assert_array_equal(b.cloud.ids, a.cloud.ids)
    assert b.cloud.id_pose_wc.keys() == a.cloud.id_pose_wc.keys()
    for h in (a, b):
        for mkf in stream[cut:]:
            h.publish_keyframe(mkf)
        h.close()
    assert (b.direct_loop_count, b.icp_loop_count) == (a.direct_loop_count, a.icp_loop_count)
    np.testing.assert_array_equal(np.asarray(b.optimized_rows()), np.asarray(a.optimized_rows()))
