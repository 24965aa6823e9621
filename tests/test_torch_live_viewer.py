"""The port's observability (``viz/live.py``, ``viz/debug.py``,
``viz/png.py``): the two cases of tests/test_live_viewer.py on the port
(the viewer's hooks and page; the three debug dumps of a SLAMNode on the
CPU, here with the viewer on too), and pixel parity with the JAX
package: ``render_template_idepth`` of a template carried across by
``utils.convert`` equals the JAX package's image pixel for pixel, and
each of the three dump files, decoded with cv2, holds the pixels of the
JAX package's file written from the same inputs. The port's PNG
encoder round-trips through cv2 exactly."""

import dataclasses
import json
import os
import re
from types import SimpleNamespace

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu.models.depth_template import TrackerTemplate as TemplateJ
from direct_stereo_slam_tpu.ops.pyramid import Pyramid as PyramidJ
from direct_stereo_slam_tpu.viz import debug as debug_j
from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu_torch.utils.convert import to_torch
from direct_stereo_slam_tpu_torch.viz import debug as debug_t
from direct_stereo_slam_tpu_torch.viz.live import LiveViewer
from direct_stereo_slam_tpu_torch.viz.png import encode_png
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

pytestmark = pytest.mark.smoke

W, H = 96, 48


def _state(path):
    s = open(path).read()
    m = re.search(r"const S = (\{.*?\});\n", s, re.S)
    return json.loads(m.group(1))


def test_live_viewer_roundtrip(tmp_path):
    path = str(tmp_path / "live.html")
    v = LiveViewer(path)
    T = np.eye(4)
    for i in range(5):
        T = T.copy()
        T[0, 3] = 0.5 * i
        v.publish_cam_pose(T)
        v.publish_keyframe(i, T, np.random.RandomState(i).rand(300, 3))
    v.refresh_lidar_data(np.random.rand(50, 3), np.random.rand(40, 3))
    v.write()
    st = _state(path)
    assert len(st["trail"]) == 5 and len(st["kfs"]) == 5 and len(st["cloud"]) > 0
    assert len(st["scan_cur"]) == 50 and len(st["scan_matched"]) == 40

    # loop closure re-poses stored keyframe clouds (modifyKeyframePoseByKFID)
    before = dict((k[0], k[1:]) for k in st["kfs"])
    T2 = np.eye(4)
    T2[:3, 3] = [100.0, 0.0, 0.0]
    v.modify_keyframe_poses({i: T2 for i in range(5)}, loop_pair=(4, 0), n_direct=1, n_icp=0)
    st2 = _state(path)
    after = dict((k[0], k[1:]) for k in st2["kfs"])
    assert all(after[i][0] == 100.0 for i in range(5)) and after != before
    assert st2["loops"] == [[4, 0]] and st2["n_direct"] == 1
    assert max(p[0] for p in st2["cloud"]) > 90.0

    # the depth pane's PNG (the port's encoder) decodes to its pixels
    rgb = np.random.RandomState(3).randint(0, 256, (7, 9, 3)).astype(np.uint8)
    v.publish_depth_image(rgb)
    v.write()
    import base64
    png = base64.b64decode(_state(path)["depth_png"])
    got = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got[..., ::-1], rgb)


def test_debug_dumps_and_viewer_end_to_end(tmp_path):
    """Residual, idepth and window-stitch dumps appear when
    runtime.debug_dump_dir is set; with live_view_path set too the
    viewer's page holds every tracked frame's pose and a KF depth image."""
    from direct_stereo_slam_tpu.config import make_config
    from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
    from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode
    from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax

    W2, H2, LVLS = 192, 64, 3
    ds = SyntheticStereoDataset(n_frames=8, width=W2, height=H2, speed=0.3)
    cfg = make_config(W2, H2)
    cfg = cfg.replace(
        tracker=dataclasses.replace(cfg.tracker, pyr_levels=LVLS),
        ba=dataclasses.replace(
            cfg.ba, max_frames=4, min_frames=2, max_points_per_frame=64,
            max_immature_per_frame=256, desired_point_density=200.0,
            desired_immature_density=150.0),
        runtime=dataclasses.replace(
            cfg.runtime, debug_dump_dir=str(tmp_path / "dbg"),
            live_view_path=str(tmp_path / "live.html")),
    )
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W2, H2, LVLS)
    node = SLAMNode(config_from_jax(cfg), intr, intr, ds.t_cam1_cam0, device="cpu")
    shells = [node.process(f["img0"], f["img1"], f["timestamp"]) for f in ds]
    node.viewer.write()
    files = sorted(os.listdir(tmp_path / "dbg"))
    kfs = [i for i, s in enumerate(shells) if s.is_kf]
    assert any(f.endswith("_idepth.png") for f in files)
    assert any(f.endswith("_window.png") for f in files)
    residual = [int(f[6:11]) for f in files if f.endswith("_residual.png")]
    assert residual and not set(residual) & set(kfs)
    assert all(cv2.imread(str(tmp_path / "dbg" / f)) is not None for f in files)
    # every frame after the stereo initialisation, which completes no
    # tracked frame (as in the reference)
    st = _state(tmp_path / "live.html")
    assert len(st["trail"]) == len(shells) - 1 and st["depth_png"]


def _carried_inputs(seed=0, n=300):
    """A level-0 template and pyramid image of the JAX package from seeded
    numpy, and the same carried into the port by utils.convert."""
    rng = np.random.RandomState(seed)
    pu = rng.uniform(2, W - 3, n).astype(np.float32)
    pv = rng.uniform(2, H - 3, n).astype(np.float32)
    pid = rng.uniform(0.05, 0.6, n).astype(np.float32)
    pid[rng.rand(n) < 0.1] = 0.0
    col = rng.uniform(20, 230, n).astype(np.float32)
    mask = rng.rand(n) < 0.85
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    planes = np.stack([img, np.zeros_like(img), np.zeros_like(img)], -1)
    tj = TemplateJ(*[(jnp.asarray(a),) for a in (pu, pv, pid, col, mask)])
    pj = PyramidJ(data=(jnp.asarray(planes),), abs_grad=(jnp.asarray(img),))
    return tj, pj, to_torch(tj), to_torch(pj), img


def test_render_template_idepth_equals_the_reference():
    tj, pj, tt, pt, _ = _carried_inputs()
    want = debug_j.render_template_idepth(tj, pj)
    got = debug_t.render_template_idepth(tt, pt)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # without a pyramid the image is sized by the points
    np.testing.assert_array_equal(debug_t.render_template_idepth(tt, None),
                                  debug_j.render_template_idepth(tj, None))


def test_template_is_read_once_per_template(monkeypatch):
    """Two renders of one template pull its lists once; a new template
    (a new set of tensors) is pulled again."""
    pulls = []
    real = debug_t.to_host
    monkeypatch.setattr(debug_t, "to_host", lambda ts: pulls.append(len(ts)) or real(ts))
    _, _, tt, pt, img = _carried_inputs(1)
    a = debug_t.render_template_idepth(tt, pt)
    b = debug_t.render_template_idepth(tt, pt)
    np.testing.assert_array_equal(a, b)
    assert pulls == [6, 1]                          # lists + image, then the image
    tt2 = tt._replace(pid=tuple(p * 1.0 for p in tt.pid))
    debug_t.render_template_idepth(tt2, None)
    assert pulls == [6, 1, 5]


def _decode(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img


@pytest.mark.parametrize("image_kind", ["numpy", "tensor"])
def test_three_dumps_decode_to_the_reference_pixels(tmp_path, image_kind):
    tj, pj, tt, pt, img = _carried_inputs(2)
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    debug_j.dump_template_idepth(str(dj), 3, tj, pj)
    debug_t.dump_template_idepth(str(dt), 3, tt, pt)

    intr = make_pyramid_intrinsics(90.0, 90.0, W / 2 - 0.5, H / 2 - 0.5, W, H, 3)
    T = np.eye(4)
    T[:3, 3] = [0.02, -0.01, 0.05]
    T[:3, :3] = cv2.Rodrigues(np.array([0.01, -0.02, 0.005]))[0]
    new = np.clip(img + np.random.RandomState(5).normal(0, 4, img.shape), 0, 255
                  ).astype(np.float32)
    debug_j.dump_tracking_residual(str(dj), 7, new, tj, intr, T, 1.03, -2.5)
    debug_t.dump_tracking_residual(str(dt), 7, new if image_kind == "numpy"
                                   else torch.as_tensor(new), tt, intr, T, 1.03, -2.5)

    # the window stitch of three active slots, each hosting some points
    rng = np.random.RandomState(9)
    n = 200
    st = dict(p_u=rng.uniform(0, W - 1, n).astype(np.float32),
              p_v=rng.uniform(0, H - 1, n).astype(np.float32),
              p_idepth=rng.uniform(0.05, 0.6, n).astype(np.float32),
              p_valid=rng.rand(n) < 0.8, p_host=rng.randint(0, 4, n).astype(np.int32))
    imgs = {s: rng.uniform(0, 255, (H, W, 3)).astype(np.float32) for s in (0, 1, 3)}

    def frontend(arr, pyr, host_dtype):
        state = {k: arr(v) for k, v in st.items()}
        state["p_host"] = arr(st["p_host"].astype(host_dtype))
        return SimpleNamespace(
            ba_state=SimpleNamespace(**state), _active_slots=lambda: [3, 0, 1, 2],
            pyramids={s: pyr((im,), (im[..., 0],)) for s, im in imgs.items()})

    debug_j.dump_window_stitch(str(dj), 3, frontend(
        jnp.asarray, lambda d, g: PyramidJ(tuple(map(jnp.asarray, d)),
                                           tuple(map(jnp.asarray, g))), np.int32))
    debug_t.dump_window_stitch(str(dt), 3, frontend(
        torch.as_tensor, lambda d, g: to_torch(PyramidJ(d, g)), np.int64))

    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt)) == [
        "frame_00007_residual.png", "kf_00003_idepth.png", "kf_00003_window.png"]
    for name in names:
        np.testing.assert_array_equal(_decode(dt / name), _decode(dj / name))


@pytest.mark.parametrize("shape", [(5, 7, 3), (5, 7), (1, 1, 3), (64, 33)])
def test_png_encoder_round_trips_through_cv2(shape):
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    got = cv2.imdecode(np.frombuffer(encode_png(img), np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got[..., ::-1] if img.ndim == 3 else got, img)
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))
