"""The port keeps its own copies of the JAX package's host modules
(``config``, ``utils/calib``, ``io/{dataset,sync,rosbag}``, the TCPROS
wire format of ``io/ros_transport``, ``loop/{scancontext,icp}``,
``retrieval.search_signatures``, ``viz/export``, the state of
``viz/live.LiveViewer`` and the numpy trajectories of ``io/synthetic``),
so that
it imports nothing of that package. These tests pin each copy to the
reference on the same seeded inputs, so the two cannot drift: configs
field by field, every other output exactly equal (numpy on both sides,
the same operations in the same order)."""

import dataclasses

import numpy as np
import pytest

from direct_stereo_slam_tpu import config as cfg_j
from direct_stereo_slam_tpu.io import dataset as ds_j
from direct_stereo_slam_tpu.io import ros_transport as ros_j
from direct_stereo_slam_tpu.io import rosbag as bag_j
from direct_stereo_slam_tpu.io import synthetic as syn_j
from direct_stereo_slam_tpu.io import sync as sync_j
from direct_stereo_slam_tpu.loop import icp as icp_j
from direct_stereo_slam_tpu.loop import retrieval as ret_j
from direct_stereo_slam_tpu.loop import scancontext as sc_j
from direct_stereo_slam_tpu.utils import calib as calib_j
from direct_stereo_slam_tpu_torch import config as cfg_t
from direct_stereo_slam_tpu.viz import export as export_j
from direct_stereo_slam_tpu.viz import live as live_j
from direct_stereo_slam_tpu_torch.io import dataset as ds_t
from direct_stereo_slam_tpu_torch.io import ros_transport as ros_t
from direct_stereo_slam_tpu_torch.io import rosbag as bag_t
from direct_stereo_slam_tpu_torch.io import synthetic as syn_t
from direct_stereo_slam_tpu_torch.io import sync as sync_t
from direct_stereo_slam_tpu_torch.loop import icp as icp_t
from direct_stereo_slam_tpu_torch.loop import retrieval as ret_t
from direct_stereo_slam_tpu_torch.loop import scancontext as sc_t
from direct_stereo_slam_tpu_torch.utils import calib as calib_t
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax
from direct_stereo_slam_tpu_torch.viz import export as export_t
from direct_stereo_slam_tpu_torch.viz import live as live_t

pytestmark = pytest.mark.smoke


def _tree(c):
    """A config as nested (class name, fields) pairs."""
    if dataclasses.is_dataclass(c):
        return (type(c).__name__,
                {f.name: _tree(getattr(c, f.name)) for f in dataclasses.fields(c)})
    return c


@pytest.mark.parametrize("size", [(96, 48), (256, 80), (320, 96), (320, 192),
                                  (616, 184), (1232, 368)])
@pytest.mark.parametrize("preset,mode", [(0, 0), (0, 1), (0, 2), (2, 1)])
def test_make_config_field_by_field(size, preset, mode):
    kw = dict(scale_opt_thres=12.0, lidar_range=35.0, scan_context_thres=0.3)
    for extra in ({}, kw):
        j = cfg_j.make_config(*size, preset=preset, mode=mode, **extra)
        t = cfg_t.make_config(*size, preset=preset, mode=mode, **extra)
        assert type(t) is cfg_t.SLAMConfig
        assert _tree(t) == _tree(j)
        assert config_from_jax(j) == t


def test_config_constants_and_defaults():
    names = [n for n in dir(cfg_j) if n.isupper()]
    assert names and names == [n for n in dir(cfg_t) if n.isupper()]
    for n in names:
        np.testing.assert_array_equal(np.asarray(getattr(cfg_t, n)),
                                      np.asarray(getattr(cfg_j, n)), err_msg=n)
    classes = [n for n in dir(cfg_j) if dataclasses.is_dataclass(getattr(cfg_j, n))]
    for n in classes:
        assert _tree(getattr(cfg_t, n)()) == _tree(getattr(cfg_j, n)()), n


CAMERAS = {
    "pinhole": "Pinhole 718.8560 718.8560 607.1928 185.2157 0\n1241 376\ncrop\n1232 368\n",
    "radtan": ("RadTan 0.5 0.8 0.5 0.5 -0.28 0.07 0.0002 0.00002\n640 480\n"
               "crop\n600 440\n"),
    "fov": "0.5 0.9 0.5 0.5 0.9\n320 240\nfull\n300 220\n",
    "explicit": "Pinhole 400 400 319.5 239.5 0\n640 480\n0.6 0.8 0.5 0.5 0\n320 240\n",
}


def _same(a, b):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    elif isinstance(a, tuple) and isinstance(b, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("kind", sorted(CAMERAS))
def test_calib_parsing(tmp_path, kind):
    path = tmp_path / "camera.txt"
    path.write_text(CAMERAS[kind])
    _same(calib_j.parse_camera_file(str(path)), calib_t.parse_camera_file(str(path)))
    _same(calib_j.build_rectified_camera(str(path)),
          calib_t.build_rectified_camera(str(path)))


def test_stereo_and_photometric_calib(tmp_path):
    rng = np.random.RandomState(0)
    T = np.eye(4)
    T[:3, 3] = rng.randn(3)
    vals = ",\n ".join(f"{v:.9f}" for v in T.reshape(-1))
    t_path = tmp_path / "T_stereo.yaml"
    t_path.write_text(f"T_stereo:\n  cols: 4\n  rows: 4\n  data: [{vals}]\n")
    np.testing.assert_array_equal(calib_t.parse_t_stereo(str(t_path)),
                                  calib_j.parse_t_stereo(str(t_path)))
    for n in (256, 1021):
        g_path = tmp_path / f"pcalib{n}.txt"
        g_path.write_text(" ".join(f"{v:.6f}" for v in np.cumsum(rng.rand(n))))
        np.testing.assert_array_equal(calib_t.parse_gamma(str(g_path)),
                                      calib_j.parse_gamma(str(g_path)))
    import cv2

    v_path = str(tmp_path / "vignette.png")
    cv2.imwrite(v_path, (rng.rand(48, 64) * 60000 + 100).astype(np.uint16))
    for size in ((None, None), (32, 24)):
        np.testing.assert_array_equal(calib_t.parse_vignette(v_path, *size),
                                      calib_j.parse_vignette(v_path, *size))


def _streams(seed):
    """Two stamp streams at ~10 Hz with jitter, drops and a late start."""
    rng = np.random.RandomState(seed)
    t0 = np.cumsum(rng.uniform(0.08, 0.12, 60))
    t1 = t0 + rng.uniform(-0.02, 0.02, 60)
    keep0, keep1 = rng.rand(60) > 0.1, rng.rand(60) > 0.1
    return ([(float(t), f"L{i}") for i, t in enumerate(t0) if keep0[i]],
            [(float(t), f"R{i}") for i, t in enumerate(t1[3:]) if keep1[i + 3]])


@pytest.mark.parametrize("seed,slop,queue", [(0, 0.01, 10), (1, 0.03, 10), (2, 0.015, 3)])
def test_sync_and_replay(seed, slop, queue):
    s0, s1 = _streams(seed)
    assert list(sync_t.replay([s0, s1], slop, queue)) == \
        list(sync_j.replay([s0, s1], slop, queue))
    a, b = sync_j.ApproximateTimeSync(slop, queue), sync_t.ApproximateTimeSync(slop, queue)
    events = sorted([(t, 0, d) for t, d in s0] + [(t, 1, d) for t, d in s1])
    for t, k, d in events:
        assert b.push(k, t, d) == a.push(k, t, d)
    assert b.flush() == a.flush() and b.dropped == a.dropped


def _write_pngs(root, n, rng):
    import cv2

    for cam in ("image_0", "image_1"):
        (root / cam).mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(root / cam / f"{i:06d}.png"),
                        rng.randint(0, 256, (24, 40)).astype(np.uint8))


def test_stereo_dir_datasets(tmp_path):
    rng = np.random.RandomState(3)
    _write_pngs(tmp_path, 5, rng)
    times = tmp_path / "times.txt"
    times.write_text("".join(f"{i} {0.1 * i:.3f} {10 + i}\n" for i in range(5)))
    stamps = [tmp_path / f"t{k}.txt" for k in (0, 1)]
    stamps[0].write_text("".join(f"{0.1 * i:.4f}\n" for i in range(5)))
    stamps[1].write_text("".join(f"{0.1 * i + 0.004:.4f}\n" for i in range(5)))
    d0, d1 = str(tmp_path / "image_0"), str(tmp_path / "image_1")
    pairs = [(ds_j.StereoDirDataset(d0, d1, str(times)),
              ds_t.StereoDirDataset(d0, d1, str(times))),
             (ds_j.StereoDirDataset(d0, d1, fps=20.0, pattern="*.png"),
              ds_t.StereoDirDataset(d0, d1, fps=20.0, pattern="*.png")),
             (ds_j.UnsyncedStereoDataset(d0, d1, *map(str, stamps), slop=0.01),
              ds_t.UnsyncedStereoDataset(d0, d1, *map(str, stamps), slop=0.01))]
    for j, t in pairs:
        assert len(t) == len(j) == 5
        for fj, ft in zip(j, t):
            assert sorted(ft) == sorted(fj)
            for k in fj:
                np.testing.assert_array_equal(np.asarray(ft[k]), np.asarray(fj[k]), err_msg=k)


def _pnm(path, kind, rng):
    """A seeded 8x10 image file: a colour P6, an 8-bit P5 or a 16-bit P5."""
    if kind == "P6":
        head, body = b"P6\n10 8\n255\n", rng.randint(0, 256, (8, 10, 3), np.uint8)
    elif kind == "P5":
        head, body = b"P5\n# a comment\n10 8\n255\n", rng.randint(0, 256, (8, 10), np.uint8)
    else:
        head, body = b"P5\n10 8\n65535\n", rng.randint(0, 65536, (8, 10)).astype(">u2")
    path.write_bytes(head + body.tobytes())
    return str(path)


@pytest.mark.parametrize("kind,ext", [("P6", ".ppm"), ("P5", ".pgm"), ("P5-16", ".pgm")])
def test_imread_gray_pnm(tmp_path, kind, ext):
    """PGM/PPM files are decoded by the native reader (colour channels
    averaged), as the JAX package decodes them, not by cv2: a colour P6
    read through cv2 differs by up to ~52 gray levels, a 16-bit P5 too."""
    path = _pnm(tmp_path / f"img{ext}", kind, np.random.RandomState(0))
    want = ds_j._imread_gray(path)
    got = ds_t._imread_gray(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (8, 10)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("laps,ease_in", [(1.25, 0), (2.5, 8)])
def test_stadium_trajectory(laps, ease_in):
    kw = dict(straight=12.0, radius=5.0, laps=laps, ease_in=ease_in)
    want = syn_j.stadium_trajectory(90, **kw)
    got = syn_t.stadium_trajectory(90, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape == (90, 4, 4)
    np.testing.assert_array_equal(got, want)
    rng = np.random.RandomState(4)
    x, z = rng.uniform(-10, 25, 200), rng.uniform(-10, 30, 200)
    np.testing.assert_array_equal(syn_t.dist_to_stadium_track(x, z, 12.0, 5.0),
                                  syn_j.dist_to_stadium_track(x, z, 12.0, 5.0))


def _cloud(rng, n=600):
    pts = rng.uniform(-30, 30, (n, 3))
    pts[:, 1] = rng.uniform(-2, 2, n)
    return pts


@pytest.mark.parametrize("binary", [True, False])
def test_scan_context(binary):
    rng = np.random.RandomState(4)
    clouds = [_cloud(rng) for _ in range(4)]
    res_j = [sc_j.generate(c, 40.0, binary=binary) for c in clouds]
    res_t = [sc_t.generate(c, 40.0, binary=binary) for c in clouds]
    for a, b in zip(res_j, res_t):
        for f in sc_j.ScanContextResult._fields:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
        for x, y in zip(sc_j.align_points_pca(clouds[0]), sc_t.align_points_pca(clouds[0])):
            np.testing.assert_array_equal(y, x)
    for a in range(4):
        for b in range(4):
            assert sc_t.signature_difference(res_t[a].signature, res_t[b].signature, 60) == \
                sc_j.signature_difference(res_j[a].signature, res_j[b].signature, 60)
    sigs = [r.signature for r in res_j]
    for cands in ([1, 2, 3], [3, 1], [2]):
        assert ret_t.search_signatures(sigs[0], sigs, cands, 60) == \
            ret_j.search_signatures(sigs[0], sigs, cands, 60)


@pytest.mark.parametrize("seed", [0, 1])
def test_icp(seed):
    rng = np.random.RandomState(seed)
    src = _cloud(rng, 500)
    ang = 0.05 * (seed + 1)
    T = np.eye(4)
    T[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
    T[:3, 3] = [0.3, -0.1, 0.5]
    tgt = src @ T[:3, :3].T + T[:3, 3] + 0.01 * rng.randn(*src.shape)
    for init in (np.eye(4), T):
        ok_j, T_j, fit_j = icp_j.icp(src, tgt, init)
        ok_t, T_t, fit_t = icp_t.icp(src, tgt, init)
        assert ok_t == ok_j
        np.testing.assert_array_equal(T_t, T_j)
        assert fit_t == fit_j


@pytest.mark.parametrize("seed", [0, 1])
def test_bag_records_and_image_wire_format(tmp_path, seed):
    """sensor_msgs/Image serialization, the bag's record and header
    fields, and whole bags (both compressions) are the same bytes; both
    parsers read them to the same fields."""
    rng = np.random.RandomState(seed)
    imgs = [rng.randint(0, 256, (rng.randint(1, 9), rng.randint(1, 13))).astype(np.uint8)
            for _ in range(4)]
    stamps = rng.uniform(0, 2e9, 4).tolist() + [0.0, 12.999999999]
    for img, t in zip(imgs * 2, stamps):
        assert bag_t.serialize_image(img, t, "cam_l") == bag_j.serialize_image(img, t, "cam_l")
    fields = [(b"op", bytes([bag_j.OP_MSG])), (b"conn", rng.bytes(4)), (b"time", rng.bytes(8))]
    data = rng.bytes(int(rng.randint(0, 40)))
    rec = bag_j._record(fields, data)
    assert bag_t._record(fields, data) == rec
    assert list(bag_t._iter_records(rec)) == list(bag_j._iter_records(rec))
    assert bag_t._parse_header(rec[4:4 + rec[0]]) == bag_j._parse_header(rec[4:4 + rec[0]])
    msgs = [(f"/cam{i % 2}/image_raw", 1.0 + 0.05 * i, imgs[i]) for i in range(4)]
    for comp in ("none", "bz2"):
        pj, pt = tmp_path / f"j{comp}.bag", tmp_path / f"t{comp}.bag"
        bag_j.write_stereo_bag(str(pj), msgs, compression=comp)
        bag_t.write_stereo_bag(str(pt), msgs, compression=comp)
        assert pt.read_bytes() == pj.read_bytes()
        rj, rt = bag_j.RosbagReader(str(pj)), bag_t.RosbagReader(str(pj))
        assert rt.connections == rj.connections and rt.topics() == rj.topics()
        assert list(rt.messages()) == list(rj.messages())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tcpros_connection_header(seed):
    """The TCPROS connection header: the same bytes for the same fields,
    and each side reads the other's back to the fields."""
    import socket

    rng = np.random.RandomState(seed)
    fields = {"callerid": f"/node{seed}", "topic": "/cam0/image_raw",
              "md5sum": ros_j.IMAGE_MD5, "type": ros_j.IMAGE_TYPE,
              "tcp_nodelay": str(int(rng.randint(0, 2))),
              f"x{rng.randint(100)}": "a=b=" + "c" * int(rng.randint(0, 50))}
    wire = ros_j._encode_header(fields)
    assert ros_t._encode_header(fields) == wire
    assert (ros_t.IMAGE_MD5, ros_t.IMAGE_TYPE) == (ros_j.IMAGE_MD5, ros_j.IMAGE_TYPE)
    for reader in (ros_t._read_header, ros_j._read_header):
        a, b = socket.socketpair()
        try:
            a.sendall(wire)
            assert reader(b) == fields
        finally:
            a.close()
            b.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_jet_and_depth_image(seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-0.3, 1.3, (9, 11)).astype(np.float32)
    np.testing.assert_array_equal(export_t._jet(x), export_j._jet(x))
    idepth = rng.uniform(0.05, 0.8, (24, 40)).astype(np.float32)
    idepth[rng.rand(24, 40) < 0.6] = 0.0
    img = rng.uniform(-10, 270, (24, 40)).astype(np.float32)
    for args in ((idepth,), (idepth, img), (np.zeros_like(idepth), img)):
        np.testing.assert_array_equal(export_t.depth_image_rgb(*args),
                                      export_j.depth_image_rgb(*args))


@pytest.mark.parametrize("seed", [0, 1])
def test_ate(seed):
    rng = np.random.RandomState(seed)
    gt = np.cumsum(rng.normal(0, 0.3, (50, 3)), axis=0)
    ang = rng.uniform(-0.3, 0.3)
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    est = gt @ R.T + rng.normal(0, 0.05, gt.shape) + [1.0, -0.5, 2.0]
    assert export_t.ate_rmse(est, gt) == export_j.ate_rmse(est, gt)
    assert export_t.ate_rmse_aligned(est, gt) == export_j.ate_rmse_aligned(est, gt)


def test_live_viewer_state_json(tmp_path):
    """The same hooks give the same page state (its clock aside)."""
    import json

    rng = np.random.RandomState(5)
    viewers = [mod.LiveViewer(str(tmp_path / f"{k}.html"), title="run")
               for k, mod in (("j", live_j), ("t", live_t))]
    Ts = [np.eye(4) for _ in range(6)]
    for i, T in enumerate(Ts):
        T[:3, 3] = rng.normal(0, 2, 3)
    pts = [rng.normal(0, 5, (int(rng.randint(1, 300)), 3)) for _ in Ts]
    scans = rng.normal(0, 9, (700, 3)), rng.normal(0, 9, (40, 3))
    for v in viewers:
        for i, T in enumerate(Ts):
            v.publish_cam_pose(T)
            v.publish_keyframe(i, T, pts[i])
        v.refresh_lidar_data(*scans)
        v.modify_keyframe_poses({i: T @ Ts[1] for i, T in enumerate(Ts[:4])},
                                loop_pair=(5, 1), n_direct=2, n_icp=1)
    states = [json.loads(v._state_json()) for v in viewers]
    for st in states:
        st.pop("time")
    assert states[1] == states[0]
