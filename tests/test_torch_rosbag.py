"""The port's rosbag v2.0 reader, writer and stereo replay
(``direct_stereo_slam_tpu_torch/io/rosbag.py``, the reference's bag path,
main.cpp:320-345): the four cases of tests/test_rosbag.py on the port;
bags written by either package's writer are the same bytes and read the
same through either reader (topics, stamps, every pixel's bits); and a
replayed bag drives the port's SLAMNode on the CPU exactly as the same
uint8 frames fed from memory do (every pose bit-equal, the same
keyframes)."""

import struct

import numpy as np
import pytest

from direct_stereo_slam_tpu.io import rosbag as bag_j
from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu_torch.io.rosbag import (RosbagReader, _decode_image,
                                                    replay_stereo_bag, write_stereo_bag)
from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax as port_cfg
from test_torch_slice_e2e import LVLS, H, W, _config
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

pytestmark = pytest.mark.smoke

T0, T1 = "/cam0/image_raw", "/cam1/image_raw"


def _imgs(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (12, 16), np.uint8) for _ in range(n)]


def _stereo_msgs(n=3):
    left, right = _imgs(n, 0), _imgs(n, 1)
    msgs = []
    for i in range(n):
        msgs.append((T0, 10.0 + 0.1 * i, left[i]))
        msgs.append((T1, 10.0 + 0.1 * i + 0.004, right[i]))
    return msgs, left


@pytest.mark.parametrize("comp", ["none", "bz2"])
def test_roundtrip_both_compressions(tmp_path, comp):
    msgs, left = _stereo_msgs()
    path = str(tmp_path / f"t_{comp}.bag")
    write_stereo_bag(path, msgs, compression=comp)
    r = RosbagReader(path)
    assert r.topics() == {T0: "sensor_msgs/Image", T1: "sensor_msgs/Image"}
    out = list(r.images())
    assert len(out) == 6
    stamps = [m.stamp for _, m in out]
    assert stamps == sorted(stamps)
    for i in range(3):
        t0, m0 = out[2 * i]
        assert t0 == T0
        np.testing.assert_array_equal(m0.data, left[i].astype(np.float32))
        assert m0.stamp == pytest.approx(10.0 + 0.1 * i, abs=1e-6)


def test_replay_pairing_and_tolerance(tmp_path):
    """Latest-from-each pairing with the reference's 0.1 s stamp check:
    a pair violating the tolerance is dropped, not fired."""
    im = _imgs(1)[0]
    msgs = [(T0, 1.00, im), (T1, 1.01, im), (T0, 2.00, im), (T0, 3.00, im),
            (T1, 3.02, im), (T0, 4.00, im), (T1, 4.50, im), (T0, 5.00, im),
            (T1, 5.05, im)]
    path = str(tmp_path / "p.bag")
    write_stereo_bag(path, msgs)
    got = []
    n = replay_stereo_bag(path, T0, T1, lambda a, b: got.append((a.stamp, b.stamp)))
    assert n == 3
    assert got == [(pytest.approx(1.0), pytest.approx(1.01)),
                   (pytest.approx(3.0), pytest.approx(3.02)),
                   (pytest.approx(5.0), pytest.approx(5.05))]
    assert replay_stereo_bag(path, T0, T1, lambda a, b: None, max_pairs=2) == 2


def _wire(h, w, encoding, payload):
    fid = b"cam"
    step = {"rgb8": w * 3, "bgr8": w * 3, "mono16": w * 2}[encoding]
    return (struct.pack("<III", 0, 7, 500000000) + struct.pack("<I", len(fid)) + fid
            + struct.pack("<II", h, w) + struct.pack("<I", len(encoding))
            + encoding.encode() + b"\x00" + struct.pack("<I", step)
            + struct.pack("<I", len(payload)) + payload)


def test_color_and_16bit_decoding():
    """cv_bridge toCvShare(msg, 'mono8') conversions: rgb8/bgr8 luma,
    mono16 scaled by 1/256; the port's decode equals the JAX package's
    bit for bit."""
    rgb = np.zeros((2, 2, 3), np.uint8)
    rgb[..., 0], rgb[..., 1], rgb[..., 2] = 100, 50, 200
    m = _decode_image(_wire(2, 2, "rgb8", rgb.tobytes()))
    np.testing.assert_allclose(m.data, 0.299 * 100 + 0.587 * 50 + 0.114 * 200, atol=1e-4)
    assert m.stamp == pytest.approx(7.5)
    m2 = _decode_image(_wire(2, 2, "bgr8", rgb.tobytes()))
    np.testing.assert_allclose(m2.data, 0.299 * 200 + 0.587 * 50 + 0.114 * 100, atol=1e-4)
    u16 = np.full((2, 2), 512, "<u2")
    m3 = _decode_image(_wire(2, 2, "mono16", u16.tobytes()))
    np.testing.assert_allclose(m3.data, 2.0)
    for enc, payload in (("rgb8", rgb.tobytes()), ("bgr8", rgb.tobytes()),
                         ("mono16", u16.tobytes())):
        wire = _wire(2, 2, enc, payload)
        assert np.array_equal(_decode_image(wire).data, bag_j._decode_image(wire).data)
    with pytest.raises(ValueError, match="unsupported image encoding"):
        _decode_image(_wire(2, 2, "rgb8", rgb.tobytes()).replace(b"rgb8", b"rgba"))


@pytest.mark.parametrize("comp", ["none", "bz2"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_bags_cross_between_the_packages(tmp_path, comp, writer, reader):
    """A bag written by one package's writer is the other's bytes, and
    the other's reader gives the same topics, stamps and pixel bits."""
    msgs, _ = _stereo_msgs(4)
    write = {"jax": bag_j.write_stereo_bag, "torch": write_stereo_bag}
    read = {"jax": bag_j.RosbagReader, "torch": RosbagReader}
    paths = {}
    for name in ("jax", "torch"):
        paths[name] = str(tmp_path / f"{name}.bag")
        write[name](paths[name], msgs, compression=comp)
    assert open(paths["jax"], "rb").read() == open(paths["torch"], "rb").read()
    got = list(read[reader](paths[writer]).images())
    want = list(read[writer](paths[writer]).images())
    assert len(got) == len(want) == len(msgs)
    for (tg, mg), (tw, mw) in zip(got, want):
        assert tg == tw and mg.stamp == mw.stamp and mg.encoding == mw.encoding
        assert mg.data.dtype == mw.data.dtype and np.array_equal(mg.data, mw.data)


def _uint8_frames(n):
    ds = SyntheticStereoDataset(n_frames=n, width=W, height=H, speed=0.2)
    frames = []
    for i in range(n):
        f = ds.frame(i)
        frames.append(dict(img0=np.clip(np.asarray(f["img0"]), 0, 255).astype(np.uint8),
                           img1=np.clip(np.asarray(f["img1"]), 0, 255).astype(np.uint8),
                           timestamp=float(f["timestamp"])))
    return ds, frames


def _node(ds):
    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, LVLS)
    return SLAMNode(port_cfg(_config()), intr, intr, ds.t_cam1_cam0, device="cpu")


def test_replay_drives_slam_node_as_frames_in_memory(tmp_path):
    """A bz2 bag of the rendered uint8 frames drives the port's SLAMNode
    through the replay loop; every shell equals the one of the same frames
    fed from memory, bit for bit."""
    ds, frames = _uint8_frames(8)
    msgs = [m for f in frames for m in ((T0, f["timestamp"], f["img0"]),
                                        (T1, f["timestamp"], f["img1"]))]
    path = str(tmp_path / "drive.bag")
    write_stereo_bag(path, msgs, compression="bz2")

    node = _node(ds)
    replayed = []
    n = replay_stereo_bag(path, T0, T1, lambda a, b: replayed.append(
        node.process(a.data, b.data, a.stamp)))
    node.finish()
    assert n == len(frames) == len(replayed)
    assert node.frontend.initialized and not node.frontend.is_lost

    mem = _node(ds)
    fed = [mem.process(f["img0"], f["img1"], f["timestamp"]) for f in frames]
    mem.finish()
    assert [s.is_kf for s in replayed] == [s.is_kf for s in fed]
    assert sum(s.is_kf for s in fed) >= 2
    for a, b in zip(replayed, fed):
        assert a.timestamp == pytest.approx(b.timestamp, abs=1e-6)
        np.testing.assert_array_equal(a.T_wc, b.T_wc)
