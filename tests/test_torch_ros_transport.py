"""The port's live ROS1 transport
(``direct_stereo_slam_tpu_torch/io/ros_transport.py``: MiniMaster, TCPROS
publisher and subscriber, the ApproximateTime stereo source) on loopback:
the four cases of tests/test_ros_transport.py (the live CLI as
``python -m direct_stereo_slam_tpu_torch.run_slam --ros-master ...
--device cpu``), a JAX-package publisher feeding the port's source, and
the port's deliberate difference from the reference: a failure of the
stereo callback or a malformed message is kept and raised by
``close()``, never printed and dropped."""

import os
import re
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from direct_stereo_slam_tpu.io import ros_transport as rt_j
from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
from direct_stereo_slam_tpu_torch.io.ros_transport import (
    ImagePublisher, ImageSubscriber, MiniMaster, StereoTopicSource)

pytestmark = pytest.mark.smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait_for(pred, timeout=10.0, step=0.02):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(step)
    return False


def test_pubsub_single_topic():
    master = MiniMaster()
    got = []
    sub = ImageSubscriber("/cam/image_raw", master.uri, got.append)
    pub = ImagePublisher("/cam/image_raw", master.uri)
    try:
        assert _wait_for(lambda: pub.connected), "subscriber never connected"
        rng = np.random.RandomState(0)
        imgs = [rng.randint(0, 255, (8, 10), np.uint8) for _ in range(4)]
        for i, im in enumerate(imgs):
            pub.publish(im, 5.0 + 0.1 * i)
        assert _wait_for(lambda: len(got) == 4), f"got {len(got)}/4"
        for i, msg in enumerate(got):
            assert msg.stamp == pytest.approx(5.0 + 0.1 * i, abs=1e-6)
            np.testing.assert_array_equal(msg.data, imgs[i].astype(np.float32))
    finally:
        sub.close(); pub.close(); master.close()


def test_subscriber_before_and_after_publisher():
    """publisherUpdate path: a subscriber registered BEFORE the publisher
    exists must connect when the master pushes the update."""
    master = MiniMaster()
    got = []
    sub = ImageSubscriber("/late/image", master.uri, got.append)
    time.sleep(0.05)
    pub = ImagePublisher("/late/image", master.uri)
    try:
        assert _wait_for(lambda: pub.connected), "no connection after update"
        pub.publish(np.zeros((4, 4), np.uint8), 1.0)
        assert _wait_for(lambda: len(got) == 1)
    finally:
        sub.close(); pub.close(); master.close()


@pytest.mark.parametrize("publisher", ["torch", "jax"])
def test_stereo_source_pairs_and_drives_sync(publisher):
    """Two live topics with offset stamps -> ApproximateTime pairs in
    order, mirroring the reference's message_filters configuration; the
    JAX package's publisher speaks to the port's source as well."""
    pub_cls = {"torch": ImagePublisher, "jax": rt_j.ImagePublisher}[publisher]
    master = MiniMaster()
    pairs = []
    src = StereoTopicSource(master.uri, "/cam0/image_raw", "/cam1/image_raw",
                            lambda a, b: pairs.append((a.stamp, b.stamp)))
    pub0 = pub_cls("/cam0/image_raw", master.uri, "/p0")
    pub1 = pub_cls("/cam1/image_raw", master.uri, "/p1")
    try:
        assert _wait_for(lambda: pub0._subs and pub1._subs)
        im = np.zeros((6, 6), np.uint8)
        for i in range(5):
            pub0.publish(im, 10.0 + 0.1 * i)
            pub1.publish(im, 10.0 + 0.1 * i + 0.01)   # 10 ms offset
        assert _wait_for(lambda: len(pairs) >= 4), f"paired {len(pairs)}"
        for t0, t1 in pairs:
            assert abs(t0 - t1) < 0.05
        stamps0 = [p[0] for p in pairs]
        assert stamps0 == sorted(stamps0)
    finally:
        src.close(); pub0.close(); pub1.close(); master.close()
    assert src.max_queue >= 1


def _stereo_session(callback, n=3):
    """A source fed n equal-stamp pairs; returns it and a closer."""
    master = MiniMaster()
    src = StereoTopicSource(master.uri, "/a", "/b", callback)
    pubs = [ImagePublisher("/a", master.uri, "/pa"), ImagePublisher("/b", master.uri, "/pb")]
    assert _wait_for(lambda: all(p.connected for p in pubs))
    for i in range(n):
        for p in pubs:
            p.publish(np.full((4, 4), i, np.uint8), 1.0 + 0.1 * i)

    def close_rest():
        for p in pubs:
            p.close()
        master.close()
    return src, close_rest


def test_failing_callback_is_raised_from_close():
    """The reference prints a callback's exception and goes on; the port
    keeps the first one, drains the rest without calling back, and
    close() raises it."""
    calls = []

    def callback(a, b):
        calls.append(a.stamp)
        raise ValueError("process failed")

    src, close_rest = _stereo_session(callback)
    try:
        assert _wait_for(lambda: src.failed)
        time.sleep(0.2)
        with pytest.raises(RuntimeError, match="callback failed") as info:
            src.close()
        assert isinstance(info.value.__cause__, ValueError)
        assert len(calls) == 1
    finally:
        close_rest()


def test_close_processes_queued_pairs():
    """No pair is dropped: close() returns after the pairs received before
    it went through the callback."""
    started, got = [], []

    def slow(a, b):
        started.append(a.stamp)
        time.sleep(0.2)
        got.append(a.stamp)

    src, close_rest = _stereo_session(slow, 5)
    try:
        assert _wait_for(lambda: len(started) + src._out.qsize() == 5)
        src.close()
        assert got == pytest.approx([1.0 + 0.1 * i for i in range(5)])
    finally:
        close_rest()


def test_malformed_message_is_not_dropped_silently():
    """A message the decoder refuses ends its connection and close()
    raises the decoder's error."""
    master = MiniMaster()
    got = []
    sub = ImageSubscriber("/bad", master.uri, got.append)
    pub = ImagePublisher("/bad", master.uri)
    try:
        assert _wait_for(lambda: pub.connected)
        data = rt_j.serialize_image(np.zeros((2, 2), np.uint8), 1.0)
        data = data.replace(b"mono8", b"mono9")        # unsupported encoding
        with pub._lock:
            for s in pub._subs:
                s.sendall(struct.pack("<I", len(data)) + data)
        assert _wait_for(lambda: sub.failed)
        assert not got
    finally:
        pub.close(); master.close()
    with pytest.raises(RuntimeError, match="subscriber of /bad failed") as info:
        sub.close()
    assert "unsupported image encoding" in str(info.value.__cause__)


def test_live_cli_end_to_end(tmp_path):
    """``run_slam --ros-master``: a live TCPROS session drives the port's
    whole pipeline on the CPU and writes the trajectories; every one of
    the 6 pairs went through ``process`` (the stage table's per_frame
    count)."""
    W, H = 96, 48
    ds = SyntheticStereoDataset(n_frames=6, width=W, height=H, speed=0.2)
    K = ds.K
    calib = tmp_path / "cam.txt"
    calib.write_text(f"Pinhole {K[0,0]} {K[1,1]} {K[0,2]} {K[1,2]} 0\n{W} {H}\nfull\n{W} {H}\n")
    master = MiniMaster()
    pub0 = ImagePublisher("/cam0/image_raw", master.uri, "/p0")
    pub1 = ImagePublisher("/cam1/image_raw", master.uri, "/p1")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "direct_stereo_slam_tpu_torch.run_slam",
         "--ros-master", master.uri, "--calib0", str(calib), "--device", "cpu",
         "--levels", "3", "--lidar-range", "-1", "--ros-idle", "3",
         "--out", str(tmp_path / "out")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        assert _wait_for(lambda: pub0.connected and pub1.connected, timeout=120), \
            "CLI never subscribed"
        for i in range(6):
            f = ds.frame(i)
            t = float(f["timestamp"])
            pub0.publish(np.clip(np.asarray(f["img0"]), 0, 255).astype(np.uint8), t)
            pub1.publish(np.clip(np.asarray(f["img1"]), 0, 255).astype(np.uint8), t)
            time.sleep(0.02)
        out = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, out[-3000:]
        assert (tmp_path / "out" / "sodso.txt").exists()
        m = re.search(r"per_frame: [\d.]+ms x (\d+)", out)
        assert m, f"no per_frame stats; CLI output:\n{out[-3000:]}"
        assert int(m.group(1)) == 6, out[-1500:]
        assert "6 stereo pairs received" in out
    finally:
        proc.kill()
        proc.wait()
        pub0.close(); pub1.close(); master.close()
