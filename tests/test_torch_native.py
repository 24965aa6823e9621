"""The port's native host library (``csrc/native_io.cpp`` through
``io/native.py``) against the JAX package's (``native/dsslam_native.cpp``
through its ``io/native.py``), on the cases of ``tests/test_native.py``:
``read_pnm`` bit-equal on P5, P6 and 16-bit P5 files; ``undistort``
bit-equal (the same source and flags, so the same floats) on identity,
random and invalid maps with and without a LUT; the prefetching
``NativeStereoLoader`` yields the JAX loader's order, timestamps, ids and
pixels. Where the port differs on purpose: a pair that cannot be read,
or whose image is not an 8-bit P5 of the loader's input size, raises on
the consumer's side (the JAX loader queues zeros), after the pairs
before it."""

import os

import numpy as np
import pytest

from direct_stereo_slam_tpu.io import native as nat_j
from direct_stereo_slam_tpu_torch.io import native as nat_t

pytestmark = pytest.mark.smoke


def write_pnm(path, img, maxval=255):
    h, w = img.shape[:2]
    magic = b"P6" if img.ndim == 3 else b"P5"
    with open(path, "wb") as f:
        f.write(magic + f"\n# test comment\n{w} {h}\n{maxval}\n".encode())
        f.write(img.tobytes())
    return str(path)


@pytest.mark.parametrize("kind", ["P5", "P6", "P5-16"])
def test_read_pnm_bit_equal(tmp_path, kind):
    rng = np.random.RandomState(0)
    if kind == "P5":
        p = write_pnm(tmp_path / "a.pgm", rng.randint(0, 256, (48, 64), np.uint8))
    elif kind == "P6":
        p = write_pnm(tmp_path / "a.ppm", rng.randint(0, 256, (48, 64, 3), np.uint8))
    else:
        p = write_pnm(tmp_path / "a.pgm", rng.randint(0, 65536, (48, 64)).astype(">u2"), 65535)
    want, got = nat_j.read_pnm(p), nat_t.read_pnm(p)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_read_pnm_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        nat_t.read_pnm(str(tmp_path / "none.pgm"))


def _maps(kind, rng):
    ys, xs = np.mgrid[0:32, 0:48].astype(np.float32)
    if kind == "identity":
        return None, None
    if kind == "random":
        return (xs * 1.2 + 1.5 + rng.uniform(-0.4, 0.4, xs.shape).astype(np.float32),
                ys * 1.1 + 2.0 + rng.uniform(-0.4, 0.4, ys.shape).astype(np.float32))
    mx, my = xs * 1.2 + 1.5, ys * 1.1 + 2.0
    mx[::3, ::2] = -1.0                 # invalid: marked zero
    return mx, my


@pytest.mark.parametrize("kind", ["identity", "random", "invalid"])
@pytest.mark.parametrize("lut", [False, True])
def test_undistort_bit_equal(kind, lut):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (40, 60), np.uint8)
    mx, my = _maps(kind, rng)
    table = (np.arange(256, dtype=np.float32) * 0.9 + 3.0) ** 1.1 if lut else None
    want = nat_j.undistort(img, mx, my, lut=table, n_threads=2)
    got = nat_t.undistort(img, mx, my, lut=table, n_threads=3)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if kind == "invalid":
        assert (got[::3, ::2] == 0).all()


def _pairs(tmp_path, n, rng):
    files0, files1 = [], []
    for i in range(n):
        files0.append(write_pnm(tmp_path / f"l_{i}.pgm", rng.randint(0, 256, (32, 40), np.uint8)))
        files1.append(write_pnm(tmp_path / f"r_{i}.pgm", rng.randint(0, 256, (32, 40), np.uint8)))
    return files0, files1, [0.1 * i + 0.05 for i in range(n)]


@pytest.mark.parametrize("capacity,maps", [(3, False), (1, True)])
def test_stereo_loader_matches(tmp_path, capacity, maps):
    rng = np.random.RandomState(2)
    files0, files1, stamps = _pairs(tmp_path, 7, rng)
    kw = dict(in_size=(40, 32), out_size=(40, 32), capacity=capacity, n_threads=2)
    if maps:
        ys, xs = np.mgrid[0:32, 0:40].astype(np.float32)
        kw.update(map_x0=xs * 0.9 + 1.0, map_y0=ys * 0.95 + 0.5,
                  map_x1=xs * 0.8 + 2.0, map_y1=ys * 0.9 + 1.0,
                  lut0=np.linspace(0, 255, 256).astype(np.float32) ** 0.9,
                  lut1=np.linspace(5, 250, 256).astype(np.float32))
    lj = nat_j.NativeStereoLoader(files0, files1, stamps, **kw)
    want = list(lj)
    lj.close()
    with nat_t.NativeStereoLoader(files0, files1, stamps, **kw) as lt:
        got = list(lt)
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w) == ["img0", "img1", "incoming_id", "timestamp"]
        assert g["incoming_id"] == w["incoming_id"] == i
        assert g["timestamp"] == w["timestamp"] == pytest.approx(stamps[i])
        for k in ("img0", "img1"):
            np.testing.assert_array_equal(g[k], w[k])
    if not maps:
        np.testing.assert_array_equal(got[3]["img1"], nat_t.read_pnm(files1[3]).astype(np.float32))


def test_stereo_loader_raises_on_a_bad_pair(tmp_path):
    """A pair that cannot be read (here: a missing right image) raises
    once the pairs before it are consumed; close() joins the worker."""
    rng = np.random.RandomState(3)
    files0, files1, stamps = _pairs(tmp_path, 5, rng)
    os.remove(files1[3])
    lt = nat_t.NativeStereoLoader(files0, files1, stamps, in_size=(40, 32),
                                  out_size=(40, 32), capacity=2, n_threads=2)
    got = []
    with pytest.raises(IOError, match="pair 3"):
        for f in lt:
            got.append(f["incoming_id"])
    assert got == [0, 1, 2]
    lt.close()
    lt.close()


@pytest.mark.parametrize("bad", ["smaller", "larger", "colour", "16-bit", "no-height"])
def test_stereo_loader_raises_on_a_wrong_image(tmp_path, bad):
    """A pair whose image is not an 8-bit P5 of in_size, or whose header
    is malformed, raises after the pairs before it: no frame is made of
    the previous frame's bytes."""
    rng = np.random.RandomState(6)
    files0, files1, stamps = _pairs(tmp_path, 4, rng)
    path = tmp_path / "r_2.pgm"
    if bad == "smaller":
        write_pnm(path, rng.randint(0, 256, (30, 40), np.uint8))
    elif bad == "larger":
        write_pnm(path, rng.randint(0, 256, (32, 44), np.uint8))
    elif bad == "colour":
        write_pnm(path, rng.randint(0, 256, (32, 40, 3), np.uint8))
    elif bad == "16-bit":
        write_pnm(path, rng.randint(0, 65536, (32, 40)).astype(">u2"), 65535)
    else:
        path.write_bytes(b"P5\n40\n")
    lt = nat_t.NativeStereoLoader(files0, files1, stamps, in_size=(40, 32),
                                  out_size=(40, 32), capacity=1, n_threads=1)
    got = []
    with pytest.raises(IOError, match="pair 2"):
        for f in lt:
            got.append(f["incoming_id"])
    assert got == [0, 1]
    lt.close()


def test_stereo_loader_closes_early(tmp_path):
    """close() before the stream is consumed stops and joins the worker,
    which waits on a full queue."""
    rng = np.random.RandomState(4)
    files0, files1, stamps = _pairs(tmp_path, 6, rng)
    lt = nat_t.NativeStereoLoader(files0, files1, stamps, in_size=(40, 32),
                                  out_size=(40, 32), capacity=1, n_threads=1)
    assert next(iter(lt))["incoming_id"] == 0
    lt.close()


def test_loader_checks_its_inputs(tmp_path):
    """Sizes are checked before the worker gets a pointer: file lists and
    stamps of one length, maps of the output size, LUTs of 256 entries."""
    files0, files1, stamps = _pairs(tmp_path, 2, np.random.RandomState(5))
    kw = dict(in_size=(40, 32), out_size=(40, 32))
    with pytest.raises(ValueError, match="timestamps"):
        nat_t.NativeStereoLoader(files0, files1[:1], stamps, **kw)
    with pytest.raises(ValueError, match="maps"):
        nat_t.NativeStereoLoader(files0, files1, stamps, map_x0=np.zeros((4, 4), np.float32),
                                 map_y0=np.zeros((4, 4), np.float32), **kw)
    with pytest.raises(ValueError, match="256"):
        nat_t.NativeStereoLoader(files0, files1, stamps, lut0=np.zeros(255, np.float32), **kw)
    with pytest.raises(ValueError, match="256"):
        nat_t.undistort(np.zeros((8, 8), np.uint8), None, None, lut=np.zeros(10, np.float32))
