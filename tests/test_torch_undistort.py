"""Undistortion in the port against the JAX package on the checked-in
real-format fixture (tests/fixtures/realformat: binary PGM frames, a DSO
RadTan camera.txt with crop, pcalib.txt gamma, a 16-bit vignette.png):
both ``Undistorter``s on the same raw frames, with and without gamma and
vignette, and through an identity camera (no remap), agree within 1e-3
gray levels. Then the port's entry point runs over the fixture's 3
frames from the image folders (``--dir0/--dir1`` with the calibration
files, on the CPU), and ``runtime/eval.run_sequence`` through both
undistorters."""

import os

import numpy as np
import pytest

from direct_stereo_slam_tpu.io.undistort import Undistorter as UndistorterJ
from direct_stereo_slam_tpu.utils import calib as calib_j
from direct_stereo_slam_tpu_torch import run_slam
from direct_stereo_slam_tpu_torch.io.dataset import StereoDirDataset
from direct_stereo_slam_tpu_torch.io.undistort import Undistorter as UndistorterT
from direct_stereo_slam_tpu_torch.utils import calib as calib_t
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "realformat")
TOL = 1e-3


def _fixture(name):
    return os.path.join(FIX, name)


@pytest.fixture(scope="module")
def raw_frames():
    ds = StereoDirDataset(_fixture("image_0"), _fixture("image_1"))
    return [ds.frame(i)[k] for i in range(len(ds)) for k in ("img0", "img1")]


@pytest.mark.parametrize("gamma,vignette", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_undistorter_like_the_reference(raw_frames, gamma, vignette):
    und = {}
    for name, calib, cls, kw in (("jax", calib_j, UndistorterJ, {}),
                                 ("torch", calib_t, UndistorterT, {"device": "cpu"})):
        cam = calib.build_rectified_camera(_fixture("camera.txt"))
        binv = calib.parse_gamma(_fixture("pcalib.txt")) if gamma else None
        vig = calib.parse_vignette(_fixture("vignette.png")) if vignette else None
        und[name] = cls(cam, binv=binv, vignette=vig, **kw)
    assert und["torch"].has_remap
    for raw in raw_frames:
        want = np.asarray(und["jax"](raw))
        got = und["torch"](raw)
        assert tuple(got.shape) == want.shape == (und["torch"].cam.h, und["torch"].cam.w)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
        # uint8 input (a decoder's own type) takes the same path
        np.testing.assert_allclose(und["torch"](raw.astype(np.uint8)).numpy(), want,
                                   rtol=0, atol=TOL)


def test_identity_camera_skips_the_remap(tmp_path, raw_frames):
    """A pinhole camera at its own size has no remap grids: only the
    photometric part runs."""
    path = tmp_path / "pinhole.txt"
    path.write_text("Pinhole 280 280 159.5 119.5 0\n320 240\nfull\n320 240\n")
    binv = calib_t.parse_gamma(_fixture("pcalib.txt"))
    ut = UndistorterT(calib_t.build_rectified_camera(str(path)), binv=binv, device="cpu")
    uj = UndistorterJ(calib_j.build_rectified_camera(str(path)), binv=binv)
    assert not ut.has_remap
    np.testing.assert_allclose(ut(raw_frames[0]).numpy(), np.asarray(uj(raw_frames[0])),
                               rtol=0, atol=TOL)


def test_run_slam_on_image_folders(tmp_path, capsys):
    out = tmp_path / "out"
    rc = run_slam.main([
        "--dir0", _fixture("image_0"), "--dir1", _fixture("image_1"),
        "--calib0", _fixture("camera.txt"), "--gamma0", _fixture("pcalib.txt"),
        "--vignette0", _fixture("vignette.png"), "--t-stereo", _fixture("T_stereo.yaml"),
        "--levels", "4", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    assert "loop_count:" in capsys.readouterr().out
    for name in ("sodso.txt", "dslam.txt"):
        assert (out / name).exists()


def test_image_folders_need_a_camera_file(tmp_path):
    with pytest.raises(SystemExit):
        run_slam.main(["--dir0", _fixture("image_0"), "--dir1", _fixture("image_1"),
                       "--device", "cpu", "--out", str(tmp_path)])


def test_run_sequence_through_the_undistorters():
    """runtime/eval.run_sequence over the fixture's raw frames with both
    undistorters: the node sees the rectified size."""
    from direct_stereo_slam_tpu_torch.config import make_config
    from direct_stereo_slam_tpu_torch.runtime.eval import run_sequence

    cam = calib_t.build_rectified_camera(_fixture("camera.txt"))
    und = UndistorterT(cam, binv=calib_t.parse_gamma(_fixture("pcalib.txt")), device="cpu")
    ds = StereoDirDataset(_fixture("image_0"), _fixture("image_1"))
    node, _, _ = run_sequence(ds, make_config(cam.w, cam.h), cam.K,
                              calib_t.parse_t_stereo(_fixture("T_stereo.yaml")),
                              undistorter0=und, undistorter1=und, levels=4,
                              threaded_loop=False, device="cpu")
    assert node.incoming_id == len(ds) == 3
    assert (node.intr0.w[0], node.intr0.h[0]) == (cam.w, cam.h)
