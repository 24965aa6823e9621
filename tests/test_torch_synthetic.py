"""Parity of the port's synthetic stereo renderer with the JAX package:
the same numpy-seeded scene and trajectory render to the same frames
(float32 ray casts; intensities 0-255 within 1e-2, depths within rel
1e-5)."""

import numpy as np
import pytest

from direct_stereo_slam_tpu.io import synthetic as syn_j
from direct_stereo_slam_tpu_torch.io import synthetic as syn_t

pytestmark = pytest.mark.smoke


@pytest.mark.parametrize("trajectory", ["forward", "loop"])
def test_frames_match(trajectory):
    kw = dict(n_frames=12, width=64, height=32, trajectory=trajectory, speed=0.3)
    dj = syn_j.SyntheticStereoDataset(**kw)
    dt = syn_t.SyntheticStereoDataset(**kw)
    np.testing.assert_allclose(dt.poses, dj.poses, atol=1e-6)
    np.testing.assert_array_equal(dt.t_cam1_cam0, dj.t_cam1_cam0)
    np.testing.assert_array_equal(dt.K, dj.K)
    for i in (0, 7):
        fj, ft = dj.frame(i), dt.frame(i)
        assert set(ft) == set(fj)
        for key in ("img0", "img1"):
            assert ft[key].shape == fj[key].shape == (32, 64)
            np.testing.assert_allclose(ft[key], fj[key], atol=1e-2)
        np.testing.assert_allclose(ft["depth0"], fj["depth0"], rtol=1e-5)
        assert ft["timestamp"] == fj["timestamp"]
        assert ft["incoming_id"] == fj["incoming_id"] == i
