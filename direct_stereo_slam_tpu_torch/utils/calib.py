"""Calibration parsing, shared with the JAX package (pure numpy, no jax)."""

from direct_stereo_slam_tpu.utils.calib import *  # noqa: F401,F403
from direct_stereo_slam_tpu.utils.calib import (  # noqa: F401
    CameraModel,
    RectifiedCamera,
    build_rectified_camera,
    parse_camera_file,
    parse_gamma,
    parse_t_stereo,
    parse_vignette,
)
