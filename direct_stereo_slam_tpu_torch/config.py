"""Unified typed configuration, shared with the JAX package (pure Python
dataclasses, no jax; ``direct_stereo_slam_tpu/__init__.py`` imports
nothing, so loading it keeps jax out)."""

from direct_stereo_slam_tpu.config import *  # noqa: F401,F403
from direct_stereo_slam_tpu.config import (  # noqa: F401
    PATTERN_NUM,
    PATTERN_OFFSETS,
    PATTERN_PADDING,
    SCALE_A,
    SCALE_B,
    SCALE_C,
    SCALE_F,
    SCALE_IDEPTH,
    SCALE_XI_ROT,
    SCALE_XI_TRANS,
    SLAMConfig,
    make_config,
)
