"""Scan Context descriptors, shared with the JAX package (pure numpy, no
jax; ``direct_stereo_slam_tpu/loop/__init__.py`` imports nothing)."""

from direct_stereo_slam_tpu.loop.scancontext import (  # noqa: F401
    ScanContextResult,
    align_points_pca,
    generate,
    signature_difference,
)
