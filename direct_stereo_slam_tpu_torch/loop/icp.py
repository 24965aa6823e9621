"""Point-to-point ICP, shared with the JAX package (pure numpy, no jax)."""

from direct_stereo_slam_tpu.loop.icp import icp  # noqa: F401
