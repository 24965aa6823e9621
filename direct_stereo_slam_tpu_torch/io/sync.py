"""Approximate-time stereo synchronizer, shared with the JAX package."""

from direct_stereo_slam_tpu.io.sync import ApproximateTimeSync, replay  # noqa: F401
