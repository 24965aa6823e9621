"""Dataset readers, shared with the JAX package (pure numpy, no jax)."""

from direct_stereo_slam_tpu.io.dataset import (  # noqa: F401
    KittiOdometryDataset,
    StereoDirDataset,
    UnsyncedStereoDataset,
)
