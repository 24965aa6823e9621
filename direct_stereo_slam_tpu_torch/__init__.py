"""direct_stereo_slam_tpu_torch — the PyTorch / CUDA port of direct_stereo_slam_tpu.

The JAX package beside it is the reference: this package keeps its module
layout, function names, argument order and NamedTuple fields, so one test
adapter drives both. Plain functions on tensors; an explicit ``device`` is
threaded from ``runtime.node.SLAMNode`` down; no ``nn.Module`` (SLAM has no
weights) and no global RNG.

The device path's hand-written kernels are CUDA C++ for Hopper
(``csrc/``, built on first use into ``build/torch_kernels/``). Each kernel
wrapper launches its kernel for CUDA tensors and takes the plain PyTorch
version beside it only for CPU tensors.

Importing this package never imports ``jax``.
"""

__version__ = "0.1.0"
