"""The device the port's entry points run on.

``SLAMNode``, ``FrontEnd``, ``LoopHandler``, ``runtime.eval.run_sequence``
and ``run_slam`` run on the CUDA card unless the caller names the CPU
(``device="cpu"``). Asking for the card on a host without one raises:
nothing carries on with the CPU in its place.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def to_device(a, device: torch.device) -> torch.Tensor:
    """A host array (or number) as a tensor on ``device``, its dtype kept.

    On the card the copy goes through pinned memory with
    ``non_blocking=True``: a copy from pageable memory makes PyTorch wait
    for the stream, that is for every kernel queued before it. PyTorch's
    caching host allocator keeps the pinned block until the copy that
    reads it has run. On the CPU the result is a copy of ``a``."""
    t = torch.from_numpy(np.array(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_host(tensors) -> tuple:
    """Host numpy copies of ``tensors`` (any dtypes and shapes, on one
    device) through one device-to-host copy: their bytes are packed into
    one uint8 tensor on the device, so the card is waited for once, not
    once per tensor."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(flat).cpu().numpy() if flat else np.zeros(0, np.uint8)
    out, off = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(host[off:off + n].view(dtype).reshape(t.shape).copy())
        off += n
    return tuple(out)


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names a CUDA card
    that this host does not have."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for, but torch sees no CUDA card; "
            "pass device='cpu' to run on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A small f32 constant on ``device``, made once per device and value:
    building it anew per call would copy it from pageable memory, a wait
    for the stream each time. Callers must not write to it."""
    return to_device(np.asarray(values, np.float32), device)
