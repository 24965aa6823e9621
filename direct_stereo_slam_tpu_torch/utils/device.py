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


_ALIGN = 256       # each uploaded array starts where cudaMalloc's would


def upload(arrays, device) -> tuple:
    """Host arrays (or numbers) as tensors on ``device``, their dtypes
    kept, through ONE pinned buffer and one ``non_blocking`` copy on the
    card: the arrays' bytes are packed into a pinned uint8 tensor (each at
    a 256-byte offset), copied, and viewed back. Nothing waits for the
    stream, and one copy replaces one per array. On the CPU each result is
    a copy of its array."""
    arrays = [np.array(a, order="C") for a in arrays]
    device = torch.device(device)
    if device.type != "cuda":
        return tuple(torch.from_numpy(a) for a in arrays)
    offs, n = [], 0
    for a in arrays:
        offs.append(n)
        n += -(-a.nbytes // _ALIGN) * _ALIGN
    host = torch.empty(max(n, 1), dtype=torch.uint8, pin_memory=True)
    hv = host.numpy()
    for a, off in zip(arrays, offs):
        hv[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    return tuple(dev[off:off + a.nbytes].view(torch.from_numpy(a.reshape(-1)[:0]).dtype)
                 .reshape(a.shape) for a, off in zip(arrays, offs))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a flat uint8 view (a copy where its layout is
    not plain: a one-element view of a wider row keeps its row's stride)."""
    x = t.reshape(-1)
    if x.numel() and x.stride(0) != 1:
        x = x.clone(memory_format=torch.contiguous_format)
    return x.view(torch.uint8)


class HostCopy:
    """A device-to-host copy of several tensors in flight: their bytes
    packed into one uint8 tensor, copied into pinned memory without
    waiting (on the card), then an event. ``ready()`` asks whether it has
    landed without waiting; ``wait()`` waits for it (only if it has not)
    and returns host numpy copies of the tensors. On the CPU the copy is
    made at once. ``buf``, a pinned uint8 tensor of an earlier copy whose
    result has been read, is reused when its size fits (``self.buf`` is
    the buffer the copy went into)."""

    def __init__(self, tensors, buf: torch.Tensor = None):
        self.meta = [(t.dtype, tuple(t.shape)) for t in tensors]
        flat = [_bytes(t) for t in tensors]
        on_card = bool(flat) and flat[0].device.type == "cuda"
        if on_card and len(flat) == 1:
            packed = flat[0]
        else:
            packed = torch.cat(flat) if flat else torch.zeros(0, dtype=torch.uint8)
        self.event = None
        if on_card:
            if buf is None or buf.shape != packed.shape:
                buf = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
            self.buf = buf
            self.buf.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.buf = packed

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> tuple:
        if not self.ready():
            self.event.synchronize()
        host = self.buf.numpy()
        out, off = [], 0
        for dtype, shape in self.meta:
            n = int(np.prod(shape, dtype=np.int64)) * torch.empty(0, dtype=dtype).element_size()
            np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
            out.append(host[off:off + n].view(np_dtype).reshape(shape).copy())
            off += n
        return tuple(out)


def to_host(tensors) -> tuple:
    """Host numpy copies of ``tensors`` (any dtypes and shapes, on one
    device) through one device-to-host copy: the card is waited for once,
    not once per tensor."""
    return HostCopy(tensors).wait()


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
