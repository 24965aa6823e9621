"""The device the port's entry points run on.

``SLAMNode``, ``FrontEnd``, ``LoopHandler``, ``runtime.eval.run_sequence``
and ``run_slam`` run on the CUDA card unless the caller names the CPU
(``device="cpu"``). Asking for the card on a host without one raises:
nothing carries on with the CPU in its place.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names a CUDA card
    that this host does not have."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for, but torch sees no CUDA card; "
            "pass device='cpu' to run on the CPU")
    return dev
