"""Order-preserving fixed-size compaction (``jnp.nonzero(size=, fill_value=)``).

The reference keeps every shape static with ``jnp.nonzero(mask, size=B,
fill_value=f)``: the indices of the first B True entries in ascending
order, padded with ``f``. This is the same thing without a host sync:
each True entry's rank is its exclusive prefix count, and entries whose
rank is below B scatter their index to that slot. Ranks are unique, so
the scatter is deterministic.
"""

from __future__ import annotations

import torch


def nonzero_fixed(mask: torch.Tensor, size: int, fill_value: int = 0) -> torch.Tensor:
    """mask: [N] bool -> [size] int64 ascending indices of True entries,
    padded with ``fill_value`` (truncated when more than ``size``)."""
    flat = mask.reshape(-1)
    rank = torch.cumsum(flat.to(torch.int64), 0) - 1
    keep = flat & (rank < size)
    out = torch.full((size + 1,), fill_value, dtype=torch.int64, device=flat.device)
    dst = torch.where(keep, rank, torch.full_like(rank, size))
    src = torch.arange(flat.shape[0], device=flat.device)
    out.scatter_(0, dst, torch.where(keep, src, torch.full_like(src, fill_value)))
    return out[:size]
