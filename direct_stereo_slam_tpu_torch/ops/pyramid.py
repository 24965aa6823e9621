"""Image pyramid construction (port of ops/pyramid.py).

Per-level ``(I, dx, dy)`` planes: level 0 is the intensity image, level
``l`` the 2x2 mean of level ``l-1``; gradients are central differences
zeroed at the border; ``abs_grad`` is |grad|^2 for the pixel selector.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class Pyramid(NamedTuple):
    """``data[l]``: [H_l, W_l, 3] = (I, dx, dy); ``abs_grad[l]``: [H_l, W_l]."""

    data: Tuple[torch.Tensor, ...]
    abs_grad: Tuple[torch.Tensor, ...]

    @property
    def levels(self) -> int:
        return len(self.data)


def _gradients(img: torch.Tensor):
    """Central differences over the last two axes; border pixels get zero
    gradient."""
    xp = F.pad(img, (1, 1, 1, 1))
    dx = 0.5 * (xp[..., 1:-1, 2:] - xp[..., 1:-1, :-2])
    dy = 0.5 * (xp[..., 2:, 1:-1] - xp[..., :-2, 1:-1])
    dx[..., :, 0] = 0.0
    dx[..., :, -1] = 0.0
    dy[..., 0, :] = 0.0
    dy[..., -1, :] = 0.0
    return dx, dy


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool over the last two axes."""
    h2, w2 = img.shape[-2] // 2, img.shape[-1] // 2
    lead = img.shape[:-2]
    return img[..., : 2 * h2, : 2 * w2].reshape(*lead, h2, 2, w2, 2).mean(dim=(-3, -1))


def build_pyramid(image: torch.Tensor, levels: int) -> Pyramid:
    """image: [H, W] float32 intensity (0..255), or a stack [S, H, W] of
    them (the JAX package's ``vmap(build_pyramid)``: level l is then
    [S, H_l, W_l, 3], contiguous, sequence s's planes at s * H_l * W_l * 3).
    Returns ``levels`` levels."""
    data, abs_grad = [], []
    img = image
    for lvl in range(levels):
        if lvl > 0:
            img = _downsample2(img)
        dx, dy = _gradients(img)
        data.append(torch.stack([img, dx, dy], dim=-1))
        abs_grad.append(dx * dx + dy * dy)
    return Pyramid(tuple(data), tuple(abs_grad))
