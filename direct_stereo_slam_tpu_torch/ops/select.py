"""Gradient-histogram pixel selector (port of ops/select.py).

Per-32x32-block gradient thresholds from a quantile plus an offset, 3x3
smoothing, then per-potential-block winners at three pyramid scales with
per-level gradient down-weighting. Output: a dense [H, W] int8 map with
values {0, 1, 2, 4} and the selected count. ``adapt_potential`` is DSO's
density feedback between keyframes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import SLAMConfig


def _block_quantile(x: torch.Tensor, bs: int, q: float) -> torch.Tensor:
    """Per-(bs x bs)-block quantile of x [H, W] -> [H/bs, W/bs] (NaN-padded
    up; linear interpolation, like jnp.nanquantile)."""
    H, W = x.shape
    Hp = (H + bs - 1) // bs * bs
    Wp = (W + bs - 1) // bs * bs
    xp = torch.full((Hp, Wp), float("nan"), dtype=x.dtype, device=x.device)
    xp[:H, :W] = x
    blocks = xp.reshape(Hp // bs, bs, Wp // bs, bs).permute(0, 2, 1, 3)
    blocks = blocks.reshape(Hp // bs, Wp // bs, bs * bs)
    return torch.nanquantile(blocks, q, dim=-1, interpolation="linear")


def _smooth3(x: torch.Tensor) -> torch.Tensor:
    """3x3 mean smoothing with edge clamping."""
    xp = F.pad(x[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    out = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            out = out + xp[dy: dy + x.shape[0], dx: dx + x.shape[1]]
    return out / 9.0


def _block_max_mask(score: torch.Tensor, p: int) -> torch.Tensor:
    """Mask of the argmax of each p x p block (first in row-major order on
    ties); blocks whose max is <= 0 select nothing."""
    H, W = score.shape
    Hp = (H + p - 1) // p * p
    Wp = (W + p - 1) // p * p
    sp = torch.full((Hp, Wp), float("-inf"), dtype=score.dtype, device=score.device)
    sp[:H, :W] = score
    blocks = sp.reshape(Hp // p, p, Wp // p, p).permute(0, 2, 1, 3).reshape(
        Hp // p, Wp // p, p * p)
    mx, am = torch.max(blocks, dim=-1)
    iota = torch.arange(p * p, device=score.device)
    sel = (iota == am[..., None]) & (mx[..., None] > 0)
    sel = sel.reshape(Hp // p, Wp // p, p, p).permute(0, 2, 1, 3).reshape(Hp, Wp)
    return sel[:H, :W]


def _block_any(mask: torch.Tensor, p: int) -> torch.Tensor:
    """True everywhere in any p x p block that contains a True."""
    H, W = mask.shape
    Hp = (H + p - 1) // p * p
    Wp = (W + p - 1) // p * p
    mp = torch.zeros((Hp, Wp), dtype=torch.bool, device=mask.device)
    mp[:H, :W] = mask
    blocks = mp.reshape(Hp // p, p, Wp // p, p).any(dim=3).any(dim=1)
    out = blocks.repeat_interleave(p, dim=0).repeat_interleave(p, dim=1)
    return out[:H, :W]


def make_selection_map(abs_grad0: torch.Tensor, abs_grad1: torch.Tensor,
                       abs_grad2: torch.Tensor, pot: int, cfg: SLAMConfig):
    """Returns (selection map [H, W] int8 with {0,1,2,4}, count)."""
    sc = cfg.selector
    H, W = abs_grad0.shape
    dev = abs_grad0.device

    g0 = torch.sqrt(abs_grad0)
    ths = _block_quantile(g0, sc.block_size, sc.min_grad_hist_cut) + sc.min_grad_hist_add
    ths = _smooth3(ths)
    by = torch.clamp(torch.arange(H, device=dev) // sc.block_size, max=ths.shape[0] - 1)
    bx = torch.clamp(torch.arange(W, device=dev) // sc.block_size, max=ths.shape[1] - 1)
    th_pix = ths[by][:, bx]

    dw1 = sc.grad_down_weight_per_level
    dw2 = dw1 * dw1
    zero = lambda x: torch.zeros_like(x)

    score0 = torch.where(g0 > th_pix, abs_grad0, zero(abs_grad0))
    sel0 = _block_max_mask(score0, pot)

    g1 = torch.sqrt(abs_grad1)
    th1 = (th_pix * dw1)[::2, ::2][: g1.shape[0], : g1.shape[1]]
    score1 = torch.where(g1 > th1, abs_grad1, zero(abs_grad1))
    sel1_half = _block_max_mask(score1, pot)
    sel1 = torch.zeros((H, W), dtype=torch.bool, device=dev)
    sel1[0: 2 * g1.shape[0]: 2, 0: 2 * g1.shape[1]: 2] = sel1_half
    sel1 = sel1 & ~_block_any(sel0, 2 * pot)

    g2 = torch.sqrt(abs_grad2)
    th2 = (th_pix * dw2)[::4, ::4][: g2.shape[0], : g2.shape[1]]
    score2 = torch.where(g2 > th2, abs_grad2, zero(abs_grad2))
    sel2_q = _block_max_mask(score2, pot)
    sel2 = torch.zeros((H, W), dtype=torch.bool, device=dev)
    sel2[0: 4 * g2.shape[0]: 4, 0: 4 * g2.shape[1]: 4] = sel2_q
    sel2 = sel2 & ~_block_any(sel0 | sel1, 4 * pot)

    out = (sel0.to(torch.int8) + 2 * (sel1 & ~sel0).to(torch.int8)
           + 4 * (sel2 & ~sel0 & ~sel1).to(torch.int8))
    count = torch.sum((out > 0).to(torch.int32))
    return out, count


def adapt_potential(pot: int, got: int, want: float) -> int:
    """DSO's density feedback: too few points -> smaller potential."""
    if got < 0.25 * want:
        pot = max(pot - 2, 1)
    elif got < 0.8 * want:
        pot = max(pot - 1, 1)
    elif got > 4.0 * want:
        pot = pot + 2
    elif got > 1.25 * want:
        pot = pot + 1
    return min(pot, 16)
