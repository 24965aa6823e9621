"""How closely a resident LM kernel (K2-LM, K3-LM, K4-LM) follows a Python
LM loop.

Each LM iteration accepts or rejects its step by comparing two sums of
thousands of terms. Summed in another order, such a sum moves by ~3e-5
relative, which can decide a near-tie the other way and send a candidate
down another path to another end. The kernel, the loop over the per-pass
kernel and the loop over plain passes all sum in different orders, so
they need not agree on every candidate of a large batch.

How many candidates may differ is measured, not assumed: the reference
loops are also run on the same points in other lane orders (which changes
nothing but the order of their sums), and a candidate on which any two
reference runs disagree is order-sensitive. The kernel may disagree with
a reference loop on at most as many candidates as are order-sensitive,
every candidate the kernel gets wrong must be one of them, and the batch's
winner must be the same. ``check`` is used by ``chip_smoke.py`` and by the
card tests alike.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Sequence

import numpy as np
import torch


class Agreement(NamedTuple):
    """A kernel run against named reference runs."""

    differ: Dict[str, int]         # candidates differing from each reference
    outside: Dict[str, int]        # ... of which not order-sensitive
    max_abs_err: Dict[str, float]  # largest difference where they agree
    sensitive: int                 # order-sensitive candidates (the allowance)
    n: int                         # candidates in the batch

    @property
    def ok(self) -> bool:
        return all(d <= self.sensitive and self.outside[k] == 0
                   for k, d in self.differ.items())

    def __str__(self) -> str:
        return "; ".join(
            f"vs {k} {self.n - d}/{self.n} agree ({self.outside[k]} of the {d} "
            f"differing not order-sensitive), max abs err {self.max_abs_err[k]:.2e}"
            for k, d in self.differ.items()) + f"; order-sensitive {self.sensitive}/{self.n}"


def _host(r):
    """(values compared relatively [B, k], poses [B, 4, 4] or None, ok [B],
    lanes seen [B], inlier ratio [B] or None) of a tracker, scale or
    loop-estimator result. Tracker: the residual per level, seen where
    every level saw a point. Scale: the scale and the error, ok where the
    host's decision counts the guess (error > 0). Loop estimator: the pose
    error, seen where a point was an inlier."""
    if hasattr(r, "res_per_level"):                     # TrackResult
        res = r.res_per_level.cpu().numpy()
        return res, r.T.cpu().numpy(), r.ok.cpu().numpy(), np.isfinite(res).all(axis=1), None
    if hasattr(r, "scale"):                             # ScaleOptResult
        res = np.stack([r.scale.cpu().numpy(), r.error.cpu().numpy()], axis=1)
        return res, None, res[:, 1] > 0, np.ones(len(res), bool), None
    inl = r.inlier_ratio.cpu().numpy()                  # LoopPoseResult
    res = r.pose_error[:, None].cpu().numpy()
    return res, r.T.cpu().numpy(), r.ok.cpu().numpy(), inl > 0, inl


def agreement(got, want, tol: float = 1e-3):
    """Per candidate, whether two runs agree: the same ok, the same
    non-finite residuals, finite residuals (scale LM: scale and error)
    within ``tol`` relative, poses within ``tol`` per matrix entry where
    ``want``'s every level saw points (and for the loop estimator the
    inlier ratio within ``tol``). Returns (agree [B] bool, largest residual
    or pose-entry difference over the agreeing candidates)."""
    res_g, T_g, ok_g, _, inl_g = _host(got)
    res_w, T_w, ok_w, seen, inl_w = _host(want)
    fin = np.isfinite(res_w)
    with np.errstate(invalid="ignore"):
        d_res = np.where(fin, np.abs(res_g - res_w), 0.0)
        rel = d_res / np.maximum(np.abs(np.where(fin, res_w, 1.0)), 1e-6)
    dT = (np.zeros(len(res_w)) if T_w is None
          else np.where(seen, np.abs(T_g - T_w).max(axis=(1, 2)), 0.0))
    agree = ((ok_g == ok_w) & (np.isinf(res_g) == np.isinf(res_w)).all(axis=1)
             & (np.isnan(res_g) == np.isnan(res_w)).all(axis=1)
             & (rel.max(axis=1) <= tol) & (dT <= tol))
    if inl_w is not None:
        agree &= np.abs(inl_g - inl_w) <= tol * np.maximum(inl_w, 1.0)
    err = max(float(d_res.max(axis=1)[agree].max(initial=0.0)),
              float(dT[agree].max(initial=0.0)))
    return agree, err


def order_sensitive(runs: Sequence, tol: float = 1e-3) -> np.ndarray:
    """Candidates on which any two of ``runs`` (the same function, sums in
    different orders) disagree."""
    out = np.zeros(len(_host(runs[0])[0]), bool)
    for i in range(len(runs)):
        for j in range(i + 1, len(runs)):
            out |= ~agreement(runs[i], runs[j], tol)[0]
    return out


def check(got, references: Dict[str, object], reordered: List, tol: float = 1e-3
          ) -> Agreement:
    """Hold the kernel run ``got`` against each named reference run; the
    allowance is measured over the references and the ``reordered`` runs
    (the reference loops on the same points in other lane orders)."""
    sensitive = order_sensitive(list(references.values()) + list(reordered), tol)
    differ, outside, errs = {}, {}, {}
    for name, ref in references.items():
        agree, errs[name] = agreement(got, ref, tol)
        differ[name] = int((~agree).sum())
        outside[name] = int((~agree & ~sensitive).sum())
    return Agreement(differ, outside, errs, int(sensitive.sum()), len(sensitive))


ORDERS = 8


def _lane_orders(sizes: Sequence[int], seed: int = 0):
    """``ORDERS`` other lane orders for levels of ``sizes`` lanes: reversed,
    and seeded permutations."""
    gen = np.random.RandomState(seed)
    return [[np.arange(n)[::-1].copy() for n in sizes]] + [
        [gen.permutation(n) for n in sizes] for _ in range(ORDERS - 1)]


def reordered_track_runs(args, loops: Sequence[Callable]) -> List:
    """Each loop of ``loops`` over a template (called as
    ``track_candidates_batch_plain(*args)`` or
    ``optimize_scale_batch_plain(*args)``: the pyramid, then the template)
    on the template with every level's lanes in the other orders."""
    pyr, tmpl, *rest = args
    out = []
    for perms in _lane_orders([int(x.shape[0]) for x in tmpl.pu]):
        idx = [torch.as_tensor(p, device=tmpl.pu[0].device) for p in perms]
        t = tmpl._replace(**{f: tuple(x[i] for x, i in zip(getattr(tmpl, f), idx))
                             for f in ("pu", "pv", "pid", "pcolor", "pmask")})
        out += [loop(pyr, t, *rest) for loop in loops]
    return out


# the scale loops take the template as the tracker's do
reordered_scale_runs = reordered_track_runs


def reordered_seed_runs(args, loops: Sequence[Callable]) -> List:
    """Each loop-estimator loop of ``loops`` (called as
    ``estimate_seeds_plain(*args)``) on the points in the other orders."""
    pyr, *points, T, intr, cfg = args
    out = []
    for (perm,) in _lane_orders([int(points[0].shape[0])]):
        i = torch.as_tensor(perm, device=points[0].device)
        out += [loop(pyr, *(x[i].contiguous() for x in points), T, intr, cfg)
                for loop in loops]
    return out
