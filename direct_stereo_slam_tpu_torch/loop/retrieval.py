"""Two-stage place retrieval (port of loop/retrieval.py).

Ringkey k-nearest neighbours with an insertion lag of ``loop_margin``
frames (recent frames never match), then the Scan Context signature
difference over the candidates (``search_signatures``, shared with the
JAX package). Up to ``DEVICE_MIN`` entries the search is a numpy
broadcast; past it the database lives in a power-of-two-capacity f32
buffer on the database's device, and the search is one distance pass and
``torch.topk``. The reference's quirks stay: index 0 is never a candidate,
and a key enters the database ``loop_margin`` insertions after it came."""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np
import torch

from direct_stereo_slam_tpu.loop.retrieval import search_signatures  # noqa: F401

DEVICE_MIN = 4096


class RingkeyDatabase:
    def __init__(self, knn: int = 3, loop_margin: int = 100,
                 ringkey_thres: float = 0.1, device="cpu"):
        self.knn = knn
        self.loop_margin = loop_margin
        self.thres = ringkey_thres
        self.device = torch.device(device)
        self.db: List[np.ndarray] = []
        self.pending = deque()        # insertion lag queue
        self._buf = None              # device mirror [cap, D] (large DBs)

    def _search(self, ringkey: np.ndarray):
        """(d2, index) pairs of the k nearest database keys."""
        n = len(self.db)
        if n <= DEVICE_MIN:
            mat = np.stack(self.db)
            d2 = ((mat - ringkey[None, :]) ** 2).sum(axis=1)
            order = np.argsort(d2)[: self.knn]
            return [(float(d2[i]), int(i)) for i in order]
        cap = self._buf.shape[0] if self._buf is not None else 0
        if cap < n:
            cap = 1 << int(np.ceil(np.log2(max(n, DEVICE_MIN))))
            pad = np.zeros((cap, len(ringkey)), np.float32)
            pad[:n] = np.stack(self.db).astype(np.float32)
            self._buf = torch.as_tensor(pad, device=self.device)
        rk = torch.as_tensor(np.asarray(ringkey, np.float32), device=self.device)
        d2 = torch.sum((self._buf - rk[None, :]) ** 2, dim=1)
        d2 = torch.where(torch.arange(cap, device=self.device) < n, d2,
                         torch.full_like(d2, float("inf")))
        d2s, idxs = torch.topk(d2, self.knn, largest=False)
        return [(float(d), int(i)) for d, i in zip(d2s.tolist(), idxs.tolist())]

    def search_and_insert(self, ringkey: np.ndarray) -> List[int]:
        """Returns candidate indices (into the order of insertion calls,
        0-based), then enqueues ``ringkey`` with the ``loop_margin`` lag."""
        candidates: List[int] = []
        if len(self.db) > self.knn:
            for d2, i in self._search(ringkey):
                # reference quirk: index 0 is rejected by the
                # `idces[0][i] > 0` check (search_place.h:37)
                if d2 < self.thres and i > 0:
                    candidates.append(int(i))
        self.pending.append(ringkey.copy())
        if len(self.pending) > self.loop_margin:
            self.db.append(self.pending.popleft())
            n = len(self.db)
            if self._buf is not None and n <= self._buf.shape[0]:
                self._buf[n - 1] = torch.as_tensor(
                    np.asarray(self.db[-1], np.float32), device=self.device)
        return candidates
