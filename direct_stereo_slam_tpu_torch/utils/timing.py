"""Per-stage timing instrumentation (port of utils/timing.py).

Named vectors of wall-clock spans, averaged and printed at shutdown with
the reference's stage names. ``sync=True`` puts a device barrier
(``torch.cuda.synchronize``) at every span exit, so each stage's
wall-clock includes the device work it enqueued instead of letting it
drain inside whichever later stage reads a result first.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

import torch


def _device_barrier():
    """Block until all device work enqueued so far has completed."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def barrier_overhead_ms(n: int = 5) -> float:
    """Median cost of a back-to-back barrier: the per-span overhead of sync mode."""
    _device_barrier()
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        _device_barrier()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return 1000.0 * samples[len(samples) // 2]


class StageTimers:
    def __init__(self, sync: bool = False):
        self.times: Dict[str, List[float]] = defaultdict(list)
        self.sync = sync
        self._stack: List[str] = []

    @contextmanager
    def span(self, name: str):
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                _device_barrier()
            self.times[name].append(time.perf_counter() - t0)
            self._stack.pop()

    def add(self, name: str, seconds: float):
        self.times[name].append(seconds)

    def average_ms(self, name: str) -> float:
        v = self.times.get(name, [])
        return 1000.0 * sum(v) / len(v) if v else 0.0

    def count(self, name: str) -> int:
        return len(self.times.get(name, []))

    def report(self, names=None) -> str:
        names = names or sorted(self.times)
        return "\n".join(f"{n}: {self.average_ms(n):.2f}ms x {self.count(n)}"
                         for n in names)
