"""Bag-like replay ingestion: timestamped, possibly-unsynced stereo
streams -> matched pairs.

The port's copy of the JAX package's ``io/sync.py``, pinned to it by
``tests/test_torch_host_copies.py``.

Host-side equivalent of the reference's ROS ingestion surface: rosbag
replay iterates messages of both image topics in time order and feeds a
``message_filters::ApproximateTime`` synchronizer whose callback is the
SLAM entry point (reference main.cpp:320-345; live mode main.cpp:355-362
uses the same policy with queue size 10). Here the same two roles are
explicit host-side objects with no middleware:

- ``ApproximateTimeSync``: an online two-stream matcher. Deterministic
  greedy algorithm with one-step lookahead per stream — emit the head
  pair unless the next message on either stream matches the other head
  strictly better, in which case the superseded head is dropped (it can
  never match anything later: stamps are monotonic per stream). This is
  the documented behavioral simplification of ROS's pivot-based
  ApproximateTime policy: both drop unmatched messages and emit
  monotonically increasing, non-reused pairs; ROS optimizes the pairing
  over a whole queue while this matches heads with lookahead, which is
  equivalent whenever stream rates are within ~2x of each other (the
  stereo-camera case).
- ``replay``: a rosbag-style merge of N (timestamp, payload) iterators
  into one time-ordered event stream (heap merge), pushed through the
  synchronizer, yielding synced pairs.

Unmatched or superseded frames are counted in ``dropped`` so ingestion
quality is observable, mirroring the silent drops of the ROS policy.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Any, Iterable, Iterator, List, Optional, Tuple


class ApproximateTimeSync:
    """Online approximate-time matcher for two monotonic streams.

    ``push(stream, t, data)`` ingests one message and returns a list of
    newly emitted pairs ``(t0, data0, t1, data1)`` (usually 0 or 1).
    ``slop`` is the maximum allowed stamp difference; ``queue_size``
    bounds per-stream buffering like the reference's sync queue
    (main.cpp:357-359, queue size 10).
    """

    def __init__(self, slop: float, queue_size: int = 10):
        if slop < 0:
            raise ValueError("slop must be >= 0")
        self.slop = float(slop)
        self.queue_size = int(queue_size)
        self._q: Tuple[deque, deque] = (deque(), deque())
        self._last_t = [None, None]   # per-stream monotonicity check
        self._last_emit: Optional[float] = None
        self.dropped = 0

    def push(self, stream: int, t: float, data: Any) -> List[Tuple]:
        if stream not in (0, 1):
            raise ValueError("stream must be 0 or 1")
        lt = self._last_t[stream]
        if lt is not None and t < lt:
            raise ValueError(
                f"non-monotonic timestamp on stream {stream}: {t} < {lt}")
        self._last_t[stream] = t
        q = self._q[stream]
        q.append((float(t), data))
        if len(q) > self.queue_size:
            q.popleft()
            self.dropped += 1
        return self._drain()

    def flush(self) -> List[Tuple]:
        """End of input: emit what still matches, count the rest dropped."""
        out = self._drain(at_end=True)
        self.dropped += len(self._q[0]) + len(self._q[1])
        self._q[0].clear()
        self._q[1].clear()
        return out

    # ------------------------------------------------------------------

    def _drain(self, at_end: bool = False) -> List[Tuple]:
        out: List[Tuple] = []
        qa, qb = self._q
        while qa and qb:
            ta, da = qa[0]
            tb, db = qb[0]
            gap = abs(ta - tb)
            if gap > self.slop:
                # the older head can never match (future stamps on the
                # other stream only grow)
                if ta < tb:
                    qa.popleft()
                else:
                    qb.popleft()
                self.dropped += 1
                continue
            # head pair is within slop; see if the NEXT message on the
            # earlier stream would match the other head strictly better.
            # Tie rule (deliberate, tested): a lookahead that only TIES the
            # current gap does NOT displace the head — strict `<` keeps the
            # earliest message, so pairing is deterministic and no message
            # is dropped without a strictly better partner. When ta == tb
            # both branches are eligible; stream A's lookahead is checked
            # first (fixed branch order), which is also deterministic.
            if ta <= tb and len(qa) > 1 and abs(qa[1][0] - tb) < gap:
                qa.popleft()
                self.dropped += 1
                continue
            if tb <= ta and len(qb) > 1 and abs(qb[1][0] - ta) < gap:
                qb.popleft()
                self.dropped += 1
                continue
            # a better partner could still ARRIVE for the later head —
            # only possible when the earlier stream's queue is exhausted
            # past the current head AND the gap is nonzero (a strictly
            # earlier head can be beaten by a not-yet-seen message);
            # wait for more input unless flushing
            if not at_end:
                if ta < tb and len(qa) == 1:
                    break
                if tb < ta and len(qb) == 1:
                    break
            qa.popleft()
            qb.popleft()
            self._last_emit = max(ta, tb)
            out.append((ta, da, tb, db))
        return out


def replay(
    streams: Iterable[Iterable[Tuple[float, Any]]],
    slop: float,
    queue_size: int = 10,
) -> Iterator[Tuple]:
    """Rosbag-style replay: merge per-stream (timestamp, payload)
    iterators in global time order (reference main.cpp:329-344 reads the
    bag view, which is time-sorted across topics) and yield synced pairs
    ``(t0, data0, t1, data1)`` from :class:`ApproximateTimeSync`.

    Exactly two streams are supported (stereo)."""
    streams = list(streams)
    if len(streams) != 2:
        raise ValueError("replay expects exactly two streams")
    sync = ApproximateTimeSync(slop, queue_size)

    def tagged(idx, it):
        for k, (t, data) in enumerate(it):
            # (t, tiebreak-by-stream, seq) keeps the heap merge stable
            yield (float(t), idx, k, data)

    merged = heapq.merge(*(tagged(i, s) for i, s in enumerate(streams)))
    for t, idx, _, data in merged:
        for pair in sync.push(idx, t, data):
            yield pair
    for pair in sync.flush():
        yield pair
