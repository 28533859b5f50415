"""The arrival queue: issued client updates ordered by arrival step.

Port of ``commefficient_tpu/asyncfed/queue.py``. A min-heap on
``(arrive_at, issue_seq)``: pops come out in arrival order, and
clients arriving at the same step in issue order. That tiebreak makes
the punctual case exact: with every delay 0 and a buffer the size of
the cohort, ``pop_arrived`` returns the issued batch slot for slot.
"""

from __future__ import annotations

import heapq
from typing import Any, List, Optional


class ArrivalQueue:
    """Priority queue of issued updates, FIFO within an arrival step."""

    def __init__(self):
        self._heap: list = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, arrive_at: int, entry: Any) -> None:
        heapq.heappush(self._heap, (int(arrive_at), self._seq, entry))
        self._seq += 1

    def pop_arrived(self, now: int, limit: int) -> List[Any]:
        """Up to ``limit`` entries with ``arrive_at <= now``, in
        (arrival, issue) order. Entries still in flight stay queued."""
        out: List[Any] = []
        while self._heap and len(out) < limit \
                and self._heap[0][0] <= now:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def peek_arrived(self, now: int,
                     limit: Optional[int] = None) -> List[Any]:
        """The entries ``pop_arrived(now, limit)`` would return, without
        consuming them."""
        out: List[Any] = []
        for t, _, e in sorted(self._heap, key=lambda x: (x[0], x[1])):
            if t > now or (limit is not None and len(out) >= limit):
                break
            out.append(e)
        return out

    def snapshot(self):
        """``(entries, next_seq)``: every queued ``(arrive_at, seq,
        entry)`` in (arrival, issue) order and the running sequence
        counter, the checkpointable view of the backlog."""
        return (sorted(self._heap, key=lambda t: (t[0], t[1])),
                self._seq)

    def restore(self, entries, next_seq: int) -> None:
        """Inverse of ``snapshot``: rebuilds the heap in place, keeping
        the seq values, so the fold order is the uninterrupted run's."""
        self._heap = [(int(t), int(s), e) for t, s, e in entries]
        heapq.heapify(self._heap)
        self._seq = int(next_seq)
