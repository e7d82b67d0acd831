"""Bounded-rate sample collection (≈ brpc's src/bvar/collector.h):
shared by rpcz spans and rpc_dump.  Producers submit samples; a budget
limits samples/second globally; a background drainer hands batches to the
registered sink (preprocessor).

A copy of ``brpc_tpu/bvar/collector.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, List, Optional

COLLECTOR_SAMPLING_BASE = 64
_MAX_PER_SECOND = 1000


class Collected:
    """Base for collectable samples (≈ bvar::Collected LinkNode)."""

    def submit(self, collector: "Collector") -> None:
        collector.submit(self)


class Collector:
    def __init__(self, sink: Optional[Callable[[List[Collected]], None]] = None,
                 max_per_second: int = _MAX_PER_SECOND):
        self._sink = sink
        self._capacity = 4 * max_per_second
        self._queue: Deque[Collected] = deque()
        self._lock = threading.Lock()
        self._max_per_second = max_per_second
        self._second_start = time.monotonic()
        self._taken_this_second = 0
        self.dropped = 0

    def submit(self, sample: Collected) -> bool:
        """Rate-limited enqueue; returns False if over budget (dropped)."""
        now = time.monotonic()
        with self._lock:
            if now - self._second_start >= 1.0:
                self._second_start = now
                self._taken_this_second = 0
            if (self._taken_this_second >= self._max_per_second
                    or len(self._queue) >= self._capacity):
                # over rate budget OR drainer is lagging: refuse admission
                # (never silently evict a sample the producer was told we
                # accepted)
                self.dropped += 1
                return False
            self._taken_this_second += 1
            self._queue.append(sample)
        return True

    def drain(self) -> List[Collected]:
        """Grab everything pending (called by the dumping thread/portal)."""
        with self._lock:
            items = list(self._queue)
            self._queue.clear()
        if self._sink and items:
            self._sink(items)
        return items

    @property
    def pending(self) -> int:
        return len(self._queue)
