"""Containers used across the stack: the cut of ``brpc_tpu/butil/flat_map.py``
that the port's ``bvar`` needs, its :class:`BoundedQueue` (the percentile
reservoirs and the sampler's history ring).  The case-ignored header map
and the bounded MRU cache wait for the port's HTTP layer.
"""

from __future__ import annotations


class BoundedQueue:
    """Fixed-capacity FIFO ring (≈ butil/containers/bounded_queue.h)."""

    def __init__(self, capacity: int):
        self._buf = [None] * capacity
        self._cap = capacity
        self._start = 0
        self._count = 0

    def push(self, item) -> bool:
        if self._count >= self._cap:
            return False
        self._buf[(self._start + self._count) % self._cap] = item
        self._count += 1
        return True

    def push_force(self, item) -> None:
        """Push, evicting the oldest if full (elim_push)."""
        if not self.push(item):
            self.pop()
            self.push(item)

    def pop(self):
        if self._count == 0:
            return None
        item = self._buf[self._start]
        self._buf[self._start] = None
        self._start = (self._start + 1) % self._cap
        self._count -= 1
        return item

    def top(self):
        return self._buf[self._start] if self._count else None

    def snapshot(self) -> list:
        """Oldest-first copy of current contents (callers needing cross-
        thread consistency must hold their own lock around push/snapshot)."""
        return [self._buf[(self._start + i) % self._cap]
                for i in range(self._count)]

    def __len__(self) -> int:
        return self._count

    @property
    def full(self) -> bool:
        return self._count >= self._cap
