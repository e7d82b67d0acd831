"""Containers used across the stack.

Python dicts are already open-addressing hash maps (brpc built FlatMap,
src/butil/containers/flat_map.h, because std::unordered_map was slow;
that reason does not carry over).  What does carry over is the
case-ignored map for HTTP headers, the bounded MRU cache and the bounded
queue (the percentile reservoirs and the sampler's history ring).

A copy of ``brpc_tpu/butil/flat_map.py``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Iterator, Tuple


class CaseIgnoredFlatMap:
    """Case-insensitive string map preserving original key casing
    (≈ case_ignored_flat_map.h; used for HTTP headers)."""

    def __init__(self):
        self._d: dict = {}  # lower_key -> (orig_key, value)

    def __setitem__(self, key: str, value) -> None:
        self._d[key.lower()] = (key, value)

    def __getitem__(self, key: str):
        return self._d[key.lower()][1]

    def get(self, key: str, default=None):
        item = self._d.get(key.lower())
        return item[1] if item is not None else default

    def __delitem__(self, key: str) -> None:
        del self._d[key.lower()]

    def __contains__(self, key: str) -> bool:
        return key.lower() in self._d

    def __len__(self) -> int:
        return len(self._d)

    def items(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._d.values())

    def keys(self):
        return (k for k, _ in self._d.values())

    def clear(self) -> None:
        self._d.clear()


class MRUCache:
    """Bounded most-recently-used cache (≈ butil/containers/mru_cache.h)."""

    def __init__(self, max_size: int):
        self.max_size = max_size
        self._d: OrderedDict = OrderedDict()

    def put(self, key, value) -> None:
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.max_size:
            self._d.popitem(last=False)

    def get(self, key, default=None):
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return default

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)


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
