"""WorkStealingQueue — per-worker deque with owner push/pop and
foreign steal.

≈ brpc's src/bthread/work_stealing_queue.h: the owner pushes
and pops at the BOTTOM (LIFO — cache-hot continuation runs first),
thieves steal from the TOP (FIFO — oldest work migrates).  The
reference gets lock-freedom from atomics; under the GIL a short lock
gives the same semantics with the same interface, and the scheduler
layering (local queue first, steal on empty) is preserved.

A copy of ``brpc_tpu/butil/work_stealing_queue.py``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Optional, Tuple


class WorkStealingQueue:
    __slots__ = ("_dq", "_lock", "_cap")

    def __init__(self, capacity: int = 4096):
        self._dq: deque = deque()
        self._lock = threading.Lock()
        self._cap = capacity

    def push(self, item: Any) -> bool:
        """Owner side; False when full (caller overflows to the shared
        queue)."""
        with self._lock:
            if len(self._dq) >= self._cap:
                return False
            self._dq.append(item)
            return True

    def pop(self) -> Tuple[bool, Optional[Any]]:
        """Owner side: newest item (LIFO)."""
        with self._lock:
            if self._dq:
                return True, self._dq.pop()
            return False, None

    def steal(self) -> Tuple[bool, Optional[Any]]:
        """Thief side: oldest item (FIFO)."""
        with self._lock:
            if self._dq:
                return True, self._dq.popleft()
            return False, None

    def __len__(self) -> int:
        return len(self._dq)
