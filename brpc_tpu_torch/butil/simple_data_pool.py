"""SimpleDataPool — recycled per-request user data.

≈ brpc's src/brpc/simple_data_pool.h: servers hand each request
a reusable "session-local data" object created by a user factory;
returning it to the pool skips re-construction on the next request.
Wired to ``ServerOptions.session_local_data_factory`` +
``ServerController.session_local_data()``.

A copy of ``brpc_tpu/butil/simple_data_pool.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional


class SimpleDataPool:
    def __init__(self, factory: Callable[[], Any],
                 destroy: Optional[Callable[[Any], None]] = None,
                 max_cached: int = 128):
        self._factory = factory
        self._destroy = destroy
        self._max = max_cached
        self._lock = threading.Lock()
        self._free: List[Any] = []
        self.created = 0      # stats (≈ Stat in the reference)
        self.borrowed = 0

    def borrow(self) -> Any:
        with self._lock:
            self.borrowed += 1
            if self._free:
                return self._free.pop()
            self.created += 1
        return self._factory()

    def give_back(self, obj: Any) -> None:
        if obj is None:
            return
        with self._lock:
            self.borrowed -= 1
            if len(self._free) < self._max:
                self._free.append(obj)
                return
        if self._destroy is not None:
            self._destroy(obj)

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)
