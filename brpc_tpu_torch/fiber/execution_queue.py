"""ExecutionQueue — MPSC queue with an auto-started single consumer
(≈ brpc's src/bthread/execution_queue.h:159).

Producers call ``execute(item)`` from any thread; exactly one consumer
task drains batches through the executor callback, then parks itself when
empty (auto-quit).  A high-priority lane jumps the line.  Backs the Socket
write path and load-balancer membership updates, as in the reference.

The executor receives a TaskIterator; iterating consumes items.  If the
queue was stopped, ``iterator.stopped`` is True and remaining items should
be handled as cancelled (mirrors TaskIterator doc, execution_queue.h:78).

A copy of ``brpc_tpu/fiber/execution_queue.py``.
"""

from __future__ import annotations

import re
import threading
from collections import deque
from typing import Any, Callable, Deque, Iterator, Optional

from ..butil.sanitizers import DebugLock
from .runtime import TaskRuntime, global_runtime


class TaskIterator:
    def __init__(self, items: Deque, stopped: bool):
        self._items = items
        self.stopped = stopped

    def __iter__(self) -> Iterator[Any]:
        while self._items:
            yield self._items.popleft()

    def __len__(self) -> int:
        return len(self._items)


class ExecutionQueue:
    def __init__(self, executor: Callable[[TaskIterator], None],
                 runtime: Optional[TaskRuntime] = None, name: str = "execq"):
        self._executor = executor
        self._runtime = runtime or global_runtime()
        self._name = name
        # lock-order-instrumented queue lock (butil/sanitizers): under
        # the debug_lock_order flag, ABBA inversions between queue
        # ROLES (instance digits stripped — per-conn queues must not
        # grow the order graph without bound) and other DebugLocks
        # warn before the timing ever deadlocks; flag off = plain Lock
        # pass-through
        self._lock = DebugLock(
            "execq:" + (re.sub(r"[_0-9]+$", "", name) or "execq"))
        self._queue: Deque = deque()
        self._high: Deque = deque()
        self._running = False
        self._stopped = False
        self._drained = threading.Condition(self._lock)

    def execute(self, item: Any, high_priority: bool = False) -> bool:
        """Enqueue; returns False if the queue was stopped."""
        with self._lock:
            if self._stopped:
                return False
            (self._high if high_priority else self._queue).append(item)
            if not self._running:
                self._running = True
                self._runtime.spawn(self._consume, name=self._name)
        return True

    def _consume(self) -> None:
        while True:
            with self._lock:
                if not self._high and not self._queue:
                    self._running = False
                    self._drained.notify_all()
                    return
                batch: Deque = deque()
                while self._high:
                    batch.append(self._high.popleft())
                while self._queue:
                    batch.append(self._queue.popleft())
                stopped = self._stopped
            it = TaskIterator(batch, stopped)
            try:
                self._executor(it)
            except Exception:
                from ..butil.logging_util import LOG
                LOG.exception("execution queue %s executor raised", self._name)
            # loop: re-check for items enqueued while we were executing

    def stop(self) -> None:
        with self._lock:
            self._stopped = True

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until everything enqueued has been consumed."""
        with self._lock:
            return self._drained.wait_for(
                lambda: not self._running and not self._queue and not self._high,
                timeout)

    @property
    def pending(self) -> int:
        return len(self._queue) + len(self._high)
