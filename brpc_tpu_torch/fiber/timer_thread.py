"""TimerThread — one dedicated thread, nearest-deadline sleep
(≈ brpc's src/bthread/timer_thread.h:63): backs RPC deadlines,
backup-request triggers, health-check schedules.

Fresh design: a single heap + Condition (the reference's hashed buckets
reduce multi-core contention that the GIL already serializes away).
``schedule`` returns a TimerId; ``unschedule`` is O(1) (lazy deletion).
Callbacks run on the task runtime, never on the timer thread itself, so a
slow callback cannot delay other timers.

A copy of ``brpc_tpu/fiber/timer_thread.py``.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Dict, Optional

from ..butil.logging_util import LOG
from .runtime import TaskRuntime, global_runtime


class TimerThread:
    def __init__(self, runtime: Optional[TaskRuntime] = None,
                 name: str = "timer"):
        self._runtime = runtime or global_runtime()
        self._heap = []                      # (abstime, seq)
        self._entries: Dict[int, tuple] = {} # seq -> (fn, args)
        self._seq = itertools.count(1)
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._name = name
        self.scheduled_count = 0
        self.triggered_count = 0
        self.cancelled_count = 0

    def _ensure_thread(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            name=self._name, daemon=True)
            self._thread.start()

    def schedule(self, fn: Callable, delay_s: float = 0.0,
                 abstime: Optional[float] = None, *args) -> int:
        """Run fn(*args) at abstime (monotonic) or after delay_s.
        Returns a TimerId."""
        when = abstime if abstime is not None else time.monotonic() + delay_s
        with self._cond:
            seq = next(self._seq)
            self._entries[seq] = (fn, args)
            heapq.heappush(self._heap, (when, seq))
            self.scheduled_count += 1
            self._ensure_thread()
            # wake the timer thread if this became the nearest deadline
            if self._heap[0][1] == seq:
                self._cond.notify()
        return seq

    def unschedule(self, timer_id: int) -> bool:
        """Cancel; returns True if the timer had not fired yet."""
        with self._cond:
            if timer_id in self._entries:
                del self._entries[timer_id]   # lazy: heap entry skipped later
                self.cancelled_count += 1
                return True
            return False

    def _run(self) -> None:
        while True:
            with self._cond:
                now = time.monotonic()
                fire = []
                while self._heap and self._heap[0][0] <= now:
                    when, seq = heapq.heappop(self._heap)
                    entry = self._entries.pop(seq, None)
                    if entry is not None:
                        fire.append(entry)
                if self._stop:
                    return
                if not fire:
                    if self._heap:
                        self._cond.wait(self._heap[0][0] - now)
                    else:
                        self._cond.wait()
            for fn, args in fire:
                self.triggered_count += 1
                try:
                    self._runtime.spawn(fn, *args, urgent=True,
                                        name="timer_cb")
                except Exception:
                    # a dead runtime must not kill the timer thread — every
                    # future RPC deadline would silently never fire
                    LOG.exception("timer callback spawn failed")

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()


_global_timer: Optional[TimerThread] = None
_global_timer_lock = threading.Lock()


def global_timer_thread() -> TimerThread:
    global _global_timer
    if _global_timer is None:
        with _global_timer_lock:
            if _global_timer is None:
                _global_timer = TimerThread()
    return _global_timer
