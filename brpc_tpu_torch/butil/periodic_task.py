"""PeriodicTask — generic repeating work on the shared timer thread.

≈ brpc's src/brpc/periodic_task.h: subclass-or-callback runs
every ``interval_s`` until stopped; the callback's return value can
retarget the next interval (return a number) or stop the task (return
False).  Used by health check / naming refresh style maintenance — now
as a public facility.

A copy of ``brpc_tpu/butil/periodic_task.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Union

from ..fiber.timer_thread import global_timer_thread


class PeriodicTask:
    def __init__(self, interval_s: float, fn: Callable[[], object],
                 run_immediately: bool = False):
        self._interval_s = float(interval_s)
        self._fn = fn
        self._lock = threading.Lock()
        self._timer_id = 0
        self._stopped = False
        self.run_count = 0
        if run_immediately:
            self._tick()
        else:
            self._schedule(self._interval_s)

    def _schedule(self, delay_s: float) -> None:
        with self._lock:
            if self._stopped:
                return
            self._timer_id = global_timer_thread().schedule(
                self._tick, delay_s, None)

    def _tick(self) -> None:
        if self._stopped:
            return
        self.run_count += 1
        try:
            ret: Union[bool, float, None] = self._fn()
        except Exception:
            from .logging_util import LOG
            LOG.exception("periodic task raised")
            ret = None
        if ret is False:
            self._stopped = True
            return
        delay = float(ret) if isinstance(ret, (int, float)) \
            and not isinstance(ret, bool) and ret > 0 else self._interval_s
        self._schedule(delay)

    def stop(self) -> None:
        """Idempotent; a tick in flight finishes but does not reschedule."""
        with self._lock:
            self._stopped = True
            if self._timer_id:
                global_timer_thread().unschedule(self._timer_id)
                self._timer_id = 0
