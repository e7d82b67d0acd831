"""Butex — futex-shaped blocking primitive
(≈ brpc's src/bthread/butex.cpp:283): wait iff the value still
equals the expected value; wakers bump the value and wake waiters.  All
higher-level blocking (call join, stream windows, countdown) builds on it,
mirroring the reference's layering.

A copy of ``brpc_tpu/fiber/butex.py``: a wait is timed for
``/hotspots/contention`` while the contention profiler runs, registered
with the stall watchdog (``butil/sanitizers``) while its flag is on, and
is a plain condition wait otherwise.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..butil import sanitizers as _san
from .runtime import blocking


class Butex:
    """Futex semantics: ``wait`` sleeps only if the value still equals
    ``expected`` at entry, and then ANY ``wake`` releases it regardless of
    the value (a generation counter prevents re-blocking on a stale
    predicate — the lost-wakeup guard the reference gets from the kernel
    futex). Spurious wakeups are allowed, as with real futexes: callers
    re-check their own condition in a loop."""

    __slots__ = ("_value", "_gen", "_cond")

    def __init__(self, value: int = 0):
        self._value = value
        self._gen = 0
        self._cond = threading.Condition()

    @property
    def value(self) -> int:
        return self._value

    def set_value(self, v: int) -> None:
        """Plain store, no wake — exactly a memory write to the futex word."""
        with self._cond:
            self._value = v

    def wait(self, expected: int, timeout: Optional[float] = None) -> bool:
        """Returns True if woken (or the value had already changed),
        False on timeout."""
        with self._cond:
            if self._value != expected:
                return True
            g = self._gen
            with blocking():
                from .. import profiling
                waitfn = lambda: self._cond.wait_for(  # noqa: E731
                    lambda: self._gen != g or self._value != expected,
                    timeout)
                if profiling.contention_active():
                    return profiling.timed_wait("butex", waitfn)
                if _san.watchdog_enabled():
                    with _san.watched_wait("butex"):
                        return waitfn()
                return waitfn()

    def wake(self, n: int = 1) -> None:
        with self._cond:
            self._gen += 1
            self._cond.notify(n)

    def wake_all(self) -> None:
        with self._cond:
            self._gen += 1
            self._cond.notify_all()

    def add_and_wake(self, delta: int = 1, all: bool = True) -> int:
        """Atomically bump the value and wake waiters — the common
        signal pattern."""
        with self._cond:
            self._value += delta
            self._gen += 1
            if all:
                self._cond.notify_all()
            else:
                self._cond.notify(1)
            return self._value


class CountdownEvent:
    """≈ bthread::CountdownEvent — join N things."""

    def __init__(self, count: int = 1):
        self._butex = Butex(count)

    def signal(self, n: int = 1) -> None:
        self._butex.add_and_wake(-n)

    def add_count(self, n: int = 1) -> None:
        self._butex.add_and_wake(n, all=False)

    def wait(self, timeout: Optional[float] = None) -> bool:
        with self._butex._cond:
            with blocking():
                from .. import profiling
                waitfn = lambda: self._butex._cond.wait_for(  # noqa: E731
                    lambda: self._butex._value <= 0, timeout)
                if profiling.contention_active():
                    return profiling.timed_wait("countdown", waitfn)
                if _san.watchdog_enabled():
                    with _san.watched_wait("countdown"):
                        return waitfn()
                return waitfn()

    @property
    def count(self) -> int:
        return self._butex.value
