"""Time helpers (≈ brpc's src/butil/time.h).

``cpuwide_time_us`` in the reference is rdtsc-based; here the monotonic
clock is the cheapest precise source Python exposes.

A copy of ``brpc_tpu/butil/time_utils.py``.
"""

from __future__ import annotations

import time


def monotonic_us() -> int:
    return time.monotonic_ns() // 1000


def monotonic_ms() -> int:
    return time.monotonic_ns() // 1_000_000


def gettimeofday_us() -> int:
    return time.time_ns() // 1000


cpuwide_time_us = monotonic_us


class Timer:
    """Stopwatch (≈ butil::Timer)."""

    def __init__(self, start: bool = False):
        self._start_ns = 0
        self._stop_ns = 0
        if start:
            self.start()

    def start(self) -> None:
        self._start_ns = time.monotonic_ns()
        self._stop_ns = self._start_ns

    def stop(self) -> None:
        self._stop_ns = time.monotonic_ns()

    def n_elapsed(self) -> int:
        return self._stop_ns - self._start_ns

    def u_elapsed(self) -> int:
        return self.n_elapsed() // 1000

    def m_elapsed(self) -> int:
        return self.n_elapsed() // 1_000_000

    def s_elapsed(self) -> float:
        return self.n_elapsed() / 1e9
