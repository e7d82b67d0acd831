"""Process/system metrics (≈ brpc's src/bvar/default_variables.cpp):
cpu, rss, fd count, thread count, uptime — read from /proc at query time.

A copy of ``brpc_tpu/bvar/default_variables.py``.
"""

from __future__ import annotations

import os
import threading
import time

from .passive_status import PassiveStatus

_start_time = time.time()
_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except Exception:
        return 0


def _fd_count() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except Exception:
        return 0


def _thread_count() -> int:
    return threading.active_count()


def _cpu_seconds() -> float:
    try:
        with open("/proc/self/stat") as f:
            raw = f.read()
        # comm (field 2) may contain spaces; fields resume after last ')'
        parts = raw.rsplit(")", 1)[1].split()
        utime, stime = int(parts[11]), int(parts[12])
        hz = os.sysconf("SC_CLK_TCK")
        return (utime + stime) / hz
    except Exception:
        return 0.0


def _uptime_s() -> float:
    return time.time() - _start_time


_exposed = []


def expose_default_variables() -> None:
    """Idempotently expose process_* vars (called by Server start).
    Keyed on registry state, not module state, so a registry reset
    (tests) can re-expose."""
    from .variable import find_exposed
    if find_exposed("process_pid") is not None:
        return
    _exposed.clear()
    _exposed.extend([
        PassiveStatus(_rss_bytes, "process_memory_resident"),
        PassiveStatus(_fd_count, "process_fd_count"),
        PassiveStatus(_thread_count, "process_thread_count"),
        PassiveStatus(_cpu_seconds, "process_cpu_seconds_total"),
        PassiveStatus(_uptime_s, "process_uptime_seconds"),
        PassiveStatus(os.getpid, "process_pid"),
    ])
