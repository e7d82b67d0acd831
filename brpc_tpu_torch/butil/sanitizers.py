"""Runtime sanitizers: stall watchdog + lock-order (deadlock) detector.

The reference ships no custom race detector either — it vendors TSAN/
valgrind/ASAN annotations and argues lock-free correctness in comments
(SURVEY §5.2, brpc's src/butil/third_party/dynamic_annotations,
src/bthread/butex.cpp:188-240).  The Python-native analogues here are
runtime diagnostics instead of compile-time instrumentation:

- **StallWatchdog** (flag ``stall_watchdog_s``): long blocking waits
  register themselves; a timer sweep logs every thread's stack ONCE per
  stall when a registered wait exceeds the threshold — the "why is my
  RPC stuck" tool, usable in production (zero cost per wait beyond a
  dict insert, and only when the flag is on).
- **DebugLock** (``debug_lock_order``): a Lock wrapper that records the
  held→acquiring edge per thread into a global lock-order graph and
  logs a *potential deadlock* the first time an ABBA cycle appears —
  catches lock-inversion bugs even when the timing never actually
  deadlocks (what TSAN's lock-order checker does for the reference's
  CI builds).

A copy of ``brpc_tpu/butil/sanitizers.py``.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple

from .flags import define_flag, get_flag
from .logging_util import LOG

define_flag("stall_watchdog_s", 0.0,
            "log all thread stacks when a registered blocking wait "
            "exceeds this many seconds (0 = off)",
            validator=lambda v: float(v) >= 0)
define_flag("debug_lock_order", False,
            "record the lock-order graph on DebugLock acquisitions and "
            "warn on cycles (potential ABBA deadlocks)",
            validator=lambda v: True)


# -- stall watchdog ---------------------------------------------------------

_waits: Dict[int, Tuple[str, float, int]] = {}   # id -> (what, since, tid)
_waits_lock = threading.Lock()
_wait_seq = 0
_reported: Set[int] = set()
_sweeper_started = False


def watchdog_enabled() -> bool:
    return float(get_flag("stall_watchdog_s", 0.0)) > 0


class watched_wait:
    """Context manager wrapping a blocking wait so the watchdog can see
    it: ``with watched_wait("butex"): cond.wait_for(...)``."""

    __slots__ = ("what", "_id")

    def __init__(self, what: str):
        self.what = what
        self._id = 0

    def __enter__(self):
        global _wait_seq
        _ensure_sweeper()
        with _waits_lock:
            _wait_seq += 1
            self._id = _wait_seq
            _waits[self._id] = (self.what, time.monotonic(),
                                threading.get_ident())
        return self

    def __exit__(self, *exc):
        with _waits_lock:
            _waits.pop(self._id, None)
            _reported.discard(self._id)
        return False


def _dump_stacks(reason: str) -> str:
    out: List[str] = [reason]
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(tid, '?')} ({tid}) ---")
        out.append("".join(traceback.format_stack(frame)))
    text = "\n".join(out)
    LOG.error("%s", text)
    return text


def check_stalls(now: Optional[float] = None) -> int:
    """One sweep (also called by tests): report waits older than the
    threshold; each wait is reported once, and one sweep emits ONE
    all-thread stack dump no matter how many waits crossed the
    threshold together (a single hung dependency can strand hundreds).
    Returns #newly reported."""
    limit = float(get_flag("stall_watchdog_s", 0.0))
    if limit <= 0:
        return 0
    now = time.monotonic() if now is None else now
    with _waits_lock:
        stuck = [(wid, what, since) for wid, (what, since, _t)
                 in _waits.items()
                 if now - since > limit and wid not in _reported]
        for wid, _, _ in stuck:
            _reported.add(wid)
    if stuck:
        lines = ", ".join(f"'{what}' blocked {now - since:.1f}s"
                          for _w, what, since in stuck[:20])
        _dump_stacks(f"STALL: {len(stuck)} wait(s) exceeded "
                     f"stall_watchdog_s={limit}: {lines}")
    return len(stuck)


_manual = False      # tests drive check_stalls() themselves


def _ensure_sweeper() -> None:
    global _sweeper_started
    if _sweeper_started or _manual or not watchdog_enabled():
        return
    _sweeper_started = True
    from ..fiber.timer_thread import global_timer_thread

    def sweep():
        try:
            if not _manual:
                check_stalls()
        finally:
            period = max(float(get_flag("stall_watchdog_s", 0.0)) / 2,
                         0.5)
            global_timer_thread().schedule(sweep, period)

    global_timer_thread().schedule(sweep, 0.5)


# -- lock-order detector ----------------------------------------------------

_order_lock = threading.Lock()
_edges: Dict[str, Set[str]] = {}        # held -> then-acquired
_warned_cycles: Set[Tuple[str, str]] = set()
_tls = threading.local()

# flag cache: DebugLock now sits on hot paths (the fiber ExecutionQueue
# backing the socket write pump), so the per-acquire check must be one
# list read, not a flags-table lookup (same pattern as admission's
# CoDel cache)
from .flags import watch_flag as _watch_flag

_order_live = [bool(get_flag("debug_lock_order", False))]
_watch_flag("debug_lock_order",
            lambda v: _order_live.__setitem__(0, bool(v)))

# warning-count bvar on /vars (satellite: the count was test-only).
# Registered at module import below, with a DebugLock-construction
# retry hook: if an import-order edge ever defers the bvar package,
# the next DebugLock re-attempts instead of latching the var off.
_warn_var = None
_warn_var_lock = threading.Lock()


def _ensure_warning_var() -> None:
    global _warn_var
    with _warn_var_lock:
        if _warn_var is not None:
            # a test-scoped registry wipe (bvar
            # clear_registry_for_tests) un-exposes import-time vars
            # without telling them: re-expose on the next DebugLock
            # instead of latching the var off for the process's life
            try:
                from ..bvar.variable import find_exposed
                if find_exposed("sanitizer_lock_order_warnings") \
                        is not _warn_var:
                    _warn_var.expose("sanitizer_lock_order_warnings")
            except Exception:
                pass
            return
        try:
            from ..bvar.passive_status import PassiveStatus
            _warn_var = PassiveStatus(
                lambda: lock_order_warnings(),
                name="sanitizer_lock_order_warnings")
        except Exception:       # deferred: retried on next DebugLock
            pass


def _has_path(src: str, dst: str) -> bool:
    seen: Set[str] = set()
    stack = [src]
    while stack:
        node = stack.pop()
        if node == dst:
            return True
        if node in seen:
            continue
        seen.add(node)
        stack.extend(_edges.get(node, ()))
    return False


class DebugLock:
    """threading.Lock with lock-order recording (under the
    ``debug_lock_order`` flag; a plain pass-through otherwise).

    Also a drop-in Condition backing: the fiber ExecutionQueue wires
    its queue lock through this class, so ABBA inversions between
    queue roles and application locks show up in the order graph."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        _ensure_warning_var()

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        if _order_live[0]:
            held: List[str] = getattr(_tls, "held", None) or []
            with _order_lock:
                for h in held:
                    if h == self.name:
                        continue
                    # adding h -> self; a pre-existing path self -> h
                    # closes an ABBA cycle.  Canonical (sorted) key:
                    # the same cycle warns once regardless of which
                    # order trips the detector
                    key = tuple(sorted((self.name, h)))
                    if _has_path(self.name, h) \
                            and key not in _warned_cycles:
                        _warned_cycles.add(key)
                        LOG.error(
                            "POTENTIAL DEADLOCK: lock order cycle "
                            "'%s' -> '%s' (both orders observed)\n%s",
                            h, self.name,
                            "".join(traceback.format_stack(limit=8)))
                    _edges.setdefault(h, set()).add(self.name)
            ok = self._lock.acquire(blocking, timeout)
            if ok:
                held = getattr(_tls, "held", None)
                if held is None:
                    held = _tls.held = []
                held.append(self.name)
            return ok
        # flag off: pure pass-through — no TLS bookkeeping on hot paths
        return self._lock.acquire(blocking, timeout)

    def release(self) -> None:
        held = getattr(_tls, "held", None)
        if held and self.name in held:
            held.remove(self.name)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._lock.locked()


def lock_order_warnings() -> int:
    """Number of distinct cycles warned so far (introspection/tests)."""
    with _order_lock:
        return len(_warned_cycles)


def reset_for_tests() -> None:
    """Also switches to manual sweeping: tests call check_stalls()
    deterministically instead of racing the background timer."""
    global _manual
    _manual = True
    with _order_lock:
        _edges.clear()
        _warned_cycles.clear()
    with _waits_lock:
        _waits.clear()
        _reported.clear()


_ensure_warning_var()
