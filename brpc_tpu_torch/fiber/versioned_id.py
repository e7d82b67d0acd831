"""Versioned correlation ids — THE RPC rendezvous mechanism.

Capability parity with bthread_id (brpc's src/bthread/id.h:46):
a 64-bit handle protecting an object (the in-flight Call), where

- ``lock(id)`` serializes access from response threads / timers / cancel;
- ``error(id, code)`` delivers asynchronous failures through the
  registered handler, queued if the id is currently locked;
- ranged ids (``create_ranged``, id.h:56) make *retry attempt k* address
  the same call as version ``base+k`` — a stale response from attempt 0
  can still find (and be distinguished by) the call object;
- ``join(id)`` blocks until the call is destroyed;
- destroying bumps the version so stale ids resolve to nothing.

Fresh design: one Condition per slot guards {locked, pending errors,
version}; no global lock on the hot path.

A copy of ``brpc_tpu/fiber/versioned_id.py``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, List, Optional, Tuple

# id layout: (slot_index << VERSION_BITS) | version
VERSION_BITS = 36
_VERSION_MASK = (1 << VERSION_BITS) - 1

INVALID_CALL_ID = 0

# on_error(call_id, data, error_code, error_text) — called with the id
# LOCKED; the handler must unlock or unlock_and_destroy.
ErrorHandler = Callable[[int, Any, int, str], None]


class _Slot:
    __slots__ = ("cond", "data", "on_error", "base", "range", "locked",
                 "pending", "joiners_wake")

    def __init__(self):
        self.cond = threading.Condition()
        self.data = None
        self.on_error: Optional[ErrorHandler] = None
        self.base = 1          # first valid version
        self.range = 1
        self.locked = False
        self.pending: deque = deque()   # queued (call_id, code, text)


class IdPool:
    def __init__(self):
        self._slots: List[_Slot] = []
        self._free: List[int] = []
        self._alloc_lock = threading.Lock()

    # -- lifecycle --

    def create(self, data: Any = None,
               on_error: Optional[ErrorHandler] = None,
               version_range: int = 1) -> int:
        with self._alloc_lock:
            if self._free:
                idx = self._free.pop()
                slot = self._slots[idx]
            else:
                idx = len(self._slots)
                slot = _Slot()
                self._slots.append(slot)
        with slot.cond:
            slot.data = data
            slot.on_error = on_error or _default_on_error(self)
            slot.range = max(1, version_range)
            slot.locked = False
            slot.pending.clear()
            return (idx << VERSION_BITS) | slot.base

    def create_ranged(self, data: Any, on_error: Optional[ErrorHandler],
                      version_range: int) -> int:
        """Versions [base, base+range) all address this call; callers
        derive sub-ids with ``first_id + k`` for retry attempt k."""
        return self.create(data, on_error, version_range)

    def _resolve(self, call_id: int) -> Tuple[Optional[_Slot], int]:
        idx = call_id >> VERSION_BITS
        version = call_id & _VERSION_MASK
        try:
            slot = self._slots[idx]
        except IndexError:
            return None, 0
        return slot, version

    def _valid_locked(self, slot: _Slot, version: int) -> bool:
        return slot.base <= version < slot.base + slot.range

    def valid(self, call_id: int) -> bool:
        slot, version = self._resolve(call_id)
        if slot is None:
            return False
        with slot.cond:
            return self._valid_locked(slot, version)

    # -- locking protocol --

    def lock(self, call_id: int) -> Tuple[bool, Any]:
        """Blocks until the id lock is held. Returns (ok, data); ok=False
        if the id is stale/destroyed."""
        slot, version = self._resolve(call_id)
        if slot is None:
            return False, None
        with slot.cond:
            while True:
                if not self._valid_locked(slot, version):
                    return False, None
                if not slot.locked:
                    slot.locked = True
                    return True, slot.data
                slot.cond.wait()

    def try_lock(self, call_id: int) -> Tuple[int, Any]:
        """Non-blocking :meth:`lock`: (1, data) = locked, (0, None) =
        currently held by another owner (caller must not wait here),
        (-1, None) = stale/destroyed.  The client lane's demux thread
        uses this so one contended id (a backup-request handler mid-
        connect) can never stall every connection's completions."""
        slot, version = self._resolve(call_id)
        if slot is None:
            return -1, None
        with slot.cond:
            if not self._valid_locked(slot, version):
                return -1, None
            if slot.locked:
                return 0, None
            slot.locked = True
            return 1, slot.data

    def unlock(self, call_id: int) -> None:
        """Release the lock; if errors were queued while locked, run the
        handler for the next one (still holding the logical id lock)."""
        slot, version = self._resolve(call_id)
        if slot is None:
            return
        run: Optional[Tuple[int, int, str]] = None
        with slot.cond:
            # a stale id must not release a lock now owned by the slot's
            # next incarnation (slot indexes are recycled)
            if not slot.locked or not self._valid_locked(slot, version):
                return
            if slot.pending:
                run = slot.pending.popleft()
                # keep slot.locked = True: handler owns the lock now
            else:
                slot.locked = False
                slot.cond.notify_all()
        if run is not None:
            # deliver with the id the error was RAISED for — a ranged
            # id's version is how the handler knows WHICH attempt
            # failed; substituting the unlocker's call_id re-errored
            # version 0 forever (retry chain spun, call never ended)
            qid, code, text = run
            slot.on_error(qid, slot.data, code, text)

    def unlock_and_destroy(self, call_id: int) -> bool:
        slot, version = self._resolve(call_id)
        if slot is None:
            return False
        with slot.cond:
            if not self._valid_locked(slot, version):
                return False             # stale id: never touch lock state
            slot.base += slot.range      # all versions in range die at once
            slot.locked = False
            slot.data = None
            slot.pending.clear()
            slot.cond.notify_all()       # wake joiners & lock waiters
        with self._alloc_lock:
            self._free.append(call_id >> VERSION_BITS)
        return True

    # -- async error delivery --

    def error(self, call_id: int, error_code: int,
              error_text: str = "") -> bool:
        """Deliver an error to the call. If the id is locked, the error is
        queued and delivered on unlock; otherwise the handler runs now,
        holding the id lock (≈ bthread_id_error, id.h:75)."""
        slot, version = self._resolve(call_id)
        if slot is None:
            return False
        with slot.cond:
            if not self._valid_locked(slot, version):
                return False
            if slot.locked:
                slot.pending.append((call_id, error_code, error_text))
                return True
            slot.locked = True
        slot.on_error(call_id, slot.data, error_code, error_text)
        return True

    def join(self, call_id: int, timeout: Optional[float] = None) -> bool:
        """Block until the id is destroyed (≈ bthread_id_join)."""
        slot, version = self._resolve(call_id)
        if slot is None:
            return True
        with slot.cond:
            waitfn = lambda: slot.cond.wait_for(       # noqa: E731
                lambda: not self._valid_locked(slot, version), timeout)
            from ..butil import sanitizers as _san
            if _san.watchdog_enabled():
                # the RPC-join wait: the one users see when a call hangs
                with _san.watched_wait("rpc_join"):
                    return waitfn()
            return waitfn()


def _default_on_error(pool: "IdPool") -> ErrorHandler:
    def handler(call_id: int, data: Any, code: int, text: str) -> None:
        pool.unlock_and_destroy(call_id)
    return handler


_global_pool = IdPool()


def global_id_pool() -> IdPool:
    return _global_pool
