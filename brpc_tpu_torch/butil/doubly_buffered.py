"""Read-mostly data with contention-free reads.

Capability parity with DoublyBufferedData
(brpc's src/butil/containers/doubly_buffered_data.h:56): readers
never touch a shared mutex; writers pay the cost.  Backs load-balancer
server lists where SelectServer runs per-RPC.

Fresh design for CPython: attribute loads of an object reference are atomic
under the GIL, so the read path is a single snapshot load (even cheaper than
the reference's TLS-mutex scheme).  Writers copy-modify-swap under a writer
lock; the old snapshot stays alive until the last reader drops it (GC), which
is exactly the RCU guarantee the reference's fg/bg flip provides.

A copy of ``brpc_tpu/butil/doubly_buffered.py``.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class DoublyBufferedData(Generic[T]):
    def __init__(self, initial: T,
                 copier: Optional[Callable[[T], T]] = None):
        """``copier`` clones the snapshot for modification; defaults to
        ``copy.deepcopy`` so nested containers are isolated from live
        readers.  Pass a cheaper copier (e.g. ``list.copy``) when the
        value is flat and modify-rate matters."""
        self._snapshot: T = initial
        self._copier = copier or copy.deepcopy
        self._writer_lock = threading.Lock()
        self.modify_count = 0

    def read(self) -> T:
        """Lock-free snapshot. The returned object must be treated as
        immutable by callers (same contract as reference ScopedPtr reads)."""
        return self._snapshot

    def modify(self, fn: Callable[[T], Optional[bool]]) -> bool:
        """Apply ``fn`` to a private deep copy and atomically publish it.
        ``fn`` returning False aborts the publish (mirrors the reference's
        ``Modify`` returning 0 => unchanged)."""
        with self._writer_lock:
            new = self._copier(self._snapshot)
            ret = fn(new)
            if ret is False:
                return False
            self._snapshot = new
            self.modify_count += 1
            return True

    def modify_with_new(self, new_value: T) -> None:
        with self._writer_lock:
            self._snapshot = new_value
            self.modify_count += 1
