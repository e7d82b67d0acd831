"""Per-method stats + concurrency accounting
(≈ brpc's src/brpc/details/method_status.h): every method gets a
LatencyRecorder (qps/latency/percentiles in windows), an error counter,
and an in-flight gauge the concurrency limiter reads.

A copy of ``brpc_tpu/server/method_status.py``.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..bvar.latency_recorder import LatencyRecorder
from ..bvar.reducer import Adder


class MethodStatus:
    __slots__ = ("full_name", "latency", "errors", "_inflight",
                 "_inflight_lock", "max_concurrency", "limiter")

    def __init__(self, full_name: str, max_concurrency: int = 0,
                 limiter=None):
        safe = full_name.replace(".", "_").lower()
        self.full_name = full_name
        self.latency = LatencyRecorder(f"rpc_server_{safe}")
        self.errors = Adder(f"rpc_server_{safe}_error")
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.max_concurrency = max_concurrency
        self.limiter = limiter

    def on_requested(self) -> bool:
        """≈ ConcurrencyLimiter::OnRequested via MethodStatus. Returns
        False to reject (ELIMIT)."""
        with self._inflight_lock:
            limit = (self.limiter.max_concurrency()
                     if self.limiter is not None else self.max_concurrency)
            if limit > 0 and self._inflight >= limit:
                return False
            self._inflight += 1
            return True

    def undo_requested(self) -> None:
        """Back out one on_requested that a LATER admission layer
        (CoDel / tenant quota) vetoed: the request never ran, so no
        latency/error sample reaches the limiter."""
        with self._inflight_lock:
            if self._inflight > 0:
                self._inflight -= 1

    def live_max_concurrency(self) -> int:
        """The limit admission actually enforces right now: the
        adaptive limiter's live value when one is installed, else the
        static cap (0 = unlimited).  The /status page reports this —
        a static 0 next to an installed AutoLimiter used to read as
        'unlimited'."""
        if self.limiter is not None:
            return self.limiter.max_concurrency()
        return self.max_concurrency

    def limiter_kind(self) -> str:
        """'auto' / 'timeout' / 'constant' when a limiter is installed,
        'constant' for a bare max_concurrency cap, 'unlimited' else."""
        if self.limiter is not None:
            return getattr(self.limiter, "kind", "custom")
        return "constant" if self.max_concurrency > 0 else "unlimited"

    def on_responded(self, error_code: int, latency_us: float) -> None:
        with self._inflight_lock:
            if self._inflight > 0:
                self._inflight -= 1
        if error_code == 0:
            self.latency << latency_us
        else:
            self.errors << 1
        if self.limiter is not None:
            self.limiter.on_responded(error_code, latency_us)

    @property
    def inflight(self) -> int:
        return self._inflight
