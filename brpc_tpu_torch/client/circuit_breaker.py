"""Per-node circuit breaker
(≈ brpc's src/brpc/circuit_breaker.h:25-85): two EMA error
windows (long + short) trip isolation; isolation duration doubles on
repeated trips within a window and decays after health returns. The LB
skips isolated nodes; feedback is fed from every finished call.

A copy of ``brpc_tpu/client/circuit_breaker.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..butil.endpoint import EndPoint
from ..butil.status import Errno

# window/threshold shapes mirror the reference defaults
_SHORT_ALPHA = 0.3        # fast window EMA
_LONG_ALPHA = 0.02        # slow window EMA
_SHORT_TRIP = 0.6         # short-window error rate to trip
_LONG_TRIP = 0.2          # long-window error rate to trip
_MIN_SAMPLES = 8
_BASE_ISOLATION_S = 0.1
_MAX_ISOLATION_S = 30.0
_DOUBLE_WINDOW_S = 30.0   # re-trip within this doubles the duration
# overload plane: an ELIMIT bounce is the server WORKING AS DESIGNED
# under overload — health feedback at reduced weight keeps a merely
# busy (not broken) replica from tripping isolation and shrinking the
# healthy pool exactly when capacity is scarcest; sustained admission
# rejection still trips eventually (0.3 x rate crosses the long
# window's 0.2 threshold)
_ELIMIT_WEIGHT = 0.3
_ELIMIT = int(Errno.ELIMIT)
# operability plane: an ELAMEDUCK bounce is a PLANNED restart — zero
# error weight (the lame-duck registry already removed the node from
# selection; tripping the breaker on top would penalize the node's
# post-restart re-entry, exactly what graceful drain exists to avoid)
_ELAMEDUCK = int(Errno.ELAMEDUCK)


class _NodeBreaker:
    __slots__ = ("short_ema", "long_ema", "samples", "isolated_until",
                 "isolation_s", "last_trip", "lock")

    def __init__(self):
        self.short_ema = 0.0
        self.long_ema = 0.0
        self.samples = 0
        self.isolated_until = 0.0
        self.isolation_s = _BASE_ISOLATION_S
        self.last_trip = 0.0
        self.lock = threading.Lock()

    def on_call(self, error) -> bool:
        """``error``: bool, or a float error weight in [0, 1] (the
        overload plane feeds ELIMIT bounces at reduced weight).
        Returns True when THIS call tripped isolation."""
        e = float(error)
        with self.lock:
            self.samples += 1
            self.short_ema += (e - self.short_ema) * _SHORT_ALPHA
            self.long_ema += (e - self.long_ema) * _LONG_ALPHA
            if self.samples < _MIN_SAMPLES:
                return
            if self.short_ema > _SHORT_TRIP or self.long_ema > _LONG_TRIP:
                now = time.monotonic()
                if now < self.isolated_until:
                    return
                if now - self.last_trip < _DOUBLE_WINDOW_S:
                    self.isolation_s = min(self.isolation_s * 2,
                                           _MAX_ISOLATION_S)
                else:
                    self.isolation_s = _BASE_ISOLATION_S
                self.last_trip = now
                self.isolated_until = now + self.isolation_s
                # both windows restart: a frozen long window would re-trip
                # a healthy server on its first post-isolation call
                self.short_ema = 0.0
                self.long_ema = 0.0
                self.samples = 0
                return True
        return False

    def isolated(self) -> bool:
        return time.monotonic() < self.isolated_until


class CircuitBreakerMap:
    def __init__(self):
        self._lock = threading.Lock()
        self._nodes: Dict[EndPoint, _NodeBreaker] = {}
        self.enabled = True

    def _node(self, ep: EndPoint) -> _NodeBreaker:
        nb = self._nodes.get(ep)
        if nb is None:
            with self._lock:
                nb = self._nodes.setdefault(ep, _NodeBreaker())
        return nb

    def on_call(self, ep: EndPoint, error_code: int,
                latency_us: float) -> None:
        if not self.enabled:
            return
        if error_code == 0 or error_code == _ELAMEDUCK:
            e = 0.0                 # lame duck: planned, not broken
        elif error_code == _ELIMIT:
            e = _ELIMIT_WEIGHT      # busy, not broken: reduced weight
        else:
            e = 1.0
        if self._node(ep).on_call(e):
            # a trip is a fleet-postmortem event: which peer, when
            try:
                from .. import fleet
                fleet.record_event("fleet_breaker_trip", str(ep))
            except Exception:
                pass

    def isolated(self, ep: EndPoint) -> bool:
        if not self.enabled:
            return False
        nb = self._nodes.get(ep)
        return nb.isolated() if nb is not None else False

    def reset(self) -> None:
        with self._lock:
            self._nodes.clear()


_global_map: Optional[CircuitBreakerMap] = None
_global_lock = threading.Lock()


def global_circuit_breaker_map() -> CircuitBreakerMap:
    global _global_map
    with _global_lock:
        if _global_map is None:
            _global_map = CircuitBreakerMap()
        return _global_map
