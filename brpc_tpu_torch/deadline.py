"""Deadline plane — the cross-cutting end-to-end deadline state.

The wire already carries a remaining deadline (tpu_std meta TLV 13);
this module is the shared machinery that makes it mean something:

- **doomed-work shedding** (server side): the dispatch path checks,
  right before user code would run, whether the request's propagated
  deadline already expired while the frame waited, and answers
  ``ERPCTIMEDOUT`` without spending handler time on it.  Sheds are
  counted per ``(lane, method)`` and exported as the
  ``deadline_shed_total`` bvar family.  ≈ brpc ``-server_fail_fast``.
- **ambient inheritance** (client side inside a handler): dispatch
  wraps user code in :class:`inherit_deadline`, so any downstream RPC
  issued from the handler's call stack defaults its own timeout to the
  inherited remaining budget minus elapsed, and fails fast at <= 0
  instead of dispatching work the upstream caller will never see.  The
  mark is a thread-local: work a handler hands to other threads must
  carry ``cntl.deadline_remaining_ms()`` itself.
- **retry hardening**: :class:`RetryBudget`, the token bucket every
  retry and backup attempt of a channel draws from, and
  :func:`backoff_ms`, exponential backoff with jitter.

Shedding is live-togglable via the ``enable_deadline_shed`` flag.

A copy of ``brpc_tpu/deadline.py``, whole: the flag, the shed counters
and their family, ``maybe_shed``, ``arm``, ``parse_deadline_ms``, the
ambient budget, ``cap_timeout_ms``, ``RetryBudget``, ``backoff_ms`` (its
jitter from the port's ``butil/fast_rand``) and ``inherit_deadline``.
The port's one server lane is classic tpu_std (``"tpu_std"``); the
other lanes named in the JAX docstring are not ported.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from .butil.flags import define_flag, get_flag
from .butil.time_utils import monotonic_us

define_flag("enable_deadline_shed", True,
            "answer ERPCTIMEDOUT for requests whose propagated deadline "
            "expired in queue, without invoking the handler",
            validator=lambda v: isinstance(v, bool))


def shed_enabled() -> bool:
    return bool(get_flag("enable_deadline_shed", True))


# ---------------------------------------------------------------------------
# shed accounting: plain dict under a lock (read-modify-write on a dict
# slot is not atomic; sheds come from every connection's thread).
# Exposed eagerly as the deadline_shed_total{lane,method} bvar family so
# a scrape keyed on it never depends on a shed having happened.
# ---------------------------------------------------------------------------

_shed_lock = threading.Lock()
_shed: Dict[Tuple[str, str], int] = {}

from .bvar.multi_dimension import PassiveDimension as _PassiveDimension

_shed_var = _PassiveDimension(
    ("lane", "method"), lambda: shed_counters(),
    name="deadline_shed_total")


def record_shed(lane: str, method: str) -> None:
    with _shed_lock:
        _shed[(lane, method)] = _shed.get((lane, method), 0) + 1


def shed_counters() -> Dict[Tuple[str, str], int]:
    """Snapshot of the per-(lane, method) shed counters."""
    with _shed_lock:
        return dict(_shed)


def maybe_shed(cntl, lane: str, method: str) -> bool:
    """The one shedding decision, shared by all five server paths.

    True ⇢ the request's propagated deadline expired before user code
    could run: the shed is recorded, the span (when sampled) annotated,
    and ``cntl`` failed with ``ERPCTIMEDOUT`` — the CALLER completes it
    (``cntl.finish(None)``) so each path's own error serializer answers
    the client (error frame, HTTP 500 + x-rpc-error-code, grpc-status 4).
    """
    d = getattr(cntl, "deadline_us", 0)
    if not d:
        return False
    late_ms = (monotonic_us() - d) / 1000.0
    if late_ms < 0 or not shed_enabled():
        return False
    record_shed(lane, method)
    span = getattr(cntl, "span", None)
    if span is not None:
        span.annotate(f"deadline expired {late_ms:.1f}ms before dispatch;"
                      f" shed on the {lane} lane")
    from .butil.status import Errno
    cntl.set_failed(int(Errno.ERPCTIMEDOUT),
                    f"deadline expired {late_ms:.1f}ms before dispatch "
                    "(doomed work shed)")
    return True


def arm(cntl, timeout_ms: Optional[int],
        arrival_us: Optional[int] = None) -> None:
    """Anchor ``cntl``'s absolute deadline at the request's ARRIVAL —
    the protocol parse timestamp when the path has one (the engine's
    CLOCK_MONOTONIC parse stamp on the native lanes, the message-cut
    stamp elsewhere), else the controller's construction time.
    ``timeout_ms == 0`` means expired-at-arrival (an ``x-deadline-ms:
    0`` header); None means no deadline."""
    if timeout_ms is None or timeout_ms < 0:
        return
    base = arrival_us if arrival_us else cntl.begin_time_us
    cntl.deadline_us = base + int(timeout_ms) * 1000


def parse_deadline_ms(value) -> Optional[int]:
    """The one ``x-deadline-ms`` header parse, shared by the classic and
    slim HTTP lanes so they can never disagree on whether the same
    request carries a deadline.  Accepts str or bytes; returns the
    remaining budget in ms (0 = already expired) or None when absent or
    malformed."""
    if value is None:
        return None
    if isinstance(value, (bytes, memoryview)):
        value = bytes(value).decode("latin1")
    value = value.strip()
    return int(value) if value.isdigit() else None


# ---------------------------------------------------------------------------
# ambient inheritance
# ---------------------------------------------------------------------------

_tls = threading.local()


def ambient_deadline_us() -> int:
    """The enclosing server request's absolute deadline (monotonic µs),
    or 0 when the current call stack is not under a deadline'd handler."""
    return getattr(_tls, "deadline_us", 0)


def ambient_remaining_ms() -> Optional[float]:
    """Remaining budget of the enclosing server request (may be ≤ 0:
    callers fail fast), or None outside a deadline'd handler."""
    d = ambient_deadline_us()
    if not d:
        return None
    return (d - monotonic_us()) / 1000.0


def cap_timeout_ms(timeout_ms: Optional[int]) -> Tuple[Optional[int], bool]:
    """Apply ambient inheritance to a client call's timeout: returns
    ``(effective_timeout_ms, expired)``.  Outside a deadline'd handler
    the timeout passes through.  Inside one, the call can never outlive
    the upstream budget — an unset/infinite timeout becomes the
    remaining budget, a longer one is clamped to it, and ``expired``
    is True when the budget is already gone (callers fail fast with
    ``ERPCTIMEDOUT`` instead of dispatching doomed work)."""
    amb = ambient_remaining_ms()
    if amb is None:
        return timeout_ms, False
    if amb <= 0:
        return 0, True
    cap = max(1, int(amb))
    if timeout_ms is None or timeout_ms <= 0 or timeout_ms > cap:
        return cap, False
    return timeout_ms, False


# ---------------------------------------------------------------------------
# retry hardening
# ---------------------------------------------------------------------------

class RetryBudget:
    """gRPC-style retry-throttling token bucket (the A6 retry design,
    same shape as brpc's RetryPolicy + CircuitBreaker pairing): a
    channel starts with ``max_tokens``; every retry or backup attempt
    COSTS one token and is denied when fewer than half the tokens
    remain; every successful response REFILLS ``token_ratio``.  Under a
    degraded backend the sustained retry rate is therefore bounded at
    ``token_ratio`` retries per successful call — a retry storm decays
    to ~1+ratio amplification instead of multiplying offered load by
    1+max_retry."""

    __slots__ = ("max_tokens", "token_ratio", "_tokens", "_lock",
                 "denied_count")

    def __init__(self, max_tokens: float = 10.0,
                 token_ratio: float = 0.1):
        self.max_tokens = float(max_tokens)
        self.token_ratio = float(token_ratio)
        self._tokens = float(max_tokens)
        self._lock = threading.Lock()
        self.denied_count = 0

    def acquire(self) -> bool:
        """Spend one token for a retry/backup attempt; False = the
        budget is exhausted and the attempt must NOT be sent."""
        with self._lock:
            if self._tokens > self.max_tokens / 2.0:
                self._tokens -= 1.0
                return True
            self.denied_count += 1
            return False

    def on_success(self) -> None:
        with self._lock:
            self._tokens = min(self.max_tokens,
                               self._tokens + self.token_ratio)

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


def backoff_ms(base_ms: int, nretry: int, max_ms: int = 5000,
               jitter: float = 0.2) -> float:
    """Exponential backoff with multiplicative jitter for retry attempt
    ``nretry`` (1-based): ``base * 2^(n-1)`` scaled by a uniform
    ±``jitter`` factor so synchronized clients don't re-storm in phase,
    then capped at ``max_ms`` (the cap is a hard bound operators size
    timeouts around — jitter never pierces it).  base_ms <= 0 disables
    (returns 0)."""
    if base_ms <= 0 or nretry <= 0:
        return 0.0
    d = float(base_ms * (1 << min(nretry - 1, 20)))
    if jitter > 0:
        from .butil.fast_rand import fast_rand
        u = (fast_rand() % 10_000) / 10_000.0       # [0, 1)
        d *= 1.0 - jitter + 2.0 * jitter * u        # [1-j, 1+j)
    return min(float(max_ms), d)


class inherit_deadline:
    """Context manager the dispatch paths wrap user code in: while the
    handler runs, its controller's deadline is the thread's ambient
    budget, consumed by the port's client launch path (``Channel``'s
    ``call_method``).  No-op (and no TLS write)
    when the request carries no deadline."""

    __slots__ = ("_d", "_prev")

    def __init__(self, cntl):
        self._d = getattr(cntl, "deadline_us", 0) or 0
        self._prev = 0

    def __enter__(self):
        if self._d:
            self._prev = getattr(_tls, "deadline_us", 0)
            _tls.deadline_us = self._d
        return self

    def __exit__(self, *exc):
        if self._d:
            _tls.deadline_us = self._prev
        return False
