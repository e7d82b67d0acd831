"""Concurrency limiters
(≈ brpc's src/brpc/concurrency_limiter.h:29-52 and
policy/auto_concurrency_limiter.h:28,55-63):

- **constant**: fixed in-flight cap ("constant:100" or an int);
- **auto**: gradient/Vegas-style adaptive limit — tracks a smoothed
  no-load latency estimate; when recent latency inflates beyond it the
  limit shrinks, when the pipeline is full and latency is flat it grows.
  Fresh implementation of the reference's algorithm *shape* (EMA minimum
  latency + qps-driven limit), not its code;
- **timeout**: as many requests as still fit in a latency budget.

A copy of ``brpc_tpu/policy/concurrency_limiter.py``, whole.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional


class ConcurrencyLimiter:
    """Plugin interface: max_concurrency() read per-request;
    on_responded(error_code, latency_us) feeds the controller."""

    kind = "custom"          # portal label ("auto"/"timeout"/"constant")

    def max_concurrency(self) -> int:
        raise NotImplementedError

    def on_responded(self, error_code: int, latency_us: float) -> None:
        pass


class ConstantLimiter(ConcurrencyLimiter):
    kind = "constant"

    def __init__(self, limit: int):
        self._limit = int(limit)

    def max_concurrency(self) -> int:
        return self._limit


class AutoLimiter(ConcurrencyLimiter):
    """Adaptive limit ≈ auto_concurrency_limiter.h: sampling windows of
    (qps, latency); min-latency EMA as the no-load estimate; limit =
    peak_qps × min_latency × (1 + alpha) with shrink on latency blow-up."""

    kind = "auto"

    def __init__(self,
                 min_limit: int = 8,
                 max_limit: int = 4096,
                 sample_window_s: float = 0.1,
                 min_sample_count: int = 50,
                 alpha_factor: float = 0.3):
        self._lock = threading.Lock()
        self._limit = min_limit * 4
        self._min_limit = min_limit
        self._max_limit = max_limit
        self._window_s = sample_window_s
        self._min_samples = min_sample_count
        self._alpha = alpha_factor
        self._win_start = time.monotonic()
        self._win_count = 0
        self._win_err = 0
        self._win_lat_sum = 0.0
        self._nolat_ema: Optional[float] = None   # no-load latency (us)
        self._peak_qps = 0.0

    def max_concurrency(self) -> int:
        return self._limit

    def on_responded(self, error_code: int, latency_us: float) -> None:
        with self._lock:
            self._win_count += 1
            if error_code != 0:
                self._win_err += 1
            else:
                self._win_lat_sum += latency_us
            now = time.monotonic()
            dt = now - self._win_start
            if dt < self._window_s or self._win_count < self._min_samples:
                return
            ok = self._win_count - self._win_err
            if ok > 0:
                avg_lat = self._win_lat_sum / ok
                qps = ok / dt
                self._peak_qps = max(self._peak_qps * 0.98, qps)
                if self._nolat_ema is None or avg_lat < self._nolat_ema:
                    self._nolat_ema = avg_lat
                elif avg_lat <= self._nolat_ema * (1.0 + self._alpha):
                    # quiet window: drift up slowly so the estimate can
                    # track a genuinely shifted baseline.  An OVERLOADED
                    # window must NOT meaningfully feed the no-load
                    # estimate — that drift would launder queueing delay
                    # into "normal" and the limit would never shrink
                    # under sustained overload (the reference
                    # re-measures min latency in non-overloaded windows
                    # for the same reason)
                    self._nolat_ema += (avg_lat - self._nolat_ema) * 0.02
                else:
                    # overloaded window: a 20x-slower RE-MEASUREMENT
                    # path so the estimate is not frozen forever when
                    # the baseline genuinely shifted past (1+alpha)x
                    # (slower dependency, not queueing) — a real shift
                    # re-learns over ~hundreds of windows, while
                    # transient overload moves the estimate by well
                    # under a percent before the shrink drains it
                    self._nolat_ema += (avg_lat - self._nolat_ema) * 0.001
                base = self._peak_qps * (self._nolat_ema / 1e6)
                if avg_lat > self._nolat_ema * (1.0 + self._alpha):
                    # overload: shrink — with peak_qps decaying 2% per
                    # window, sustained overload keeps ratcheting the
                    # limit down until latency returns to baseline
                    new_limit = base * (1.0 - self._alpha / 2)
                else:
                    new_limit = base * (1.0 + self._alpha)
                self._limit = int(min(self._max_limit,
                                      max(self._min_limit,
                                          math.ceil(new_limit))))
            self._win_start = now
            self._win_count = 0
            self._win_err = 0
            self._win_lat_sum = 0.0


class TimeoutLimiter(ConcurrencyLimiter):
    """Timeout-driven limit
    (≈ brpc's src/brpc/policy/timeout_concurrency_limiter.h):
    admit only as many requests as can still finish inside the timeout
    budget — max_concurrency = timeout / avg_latency.  A latency EMA
    (failures counted at the full timeout) drives the bound, so a slow
    backend sheds load it could never answer in time instead of queueing
    doomed requests."""

    kind = "timeout"

    def __init__(self, timeout_ms: float = 500.0,
                 min_limit: int = 2, max_limit: int = 4096,
                 alpha: float = 0.2):
        self._timeout_us = max(1.0, timeout_ms * 1000.0)
        self._min = min_limit
        self._max = max_limit
        self._alpha = alpha
        self._lock = threading.Lock()
        self._lat_ema: Optional[float] = None
        self._limit = max_limit

    def max_concurrency(self) -> int:
        return self._limit

    def on_responded(self, error_code: int, latency_us: float) -> None:
        with self._lock:
            sample = latency_us if error_code == 0 else self._timeout_us
            if self._lat_ema is None:
                self._lat_ema = float(sample)
            else:
                self._lat_ema += (sample - self._lat_ema) * self._alpha
            self._limit = int(min(self._max, max(
                self._min, self._timeout_us / max(1.0, self._lat_ema))))


def make_limiter(spec) -> Optional[ConcurrencyLimiter]:
    """Parse an AdaptiveMaxConcurrency-style spec
    (≈ src/brpc/adaptive_max_concurrency.h): int / "constant:N" /
    "auto" / "timeout[:ms]" / "unlimited"."""
    if spec is None:
        return None
    if isinstance(spec, int):
        return ConstantLimiter(spec) if spec > 0 else None
    s = str(spec).strip().lower()
    if s in ("", "unlimited", "0"):
        return None
    if s == "auto":
        return AutoLimiter()
    if s == "timeout":
        return TimeoutLimiter()
    if s.startswith("timeout:"):
        return TimeoutLimiter(float(s.split(":", 1)[1]))
    if s.startswith("constant:"):
        return ConstantLimiter(int(s.split(":", 1)[1]))
    if s.isdigit():
        return ConstantLimiter(int(s))
    raise ValueError(f"unknown concurrency limiter spec: {spec!r}")
