"""LatencyRecorder — the composite every RPC method exposes
(≈ brpc's src/bvar/latency_recorder.h:75): windowed average
latency, max latency, qps, count, p50/p90/p99/p999.

Write path is FUSED: one thread-local agent carries (sum, num, max,
epoch-max, percentile reservoir), so recording a latency is a single TLS
lookup plus a handful of inline ops — not four separate reducer updates.
This matters because ``on_responded`` runs on every RPC: the reference's
IntRecorder/Percentile writes are tens of nanoseconds; the unfused
Python composite cost ~8µs/call, the fused one ~1µs.

Read path: lightweight component views subclass the plain reducer types
(IntRecorder/Maxer/Adder/Percentile) so the Window/PerSecond/sampler
machinery — which dispatches on isinstance and on the
get_sample/take_epoch_sample protocols — sees exactly the shapes it
expects while reading from the fused agents.

Epoch semantics: the per-second sampler drains epoch-max and the
reservoir with plain swaps (no per-update lock).  A sample landing
exactly on the swap boundary can miss one window bucket; cumulative
values (sum/num) never reset, so counts and averages are exact.

A copy of ``brpc_tpu/bvar/latency_recorder.py``.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from .percentile import (SAMPLES_PER_SECOND, SAMPLES_PER_THREAD,
                         GlobalSample, Percentile)
from .reducer import Adder, IntRecorder, Maxer
from .variable import Variable
from .window import PerSecond, Window

_NEG_INF = float("-inf")


class _LatAgent:
    __slots__ = ("sum", "num", "mx", "epoch_mx", "samples", "scount",
                 "rng", "thread")

    def __init__(self, thread):
        self.sum = 0.0
        self.num = 0
        self.mx = _NEG_INF           # all-time max
        self.epoch_mx = _NEG_INF     # max since the last sampler drain
        self.samples: List[float] = []
        self.scount = 0
        # inline xorshift64 state for reservoir sampling: a
        # fast_rand_less_than() call per update costs more than the
        # whole rest of the fused write path
        self.rng = (id(thread) ^ 0x9E3779B97F4A7C15) | 1
        self.thread = thread


class _FusedLatency(IntRecorder):
    """IntRecorder view over the fused agents (cumulative sum/num)."""

    def __init__(self, owner: "LatencyRecorder"):
        Variable.__init__(self)
        self._owner = owner

    def update(self, value):             # pragma: no cover - not the path
        self._owner.update(value)
        return self

    def get_sample(self) -> Tuple[float, int]:
        return self._owner._sum_num()

    def get_value(self) -> float:
        s, n = self._owner._sum_num()
        return (s / n) if n else 0.0

    @property
    def sum(self):
        return self._owner._sum_num()[0]

    @property
    def num(self):
        return self._owner._sum_num()[1]

    def average(self) -> float:
        return self.get_value()


class _FusedMax(Maxer):
    """Maxer view: all-time max reads, per-epoch drains for Windows."""

    # Window reads these off the reducer (window.py:27-28)
    _identity = _NEG_INF
    _op = staticmethod(lambda a, b: b if b > a else a)

    def __init__(self, owner: "LatencyRecorder"):
        Variable.__init__(self)
        self._owner = owner

    def update(self, value):             # pragma: no cover - not the path
        self._owner.update(value)
        return self

    def enable_window_mode(self) -> None:
        pass                 # epoch max is always maintained inline

    def get_value(self):
        o = self._owner
        mx = o._res_mx
        for a in o._agents_snapshot():
            if a.mx > mx:
                mx = a.mx
        return 0 if mx == _NEG_INF else mx

    def take_epoch_sample(self):
        o = self._owner
        cur = o._res_epoch_mx          # dead threads' un-drained maxima
        o._res_epoch_mx = _NEG_INF
        for a in o._agents_snapshot():
            v = a.epoch_mx
            a.epoch_mx = _NEG_INF
            if v > cur:
                cur = v
        if cur > o._res_mx:
            o._res_mx = cur
        return cur


class _FusedCount(Adder):
    """Adder view over the fused update count (drives the qps window)."""

    # Window reads these off the reducer (window.py:34-36)
    _identity = 0
    _op = staticmethod(lambda a, b: a + b)

    def __init__(self, owner: "LatencyRecorder"):
        Variable.__init__(self)
        self._owner = owner

    def update(self, value):             # pragma: no cover - not the path
        self._owner.update(value)
        return self

    def get_value(self) -> int:
        return self._owner._sum_num()[1]


class _FusedPercentile(Percentile):
    """Percentile whose per-second merge drains the fused reservoirs."""

    def __init__(self, owner: "LatencyRecorder"):
        self._owner = owner
        Percentile.__init__(self)

    def update(self, value):             # pragma: no cover - not the path
        self._owner.update(value)
        return self

    def take_sample(self) -> None:
        o = self._owner
        merged = o._res_samples        # dead threads' un-drained samples
        o._res_samples = []
        count = o._res_scount
        o._res_scount = 0
        for a in o._agents_snapshot():
            s = a.samples
            a.samples = []
            c = a.scount
            a.scount = 0
            merged.extend(s)
            count += c
        if len(merged) > SAMPLES_PER_SECOND:
            step = len(merged) / SAMPLES_PER_SECOND
            merged = [merged[int(i * step)]
                      for i in range(SAMPLES_PER_SECOND)]
        with self._ring_lock:
            self._ring.push_force(GlobalSample(merged, count))


class LatencyRecorder(Variable):
    def __init__(self, name: Optional[str] = None, window_size: int = 10):
        super().__init__()
        self._tls = threading.local()
        self._agents: List[_LatAgent] = []
        self._agents_lock = threading.Lock()
        self._res_sum = 0.0
        self._res_num = 0
        self._res_mx = _NEG_INF
        # un-drained window data folded out of dead threads' agents:
        # consumed (and cleared) by the next epoch/percentile drain so a
        # thread dying mid-window loses nothing
        self._res_epoch_mx = _NEG_INF
        self._res_samples: List[float] = []
        self._res_scount = 0
        self._latency = _FusedLatency(self)
        self._max_latency = _FusedMax(self)
        self._count = _FusedCount(self)
        self._percentile = _FusedPercentile(self)
        self._latency_window = Window(self._latency, window_size)
        self._max_window = Window(self._max_latency, window_size)
        self._qps = PerSecond(self._count, window_size)
        self.window_size = window_size
        if name:
            self.expose(name)

    # -- fused write path --------------------------------------------------

    def update(self, latency_us: float) -> "LatencyRecorder":
        try:
            a = self._tls.a
        except AttributeError:
            a = _LatAgent(threading.current_thread())
            with self._agents_lock:
                self._agents.append(a)
            self._tls.a = a
        a.sum += latency_us
        a.num += 1
        if latency_us > a.mx:
            a.mx = latency_us
        if latency_us > a.epoch_mx:
            a.epoch_mx = latency_us
        n = a.scount + 1
        a.scount = n
        s = a.samples
        if len(s) < SAMPLES_PER_THREAD:
            s.append(latency_us)
        else:
            r = a.rng
            r ^= (r << 13) & 0xFFFFFFFFFFFFFFFF
            r ^= r >> 7
            r ^= (r << 17) & 0xFFFFFFFFFFFFFFFF
            a.rng = r
            idx = r % n                      # reservoir: uniform keep
            if idx < SAMPLES_PER_THREAD:
                s[idx] = latency_us
        return self

    def __lshift__(self, latency_us: float) -> "LatencyRecorder":
        return self.update(latency_us)

    # -- agent bookkeeping -------------------------------------------------

    def _agents_snapshot(self) -> List[_LatAgent]:
        with self._agents_lock:
            return list(self._agents)

    def _sum_num(self) -> Tuple[float, int]:
        """Cumulative (sum, num) over residual + live agents; folds dead
        threads' agents into the residual (values are never lost)."""
        s = self._res_sum
        n = self._res_num
        dead: List[_LatAgent] = []
        for a in self._agents_snapshot():
            s += a.sum
            n += a.num
            if not a.thread.is_alive():
                dead.append(a)
        if dead:
            with self._agents_lock:
                for a in dead:
                    if a in self._agents:
                        self._res_sum += a.sum
                        self._res_num += a.num
                        if a.mx > self._res_mx:
                            self._res_mx = a.mx
                        # keep the agent's un-drained window data for the
                        # next sampler drain (dropping it here silently
                        # zeroed windowed max/percentiles on thread churn)
                        if a.epoch_mx > self._res_epoch_mx:
                            self._res_epoch_mx = a.epoch_mx
                        self._res_samples.extend(a.samples)
                        self._res_scount += a.scount
                        self._agents.remove(a)
        return s, n

    # -- views --

    def latency(self) -> float:
        """Windowed average latency (us)."""
        return self._latency_window.get_value()

    def max_latency(self) -> float:
        return self._max_window.get_value()

    def qps(self) -> float:
        return self._qps.get_value()

    def count(self) -> int:
        return self._sum_num()[1]

    def latency_percentile(self, fraction: float) -> float:
        return self._percentile.get_number(fraction, self.window_size)

    def p50(self) -> float:
        return self.latency_percentile(0.5)

    def p90(self) -> float:
        return self.latency_percentile(0.9)

    def p99(self) -> float:
        return self.latency_percentile(0.99)

    def p999(self) -> float:
        return self.latency_percentile(0.999)

    def get_value(self):
        return self.latency()

    def describe(self) -> str:
        return (f"latency={self.latency():.0f} max={self.max_latency():.0f} "
                f"qps={self.qps():.1f} count={self.count()} "
                f"p99={self.p99():.0f}")

    def expose(self, name: str, prefix: str = "") -> bool:
        """Expose the composite's sub-views too (latency/qps/count/...)."""
        ok = super().expose(name, prefix)
        if ok and self._name:
            base = self._name
            self._latency_window.expose(f"{base}_latency")
            self._max_window.expose(f"{base}_max_latency")
            self._qps.expose(f"{base}_qps")
            self._count.expose(f"{base}_count")
        return ok
