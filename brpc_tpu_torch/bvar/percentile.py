"""Percentile estimation (≈ brpc's src/bvar/detail/percentile.h).

Writes go to a per-thread bounded reservoir (no shared contention); the
sampler thread merges thread reservoirs into a per-second GlobalSample ring;
queries merge the last W seconds of global samples and read the quantile.

A copy of ``brpc_tpu/bvar/percentile.py``.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from ..butil.fast_rand import fast_rand_less_than
from ..butil.flat_map import BoundedQueue
from .sampler import Sampler, add_sampler
from .variable import Variable

SAMPLES_PER_THREAD = 254          # reference: PercentileInterval<254>
SAMPLES_PER_SECOND = 1024         # merged global reservoir size


class _ThreadReservoir:
    __slots__ = ("samples", "count", "thread")

    def __init__(self, thread):
        self.samples: List[float] = []
        self.count = 0
        self.thread = thread

    def add(self, value: float) -> None:
        self.count += 1
        if len(self.samples) < SAMPLES_PER_THREAD:
            self.samples.append(value)
        else:
            # reservoir sampling keeps the sample set uniform
            idx = fast_rand_less_than(self.count)
            if idx < SAMPLES_PER_THREAD:
                self.samples[idx] = value


class GlobalSample:
    __slots__ = ("samples", "count")

    def __init__(self, samples: List[float], count: int):
        self.samples = samples
        self.count = count


class Percentile(Variable, Sampler):
    def __init__(self, name: Optional[str] = None):
        Variable.__init__(self)
        self._tls = threading.local()
        self._reservoirs: List[_ThreadReservoir] = []
        self._lock = threading.Lock()
        self._ring = BoundedQueue(120)
        self._ring_lock = threading.Lock()
        add_sampler(self)
        if name:
            self.expose(name)

    def update(self, value: float) -> "Percentile":
        r = getattr(self._tls, "r", None)
        if r is None:
            r = _ThreadReservoir(threading.current_thread())
            with self._lock:
                self._reservoirs.append(r)
            self._tls.r = r
        r.add(value)
        return self

    def __lshift__(self, value: float) -> "Percentile":
        return self.update(value)

    def take_sample(self) -> None:
        """Merge all thread reservoirs into one per-second global sample."""
        merged: List[float] = []
        count = 0
        with self._lock:
            reservoirs = list(self._reservoirs)
            for r in reservoirs:
                merged.extend(r.samples)
                count += r.count
                r.samples = []
                r.count = 0
            self._reservoirs = [r for r in self._reservoirs
                                if r.thread.is_alive()]
        if len(merged) > SAMPLES_PER_SECOND:
            step = len(merged) / SAMPLES_PER_SECOND
            merged = [merged[int(i * step)] for i in range(SAMPLES_PER_SECOND)]
        with self._ring_lock:
            self._ring.push_force(GlobalSample(merged, count))

    def get_number(self, fraction: float, window_size: int = 10) -> float:
        """Quantile over the last window_size seconds of samples."""
        with self._ring_lock:
            recent = self._ring.snapshot()[-window_size:]
        samples: List[float] = []
        for gs in recent:
            samples.extend(gs.samples)
        if not samples:
            return 0.0
        samples.sort()
        idx = min(len(samples) - 1, int(fraction * len(samples)))
        return samples[idx]

    def get_value(self):
        return self.get_number(0.5)
