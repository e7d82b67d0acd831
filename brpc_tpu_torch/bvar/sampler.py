"""The sampling thread (≈ brpc's src/bvar/detail/sampler.cpp).

One global daemon thread wakes every second and calls ``take_sample()`` on
every registered sampler.  Windows/PerSecond/Percentile build on the sampled
rings.  Tests can call :func:`tick_once_for_tests` to advance time
deterministically instead of sleeping.

A copy of ``brpc_tpu/bvar/sampler.py``.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import List, Optional

from ..butil.flat_map import BoundedQueue

SAMPLE_INTERVAL_S = 1.0


class Sampler:
    def take_sample(self) -> None:
        raise NotImplementedError


class _SamplerThread:
    """Holds samplers by weakref: a Window/Percentile that is dropped by
    its owner disappears from the schedule automatically — no unbounded
    growth of per-second work (the reference destroys samplers explicitly;
    GC is the Python-idiomatic equivalent)."""

    def __init__(self):
        self._samplers: List[weakref.ref] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._manual = False     # tests drive ticks; background thread idles
        self.rounds = 0

    def add(self, s: Sampler) -> None:
        with self._lock:
            self._samplers.append(weakref.ref(s))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="bvar_sampler", daemon=True)
                self._thread.start()

    def remove(self, s: Sampler) -> None:
        with self._lock:
            self._samplers = [r for r in self._samplers
                              if r() is not None and r() is not s]

    def tick(self) -> None:
        with self._lock:
            live = []
            samplers = []
            for r in self._samplers:
                s = r()
                if s is not None:
                    live.append(r)
                    samplers.append(s)
            self._samplers = live
        for s in samplers:
            try:
                s.take_sample()
            except Exception:
                pass
        self.rounds += 1

    def _run(self) -> None:
        while not self._stop.wait(SAMPLE_INTERVAL_S):
            if not self._manual:
                self.tick()


_sampler_thread = _SamplerThread()


def add_sampler(s: Sampler) -> None:
    _sampler_thread.add(s)


def remove_sampler(s: Sampler) -> None:
    _sampler_thread.remove(s)


def tick_once_for_tests() -> None:
    """Deterministically run one sampling round. The first call switches
    the process to manual sampling (the background thread stops ticking)
    so test windows can't be double-sampled by the 1s daemon."""
    _sampler_thread._manual = True
    _sampler_thread.tick()


def _sub(a, b):
    if isinstance(a, tuple):
        return tuple(x - y for x, y in zip(a, b))
    return a - b


_shared_sampler_lock = threading.Lock()


class ReducerSampler(Sampler):
    """Samples a reducer every second into a bounded ring.

    - For cumulative reducers (Adder/IntRecorder), stores per-second deltas
      computed by subtracting consecutive cumulative snapshots — the reducer
      itself is never reset, so cumulative reads (count()) stay valid.
    - For extremum reducers (Maxer/Miner), stores the per-epoch extremum
      via the reducer's epoch protocol (agents restart each second), so a
      windowed max really is the max over the window, while the reducer's
      own get_value() stays the all-time extremum.
    """

    MAX_WINDOW = 120

    def __init__(self, reducer, use_delta: bool):
        self._reducer = reducer
        self._use_delta = use_delta
        self._epoch_mode = (not use_delta) and hasattr(reducer, "take_epoch_sample")
        if self._epoch_mode:
            reducer.enable_window_mode()
        self._sample_fn = getattr(reducer, "get_sample", reducer.get_value)
        self._last = self._sample_fn() if use_delta else None
        self._ring = BoundedQueue(self.MAX_WINDOW)
        self._ring_lock = threading.Lock()
        add_sampler(self)

    @staticmethod
    def shared_for(reducer, use_delta: bool) -> "ReducerSampler":
        """One sampler per reducer (as in the reference): multiple Windows
        over the same reducer must share the ring — a second epoch-mode
        sampler would close every epoch twice and read zeros."""
        with _shared_sampler_lock:
            s = getattr(reducer, "_shared_sampler", None)
            if s is None:
                s = ReducerSampler(reducer, use_delta)
                reducer._shared_sampler = s
        return s

    def take_sample(self) -> None:
        if self._use_delta:
            cur = self._sample_fn()
            value = _sub(cur, self._last)
            self._last = cur
        elif self._epoch_mode:
            value = self._reducer.take_epoch_sample()
        else:
            value = self._sample_fn()
        with self._ring_lock:
            self._ring.push_force(value)

    def last_n(self, n: int) -> list:
        """Most recent up-to-n samples (oldest first)."""
        with self._ring_lock:
            items = self._ring.snapshot()
        return items[-n:]
