"""Window / PerSecond views over reducers
(≈ brpc's src/bvar/window.h:43,174).

``Window(adder, 10)`` = value accumulated over the last 10 seconds.
``PerSecond(adder, 10)`` = that / 10.

A copy of ``brpc_tpu/bvar/window.py``.
"""

from __future__ import annotations

from typing import Optional

from .reducer import Adder, Maxer, Miner, IntRecorder, Reducer
from .sampler import ReducerSampler
from .variable import Variable


class Window(Variable):
    def __init__(self, reducer, window_size: int = 10,
                 name: Optional[str] = None):
        super().__init__()
        if window_size <= 0 or window_size > ReducerSampler.MAX_WINDOW:
            raise ValueError(f"window_size must be in [1, {ReducerSampler.MAX_WINDOW}]")
        self._reducer = reducer
        self.window_size = window_size
        if isinstance(reducer, (Maxer, Miner)):
            self._use_delta = False
            self._combine = reducer._op
            self._identity = reducer._identity
        elif isinstance(reducer, IntRecorder):
            self._use_delta = True
            self._combine = lambda a, b: (a[0] + b[0], a[1] + b[1])
            self._identity = (0, 0)
        else:
            self._use_delta = True
            self._combine = reducer._op
            self._identity = reducer._identity
        self._sampler = ReducerSampler.shared_for(reducer, self._use_delta)
        if name:
            self.expose(name)

    def get_value(self):
        samples = self._sampler.last_n(self.window_size)
        acc = self._identity
        for s in samples:
            acc = self._combine(acc, s)
        if isinstance(self._reducer, IntRecorder):
            s, n = acc
            return (s / n) if n else 0.0
        if isinstance(self._reducer, Maxer) and acc == float("-inf"):
            return 0
        if isinstance(self._reducer, Miner) and acc == float("inf"):
            return 0
        return acc


class PerSecond(Window):
    """Average per-second rate over the window (≈ bvar::PerSecond)."""

    def get_value(self):
        samples = self._sampler.last_n(self.window_size)
        if not samples:
            return 0
        acc = self._identity
        for s in samples:
            acc = self._combine(acc, s)
        return acc / len(samples)
