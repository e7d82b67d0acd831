"""Thread-local-aggregated reducers (≈ brpc's src/bvar/reducer.h).

Write path is O(1) on a per-thread agent with no shared mutation; the read
path walks all agents and combines.  Agents of dead threads fold into a
residual at read time, so values are never lost to thread churn
(the reference's AgentGroup + combiner, src/bvar/detail/agent_group.h:51).

A copy of ``brpc_tpu/bvar/reducer.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from .variable import Variable


class _Agent:
    __slots__ = ("value", "thread", "lock")

    def __init__(self, identity, thread):
        self.value = identity
        self.thread = thread
        # taken only in window mode (extremum windows): the sampler
        # reads-and-resets under the same lock writers combine under, so
        # no update can fall between two sampling epochs and vanish
        self.lock = threading.Lock()


class Reducer(Variable):
    """Combine per-thread values with an associative op."""

    def __init__(self, identity, op: Callable, name: Optional[str] = None):
        super().__init__()
        self._identity = identity
        self._op = op
        self._agents: List[_Agent] = []
        self._agents_lock = threading.Lock()
        self._residual = identity
        self._tls = threading.local()
        # Window-of-extremum support: when a Window attaches to a Maxer/
        # Miner it flips window-mode on; the sampler then drains (reads and
        # resets) agents each second, and drained values fold into
        # _residual so get_value() stays the all-time extremum.
        self._window_mode = False
        if name:
            self.expose(name)

    def _my_agent(self) -> _Agent:
        agent = getattr(self._tls, "agent", None)
        if agent is None:
            agent = _Agent(self._identity, threading.current_thread())
            with self._agents_lock:
                self._agents.append(agent)
            self._tls.agent = agent
        return agent

    def update(self, value) -> "Reducer":
        """O(1), contention-free: only touches this thread's agent.
        (Window mode adds an uncontended per-agent lock acquire.)"""
        agent = self._my_agent()
        if not self._window_mode:
            agent.value = self._op(agent.value, value)
            return self
        with agent.lock:
            agent.value = self._op(agent.value, value)
        return self

    def __lshift__(self, value) -> "Reducer":  # adder << 1, like the reference
        return self.update(value)

    def get_value(self):
        result = self._residual
        dead: List[_Agent] = []
        with self._agents_lock:
            agents = list(self._agents)
        for agent in agents:
            result = self._op(result, agent.value)
            if not agent.thread.is_alive():
                dead.append(agent)
        if dead:
            with self._agents_lock:
                for agent in dead:
                    if agent in self._agents:
                        self._residual = self._op(self._residual, agent.value)
                        self._agents.remove(agent)
        return result

    def enable_window_mode(self) -> None:
        self._window_mode = True

    def take_epoch_sample(self):
        """Close the current epoch: drain (read + reset) every agent under
        its lock and return the combined value.  Called by the sampler
        thread once per second in window mode.  Drained values fold into
        the residual so the plain ``get_value()`` remains the all-time
        aggregate."""
        cur = self._identity
        with self._agents_lock:
            for agent in self._agents:
                with agent.lock:
                    cur = self._op(cur, agent.value)
                    agent.value = self._identity
            self._residual = self._op(self._residual, cur)
            self._agents = [a for a in self._agents if a.thread.is_alive()]
        return cur


class Adder(Reducer):
    """adder << n; value = sum (≈ bvar::Adder, reducer.h:264)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(0, lambda a, b: a + b, name)


class Maxer(Reducer):
    """value = max (≈ bvar::Maxer, reducer.h:302)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(float("-inf"), lambda a, b: b if b > a else a, name)

    def get_value(self):
        v = super().get_value()
        return 0 if v == float("-inf") else v


class Miner(Reducer):
    """value = min (≈ bvar::Miner, reducer.h:352)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(float("inf"), lambda a, b: b if b < a else a, name)

    def get_value(self):
        v = super().get_value()
        return 0 if v == float("inf") else v


class IntRecorder(Variable):
    """Average of ints (≈ bvar::IntRecorder, recorder.h:84). The reference
    compresses (sum,num) into one int64 for atomicity; here each thread owns
    a (sum, num) pair and read-side merges."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self._sum = Adder()
        self._num = Adder()
        if name:
            self.expose(name)

    def update(self, value) -> "IntRecorder":
        self._sum.update(value)
        self._num.update(1)
        return self

    def __lshift__(self, value) -> "IntRecorder":
        return self.update(value)

    def average(self) -> float:
        n = self._num.get_value()
        return (self._sum.get_value() / n) if n else 0.0

    @property
    def sum(self):
        return self._sum.get_value()

    @property
    def num(self):
        return self._num.get_value()

    def get_value(self):
        return self.average()

    def get_sample(self) -> Tuple[int, int]:
        """(sum, num) cumulative snapshot for windowed delta sampling."""
        return self._sum.get_value(), self._num.get_value()
