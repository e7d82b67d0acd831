"""Builtin load-balancing policies, registered on import
(≈ brpc's src/brpc/global.cpp:368-376):

- ``rr`` / ``wrr``           round robin (+weighted by tag "w=N")
- ``random`` / ``wr``        (weighted) random
- ``c_murmurhash`` / ``c_md5``  consistent hashing (ketama ring,
  brpc's src/brpc/policy/consistent_hashing_load_balancer.cpp)
- ``la``                     locality-aware: lowest expected latency with
  inflight punishment (policy/locality_aware_load_balancer.h:41-80,
  docs/cn/lalb.md — algorithm shape, fresh implementation)

A copy of ``brpc_tpu/policy/load_balancers.py``.
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

from ..butil.endpoint import EndPoint
from ..butil.fast_rand import fast_rand
from ..client.load_balancer import LoadBalancer, lb_registry
from ..client.naming_service import ServerNode


def _weight_of(node: ServerNode) -> int:
    for part in node.tag.split():
        if part.startswith("w="):
            try:
                return max(1, int(part[2:]))
            except ValueError:
                return 1
    return 1


class RoundRobinLB(LoadBalancer):
    def __init__(self):
        super().__init__()
        self._counter = itertools.count()

    def select(self, nodes, cntl):
        return nodes[next(self._counter) % len(nodes)]


class WeightedRoundRobinLB(LoadBalancer):
    def __init__(self):
        super().__init__()
        self._counter = itertools.count()
        self._cache_lock = threading.Lock()
        self._cache_src: Optional[tuple] = None
        self._cycle: List[ServerNode] = []

    def _expanded(self, nodes) -> List[ServerNode]:
        key = tuple(id(n) for n in nodes)
        with self._cache_lock:
            if key != self._cache_src:
                cycle: List[ServerNode] = []
                for n in nodes:
                    cycle.extend([n] * _weight_of(n))
                self._cache_src = key
                self._cycle = cycle
            return self._cycle

    def select(self, nodes, cntl):
        cycle = self._expanded(nodes)
        return cycle[next(self._counter) % len(cycle)]


class RandomLB(LoadBalancer):
    def select(self, nodes, cntl):
        return nodes[fast_rand() % len(nodes)]


class WeightedRandomLB(LoadBalancer):
    def select(self, nodes, cntl):
        weights = [_weight_of(n) for n in nodes]
        total = sum(weights)
        pick = fast_rand() % total
        for n, w in zip(nodes, weights):
            if pick < w:
                return n
            pick -= w
        return nodes[-1]


class ConsistentHashLB(LoadBalancer):
    """Ketama ring with virtual replicas; the key is the call's
    ``request_code`` (set by the user, ≈ cntl.set_request_code)."""

    REPLICAS = 100

    def __init__(self, hasher: str = "murmurhash"):
        super().__init__()
        self._hasher = hasher
        self._ring_lock = threading.Lock()
        self._ring_src: Optional[tuple] = None
        self._ring: List[int] = []
        self._ring_nodes: List[ServerNode] = []

    def _hash(self, data: bytes) -> int:
        if self._hasher == "md5":
            return int.from_bytes(hashlib.md5(data).digest()[:8], "little")
        # murmur-shaped 64-bit mix (fresh implementation)
        h = 0xC6A4A7935BD1E995
        for b in data:
            h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
            h ^= h >> 29
        return h

    def _build_ring(self, nodes):
        key = tuple(str(n) for n in nodes)
        with self._ring_lock:
            if key == self._ring_src:
                return self._ring, self._ring_nodes
            points: List[tuple] = []
            for n in nodes:
                base = str(n.endpoint).encode()
                for r in range(self.REPLICAS * _weight_of(n)):
                    points.append((self._hash(base + b"#%d" % r), n))
            points.sort(key=lambda p: p[0])
            self._ring = [p[0] for p in points]
            self._ring_nodes = [p[1] for p in points]
            self._ring_src = key
            return self._ring, self._ring_nodes

    def select(self, nodes, cntl):
        ring, ring_nodes = self._build_ring(nodes)
        if not ring:
            return None
        code = getattr(cntl, "request_code", 0) or 0
        h = self._hash(int(code).to_bytes(8, "little"))
        idx = bisect.bisect_left(ring, h) % len(ring)
        return ring_nodes[idx]


class WeightTree:
    """Fenwick (binary-indexed) tree over node weights with O(log n)
    update and O(log n) weighted-random pick — the reference's
    locality-aware weight tree shape
    (brpc's src/brpc/policy/locality_aware_load_balancer.h:41-80)
    re-expressed: total() is the root sum, pick descends by prefix sums.
    """

    def __init__(self, n: int = 0):
        self._n = 0
        self._bit: List[float] = []
        self._w: List[float] = []
        if n:
            self.resize(n)

    def resize(self, n: int) -> None:
        self._n = n
        self._bit = [0.0] * (n + 1)
        self._w = [0.0] * n

    def update(self, i: int, w: float) -> None:
        delta = w - self._w[i]
        if delta == 0.0:
            return
        self._w[i] = w
        j = i + 1
        while j <= self._n:
            self._bit[j] += delta
            j += j & (-j)

    def weight(self, i: int) -> float:
        return self._w[i]

    def total(self) -> float:
        return self._prefix(self._n)

    def _prefix(self, j: int) -> float:
        s = 0.0
        while j > 0:
            s += self._bit[j]
            j -= j & (-j)
        return s

    def pick(self, r: float) -> int:
        """Index i such that prefix(i) <= r < prefix(i+1); O(log n)
        Fenwick descent."""
        pos = 0
        mask = 1
        while mask * 2 <= self._n:
            mask *= 2
        while mask:
            nxt = pos + mask
            if nxt <= self._n and self._bit[nxt] <= r:
                pos = nxt
                r -= self._bit[nxt]
            mask //= 2
        return min(pos, self._n - 1)


class LocalityAwareLB(LoadBalancer):
    """Weighted-random by expected goodness: weight =
    1 / (ema_latency_us * (1 + inflight * punish)), maintained in a
    Fenwick weight tree so select and feedback are O(log n) — the shape
    that survives pod-scale server lists
    (≈ locality_aware_load_balancer.h:41-80)."""

    PUNISH = 0.5
    ALPHA = 0.2
    DEFAULT_LATENCY_US = 50_000.0

    def __init__(self):
        super().__init__()
        self._stat_lock = threading.Lock()
        self._lat: Dict[EndPoint, float] = {}
        self._inflight: Dict[EndPoint, int] = {}
        self._tree = WeightTree()
        self._eps: List[EndPoint] = []
        self._index: Dict[EndPoint, int] = {}
        self._by_ep: Dict[EndPoint, Any] = {}

    def _weight_of(self, ep: EndPoint) -> float:
        lat = self._lat.get(ep, self.DEFAULT_LATENCY_US)
        inflight = self._inflight.get(ep, 0)
        return 1e9 / (lat * (1.0 + inflight * self.PUNISH))

    def _rebuild_locked(self, nodes) -> None:
        self._eps = [n.endpoint for n in nodes]
        self._index = {ep: i for i, ep in enumerate(self._eps)}
        self._by_ep = {n.endpoint: n for n in nodes}
        self._tree.resize(len(self._eps))
        for i, ep in enumerate(self._eps):
            self._tree.update(i, self._weight_of(ep))

    def _bump_locked(self, ep: EndPoint) -> None:
        i = self._index.get(ep)
        if i is not None:
            self._tree.update(i, self._weight_of(ep))

    def select(self, nodes, cntl):
        with self._stat_lock:
            if len(nodes) != len(self._eps) or any(
                    n.endpoint not in self._index for n in nodes):
                self._rebuild_locked(nodes)
            total = self._tree._prefix(self._tree._n)
            if total <= 0:
                best = nodes[fast_rand() % len(nodes)]
            else:
                # a few weighted draws tolerate per-call exclusions
                # without rebuilding the tree
                excluded = getattr(cntl, "excluded_servers", None) or ()
                best = None
                for _ in range(4):
                    r = (fast_rand() % (1 << 30)) / float(1 << 30) * total
                    ep = self._eps[self._tree.pick(r)]
                    if ep not in excluded:
                        best = self._by_ep.get(ep)
                        break
                if best is None:
                    best = nodes[fast_rand() % len(nodes)]
            ep = best.endpoint
            self._inflight[ep] = self._inflight.get(ep, 0) + 1
            self._bump_locked(ep)
        return best

    def on_feedback(self, cntl):
        ep = cntl.remote_side
        # every attempt's select() incremented inflight; decrement them
        # all (retried calls touched several servers)
        attempts = list(getattr(cntl, "attempt_remotes", {}).values()) \
            or [ep]
        with self._stat_lock:
            for aep in attempts:
                n = self._inflight.get(aep, 0)
                if n > 0:
                    self._inflight[aep] = n - 1
                self._bump_locked(aep)
            if cntl.error_code == 0:
                prev = self._lat.get(ep, self.DEFAULT_LATENCY_US)
                self._lat[ep] = prev + (cntl.latency_us - prev) * self.ALPHA
            else:
                # failures look slow: steer away without a hard ban
                # (the breaker handles hard isolation)
                prev = self._lat.get(ep, self.DEFAULT_LATENCY_US)
                self._lat[ep] = prev * 1.5
            self._bump_locked(ep)


class DynPartLB(LoadBalancer):
    """Weighted-random by declared node weight
    (≈ brpc's src/brpc/policy/dynpart_load_balancer.cpp, which
    weights partitioned sub-channels by capacity): a node's ``w=<n>``
    tag token sets its weight (default 1), so heterogeneous partitions
    of a dynamically re-partitioning cluster receive proportional
    traffic."""

    @staticmethod
    def _weight(node) -> int:
        for token in (node.tag or "").split():
            if token.startswith("w="):
                try:
                    return max(0, int(token[2:]))
                except ValueError:
                    return 1
        return 1

    def select(self, nodes, cntl):
        total = sum(self._weight(n) for n in nodes)
        if total <= 0:
            return nodes[fast_rand() % len(nodes)]
        r = fast_rand() % total
        for n in nodes:
            r -= self._weight(n)
            if r < 0:
                return n
        return nodes[-1]


lb_registry().register("rr", RoundRobinLB)
lb_registry().register("dynpart", DynPartLB)
lb_registry().register("wrr", WeightedRoundRobinLB)
lb_registry().register("random", RandomLB)
lb_registry().register("wr", WeightedRandomLB)
lb_registry().register("c_murmurhash", ConsistentHashLB)
lb_registry().register("c_md5", lambda: ConsistentHashLB("md5"))
lb_registry().register("la", LocalityAwareLB)
