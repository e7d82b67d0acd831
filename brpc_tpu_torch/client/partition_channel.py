"""PartitionChannel — key-space sharding over a tagged cluster.

≈ brpc's src/brpc/partition_channel.h:46,75,136: servers publish
partition tags ``i/N`` through the naming service; the channel builds one
sub-channel per partition (each load-balancing over that partition's
replicas) and fans a call out to all partitions, merging responses.
DynamicPartitionChannel's scheme mixing (``:136``) is approximated by
re-reading tags on every naming push, so a cluster can migrate N→M
partitions live.

``mesh://`` naming tags each rank of the device mesh ``i/N`` — a
PartitionChannel over it is the control-plane twin of
MeshTransport.scatter/all_gather (the data plane).

The port of ``brpc_tpu/client/partition_channel.py``: calls are
synchronous (no ``done``), and each partition keeps one sub-channel, so
its connections are reused across calls and closed by :meth:`stop`
(the JAX package builds the sub-channels per call over its process-wide
socket map, which the port does not have).
"""

from __future__ import annotations

import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..butil.logging_util import LOG
from ..butil.status import Errno
from .channel import Channel, ChannelOptions
from .controller import Controller
from .load_balancer import create_load_balancer
from .naming_service import ServerNode, create_naming_service
from .parallel_channel import ParallelChannel

_TAG_RE = re.compile(r"^(\d+)/(\d+)$")


def parse_partition_tag(tag: str) -> Optional[Tuple[int, int]]:
    """First ``i/N`` token of the tag → (index, count)."""
    for token in tag.split():
        m = _TAG_RE.match(token)
        if m:
            return int(m.group(1)), int(m.group(2))
    return None


class _PartitionLB:
    """A fixed-partition view over the shared server list, with the
    partition's sub-channel."""

    def __init__(self, lb_name: str, index: int,
                 options: ChannelOptions):
        self.lb = create_load_balancer(lb_name)
        self.lb.use_circuit_breaker = options.enable_circuit_breaker
        self.index = index
        self.channel = _PartitionSubChannel(self, options)

    def select_server(self, cntl):
        return self.lb.select_server(cntl)

    def feedback(self, cntl):
        self.lb.feedback(cntl)

    def stop(self) -> None:
        """The partition's naming is its PartitionChannel's."""


class _PartitionSubChannel(Channel):
    """Channel whose 'cluster' is one partition's replicas."""

    def __init__(self, lb: _PartitionLB,
                 options: Optional[ChannelOptions] = None):
        super().__init__(options)
        self.load_balancer = lb


class PartitionChannel:
    def __init__(self, partition_count: int = 0,
                 options: Optional[ChannelOptions] = None,
                 fail_limit: int = -1):
        self.partition_count = partition_count    # 0 = learn from tags
        self.options = options or ChannelOptions()
        self.fail_limit = fail_limit
        self._ns = None
        self._lb_name = "rr"
        self._lock = threading.Lock()
        self._partitions: Dict[int, _PartitionLB] = {}

    def init(self, naming_url: str, lb_name: str = "rr") -> int:
        from ..policy import load_balancers  # noqa: F401
        from ..policy import naming          # noqa: F401

        self._lb_name = lb_name
        self._ns = create_naming_service(naming_url)
        if self._ns is None:
            return -1
        self._ns.watch(self._on_servers)
        with self._lock:
            ok = bool(self._partitions)
        if not ok:
            LOG.error("no partition-tagged servers at %s", naming_url)
            self._ns.stop()
            self._ns = None
            return -1
        return 0

    def _on_servers(self, nodes: List[ServerNode]) -> None:
        # group by scheme (the N in "i/N"): mixing schemes would shard
        # one key space two ways at once during an N→M migration
        schemes: Dict[int, Dict[int, List[ServerNode]]] = {}
        for n in nodes:
            parsed = parse_partition_tag(n.tag)
            if parsed is None:
                continue
            idx, total = parsed
            if self.partition_count and total != self.partition_count:
                continue                  # foreign partition scheme
            if 0 <= idx < total:
                schemes.setdefault(total, {}).setdefault(
                    idx, []).append(n)
        # adopt the largest scheme with COMPLETE coverage (every
        # partition has at least one replica); else the most complete one
        # (≈ DynamicPartitionChannel's capacity rule, simplified)
        chosen: Dict[int, List[ServerNode]] = {}
        best_key = (-1.0, 0)
        for total, by_part in schemes.items():
            coverage = len(by_part) / total
            if (coverage, total) > best_key:
                best_key = (coverage, total)
                chosen = by_part
        dropped = []
        with self._lock:
            stale = set(self._partitions) - set(chosen)
            for idx in stale:
                dropped.append(self._partitions.pop(idx))
            for idx, members in chosen.items():
                plb = self._partitions.get(idx)
                if plb is None:
                    plb = self._partitions[idx] = _PartitionLB(
                        self._lb_name, idx, self.options)
                plb.lb.reset_servers(members)
        for plb in dropped:
            plb.channel.close()

    @property
    def partitions(self) -> List[int]:
        with self._lock:
            return sorted(self._partitions)

    def call_method(self, method_full: str, request: Any,
                    cntl: Optional[Controller] = None,
                    call_mapper: Optional[Callable] = None,
                    merger: Optional[Callable] = None) -> Controller:
        """Fan out to every partition (call_mapper(index, None, request)
        shapes per-partition requests, e.g. splitting a key batch)."""
        with self._lock:
            parts = sorted(self._partitions.items())
        return _fan_out(parts, self.fail_limit, method_full, request, cntl,
                        call_mapper, merger)

    def _all_partitions(self) -> List[_PartitionLB]:
        with self._lock:
            return list(self._partitions.values())

    def stop(self) -> None:
        """End the naming watch and close every partition's
        connections."""
        if self._ns is not None:
            self._ns.stop()
        for plb in self._all_partitions():
            plb.channel.close()


def _fan_out(parts, fail_limit: int, method_full: str, request: Any,
             cntl: Optional[Controller], call_mapper: Optional[Callable],
             merger: Optional[Callable]) -> Controller:
    """One call over ``parts`` (``(index, _PartitionLB)`` pairs) through a
    ParallelChannel of their sub-channels."""
    pc = ParallelChannel(fail_limit=fail_limit)
    for idx, plb in parts:
        if call_mapper is not None:
            def mk(i):
                return lambda _i, _sub, req: call_mapper(i, _sub, req)
            pc.add_channel(plb.channel, call_mapper=mk(idx))
        else:
            pc.add_channel(plb.channel)
    return pc.call_method(method_full, request, cntl=cntl, merger=merger)


class DynamicPartitionChannel(PartitionChannel):
    """≈ DynamicPartitionChannel (partition_channel.h:136): during an
    N→M re-partitioning, servers of BOTH schemes coexist in naming; each
    call picks one scheme, weighted by its capacity (replica count), so
    traffic migrates proportionally as the new scheme fills in — instead
    of the base class's single-scheme adoption cliff."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._schemes: Dict[int, Dict[int, _PartitionLB]] = {}
        self._scheme_sizes: Dict[int, int] = {}

    def _on_servers(self, nodes: List[ServerNode]) -> None:
        groups: Dict[int, Dict[int, List[ServerNode]]] = {}
        for n in nodes:
            parsed = parse_partition_tag(n.tag)
            if parsed is None:
                continue
            idx, total = parsed
            if 0 <= idx < total:
                groups.setdefault(total, {}).setdefault(idx, []).append(n)
        dropped = []
        with self._lock:
            # only COMPLETE schemes carry traffic (a scheme missing a
            # partition would black-hole part of the key space)
            complete = {t: g for t, g in groups.items() if len(g) == t}
            stale = set(self._schemes) - set(complete)
            for t in stale:
                dropped.extend(self._schemes.pop(t).values())
                self._scheme_sizes.pop(t, None)
            for t, by_part in complete.items():
                scheme = self._schemes.setdefault(t, {})
                for idx, members in by_part.items():
                    plb = scheme.get(idx)
                    if plb is None:
                        plb = scheme[idx] = _PartitionLB(
                            self._lb_name, idx, self.options)
                    plb.lb.reset_servers(members)
                self._scheme_sizes[t] = sum(
                    len(m) for m in by_part.values())
            # keep the base-class view pointing at the largest scheme so
            # .partitions introspection still answers
            if complete:
                biggest = max(complete)
                self._partitions = dict(self._schemes[biggest])
        for plb in dropped:
            plb.channel.close()

    @property
    def scheme_weights(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._scheme_sizes)

    def _all_partitions(self) -> List[_PartitionLB]:
        with self._lock:
            return [plb for scheme in self._schemes.values()
                    for plb in scheme.values()]

    def call_method(self, method_full: str, request: Any,
                    cntl: Optional[Controller] = None,
                    call_mapper: Optional[Callable] = None,
                    merger: Optional[Callable] = None) -> Controller:
        from ..butil.fast_rand import fast_rand
        with self._lock:
            total_cap = sum(self._scheme_sizes.values())
            if total_cap <= 0:
                parts = []
            else:
                r = fast_rand() % total_cap
                chosen = None
                for t in sorted(self._schemes):
                    r -= self._scheme_sizes[t]
                    if r < 0:
                        chosen = t
                        break
                parts = sorted(self._schemes[chosen].items())
        if not parts:
            c = cntl or Controller()
            c.set_failed(int(Errno.EINTERNAL), "no complete partition scheme")
            return c
        return _fan_out(parts, self.fail_limit, method_full, request, cntl,
                        call_mapper, merger)
