"""LoadBalancer plugin interface
(≈ brpc's src/brpc/load_balancer.h:35-95): server set mutations
go through DoublyBufferedData so SelectServer is a read-only, lock-free
path; Feedback lets latency-aware policies learn.

Selection context is the Controller: it carries ``request_code`` (for
consistent hashing), the per-call excluded-server set (retries avoid the
server that just failed, ≈ excluded_servers.h), and receives
``remote_side`` back.

A copy of ``brpc_tpu/client/load_balancer.py``.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

from ..butil.doubly_buffered import DoublyBufferedData
from ..butil.endpoint import EndPoint
from ..butil.extension import extension
from .circuit_breaker import global_circuit_breaker_map
from .naming_service import ServerNode, global_lame_ducks


class LoadBalancer:
    """Subclasses implement select(); the base maintains the server list
    in a DoublyBufferedData and filters excluded/isolated nodes."""

    def __init__(self):
        self._servers: DoublyBufferedData[List[ServerNode]] = \
            DoublyBufferedData([])
        self._breakers = global_circuit_breaker_map()
        # Gated by ChannelOptions.enable_circuit_breaker (off by default,
        # like the reference channel.h:49-77): when False, no node is
        # filtered by breaker state and calls don't feed it.
        self.use_circuit_breaker = False
        # ClusterRecoverPolicy (≈ cluster_recover_policy.h): when fewer
        # than min_working_instances survive breaker isolation, the
        # cluster is deemed "recovering" — selection probes the FULL
        # list (isolated included) so broken-but-healed servers get
        # traffic and can revive, instead of the survivors melting down.
        self.min_working_instances = 0      # 0 = policy off
        self.recovering = False

    # -- membership (≈ AddServer/RemoveServer batched) --------------------

    def reset_servers(self, nodes: Sequence[ServerNode]) -> None:
        self._servers.modify_with_new(list(nodes))

    def add_server(self, node: ServerNode) -> None:
        def add(lst):
            if node not in lst:
                lst.append(node)
            return True
        self._servers.modify(add)

    def remove_server(self, node: ServerNode) -> None:
        def rm(lst):
            if node in lst:
                lst.remove(node)
            return True
        self._servers.modify(rm)

    @property
    def servers(self) -> List[ServerNode]:
        return self._servers.read()

    # -- selection ---------------------------------------------------------

    def candidates(self, cntl) -> List[ServerNode]:
        nodes = self._servers.read()
        excluded = getattr(cntl, "excluded_servers", None) or ()
        breakers = self._breakers if self.use_circuit_breaker else None
        # lame-duck filter (operability plane): a draining node said so
        # itself — drop it from selection immediately, breaker state
        # untouched (unconditional: the mark only exists because the
        # node emitted the signal).  In-flight responses still complete
        # — this filters SELECTION only.
        ducks = global_lame_ducks()
        usable = [n for n in nodes
                  if not ducks.is_lame(n.endpoint)
                  and (breakers is None
                       or not breakers.isolated(n.endpoint))]
        if breakers is not None and self.min_working_instances > 0:
            if len(usable) < self.min_working_instances:
                self.recovering = True
            elif self.recovering and \
                    len(usable) >= self.min_working_instances:
                self.recovering = False
            if self.recovering:
                # probe the full list so isolated-but-healed servers get
                # traffic and can re-qualify
                usable = list(nodes)
        out = [n for n in usable if n.endpoint not in excluded]
        if not out and nodes:
            # every node excluded/isolated: fall back to the full list
            # rather than failing the call outright (cluster recover
            # behavior, ≈ cluster_recover_policy.h)
            out = list(nodes)
        return out

    def select_server(self, cntl) -> Optional[EndPoint]:
        nodes = self.candidates(cntl)
        if not nodes:
            return None
        node = self.select(nodes, cntl)
        return node.endpoint if node is not None else None

    def select(self, nodes: List[ServerNode], cntl) -> Optional[ServerNode]:
        raise NotImplementedError

    # -- learning ----------------------------------------------------------

    def feedback(self, cntl) -> None:
        """Called on RPC completion with the final controller state."""
        if cntl.remote_side is None:
            return
        if self.use_circuit_breaker:
            self._breakers.on_call(cntl.remote_side, cntl.error_code,
                                   cntl.latency_us)
        self.on_feedback(cntl)

    def on_feedback(self, cntl) -> None:
        pass


def lb_registry():
    return extension("load_balancer")


def create_load_balancer(name: str) -> Optional[LoadBalancer]:
    factory = lb_registry().find(name or "rr")
    return factory() if factory is not None else None
