"""NamingService + LoadBalancer composition
(≈ brpc's src/brpc/details/load_balancer_with_naming.h): the
channel's cluster mode — watch membership, keep the LB's server set
fresh, delegate selection/feedback.

A copy of ``brpc_tpu/client/load_balancer_with_naming.py``.
"""

from __future__ import annotations

from typing import List, Optional

from ..butil.logging_util import LOG
from .load_balancer import LoadBalancer, create_load_balancer
from .naming_service import NamingService, ServerNode, create_naming_service


class LoadBalancerWithNaming:
    def __init__(self):
        self._ns: Optional[NamingService] = None
        self._lb: Optional[LoadBalancer] = None

    def init(self, naming_url: str, lb_name: str,
             enable_circuit_breaker: bool = False) -> int:
        # builtin policies register on import
        from ..policy import load_balancers as _lbs  # noqa: F401
        from ..policy import naming as _naming       # noqa: F401

        self._lb = create_load_balancer(lb_name)
        if self._lb is None:
            LOG.error("unknown load balancer %r", lb_name)
            return -1
        self._lb.use_circuit_breaker = enable_circuit_breaker
        self._ns = create_naming_service(naming_url)
        if self._ns is None:
            return -1
        self._ns.watch(self._on_servers)
        return 0

    def _on_servers(self, nodes: List[ServerNode]) -> None:
        self._lb.reset_servers(nodes)

    def select_server(self, cntl):
        return self._lb.select_server(cntl)

    def feedback(self, cntl) -> None:
        self._lb.feedback(cntl)

    @property
    def servers(self) -> List[ServerNode]:
        return self._lb.servers if self._lb else []

    def stop(self) -> None:
        if self._ns is not None:
            self._ns.stop()
