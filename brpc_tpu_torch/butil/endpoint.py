"""EndPoint — where a peer lives: ``host:port`` (IPv4, IPv6, hostname).

The network half of ``brpc_tpu/butil/endpoint.py``; the ICI device
coordinates and unix sockets of the JAX package are not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True, order=True)
class EndPoint:
    host: str = ""
    port: int = 0

    def __str__(self) -> str:
        if ":" in self.host:  # ipv6 literal
            return f"[{self.host}]:{self.port}"
        return f"{self.host}:{self.port}"

    def to_sockaddr(self) -> Tuple[str, int]:
        return (self.host, self.port)


def parse_endpoint(text: str, default_port: int = 0) -> EndPoint:
    """Parse ``host:port``, ``[v6]:port``, a bare IPv6 literal, or a bare
    host (uses ``default_port``)."""
    text = text.strip()
    if text.startswith("["):  # [ipv6]:port
        close = text.index("]")
        host = text[1:close]
        rest = text[close + 1:]
        port = int(rest[1:]) if rest.startswith(":") else default_port
        return EndPoint(host=host, port=port)
    if text.count(":") == 1:
        host, port_s = text.split(":")
        return EndPoint(host=host, port=int(port_s))
    if text.count(":") > 1:  # bare ipv6
        return EndPoint(host=text, port=default_port)
    if not text:
        raise ValueError("empty endpoint")
    return EndPoint(host=text, port=default_port)
