"""EndPoint — where a peer lives: ``host:port`` (IPv4, IPv6, hostname),
a unix socket path ``unix:/path``, or a rank of a device mesh,
``ici://<mesh>/<index>``.

The port of ``brpc_tpu/butil/endpoint.py``: ``is_unix``,
``device_endpoint``, ``hostname_to_ip`` and ``my_hostname`` as there (a
unix endpoint parses and prints; neither package dials one).
"""

from __future__ import annotations

import re
import socket
from dataclasses import dataclass
from typing import Tuple

_ICI_RE = re.compile(r"^ici://([A-Za-z0-9_\-\.]+)/(\d+)$")
_UDS_PREFIX = "unix:"


@dataclass(frozen=True, order=True)
class EndPoint:
    host: str = ""
    port: int = 0
    # device coordinate fields (exclusive with host/port)
    mesh: str = ""
    device_index: int = -1

    @property
    def is_device(self) -> bool:
        return self.device_index >= 0

    @property
    def is_unix(self) -> bool:
        return self.host.startswith(_UDS_PREFIX)

    def __str__(self) -> str:
        if self.is_device:
            return f"ici://{self.mesh}/{self.device_index}"
        if self.is_unix:
            return self.host
        if ":" in self.host:  # ipv6 literal
            return f"[{self.host}]:{self.port}"
        return f"{self.host}:{self.port}"

    def to_sockaddr(self) -> Tuple[str, int]:
        if self.is_device:
            raise ValueError(f"{self} is a device endpoint, not a sockaddr")
        return (self.host, self.port)


def parse_endpoint(text: str, default_port: int = 0) -> EndPoint:
    """Parse ``host:port``, ``[v6]:port``, ``unix:/path``,
    ``ici://mesh/idx``, a bare IPv6 literal, or a bare host (uses
    ``default_port``)."""
    text = text.strip()
    if text.startswith(_UDS_PREFIX):
        return EndPoint(host=text, port=default_port)
    m = _ICI_RE.match(text)
    if m:
        return EndPoint(mesh=m.group(1), device_index=int(m.group(2)))
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


def device_endpoint(mesh: str, index: int) -> EndPoint:
    return EndPoint(mesh=mesh, device_index=index)


def hostname_to_ip(hostname: str) -> str:
    """Resolve a hostname to its first IP (≈ butil::hostname2ip)."""
    return socket.gethostbyname(hostname)


def my_hostname() -> str:
    return socket.gethostname()
