"""Builtin naming services (≈ brpc's src/brpc/policy/
{list,file,domain}_naming_service.cpp + a mesh topology source),
registered under their URL schemes on import (≈ global.cpp:354-365).

- ``list://h1:p1[ tag],h2:p2``  static list, tags after spaces
- ``file:///path``              one server per line, reloaded on change
- ``dns://host:port``           periodic resolution, all A records
- ``mesh://name``               the ranks of the process-wide device mesh
                                (peers = ranks, each tagged ``i/N``)

A copy of ``brpc_tpu/policy/naming.py``.  ``mesh://`` reads the port's
:func:`~brpc_tpu_torch.parallel.mesh_transport.global_mesh_transport`,
whose default device is ``"cuda"``: on the CPU the caller makes the
process-wide transport first with ``global_mesh_transport(device="cpu")``
(a gloo group); without one and without a card the scheme fails to
start, and it never makes a CPU transport of its own.
"""

from __future__ import annotations

import os
import socket as _socket
from typing import List, Optional, Sequence

from ..butil.endpoint import EndPoint
from ..butil.logging_util import LOG
from ..client.naming_service import (NamingService, ServerNode,
                                     naming_registry, parse_server_line)


class ListNamingService(NamingService):
    """Static: the url itself is the list; no refresh needed."""

    def __init__(self):
        super().__init__()
        self.refresh_interval_s = 0
        self._nodes: List[ServerNode] = []

    def start(self, url_path: str) -> int:
        nodes = []
        for part in url_path.split(","):
            node = parse_server_line(part)
            if part.strip() and node is None:
                return -1
            if node is not None:
                nodes.append(node)
        if not nodes:
            return -1
        self._nodes = nodes
        self.push(nodes)
        return 0

    def fetch_servers(self) -> Sequence[ServerNode]:
        return self._nodes


class FileNamingService(NamingService):
    def __init__(self):
        super().__init__()
        self._path = ""
        self._mtime = 0.0

    def start(self, url_path: str) -> int:
        path = url_path
        if not path.startswith("/") and os.path.exists("/" + path):
            path = "/" + path        # file:///abs/path → rest lacks one /
        self._path = path
        if not os.path.exists(self._path):
            return -1
        return super().start(url_path)

    def fetch_servers(self) -> Optional[Sequence[ServerNode]]:
        try:
            mtime = os.path.getmtime(self._path)
            with open(self._path) as f:
                lines = f.readlines()
        except OSError:
            return None             # keep previous list
        self._mtime = mtime
        return [n for n in map(parse_server_line, lines) if n is not None]


class DnsNamingService(NamingService):
    def __init__(self):
        super().__init__()
        self.refresh_interval_s = 30.0
        self._host = ""
        self._port = 0

    def start(self, url_path: str) -> int:
        host, _, port = url_path.partition(":")
        if not host:
            return -1
        self._host = host
        try:
            self._port = int(port) if port else 80
        except ValueError:
            return -1
        return super().start(url_path)

    def fetch_servers(self) -> Optional[Sequence[ServerNode]]:
        try:
            infos = _socket.getaddrinfo(self._host, self._port,
                                        _socket.AF_INET,
                                        _socket.SOCK_STREAM)
        except OSError:
            return None
        seen, nodes = set(), []
        for _, _, _, _, sockaddr in infos:
            ep = EndPoint(host=sockaddr[0], port=sockaddr[1])
            if ep not in seen:
                seen.add(ep)
                nodes.append(ServerNode(ep))
        return nodes


class MeshNamingService(NamingService):
    """Peers = the ranks of the device mesh: with N ranks the "cluster"
    is ici://<name>/0..N-1, each tagged ``i/N`` so PartitionChannel can
    shard key-spaces straight onto the mesh."""

    def __init__(self):
        super().__init__()
        self.refresh_interval_s = 0      # topology is static per process
        self._name = ""

    def start(self, url_path: str) -> int:
        from ..parallel.mesh_transport import global_mesh_transport
        self._name = url_path or "mesh0"
        try:
            mt = global_mesh_transport()
        except (RuntimeError, ValueError) as e:
            # no process group, or no card for the default cuda mesh
            LOG.error("mesh naming: no mesh transport (%s)", e)
            return -1
        n = mt.n_peers
        self.push([ServerNode(EndPoint(mesh=self._name, device_index=i),
                              tag=f"{i}/{n}") for i in range(n)])
        return 0

    def fetch_servers(self) -> Sequence[ServerNode]:
        return self.current


naming_registry().register("list", ListNamingService)
naming_registry().register("file", FileNamingService)
naming_registry().register("dns", DnsNamingService)
naming_registry().register("mesh", MeshNamingService)

# watch:// — long-poll remote membership (fleet controller); its own
# module: it owns a thread and degrade-to-file machinery
from . import remote_naming as _remote_naming          # noqa: E402,F401
