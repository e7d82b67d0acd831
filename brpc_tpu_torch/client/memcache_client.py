"""Memcached client — text protocol.

The port of ``brpc_tpu/client/memcache_client.py`` (≈ brpc's
``memcache.h`` and ``policy/memcache_binary_protocol``; brpc speaks the
binary protocol, this client the text one, with the same surface:
get/set/add/replace/delete/incr/decr with flags, exptime and CAS).  The
code is the JAX module's; nothing is cut.
"""

from __future__ import annotations

import socket as _socket
import threading
from typing import Dict, Optional, Tuple

from ..butil.endpoint import EndPoint, parse_endpoint


class MemcacheError(Exception):
    pass


class MemcacheClient:
    def __init__(self, addr, timeout_s: float = 2.0):
        self._remote: EndPoint = addr if isinstance(addr, EndPoint) \
            else parse_endpoint(str(addr))
        self._timeout_s = timeout_s
        self._lock = threading.Lock()
        self._sock: Optional[_socket.socket] = None
        self._buf = b""

    def _ensure(self) -> None:
        if self._sock is None:
            s = _socket.create_connection(self._remote.to_sockaddr(),
                                          timeout=self._timeout_s)
            s.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            self._sock = s
            self._buf = b""

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("memcached closed the connection")
            self._buf += chunk
        line, _, self._buf = self._buf.partition(b"\r\n")
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("memcached closed the connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    # -- storage ------------------------------------------------------------

    def _store(self, verb: str, key: str, value: bytes, flags: int,
               exptime: int, cas: Optional[int] = None) -> bool:
        data = value if isinstance(value, bytes) else str(value).encode()
        head = f"{verb} {key} {flags} {exptime} {len(data)}"
        if cas is not None:
            head += f" {cas}"
        with self._lock:
            self._ensure()
            self._sock.sendall(head.encode() + b"\r\n" + data + b"\r\n")
            resp = self._read_line()
        if resp == b"STORED":
            return True
        if resp in (b"NOT_STORED", b"EXISTS", b"NOT_FOUND"):
            return False
        raise MemcacheError(resp.decode("utf-8", "replace"))

    def set(self, key: str, value, flags: int = 0, exptime: int = 0) -> bool:
        return self._store("set", key, value, flags, exptime)

    def add(self, key: str, value, flags: int = 0, exptime: int = 0) -> bool:
        return self._store("add", key, value, flags, exptime)

    def replace(self, key: str, value, flags: int = 0,
                exptime: int = 0) -> bool:
        return self._store("replace", key, value, flags, exptime)

    def cas(self, key: str, value, cas_id: int, flags: int = 0,
            exptime: int = 0) -> bool:
        return self._store("cas", key, value, flags, exptime, cas_id)

    # -- retrieval -----------------------------------------------------------

    def get(self, key: str) -> Optional[bytes]:
        out = self.gets(key)
        return out[0] if out is not None else None

    def gets(self, key: str) -> Optional[Tuple[bytes, int, Optional[int]]]:
        """(value, flags, cas_id) or None."""
        with self._lock:
            self._ensure()
            self._sock.sendall(f"gets {key}\r\n".encode())
            out: Dict[str, Tuple[bytes, int, Optional[int]]] = {}
            while True:
                line = self._read_line()
                if line == b"END":
                    break
                parts = line.split()
                if parts[0] != b"VALUE":
                    raise MemcacheError(line.decode("utf-8", "replace"))
                k = parts[1].decode()
                flags, n = int(parts[2]), int(parts[3])
                cas_id = int(parts[4]) if len(parts) > 4 else None
                data = self._read_exact(n)
                self._read_exact(2)      # trailing \r\n
                out[k] = (data, flags, cas_id)
        return out.get(key)

    # -- misc ----------------------------------------------------------------

    def delete(self, key: str) -> bool:
        with self._lock:
            self._ensure()
            self._sock.sendall(f"delete {key}\r\n".encode())
            return self._read_line() == b"DELETED"

    def _arith(self, verb: str, key: str, delta: int) -> Optional[int]:
        with self._lock:
            self._ensure()
            self._sock.sendall(f"{verb} {key} {delta}\r\n".encode())
            resp = self._read_line()
        if resp == b"NOT_FOUND":
            return None
        if resp.isdigit():
            return int(resp)
        raise MemcacheError(resp.decode("utf-8", "replace"))

    def incr(self, key: str, delta: int = 1) -> Optional[int]:
        return self._arith("incr", key, delta)

    def decr(self, key: str, delta: int = 1) -> Optional[int]:
        return self._arith("decr", key, delta)

    def version(self) -> str:
        with self._lock:
            self._ensure()
            self._sock.sendall(b"version\r\n")
            line = self._read_line()
        return line.decode("utf-8", "replace")
