"""Redis client — RESP over one connection of its own.

The port of ``brpc_tpu/client/redis_client.py`` (≈ brpc's ``redis.h``
client half, RedisRequest/RedisResponse with pipelining): commands are
plain ``*args``, ``pipeline()`` ships N commands in one write and reads
N replies — against any RESP server, the port's own one port with a
``"redis"`` service included.  The code is the JAX module's; nothing is
cut.  Divergence: a failed command drops the connection under the
client's lock (the JAX client calls ``close``, which takes the lock it
holds, and hangs).
"""

from __future__ import annotations

import socket as _socket
import threading
from typing import Any, List, Optional

from ..butil.endpoint import EndPoint, parse_endpoint
from ..protocol.resp import NIL, RedisError, decode_one, encode_command


class RedisClient:
    """One connection, thread-safe via a lock (commands are cheap; use
    several clients for parallelism)."""

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
            self._drop()

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _read_reply(self) -> Any:
        while True:
            val, pos = decode_one(self._buf, 0)
            if pos > 0 or val is not None:
                self._buf = self._buf[pos:]
                return None if val is NIL else val
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis server closed the connection")
            self._buf += chunk

    def command(self, *args) -> Any:
        """One command; RedisError replies raise."""
        with self._lock:
            self._ensure()
            try:
                self._sock.sendall(encode_command(*args))
                reply = self._read_reply()
            except (OSError, ConnectionError):
                self._drop()
                raise
        if isinstance(reply, RedisError):
            raise reply
        return reply

    def pipeline(self, commands: List[tuple]) -> List[Any]:
        """N commands in one write, N replies back (errors returned
        in-place, not raised — pipelining semantics)."""
        with self._lock:
            self._ensure()
            try:
                self._sock.sendall(b"".join(
                    encode_command(*c) for c in commands))
                return [self._read_reply() for _ in commands]
            except (OSError, ConnectionError):
                self._drop()
                raise

    # sugar for the common commands
    def set(self, key, value) -> Any:
        return self.command("SET", key, value)

    def get(self, key) -> Any:
        return self.command("GET", key)

    def delete(self, *keys) -> Any:
        return self.command("DEL", *keys)

    def incr(self, key) -> Any:
        return self.command("INCR", key)

    def ping(self) -> Any:
        return self.command("PING")
