"""Channel — the client stub, over one blocking tpu_std connection.

The slim core of ``brpc_tpu/client/channel.py``: ``init`` against one
server ("ip:port"), then ``call_method`` / ``call``.  Calls on one
channel are serialized over its connection; a call that times out or
loses the connection closes it, and the next call reconnects.  Naming,
load balancing, retries, TLS and the other protocols wait for later
slices of the port.
"""

from __future__ import annotations

import socket
import threading
from typing import Any, Optional

from ..butil.endpoint import EndPoint, parse_endpoint
from ..butil.status import Errno
from ..protocol.meta import RpcMeta
from ..protocol.tpu_std import (FrameError, pack_frame, read_frame,
                                serialize_payload)
from .controller import Controller


class ChannelOptions:
    """Defaults mirror the JAX package's: timeout 500 ms, connect 1 s."""

    __slots__ = ("timeout_ms", "connect_timeout_ms")

    def __init__(self):
        self.timeout_ms = 500
        self.connect_timeout_ms = 1000


class RpcError(Exception):
    def __init__(self, code: int, text: str):
        super().__init__(f"[{code}] {text}")
        self.code = code
        self.text = text


class Channel:
    def __init__(self, options: Optional[ChannelOptions] = None):
        self.options = options or ChannelOptions()
        self.server: Optional[EndPoint] = None
        self._sock: Optional[socket.socket] = None
        self._next_cid = 1
        self._lock = threading.Lock()

    def init(self, addr: Any) -> int:
        """``addr``: "ip:port" or an EndPoint.  0 on success."""
        try:
            self.server = addr if isinstance(addr, EndPoint) \
                else parse_endpoint(str(addr))
        except ValueError:
            return -1
        return 0

    def close(self) -> None:
        with self._lock:
            self._drop()

    def _drop(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def call_method(self, method_full: str, request: Any,
                    cntl: Optional[Controller] = None) -> Controller:
        """Blocking call of ``"Service.Method"`` with a bytes request; the
        response bytes and any error land in the returned controller."""
        c = cntl or Controller()
        if self.server is None:
            c.set_failed(Errno.EINTERNAL, "channel not initialized")
            return c
        try:
            payload = serialize_payload(request)
        except TypeError as e:
            c.set_failed(Errno.EREQUEST, str(e))
            return c
        timeout_ms = c.timeout_ms or self.options.timeout_ms
        svc, _, mth = method_full.rpartition(".")
        with self._lock:
            meta = RpcMeta()
            meta.correlation_id = self._next_cid
            self._next_cid += 1
            meta.service_name, meta.method_name = svc, mth
            meta.timeout_ms = int(timeout_ms)
            try:
                if self._sock is None:
                    self._sock = socket.create_connection(
                        self.server.to_sockaddr(),
                        timeout=self.options.connect_timeout_ms / 1e3)
                    self._sock.setsockopt(socket.IPPROTO_TCP,
                                          socket.TCP_NODELAY, 1)
                self._sock.settimeout(timeout_ms / 1e3)
                self._sock.sendall(pack_frame(meta, payload))
                rmeta, body, _ = read_frame(self._sock)
            except socket.timeout:
                self._drop()
                c.set_failed(Errno.ERPCTIMEDOUT,
                             f"deadline {timeout_ms}ms exceeded")
                return c
            except (OSError, EOFError, FrameError) as e:
                self._drop()
                c.set_failed(Errno.EFAILEDSOCKET, f"{type(e).__name__}: {e}")
                return c
            if rmeta.correlation_id != meta.correlation_id:
                self._drop()
                c.set_failed(Errno.ERESPONSE,
                             f"response for call {rmeta.correlation_id}, "
                             f"expected {meta.correlation_id}")
                return c
        if rmeta.error_code:
            c.set_failed(rmeta.error_code, rmeta.error_text)
        else:
            c.response = body
        return c

    def call(self, method_full: str, request: Any,
             timeout_ms: Optional[int] = None) -> bytes:
        """``channel.call("LM.Info", b"")`` -> the response, or raises
        :class:`RpcError`."""
        cntl = Controller()
        cntl.timeout_ms = timeout_ms
        c = self.call_method(method_full, request, cntl=cntl)
        if c.failed:
            raise RpcError(c.error_code, c.error_text)
        return c.response
