"""Channel — the client stub, over one blocking tpu_std connection.

The slim core of ``brpc_tpu/client/channel.py``: ``init`` against one
server ("ip:port"), then ``call_method`` / ``call``.  Calls on one
channel are serialized over its connection; a call that times out or
loses the connection closes it (reclaiming the device payloads posted on
it), and the next call reconnects.

Device attachments (``brpc_tpu/client/controller.py``'s ICI lane): every
request advertises this process's fabric domain and the connection
nonce; the peer's domain is learned from the first response, and from
then on a device attachment to a peer in this process goes as a
descriptor.  TICI ack frames that arrive ahead of a response are
processed; the credit for a response descriptor goes back when the
caller redeems it (or drops it unredeemed), on the connection's ack
queue.  Naming, load balancing, retries, TLS and the other protocols
wait for later slices of the port.
"""

from __future__ import annotations

import socket
import threading
from typing import Any, Optional

from ..butil.endpoint import EndPoint, parse_endpoint
from ..butil.status import Errno
from ..ici.endpoint import (ack_unused, conn_nonce_of, ici_enabled,
                            prepare_send, process_ack,
                            split_device_attachment)
from ..ici.fabric import local_domain_id
from ..protocol.meta import RpcMeta
from ..protocol.tpu_std import (AckFrame, FrameError, pack_frame, read_frame,
                                serialize_payload)
from ..transport.socket import Socket
from .controller import Controller

_MAX_POST_WAIT_S = 30.0     # a request descriptor's wait for window credit


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
        self._sock: Optional[Socket] = None
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
                sock = self._connect()
                sock.conn.settimeout(timeout_ms / 1e3)
                frame = self._request_frame(c, sock, meta, payload,
                                            timeout_ms)
                if frame is None:
                    return c
                sock.write(frame)
                while True:
                    msg = read_frame(sock.conn)
                    if not isinstance(msg, AckFrame):
                        break
                    process_ack(msg.ids, sock)
            except socket.timeout:
                self._drop()
                c.set_failed(Errno.ERPCTIMEDOUT,
                             f"deadline {timeout_ms}ms exceeded")
                return c
            except (OSError, EOFError, FrameError) as e:
                self._drop()
                c.set_failed(Errno.EFAILEDSOCKET, f"{type(e).__name__}: {e}")
                return c
            rmeta, body, ratt = msg
            if rmeta.correlation_id != meta.correlation_id:
                ack_unused(rmeta, sock.id)
                self._drop()
                c.set_failed(Errno.ERESPONSE,
                             f"response for call {rmeta.correlation_id}, "
                             f"expected {meta.correlation_id}")
                return c
        if rmeta.ici_domain:
            sock.ici_peer_domain = rmeta.ici_domain
        if rmeta.error_code:
            ack_unused(rmeta, sock.id)
            c.set_failed(rmeta.error_code, rmeta.error_text)
        else:
            c.response = body
            c.response_attachment, c.response_device_attachment = \
                split_device_attachment(rmeta, ratt, sock.id)
        return c

    def _connect(self) -> Socket:
        if self._sock is None:
            conn = socket.create_connection(
                self.server.to_sockaddr(),
                timeout=self.options.connect_timeout_ms / 1e3)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = Socket(conn)
        return self._sock

    @staticmethod
    def _request_frame(c: Controller, sock: Socket, meta: RpcMeta,
                       payload: bytes, timeout_ms: int) -> Optional[bytes]:
        """The request frame, with the domain exchange and the device
        attachment; None after failing ``c``."""
        if ici_enabled():
            meta.ici_domain = local_domain_id()
            meta.ici_conn = conn_nonce_of(sock)
        attachment = c.request_attachment
        if c.request_device_attachment is not None:
            # with ici off prepare_send sends the bytes inline itself: the
            # attachment is never dropped
            wait_s = min(_MAX_POST_WAIT_S, max(0.001, timeout_ms / 1e3))
            try:
                tail = prepare_send(sock, meta, c.request_device_attachment,
                                    timeout_s=wait_s)
            except RuntimeError as e:
                c.set_failed(Errno.EOVERCROWDED, str(e))
                return None
            if tail is not None:
                attachment = bytes(attachment) + tail if attachment else tail
        try:
            return pack_frame(meta, payload, attachment)
        except FrameError as e:
            c.set_failed(Errno.EREQUEST, str(e))
            return None

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
