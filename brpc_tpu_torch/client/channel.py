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
queue.

The shm data plane (``transport/shm_ring.py``, the JAX controller's
lane): a request attachment of ``rpc_shm_threshold`` bytes or more to a
peer on this host rides a descriptor into this process's ring once the
peer has accepted the ring offer (the first eligible request carries
it); slot releases owed to the peer ride the next request; a response
descriptor is resolved into a view of the peer's ring (the
``response_attachment``, a ``memoryview`` whose release settles its
slot); and the request's slot lease is settled once the call has an
outcome.  Every ineligible shape rides the frame, byte for byte as
before, under a named reason.

Streams (``brpc_tpu/client/controller.py``): a call whose controller
carries a stream (``streaming.stream_create``) puts the stream's id and
window into the request meta, binds the stream to the connection before
the write, and the response binds it to the server's stream (a failed
call, or one the server did not accept it on, closes it).  Stream frames
arrive after the call returns, and the first may arrive before the
response: from that call on the connection gets one reader thread, which
owns every read, hands each response to its waiting call by correlation
id, and routes TSTR frames to their streams and TICI acks to the lane.
A call that times out there leaves the connection up (the streams on it
live on); its late response is dropped.  A call with ``cntl.trace_id``
set is traced (``Controller._begin_trace_span``): its client span
finishes with the call's outcome.  Naming, load balancing,
retries, TLS and the other protocols wait for later slices of the port.
"""

from __future__ import annotations

import socket
import threading
from typing import Any, Dict, Optional

from ..butil.endpoint import EndPoint, parse_endpoint
from ..butil.status import Errno
from ..ici.endpoint import (ack_unused, conn_nonce_of, ici_enabled,
                            prepare_send, process_ack,
                            split_device_attachment)
from ..ici.fabric import local_domain_id
from ..protocol.meta import RpcMeta
from ..protocol.streaming import StreamFrame, dispatch
from ..protocol.tpu_std import (AckFrame, FrameError, pack_frame, read_frame,
                                serialize_payload)
from ..transport import shm_ring
from ..transport.socket import Socket
from .controller import Controller

_MAX_POST_WAIT_S = 30.0     # a request descriptor's wait for window credit
_JOIN_TIMEOUT_S = 5.0


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


class _Waiter:
    """One call waiting for its response from the reader thread."""

    __slots__ = ("done", "msg", "error")

    def __init__(self):
        self.done = threading.Event()
        self.msg = None
        self.error: Optional[str] = None


class Channel:
    def __init__(self, options: Optional[ChannelOptions] = None):
        self.options = options or ChannelOptions()
        self.server: Optional[EndPoint] = None
        self._sock: Optional[Socket] = None
        self._next_cid = 1
        self._lock = threading.Lock()
        # reader mode: the thread reading _reader_sock, and the calls
        # waiting on it by correlation id
        self._reader: Optional[threading.Thread] = None
        self._reader_sock: Optional[Socket] = None
        self._waiters: Dict[int, _Waiter] = {}
        self._waiters_lock = threading.Lock()

    def init(self, addr: Any) -> int:
        """``addr``: "ip:port" or an EndPoint.  0 on success."""
        try:
            self.server = addr if isinstance(addr, EndPoint) \
                else parse_endpoint(str(addr))
        except ValueError:
            return -1
        return 0

    def close(self) -> None:
        """Close the connection, and with it the streams it carries."""
        with self._lock:
            reader = self._reader
            self._drop()
        if reader is not None and reader is not threading.current_thread():
            reader.join(_JOIN_TIMEOUT_S)

    def _drop(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def call_method(self, method_full: str, request: Any,
                    cntl: Optional[Controller] = None) -> Controller:
        """Blocking call of ``"Service.Method"`` with a bytes request; the
        response bytes and any error land in the returned controller."""
        c = cntl or Controller()
        stream = c._stream_to_create
        if c.trace_id:
            # an explicitly traced call: its client span opens before the
            # request is framed, so the meta carries this hop's span id
            c._begin_trace_span(method_full)
        if self.server is None:
            c.set_failed(Errno.EINTERNAL, "channel not initialized")
        else:
            try:
                payload = serialize_payload(request)
            except TypeError as e:
                c.set_failed(Errno.EREQUEST, str(e))
            else:
                self._call(c, method_full, payload, stream)
        if stream is not None and (c.failed
                                   or not stream._established.is_set()):
            # a failed call, or one the server accepted no stream on:
            # the pending stream dies with it
            stream._close_local(notify_peer=False)
        c._end_trace_span(self.server)
        return c

    def _call(self, c: Controller, method_full: str, payload: bytes,
              stream) -> None:
        timeout_ms = c.timeout_ms or self.options.timeout_ms
        svc, _, mth = method_full.rpartition(".")
        waiter = None
        lease, offered = None, False        # the shm lane's, for this call
        with self._lock:
            meta = RpcMeta()
            meta.correlation_id = self._next_cid
            self._next_cid += 1
            meta.service_name, meta.method_name = svc, mth
            meta.timeout_ms = int(timeout_ms)
            meta.trace_id, meta.span_id = c.trace_id, c.span_id
            try:
                sock = self._connect()
                if stream is not None:
                    meta.stream_id = stream.id
                    meta.stream_window = stream.options.max_buf_size
                    if not stream._attach(sock.id):
                        raise OSError("connection closed")
                    self._start_reader(sock)
                frame, lease, offered = self._request_frame(
                    c, sock, meta, payload, timeout_ms)
                if frame is None:
                    return
                if self._reader_sock is sock:
                    waiter = _Waiter()
                    with self._waiters_lock:
                        self._waiters[meta.correlation_id] = waiter
                    sock.write(frame)
                else:
                    sock.conn.settimeout(timeout_ms / 1e3)
                    sock.write(frame)
                    msg = self._read_response(sock)
            except socket.timeout:
                self._drop()
                shm_ring.client_complete(lease)
                c.set_failed(Errno.ERPCTIMEDOUT,
                             f"deadline {timeout_ms}ms exceeded")
                return
            except (OSError, EOFError, FrameError) as e:
                if waiter is not None:
                    with self._waiters_lock:
                        self._waiters.pop(meta.correlation_id, None)
                self._drop()
                shm_ring.client_complete(lease)
                c.set_failed(Errno.EFAILEDSOCKET, f"{type(e).__name__}: {e}")
                return
        if waiter is not None:
            if not waiter.done.wait(timeout_ms / 1e3):
                with self._waiters_lock:
                    timed_out = self._waiters.pop(meta.correlation_id,
                                                  None) is not None
                if timed_out:
                    shm_ring.client_complete(lease)
                    c.set_failed(Errno.ERPCTIMEDOUT,
                                 f"deadline {timeout_ms}ms exceeded")
                    return
                waiter.done.wait()      # the reader is handing it over
            if waiter.error is not None:
                shm_ring.client_complete(lease)
                c.set_failed(Errno.EFAILEDSOCKET, waiter.error)
                return
            msg = waiter.msg
        rmeta, body, ratt = msg
        if rmeta.correlation_id != meta.correlation_id:
            shm_ring.client_complete(lease)
            ack_unused(rmeta, sock.id)
            with self._lock:
                if self._sock is sock:
                    self._drop()
            c.set_failed(Errno.ERESPONSE,
                         f"response for call {rmeta.correlation_id}, "
                         f"expected {meta.correlation_id}")
            return
        if rmeta.ici_domain:
            sock.ici_peer_domain = rmeta.ici_domain
        view = settle = None
        if rmeta.shm_offer or rmeta.shm_accept or rmeta.shm_desc \
                or offered or lease is not None:
            # learn the accept and the server's ring, settle the request
            # slot, resolve a response descriptor (an error answer proves
            # nothing about the capability)
            try:
                view, settle = shm_ring.client_on_response_meta(
                    sock, rmeta, offered_now=offered and not rmeta.error_code,
                    staged_slot=lease)
            except shm_ring.ShmDescriptorError as e:
                ack_unused(rmeta, sock.id)
                c.set_failed(Errno.ERESPONSE, str(e))
                return
        if rmeta.error_code:
            ack_unused(rmeta, sock.id)
            c.set_failed(rmeta.error_code, rmeta.error_text)
            return
        c.response = body
        c.response_attachment, c.response_device_attachment = \
            split_device_attachment(rmeta, ratt, sock.id)
        if view is not None:
            # the attachment rode the ring: its slot recycles when the
            # caller drops the view
            c.response_attachment = shm_ring.settled_view(view, settle)
        if stream is not None and rmeta.stream_id:
            # the accepted stream rides the connection that answered
            stream._bind(sock.id, rmeta.stream_id,
                         peer_window=rmeta.stream_window)

    @staticmethod
    def _read_response(sock: Socket):
        """The next response on ``sock``, read inline by a call or by the
        reader thread; acks and stream frames ahead of it are handed on."""
        while True:
            msg = read_frame(sock.conn)
            if isinstance(msg, AckFrame):
                process_ack(msg.ids, sock)
            elif isinstance(msg, StreamFrame):
                dispatch(msg, sock)
            else:
                return msg

    def _start_reader(self, sock: Socket) -> None:
        """From now on one thread reads ``sock`` (called under the lock,
        so no call is reading it)."""
        if self._reader_sock is sock:
            return
        sock.conn.settimeout(None)
        self._reader_sock = sock
        self._reader = threading.Thread(target=self._read_loop,
                                        args=(sock,), name="tpu_std-reader",
                                        daemon=True)
        self._reader.start()

    def _read_loop(self, sock: Socket) -> None:
        why = "connection closed"
        try:
            while True:
                msg = self._read_response(sock)
                with self._waiters_lock:
                    waiter = self._waiters.pop(msg[0].correlation_id, None)
                if waiter is None:
                    ack_unused(msg[0], sock.id)       # its call timed out
                else:
                    waiter.msg = msg
                    waiter.done.set()
        except (OSError, EOFError, FrameError) as e:
            why = f"{type(e).__name__}: {e}"
        finally:
            sock.close()            # closes the streams it carried
            with self._waiters_lock:
                waiters = list(self._waiters.values())
                self._waiters.clear()
            for waiter in waiters:
                waiter.error = why
                waiter.done.set()

    def _connect(self) -> Socket:
        if self._sock is not None and self._sock.failed:
            self._drop()
        if self._sock is None:
            conn = socket.create_connection(
                self.server.to_sockaddr(),
                timeout=self.options.connect_timeout_ms / 1e3)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = Socket(conn)
        return self._sock

    @staticmethod
    def _request_frame(c: Controller, sock: Socket, meta: RpcMeta,
                       payload: bytes, timeout_ms: int):
        """``(frame, shm slot lease, offer carried)``: the request frame,
        with the domain exchange, the device attachment and the shm lane;
        the frame is None after failing ``c``."""
        if ici_enabled():
            meta.ici_domain = local_domain_id()
            meta.ici_conn = conn_nonce_of(sock)
        attachment = c.request_attachment
        device = c.request_device_attachment is not None
        if device:
            # with ici off prepare_send sends the bytes inline itself: the
            # attachment is never dropped
            wait_s = min(_MAX_POST_WAIT_S, max(0.001, timeout_ms / 1e3))
            try:
                tail = prepare_send(sock, meta, c.request_device_attachment,
                                    timeout_s=wait_s)
            except RuntimeError as e:
                c.set_failed(Errno.EOVERCROWDED, str(e))
                return None, None, False
            if tail is not None:
                attachment = bytes(attachment) + tail if attachment else tail
        extra, lease, offered = b"", None, False
        if attachment or sock.shm is not None:
            extra, wire, lease, offered = shm_ring.client_prepare(
                sock, attachment or None, device=device)
            attachment = b"" if wire is None else wire
        try:
            return pack_frame(meta, payload, attachment, extra), lease, \
                offered
        except FrameError as e:
            shm_ring.client_complete(lease)
            c.set_failed(Errno.EREQUEST, str(e))
            return None, None, False

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
