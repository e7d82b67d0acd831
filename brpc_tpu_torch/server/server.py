"""Server — serves registered services over tpu_std.

The slim core of ``brpc_tpu/server/server.py``: ``add_service``,
``start``, ``listen_endpoint`` and ``stop``, with one accept thread and
one thread per connection on blocking sockets.  A connection's requests
are answered in order.  Each connection is a
:class:`~brpc_tpu_torch.transport.Socket`, which carries the device
attachment lane's state (``brpc_tpu/server/rpc_dispatch.py`` and
``interceptors.py``): the server learns the peer's fabric domain and pins
its connection nonce from the request meta, splits the request's device
attachment off, answers the domain exchange, settles the request
attachment before it writes the response (so the credit return precedes
it), sends the response's device attachment through ``prepare_send``
(``EOVERCROWDED`` when the window stays full), takes inbound TICI ack
frames, and reclaims a connection's descriptors when it closes.  Streams
(``brpc_tpu/server/rpc_dispatch.py``): a method accepts the request's
stream with ``streaming.stream_accept``, the response meta carries the
accepted stream's id and window, a failed call closes the stream it
accepted, and inbound TSTR frames (the peer's acks and closes) go to
their stream.  Frames written by other threads on a stream (a decode
batcher's tokens) share the connection's write lock with the responses.
The shm data plane (``brpc_tpu/server/interceptors.py`` and
``rpc_dispatch.py``, ``transport/shm_ring.py``): the server takes a
request's ring offer, accept and release TLVs, resolves a request
descriptor into a view of the client's ring (an unresolvable one answers
EREQUEST), answers every response of that request with the accept and
its own ring's spec, and moves a response attachment of the threshold
or more onto the ring once it can (re-describing the request's slot when
the handler echoes its view; the rest under a named reason), after the
response has serialized.  ``stop`` waits a bounded time for this
process's ring slots to settle.
Observability (``brpc_tpu/server/interceptors.py``'s tpu_std epilogue):
each method has a :class:`~brpc_tpu_torch.server.method_status.MethodStatus`
(a latency recorder and an error counter, exposed as
``rpc_server_<service>_<method>``), settled once per request after its
response has serialized, the error path included, with the latency from
the frame's arrival; and each request of a known method gets an rpcz
server span (``rpcz.start_server_span``: forced for a traced request,
passively sampled under ``rpcz_max_samples_per_second`` otherwise),
backdated to the frame's arrival, on ``cntl.span`` for the handler, and
finished with the response's size and error code.  ``start`` starts the
bvar file dump when its flag is on.
It speaks tpu_std only; the JAX server's other protocols, native engine,
admission, concurrency limiters and draining wait for later slices of
the port.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ..butil.endpoint import EndPoint, parse_endpoint
from ..butil.flags import get_flag
from ..butil.status import Errno
from ..bvar.dump import ensure_dumper
from ..ici.endpoint import (ici_enabled, prepare_send, process_ack,
                            split_device_attachment)
from ..ici.fabric import local_domain_id
from ..protocol.meta import RpcMeta
from ..protocol.streaming import StreamFrame, dispatch
from ..protocol.tpu_std import (AckFrame, FrameError, pack_frame, read_frame,
                                serialize_payload)
from ..rpcz import backdate_span, start_server_span
from ..transport import shm_ring
from ..transport.socket import Socket
from .controller import ServerController
from .method_status import MethodStatus
from .service import extract_methods, service_name_of

LOG = logging.getLogger(__name__)
_ACCEPT_POLL_S = 0.2
_JOIN_TIMEOUT_S = 5.0
_POST_TIMEOUT_S = 5.0       # a response descriptor's wait for window credit
_DRAIN_S = 1.0              # stop's wait for the ring's slots to settle


class Server:
    def __init__(self):
        self._services: Dict[str, Any] = {}
        self._methods: Dict[Tuple[str, str], Callable] = {}
        self._status: Dict[Tuple[str, str], MethodStatus] = {}
        self._listener: Optional[socket.socket] = None
        self._listen_endpoint: Optional[EndPoint] = None
        self._threads: list = []
        self._conns: set = set()
        self._lock = threading.Lock()
        self._stopping = threading.Event()

    def add_service(self, service: Any, name: str = "") -> int:
        """Register ``service`` under ``name`` (default: its class name);
        its public methods become ``name.Method``.  0 on success."""
        if self._listener is not None:
            LOG.error("add_service after start")
            return -1
        sname = name or service_name_of(service)
        if sname in self._services:
            LOG.error("service %s already added", sname)
            return -1
        methods = extract_methods(service)
        if not methods:
            LOG.error("service %s has no public methods", sname)
            return -1
        self._services[sname] = service
        for mname, fn in methods.items():
            self._methods[(sname, mname)] = fn
            self._status[(sname, mname)] = MethodStatus(f"{sname}.{mname}")
        return 0

    def method_status(self, full_name: str) -> Optional[MethodStatus]:
        """``"Service.Method"``'s MethodStatus (None for an unknown one)."""
        svc, _, mth = full_name.rpartition(".")
        return self._status.get((svc, mth))

    def start(self, addr: Any = "127.0.0.1:0") -> int:
        """Listen on ``addr`` ("ip:port"; port 0 picks a free one) and
        start accepting.  0 on success."""
        if self._listener is not None:
            LOG.error("server already started")
            return -1
        ep = addr if isinstance(addr, EndPoint) else parse_endpoint(str(addr))
        family = socket.AF_INET6 if ":" in ep.host else socket.AF_INET
        lsock = socket.socket(family, socket.SOCK_STREAM)
        try:
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lsock.bind(ep.to_sockaddr())
            lsock.listen(128)
        except OSError as e:
            lsock.close()
            LOG.error("cannot listen on %s: %s", ep, e)
            return -1
        lsock.settimeout(_ACCEPT_POLL_S)
        host, port = lsock.getsockname()[:2]
        self._listener = lsock
        self._listen_endpoint = EndPoint(host=host, port=port)
        self._stopping.clear()
        self._spawn(self._accept_loop, "tpu_std-accept")
        ensure_dumper()     # a no-op unless the bvar_dump flag is on
        return 0

    @property
    def listen_endpoint(self) -> Optional[EndPoint]:
        return self._listen_endpoint

    def stop(self) -> int:
        """Close the listener and every connection, and join the threads
        (a request being served is let finish, up to a timeout)."""
        if self._listener is None:
            return 0
        self._stopping.set()
        with self._lock:
            conns = list(self._conns)
            threads = list(self._threads)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in threads:
            t.join(_JOIN_TIMEOUT_S)
        left = shm_ring.drain_settle(time.monotonic() + _DRAIN_S)
        if left:
            LOG.warning("stop: %d shm slot(s) of this process still "
                        "outstanding", left)
        self._listener.close()
        self._listener = None
        self._listen_endpoint = None
        self._threads = []
        return 0

    # -- internals ---------------------------------------------------------

    def _spawn(self, target, name: str, *args) -> None:
        t = threading.Thread(target=target, args=args, name=name,
                             daemon=True)
        with self._lock:
            self._threads.append(t)
        t.start()

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.add(conn)
            self._spawn(self._serve_conn, "tpu_std-conn", conn,
                        EndPoint(host=peer[0], port=peer[1]))

    def _serve_conn(self, conn: socket.socket, peer: EndPoint) -> None:
        sock = Socket(conn, remote_side=peer)
        try:
            while not self._stopping.is_set():
                try:
                    msg = read_frame(conn)
                except (EOFError, OSError):
                    return
                except FrameError as e:
                    LOG.warning("closing %s: %s", peer, e)
                    return
                recv_ns = time.monotonic_ns()
                if isinstance(msg, AckFrame):
                    process_ack(msg.ids, sock)
                    continue
                if isinstance(msg, StreamFrame):
                    dispatch(msg, sock)
                    continue
                # acks queued while serving ride in front of the response
                sock.defer_acks = True
                try:
                    sock.write(self._dispatch(*msg, sock, recv_ns))
                finally:
                    sock.defer_acks = False
                sock.flush_acks()
        except OSError:
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)
            sock.close()

    def _dispatch(self, meta: RpcMeta, payload: bytes, att: bytes,
                  sock: Socket, recv_ns: int) -> bytes:
        """One request frame's fields -> the response frame.  A known
        method's MethodStatus and span are settled here, once, after the
        response frame exists (``recv_ns``: the frame's arrival on the
        monotonic clock)."""
        status = self._status.get((meta.service_name, meta.method_name))
        if status is None:
            # an unknown method: no status and no span, as in the JAX
            # package
            return self._answer(meta, payload, att, sock, None, recv_ns)[0]
        status.on_requested()
        frame, code, span = self._answer(meta, payload, att, sock, status,
                                         recv_ns)
        status.on_responded(code, (time.monotonic_ns() - recv_ns) // 1000)
        if span is not None:
            span.finish(code)
        return frame

    def _answer(self, meta: RpcMeta, payload: bytes, att: bytes,
                sock: Socket, status: Optional[MethodStatus], recv_ns: int):
        """``(response frame, error code, span or None)``."""
        if meta.ici_domain:
            sock.ici_peer_domain = meta.ici_domain
        if meta.ici_conn and sock.ici_conn_token is None:
            sock.ici_conn_token = meta.ici_conn     # first write wins
        att, dev_att = split_device_attachment(meta, att, sock.id)
        shm_extra, handle = b"", None
        if meta.shm_offer or meta.shm_accept or meta.shm_release \
                or meta.shm_desc:
            view, handle, shm_extra = shm_ring.server_on_request_meta(sock,
                                                                       meta)
            if view is not None:
                att = view      # the attachment never rode the frame
            elif meta.shm_desc:
                if dev_att is not None:
                    dev_att.settle()
                return self._error_frame(meta, Errno.EREQUEST,
                                         "unresolvable shm attachment "
                                         "descriptor", shm_extra), \
                    int(Errno.EREQUEST), None
        cntl = ServerController(meta, sock.remote_side, att, sock.id)
        cntl.request_device_attachment = dev_att
        if status is not None:
            span = start_server_span(status.full_name, meta,
                                     sock.remote_side)
            if span is not None:
                span.request_size = len(payload) + len(att)
                backdate_span(span, recv_ns)
                cntl.span = span
        fn = self._methods.get((meta.service_name, meta.method_name))
        response = None
        if fn is None:
            known = meta.service_name in self._services
            cntl.set_failed(Errno.ENOMETHOD if known else Errno.ENOSERVICE,
                            f"unknown {meta.service_name}."
                            f"{meta.method_name}")
        elif meta.compress_type:
            cntl.set_failed(Errno.EREQUEST,
                            f"unsupported compress_type {meta.compress_type}")
        else:
            try:
                response = fn(cntl, payload)
            except Exception as e:  # a failing method answers EINTERNAL
                LOG.exception("method %s.%s raised", meta.service_name,
                              meta.method_name)
                cntl.set_failed(Errno.EINTERNAL, f"{type(e).__name__}: {e}")
        if dev_att is not None:
            # the credit return for a request descriptor precedes the
            # response: redeemed in the handler, its ack is queued; never
            # redeemed, settle acks it now
            dev_att.settle()
        out = RpcMeta()
        out.correlation_id = meta.correlation_id
        if meta.ici_domain and ici_enabled():
            out.ici_domain = local_domain_id()   # answer the exchange
        if not cntl.failed:
            if cntl._accepted_stream_id:
                out.stream_id = cntl._accepted_stream_id
                out.stream_window = cntl._accepted_stream_window
            frame = self._response_frame(cntl, out, response, sock, handle,
                                         shm_extra)
            if frame is not None:
                return frame, 0, cntl.span
        if cntl._accepted_stream_id:
            # the client never binds a stream of a failed call
            from ..streaming import find_stream
            stream = find_stream(cntl._accepted_stream_id)
            if stream is not None:
                stream._close_local(notify_peer=False)
        return self._error_frame(meta, cntl.error_code, cntl.error_text,
                                 shm_extra, out.ici_domain), \
            cntl.error_code, cntl.span

    @staticmethod
    def _error_frame(meta: RpcMeta, code: int, text: str, shm_extra: bytes,
                     ici_domain: bytes = b"") -> bytes:
        err = RpcMeta()
        err.correlation_id = meta.correlation_id
        err.ici_domain = ici_domain
        err.error_code = code
        err.error_text = text
        return pack_frame(err, extra_meta=shm_extra)

    @staticmethod
    def _response_frame(cntl: ServerController, out: RpcMeta, response,
                        sock: Socket, handle, shm_extra: bytes
                        ) -> Optional[bytes]:
        """The success frame, or None after failing ``cntl``.  The
        response attachment moves to the ring only once the response has
        serialized, so a failure cannot strand a staged slot."""
        try:
            body = serialize_payload(response)
        except TypeError as e:
            cntl.set_failed(Errno.EINTERNAL,
                            f"response serialization failed: {e}")
            return None
        attachment = cntl.response_attachment
        device = cntl.response_device_attachment is not None
        if device:
            try:
                tail = prepare_send(sock, out, cntl.response_device_attachment,
                                    timeout_s=_POST_TIMEOUT_S)
            except RuntimeError as e:
                cntl.set_failed(Errno.EOVERCROWDED, str(e))
                return None
        shm_desc = b""
        if attachment:
            if sock.shm is not None and not device:
                shm_desc, attachment = shm_ring.describe_response_att(
                    sock, attachment, handle)
                attachment = attachment or b""
            elif shm_ring.lane_enabled() and len(attachment) >= int(
                    get_flag("rpc_shm_threshold")):
                # kept off the ring by the response's shape, or the peer
                # never spoke a shm TLV
                shm_ring.count_fallback("shm_device_combo" if device
                                        else "shm_peer_no_cap")
        if device and tail is not None:
            attachment = bytes(attachment) + tail if attachment else tail
        if cntl.span is not None:
            cntl.span.response_size = len(body) + len(attachment or b"")
        try:
            return pack_frame(out, body, attachment, shm_extra + shm_desc)
        except FrameError as e:
            shm_ring.unstage_response(shm_desc)
            cntl.set_failed(Errno.EINTERNAL, f"response too large: {e}")
            return None
