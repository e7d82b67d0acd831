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
It speaks tpu_std only; the JAX server's other protocols, native engine,
admission, tracing and draining wait for later slices of the port.
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from ..butil.endpoint import EndPoint, parse_endpoint
from ..butil.status import Errno
from ..ici.endpoint import (ici_enabled, prepare_send, process_ack,
                            split_device_attachment)
from ..ici.fabric import local_domain_id
from ..protocol.meta import RpcMeta
from ..protocol.streaming import StreamFrame, dispatch
from ..protocol.tpu_std import (AckFrame, FrameError, pack_frame, read_frame,
                                serialize_payload)
from ..transport.socket import Socket
from .controller import ServerController
from .service import extract_methods, service_name_of

LOG = logging.getLogger(__name__)
_ACCEPT_POLL_S = 0.2
_JOIN_TIMEOUT_S = 5.0
_POST_TIMEOUT_S = 5.0       # a response descriptor's wait for window credit


class Server:
    def __init__(self):
        self._services: Dict[str, Any] = {}
        self._methods: Dict[Tuple[str, str], Callable] = {}
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
        return 0

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
                if isinstance(msg, AckFrame):
                    process_ack(msg.ids, sock)
                    continue
                if isinstance(msg, StreamFrame):
                    dispatch(msg, sock)
                    continue
                # acks queued while serving ride in front of the response
                sock.defer_acks = True
                try:
                    sock.write(self._dispatch(*msg, sock))
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
                  sock: Socket) -> bytes:
        """One request frame's fields -> the response frame."""
        if meta.ici_domain:
            sock.ici_peer_domain = meta.ici_domain
        if meta.ici_conn and sock.ici_conn_token is None:
            sock.ici_conn_token = meta.ici_conn     # first write wins
        att, dev_att = split_device_attachment(meta, att, sock.id)
        cntl = ServerController(meta, sock.remote_side, att, sock.id)
        cntl.request_device_attachment = dev_att
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
            frame = self._response_frame(cntl, out, response, sock)
            if frame is not None:
                return frame
        if cntl._accepted_stream_id:
            # the client never binds a stream of a failed call
            from ..streaming import find_stream
            stream = find_stream(cntl._accepted_stream_id)
            if stream is not None:
                stream._close_local(notify_peer=False)
        err = RpcMeta()
        err.correlation_id = meta.correlation_id
        err.ici_domain = out.ici_domain
        err.error_code = cntl.error_code
        err.error_text = cntl.error_text
        return pack_frame(err)

    @staticmethod
    def _response_frame(cntl: ServerController, out: RpcMeta, response,
                        sock: Socket) -> Optional[bytes]:
        """The success frame, or None after failing ``cntl``."""
        try:
            body = serialize_payload(response)
        except TypeError as e:
            cntl.set_failed(Errno.EINTERNAL,
                            f"response serialization failed: {e}")
            return None
        attachment = cntl.response_attachment
        if cntl.response_device_attachment is not None:
            try:
                tail = prepare_send(sock, out, cntl.response_device_attachment,
                                    timeout_s=_POST_TIMEOUT_S)
            except RuntimeError as e:
                cntl.set_failed(Errno.EOVERCROWDED, str(e))
                return None
            if tail is not None:
                attachment = bytes(attachment) + tail if attachment else tail
        try:
            return pack_frame(out, body, attachment)
        except FrameError as e:
            cntl.set_failed(Errno.EINTERNAL, f"response too large: {e}")
            return None
