"""gRPC client — h2 connection with multiplexed unary calls.

The client half of the h2/gRPC interop story (≈ the client paths of
brpc's src/brpc/policy/http2_rpc_protocol.cpp): one TCP
connection per peer, streams multiplexed, and ONE process-wide
selector-driven reader thread distributing frames to waiting callers
across ALL connections (h2 responses are unordered across streams, so
the tpu_std direct-read trick does not apply; a thread per connection
would not scale to pod-sized peer sets).

Used by Channel when ``options.protocol == "grpc"``; also usable
standalone against any gRPC server (oracle: grpcio in the tests).

A copy of ``brpc_tpu/client/grpc_client.py``, with TLS: a connection
made with an ``ssl_context`` (``Channel`` passes its own when
``ChannelOptions.ssl`` is on) wraps its socket after the connect and
reads on a thread of its own, since a TLS socket can neither be polled
for its buffered plaintext nor read with ``MSG_DONTWAIT``; that thread
reads under the connection's lock, so no read runs beside a write on the
one SSL object; the ``:scheme`` is then ``https``.
"""

from __future__ import annotations

import select
import selectors
import socket as _socket
import ssl
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..butil.endpoint import EndPoint
from ..butil.logging_util import LOG
from ..protocol.h2_rpc import GRPC_CT, pack_grpc_message, unpack_grpc_messages
from ..protocol.h2_session import H2Error, H2Session


class _SharedReader:
    """One selector loop reading for every GrpcConnection.

    Sockets stay BLOCKING: the loop issues exactly one recv per
    readiness event (select guarantees it cannot block), so writer
    threads keep their simple sendall path.  Register/unregister
    requests are queued and applied on the loop thread (selectors are
    not thread-safe), with a socketpair as the wakeup."""

    def __init__(self):
        self._sel = selectors.DefaultSelector()
        self._rd, self._wr = _socket.socketpair()
        self._rd.setblocking(False)
        self._wr.setblocking(False)    # _wake must never block a caller
                                       # holding a connection lock
        self._sel.register(self._rd, selectors.EVENT_READ, None)
        self._ops: deque = deque()     # ("add", sock, conn) | ("del", sock)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop,
                                            name="grpc_shared_reader",
                                            daemon=True)
            self._thread.start()

    def _wake(self) -> None:
        try:
            self._wr.send(b"x")
        except OSError:
            pass

    def register(self, sock: _socket.socket, conn: "GrpcConnection") -> None:
        with self._lock:
            self._ops.append(("add", sock, conn))
            self._ensure_thread()
        self._wake()

    def unregister(self, sock: _socket.socket) -> None:
        """Queue removal; the loop thread closes the socket after
        deregistering (closing first would poison the selector)."""
        with self._lock:
            self._ops.append(("del", sock, None))
            self._ensure_thread()      # a dead loop must still close fds
        self._wake()

    def _apply_ops(self) -> None:
        while True:
            with self._lock:
                if not self._ops:
                    return
                op, sock, conn = self._ops.popleft()
            try:
                if op == "add":
                    self._sel.register(sock, selectors.EVENT_READ, conn)
                else:
                    try:
                        self._sel.unregister(sock)
                    except (KeyError, ValueError):
                        pass
                    try:
                        sock.close()
                    except OSError:
                        pass
            except (OSError, ValueError) as e:
                LOG.warning("grpc shared reader op %s failed: %s", op, e)

    def _loop(self) -> None:
        while True:
            self._apply_ops()
            try:
                events = self._sel.select(1.0)
            except OSError:
                # a registered fd died outside the queue (should not
                # happen; defensive): rebuild by dropping dead entries
                for key in list(self._sel.get_map().values()):
                    if key.data is not None and key.fileobj.fileno() < 0:
                        try:
                            self._sel.unregister(key.fileobj)
                        except (KeyError, ValueError):
                            pass
                continue
            for key, _mask in events:
                if key.data is None:
                    try:
                        self._rd.recv(4096)
                    except OSError:
                        pass
                    continue
                try:
                    key.data._on_readable(key.fileobj)
                except Exception as e:   # noqa: BLE001 - blast radius:
                    # ONE connection, never the process-wide loop
                    LOG.exception("grpc reader: connection dispatch "
                                  "raised")
                    try:
                        key.data._fail_all(f"reader: {e}")
                    except Exception:
                        pass


_shared_reader: Optional[_SharedReader] = None
_shared_reader_lock = threading.Lock()


def shared_reader() -> _SharedReader:
    global _shared_reader
    with _shared_reader_lock:
        if _shared_reader is None:
            _shared_reader = _SharedReader()
        return _shared_reader


class _Call:
    __slots__ = ("event", "headers", "trailers", "body", "rst_code",
                 "streaming", "msgs", "cond", "ended")

    def __init__(self, streaming: bool = False):
        self.event = threading.Event()
        self.headers: List[Tuple[str, str]] = []
        self.trailers: List[Tuple[str, str]] = []
        self.body = bytearray()
        self.rst_code: Optional[int] = None
        self.streaming = streaming
        self.msgs: List[bytes] = []        # streaming: decoded messages
        self.cond = threading.Condition()
        self.ended = False

    def header(self, name: str, default: str = "") -> str:
        for n, v in self.trailers:
            if n == name:
                return v
        for n, v in self.headers:
            if n == name:
                return v
        return default


class GrpcConnection:
    """One h2 connection; thread-safe; reconnects lazily after failure."""

    def __init__(self, remote: EndPoint, connect_timeout_s: float = 2.0,
                 ssl_context=None):
        self._remote = remote
        self._connect_timeout_s = connect_timeout_s
        self._ssl_context = ssl_context
        self._lock = threading.Lock()        # guards session + socket writes
        self._sock: Optional[_socket.socket] = None
        self._session: Optional[H2Session] = None
        self._calls: Dict[int, _Call] = {}
        self._dead = True

    # -- connection management --------------------------------------------

    def _ensure_connected(self) -> None:
        with self._lock:
            if not self._dead and self._sock is not None:
                return
            sock = _socket.create_connection(
                self._remote.to_sockaddr(),
                timeout=self._connect_timeout_s)
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            if self._ssl_context is not None:
                # a bounded blocking handshake, as the tpu_std client's
                sock.settimeout(self._connect_timeout_s + 4.0)
                sock = self._ssl_context.wrap_socket(
                    sock, server_hostname=str(self._remote.host))
            sock.settimeout(None)
            self._sock = sock
            self._session = H2Session(is_server=False)
            self._session.start()
            self._flush_locked()
            self._dead = False
            if self._ssl_context is None:
                shared_reader().register(sock, self)
            else:
                threading.Thread(target=self._tls_read_loop, args=(sock,),
                                 name="grpc_tls_reader",
                                 daemon=True).start()

    def _flush_locked(self) -> None:
        out = self._session.take_output()
        if out and self._sock is not None:
            self._sock.sendall(out)

    def _fail_all(self, why: str) -> None:
        with self._lock:
            self._dead = True
            calls = list(self._calls.values())
            self._calls.clear()
            if self._sock is not None:
                if self._ssl_context is None:
                    # the reader loop deregisters, then closes
                    shared_reader().unregister(self._sock)
                else:
                    # wakes the connection's reader, which closes it
                    try:
                        self._sock.shutdown(_socket.SHUT_RDWR)
                    except OSError:
                        pass
            self._sock = None
        for call in calls:
            call.rst_code = -1
            call.trailers = [("grpc-status", "14"),      # UNAVAILABLE
                             ("grpc-message", why)]
            with call.cond:
                call.ended = True
                call.cond.notify_all()
            call.event.set()

    def _on_readable(self, sock: _socket.socket) -> None:
        """Runs on the shared reader loop: one recv (select said it
        cannot block), feed the session, dispatch events."""
        with self._lock:
            if sock is not self._sock:
                # superseded by a reconnect: drop the orphan
                shared_reader().unregister(sock)
                return
            session = self._session
        try:
            # MSG_DONTWAIT: the socket itself stays blocking for the
            # writers' sendall, but a spurious readiness event (select
            # raced a discarded packet) must not hang the shared loop
            data = sock.recv(256 * 1024, _socket.MSG_DONTWAIT)
        except BlockingIOError:
            return                     # spurious readiness
        except OSError as e:
            self._fail_all(f"recv: {e}")
            return
        self._on_data(session, data)

    def _tls_read_loop(self, sock) -> None:
        """A TLS connection's reader, until the connection fails or is
        superseded, then the socket closes.  One SSL object must not be
        used by two threads at once: the reader waits for the descriptor
        without the lock and reads under it, without blocking, so no
        read runs beside a writer's ``sendall``."""
        try:
            while True:
                try:
                    if not sock.pending():
                        select.select([sock], [], [])
                    with self._lock:
                        if sock is not self._sock:
                            return
                        session = self._session
                        sock.setblocking(False)
                        try:
                            data = sock.recv(256 * 1024)
                        except (ssl.SSLWantReadError, ssl.SSLWantWriteError,
                                BlockingIOError):
                            continue
                        finally:
                            sock.setblocking(True)
                except (OSError, ValueError) as e:
                    self._fail_all(f"recv: {e}")
                    return
                if not self._on_data(session, data):
                    return
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _on_data(self, session, data: bytes) -> bool:
        """Feed one read's bytes to the session and dispatch its events;
        False once the connection is done."""
        if not data:
            self._fail_all("connection closed by server")
            return False
        try:
            with self._lock:
                if self._session is not session:
                    return False             # superseded mid-recv
                events = session.feed(data)
                self._flush_locked()
        except (H2Error, OSError) as e:
            self._fail_all(f"h2: {e}")
            return False
        for ev in events:
            self._on_event(ev)
        return True

    def _on_event(self, ev: tuple) -> None:
        kind = ev[0]
        if kind == "headers":
            _, sid, headers, end = ev
            call = self._calls.get(sid)
            if call is None:
                return
            if call.headers:
                call.trailers = headers
            else:
                call.headers = headers
            if end:
                self._finish(sid)
        elif kind == "data":
            _, sid, body, end = ev
            call = self._calls.get(sid)
            if call is None:
                return
            call.body += body
            if call.streaming:
                with call.cond:
                    try:
                        call.msgs.extend(unpack_grpc_messages(call.body))
                    except H2Error:
                        call.rst_code = -2
                        self._finish(sid)
                        return
                    call.cond.notify_all()
            if end:
                self._finish(sid)
        elif kind == "rst":
            _, sid, code = ev
            call = self._calls.get(sid)
            if call is not None:
                call.rst_code = code
                self._finish(sid)
        elif kind == "goaway":
            self._fail_all(f"goaway code={ev[2]}")

    def _finish(self, sid: int) -> None:
        with self._lock:
            call = self._calls.pop(sid, None)
            if self._session is not None:
                self._session.close_stream(sid)
        if call is not None:
            with call.cond:
                call.ended = True
                call.cond.notify_all()
            call.event.set()

    # -- calls -------------------------------------------------------------

    def _request_headers(self, path: str, timeout_s: float,
                         metadata) -> List[Tuple[str, str]]:
        return [
            (":method", "POST"),
            (":scheme", "http" if self._ssl_context is None else "https"),
            (":path", path),
            (":authority", str(self._remote)),
            ("content-type", GRPC_CT),
            ("te", "trailers"),
            ("grpc-timeout", f"{max(1, int(timeout_s * 1000))}m"),
        ] + list(metadata or [])

    def unary_call(self, path: str, payload: bytes,
                   timeout_s: float = 30.0,
                   metadata: Optional[List[Tuple[str, str]]] = None
                   ) -> Tuple[int, str, bytes]:
        """Returns (grpc_status, message, response_bytes).  14/UNAVAILABLE
        on transport failure, 4/DEADLINE_EXCEEDED on timeout."""
        try:
            self._ensure_connected()
        except OSError as e:
            return 14, f"connect to {self._remote}: {e}", b""
        call = _Call()
        with self._lock:
            if self._dead:
                return 14, "connection lost", b""
            sid = self._session.next_stream_id()
            self._calls[sid] = call
            headers = self._request_headers(path, timeout_s, metadata)
            try:
                self._session.send_headers(sid, headers)
                self._session.send_data(sid, pack_grpc_message(payload),
                                        end_stream=True)
                self._flush_locked()
            except OSError as e:
                self._calls.pop(sid, None)
                self._fail_all(f"send: {e}")
                return 14, f"send: {e}", b""
        if not call.event.wait(timeout_s):
            with self._lock:
                self._calls.pop(sid, None)
                if self._session is not None:
                    try:
                        self._session.send_rst(sid, 0x8)   # CANCEL
                        self._flush_locked()
                    except OSError:
                        pass
            return 4, f"deadline {timeout_s}s exceeded", b""
        if call.rst_code not in (None, -1):
            return 13, f"stream reset (h2 code {call.rst_code})", b""
        status_s = call.header("grpc-status", "2")
        status = int(status_s) if status_s.isdigit() else 2
        message = call.header("grpc-message")
        body = b""
        if call.body:
            buf = bytearray(call.body)
            try:
                msgs = unpack_grpc_messages(buf)
                body = msgs[0] if msgs else b""
            except H2Error as e:
                return 13, f"bad response framing: {e}", b""
        return status, message, body

    def streaming_call(self, path: str, timeout_s: float = 30.0,
                       metadata: Optional[List[Tuple[str, str]]] = None
                       ) -> "GrpcStreamCall":
        """Open a full-duplex gRPC stream (covers server-streaming,
        client-streaming and bidi): write() request messages, read()
        response messages, done_writing() to half-close, status()/
        message() after the response stream ends."""
        self._ensure_connected()
        call = _Call(streaming=True)
        with self._lock:
            if self._dead:
                raise ConnectionError("connection lost")
            sid = self._session.next_stream_id()
            self._calls[sid] = call
            self._session.send_headers(
                sid, self._request_headers(path, timeout_s, metadata))
            self._flush_locked()
        return GrpcStreamCall(self, sid, call, timeout_s)

    def close(self) -> None:
        self._fail_all("closed")


class GrpcStreamCall:
    """Client end of one gRPC stream."""

    def __init__(self, conn: GrpcConnection, sid: int, call: _Call,
                 timeout_s: float):
        self._conn = conn
        self._sid = sid
        self._call = call
        self._timeout_s = timeout_s
        self._half_closed = False

    # -- sending -----------------------------------------------------------

    def write(self, payload: bytes) -> None:
        if self._half_closed:
            raise RuntimeError("write after done_writing")
        if self._call.ended:
            # the server already finished: framing DATA on a closed h2
            # stream is a connection error that would kill every call
            # multiplexed on this connection
            raise ConnectionError(
                f"stream finished (grpc-status {self.status()})")
        with self._conn._lock:
            if self._conn._dead:
                raise ConnectionError("connection lost")
            self._conn._session.send_data(self._sid,
                                          pack_grpc_message(payload))
            self._conn._flush_locked()

    def done_writing(self) -> None:
        """Half-close: no more request messages."""
        if self._half_closed:
            return
        self._half_closed = True
        if self._call.ended:
            return
        with self._conn._lock:
            if self._conn._dead:
                return
            self._conn._session.send_data(self._sid, b"", end_stream=True)
            self._conn._flush_locked()

    # -- receiving ---------------------------------------------------------

    def read(self, timeout_s: Optional[float] = None) -> Optional[bytes]:
        """Next response message; None when the server finished."""
        call = self._call
        deadline = timeout_s if timeout_s is not None else self._timeout_s
        with call.cond:
            ok = call.cond.wait_for(lambda: call.msgs or call.ended,
                                    deadline)
            if call.msgs:
                return call.msgs.pop(0)
            if not ok:
                raise TimeoutError("grpc stream read timed out")
            return None

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        msg = self.read()
        if msg is None:
            raise StopIteration
        return msg

    def cancel(self) -> None:
        with self._conn._lock:
            if not self._conn._dead and self._conn._session is not None:
                try:
                    self._conn._session.send_rst(self._sid, 0x8)  # CANCEL
                    self._conn._flush_locked()
                except OSError:
                    pass
        self._conn._finish(self._sid)

    # -- completion --------------------------------------------------------

    def status(self) -> int:
        s = self._call.header("grpc-status", "2")
        return int(s) if s.isdigit() else 2

    def message(self) -> str:
        return self._call.header("grpc-message")

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        return self._call.event.wait(
            timeout_s if timeout_s is not None else self._timeout_s)


_conns_lock = threading.Lock()
_conns: Dict[tuple, GrpcConnection] = {}


def grpc_connection(remote: EndPoint, ssl_context=None) -> GrpcConnection:
    """The process's shared connection to ``remote`` (one per TLS
    context: a TLS and a plaintext caller of one peer never share)."""
    key = (remote, id(ssl_context) if ssl_context is not None else 0)
    with _conns_lock:
        conn = _conns.get(key)
        if conn is None:
            conn = _conns[key] = GrpcConnection(remote,
                                                ssl_context=ssl_context)
        return conn
