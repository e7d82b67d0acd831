"""HTTP/2 server protocol + gRPC semantics on the shared port.

Capability parity with brpc's src/brpc/policy/http2_rpc_protocol.cpp
+ src/brpc/grpc.*: the same port that speaks tpu_std/HTTP/1/streaming
also accepts h2 connections (detected by the client preface).  Requests
with content-type ``application/grpc`` get full gRPC unary semantics
(5-byte message framing, ``/package.Service/Method`` routing into the
regular service registry, grpc-status/grpc-message trailers,
grpc-timeout); other h2 requests are served the builtin portal pages —
the JSON/RPC bridge stays on HTTP/1.

The oracle for this implementation is the real ``grpcio`` package: a
grpcio client calls this server and a grpcio server answers this
framework's h2 client.

A copy of ``brpc_tpu/protocol/h2_rpc.py`` for the port's bytes payloads
(a request reaches the method as ``bytes``; a response serializes as the
tpu_std lane's does).  A unary call finishes when the handler returns,
or, after the handler called ``cntl.begin_async()``, when it calls
``cntl.finish``.  Two differences, taken from the port's
tpu_std lane so that one server's lanes measure alike: a unary call's
server span is backdated to the stream's assembly, and its latency runs
from it.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Tuple

from ..butil.iobuf import IOBuf
from ..butil.logging_util import LOG
from ..butil.status import Errno
from ..butil.time_utils import monotonic_us
from ..deadline import arm as _arm_deadline
from ..deadline import inherit_deadline as _inherit_deadline
from ..deadline import maybe_shed as _maybe_shed
from .base import (ParseResult, Protocol, ProtocolType, max_body_size,
                   register_protocol)
from .h2_session import (PREFACE, E_NO_ERROR, E_PROTOCOL, H2Error,
                         H2Session)

GRPC_CT = "application/grpc"

# Errno -> grpc-status (status.proto codes); default UNKNOWN(2)
_ERRNO_TO_GRPC = {
    0: 0,
    int(Errno.ENOSERVICE): 12,      # UNIMPLEMENTED
    int(Errno.ENOMETHOD): 12,
    int(Errno.EREQUEST): 3,         # INVALID_ARGUMENT
    int(Errno.ERPCAUTH): 16,        # UNAUTHENTICATED
    int(Errno.ELIMIT): 8,           # RESOURCE_EXHAUSTED
    int(Errno.EOVERCROWDED): 8,
    int(Errno.ERPCTIMEDOUT): 4,     # DEADLINE_EXCEEDED
    int(Errno.EINTERNAL): 13,       # INTERNAL
}


def grpc_status_of(errno_code: int) -> int:
    return _ERRNO_TO_GRPC.get(int(errno_code), 2)


_GRPC_TO_ERRNO = {
    0: 0,
    3: int(Errno.EREQUEST),
    4: int(Errno.ERPCTIMEDOUT),
    8: int(Errno.ELIMIT),
    12: int(Errno.ENOMETHOD),
    13: int(Errno.EINTERNAL),
    14: int(Errno.EFAILEDSOCKET),
    16: int(Errno.ERPCAUTH),
}


def errno_of_grpc_status(status: int) -> int:
    return _GRPC_TO_ERRNO.get(int(status), int(Errno.EINTERNAL))


def pack_grpc_message(payload: bytes) -> bytes:
    return b"\x00" + struct.pack(">I", len(payload)) + payload


_GRPC_TIMEOUT_UNIT_MS = {"H": 3600_000.0, "M": 60_000.0, "S": 1000.0,
                         "m": 1.0, "u": 1e-3, "n": 1e-6}


def parse_grpc_timeout(value: str) -> Optional[int]:
    """``grpc-timeout`` header (1-8 digits + one of HMSmun) → remaining
    milliseconds, or None when malformed.  Sub-millisecond values floor
    to 0 — which means expired-at-arrival, matching ``x-deadline-ms: 0``
    and distinct from an ABSENT header (no deadline)."""
    if not value or len(value) > 9:
        return None
    digits, unit = value[:-1], value[-1]
    if not digits.isdigit() or unit not in _GRPC_TIMEOUT_UNIT_MS:
        return None
    return int(int(digits) * _GRPC_TIMEOUT_UNIT_MS[unit])


def unpack_grpc_messages(buf: bytearray) -> List[bytes]:
    """Cut complete length-prefixed messages off ``buf`` (mutates)."""
    out = []
    while len(buf) >= 5:
        compressed = buf[0]
        (ln,) = struct.unpack_from(">I", buf, 1)
        if len(buf) < 5 + ln:
            break
        if compressed:
            raise H2Error(E_PROTOCOL, "compressed grpc message "
                                      "(no grpc-encoding negotiated)")
        out.append(bytes(buf[5:5 + ln]))
        del buf[:5 + ln]
    return out


def resolve_grpc_entry(server, path: str):
    """``/package.Service/Method`` → method entry (the registry is keyed
    by bare service name; package-qualified paths fall back)."""
    parts = [p for p in path.split("/") if p]
    if len(parts) != 2:
        return None
    svc_full, method = parts
    entry = server.find_method(svc_full, method)
    if entry is None and "." in svc_full:
        entry = server.find_method(svc_full.rsplit(".", 1)[-1], method)
    return entry


class H2Request:
    __slots__ = ("stream_id", "headers", "body", "conn", "recv_us")

    def __init__(self, stream_id: int, headers: List[Tuple[str, str]],
                 body: bytes, conn: "H2ServerConn"):
        self.stream_id = stream_id
        self.headers = headers
        self.body = body
        self.conn = conn
        # arrival anchor for the deadline plane (grpc-timeout): stamped
        # when the stream's END_STREAM completed assembly — fiber
        # queueing between here and dispatch counts against the budget
        self.recv_us = monotonic_us()

    def header(self, name: str) -> str:
        for n, v in self.headers:
            if n == name:
                return v
        return ""


class GrpcServerStream:
    """Live full-duplex gRPC stream on the server: the handler reads
    request messages by iterating, pushes responses with write(), and
    the dispatcher sends trailers when the handler returns.
    ≈ the reference's full-duplex h2 streams (grpc.h + the streaming
    paths of policy/http2_rpc_protocol.cpp)."""

    def __init__(self, conn: "H2ServerConn", sock, sid: int):
        self.conn = conn
        self.sock = sock
        self.sid = sid
        self._recv = bytearray()            # un-cut grpc message bytes
        self._msgs: List[bytes] = []
        self._buffered = 0                  # unread bytes (bounded)
        self._cond = threading.Condition()
        self._closed_remote = False
        self.cancelled = False              # peer RST: send nothing back
        self.framing_error = False          # bad message framing: status 12
        self._headers_sent = False

    # -- fed by the connection (under conn.lock) ---------------------------

    def _on_data(self, body: bytes, end: bool) -> None:
        with self._cond:
            self._recv += body
            self._buffered += len(body)
            if self._buffered > max_body_size():
                # same defense as the unary assembly path: a writer
                # outpacing the handler must not buffer unboundedly.
                # RST goes out now, so nothing more may be sent later.
                self.cancelled = True
                self._closed_remote = True
                self.conn.session.send_rst(self.sid, E_PROTOCOL)
                self._cond.notify_all()
                return
            try:
                self._msgs.extend(unpack_grpc_messages(self._recv))
            except H2Error:
                self.framing_error = True
                self._closed_remote = True
            if end:
                self._closed_remote = True
            self._cond.notify_all()

    def _on_rst(self) -> None:
        with self._cond:
            self.cancelled = True
            self._closed_remote = True
            self._cond.notify_all()

    # -- handler side ------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        msg = self.read()
        if msg is None:
            raise StopIteration
        return msg

    def read(self, timeout: Optional[float] = None) -> Optional[bytes]:
        """Next request message, or None when the client half-closed
        (or the stream was cancelled).  Raises TimeoutError on timeout —
        None strictly means end-of-stream."""
        from ..fiber.runtime import blocking
        with self._cond:
            with blocking():
                ok = self._cond.wait_for(
                    lambda: self._msgs or self._closed_remote
                    or self.cancelled, timeout)
            if self._msgs:
                msg = self._msgs.pop(0)
                self._buffered -= len(msg)
                return msg
            if not ok:
                raise TimeoutError("grpc stream read timed out")
            return None

    def write(self, payload: bytes) -> None:
        """Push one response message."""
        if self.cancelled or self.framing_error:
            return
        with self.conn.lock:
            self._send_headers_locked()
            self.conn.session.send_data(self.sid, pack_grpc_message(payload))
        self.conn.flush(self.sock)

    def _send_headers_locked(self) -> None:
        if not self._headers_sent:
            self._headers_sent = True
            self.conn.session.send_headers(self.sid, [
                (":status", "200"), ("content-type", GRPC_CT)])

    def _finish(self, status: int, message: str = "",
                final_payload: Optional[bytes] = None) -> None:
        if self.cancelled:
            # peer reset the stream: nothing may be sent on it
            with self.conn.lock:
                self.conn.live.pop(self.sid, None)
            return
        if self.framing_error and status == 0:
            status, message = 12, "malformed grpc message framing"
            final_payload = None
        with self.conn.lock:
            if status == 0:
                self._send_headers_locked()
                if final_payload is not None:
                    self.conn.session.send_data(
                        self.sid, pack_grpc_message(final_payload))
                self.conn.session.send_headers(
                    self.sid, [("grpc-status", "0")]
                    + ([("grpc-message", message)] if message else []),
                    end_stream=True)
            elif self._headers_sent:
                self.conn.session.send_headers(
                    self.sid, [("grpc-status", str(status)),
                               ("grpc-message", message or "")],
                    end_stream=True)
            else:
                self.conn.session.send_headers(self.sid, [
                    (":status", "200"), ("content-type", GRPC_CT),
                    ("grpc-status", str(status)),
                    ("grpc-message", message or "")], end_stream=True)
            self.conn.session.close_stream(self.sid)
            self.conn.live.pop(self.sid, None)
            self.conn._maybe_goaway_locked()
        self.conn.flush(self.sock)


class H2ServerConn:
    """Per-connection server state: the session + request assembly (and
    live streaming dispatch for @grpc_streaming methods)."""

    def __init__(self, sock, server=None):
        self.session = H2Session(is_server=True)
        self.sock_id = sock.id
        self.server = server
        self._sock = sock
        self._assembling: Dict[int, dict] = {}
        self.live: Dict[int, GrpcServerStream] = {}
        self.ready: List[H2Request] = []
        self.lock = threading.Lock()
        self._goaway_sent = False   # lame-duck GOAWAY: once per conn

    def _maybe_goaway_locked(self) -> None:
        """Operability plane, h2 spelling: while the server drains,
        the first response on each connection is followed by a
        NO_ERROR GOAWAY — the client finishes in-flight streams and
        re-connects elsewhere (the GOAWAY analogue of tpu_std's
        lame-duck TLV and HTTP/1.1's Connection: close).  Call with
        self.lock held, before take_output."""
        if self._goaway_sent:
            return
        srv = self.server
        if srv is not None and getattr(srv, "lame_duck_signal_on",
                                       False):
            self._goaway_sent = True
            self.session.send_goaway(E_NO_ERROR)

    def feed(self, data: bytes) -> None:
        spawn_live: List[Tuple[GrpcServerStream, object]] = []
        with self.lock:
            events = self.session.feed(data)
            for ev in events:
                kind = ev[0]
                if kind == "headers":
                    _, sid, headers, end = ev
                    if sid in self.live:
                        if end:                    # request trailers
                            self.live[sid]._on_data(b"", True)
                        continue
                    entry = None if end else self._streaming_entry(headers)
                    if entry is not None:
                        stream = GrpcServerStream(self, self._sock, sid)
                        self.live[sid] = stream
                        spawn_live.append((stream, (entry, headers)))
                        continue
                    st = self._assembling.setdefault(
                        sid, {"headers": [], "body": bytearray()})
                    if st["headers"]:
                        st["trailers"] = headers      # request trailers
                    else:
                        st["headers"] = headers
                    if end:
                        self._complete(sid)
                elif kind == "data":
                    _, sid, body, end = ev
                    live = self.live.get(sid)
                    if live is not None:
                        live._on_data(body, end)
                        continue
                    st = self._assembling.get(sid)
                    if st is None:
                        continue
                    st["body"] += body
                    if len(st["body"]) > max_body_size():
                        self.session.send_rst(sid, E_PROTOCOL)
                        del self._assembling[sid]
                        continue
                    if end:
                        self._complete(sid)
                elif kind == "rst":
                    self._assembling.pop(ev[1], None)
                    live = self.live.pop(ev[1], None)
                    if live is not None:
                        live._on_rst()
        for stream, ctx in spawn_live:
            from ..fiber import runtime as fiber_runtime
            # arrival anchor = now (the headers completed in THIS feed
            # batch): fiber queueing between here and admission counts
            # toward the CoDel sojourn
            fiber_runtime.spawn(_run_streaming_handler, stream, ctx[0],
                                ctx[1], self._sock, self.server,
                                monotonic_us(),
                                name="grpc_stream")

    def _streaming_entry(self, headers):
        """The method entry IFF this request addresses a @grpc_streaming
        method (dispatch must then start before END_STREAM)."""
        if self.server is None:
            return None
        hmap = dict(headers)
        if not hmap.get("content-type", "").startswith(GRPC_CT):
            return None
        entry = resolve_grpc_entry(self.server, hmap.get(":path", ""))
        return entry if entry is not None and entry.grpc_streaming else None

    def _complete(self, sid: int) -> None:
        st = self._assembling.pop(sid, None)
        if st is None:
            return
        self.ready.append(H2Request(sid, st["headers"],
                                    bytes(st["body"]), self))

    # -- response writers (serialized by self.lock) -----------------------

    def flush(self, sock) -> None:
        # take_output must be under the lock: two responses finishing
        # concurrently could otherwise clear each other's queued frames
        with self.lock:
            out = self.session.take_output()
        if out and not sock.failed:
            sock.write(out)

    def send_grpc_response(self, sock, sid: int, payload: Optional[bytes],
                           status: int, message: str = "") -> None:
        with self.lock:
            if status == 0 and payload is not None:
                self.session.send_headers(sid, [
                    (":status", "200"), ("content-type", GRPC_CT)])
                self.session.send_data(sid, pack_grpc_message(payload))
                self.session.send_headers(
                    sid, [("grpc-status", "0")], end_stream=True)
            else:
                self.session.send_headers(sid, [
                    (":status", "200"), ("content-type", GRPC_CT),
                    ("grpc-status", str(status)),
                    ("grpc-message", message or "")], end_stream=True)
            self.session.close_stream(sid)
            self._maybe_goaway_locked()
        self.flush(sock)

    def send_http_response(self, sock, sid: int, status: int, body: bytes,
                           ctype: str = "text/plain",
                           extra: Optional[List[Tuple[str, str]]] = None
                           ) -> None:
        with self.lock:
            headers = [(":status", str(status)), ("content-type", ctype),
                       ("content-length", str(len(body)))]
            headers += list(extra or [])
            self.session.send_headers(sid, headers, end_stream=not body)
            if body:
                self.session.send_data(sid, body, end_stream=True)
            self.session.close_stream(sid)
            self._maybe_goaway_locked()
        self.flush(sock)


def parse(source: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    conn: Optional[H2ServerConn] = getattr(sock, "h2_conn", None)
    if conn is None:
        avail = len(source)
        probe = source.fetch(min(len(PREFACE), avail))
        if not PREFACE.startswith(probe):
            return ParseResult.try_others()
        if avail < len(PREFACE):
            return ParseResult.not_enough_data()
        conn = H2ServerConn(sock, server=arg)
        sock.h2_conn = conn
    data = source.to_bytes()
    source.clear()
    try:
        if data:
            conn.feed(data)
    except H2Error as e:
        LOG.warning("h2 connection error: %s", e)
        with conn.lock:
            conn.session.send_goaway(e.code)
        conn.flush(sock)
        return ParseResult.absolutely_wrong()
    conn.flush(sock)                      # settings acks, window updates
    if conn.ready:
        first = conn.ready.pop(0)
        # one gulp can complete SEVERAL multiplexed streams, but the
        # messenger collects one message per parse and stops at an empty
        # source — dispatch the extras ourselves, one fiber each
        if conn.ready:
            from ..fiber import runtime as fiber_runtime
            extras, conn.ready = conn.ready, []
            for req in extras:
                fiber_runtime.spawn(_process_request, req, sock, arg,
                                    name="h2_request")
        return ParseResult.make_message(first)
    return ParseResult.not_enough_data()


def _run_streaming_handler(stream: GrpcServerStream, entry, headers,
                           sock, server, recv_us=None) -> None:
    """Fiber body for a @grpc_streaming method: admission, handler,
    trailers.  The handler sees (cntl, stream)."""
    from ..server.controller import ServerController
    from ..protocol.meta import RpcMeta
    from ..protocol.tpu_std import serialize_payload

    from ..server.admission import admit as _admit
    # overload plane: the shared admission stage (tenant from the
    # x-tenant HPACK header); rejections are RESOURCE_EXHAUSTED
    tenant_h = None
    for k, v in headers:
        if k == "x-tenant":
            tenant_h = v
            break
    rej = _admit(server, entry, "grpc", tenant_h, recv_us or None)
    if rej is not None:
        stream._finish(8, rej.text)
        return
    meta = RpcMeta()
    meta.service_name = entry.status.full_name.rsplit(".", 1)[0]
    meta.method_name = entry.method_name
    if tenant_h:
        meta.tenant = tenant_h.encode("utf-8", "replace")
    begin = monotonic_us()
    cntl = ServerController(meta, sock.remote_side, b"", sock.id)
    cntl.server = server
    cntl.grpc_stream = stream
    try:
        ret = entry.fn(cntl, stream)
    except Exception as e:
        LOG.exception("grpc streaming method %s raised",
                      entry.status.full_name)
        cntl.set_failed(Errno.EINTERNAL, f"{type(e).__name__}: {e}")
        ret = None
    latency_us = monotonic_us() - begin
    entry.status.on_responded(cntl.error_code, latency_us)
    server.on_request_out(tenant=meta.tenant,
                          error_code=cntl.error_code,
                          latency_us=latency_us)
    if cntl.failed:
        stream._finish(grpc_status_of(cntl.error_code), cntl.error_text)
        return
    final = None
    if ret is not None:
        try:
            final = serialize_payload(ret)
        except TypeError as e:
            stream._finish(13, f"serialize: {e}")
            return
    stream._finish(0, final_payload=final)


def _process_request(req: H2Request, sock, server) -> None:
    ct = req.header("content-type")
    if ct.startswith(GRPC_CT):
        _process_grpc(req, sock, server)
        return
    # generic h2: builtin portal pages (the HTTP/1 path keeps the full
    # JSON bridge; internal-port gating applies identically)
    from ..protocol.http import HttpMessage
    from ..server.builtin import route_builtin

    path = req.header(":path")
    msg = HttpMessage()
    msg.is_request = True
    msg.method = req.header(":method") or "GET"
    msg.path, _, msg.query_string = path.partition("?")
    msg.body = req.body
    from ..server.http_dispatch import portal_restricted
    parts = [p for p in msg.path.split("/") if p]
    if portal_restricted(server, sock, parts[0] if parts else ""):
        req.conn.send_http_response(sock, req.stream_id, 403,
                                    b"restricted to the internal port\n")
        return
    try:
        status, ctype, body, extra = route_builtin(server, msg)
    except Exception as e:
        LOG.exception("builtin page %s raised (h2)", path)
        status, ctype, body, extra = 500, "text/plain", \
            f"internal error: {e}\n".encode(), []
    req.conn.send_http_response(sock, req.stream_id, status, body,
                                ctype, extra)


def _process_grpc(req: H2Request, sock, server) -> None:
    from ..server.controller import ServerController
    from ..protocol.meta import RpcMeta
    from ..protocol.tpu_std import serialize_payload

    path = req.header(":path")
    entry = resolve_grpc_entry(server, path)
    if entry is None:
        req.conn.send_grpc_response(sock, req.stream_id, None, 12,
                                    f"unknown method {path}")
        return
    if entry.grpc_streaming:
        # fully-assembled request on a streaming method (client sent
        # END_STREAM with HEADERS or in one gulp): run the handler with
        # a pre-closed stream carrying the buffered messages
        stream = GrpcServerStream(req.conn, sock, req.stream_id)
        with req.conn.lock:
            req.conn.live[req.stream_id] = stream
        stream._on_data(req.body, True)
        _run_streaming_handler(stream, entry, req.headers, sock, server,
                               recv_us=getattr(req, "recv_us", 0))
        return
    from ..server.admission import admit as _admit
    # overload plane: the shared admission stage — server cap, adaptive
    # method cap, CoDel sojourn (anchored at stream assembly), tenant
    # fair admission; rejections answer grpc-status 8
    # RESOURCE_EXHAUSTED (the ELIMIT row of the status map) before the
    # body is even unpacked
    tenant_h = req.header("x-tenant") or None
    rej = _admit(server, entry, "grpc", tenant_h,
                 getattr(req, "recv_us", 0) or None)
    if rej is not None:
        req.conn.send_grpc_response(sock, req.stream_id, None, 8,
                                    rej.text)
        return

    buf = bytearray(req.body)
    try:
        messages = unpack_grpc_messages(buf)
    except H2Error as e:
        entry.status.on_responded(int(Errno.EREQUEST), 0)
        server.on_request_out(tenant=tenant_h or b"")
        req.conn.send_grpc_response(sock, req.stream_id, None, 12, str(e))
        return
    payload = messages[0] if messages else b""

    meta = RpcMeta()
    meta.service_name = entry.status.full_name.rsplit(".", 1)[0]
    meta.method_name = entry.method_name
    if tenant_h:
        meta.tenant = tenant_h.encode("utf-8", "replace")
    tp_header = req.header("traceparent")
    if tp_header:
        from ..rpcz import parse_traceparent
        tp = parse_traceparent(tp_header)
        if tp is not None:
            # W3C trace context over HPACK → the internal trace model:
            # the server span parents to the caller's span id, exactly
            # like the tpu_std meta's trace/span TLVs
            meta.trace_id, meta.span_id = tp
    # grpc-timeout: the h2 spelling of tpu_std's remaining-deadline
    # TLV 13 (0 = already expired); kept in a local — meta.timeout_ms
    # == 0 conventionally means "none"
    dl_ms = parse_grpc_timeout(req.header("grpc-timeout"))
    if dl_ms is not None:
        meta.timeout_ms = dl_ms

    def send(cntl: ServerController, response) -> None:
        latency_us = monotonic_us() - cntl.begin_time_us
        entry.status.on_responded(cntl.error_code, latency_us)
        server.on_request_out(tenant=meta.tenant,
                              error_code=cntl.error_code,
                              latency_us=latency_us)
        span = cntl.span
        if cntl.failed:
            if span is not None:
                span.finish(cntl.error_code)
            req.conn.send_grpc_response(
                sock, req.stream_id, None,
                grpc_status_of(cntl.error_code), cntl.error_text)
            return
        try:
            body = serialize_payload(response)
        except TypeError as e:
            if span is not None:
                span.finish(int(Errno.EINTERNAL))
            req.conn.send_grpc_response(sock, req.stream_id, None, 13,
                                        f"serialize: {e}")
            return
        if span is not None:
            span.response_size = len(body)
            span.finish(0)
        req.conn.send_grpc_response(sock, req.stream_id, body, 0)

    cntl = ServerController(meta, sock.remote_side, b"", sock.id,
                            send=send)
    cntl.server = server
    cntl.begin_time_us = req.recv_us
    from ..rpcz import backdate_span, start_server_span
    cntl.span = start_server_span(entry.status.full_name, meta,
                                  sock.remote_side)
    if cntl.span is not None:
        cntl.span.request_size = len(payload)
        backdate_span(cntl.span, req.recv_us * 1000)
    if dl_ms is not None:
        # deadline plane: anchor grpc-timeout at stream assembly (fiber
        # queueing between END_STREAM and this dispatch counts against
        # it), then shed doomed work → DEADLINE_EXCEEDED trailers (the
        # ERPCTIMEDOUT→4 row of the status map) before the handler runs
        _arm_deadline(cntl, dl_ms, req.recv_us)
        if _maybe_shed(cntl, "grpc", entry.status.full_name):
            cntl.finish(None)
            return
    try:
        with _inherit_deadline(cntl):
            response = entry.fn(cntl, payload)
    except Exception as e:
        LOG.exception("grpc method %s raised", entry.status.full_name)
        cntl.set_failed(Errno.EINTERNAL, f"{type(e).__name__}: {e}")
        cntl.finish(None)
        return
    if cntl.is_async:
        return          # the handler owns completion: cntl.finish(resp)
    cntl.finish(response)


H2 = Protocol(
    ProtocolType.H2, "h2", parse,
    process_request=_process_request,
)
register_protocol(H2)
