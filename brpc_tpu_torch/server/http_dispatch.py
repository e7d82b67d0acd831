"""HTTP request routing: RPC bridge + builtin portal.

≈ the reference's http protocol dispatch (`/ServiceName/MethodName` →
service, everything else → builtin services on the same port,
brpc's src/brpc/policy/http_rpc_protocol.cpp + server.cpp:464).
JSON bridge: a dict/list return value is serialized as JSON; a JSON body
arrives as bytes for the method to parse (json2pb's role without
protobuf codegen in the way).

A copy of ``brpc_tpu/server/http_dispatch.py`` for the port's bytes
payloads: a request reaches the method as ``bytes`` (a JSON body too,
unless json2pb converts it for a method typed with a protobuf class,
which no port method is) and attachments are ``bytes`` on both sides.
A handler that calls ``cntl.begin_async()`` answers later through
``cntl.finish``, as in the JAX package.
"""

from __future__ import annotations

import json
from typing import Any, Tuple

from ..butil.iobuf import IOBuf
from ..butil.logging_util import LOG
from ..butil.status import Errno
from ..deadline import inherit_deadline
from ..protocol.http import HttpMessage, build_response
from ..transport.socket import Socket
from .controller import ServerController


PUBLIC_BUILTIN_PAGES = ("health", "version")


def drain_response_args(server, headers=None, keep_alive=True):
    """Operability plane, HTTP spelling: while the server drains,
    every HTTP/1.1 response — success, rejection, builtin page —
    carries ``x-lame-duck: 1`` and ``Connection: close`` (the
    keep-alive teardown makes the client re-connect, and its resolver
    will land elsewhere).  Returns the adjusted ``(headers,
    keep_alive)`` pair; a no-op outside drain, so the lanes stay
    byte-identical in steady state."""
    if server is not None and server.lame_duck_signal_on:
        h = list(headers or [])
        if not any(k.lower() == "x-lame-duck" for k, _v in h):
            h.append(("x-lame-duck", "1"))   # /health already adds its
            #                                  own — never duplicate
        return h, False
    return headers, keep_alive


def http_status_for_error(error_code: int) -> int:
    """RPC error -> HTTP status for the bridge (the JAX package's slim
    HTTP lane maps identically)."""
    return 400 if error_code == int(Errno.EREQUEST) else 500


def portal_restricted(server, sock, first_segment: str) -> bool:
    """True when builtin pages must be refused on this connection: an
    internal port is configured, this connection is not on it, and the
    page is not in the public allowlist (shared by HTTP/1 and h2)."""
    return (server.options.internal_port >= 0
            and getattr(sock, "tag", None) != "internal"
            and first_segment not in PUBLIC_BUILTIN_PAGES)


class ProgressiveAttachment:
    """Chunked-transfer body writer living past the RPC
    (≈ brpc's src/brpc/progressive_attachment.h): the handler
    calls cntl.create_progressive_attachment(), returns, then any thread
    writes chunks and close()s.  The connection carries the chunk stream
    until then."""

    def __init__(self, socket_id: int):
        import threading as _threading
        self._socket_id = socket_id
        self._closed = False
        self._started = False           # headers on the wire yet?
        self._pending = []              # chunks written before that
        self._lock = _threading.Lock()

    def _start(self) -> None:
        """Called by the dispatcher once the response headers are out:
        flush chunks the handler raced ahead with.  The flush stays
        under the lock so a concurrent write() cannot jump ahead of the
        buffered frames (Socket.write is ordered; this lock orders who
        reaches it first)."""
        with self._lock:
            self._started = True
            pending, self._pending = self._pending, []
            s = Socket.address(self._socket_id)
            if s is not None and not s.failed:
                for frame in pending:
                    s.write(frame)

    def _abort(self) -> None:
        """RPC failed before the chunked response started: kill the
        attachment so background writers see ECLOSE instead of buffering
        forever."""
        with self._lock:
            self._closed = True
            self._pending.clear()

    def write(self, data) -> int:
        """One HTTP/1.1 chunk; returns 0 or an errno."""
        b = bytes(data)
        if not b:
            return 0
        frame = b"%x\r\n" % len(b) + b + b"\r\n"
        with self._lock:
            if self._closed:
                return int(Errno.ECLOSE)
            if not self._started:
                self._pending.append(frame)
                return 0
            s = Socket.address(self._socket_id)
            if s is None or s.failed:
                return int(Errno.EFAILEDSOCKET)
            try:
                s.write(frame)
            except OSError:
                return int(Errno.EFAILEDSOCKET)
            return 0

    def close(self) -> None:
        """Terminal zero chunk; idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if not self._started:
                self._pending.append(b"0\r\n\r\n")
                return
            s = Socket.address(self._socket_id)
            if s is not None and not s.failed:
                s.write(b"0\r\n\r\n")

    @property
    def closed(self) -> bool:
        return self._closed


def handle_http_request(msg: HttpMessage, sock, server) -> None:
    path = msg.path.rstrip("/") or "/"
    parts = [p for p in path.split("/") if p]
    # RPC bridge: /Service/Method (also /Service.Method for symmetry)
    entry = None
    unresolved = ""
    if len(parts) == 2:
        entry = server.find_method(parts[0], parts[1])
        svc, mth = parts[0], parts[1]
    elif len(parts) == 1 and "." in parts[0]:
        svc, _, mth = parts[0].partition(".")
        entry = server.find_method(svc, mth)
    if entry is None and server._restful:
        hit = server.find_restful(parts)
        if hit is not None:
            entry, unresolved = hit
            svc = entry.status.full_name.rsplit(".", 1)[0]
            mth = entry.method_name
    if entry is not None:
        _bridge_rpc(msg, sock, server, svc, mth, entry,
                    unresolved=unresolved)
        return
    # With an internal port configured, operator pages are reachable only
    # through it (≈ reference's internal-port-only builtin services);
    # liveness probes stay public.
    if portal_restricted(server, sock, parts[0] if parts else ""):
        sock.write(build_response(
            403, b"builtin services are restricted to the internal port\n",
            keep_alive=msg.keep_alive))
        return
    from .builtin import route_builtin
    try:
        status, ctype, body, extra = route_builtin(server, msg)
    except Exception as e:
        LOG.exception("builtin page %s raised", msg.path)
        status, ctype, body, extra = 500, "text/plain", \
            f"internal error: {e}\n".encode(), []
    extra, ka = drain_response_args(server, extra, msg.keep_alive)
    sock.write(build_response(status, body, ctype, headers=extra,
                              keep_alive=ka))


def _bridge_rpc(msg: HttpMessage, sock, server, svc: str,
                mth: str, entry, unresolved: str = "") -> None:
    # cross-cutting stages (admission → trace extract → deadline
    # arm/shed) ride the COMPILED interceptor chain — the third
    # binding of ROADMAP item 1 (after the kind-5 streaming and kind-3
    # slim lanes).  The lane body only builds its HTTP-flavored send
    # closure, calls the chain's enter before user code, and settles
    # every completion through the chain's settle half.
    chain = getattr(entry, "_http_chain", None)
    if chain is None:
        from .interceptors import compile_http_chain
        chain = compile_http_chain(server, entry)
        try:
            entry._http_chain = chain       # compile once per entry
        except AttributeError:
            pass
    _enter, _settle = chain

    def send(cntl: ServerController, response: Any) -> None:
        s = Socket.address(cntl.socket_id)
        if s is None:
            _settle(cntl, 0)
            return
        if cntl.failed:
            if cntl._progressive is not None:
                cntl._progressive._abort()
            code = http_status_for_error(cntl.error_code)
            body = cntl.error_text.encode()
            _settle(cntl, len(body))
            hdrs, ka = drain_response_args(
                server, [("x-rpc-error-code", str(cntl.error_code))],
                msg.keep_alive)
            s.write(build_response(code, body, headers=hdrs,
                                   keep_alive=ka))
            return
        if cntl._progressive is not None:
            # chunked transfer: headers now, body chunks whenever the
            # ProgressiveAttachment writes them
            body, ctype = _encode_http_body(response)
            head = (b"HTTP/1.1 200 OK\r\n"
                    b"content-type: " + ctype.encode() + b"\r\n"
                    b"transfer-encoding: chunked\r\n"
                    b"connection: keep-alive\r\n\r\n")
            first = b"%x\r\n" % len(body) + body + b"\r\n" if body else b""
            s.write(head + first)
            cntl._progressive._start()
            _settle(cntl, len(body))
            return
        body, ctype = _encode_http_body(response)
        extra = None
        att = bytes(cntl.response_attachment or b"")
        if att:
            # attachment rides after the body; the size header lets the
            # peer split (HTTP has no native side channel)
            body += att
            extra = [("x-rpc-attachment-size", str(len(att)))]
        _settle(cntl, len(body))
        extra, ka = drain_response_args(server, extra, msg.keep_alive)
        s.write(build_response(200, body, ctype, headers=extra,
                               keep_alive=ka))

    cntl = _enter(msg, sock, svc, mth, unresolved, send)
    if cntl is None:
        return           # rejected or shed: the client is answered
    if msg.method in ("GET", "HEAD") and msg.query_string:
        request: Any = json.dumps(msg.query()).encode()
    else:
        request = msg.body
        att_size = msg.headers.get("x-rpc-attachment-size")
        if att_size and att_size.isdigit():
            n = int(att_size)
            if 0 < n <= len(request):
                cntl.request_attachment = request[len(request) - n:]
                request = request[:len(request) - n]
    try:
        from ..protocol.json2pb import maybe_parse_request
        converted = maybe_parse_request(
            request if isinstance(request, bytes) else bytes(request),
            entry.request_type, msg.headers.get("content-type", ""))
        if converted is not None:
            request = converted          # json2pb: JSON → pb message
    except Exception as e:
        cntl.set_failed(Errno.EREQUEST, f"request parse failed: {e}")
        cntl.finish(None)
        return
    try:
        with inherit_deadline(cntl):
            response = entry.fn(cntl, request)
    except Exception as e:
        LOG.exception("http method %s raised", entry.status.full_name)
        cntl.set_failed(Errno.EINTERNAL, f"{type(e).__name__}: {e}")
        cntl.finish(None)
        return
    if cntl.is_async:
        return          # the handler owns completion: cntl.finish(resp)
    cntl.finish(response)


def _encode_http_body(response: Any) -> Tuple[bytes, str]:
    if response is None:
        return b"", "text/plain"
    from ..protocol.json2pb import maybe_encode_response
    as_json = maybe_encode_response(response)
    if as_json is not None:              # pb message → JSON (pb2json)
        return as_json, "application/json"
    if isinstance(response, (dict, list)):
        return json.dumps(response).encode(), "application/json"
    if isinstance(response, str):
        return response.encode(), "text/plain"
    if isinstance(response, IOBuf):
        return response.to_bytes(), "application/octet-stream"
    if isinstance(response, (bytes, bytearray, memoryview)):
        return bytes(response), "application/octet-stream"
    if hasattr(response, "SerializeToString"):
        return response.SerializeToString(), "application/x-protobuf"
    return str(response).encode(), "text/plain"
