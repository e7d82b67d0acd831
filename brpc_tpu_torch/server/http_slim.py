"""Slim native HTTP dispatch — the Python half of the engine's kind-4
lane (the port's twin of ``brpc_tpu/server/http_slim.py``).

Without this lane an HTTP request on the native port pays Python per
message: C++ cuts the message (``EV_HTTP``), then ``protocol/http.py``
parses the request line and headers, the server's HTTP dispatch routes
it, and the response goes out through its own ``engine.send``.

Kind 4 removes all of it from the eligible path: the C++ engine parses
the request line + headers itself, batches every eligible HTTP/1.1
request of a read burst, and enters Python ONCE calling the per-route
shim built below as ``handler(body, query, content_type, att_size,
conn_id, recv_ns, traceparent, deadline, tenant)`` (bytes-or-None for
the middle three, ``traceparent``, ``deadline`` and ``tenant`` — the
last is the raw ``x-tenant`` header, the fair-admission key;
``recv_ns`` is the
engine's CLOCK_MONOTONIC parse timestamp, used to backdate rpcz spans
so they cover native queueing).  ``traceparent`` is the raw W3C
trace-context header value the engine captured — explicitly traced
HTTP requests STAY on the slim lane, with the span parented to the
caller.  ``deadline`` is the raw ``x-deadline-ms`` header value (the
HTTP/1.1 spelling of tpu_std's remaining-deadline TLV 13): anchored
at ``recv_ns``, the shim SHEDS requests whose budget expired in the
native batch — 500 + ``x-rpc-error-code: ERPCTIMEDOUT``, handler
never runs (deadline plane).  The shim is the whole per-call Python
cost of the lane:

    admission   the SHARED overload-plane stage (server/admission.py):
                server cap, adaptive method cap, CoDel against the
                engine parse stamp, per-tenant fair admission — 503 +
                Retry-After answers ride the slim serializer,
                byte-identical with the classic ``build_response``
                output
    sampling    rpcz spans keep their per-second budget via
                start_server_span; traced requests always record and
                the slim lane records real sizes inline
    user code   entry.fn(cntl, request) with a REAL ServerController —
                handlers keep attachments, set_failed, begin_async,
                progressive attachments, session_local_data
    accounting  MethodStatus.on_responded with the measured latency

Return contract with the engine (flush_py_batch -> http_slim_item):

    (status, header_block, body)   serialized natively — status line +
                                   Content-Length + header_block +
                                   CRLF + body, coalesced into the
                                   burst's single writev.  The header
                                   block is pre-formatted "Name: v\\r\\n"
                                   lines, Content-Type first — exactly
                                   build_response's layout
    bytes                          a pre-serialized full response,
                                   appended verbatim (keeps wire order
                                   for classic-built edge responses)
    None                           completed (or will complete, for
                                   async/progressive methods) through
                                   the classic write path

Request-side ineligibility (chunked/`Expect`/`Upgrade` requests,
`Connection: close`, HTTP/1.0, unregistered paths, over-inbuf bodies)
never reaches the shim — the engine's header scan routes those
messages to the classic `EV_HTTP` path byte-identically.  The request
reaches the method as the port's classic HTTP bridge hands it: the body
``bytes`` (a GET's query as JSON bytes), converted only by json2pb for a
protobuf-typed method.
"""

from __future__ import annotations

import json
import threading
from urllib.parse import unquote_plus

from ..butil.iobuf import IOBuf
from ..butil.logging_util import LOG
from ..butil.status import Errno
from ..deadline import inherit_deadline
from ..protocol.http import build_response
from ..transport.socket import Socket
from .http_dispatch import _encode_http_body, http_status_for_error

_EREQUEST = int(Errno.EREQUEST)
_EINTERNAL = int(Errno.EINTERNAL)

_CT = b"Content-Type: "
_CRLF = b"\r\n"


def _hdr_block(ctype: str, extra) -> bytes:
    """The slim tuple's header block: Content-Type first, then extras —
    the exact line order build_response emits after Content-Length."""
    out = _CT + ctype.encode("latin1") + _CRLF
    if extra:
        for k, v in extra:
            out += f"{k}: {v}".encode("latin1") + _CRLF
    return out


def _query_to_json(query: bytes) -> bytes:
    """Mirror of HttpMessage.query() + the GET bridge's json.dumps."""
    out = {}
    for pair in query.decode("latin1").split("&"):
        if not pair:
            continue
        k, _, v = pair.partition("=")
        out[unquote_plus(k)] = unquote_plus(v)
    return json.dumps(out).encode()


def make_http_slim_handler(bridge, server, entry, svc: str, mth: str,
                           http_method: str):
    """Build the kind-4 shim for one (service, method, HTTP-method)
    route.  All per-entry state is bound into closure cells — the
    steady-state call touches no module globals.

    The cross-cutting stages (admission → trace extract → deadline
    arm/shed, and the completion epilogue) live in the compiled
    interceptor chain — ``compile_http_slim_chain`` — the FOURTH chain
    binding of ROADMAP item 1.  The shim body keeps only what is
    lane-SPECIFIC: the inline-cell completion plumbing, request body /
    attachment / json2pb parsing, and the user-code call."""
    from .interceptors import compile_http_slim_chain

    fn = entry.fn
    req_type = entry.request_type
    full_name = entry.status.full_name
    socks = bridge._socks          # conn_id -> NativeSocket (live dict)
    is_get = http_method in ("GET", "HEAD")
    enter, settle = compile_http_slim_chain(server, entry, svc, mth,
                                            http_method)

    # ARITY CONTRACT: the engine's kind-4 call site passes exactly these
    # nine params (the underscore defaults are chain bindings, not
    # public params)
    def slim(body, query, ctype, attsz, conn_id, recv_ns,
             traceparent=None, deadline=None, tenant=None,
             _enter=enter, _settle=settle):
        sock = socks.get(conn_id)
        if sock is None:
            return None          # connection died mid-burst

        # Completion plumbing: while `inline` holds, the send closure
        # parks its response in `cell` and the engine serializes it into
        # the burst's coalesced writev; once the shim returns (async
        # methods), completions write classically via build_response —
        # same bytes, classic path.  The lock closes the race between a
        # fast async finisher and the shim's return.
        cell = []
        inline = [True]
        lk = threading.Lock()

        def _deliver(code, body_, ctype_, extra):
            with lk:
                if inline[0]:
                    cell.append((code, _hdr_block(ctype_, extra), body_))
                    return
            s = Socket.address(sock.id)
            if s is not None and not s.failed:
                # async completions land here AFTER the burst — a
                # drain may have started meanwhile: the late response
                # carries the x-lame-duck / Connection: close signal
                # exactly like the classic bridge's
                from .http_dispatch import drain_response_args
                extra, ka = drain_response_args(server, extra, True)
                s.write(build_response(code, body_, ctype_,
                                       headers=extra, keep_alive=ka))

        def send(cntl, response):
            # every response shape settles through the chain exactly
            # once (MethodStatus + limiter feed + span completion)
            if cntl.failed:
                if cntl._progressive is not None:
                    cntl._progressive._abort()
                code = http_status_for_error(cntl.error_code)
                body_ = cntl.error_text.encode()
                _settle(cntl, len(body_))
                _deliver(code, body_, "text/plain",
                         [("x-rpc-error-code", str(cntl.error_code))])
                return
            if cntl._progressive is not None:
                # chunked transfer: headers out now through the classic
                # writer (the chunk stream follows via Socket.write —
                # the engine's order guard staged earlier slim
                # responses first), byte-identical with _bridge_rpc
                body_, ctype_ = _encode_http_body(response)
                head = (b"HTTP/1.1 200 OK\r\n"
                        b"content-type: " + ctype_.encode() + b"\r\n"
                        b"transfer-encoding: chunked\r\n"
                        b"connection: keep-alive\r\n\r\n")
                first = (b"%x\r\n" % len(body_) + body_ + b"\r\n"
                         if body_ else b"")
                s = Socket.address(sock.id)
                if s is not None and not s.failed:
                    s.write(IOBuf(head + first))
                    cntl._progressive._start()
                _settle(cntl, len(body_))
                return
            body_, ctype_ = _encode_http_body(response)
            extra = None
            att = bytes(cntl.response_attachment or b"")
            if att:
                body_ += att
                extra = [("x-rpc-attachment-size", str(len(att)))]
            _settle(cntl, len(body_))
            _deliver(200, body_, ctype_, extra)

        # chain enter: admission → trace extract → deadline arm/shed.
        # A rejection comes back as the inline tuple; a shed already
        # completed through `send` and parked its tuple in the cell.
        cntl, early = _enter(len(body) if body is not None else 0,
                             sock.id, sock.remote_side, recv_ns, send,
                             traceparent, deadline, tenant)
        if cntl is None:
            if early is not None:
                return early
            return cell[0] if cell else None

        # request build — mirror of the classic bridge
        if is_get and query:
            request = _query_to_json(query)
        else:
            request = bytes(body) if body is not None else b""
            asz = (attsz.decode("latin1").strip()
                   if attsz is not None else None)
            if asz and asz.isdigit():
                n = int(asz)
                if 0 < n <= len(request):
                    cntl.request_attachment = request[len(request) - n:]
                    request = request[:len(request) - n]
        try:
            from ..protocol.json2pb import maybe_parse_request
            ct = (ctype.decode("latin1").strip()
                  if ctype is not None else "")
            converted = maybe_parse_request(request, req_type, ct)
            if converted is not None:
                request = converted          # json2pb: JSON -> pb
        except Exception as e:
            cntl.set_failed(Errno.EREQUEST, f"request parse failed: {e}")
            cntl.finish(None)
            return cell[0] if cell else None
        try:
            with inherit_deadline(cntl):
                response = fn(cntl, request)
        except Exception as e:
            LOG.exception("http method %s raised", full_name)
            cntl.set_failed(Errno.EINTERNAL, f"{type(e).__name__}: {e}")
            cntl.finish(None)
            return cell[0] if cell else None
        if cntl.is_async:
            with lk:
                inline[0] = False
                # a fast finisher may have completed before we returned
                return cell[0] if cell else None
        cntl.finish(response)
        with lk:
            inline[0] = False
            return cell[0] if cell else None

    return slim
