"""One pipeline, N lane bindings — the per-lane-compiled interceptor
chain.

Every server lane runs the same cross-cutting stages around user code:

    admission      the SHARED overload-plane stage (server/admission) —
                   server cap, adaptive method cap, CoDel, tenant fair
                   admission, drain rejection
    deadline shed  queue-expired requests answered ERPCTIMEDOUT before
                   user code runs, anchored at the message's arrival
    trace extract  rpcz span sampling / forced spans for traced
                   requests, backdated to the arrival
    MethodStatus   per-method accounting + rpcz span completion
    telemetry      latency fed to the adaptive limiters through
                   on_responded / on_request_out

Each ``compile_*`` function composes them once per (server, method,
lane) into a flat ``(enter, settle)`` closure pair (≈ brpc's
per-protocol ``process_request`` policy callbacks, protocol.h:92-146):
the lane body calls ``enter`` before user code and funnels every
completion through ``settle``.  The port's twin of
``brpc_tpu/server/interceptors.py``, with its four bindings:

- :func:`compile_rpc_chain`, the classic tpu_std lane
  (``rpc_dispatch.process_rpc_request``, on both transports);
- :func:`compile_chain`, the native engine's kind-3 slim lane and kind-5
  stream opens (``slim_dispatch``, ``stream_slim``);
- :func:`compile_http_chain`, the classic HTTP/1.1 lane;
- :func:`compile_http_slim_chain`, the native kind-4 HTTP lane
  (``http_slim``).

Rejections serialize through the lane's shared error builder
(``rpc_dispatch._send_error`` on tpu_std, ``http_reject`` on HTTP),
traces arrive as meta TLVs or W3C ``traceparent`` headers, deadlines as
TLV 13 or ``x-deadline-ms``.  Where the JAX bindings differ from the
port's lanes, the port keeps its own: every span is backdated to the
message's arrival and every latency that settles MethodStatus and the
limiters runs from it.
"""

from __future__ import annotations

from time import monotonic_ns as _mono_ns

from ..butil.status import Errno
from ..deadline import arm as _arm_deadline
from ..deadline import maybe_shed as _maybe_shed
from ..deadline import parse_deadline_ms as _parse_deadline_ms
from ..protocol.http import build_response
from ..protocol.meta import RpcMeta
from ..rpcz import backdate_span, parse_traceparent, start_server_span
from .admission import admit as _admit
from .admission import http_reject
from .controller import ServerController
from .rpc_dispatch import _send_error, _send_response, stage_request

_ELOGOFF = int(Errno.ELOGOFF)
_EREQUEST = int(Errno.EREQUEST)


def compile_rpc_chain(server, entry):
    """The classic tpu_std lane's binding: both transports'
    ``rpc_dispatch.process_rpc_request`` runs these stages.

    ``enter(msg, sock)`` runs the prologue on a request frame: running
    check → admission → the attachment/fabric/shm staging and the
    controller (its completion is the lane's ``_send_response`` funnel)
    → trace extract → deadline arm + shed.  Returns a ready
    :class:`ServerController`, or ``None`` when the request was rejected
    or shed: the client is already answered and every taken count
    settled.

    ``settle(cntl, response)`` is the accounting epilogue every
    completion funnels through once, after its response frame exists:
    MethodStatus, the limiters' latency feed, the tenant slot, the span.
    A trivial-shape slim request escalated to the classic completion
    (``cntl._slim_fast``) took no counts, so it feeds the per-method
    recorders only."""
    status = entry.status
    full_name = status.full_name

    def _send(cntl, response, _server=server, _entry=entry):
        _send_response(_server, _entry, cntl, response)

    def enter(msg, sock,
              _server=server, _entry=entry, _status=status, _send=_send,
              _full=full_name, _admit_stage=_admit, _shed=_maybe_shed,
              _arm=_arm_deadline, _sample=start_server_span,
              _backdate=backdate_span, _stage=stage_request):
        meta = msg.meta
        if not _server.running:
            _send_error(sock, meta, _ELOGOFF, "server is stopping",
                        server=_server)
            return None
        # ---- admission: the ONE shared overload-plane stage, FIRST —
        # CoDel's sojourn measured from the frame's arrival; a rejected
        # request is answered before anything else runs for it
        rej = _admit_stage(_server, _entry, "tpu_std", meta.tenant,
                           msg.recv_ns // 1000)
        if rej is not None:
            _send_error(sock, meta, rej.code, rej.text, server=_server)
            return None
        cntl = _stage(msg, sock, _server, _send)
        if cntl is None:
            # an unresolvable shm descriptor, already answered EREQUEST
            latency_us = (_mono_ns() - msg.recv_ns) // 1000
            _status.on_responded(_EREQUEST, latency_us)
            _server.on_request_out(tenant=meta.tenant,
                                   error_code=_EREQUEST,
                                   latency_us=latency_us)
            return None
        cntl.response_compress_type = _entry.response_compress
        # ---- trace extract: sampled spans + forced spans for traced
        # requests, backdated to the frame's arrival
        span = _sample(_full, meta, sock.remote_side)
        if span is not None:
            span.request_size = len(msg.payload) \
                + len(cntl.request_attachment)
            _backdate(span, msg.recv_ns)
            cntl.span = span
        # ---- deadline plane, after admission, before user code: TLV
        # 13's budget anchored at the frame's arrival (an explicit
        # on-wire 0 is expired at arrival), then the shed (answered
        # ERPCTIMEDOUT by maybe_shed)
        if meta.timeout_ms or meta.timeout_present:
            _arm(cntl, meta.timeout_ms, msg.recv_ns // 1000)
            if _shed(cntl, "tpu_std", _full):
                cntl.finish(None)
                return None
        return cntl

    def settle(cntl, response, _status=status, _server=server,
               _ns=_mono_ns):
        latency_us = _ns() // 1000 - cntl.begin_time_us
        code = cntl.error_code
        if cntl._slim_fast:
            cntl._slim_fast = False
            if code == 0:
                _status.latency << latency_us
            else:
                _status.errors << 1
        else:
            _status.on_responded(code, latency_us)
            _server.on_request_out(tenant=cntl.request_meta.tenant,
                                   error_code=code, latency_us=latency_us)
        if cntl.span is not None:
            cntl.span.finish(code)

    return enter, settle


def compile_chain(server, entry, lane: str):
    """The native engine's slim binding (kind 3, and kind-5 stream
    opens): the stages for one (server, method, lane) as a flat
    ``(enter, settle)`` pair.

    ``enter(sock, cid, payload_len, att, dom, nonce, recv_ns, trace,
    tmo, tenant)`` runs running check → admission → trace extract →
    deadline shed on the fields the engine scanned out of the meta, and
    returns a ready :class:`ServerController`, or ``None`` when the
    request was rejected or shed (the client is already answered through
    the classic error builder and every taken count undone — the lane
    must not touch the request again).  The stages measure from the
    engine's CLOCK_MONOTONIC parse stamp, so native batch queueing counts
    against limits, deadlines and spans.

    ``settle(cntl, response_len)`` is the fast-completion epilogue:
    MethodStatus, the limiters' latency feed, the tenant slot, the span.
    Escalations (``cntl.finish``) settle through the classic completion
    instead and must NOT also call ``settle``."""
    status = entry.status
    full_name = status.full_name
    svc, _, mth = full_name.partition(".")

    def _send(cntl, response, _server=server, _entry=entry):
        _send_response(_server, _entry, cntl, response)

    def enter(sock, cid, payload_len, att, dom, nonce, recv_ns, trace,
              tmo, tenant,
              _server=server, _entry=entry, _status=status, _svc=svc,
              _mth=mth, _send=_send, _admit_stage=_admit,
              _shed=_maybe_shed, _arm=_arm_deadline,
              _sample=start_server_span, _backdate=backdate_span,
              _lane=lane):
        meta = RpcMeta()
        meta.correlation_id = cid
        if not _server.running:
            _send_error(sock, meta, _ELOGOFF, "server is stopping")
            return None
        # ---- admission: the ONE shared overload-plane stage, FIRST
        rej = _admit_stage(_server, _entry, _lane, tenant, recv_ns // 1000)
        if rej is not None:
            # the shared classic error builder (drain rejections carry
            # the lame-duck TLV)
            _send_error(sock, meta, rej.code, rej.text, server=_server)
            return None
        meta.service_name = _svc
        meta.method_name = _mth
        if dom is not None:
            sock.ici_peer_domain = dom = bytes(dom)
            meta.ici_domain = dom
        if nonce is not None and sock.ici_conn_token is None:
            sock.ici_conn_token = bytes(nonce)      # first write wins
        if trace is not None:
            meta.trace_id, meta.span_id, meta.parent_span_id = trace
        if tenant is not None:
            meta.tenant = bytes(tenant)             # slot-release key
        na = len(att) if att is not None else 0
        if na:
            meta.attachment_size = na
        cntl = ServerController(meta, sock.remote_side,
                                bytes(att) if na else b"", sock.id,
                                send=_send)
        cntl.server = _server
        cntl.begin_time_us = recv_ns // 1000
        cntl.response_compress_type = _entry.response_compress
        if tmo is not None:
            meta.timeout_ms = tmo
            _arm(cntl, tmo, recv_ns // 1000)
        # ---- trace extract: sampled spans + FORCED spans for traced
        # requests, backdated so they cover native queueing
        span = _sample(_status.full_name, meta, sock.remote_side)
        if span is not None:
            span.request_size = payload_len + na
            _backdate(span, recv_ns)
            cntl.span = span
        # ---- deadline shed, AFTER admission, BEFORE user code
        if tmo is not None and _shed(cntl, _lane, _status.full_name):
            cntl.finish(None)
            return None
        return cntl

    def settle(cntl, response_len,
               _status=status, _server=server, _ns=_mono_ns):
        latency_us = _ns() // 1000 - cntl.begin_time_us
        _status.on_responded(0, latency_us)
        _server.on_request_out(tenant=cntl.request_meta.tenant,
                               latency_us=latency_us)
        span = cntl.span
        if span is not None:
            span.response_size = response_len
            span.finish(0)

    return enter, settle


def compile_http_chain(server, entry):
    """The HTTP binding of the interceptor chain: tenant from
    ``x-tenant``, trace from W3C ``traceparent``, deadline from
    ``x-deadline-ms``, rejections through the shared ``http_reject``
    helper with the drain plane's lame-duck headers.

    ``enter(msg, sock, svc, mth, unresolved, send)`` runs admission →
    trace extract → deadline arm/shed and returns a ready
    :class:`ServerController` (with ``send`` as its completion
    callback), or ``None`` when the request was rejected/shed — the
    client is already answered.

    ``settle(cntl, response_len)`` is the completion epilogue every
    response path funnels through: MethodStatus + limiter latency feed
    + tenant slot release + span completion.  The lane's ``send``
    closure calls it exactly once per request, right before the bytes
    go out (or in place of them when the socket is gone)."""
    # lazy: http_dispatch imports this module to bind the chain
    from .http_dispatch import drain_response_args

    status = entry.status

    def enter(msg, sock, svc, mth, unresolved, send,
              _server=server, _entry=entry, _status=status,
              _admit_stage=_admit, _shed=_maybe_shed,
              _arm=_arm_deadline, _sample=start_server_span,
              _backdate=backdate_span, _parse_tp=parse_traceparent,
              _parse_dl=_parse_deadline_ms, _reject=http_reject,
              _drain_args=drain_response_args, _build=build_response):
        # ---- admission: the ONE shared overload-plane stage, FIRST
        # (CoDel sojourn measured from the message's parse stamp)
        tenant = msg.headers.get("x-tenant")
        rej = _admit_stage(_server, _entry, "http", tenant, msg.recv_us)
        if rej is not None:
            # rejection serialization through the SHARED HTTP helper
            # (503 + Retry-After + reason; lame-duck headers in drain)
            status_code, body, extra = _reject(rej)
            extra, ka = _drain_args(_server, extra, msg.keep_alive)
            sock.write(_build(status_code, body, headers=extra,
                              keep_alive=ka))
            return None
        meta = RpcMeta()
        meta.service_name = svc
        meta.method_name = mth
        if tenant:
            meta.tenant = tenant.encode("utf-8", "replace")
        # ---- trace extract: W3C trace context → the internal trace
        # model (the server span parents to the caller's span id,
        # exactly like the tpu_std meta's trace/span TLVs)
        tp_header = msg.headers.get("traceparent")
        if tp_header:
            tp = _parse_tp(tp_header)
            if tp is not None:
                meta.trace_id, meta.span_id = tp
        # x-deadline-ms: the HTTP/1.1 spelling of tpu_std's remaining-
        # deadline TLV 13 (0 = already expired); kept in a local too —
        # meta.timeout_ms == 0 conventionally means "none"
        dl_ms = _parse_dl(msg.headers.get("x-deadline-ms"))
        if dl_ms is not None:
            meta.timeout_ms = dl_ms
        cntl = ServerController(meta, sock.remote_side, b"", sock.id,
                                send=send)
        cntl.server = _server
        cntl.begin_time_us = msg.recv_us
        cntl.http_method = msg.method
        cntl.http_path = msg.path
        cntl.http_unresolved_path = unresolved
        span = _sample(_status.full_name, meta, sock.remote_side)
        if span is not None:
            span.request_size = len(msg.body)
            _backdate(span, msg.recv_us * 1000)
            cntl.span = span
        if dl_ms is not None:
            # deadline plane: anchor the propagated budget at the
            # message's PARSE time, then shed doomed work before body
            # parsing or the handler burn any time on it
            _arm(cntl, dl_ms, msg.recv_us)
            if _shed(cntl, "http", _status.full_name):
                cntl.finish(None)
                return None
        return cntl

    def settle(cntl, response_len,
               _status=status, _server=server, _ns=_mono_ns):
        """Completion epilogue (every response shape — success, error,
        progressive headers, socket-gone — funnels through here once):
        MethodStatus settle, limiter latency feed, span completion."""
        latency_us = _ns() // 1000 - cntl.begin_time_us
        _status.on_responded(cntl.error_code, latency_us)
        _server.on_request_out(tenant=cntl.request_meta.tenant,
                               error_code=cntl.error_code,
                               latency_us=latency_us)
        span = cntl.span
        if span is not None:
            span.response_size = response_len
            span.finish(cntl.error_code)

    return enter, settle


def compile_http_slim_chain(server, entry, svc: str, mth: str,
                            http_method: str):
    """The native kind-4 HTTP binding: the stages of
    :func:`compile_http_chain` in the slim lane's spellings.  The engine
    hands the shim raw header VALUES (``traceparent`` / ``x-deadline-ms``
    / ``x-tenant``) instead of a parsed message, timestamps are the
    engine's CLOCK_MONOTONIC parse stamp (spans backdated over native
    queueing), and a rejection serializes as the lane's ``(status,
    header_block, body)`` tuple riding the burst's single coalesced
    writev — byte-identical with ``build_response``'s output.

    ``enter(body_len, socket_id, remote_side, recv_ns, send,
    traceparent, deadline, tenant)`` returns ``(cntl, early)``: ``(cntl,
    None)`` when the request may proceed, ``(None, tuple)`` for an
    admission rejection (the tuple is the engine's inline response),
    ``(None, None)`` when the deadline shed already completed through
    ``send``.

    ``settle(cntl, response_len)`` is the completion epilogue the lane's
    ``send`` closure funnels every response shape through."""
    # lazy: http_slim imports this module to bind the chain
    from .http_slim import _hdr_block

    status = entry.status
    full_name = status.full_name
    path = f"/{svc}/{mth}"

    def enter(body_len, socket_id, remote_side, recv_ns, send,
              traceparent, deadline, tenant,
              _server=server, _entry=entry, _svc=svc, _mth=mth,
              _http_method=http_method, _path=path, _full=full_name,
              _admit_stage=_admit, _shed=_maybe_shed, _arm=_arm_deadline,
              _sample=start_server_span, _backdate=backdate_span,
              _parse_tp=parse_traceparent, _parse_dl=_parse_deadline_ms,
              _reject=http_reject, _hdr=_hdr_block):
        # ---- admission: the ONE shared overload-plane stage, FIRST
        rej = _admit_stage(_server, _entry, "http_slim", tenant,
                           recv_ns // 1000)
        if rej is not None:
            # the shared HTTP helper's 503 as a slim tuple the engine
            # coalesces into the burst's writev (lame-duck headers in
            # drain)
            st, rbody, extra = _reject(rej)
            return None, (st, _hdr("text/plain", extra), rbody)
        meta = RpcMeta()
        meta.service_name = _svc
        meta.method_name = _mth
        if tenant is not None:
            meta.tenant = bytes(tenant)     # fair-admission slot release
        # ---- trace extract: raw W3C header value → the internal trace
        # model (explicitly traced requests STAY on the slim lane)
        if traceparent is not None:
            tp = _parse_tp(traceparent)
            if tp is not None:
                meta.trace_id, meta.span_id = tp
        dl_ms = _parse_dl(deadline)
        if dl_ms is not None:
            meta.timeout_ms = dl_ms
        cntl = ServerController(meta, remote_side, b"", socket_id,
                                send=send)
        cntl.server = _server
        cntl.begin_time_us = recv_ns // 1000
        cntl.http_method = _http_method
        cntl.http_path = _path
        cntl.http_unresolved_path = ""
        if dl_ms is not None:
            _arm(cntl, dl_ms, recv_ns // 1000)
        span = _sample(_full, meta, remote_side)
        if span is not None:
            span.request_size = body_len
            _backdate(span, recv_ns)
            cntl.span = span
        # ---- deadline shed, AFTER admission, BEFORE user code: the
        # finish below completes through the lane's send closure
        if dl_ms is not None and _shed(cntl, "http_slim", _full):
            cntl.finish(None)
            return None, None
        return cntl, None

    def settle(cntl, response_len, _status=status, _server=server,
               _ns=_mono_ns):
        latency_us = _ns() // 1000 - cntl.begin_time_us
        _status.on_responded(cntl.error_code, latency_us)
        _server.on_request_out(tenant=cntl.request_meta.tenant,
                               error_code=cntl.error_code,
                               latency_us=latency_us)
        span = cntl.span
        if span is not None:
            span.response_size = response_len
            span.finish(cntl.error_code)

    return enter, settle
