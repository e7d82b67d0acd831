"""The interceptor chain's HTTP binding.

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

:func:`compile_http_chain` composes them once per (server, method) into
a flat ``(enter, settle)`` closure pair (≈ brpc's per-protocol
``process_request`` policy callbacks, protocol.h:92-146): the HTTP lane
body calls ``enter`` before user code and funnels every completion
through ``settle``.  Rejections serialize through the shared
``http_reject`` helper, traces arrive as W3C ``traceparent`` headers,
deadlines as ``x-deadline-ms``.

A copy of ``brpc_tpu/server/interceptors.py``'s HTTP binding only.  The
port's tpu_std lane keeps its stages in ``server/server.py``
(``Server._dispatch`` and ``_answer``: the classic half of the JAX
package's ``rpc_dispatch.py`` and ``compile_rpc_chain``); the slim
lanes' bindings (``compile_chain``, ``compile_http_slim_chain``) wait for
the native engine.  Two differences from the JAX HTTP binding, both
taken from the port's tpu_std lane so that the two lanes of one server
measure alike: the span is backdated to the message's arrival, and the
latency that settles MethodStatus and the limiters runs from it.
"""

from __future__ import annotations

from time import monotonic_ns as _mono_ns

from ..deadline import arm as _arm_deadline
from ..deadline import maybe_shed as _maybe_shed
from ..deadline import parse_deadline_ms as _parse_deadline_ms
from ..protocol.http import build_response
from ..protocol.meta import RpcMeta
from ..rpcz import backdate_span, parse_traceparent, start_server_span
from .admission import admit as _admit
from .admission import http_reject
from .controller import ServerController


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
