"""Slim native server-side dispatch — the Python half of the engine's
kind-3 lane.

The port's twin of ``brpc_tpu/server/slim_dispatch.py``.  The C++
engine scans the meta TLVs, batches every eligible unary request of a
read burst, and enters Python ONCE calling the shim built below as
``handler(payload, att, cid, conn_id, dom, nonce, recv_ns, trace,
timeout_ms, tenant)`` — ``recv_ns`` is the engine's CLOCK_MONOTONIC
frame-parse timestamp (spans are backdated to it, latencies run from
it); ``trace`` is None or the request's ``(trace_id, span_id,
parent_id)`` TLVs, so explicitly traced requests STAY on the lane;
``timeout_ms`` is TLV 13's remaining budget (None = no deadline; an
explicit 0 means expired at arrival), anchored at ``recv_ns``, and a
request whose budget expired in the native batch is shed (the handler
never runs, the client gets ``ERPCTIMEDOUT``); ``tenant`` is TLV 22's
identity bytes, the fair-admission key.  The shim is the whole per-call
Python cost of the lane:

    admission   the SHARED overload-plane stage (server/admission.py),
                through the compiled chain (server/interceptors.py) —
                ELIMIT / ELAMEDUCK answers ride the classic error
                builder, byte-identical with the Python lane
    sampling    rpcz spans keep their per-second budget; traced
                requests always record, sizes recorded inline
    user code   entry.fn(cntl, request) with a real ServerController —
                attachments, set_failed, begin_async,
                session_local_data, annotate
    accounting  MethodStatus.on_responded with the measured latency

Return contract with the engine (kind 3):

    bytes / memoryview      success payload; frame built natively and
                            coalesced into the burst's single writev
    (payload, att_bytes)    success with response attachment
    None                    the shim completed (or will complete, for
                            async methods) the RPC through the classic
                            Python send path — byte-identical fallback

Everything the slim frame cannot express natively escalates through
``cntl.finish`` into ``rpc_dispatch._send_response``, so escalated calls
are byte-identical with the classic lane by construction: async
completion, compressed/streamed/device responses, non-bytes responses,
errors.  Request-side ineligibility (compression, streams, device
descriptors, over-threshold attachments, large frames) never reaches
the shim — the engine's meta scan routes those frames to the classic
path.

One difference from the JAX shim: the port's fast template builds a
fresh controller per request where the JAX one recycles a pool of them
(``reset_slim``); the per-burst admission accounting is the same.
"""

from __future__ import annotations

import threading as _threading
from time import monotonic_ns as _mono_ns

from ..butil.logging_util import LOG
from ..butil.status import Errno
from ..deadline import arm as arm_deadline
from ..deadline import inherit_deadline, maybe_shed
from ..protocol.meta import RpcMeta
from ..protocol.tpu_std import parse_payload
from ..rpcz import backdate_span, passive_server_span
from .admission import count_admitted_burst, trivial_shape
from .controller import ServerController
from .interceptors import compile_chain
from .rpc_dispatch import _send_error, _send_response

# Per-burst aggregated accounting: each engine loop thread accumulates its
# burst's admitted-verdict count here and the engine's burst_end hook
# (NativeBridge registers flush_burst_accounting) folds it into the
# module-global admission counters under ONE lock per burst.  Thread-
# local: engine loops never race each other's accumulator.
_burst_tls = _threading.local()


def _burst_cell() -> list:
    cell = getattr(_burst_tls, "admitted", None)
    if cell is None:
        cell = _burst_tls.admitted = [0]
    return cell


def flush_burst_accounting() -> None:
    """Engine burst_end hook: flush this loop thread's aggregated
    fast-path accounting (called once per batched GIL entry)."""
    cell = getattr(_burst_tls, "admitted", None)
    if cell is not None and cell[0]:
        count_admitted_burst(cell[0])
        cell[0] = 0


_ELOGOFF = int(Errno.ELOGOFF)


def make_slim_handler(bridge, server, entry, svc: str, mth: str):
    """Build the kind-3 shim for one (service, method) entry.  All
    per-entry state is bound into default args — the steady-state call
    touches no module globals.

    The non-trivial request path runs through the compiled chain
    (server/interceptors.py) — ``enter`` before user code, ``settle``
    after — so admission ordering, trace extraction, deadline shed and
    the MethodStatus epilogue live in ONE place.  The fast template
    below it is the documented exception: it serves only trivial shapes
    (no trace/tenant TLVs, no admission layer configured), where the
    chain's stages are each provably no-ops and the per-call cost is the
    whole point."""
    status = entry.status
    socks = bridge._socks          # conn_id -> NativeSocket (live dict)
    enter, settle = compile_chain(server, entry, "slim")

    # one shared completion closure (not one lambda per call): it only
    # reads its (cntl, response) arguments
    def _send(cntl, response, _server=server, _entry=entry):
        _send_response(_server, _entry, cntl, response)

    # ARITY CONTRACT: the engine's kind-3 call site passes exactly the
    # public params below (privates are the underscore-prefixed default
    # binds)
    def slim(payload, att, cid, conn_id, dom, nonce, recv_ns,
             trace=None, tmo=None, tenant=None,
             _server=server, _entry=entry, _status=status, _fn=entry.fn,
             _rt=entry.request_type, _svc=svc, _mth=mth, _send=_send,
             _socks=socks, _ns=_mono_ns, _backdate=backdate_span,
             _shed=maybe_shed, _inherit=inherit_deadline,
             _arm=arm_deadline, _trivial=trivial_shape, _cell=_burst_cell,
             _pspan=passive_server_span, _enter=enter, _settle=settle):
        sock = _socks.get(conn_id)
        if sock is None:
            return None          # connection died mid-burst: drop, like
            #                      the classic path drops dead-conn sends
        if not _server.running:
            meta = RpcMeta()
            meta.correlation_id = cid
            _send_error(sock, meta, _ELOGOFF, "server is stopping")
            return None
        fast = trace is None and tenant is None \
            and _trivial(_server, _status)
        if not fast:
            # ---- the interceptor-chain binding: admission → deadline
            # shed → trace extract, in pinned order, INSIDE enter; a None
            # return means the client is already answered (rejection /
            # shed) and every taken count is settled
            cntl = _enter(sock, cid, len(payload), att, dom, nonce,
                          recv_ns, trace, tmo, tenant)
            if cntl is None:
                return None
        else:
            # ---- fast template: for the hot request shape — no
            # trace/tenant TLVs — on a method with NO admission layer
            # configured, the four-layer admit() walk is replaced by a
            # per-BURST admitted count (flushed in the engine's burst_end
            # hook); in-flight gauges are net-zero across a
            # synchronously-completing item and are not touched (they
            # stay exact whenever any admission layer is configured).
            # Every chain stage is a provable no-op for this shape, so
            # skipping the chain changes cost, not semantics.
            _cell()[0] += 1
            meta = RpcMeta()
            meta.correlation_id = cid
            meta.service_name = _svc
            meta.method_name = _mth
            na = len(att) if att is not None else 0
            if na:
                meta.attachment_size = na
            if dom is not None:
                sock.ici_peer_domain = meta.ici_domain = bytes(dom)
            if nonce is not None and sock.ici_conn_token is None:
                sock.ici_conn_token = bytes(nonce)
            cntl = ServerController(meta, sock.remote_side,
                                    bytes(att) if na else b"", sock.id,
                                    send=_send)
            cntl.server = _server
            cntl.begin_time_us = recv_ns // 1000
            cntl.response_compress_type = _entry.response_compress
            cntl._slim_fast = True      # escalations settle recorder-
            #                             only (no counts were taken)
            if tmo is not None:
                meta.timeout_ms = tmo
                _arm(cntl, tmo, recv_ns // 1000)
            span = _pspan(_status.full_name, sock.remote_side)
            if span is not None:
                span.request_size = len(payload) + na
                _backdate(span, recv_ns)
                cntl.span = span
            if tmo is not None and _shed(cntl, "slim", _status.full_name):
                # doomed work: the budget expired in the native batch —
                # ERPCTIMEDOUT via the classic completion, user code
                # never runs (identical to the chain-bound path)
                cntl.finish(None)
                return None
        try:
            request = parse_payload(bytes(payload), _rt)
        except Exception as e:
            cntl.set_failed(Errno.EREQUEST, f"request parse failed: {e}")
            cntl.finish(None)
            return None
        try:
            with _inherit(cntl):
                response = _fn(cntl, request)
        except Exception as e:
            LOG.exception("method %s raised", _status.full_name)
            cntl.set_failed(Errno.EINTERNAL, f"{type(e).__name__}: {e}")
            cntl.finish(None)
            return None
        if cntl.is_async:
            if cntl._slim_fast:
                # async escalation OUTLIVES the burst: the "in-flight
                # counts are net-zero for sync items" elision no longer
                # holds — take them now (server gauge, method gauge, '-'
                # tenant slot) so Server.drain()/join() SEE this request
                # and the classic completion settles each symmetrically
                cntl._slim_fast = False
                _server.on_request_in()
                _status.on_requested()
                _server.admission._tenant_acquire("-")
            return None          # user owns completion via cntl.finish
        if (cntl.failed or cntl._accepted_stream_id
                or cntl.response_compress_type
                or cntl.response_device_attachment is not None
                or not isinstance(response,
                                  (bytes, bytearray, memoryview))):
            # anything the native frame builder cannot express: classic
            # completion — byte-identical by construction
            cntl.finish(response)
            return None
        # ---- slim completion: the epilogue + the native frame
        if not cntl._mark_finished_if_first():
            return None
        ratt = cntl.response_attachment
        if cntl._slim_fast:
            cntl._slim_fast = False
            _status.latency << _ns() // 1000 - cntl.begin_time_us
            span = cntl.span
            if span is not None:
                span.response_size = len(response) + len(ratt)
                span.finish(0)
        else:
            _settle(cntl, len(response) + len(ratt))
        if ratt:
            return response, ratt
        return response

    return slim
