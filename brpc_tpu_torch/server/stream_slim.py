"""Kind-5 streaming lane — the Python half of the engine's native
stream transport (the port's twin of ``brpc_tpu/server/stream_slim.py``).

Two entries, both called from engine loop threads inside the per-burst
batched GIL entry:

``make_stream_handler`` builds the STREAM-OPEN shim for one kind-3
method: the engine scans the stream TLVs (12/14) out of an eligible
unary request and dispatches here instead of the kind-3 shim, as
``handler(payload, att, cid, conn_id, dom, nonce, recv_ns, trace,
timeout_ms, tenant, stream_id, stream_window)``.  The lane binds the
compiled interceptor chain (server/interceptors.py — admission →
deadline shed → trace extract → MethodStatus/rpcz → telemetry): the
body calls ``enter`` before user code and ``settle`` after.  On
success the accepted stream is REGISTERED with the engine before the
grant response leaves — write-side credit is then accounted in C++
(``Stream.write`` routes through ``engine.stream_write``), and the
response frame carries the grant TLVs natively.

``slim_chunks`` is the batched chunk delivery: ALL DATA/CLOSE chunks
of a read burst — across every stream on the loop — enter Python in
this ONE call (the kind-3/4 discipline applied to stream frames;
credit FEEDBACK frames never enter Python at all, the engine settles
them in C++).  Chunks route into the existing ``Stream.on_frame``
machinery, so ordering, ack generation and close semantics are
identical with the Python lane by construction.

Return contract of the open shim with the engine (stream_open_item):

    (payload, grant_bytes)   success with an accepted stream: the
                             pre-encoded grant TLVs (stream id +
                             window) ride the response meta natively
    bytes / memoryview       success, method declined the stream
    None                     escalated through the classic completion
                             (async, errors, compressed/device/
                             attachment responses) — byte-identical
"""

from __future__ import annotations

import struct as _struct

from ..butil.logging_util import LOG
from ..butil.status import Errno
from ..deadline import inherit_deadline
from ..protocol.meta import TAG_STREAM_ID, TAG_STREAM_WINDOW, encode_tlv
from ..protocol.tpu_std import parse_payload
from ..streaming import find_stream
from .interceptors import compile_chain

# Closed kind-5 fallback reason-name mirror — MUST match engine.cpp's
# kStreamFbNames order exactly (tests/test_torch_native_engine.py pins
# it).  The
# bridge pre-seeds the fallback family with these so every reason row
# exists from the first scrape.
STREAM_FB_NAMES = (
    "stream_no_shim", "stream_non_inline", "stream_compressed",
    "stream_chunk_oversize", "stream_drain", "stream_unregistered",
)


def make_stream_handler(bridge, server, entry, svc: str, mth: str):
    """Build the kind-5 stream-open shim for one (service, method)
    entry.  All per-entry state is bound into default args; the
    cross-cutting stages come from the compiled interceptor chain."""
    enter, settle = compile_chain(server, entry, "stream")
    engine = bridge.engine

    # ARITY CONTRACT: the engine's kind-5 call site passes exactly the
    # public params below (privates are the underscore-prefixed default
    # binds)
    def slim(payload, att, cid, conn_id, dom, nonce, recv_ns,
             trace=None, tmo=None, tenant=None, stream_id=0,
             stream_window=0,
             _enter=enter, _settle=settle, _fn=entry.fn,
             _rt=entry.request_type, _socks=bridge._socks,
             _engine=engine, _inherit=inherit_deadline,
             _find=find_stream, _pack=_struct.pack,
             _tlv=encode_tlv):
        sock = _socks.get(conn_id)
        if sock is None:
            return None          # connection died mid-burst
        # ---- the interceptor-chain binding: admission → shed → trace
        # run INSIDE enter, in pinned order — a None return means the
        # client is already answered (rejection / shed) and every
        # taken count is settled
        cntl = _enter(sock, cid, len(payload), att, dom, nonce,
                      recv_ns, trace, tmo, tenant)
        if cntl is None:
            return None
        cntl._remote_stream_id = stream_id
        cntl.request_meta.stream_id = stream_id
        cntl.request_meta.stream_window = stream_window
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
            LOG.exception("method %s raised",
                          cntl.request_meta.service_name)
            cntl.set_failed(Errno.EINTERNAL, f"{type(e).__name__}: {e}")
            cntl.finish(None)
            return None
        if cntl.is_async:
            return None          # user owns completion via cntl.finish
        if (cntl.failed or cntl.response_compress_type
                or cntl.response_device_attachment is not None
                or cntl.response_attachment
                or not isinstance(response,
                                  (bytes, bytearray, memoryview))):
            # anything the native grant frame cannot express: classic
            # completion — byte-identical by construction (the classic
            # meta carries the grant TLVs for accepted streams)
            cntl.finish(response)
            return None
        if not cntl._mark_finished_if_first():
            # lost the finish race (the deadline kicker already sent
            # an error frame — no grant ever reaches the client): the
            # stream must NOT be adopted, or the engine would keep a
            # live session the peer will never bind
            return None
        grant = None
        acc = cntl._accepted_stream_id
        if acc:
            # grant TLVs ride the response meta natively; the stream is
            # adopted onto the kind-5 lane BEFORE the response leaves,
            # so no peer frame can race the registration
            grant = (_tlv(TAG_STREAM_ID, _pack("<Q", acc))
                     + _tlv(TAG_STREAM_WINDOW,
                            _pack("<I", cntl._accepted_stream_window)))
            s = _find(acc)
            if s is not None:
                _engine.stream_register(conn_id, acc, stream_id,
                                        s._write_window)
                s._native_tx = _engine
        # ---- chain epilogue: MethodStatus/limiter feed + span finish
        _settle(cntl, len(response))
        if grant is not None:
            return response, grant
        return response

    return slim


def slim_chunks(items) -> None:
    """Batched kind-5 chunk delivery — ONE GIL entry per read burst
    covering every stream on the loop.  Routes into the existing
    ``Stream.on_frame`` machinery (per-stream ExecutionQueue ordering,
    consumption-driven acks, ordered close), so delivery semantics are
    identical with the Python lane.  The engine only batches frames
    whose (sid, conn) binding matched its registration — the forged-
    frame guard ran in C++."""
    find = find_stream
    for sid, flags, payload in items:
        s = find(sid)
        if s is None:
            continue             # closed since the frame was cut
        try:
            s.on_frame(flags, payload)
        except Exception:
            LOG.exception("stream chunk delivery raised (sid=%d)", sid)
