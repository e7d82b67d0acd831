"""Server-side request processing for tpu_std frames — the classic lane.

The port's twin of ``brpc_tpu/server/rpc_dispatch.py`` (≈
ProcessRpcRequest + SendRpcResponse, baidu_rpc_protocol.cpp:314,139):
find the method, run the compiled interceptor chain's prologue
(``interceptors.compile_rpc_chain``: admission, the attachment and
fabric staging, the span, the deadline shed), then auth, the user
interceptor, decompression and the handler, and answer exactly once.
Both transports call :func:`process_rpc_request`: the Python
transport's ``InputMessenger`` for a frame tpu_std's ``parse`` cut
(``protocol/tpu_std.py``'s ``TPU_STD``), and the native bridge for a
frame the engine cut and could not answer on a slim lane.

The port keeps its classic lane's shape where it differs from the JAX
package's: payloads and attachments are ``bytes``; a request's latency,
span and deadline run from the frame's arrival (``msg.recv_ns``); the
response frame is built before the settle, so a response that fails to
serialize settles as the error it becomes; an unknown method's answer
carries the domain answer and shm TLVs as any other response does.

While the ``rpc_dump`` flag is on, :func:`process_rpc_request` first
hands a budgeted sample of the requests to ``tools/rpc_dump.py``, as
the JAX lane does (``:242-245``).

Every completion — the handler's return, an async ``cntl.finish``, an
error — reaches :func:`_send_response`: the credit return of a request
descriptor first (so its ack precedes the response on the wire), the
response frame (the shm descriptor or device attachment once the
response has serialized), the chain's settle, the write.  A failed call
closes the stream it accepted.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

from ..butil.flags import get_flag
from ..butil.status import Errno
from ..deadline import inherit_deadline
from ..ici.endpoint import (ack_unused, ici_enabled, prepare_send,
                            split_device_attachment)
from ..ici.fabric import local_domain_id
from ..protocol import compress as compress_mod
from ..protocol.meta import TAG_ICI_DOMAIN, RpcMeta, encode_tlv
from ..protocol.tpu_std import (FrameError, RpcMessage, pack_frame,
                                serialize_payload)
from ..tools import rpc_dump as _rpc_dump
from ..transport import shm_ring
from ..transport.socket import Socket
from .controller import ServerController

LOG = logging.getLogger(__name__)
_POST_TIMEOUT_S = 5.0       # a response descriptor's wait for window credit
_AUTH_WAIT_S = 5.0          # a message's wait for the first one's verdict


def _write(sock: Socket, frame: bytes) -> None:
    try:
        sock.write(frame)
    except OSError:
        pass            # the connection is gone: dropped


def _error_frame(meta: RpcMeta, code: int, text: str,
                 shm_extra: bytes = b"", ici_domain: bytes = b"",
                 lame_duck: bool = False) -> bytes:
    err = RpcMeta()
    err.correlation_id = meta.correlation_id
    err.ici_domain = ici_domain
    err.error_code = int(code)
    err.error_text = text
    if lame_duck:
        err.lame_duck = 1
    return pack_frame(err, extra_meta=shm_extra)


def _send_error(sock: Socket, meta: RpcMeta, code: int, text: str,
                server=None) -> None:
    """A request answered before its controller exists (a stopping
    server, an admission rejection): the client's posted device-window
    credit goes back, and while draining the frame carries the lame-duck
    signal."""
    if meta.ici_desc:
        ack_unused(meta, sock.id)
    _write(sock, _error_frame(
        meta, code, text,
        lame_duck=server is not None and server.lame_duck_signal_on))


_domain_tlv_cache: Optional[bytes] = None


def _domain_tlv() -> bytes:
    """The pre-encoded ICI-domain TLV of this process (empty when the
    device lane is off): the native slim lanes' answer to the domain
    exchange."""
    global _domain_tlv_cache
    if _domain_tlv_cache is None:
        _domain_tlv_cache = encode_tlv(TAG_ICI_DOMAIN, local_domain_id()) \
            if ici_enabled() else b""
    return _domain_tlv_cache


def _chain_for(server, entry):
    """The entry's compiled tpu_std interceptor chain, built once per
    (server, method) and cached on the entry (the import is lazy:
    interceptors binds this module's builders at its top)."""
    chain = entry.chain
    if chain is None:
        from .interceptors import compile_rpc_chain
        chain = entry.chain = compile_rpc_chain(server, entry)
    return chain


def stage_request(msg: RpcMessage, sock: Socket, server, send
                  ) -> Optional[ServerController]:
    """The staging every request of the classic lane goes through: learn
    the peer's fabric domain and pin its connection nonce, split the
    device attachment off, take the shm TLVs (a request descriptor
    resolves into a view of the client's ring), and build the controller
    with ``send`` as its completion.  None after answering ``EREQUEST``
    for an unresolvable shm descriptor."""
    meta = msg.meta
    if meta.ici_domain:
        sock.ici_peer_domain = meta.ici_domain
    if meta.ici_conn and sock.ici_conn_token is None:
        sock.ici_conn_token = meta.ici_conn     # first write wins
    att, dev_att = split_device_attachment(meta, msg.attachment, sock.id)
    shm_extra, handle = b"", None
    if meta.shm_offer or meta.shm_accept or meta.shm_release \
            or meta.shm_desc:
        view, handle, shm_extra = shm_ring.server_on_request_meta(sock, meta)
        if view is not None:
            att = view      # the attachment never rode the frame
        elif meta.shm_desc:
            if dev_att is not None:
                dev_att.settle()
            _write(sock, _error_frame(
                meta, Errno.EREQUEST,
                "unresolvable shm attachment descriptor", shm_extra))
            return None
    cntl = ServerController(meta, sock.remote_side, att, sock.id, send=send)
    cntl.request_device_attachment = dev_att
    cntl.server = server
    cntl.begin_time_us = msg.recv_ns // 1000
    cntl._shm_extra = shm_extra
    cntl._shm_handle = handle
    return cntl


def _frame(server, cntl: ServerController, response, sock: Socket) -> bytes:
    """The response frame of a completed request: its success frame, or
    the error frame (a failed accepted stream closes)."""
    meta = cntl.request_meta
    out = RpcMeta()
    out.correlation_id = meta.correlation_id
    if meta.ici_domain and ici_enabled():
        out.ici_domain = local_domain_id()   # answer the exchange
    lame_duck = server.lame_duck_signal_on
    if lame_duck:
        out.lame_duck = 1   # draining: in-flight work still answers
    if not cntl.failed:
        if cntl._accepted_stream_id:
            out.stream_id = cntl._accepted_stream_id
            out.stream_window = cntl._accepted_stream_window
        frame = _response_frame(cntl, out, response, sock)
        if frame is not None:
            return frame
    if cntl._accepted_stream_id:
        # the client never binds a stream of a failed call
        from ..streaming import find_stream
        stream = find_stream(cntl._accepted_stream_id)
        if stream is not None:
            stream._close_local(notify_peer=False)
    return _error_frame(meta, cntl.error_code, cntl.error_text,
                        cntl._shm_extra, out.ici_domain, lame_duck)


def _response_frame(cntl: ServerController, out: RpcMeta, response,
                    sock: Socket) -> Optional[bytes]:
    """The success frame, or None after failing ``cntl``.  The response
    attachment moves to the ring only once the response has serialized,
    so a failure cannot strand a staged slot."""
    try:
        body = serialize_payload(response)
    except TypeError as e:
        cntl.set_failed(Errno.EINTERNAL,
                        f"response serialization failed: {e}")
        return None
    compressed = bool(cntl.response_compress_type)
    if compressed:
        packed = compress_mod.compress(body, cntl.response_compress_type)
        if packed is not None:
            out.compress_type = cntl.response_compress_type
            body = packed
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
        if sock.shm is not None and not device and not compressed:
            shm_desc, attachment = shm_ring.describe_response_att(
                sock, attachment, cntl._shm_handle)
            attachment = attachment or b""
        elif shm_ring.lane_enabled() and len(attachment) >= int(
                get_flag("rpc_shm_threshold")):
            # kept off the ring by the response's shape, or the peer
            # never spoke a shm TLV
            shm_ring.count_fallback(
                "shm_compressed" if compressed else "shm_device_combo"
                if device else "shm_peer_no_cap")
    if device and tail is not None:
        attachment = bytes(attachment) + tail if attachment else tail
    if cntl.span is not None:
        cntl.span.response_size = len(body) + len(attachment or b"")
    try:
        return pack_frame(out, body, attachment, cntl._shm_extra + shm_desc)
    except FrameError as e:
        shm_ring.unstage_response(shm_desc)
        cntl.set_failed(Errno.EINTERNAL, f"response too large: {e}")
        return None


def _respond_wire(server, entry, cntl: ServerController,
                  response: Any) -> Optional[bytes]:
    """The wire half of a completion: the credit return of a request
    descriptor (redeemed in the handler, its ack is queued; never
    redeemed, settle acks it now), then the response frame.  None when
    the connection is gone (the response is dropped)."""
    if cntl.request_device_attachment is not None:
        cntl.request_device_attachment.settle()
    sock = Socket.address(cntl.socket_id)
    if sock is None:
        if cntl._accepted_stream_id:
            from ..streaming import find_stream
            stream = find_stream(cntl._accepted_stream_id)
            if stream is not None:
                stream._close_local(notify_peer=False)
        return None
    return _frame(server, cntl, response, sock)


def _send_response(server, entry, cntl: ServerController,
                   response: Any) -> None:
    """Classic completion: the response frame, the chain's settle
    (MethodStatus, the limiters' feed, the tenant slot, the span), the
    write.  The slim lanes' escalations land here as well."""
    frame = _respond_wire(server, entry, cntl, response)
    if entry is not None:
        _settle = _chain_for(server, entry)[1]
        _settle(cntl, response)
    if frame is not None:
        sock = Socket.address(cntl.socket_id)
        if sock is not None:
            _write(sock, frame)


def process_rpc_request(msg: RpcMessage, sock: Socket, server) -> None:
    """One request frame, answered on ``sock`` when the request
    completes: when its handler returns or, after the handler called
    ``begin_async``, when it calls ``finish``."""
    meta = msg.meta
    if _rpc_dump.dump_enabled():
        # sampled wire capture for rpc_replay: the frame's body as it
        # came (payload, then the attachment)
        _rpc_dump.maybe_dump_request(meta, msg.payload, msg.attachment)
    entry = server.find_method(meta.service_name, meta.method_name)
    if entry is None:
        # an unknown method: no admission, status or span, as in the JAX
        # package
        cntl = stage_request(
            msg, sock, server,
            lambda c, r: _send_response(server, None, c, r))
        if cntl is not None:
            known = meta.service_name in server.services
            cntl.set_failed(Errno.ENOMETHOD if known else Errno.ENOSERVICE,
                            f"unknown {meta.service_name}."
                            f"{meta.method_name}")
            cntl.finish(None)
        return
    enter, _settle = _chain_for(server, entry)
    cntl = enter(msg, sock)
    if cntl is None:
        return      # rejected or shed: the client is already answered
    # auth on the connection's first message (≈ Protocol::verify); a
    # later message the messenger runs beside it waits for its verdict
    # (≈ brpc's Socket::FightAuthentication)
    auth = server.options.auth
    gate = sock.auth_gate
    if auth is not None and sock.app_data is None and gate is not None \
            and not msg.auth_first:
        from ..fiber import runtime as fiber_runtime
        with fiber_runtime.blocking():
            gate.wait(_AUTH_WAIT_S)
    if auth is not None and sock.app_data is None:
        try:
            ok = auth.verify(meta.auth_data, cntl)
        except Exception:
            ok = False
        if not ok:
            cntl.set_failed(Errno.ERPCAUTH, "authentication failed")
            cntl.finish(None)
            return
        sock.app_data = "authed"
    # the user interceptor (≈ interceptor.h:26-36): a bool or (ok, code,
    # text); a refusal fails the call with its code and text, a raise
    # with EINTERNAL
    interceptor = server.options.interceptor
    if interceptor is not None:
        try:
            verdict = interceptor(cntl)
        except Exception as e:
            verdict = (False, int(Errno.EINTERNAL), f"interceptor: {e}")
        ok = verdict[0] if isinstance(verdict, tuple) else bool(verdict)
        if not ok:
            code = verdict[1] if isinstance(verdict, tuple) \
                else Errno.EREJECT
            text = verdict[2] if isinstance(verdict, tuple) and \
                len(verdict) > 2 else "rejected"
            cntl.set_failed(code, text)
            cntl.finish(None)
            return
    payload = msg.payload
    if meta.compress_type:
        try:
            raw = compress_mod.decompress(payload, meta.compress_type)
        except Exception as e:
            cntl.set_failed(Errno.EREQUEST,
                            f"request decompression failed: {e}")
            cntl.finish(None)
            return
        if raw is None:
            cntl.set_failed(Errno.EREQUEST, "unsupported compress_type "
                            f"{meta.compress_type}")
            cntl.finish(None)
            return
        payload = raw
    if entry.raw_fn is not None:
        # @raw_method on the full path (the Python transport, or a
        # request carrying controller-tier features): the same (payload,
        # attachment) handler contract
        att = cntl.request_attachment
        try:
            out = entry.raw_fn(memoryview(payload), att if att else None)
            resp, ratt = out if type(out) is tuple else (out, None)
            if not isinstance(resp, (bytes, bytearray, memoryview)):
                raise TypeError(
                    f"raw method returned {type(resp).__name__}, "
                    "expected bytes or (bytes, bytes)")
        except Exception as e:
            LOG.exception("raw method %s failed", entry.status.full_name)
            cntl.set_failed(Errno.EINTERNAL, f"{type(e).__name__}: {e}")
            cntl.finish(None)
            return
        if ratt is not None and len(ratt):
            cntl.response_attachment = bytes(ratt)
        cntl.finish(resp)
        return
    try:
        with inherit_deadline(cntl):
            response = entry.fn(cntl, payload)
    except Exception as e:  # a failing method answers EINTERNAL
        LOG.exception("method %s.%s raised", meta.service_name,
                      meta.method_name)
        cntl.set_failed(Errno.EINTERNAL, f"{type(e).__name__}: {e}")
        cntl.finish(None)
        return
    if cntl.is_async:
        return          # the handler owns completion: cntl.finish(resp)
    cntl.finish(response)

