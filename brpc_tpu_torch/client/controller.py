"""Controller — one client call's knobs and results.

The slim core of ``brpc_tpu/client/controller.py``: ``timeout_ms``,
``request_attachment`` (bytes) and ``request_device_attachment`` (a
tensor for the ICI lane) in; ``failed`` / ``error_code`` / ``error_text``,
``response``, ``response_attachment`` and ``response_device_attachment``
(a :class:`~brpc_tpu_torch.ici.DeviceAttachment` to redeem with
``.tensor()``) out; ``streaming.stream_create`` sets
``_stream_to_create``, the stream the call sets up.  Tracing: a call
whose ``trace_id`` is set (with ``span_id``, the caller's span, as the
parent) opens an rpcz client span, and the request carries the trace id
and that span's id in its meta TLVs, so the server span parents to it.

Retries and backup requests (``brpc_tpu/client/controller.py:58-80``,
``:344-370``): ``max_retry`` and ``backup_request_ms`` (None: the
channel's), ``connection_type`` (None: the channel's; ``"single"``,
``"pooled"`` or ``"short"``) and ``retry_policy`` (default
:func:`default_retry_policy`, the JAX package's ``_RETRIABLE`` and
``_FAIL_FAST`` sets) in; ``retried_count`` and ``has_backup_request``
out.  A stream-creating call gets no retry, no backup and the single
connection.

The cluster client (``brpc_tpu/client/controller.py:405-421``,
``:697-706``, ``:1026-1036``): ``request_code`` (the consistent-hashing
key) in; every attempt picks its server through the channel's load
balancer, records it in ``attempt_remotes`` (attempt version ->
EndPoint) and ``remote_side`` (in the end, the server of the attempt
that decided the call), and a failed attempt's server joins
``excluded_servers``, so a retry goes elsewhere; ``latency_us`` is the
call's, fed back to the balancer with its outcome.  With a balancer the
fail-fast codes (``ELIMIT``, ``ELAMEDUCK``) are retried at once on
another replica; on a single-server channel they are not, as the JAX
policy decides.

Call ids and the classic lane's request stages
(``brpc_tpu/client/controller.py:263-270``, ``:561-581``, ``:1114``):
every call holds a versioned id of ``fiber.versioned_id``'s global pool
from its launch to its end (``call_id``); :meth:`Controller.join` waits
for the end, and :func:`start_cancel` ends the call ``ECANCELLED`` (a
response that arrives later is dropped; a handler already running is
not stopped).  ``request_compress_type`` (default: the channel's)
compresses a tpu_std request's payload.

The HTTP client half (``brpc_tpu/client/controller.py:458``, ``:1072``):
:func:`process_http_response` reads an attempt's HTTP/1.1 response into
the meta the tpu_std attempt would have had (``x-rpc-error-code`` or
``EHTTP`` for a non-200, ``x-lame-duck``, the ``x-rpc-attachment-size``
split), so the channel settles both protocols alike.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Set

from ..butil.logging_util import LOG
from ..butil.status import Errno
from ..fiber.versioned_id import INVALID_CALL_ID, global_id_pool
from ..protocol.meta import CompressType, RpcMeta
from ..rpcz import start_client_span

# errors worth retrying on another attempt (≈ DefaultRetryPolicy)
_RETRIABLE = {int(Errno.EFAILEDSOCKET), int(Errno.EEOF),
              int(Errno.ELOGOFF), int(Errno.EUNUSED)}
_ELIMIT = int(Errno.ELIMIT)
_ELAMEDUCK = int(Errno.ELAMEDUCK)
# errors the server answered in microseconds precisely so the caller can
# go elsewhere right now: retried immediately (no backoff) and only when
# a load balancer can pick a different replica
_FAIL_FAST = (_ELIMIT, _ELAMEDUCK)


def default_retry_policy(cntl: "Controller", error_code: int) -> bool:
    if error_code in _FAIL_FAST:
        ch = getattr(cntl, "_channel", None)
        return ch is not None and ch.load_balancer is not None
    return error_code in _RETRIABLE


class Controller:
    __slots__ = ("timeout_ms", "max_retry", "backup_request_ms",
                 "connection_type", "retry_policy", "request_attachment",
                 "request_device_attachment", "response",
                 "response_attachment", "response_device_attachment",
                 "retried_count", "has_backup_request", "request_code",
                 "excluded_servers", "remote_side", "attempt_remotes",
                 "latency_us", "_error_code", "_error_text",
                 "_stream_to_create", "trace_id", "span_id", "_client_span",
                 "_channel", "request_compress_type", "_call_id", "_call",
                 "_cancel")

    def __init__(self):
        self.timeout_ms: Optional[int] = None   # None = the channel's
        self.max_retry: Optional[int] = None
        self.backup_request_ms: Optional[int] = None
        self.connection_type: Optional[str] = None
        self.retry_policy: Callable = default_retry_policy
        self.retried_count = 0
        self.has_backup_request = False
        self._channel = None            # the channel of the call
        self.request_code = 0           # consistent-hashing key
        self.excluded_servers: Set = set()  # retries avoid these
        self.remote_side = None         # the server that answered
        self.attempt_remotes: Dict[int, Any] = {}   # version -> EndPoint
        self.latency_us = 0
        self.request_attachment: bytes = b""
        self.request_device_attachment: Any = None
        self.response: Any = None       # response bytes
        self.response_attachment: bytes = b""
        self.response_device_attachment = None
        self._error_code = 0
        self._error_text = ""
        self._stream_to_create = None   # set by streaming.stream_create
        self.trace_id = 0
        self.span_id = 0
        self._client_span = None        # rpcz Span of a traced call
        self.request_compress_type = CompressType.NONE  # NONE: the channel's
        self._call_id = INVALID_CALL_ID
        self._call = None               # the channel's _Call, once launched
        self._cancel = None             # (code, text) of a start_cancel

    def _begin_trace_span(self, method_full: str) -> None:
        """Open the client half of an explicitly traced call: the client
        span parents to the span id the caller carried in, and the call's
        own span id replaces it on the wire, so the server span links back
        to this hop."""
        if not self.trace_id or self._client_span is not None:
            return
        span = start_client_span(method_full, self.trace_id, self.span_id)
        if span is not None:
            self._client_span = span
            self.span_id = span.span_id

    def _end_trace_span(self, remote_side) -> None:
        span = self._client_span
        if span is not None:
            self._client_span = None
            span.remote_side = str(remote_side or "")
            span.finish(self._error_code)

    # -- call ids ----------------------------------------------------------

    @property
    def call_id(self) -> int:
        """The cancel handle (≈ Controller::call_id, controller.cpp:358);
        valid from the call's launch until it ends."""
        return self._call_id

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the call to end: True once it has (or was never
        launched), False at ``timeout``."""
        if not self._call_id:
            return True
        return global_id_pool().join(self._call_id, timeout)

    def _open_call_id(self) -> None:
        self._cancel = None
        self._call = None
        self._call_id = global_id_pool().create(data=self,
                                                on_error=_on_id_error)

    def _attach_call(self, call) -> Optional[tuple]:
        """The launched call, under the id lock: a cancel that came first
        is returned (the call then never starts), a later one reaches the
        call through its results."""
        ok, _ = global_id_pool().lock(self._call_id)
        if not ok:
            return self._cancel
        try:
            self._call = call
            return self._cancel
        finally:
            global_id_pool().unlock(self._call_id)

    def _close_call_id(self, done: Optional[Callable] = None) -> None:
        """The call ended: its id dies (joiners wake, a later cancel is a
        no-op), then ``done`` runs."""
        cid = self._call_id
        ok, _ = global_id_pool().lock(cid)
        if ok:
            self._call = None
            global_id_pool().unlock_and_destroy(cid)
        if done is not None:
            try:
                done(self)
            except Exception:
                LOG.exception("rpc done callback raised")

    @property
    def failed(self) -> bool:
        return self._error_code != 0

    @property
    def error_code(self) -> int:
        return self._error_code

    @property
    def error_text(self) -> str:
        return self._error_text

    def set_failed(self, code: int, text: str = "") -> None:
        self._error_code = int(code)
        self._error_text = text


def _on_id_error(call_id: int, cntl: "Controller", code: int,
                 text: str) -> None:
    """Runs with the call's id locked (the IdPool contract): a cancel is
    recorded and, once the call is launched, put on its results."""
    cntl._cancel = (code, text)
    call = cntl._call
    if call is not None:
        call.results.put((-1, "cancel", (code, text)))
    global_id_pool().unlock(call_id)


def start_cancel(call_id: int) -> None:
    """≈ brpc::StartCancel(CallId): asynchronous and idempotent; the call
    ends ``ECANCELLED``."""
    global_id_pool().error(call_id, int(Errno.ECANCELLED),
                           "cancelled by caller")


def process_http_response(msg) -> tuple:
    """Client side of the HTTP protocol: one attempt's response
    (``protocol.http.HttpMessage``) -> ``(meta, body, attachment)``.  A
    non-200 carries the server's RPC code in ``x-rpc-error-code`` (else
    ``EHTTP``); ``x-lame-duck`` is the drain signal on any response; the
    attachment rides after the body, split off by
    ``x-rpc-attachment-size``."""
    meta = RpcMeta()
    if msg.headers.get("x-lame-duck"):
        meta.lame_duck = 1
    if msg.status_code != 200:
        rpc_code = msg.headers.get("x-rpc-error-code")
        meta.error_code = int(rpc_code) if rpc_code and rpc_code.isdigit() \
            else int(Errno.EHTTP)
        meta.error_text = (f"HTTP {msg.status_code}: "
                           f"{msg.body[:200].decode('latin1', 'replace')}")
        return meta, b"", b""
    body, att = msg.body, b""
    att_size = msg.headers.get("x-rpc-attachment-size")
    if att_size and att_size.isdigit():
        n = int(att_size)
        if 0 < n <= len(body):
            body, att = body[:len(body) - n], body[len(body) - n:]
    return meta, body, att
