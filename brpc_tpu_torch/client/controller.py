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

The HTTP client half (``brpc_tpu/client/controller.py:458``, ``:1072``):
:func:`process_http_response` reads an attempt's HTTP/1.1 response into
the meta the tpu_std attempt would have had (``x-rpc-error-code`` or
``EHTTP`` for a non-200, ``x-lame-duck``, the ``x-rpc-attachment-size``
split), so the channel settles both protocols alike.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Set

from ..butil.status import Errno
from ..protocol.meta import RpcMeta
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
                 "_channel")

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
