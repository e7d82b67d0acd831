"""ServerController — the per-request context handed to service methods.

The slim core of ``brpc_tpu/server/controller.py``: the request meta,
the peer and the connection id, attachments in both directions (bytes,
and device tensors through the ICI lane: ``request_device_attachment``
is a :class:`~brpc_tpu_torch.ici.DeviceAttachment` to redeem with
``.tensor()``, ``response_device_attachment`` a tensor to send back),
error reporting, and the stream handshake (``_remote_stream_id`` from the
request, set by ``streaming.stream_accept``'s ``_accepted_stream_id`` and
``_accepted_stream_window`` for the response), ``span``, the
request's rpcz server span (None when the request was not sampled),
``server``, the serving :class:`~brpc_tpu_torch.server.Server` (a
stream accepted on it is closed by its drain), and the deadline API of
``brpc_tpu/server/controller.py:127-146``: ``deadline_us`` (the absolute
monotonic-µs deadline, 0 for none; the server re-anchors it at the
frame's arrival), ``deadline_remaining_ms()`` and ``deadline_expired``.
Every lane (tpu_std in ``server/server.py``, ``server/http_dispatch.py``,
``protocol/h2_rpc.py``) builds its controller with ``send``, the lane's
completion callback, which :meth:`finish` calls once; the HTTP and gRPC
lanes also set ``http_method``, ``http_path``, ``http_unresolved_path``
(a restful mapping's captured tail) and ``grpc_stream`` (a streaming
gRPC method's :class:`~brpc_tpu_torch.protocol.h2_rpc.GrpcServerStream`),
and an HTTP handler may answer through
:meth:`create_progressive_attachment`.  Async completion
(``brpc_tpu/server/controller.py:170-201``): a handler that calls
:meth:`begin_async` owns its completion and answers later, from any
thread, through :meth:`finish`; otherwise the lane finishes with the
handler's return value.  ``response_compress_type`` (default: the
method's ``@method(response_compress=)``) compresses a tpu_std
response; :meth:`session_local_data` lends the request an object from
the server's ``SimpleDataPool`` (``ServerOptions.
session_local_data_factory``), given back when the request finishes;
``auth_context`` is the authenticator's to fill.
"""

from __future__ import annotations

import threading
from time import monotonic_ns as _mono_ns
from typing import Any, Callable, Optional

from ..butil.endpoint import EndPoint
from ..butil.status import Errno
from ..protocol.meta import CompressType, RpcMeta


class ServerController:
    __slots__ = ("request_meta", "remote_side", "socket_id",
                 "request_attachment", "response_attachment",
                 "request_device_attachment", "response_device_attachment",
                 "_error_code", "_error_text", "_remote_stream_id",
                 "_accepted_stream_id", "_accepted_stream_window", "span",
                 "server", "begin_time_us", "deadline_us", "_send",
                 "http_method", "http_path", "http_unresolved_path",
                 "_progressive", "grpc_stream", "response_compress_type",
                 "auth_context", "_async", "_finish_lock", "_session_data",
                 "_slim_fast", "_shm_extra", "_shm_handle")

    def __init__(self, request_meta: RpcMeta,
                 remote_side: Optional[EndPoint] = None,
                 request_attachment: bytes = b"", socket_id: int = 0,
                 send: Optional[Callable] = None):
        self.request_meta = request_meta
        self.remote_side = remote_side
        self.socket_id = socket_id      # the connection (transport.Socket)
        self.request_attachment = request_attachment
        self.response_attachment = b""  # bytes sent after the response
        self.request_device_attachment = None
        self.response_device_attachment = None
        self._error_code = 0
        self._error_text = ""
        self._remote_stream_id = request_meta.stream_id
        self._accepted_stream_id = 0
        self._accepted_stream_window = 0
        self.span = None                # rpcz Span, set by the server
        self.server: Any = None
        self.begin_time_us = _mono_ns() // 1000
        # absolute monotonic-µs deadline from the request's propagated
        # remaining budget (TLV 13), 0 = none; deadline.arm re-anchors it
        # at the frame's arrival, so this default is the latest possible
        tmo = request_meta.timeout_ms
        self.deadline_us = self.begin_time_us + tmo * 1000 if tmo > 0 \
            else 0
        self._send = send               # the lane's completion callback
        self.http_method = ""
        self.http_path = ""
        self.http_unresolved_path = ""
        self._progressive = None
        self.grpc_stream = None
        self.response_compress_type = CompressType.NONE
        self.auth_context: Any = None
        self._async = False
        self._finish_lock = threading.Lock()
        self._session_data = None       # borrowed SimpleDataPool object
        # the native slim lane's trivial-shape request, whose admission
        # counts were never taken (server/slim_dispatch.py)
        self._slim_fast = False
        # the classic lane's shm negotiation: the TLVs every response of
        # the request carries, and the request slot's handle
        self._shm_extra = b""
        self._shm_handle = None

    # -- async completion --------------------------------------------------

    def begin_async(self) -> None:
        """Declare that the response will be sent later through
        :meth:`finish` (≈ brpc's done->Run() ownership transfer): the
        lane does not answer when the handler returns."""
        self._async = True

    @property
    def is_async(self) -> bool:
        return self._async

    def finish(self, response: Any = None) -> None:
        """Complete the request through the lane's ``send`` callback.
        Idempotent: the first call wins.  The session-local data goes back
        to the server's pool first: the handler is done with it, and the
        connection's next request may be served (on another fiber) as soon
        as this answer is written, where the JAX lane gives it back after
        the write."""
        with self._finish_lock:
            send, self._send = self._send, None
        if send is None:
            return
        if self._session_data is not None and self.server is not None \
                and self.server._session_pool is not None:
            self.server._session_pool.give_back(self._session_data)
            self._session_data = None
        send(self, response)

    def _mark_finished_if_first(self) -> bool:
        """Claim the completion without calling ``send``: a native slim
        lane that answers inline (the engine builds the frame) takes it
        here, so a later :meth:`finish` is a no-op.  False when another
        completion already won."""
        with self._finish_lock:
            send, self._send = self._send, None
        return send is not None

    def session_local_data(self) -> Any:
        """Reusable per-request user data from the server's
        SimpleDataPool (≈ Controller::session_local_data); None when the
        server has no ``session_local_data_factory``."""
        if self._session_data is None and self.server is not None \
                and self.server._session_pool is not None:
            self._session_data = self.server._session_pool.borrow()
        return self._session_data

    def create_progressive_attachment(self):
        """An HTTP response body written in chunks after the handler
        returns (≈ brpc's progressive_attachment.h): the headers go out
        at completion, then each ``write`` is one chunk until
        ``close``."""
        from .http_dispatch import ProgressiveAttachment
        if self._progressive is None:
            self._progressive = ProgressiveAttachment(self.socket_id)
        return self._progressive

    # -- deadline plane ----------------------------------------------------

    def deadline_remaining_ms(self) -> Optional[float]:
        """Remaining budget of this request's propagated deadline in ms
        (negative once expired), or None when it carries no deadline.
        Downstream calls on the handler's own call stack inherit it
        (``deadline.inherit_deadline``)."""
        if not self.deadline_us:
            return None
        return (self.deadline_us - _mono_ns() // 1000) / 1000.0

    @property
    def deadline_expired(self) -> bool:
        """True once the request's propagated deadline has passed."""
        return bool(self.deadline_us) \
            and _mono_ns() // 1000 >= self.deadline_us

    @property
    def failed(self) -> bool:
        return self._error_code != 0

    def set_failed(self, code_or_text, text: str = "") -> None:
        """``cntl.set_failed("oops")`` or ``cntl.set_failed(EREQUEST, "x")``."""
        if isinstance(code_or_text, str):
            self._error_code = int(Errno.EINTERNAL)
            self._error_text = code_or_text
        else:
            self._error_code = int(code_or_text)
            self._error_text = text

    def annotate(self, text: str) -> None:
        """Add a note to the request's rpcz span (a no-op when the request
        was not sampled)."""
        if self.span is not None:
            self.span.annotate(text)

    @property
    def error_code(self) -> int:
        return self._error_code

    @property
    def error_text(self) -> str:
        return self._error_text
