"""ServerController — the per-request context handed to service methods.

The slim core of ``brpc_tpu/server/controller.py``: the request meta,
the peer and the connection id, attachments in both directions (bytes,
and device tensors through the ICI lane: ``request_device_attachment``
is a :class:`~brpc_tpu_torch.ici.DeviceAttachment` to redeem with
``.tensor()``, ``response_device_attachment`` a tensor to send back),
error reporting, and the stream handshake (``_remote_stream_id`` from the
request, set by ``streaming.stream_accept``'s ``_accepted_stream_id`` and
``_accepted_stream_window`` for the response), and ``span``, the
request's rpcz server span (None when the request was not sampled).
Async completion and deadlines wait for later slices of the port.
"""

from __future__ import annotations

from typing import Optional

from ..butil.endpoint import EndPoint
from ..butil.status import Errno
from ..protocol.meta import RpcMeta


class ServerController:
    __slots__ = ("request_meta", "remote_side", "socket_id",
                 "request_attachment", "response_attachment",
                 "request_device_attachment", "response_device_attachment",
                 "_error_code", "_error_text", "_remote_stream_id",
                 "_accepted_stream_id", "_accepted_stream_window", "span")

    def __init__(self, request_meta: RpcMeta,
                 remote_side: Optional[EndPoint] = None,
                 request_attachment: bytes = b"", socket_id: int = 0):
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
