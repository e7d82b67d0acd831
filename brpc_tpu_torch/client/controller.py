"""Controller — one client call's knobs and results.

The slim core of ``brpc_tpu/client/controller.py``: ``timeout_ms``,
``request_attachment`` (bytes) and ``request_device_attachment`` (a
tensor for the ICI lane) in; ``failed`` / ``error_code`` / ``error_text``,
``response``, ``response_attachment`` and ``response_device_attachment``
(a :class:`~brpc_tpu_torch.ici.DeviceAttachment` to redeem with
``.tensor()``) out; ``streaming.stream_create`` sets
``_stream_to_create``, the stream the call sets up.  Retries, backup
requests and load balancing wait for later slices of the port.
"""

from __future__ import annotations

from typing import Any, Optional


class Controller:
    __slots__ = ("timeout_ms", "request_attachment",
                 "request_device_attachment", "response",
                 "response_attachment", "response_device_attachment",
                 "_error_code", "_error_text", "_stream_to_create")

    def __init__(self):
        self.timeout_ms: Optional[int] = None   # None = the channel's
        self.request_attachment: bytes = b""
        self.request_device_attachment: Any = None
        self.response: Any = None       # response bytes
        self.response_attachment: bytes = b""
        self.response_device_attachment = None
        self._error_code = 0
        self._error_text = ""
        self._stream_to_create = None   # set by streaming.stream_create

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
