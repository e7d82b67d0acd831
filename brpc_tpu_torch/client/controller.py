"""Controller — one client call's knobs and results.

The slim core of ``brpc_tpu/client/controller.py``: ``timeout_ms`` in,
``failed`` / ``error_code`` / ``error_text`` / ``response`` out.
Retries, backup requests, load balancing, streams and attachments wait
for later slices of the port.
"""

from __future__ import annotations

from typing import Any, Optional


class Controller:
    __slots__ = ("timeout_ms", "response", "_error_code", "_error_text")

    def __init__(self):
        self.timeout_ms: Optional[int] = None   # None = the channel's
        self.response: Any = None       # response bytes
        self._error_code = 0
        self._error_text = ""

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
