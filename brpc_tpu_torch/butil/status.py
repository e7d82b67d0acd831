"""Error status value (≈ brpc's butil/status.h) and the framework-wide
error codes (≈ brpc's errno.proto).  A copy of ``brpc_tpu/butil/status.py``:
the codes travel on the wire and must stay equal to the JAX package's."""

from __future__ import annotations

from enum import IntEnum
from typing import Optional


class Errno(IntEnum):
    """RPC error space — names mirror the reference's brpc/errno.proto so
    operators coming from the reference find the same vocabulary."""

    OK = 0
    # Framework errors (reference errno.proto values kept where they exist)
    ENOSERVICE = 1001      # service not found
    ENOMETHOD = 1002       # method not found
    EREQUEST = 1003        # bad request
    ERPCAUTH = 1004        # authentication failed
    ETOOMANYFAILS = 1005   # too many sub-channel failures (ParallelChannel)
    EPCHANFINISH = 1006    # ParallelChannel finished
    EBACKUPREQUEST = 1007  # backup request fired (internal)
    ERPCTIMEDOUT = 1008    # RPC deadline exceeded
    EFAILEDSOCKET = 1009   # socket broken during RPC
    EHTTP = 1010           # HTTP non-2xx
    EOVERCROWDED = 1011    # too many buffering bytes / queue full
    ERTMPPUBLISHABLE = 1012
    ERTMPCREATESTREAM = 1013
    EEOF = 1014            # stream EOF
    EUNUSED = 1015         # connection unused
    ESSL = 1016
    EH2RUNOUTSTREAMS = 1017
    EREJECT = 1018         # rejected by Interceptor / concurrency limiter
    # Client-side
    EINTERNAL = 2001
    ERESPONSE = 2002
    ELOGOFF = 2003         # server is stopping
    ELIMIT = 2004          # concurrent requests over max_concurrency
    ECLOSE = 2005
    EITP = 2007
    ELAMEDUCK = 2008       # server draining: re-resolve, no breaker
    #                        penalty (fail-fast retried on LB channels
    #                        like ELIMIT — the operability plane)
    # Additions for the TPU build
    EDEVICE = 3001         # device/ICI transport failure
    EMESH = 3002           # mesh membership/topology error
    ECANCELLED = 3003      # call cancelled via CallId


class Status:
    """Error code + message; falsy when not OK to allow `if not st:`."""

    __slots__ = ("code", "message")

    def __init__(self, code: int = 0, message: str = ""):
        self.code = int(code)
        self.message = message

    @staticmethod
    def ok() -> "Status":
        return Status(0, "")

    def is_ok(self) -> bool:
        return self.code == 0

    def __bool__(self) -> bool:
        return self.code == 0

    def set_error(self, code: int, message: str = "") -> "Status":
        self.code = int(code)
        self.message = message
        return self

    def reset(self) -> None:
        self.code = 0
        self.message = ""

    def error_str(self) -> str:
        if self.code == 0:
            return "OK"
        try:
            name = Errno(self.code).name
        except ValueError:
            name = str(self.code)
        return f"[{name}] {self.message}" if self.message else f"[{name}]"

    def __repr__(self) -> str:
        return f"Status({self.error_str()})"

    def __eq__(self, other) -> bool:
        if isinstance(other, Status):
            return self.code == other.code
        if isinstance(other, int):
            return self.code == other
        return NotImplemented
