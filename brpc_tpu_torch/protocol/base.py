"""Protocol plugin API + registry.

Fresh design following the reference's 3-step protocol recipe
(brpc's src/brpc/protocol.h:71-75): implement parse/process
callbacks, pick an id, register. Differences from the reference:

- callbacks are plain Python callables on a dataclass-like object;
- ``parse`` returns a :class:`ParseResult` carrying either a cut message
  or a :class:`ParseError` telling the messenger to wait for more bytes /
  try other protocols / fail the connection;
- messages cut by ``parse`` are arbitrary objects owned by the protocol
  (the framed pb-RPC protocol cuts an ``RpcMessage`` with meta + payload
  IOBuf views — zero-copy all the way to user code).

A copy of ``brpc_tpu/protocol/base.py``.  The port's registrations are
listed in its server's ``InputMessenger`` (``server/server.py``) and
client messenger (``transport/input_messenger.py``).
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Callable, Dict, List, Optional


class ProtocolType(enum.IntEnum):
    """Wire protocol ids (≈ brpc's src/brpc/options.proto:38-67).
    Values are this framework's own; names keep the reference vocabulary
    where capabilities overlap."""

    UNKNOWN = 0
    TPU_STD = 1          # framed pb-RPC, the default (≈ baidu_std)
    STREAMING_RPC = 2
    HTTP = 3             # HTTP/1.x (+ restful + JSON bridge)
    H2 = 4               # HTTP/2 + gRPC
    REDIS = 5
    MEMCACHE = 6
    THRIFT = 7
    ESP = 8
    NSHEAD = 9
    MESH = 10            # device-mesh collective transport frames
    ICI_ACK = 11         # device-attachment redemption acks (ici/)


class ParseError(enum.IntEnum):
    """Outcome codes for Protocol.parse (≈ protocol.h ParseError)."""

    OK = 0
    TRY_OTHERS = 1        # bytes don't look like this protocol at all
    NOT_ENOUGH_DATA = 2   # prefix matches; wait for more bytes
    ABSOLUTELY_WRONG = 3  # prefix matches but the frame is broken: fail fd
    TOO_BIG_DATA = 4      # frame exceeds max_body_size: fail fd


class ParseResult:
    """Either a successfully cut message or an error telling the input
    messenger what to do next."""

    __slots__ = ("error", "message")

    def __init__(self, error: ParseError = ParseError.OK,
                 message: Any = None):
        self.error = error
        self.message = message

    @property
    def ok(self) -> bool:
        return self.error == ParseError.OK

    @staticmethod
    def make_message(msg: Any) -> "ParseResult":
        return ParseResult(ParseError.OK, msg)

    @staticmethod
    def not_enough_data() -> "ParseResult":
        return ParseResult(ParseError.NOT_ENOUGH_DATA)

    @staticmethod
    def try_others() -> "ParseResult":
        return ParseResult(ParseError.TRY_OTHERS)

    @staticmethod
    def absolutely_wrong() -> "ParseResult":
        return ParseResult(ParseError.ABSOLUTELY_WRONG)

    @staticmethod
    def too_big(limit: int = 0) -> "ParseResult":
        return ParseResult(ParseError.TOO_BIG_DATA)


# 64 MB default, mirroring the reference (src/brpc/protocol.cpp:44).
MAX_BODY_SIZE = 64 * 1024 * 1024


def max_body_size() -> int:
    """Current frame-size cap — live-tunable via /flags/max_body_size."""
    from ..butil.flags import get_flag
    return get_flag("max_body_size", MAX_BODY_SIZE)


class Protocol:
    """Struct-of-callbacks protocol plugin
    (≈ brpc's src/brpc/protocol.h:92-146).

    parse(source: IOBuf, socket, read_eof: bool, arg) -> ParseResult
        Cut ONE message off ``source`` (mutating it). ``arg`` is the
        server (server side) or None (client side).
    serialize_request(request, controller) -> IOBuf | None
        Turn the user request object into payload bytes. Runs once per
        RPC (not per retry). On failure, set error on controller.
    pack_request(payload: IOBuf, controller, correlation_id) -> IOBuf
        Frame the serialized payload for one attempt (adds header/meta).
    process_request(msg, socket, server) -> None
        Server-side: full service dispatch for one cut message.
    process_response(msg, socket) -> None
        Client-side: rendezvous with the waiting call via correlation id.
    verify(msg) -> bool
        Server-side auth check on first message of a connection.
    """

    __slots__ = ("type", "name", "parse", "serialize_request",
                 "pack_request", "process_request", "process_response",
                 "verify", "support_client", "support_server",
                 "process_inline")

    def __init__(self, type: ProtocolType, name: str,
                 parse: Callable,
                 process_request: Optional[Callable] = None,
                 process_response: Optional[Callable] = None,
                 serialize_request: Optional[Callable] = None,
                 pack_request: Optional[Callable] = None,
                 verify: Optional[Callable] = None,
                 process_inline: bool = False):
        self.type = type
        self.name = name
        self.parse = parse
        self.process_request = process_request
        self.process_response = process_response
        self.serialize_request = serialize_request
        self.pack_request = pack_request
        self.verify = verify
        self.support_client = process_response is not None
        self.support_server = process_request is not None
        # True = the messenger must process messages on the reading task
        # in arrival order (protocols with ordered semantics — streams);
        # processing must then be cheap/non-blocking
        self.process_inline = process_inline


_registry_lock = threading.Lock()
_registry: Dict[ProtocolType, Protocol] = {}


def register_protocol(proto: Protocol) -> None:
    """≈ RegisterProtocol (brpc's src/brpc/protocol.h:186).
    Re-registering the same type raises — protocols are process-global."""
    with _registry_lock:
        if proto.type in _registry:
            raise ValueError(f"protocol {proto.type!r} already registered")
        _registry[proto.type] = proto


def get_protocol(ptype: ProtocolType) -> Optional[Protocol]:
    return _registry.get(ptype)


def list_protocols() -> List[Protocol]:
    with _registry_lock:
        return list(_registry.values())
