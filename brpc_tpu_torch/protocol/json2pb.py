"""json2pb — JSON ⇄ protobuf conversion for the HTTP bridge.

≈ brpc's src/json2pb/ (json_to_pb.cpp / pb_to_json.cpp): HTTP
clients POST JSON at a method whose ``@method(request_type=...)`` is a
protobuf Message class and the bridge converts both directions; the
framed-RPC path keeps carrying binary pb untouched.  Built on the real
``google.protobuf.json_format`` (no hand-rolled schema walker).

A copy of ``brpc_tpu/protocol/json2pb.py``.  Where ``google.protobuf``
is not installed, no class is a pb class and the bridge passes bytes
through, as the LM's payloads are.
"""

from __future__ import annotations

from typing import Any, Optional

try:
    from google.protobuf import json_format
    from google.protobuf.message import Message
    _HAVE_PB = True
except ImportError:                      # pragma: no cover
    json_format = None
    Message = ()                          # type: ignore[assignment]
    _HAVE_PB = False


def is_pb_class(cls: Any) -> bool:
    return _HAVE_PB and isinstance(cls, type) and issubclass(cls, Message)


def json_to_pb(data: bytes, message_cls) -> Any:
    """JSON bytes → a protobuf message instance (raises on mismatch)."""
    msg = message_cls()
    json_format.Parse(data.decode("utf-8"), msg)
    return msg


def pb_to_json(msg: Any) -> bytes:
    return json_format.MessageToJson(msg).encode("utf-8")


def maybe_parse_request(raw: bytes, request_type,
                        content_type: str) -> Optional[Any]:
    """HTTP bridge hook: JSON body + pb request type ⇒ converted message;
    None means 'not a json2pb case, use the normal parser'."""
    if not is_pb_class(request_type):
        return None
    ct = (content_type or "").lower()
    if "json" not in ct and not (raw[:1] in (b"{", b"[")):
        return None
    return json_to_pb(raw, request_type)


def maybe_encode_response(response: Any) -> Optional[bytes]:
    """HTTP bridge hook: pb message response ⇒ JSON bytes."""
    if _HAVE_PB and isinstance(response, Message):
        return pb_to_json(response)
    return None
