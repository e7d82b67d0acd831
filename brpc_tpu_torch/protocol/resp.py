"""RESP (REdis Serialization Protocol) — server protocol + codec.

The port of ``brpc_tpu/protocol/resp.py`` (brpc's ``redis.h`` and
``policy/redis_protocol.cpp``): the one serving port speaks RESP when
the server registered a redis service — redis-cli can talk to an RPC
server directly.  The service is
any object with ``on_command(args: list[bytes])`` returning a reply:

    bytes / bytearray  -> bulk string
    str                -> simple string (+OK style)
    int                -> :integer
    None               -> nil bulk
    RedisError("msg")  -> -ERR style error
    list/tuple         -> array (recursively encoded)

Register it as ``server.add_service(obj, name="redis")`` — objects with
``on_command`` are exempt from RPC-method extraction.  Commands run
inline on the connection's consumer fiber, so a pipeline is answered in
order.  The code is the JAX module's, the replies written as ``bytes``;
nothing is cut.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ..butil.logging_util import LOG
from .base import (ParseResult, Protocol, ProtocolType, max_body_size,
                   register_protocol)


class RedisError(Exception):
    """Reply as a RESP error without killing the connection."""


# -- codec ------------------------------------------------------------------

def encode_reply(obj: Any) -> bytes:
    if isinstance(obj, RedisError):
        msg = str(obj).replace("\r", " ").replace("\n", " ")
        if not msg.upper().startswith(("ERR", "WRONGTYPE", "MOVED")):
            msg = "ERR " + msg
        return b"-" + msg.encode() + b"\r\n"
    if isinstance(obj, bool):
        return b":1\r\n" if obj else b":0\r\n"
    if isinstance(obj, int):
        return b":%d\r\n" % obj
    if isinstance(obj, str):
        return b"+" + obj.encode() + b"\r\n"
    if isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        return b"$%d\r\n" % len(b) + b + b"\r\n"
    if obj is None:
        return b"$-1\r\n"
    if isinstance(obj, (list, tuple)):
        out = b"*%d\r\n" % len(obj)
        return out + b"".join(encode_reply(x) for x in obj)
    raise TypeError(f"cannot encode {type(obj).__name__} as RESP")


def decode_one(data: bytes, off: int = 0) -> Tuple[Optional[Any], int]:
    """Decode one RESP value.  Returns (value, new_offset);
    (None, off) with new_offset == off means incomplete.  Errors decode
    as RedisError instances, nil as the _NIL sentinel."""
    if off >= len(data):
        return None, off
    end = data.find(b"\r\n", off)
    if end < 0:
        return None, off
    t = data[off:off + 1]
    line = data[off + 1:end]
    nxt = end + 2
    if t == b"+":
        return line.decode("utf-8", "replace"), nxt
    if t == b"-":
        return RedisError(line.decode("utf-8", "replace")), nxt
    if t == b":":
        return int(line), nxt
    if t == b"$":
        n = int(line)
        if n < 0:
            return _NIL, nxt
        if len(data) < nxt + n + 2:
            return None, off
        return data[nxt:nxt + n], nxt + n + 2
    if t == b"*":
        n = int(line)
        if n < 0:
            return _NIL, nxt
        items = []
        pos = nxt
        for _ in range(n):
            v, pos2 = decode_one(data, pos)
            if pos2 == pos and v is None:
                return None, off
            items.append(None if v is _NIL else v)
            pos = pos2
        return items, pos
    raise ValueError(f"bad RESP type byte {t!r}")


class _Nil:
    def __repr__(self):
        return "<redis nil>"


_NIL = _Nil()
NIL = _NIL


def encode_command(*args) -> bytes:
    """Client side: command as a RESP array of bulk strings."""
    out = b"*%d\r\n" % len(args)
    for a in args:
        b = a if isinstance(a, bytes) else str(a).encode()
        out += b"$%d\r\n" % len(b) + b + b"\r\n"
    return out


# -- server protocol on the shared port -------------------------------------

class RespCommand:
    __slots__ = ("args",)

    def __init__(self, args: List[bytes]):
        self.args = args


def parse(source, sock, read_eof: bool, arg) -> ParseResult:
    avail = len(source)
    first = source.fetch(1)
    if first != b"*":
        return ParseResult.try_others()
    if arg is None or "redis" not in getattr(arg, "services", {}):
        return ParseResult.try_others()   # no redis service registered
    data = source.to_bytes()
    try:
        val, pos = decode_one(data, 0)
    except (ValueError, UnicodeDecodeError):
        return ParseResult.absolutely_wrong()
    if pos == 0 and val is None:
        if avail > max_body_size():
            return ParseResult.too_big()
        return ParseResult.not_enough_data()
    source.pop_front(pos)
    if not isinstance(val, list) or not all(
            isinstance(x, (bytes, bytearray)) for x in val):
        return ParseResult.absolutely_wrong()
    return ParseResult.make_message(RespCommand([bytes(x) for x in val]))


def _process_request(msg: RespCommand, sock, server) -> None:
    svc = server.services.get("redis")
    if svc is None:
        sock.write(encode_reply(RedisError("ERR no redis service")))
        return
    try:
        reply = svc.on_command(msg.args)
    except RedisError as e:
        reply = e
    except Exception as e:       # noqa: BLE001 — server must answer
        LOG.exception("redis command %r raised", msg.args[:1])
        reply = RedisError(f"ERR internal: {type(e).__name__}")
    try:
        sock.write(encode_reply(reply))
    except TypeError:
        sock.write(encode_reply(
            RedisError("ERR unencodable reply from service")))


RESP = Protocol(
    ProtocolType.REDIS, "redis", parse,
    process_request=_process_request,
    process_inline=True,        # redis pipelining is order-sensitive
)
register_protocol(RESP)
