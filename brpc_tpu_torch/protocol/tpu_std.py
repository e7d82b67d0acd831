"""tpu_std — the framed RPC protocol, over plain ``bytes``.

The same frames as ``brpc_tpu/protocol/tpu_std.py``::

    [ "TRPC" ][ u32 body_size ][ u32 meta_size ]  -- 12-byte header
    [ meta (RpcMeta TLV) ][ payload ][ attachment ]

where ``body_size = meta_size + len(payload) + len(attachment)``.  The
JAX package frames into its IOBuf; the port packs and cuts ``bytes``.

The same connection also carries the device-attachment lane's "TICI"
credit-return frames (``brpc_tpu/ici/endpoint.py``'s ack frames)::

    [ "TICI" ][ u32 count ][ count x u64 descriptor id ]

and the streams' "TSTR" frames (:mod:`.streaming`).  :func:`read_frame`
returns any of the three kinds off a blocking socket (a caller that
reads its own connection).  Where the dispatcher reads a connection,
:func:`parse` cuts one tpu_std frame off the connection's portal for the
``InputMessenger`` and :data:`TPU_STD` is its registration (as
``brpc_tpu/protocol/tpu_std.py:170``): a request goes to
``server/rpc_dispatch.process_rpc_request`` with its acks deferred in
front of its response, a response to the call waiting on its
correlation id (``transport/socket_map.hand_over``).  The streams' and
the acks' registrations are ``STREAMING`` and ``ici.endpoint.ICI_ACK``.
A cut frame is stamped with its arrival (``RpcMessage.recv_ns``): the
deadline plane, CoDel and the server span run from it.

A frame's body is capped by the live flag ``max_body_size`` (64 MiB by
default, as in the JAX package), read at every send and receive.  The
port refuses an oversized frame already at send (:func:`pack_frame`
raises); the JAX package checks the cap only where a frame is received.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Any, NamedTuple, Tuple, Union

from ..butil.flags import define_flag, get_flag
from .base import ParseResult, Protocol, ProtocolType, register_protocol
from .meta import RpcMeta
from .streaming import HEADER as STREAM_HEADER_SIZE
from .streaming import MAGIC as STREAM_MAGIC
from .streaming import StreamFrame

MAGIC = b"TRPC"
HEADER_SIZE = 12
MAX_BODY_SIZE = 64 * 1024 * 1024       # the default of max_body_size
ACK_MAGIC = b"TICI"
ACK_HEADER_SIZE = 8
# ids per TICI frame when packing (the JAX encoder's chunk), and the most
# one frame may announce when reading (the JAX parser's cap)
_ACK_CHUNK = 4096
_ACK_MAX_IDS = 1 << 20


define_flag("max_body_size", MAX_BODY_SIZE, "largest acceptable frame body",
            validator=lambda v: isinstance(v, int) and v > 0)


def max_body_size() -> int:
    """The frame-size cap now (the ``max_body_size`` flag)."""
    return get_flag("max_body_size")


class FrameError(ValueError):
    """Bytes that are not a tpu_std frame, or one past the size cap."""


class RpcMessage(NamedTuple):
    """One cut tpu_std frame: its meta, payload and attachment, and its
    arrival on the monotonic clock (``(meta, payload, attachment)`` is
    what :func:`unpack_frame` returns, so a response reads as one)."""
    meta: RpcMeta
    payload: bytes
    attachment: bytes
    recv_ns: int
    # the first frame cut on a connection whose server checks
    # credentials: its verdict is the one later frames wait for
    auth_first: bool = False


class AckFrame(NamedTuple):
    """One TICI frame: the descriptor ids whose window credit returns."""
    ids: Tuple[int, ...]


def pack_frame(meta: RpcMeta, payload: bytes = b"",
               attachment: bytes = b"", extra_meta: bytes = b"") -> bytes:
    """Frame one message; a non-empty ``attachment`` rides after the
    payload and its size is recorded in the meta.  ``extra_meta`` is
    pre-encoded TLV bytes appended inside the meta region (the shm data
    plane's).  A body past :func:`max_body_size` raises
    :class:`FrameError`: the peer would refuse it."""
    if attachment:
        meta.attachment_size = len(attachment)
    meta_bytes = meta.encode() + extra_meta
    body_size = len(meta_bytes) + len(payload) + len(attachment)
    limit = max_body_size()
    if body_size > limit:
        raise FrameError(f"body {body_size} exceeds {limit}")
    return b"".join((MAGIC, struct.pack("<II", body_size, len(meta_bytes)),
                     meta_bytes, payload, attachment))


def frame_size(header: bytes) -> int:
    """Total frame length from its first :data:`HEADER_SIZE` bytes."""
    if header[:4] != MAGIC:
        raise FrameError(f"bad magic {bytes(header[:4])!r}")
    body_size, meta_size = struct.unpack_from("<II", header, 4)
    limit = max_body_size()
    if body_size > limit:
        raise FrameError(f"body {body_size} exceeds {limit}")
    if meta_size > body_size:
        raise FrameError("meta larger than body")
    return HEADER_SIZE + body_size


def unpack_frame(frame: bytes) -> Tuple[RpcMeta, bytes, bytes]:
    """One whole frame -> ``(meta, payload, attachment)``."""
    total = frame_size(frame)
    if len(frame) != total:
        raise FrameError(f"frame of {len(frame)} bytes, header says {total}")
    (meta_size,) = struct.unpack_from("<I", frame, 8)
    meta = RpcMeta.decode(bytes(frame[HEADER_SIZE:HEADER_SIZE + meta_size]))
    if meta is None:
        raise FrameError("malformed meta")
    body = memoryview(frame)[HEADER_SIZE + meta_size:]
    if meta.attachment_size > len(body):
        raise FrameError("attachment size exceeds body")
    split = len(body) - meta.attachment_size
    return meta, bytes(body[:split]), bytes(body[split:])


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            raise EOFError("connection closed")
        got += k
    return buf


def pack_ack_frame(ids) -> bytes:
    """TICI frame(s) returning the credit of ``ids``, chunked at 4096 ids
    a frame, back to back."""
    ids = list(ids)
    out = []
    for i in range(0, len(ids), _ACK_CHUNK):
        chunk = ids[i:i + _ACK_CHUNK]
        out.append(ACK_MAGIC + struct.pack(f"<I{len(chunk)}Q", len(chunk),
                                           *chunk))
    return b"".join(out)


def read_frame(sock: socket.socket
               ) -> Union[Tuple[RpcMeta, bytes, bytes], AckFrame,
                          StreamFrame]:
    """Read one whole frame from a blocking socket: a tpu_std frame as
    ``(meta, payload, attachment)``, a TICI frame as an
    :class:`AckFrame`, or a TSTR frame as a
    :class:`~.streaming.StreamFrame`.  Raises EOFError when the peer
    closes, FrameError on bytes that are none of them."""
    head = _recv_exact(sock, ACK_HEADER_SIZE)
    if head[:4] == ACK_MAGIC:
        (count,) = struct.unpack_from("<I", head, 4)
        if count > _ACK_MAX_IDS:
            raise FrameError(f"ack frame of {count} ids")
        data = _recv_exact(sock, 8 * count)
        return AckFrame(struct.unpack(f"<{count}Q", data))
    if head[:4] == STREAM_MAGIC:
        head += _recv_exact(sock, STREAM_HEADER_SIZE - ACK_HEADER_SIZE)
        flags, dest, size = struct.unpack_from("<BQI", head, 4)
        limit = max_body_size()
        if size > limit:
            raise FrameError(f"stream frame of {size} bytes exceeds "
                             f"{limit}")
        return StreamFrame(flags, dest, bytes(_recv_exact(sock, size)))
    header = head + _recv_exact(sock, HEADER_SIZE - ACK_HEADER_SIZE)
    body = _recv_exact(sock, frame_size(header) - HEADER_SIZE)
    return unpack_frame(header + body)


def parse_payload(data: bytes, response_type: Any) -> Any:
    """Payload bytes -> an object of ``response_type`` (None: the bytes),
    as ``brpc_tpu/protocol/tpu_std.py``'s ``parse_payload``."""
    if response_type is None or response_type in (bytes, bytearray):
        return data
    if hasattr(response_type, "FromString"):
        return response_type.FromString(data)
    inst = response_type()
    if hasattr(inst, "ParseFromString"):
        inst.ParseFromString(data)
        return inst
    if hasattr(inst, "parse"):
        inst.parse(data)
        return inst
    raise TypeError(f"cannot parse payload into {response_type!r}")


def serialize_payload(obj: Any) -> bytes:
    """A method's response or a call's request -> payload bytes."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return bytes(obj)
    if obj is None:
        return b""
    raise TypeError(f"cannot serialize {type(obj).__name__} as RPC payload;"
                    f" the port's payloads are bytes")


# -- the frame cut for the InputMessenger ------------------------------------

def _cut_bytes(source, n: int) -> bytes:
    """The first ``n`` bytes of an IOBuf, consumed, as one copy."""
    if n <= 0:
        return b""
    buf = source.cutn(n)
    return b"".join([blk.view(off, ln) for blk, off, ln in buf._refs])


def parse(source, sock, read_eof: bool, arg) -> ParseResult:
    """≈ ParseRpcMessage (baidu_rpc_protocol.cpp:95): one tpu_std frame
    off ``source`` as an :class:`RpcMessage` stamped with its arrival."""
    avail = len(source)
    if avail < HEADER_SIZE:
        if MAGIC.startswith(source.fetch(min(4, avail))):
            return ParseResult.not_enough_data()
        return ParseResult.try_others()
    header = source.fetch(HEADER_SIZE)
    if header[:4] != MAGIC:
        return ParseResult.try_others()
    body_size, meta_size = struct.unpack_from("<II", header, 4)
    limit = max_body_size()
    if body_size > limit:
        return ParseResult.too_big(limit)
    if meta_size > body_size:
        return ParseResult.absolutely_wrong()
    if avail < HEADER_SIZE + body_size:
        return ParseResult.not_enough_data()
    recv_ns = time.monotonic_ns()
    source.pop_front(HEADER_SIZE)
    meta = RpcMeta.decode(_cut_bytes(source, meta_size))
    rest = body_size - meta_size
    if meta is None or meta.attachment_size > rest:
        return ParseResult.absolutely_wrong()
    payload = _cut_bytes(source, rest - meta.attachment_size)
    attachment = _cut_bytes(source, meta.attachment_size)
    auth_first = False
    if arg is not None and sock.auth_gate is None \
            and sock.app_data is None \
            and getattr(arg.options, "auth", None) is not None:
        # frames are cut in order: the first one's verdict decides
        sock.auth_gate = threading.Event()
        auth_first = True
    return ParseResult.make_message(RpcMessage(meta, payload, attachment,
                                               recv_ns, auth_first))


def _process_request(msg: RpcMessage, sock, server) -> None:
    # the server layer sits above the protocol layer
    from ..server.rpc_dispatch import process_rpc_request
    # acks queued while the request is served ride in front of its
    # response
    sock.defer_acks = True
    try:
        process_rpc_request(msg, sock, server)
    finally:
        sock.defer_acks = False
        if msg.auth_first:
            sock.auth_gate.set()
    sock.flush_acks()


def _process_response(msg: RpcMessage, sock) -> None:
    from ..transport.socket_map import hand_over
    hand_over(sock, msg)


TPU_STD = Protocol(ProtocolType.TPU_STD, "tpu_std", parse,
                   process_request=_process_request,
                   process_response=_process_response)
register_protocol(TPU_STD)
