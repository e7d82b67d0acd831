"""tpu_std — the framed RPC protocol, over plain ``bytes``.

The same frames as ``brpc_tpu/protocol/tpu_std.py``::

    [ "TRPC" ][ u32 body_size ][ u32 meta_size ]  -- 12-byte header
    [ meta (RpcMeta TLV) ][ payload ][ attachment ]

where ``body_size = meta_size + len(payload) + len(attachment)``.  The
JAX package frames into its IOBuf; the port packs and cuts ``bytes``.
"""

from __future__ import annotations

import socket
import struct
from typing import Any, Tuple

from .meta import RpcMeta

MAGIC = b"TRPC"
HEADER_SIZE = 12
MAX_BODY_SIZE = 64 * 1024 * 1024


class FrameError(ValueError):
    """Bytes that are not a tpu_std frame, or one past the size cap."""


def pack_frame(meta: RpcMeta, payload: bytes = b"",
               attachment: bytes = b"") -> bytes:
    """Frame one message; a non-empty ``attachment`` rides after the
    payload and its size is recorded in the meta."""
    if attachment:
        meta.attachment_size = len(attachment)
    meta_bytes = meta.encode()
    body_size = len(meta_bytes) + len(payload) + len(attachment)
    return b"".join((MAGIC, struct.pack("<II", body_size, len(meta_bytes)),
                     meta_bytes, payload, attachment))


def frame_size(header: bytes) -> int:
    """Total frame length from its first :data:`HEADER_SIZE` bytes."""
    if header[:4] != MAGIC:
        raise FrameError(f"bad magic {bytes(header[:4])!r}")
    body_size, meta_size = struct.unpack_from("<II", header, 4)
    if body_size > MAX_BODY_SIZE:
        raise FrameError(f"body {body_size} exceeds {MAX_BODY_SIZE}")
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
    body = bytes(frame[HEADER_SIZE + meta_size:])
    if meta.attachment_size > len(body):
        raise FrameError("attachment size exceeds body")
    split = len(body) - meta.attachment_size
    return meta, body[:split], body[split:]


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise EOFError("connection closed")
        buf += chunk
    return bytes(buf)


def read_frame(sock: socket.socket) -> Tuple[RpcMeta, bytes, bytes]:
    """Read one whole frame from a blocking socket.  Raises EOFError when
    the peer closes, FrameError on bytes that are not a frame."""
    header = _recv_exact(sock, HEADER_SIZE)
    body = _recv_exact(sock, frame_size(header) - HEADER_SIZE)
    return unpack_frame(header + body)


def serialize_payload(obj: Any) -> bytes:
    """A method's response or a call's request -> payload bytes."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return bytes(obj)
    if obj is None:
        return b""
    raise TypeError(f"cannot serialize {type(obj).__name__} as RPC payload;"
                    f" the port's payloads are bytes")
