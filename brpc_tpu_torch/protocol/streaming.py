"""Stream frames — the wire format of ``brpc_tpu/protocol/streaming.py``
and dispatch to the port's :class:`~brpc_tpu_torch.streaming.Stream`::

    [ "TSTR" ][ u8 flags ][ u64 dest_stream_id ][ u32 len ][ payload ]

17 bytes of header.  Frames ride the connection of the RPC that set the
stream up and are dispatched by destination stream id, the same on both
sides.  :func:`~brpc_tpu_torch.protocol.tpu_std.read_frame` cuts them off
a socket as :class:`StreamFrame`; where the dispatcher reads a
connection, :func:`parse` cuts them for the ``InputMessenger`` and
:data:`STREAMING` is their registration, processed inline on the
reading fiber in arrival order (a stream is ordered), on both sides.
The port materializes every payload as ``bytes``, where the JAX parser
shares the portal's blocks for a payload of 8 KiB or more.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

from .base import (ParseResult, Protocol, ProtocolType, max_body_size,
                   register_protocol)

MAGIC = b"TSTR"
HEADER = 17            # 4 magic + 1 flags + 8 dest id + 4 len

F_DATA = 0
F_FEEDBACK = 1
F_CLOSE = 2            # graceful FIN, the payload a named reason
F_RST = 3              # abortive


class StreamFrame(NamedTuple):
    flags: int
    dest: int
    payload: bytes


def pack_stream_frame(flags: int, dest: int, payload: bytes = b"") -> bytes:
    return MAGIC + struct.pack("<BQI", flags, dest, len(payload)) + payload


def dispatch(frame: StreamFrame, sock) -> None:
    """Hand one frame to the stream it names.  A stream is bound to one
    connection: a frame for it on any other socket is forged or misrouted
    (a peer guessing ids) and dropped, as are frames for streams that
    already closed."""
    from ..streaming import find_stream

    stream = find_stream(frame.dest)
    if stream is None:
        return
    if stream.socket_id and sock is not None \
            and sock.id != stream.socket_id:
        return
    stream.on_frame(frame.flags, frame.payload)


def parse(source, sock, read_eof: bool, arg) -> ParseResult:
    """One TSTR frame off ``source`` as a :class:`StreamFrame`."""
    avail = len(source)
    if avail < HEADER:
        if MAGIC.startswith(source.fetch(min(4, avail))):
            return ParseResult.not_enough_data()
        return ParseResult.try_others()
    head = source.fetch(HEADER)
    if head[:4] != MAGIC:
        return ParseResult.try_others()
    flags, dest, ln = struct.unpack_from("<BQI", head, 4)
    if ln > max_body_size():
        return ParseResult.too_big()
    if avail < HEADER + ln:
        return ParseResult.not_enough_data()
    source.pop_front(HEADER)
    payload = source.fetch(ln)
    source.pop_front(ln)
    return ParseResult.make_message(StreamFrame(flags, dest, payload))


STREAMING = Protocol(
    ProtocolType.STREAMING_RPC, "streaming_rpc", parse,
    process_request=lambda msg, sock, server: dispatch(msg, sock),
    process_response=dispatch,
    # frames are ordered within a stream: dispatched on the reading
    # fiber (a push into the stream's queue)
    process_inline=True)
register_protocol(STREAMING)
