"""HTTP/2 (RFC 7540) connection session — framing + state, both sides.

Capability parity with the reference's H2Context/H2StreamContext
(brpc's src/brpc/policy/http2_rpc_protocol.cpp, 1,835 LoC) at
the scope gRPC interop needs: connection preface, SETTINGS exchange,
HEADERS/CONTINUATION with HPACK, DATA with connection+stream flow
control, WINDOW_UPDATE, PING, RST_STREAM, GOAWAY.

Fresh design: one :class:`H2Session` drives both client and server
ends.  ``feed(bytes)`` consumes wire bytes and returns a list of
events; every send_* method appends to an output buffer the caller
drains with ``take_output()`` and writes to its transport — the
session never touches sockets (easy to test byte-for-byte and to ride
either the Python or native transport).

A copy of ``brpc_tpu/protocol/h2_session.py``.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Tuple

from .hpack import Decoder as HpackDecoder
from .hpack import Encoder as HpackEncoder
from .hpack import HpackError

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types
F_DATA = 0x0
F_HEADERS = 0x1
F_PRIORITY = 0x2
F_RST_STREAM = 0x3
F_SETTINGS = 0x4
F_PUSH_PROMISE = 0x5
F_PING = 0x6
F_GOAWAY = 0x7
F_WINDOW_UPDATE = 0x8
F_CONTINUATION = 0x9

# flags
FLAG_END_STREAM = 0x1
FLAG_ACK = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

# settings ids
S_HEADER_TABLE_SIZE = 0x1
S_ENABLE_PUSH = 0x2
S_MAX_CONCURRENT_STREAMS = 0x3
S_INITIAL_WINDOW_SIZE = 0x4
S_MAX_FRAME_SIZE = 0x5
S_MAX_HEADER_LIST_SIZE = 0x6

DEFAULT_WINDOW = 65535
RECV_WINDOW = 4 * 1024 * 1024      # what we advertise

# error codes
E_NO_ERROR = 0x0
E_PROTOCOL = 0x1
E_FLOW_CONTROL = 0x3
E_REFUSED = 0x7


class H2Error(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


class _Stream:
    __slots__ = ("id", "send_window", "pending", "end_after_pending",
                 "trailers", "headers_done", "closed_local",
                 "closed_remote")

    def __init__(self, sid: int, send_window: int):
        self.id = sid
        self.send_window = send_window
        self.pending = bytearray()     # data waiting for window
        self.end_after_pending = False
        self.trailers: Optional[List[Tuple[str, str]]] = None
        self.headers_done = False
        self.closed_local = False
        self.closed_remote = False


class H2Session:
    """Events returned by feed():
    ("headers", sid, [(name, value)], end_stream)
    ("data", sid, bytes, end_stream)
    ("rst", sid, error_code)
    ("goaway", last_sid, error_code, debug_bytes)
    ("ping", payload)          # already acked internally
    """

    def __init__(self, is_server: bool):
        self.is_server = is_server
        self._buf = bytearray()
        self._out = bytearray()
        self._hp_enc = HpackEncoder()
        self._hp_dec = HpackDecoder()
        self._streams: Dict[int, _Stream] = {}
        self._next_sid = 2 if is_server else 1
        self._preface_seen = not is_server
        self._preface_sent = False
        self.peer_initial_window = DEFAULT_WINDOW
        self.conn_send_window = DEFAULT_WINDOW
        self.conn_recv_consumed = 0
        self.max_frame_size = 16384
        self._hdr_accum: Optional[Tuple[int, bytearray, int]] = None
        self.goaway_received = False
        self.lock = threading.RLock()   # callers serialize on this

    # -- output ------------------------------------------------------------

    def take_output(self) -> bytes:
        out = bytes(self._out)
        del self._out[:]
        return out

    def _frame(self, ftype: int, flags: int, sid: int,
               payload: bytes = b"") -> None:
        self._out += struct.pack(">I", len(payload))[1:]
        self._out.append(ftype)
        self._out.append(flags)
        self._out += struct.pack(">I", sid & 0x7FFFFFFF)
        self._out += payload

    def start(self) -> None:
        """Queue the preface (client) + initial SETTINGS + window."""
        if self._preface_sent:
            return
        self._preface_sent = True
        if not self.is_server:
            self._out += PREFACE
        settings = struct.pack(">HI", S_INITIAL_WINDOW_SIZE, RECV_WINDOW)
        settings += struct.pack(">HI", S_MAX_CONCURRENT_STREAMS, 1024)
        self._frame(F_SETTINGS, 0, 0, settings)
        # grow the connection receive window
        self._frame(F_WINDOW_UPDATE, 0, 0,
                    struct.pack(">I", RECV_WINDOW - DEFAULT_WINDOW))

    # -- send side ---------------------------------------------------------

    def next_stream_id(self) -> int:
        sid = self._next_sid
        self._next_sid += 2
        return sid

    def _stream(self, sid: int) -> _Stream:
        st = self._streams.get(sid)
        if st is None:
            st = self._streams[sid] = _Stream(sid, self.peer_initial_window)
        return st

    def send_headers(self, sid: int, headers: List[Tuple[str, str]],
                     end_stream: bool = False) -> None:
        st = self._stream(sid)
        if st.pending or (st.end_after_pending and not st.closed_local):
            # DATA is still window-blocked: these headers are trailers
            # and MUST follow it — defer to the pump (frames on a stream
            # are ordered; emitting now would truncate the response)
            st.trailers = list(headers)
            if not end_stream:
                raise H2Error(E_PROTOCOL,
                              "non-trailing HEADERS after pending DATA")
            self._pump_stream(st)
            return
        block = self._hp_enc.encode(headers)
        flags = FLAG_END_HEADERS | (FLAG_END_STREAM if end_stream else 0)
        self._frame(F_HEADERS, flags, sid, block)
        if end_stream:
            st.closed_local = True

    MAX_PENDING = 64 << 20      # per-stream window-blocked buffer cap

    def send_data(self, sid: int, data: bytes,
                  end_stream: bool = False) -> None:
        st = self._stream(sid)
        if len(st.pending) + len(data) > self.MAX_PENDING:
            # a peer sitting on its window must not buffer us to death:
            # reset the stream instead of accumulating unboundedly
            self.send_rst(sid, E_FLOW_CONTROL)
            raise H2Error(E_FLOW_CONTROL,
                          f"stream {sid} window-blocked beyond "
                          f"{self.MAX_PENDING} pending bytes")
        st.pending += data
        st.end_after_pending = st.end_after_pending or end_stream
        self._pump_stream(st)

    def _pump_stream(self, st: _Stream) -> None:
        while st.pending:
            allowed = min(len(st.pending), st.send_window,
                          self.conn_send_window, self.max_frame_size)
            if allowed <= 0:
                return                 # wait for WINDOW_UPDATE
            chunk = bytes(st.pending[:allowed])
            del st.pending[:allowed]
            st.send_window -= allowed
            self.conn_send_window -= allowed
            # END_STREAM rides the last DATA only when no trailers follow
            last = not st.pending and st.end_after_pending \
                and st.trailers is None
            self._frame(F_DATA, FLAG_END_STREAM if last else 0,
                        st.id, chunk)
            if last:
                st.closed_local = True
        if st.trailers is not None:
            block = self._hp_enc.encode(st.trailers)
            st.trailers = None
            self._frame(F_HEADERS, FLAG_END_HEADERS | FLAG_END_STREAM,
                        st.id, block)
            st.closed_local = True
            st.end_after_pending = False
        elif st.end_after_pending and not st.closed_local:
            self._frame(F_DATA, FLAG_END_STREAM, st.id, b"")
            st.closed_local = True

    def send_rst(self, sid: int, code: int = E_NO_ERROR) -> None:
        self._frame(F_RST_STREAM, 0, sid, struct.pack(">I", code))
        self._streams.pop(sid, None)

    def send_goaway(self, code: int = E_NO_ERROR) -> None:
        last = max(self._streams) if self._streams else 0
        self._frame(F_GOAWAY, 0, 0, struct.pack(">II", last, code))

    # -- receive side ------------------------------------------------------

    def feed(self, data: bytes) -> List[tuple]:
        self._buf += data
        events: List[tuple] = []
        if not self._preface_seen:
            if len(self._buf) < len(PREFACE):
                if PREFACE.startswith(bytes(self._buf)):
                    return events
                raise H2Error(E_PROTOCOL, "bad preface")
            if bytes(self._buf[:len(PREFACE)]) != PREFACE:
                raise H2Error(E_PROTOCOL, "bad preface")
            del self._buf[:len(PREFACE)]
            self._preface_seen = True
            self.start()
        while len(self._buf) >= 9:
            length = int.from_bytes(self._buf[0:3], "big")
            ftype = self._buf[3]
            flags = self._buf[4]
            sid = int.from_bytes(self._buf[5:9], "big") & 0x7FFFFFFF
            if length > (1 << 24) - 1 or length > 16 * 1024 * 1024:
                raise H2Error(E_PROTOCOL, "frame too large")
            if len(self._buf) < 9 + length:
                break
            payload = bytes(self._buf[9:9 + length])
            del self._buf[:9 + length]
            self._on_frame(ftype, flags, sid, payload, events)
        return events

    def _on_frame(self, ftype: int, flags: int, sid: int,
                  payload: bytes, events: List[tuple]) -> None:
        if self._hdr_accum is not None and ftype != F_CONTINUATION:
            raise H2Error(E_PROTOCOL, "expected CONTINUATION")
        if ftype == F_SETTINGS:
            self._on_settings(flags, payload)
        elif ftype == F_HEADERS:
            body = payload
            if flags & FLAG_PADDED:
                pad = body[0]
                body = body[1:len(body) - pad]
            if flags & FLAG_PRIORITY:
                body = body[5:]
            if flags & FLAG_END_HEADERS:
                self._emit_headers(sid, body, flags, events)
            else:
                self._hdr_accum = (sid, bytearray(body), flags)
        elif ftype == F_CONTINUATION:
            if self._hdr_accum is None or self._hdr_accum[0] != sid:
                raise H2Error(E_PROTOCOL, "stray CONTINUATION")
            self._hdr_accum[1].extend(payload)
            if flags & FLAG_END_HEADERS:
                _sid, block, hflags = self._hdr_accum
                self._hdr_accum = None
                self._emit_headers(_sid, bytes(block), hflags, events)
        elif ftype == F_DATA:
            body = payload
            if flags & FLAG_PADDED:
                pad = body[0]
                body = body[1:len(body) - pad]
            end = bool(flags & FLAG_END_STREAM)
            st = self._stream(sid)
            if end:
                st.closed_remote = True
            # replenish both windows right away (we buffer upstream)
            if len(payload):
                self._frame(F_WINDOW_UPDATE, 0, 0,
                            struct.pack(">I", len(payload)))
                if not end:
                    self._frame(F_WINDOW_UPDATE, 0, sid,
                                struct.pack(">I", len(payload)))
            events.append(("data", sid, body, end))
        elif ftype == F_WINDOW_UPDATE:
            (inc,) = struct.unpack(">I", payload[:4])
            inc &= 0x7FFFFFFF
            if sid == 0:
                self.conn_send_window += inc
                for st in list(self._streams.values()):
                    self._pump_stream(st)
            else:
                st = self._stream(sid)
                st.send_window += inc
                self._pump_stream(st)
        elif ftype == F_PING:
            if not (flags & FLAG_ACK):
                self._frame(F_PING, FLAG_ACK, 0, payload)
            events.append(("ping", payload))
        elif ftype == F_RST_STREAM:
            (code,) = struct.unpack(">I", payload[:4])
            self._streams.pop(sid, None)
            events.append(("rst", sid, code))
        elif ftype == F_GOAWAY:
            last, code = struct.unpack(">II", payload[:8])
            self.goaway_received = True
            events.append(("goaway", last, code, payload[8:]))
        # PRIORITY / PUSH_PROMISE / unknown: ignored

    def _emit_headers(self, sid: int, block: bytes, flags: int,
                      events: List[tuple]) -> None:
        try:
            headers = self._hp_dec.decode(block)
        except HpackError as e:
            raise H2Error(E_PROTOCOL, f"hpack: {e}")
        end = bool(flags & FLAG_END_STREAM)
        st = self._stream(sid)
        st.headers_done = True
        if end:
            st.closed_remote = True
        events.append(("headers", sid, headers, end))

    def _on_settings(self, flags: int, payload: bytes) -> None:
        if flags & FLAG_ACK:
            return
        for off in range(0, len(payload) - 5, 6):
            ident, value = struct.unpack_from(">HI", payload, off)
            if ident == S_INITIAL_WINDOW_SIZE:
                delta = value - self.peer_initial_window
                self.peer_initial_window = value
                for st in list(self._streams.values()):
                    st.send_window += delta
                    if delta > 0:
                        # RFC 7540 §6.9.2: the extra window is granted by
                        # the SETTINGS itself; no WINDOW_UPDATE will come
                        self._pump_stream(st)
            elif ident == S_MAX_FRAME_SIZE:
                self.max_frame_size = max(16384, min(value, 1 << 24))
            elif ident == S_HEADER_TABLE_SIZE:
                # the peer's DECODER table cap: our encoder must not
                # index beyond it (it may shrink, e.g. to 0)
                self._hp_enc.set_max_table_size(value)
        self._frame(F_SETTINGS, FLAG_ACK, 0)

    def close_stream(self, sid: int) -> None:
        """Forget a stream once its output is fully framed; a stream
        still holding window-blocked DATA/trailers stays registered so
        WINDOW_UPDATE can finish it."""
        st = self._streams.get(sid)
        if st is None:
            return
        if not st.pending and st.trailers is None:
            del self._streams[sid]
