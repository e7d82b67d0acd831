"""Thrift framed transport + binary-protocol message layer.

The port of ``brpc_tpu/protocol/thrift_proto.py`` (brpc's
``policy/thrift_protocol.cpp`` and ``thrift_message.h``):
CALL/REPLY/EXCEPTION envelopes over the framed transport, seqid
matching, serving on the one port next to every other protocol (a
service added as ``"thrift"``, an object with ``handle(method, body)``;
a call runs on a fiber of its own unless it ends its gulp).  Struct payloads stay opaque bytes — apps bring their
own generated codecs (the reference links real thrift for the same
reason); :class:`TBinary` covers the primitive read/writes tests and
simple handlers need.

Wire: [u32 frame_len][0x8001 version | message_type][name][seqid][body]

The code is the JAX module's, the replies written as ``bytes``; nothing
is cut.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

from ..butil.logging_util import LOG
from .base import (ParseResult, Protocol, ProtocolType, max_body_size,
                   register_protocol)

VERSION_1 = 0x80010000
M_CALL = 1
M_REPLY = 2
M_EXCEPTION = 3
M_ONEWAY = 4

# TApplicationException codes
EX_UNKNOWN_METHOD = 1
EX_INTERNAL_ERROR = 6


class TBinary:
    """Minimal TBinaryProtocol writer/reader for primitives + the
    TApplicationException struct."""

    @staticmethod
    def write_string(b: bytes) -> bytes:
        return struct.pack(">i", len(b)) + b

    @staticmethod
    def read_string(data: bytes, off: int) -> Tuple[bytes, int]:
        (n,) = struct.unpack_from(">i", data, off)
        off += 4
        return data[off:off + n], off + n

    @staticmethod
    def write_field(ftype: int, fid: int, payload: bytes) -> bytes:
        return struct.pack(">bh", ftype, fid) + payload

    STOP = b"\x00"

    @staticmethod
    def app_exception(code: int, message: str) -> bytes:
        """TApplicationException struct: 1:string message, 2:i32 type."""
        msg = message.encode()
        return (TBinary.write_field(11, 1, TBinary.write_string(msg))
                + TBinary.write_field(8, 2, struct.pack(">i", code))
                + TBinary.STOP)

    @staticmethod
    def read_app_exception(data: bytes) -> Tuple[int, str]:
        off, code, msg = 0, 0, ""
        while off < len(data):
            ftype = data[off]
            if ftype == 0:
                break
            (fid,) = struct.unpack_from(">h", data, off + 1)
            off += 3
            if ftype == 11:
                raw, off = TBinary.read_string(data, off)
                if fid == 1:
                    msg = raw.decode("utf-8", "replace")
            elif ftype == 8:
                (v,) = struct.unpack_from(">i", data, off)
                off += 4
                if fid == 2:
                    code = v
            else:
                break
        return code, msg


def pack_message(mtype: int, name: str, seqid: int, body: bytes) -> bytes:
    inner = (struct.pack(">I", VERSION_1 | mtype)
             + TBinary.write_string(name.encode())
             + struct.pack(">i", seqid) + body)
    return struct.pack(">I", len(inner)) + inner


def unpack_message(frame: bytes) -> Tuple[int, str, int, bytes]:
    (verty,) = struct.unpack_from(">I", frame, 0)
    if verty & 0xFFFF0000 != VERSION_1:
        raise ValueError("bad thrift version")
    mtype = verty & 0xFF
    name, off = TBinary.read_string(frame, 4)
    (seqid,) = struct.unpack_from(">i", frame, off)
    return mtype, name.decode("utf-8", "replace"), seqid, frame[off + 4:]


class ThriftMessage:
    __slots__ = ("mtype", "method", "seqid", "body")

    def __init__(self, mtype: int, method: str, seqid: int, body: bytes):
        self.mtype = mtype
        self.method = method
        self.seqid = seqid
        self.body = body


def parse(source, sock, read_eof: bool, arg) -> ParseResult:
    avail = len(source)
    if avail < 8:
        head = source.fetch(min(8, avail))
        # prefix check: [len>0 with high byte 0][0x80 0x01 ...]
        if len(head) >= 1 and head[0] != 0:
            return ParseResult.try_others()
        if len(head) >= 5 and head[4] != 0x80:
            return ParseResult.try_others()
        if len(head) >= 6 and head[5] != 0x01:
            return ParseResult.try_others()
        return ParseResult.not_enough_data()
    head = source.fetch(8)
    (flen,) = struct.unpack_from(">I", head, 0)
    if head[4] != 0x80 or head[5] != 0x01:
        return ParseResult.try_others()
    if flen > max_body_size():
        return ParseResult.too_big()
    if avail < 4 + flen:
        return ParseResult.not_enough_data()
    source.pop_front(4)
    frame = source.cutn(flen).to_bytes()
    try:
        mtype, method, seqid, body = unpack_message(frame)
    except (ValueError, struct.error):
        return ParseResult.absolutely_wrong()
    return ParseResult.make_message(ThriftMessage(mtype, method, seqid,
                                                  body))


def _process_request(msg: ThriftMessage, sock, server) -> None:
    svc = server.services.get("thrift")
    if svc is None or msg.mtype not in (M_CALL, M_ONEWAY):
        sock.write(pack_message(
            M_EXCEPTION, msg.method, msg.seqid,
            TBinary.app_exception(EX_UNKNOWN_METHOD,
                                  "no thrift service registered")))
        return
    try:
        reply = svc.handle(msg.method, msg.body)
    except KeyError:
        if msg.mtype != M_ONEWAY:
            sock.write(pack_message(
                M_EXCEPTION, msg.method, msg.seqid,
                TBinary.app_exception(EX_UNKNOWN_METHOD,
                                      f"unknown method {msg.method}")))
        return
    except Exception as e:      # noqa: BLE001 — must answer
        LOG.exception("thrift method %s raised", msg.method)
        if msg.mtype != M_ONEWAY:
            sock.write(pack_message(
                M_EXCEPTION, msg.method, msg.seqid,
                TBinary.app_exception(EX_INTERNAL_ERROR,
                                      f"{type(e).__name__}: {e}")))
        return
    if msg.mtype != M_ONEWAY:
        sock.write(pack_message(M_REPLY, msg.method, msg.seqid,
                                reply or TBinary.STOP))


THRIFT = Protocol(
    ProtocolType.THRIFT, "thrift", parse,
    process_request=_process_request,
)
register_protocol(THRIFT)


class ThriftClient:
    """Framed-binary thrift client: call(method, body_bytes) ->
    reply body bytes; raises ThriftApplicationError on EXCEPTION."""

    def __init__(self, addr, timeout_s: float = 2.0):
        import socket as _socket

        from ..butil.endpoint import EndPoint, parse_endpoint
        self._remote = addr if isinstance(addr, EndPoint) \
            else parse_endpoint(str(addr))
        self._timeout_s = timeout_s
        self._sock = None
        self._seq = 0
        import threading
        self._lock = threading.Lock()

    def _ensure(self):
        if self._sock is None:
            import socket as _socket
            s = _socket.create_connection(self._remote.to_sockaddr(),
                                          timeout=self._timeout_s)
            s.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            self._sock = s

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def _read_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self._sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("thrift server closed the connection")
            out += chunk
        return out

    def call(self, method: str, body: bytes = b"\x00",
             oneway: bool = False) -> Optional[bytes]:
        with self._lock:
            self._ensure()
            self._seq += 1
            seq = self._seq
            mtype = M_ONEWAY if oneway else M_CALL
            self._sock.sendall(pack_message(mtype, method, seq, body))
            if oneway:
                return None
            (flen,) = struct.unpack(">I", self._read_exact(4))
            frame = self._read_exact(flen)
        mtype, name, seqid, rbody = unpack_message(frame)
        if seqid != seq:
            raise ConnectionError(f"seqid mismatch {seqid} != {seq}")
        if mtype == M_EXCEPTION:
            code, msg = TBinary.read_app_exception(rbody)
            raise ThriftApplicationError(code, msg)
        return rbody


class ThriftApplicationError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.message = message
