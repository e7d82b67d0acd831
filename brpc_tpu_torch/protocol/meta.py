"""RpcMeta — the framed-RPC meta block and its wire codec.

A copy of ``brpc_tpu/protocol/meta.py``: the same tag-length-value
registry (tags 1-23), encoded in the same order, so the port and the JAX
package read each other's frames byte for byte.  Unknown tags are skipped
(forward compatibility).  Each field is one byte of tag, a little-endian
u32 length and the value.  The shm data plane appends its TLVs (18-21)
pre-encoded after the encoded fields, as the JAX package does
(:func:`encode_tlv`, ``tpu_std.pack_frame``'s ``extra_meta``).
"""

from __future__ import annotations

import struct
from typing import Optional

# field tags (u8); the registry must stay equal to the JAX package's
_T_CORRELATION = 1      # u64
_T_COMPRESS = 2         # u8
_T_ATTACHMENT = 3       # u32 size of attachment tail within payload
_T_SERVICE = 4          # utf-8
_T_METHOD = 5           # utf-8
_T_ERROR_CODE = 6       # i32
_T_ERROR_TEXT = 7       # utf-8
_T_AUTH = 8             # bytes
_T_TRACE_ID = 9         # u64
_T_SPAN_ID = 10         # u64
_T_PARENT_SPAN = 11     # u64
_T_STREAM_ID = 12       # u64 (streaming rpc settlement)
_T_TIMEOUT_MS = 13      # u32 remaining-deadline propagation
_T_STREAM_WINDOW = 14   # u32 receiver buffer size (stream handshake)
_T_ICI_DOMAIN = 15      # bytes: sender's device-fabric domain id
_T_ICI_DESC = 16        # bytes: device attachment descriptor
_T_ICI_CONN = 17        # bytes: initiator's connection nonce
_T_SHM_OFFER = 18       # bytes: sender's shm ring spec (capability offer)
_T_SHM_ACCEPT = 19      # bytes: ring id the sender has mapped (confirm)
_T_SHM_RELEASE = 20     # bytes: slot credits returned to the ring owner
_T_SHM_DESC = 21        # bytes: (ring_id, slot, offset, len)
_T_TENANT = 22          # utf-8: caller's tenant identity
_T_LAME_DUCK = 23       # u8: response-side drain signal


# the shm data plane's tags, for pre-encoded TLVs (transport/shm_ring.py)
TAG_SHM_OFFER = _T_SHM_OFFER
TAG_SHM_ACCEPT = _T_SHM_ACCEPT
TAG_SHM_RELEASE = _T_SHM_RELEASE
TAG_SHM_DESC = _T_SHM_DESC
# the native lanes' tags and pre-encoded TLV prefixes (the raw lane's
# flat response meta, the stream grant, the domain answer)
TAG_STREAM_ID = _T_STREAM_ID
TAG_STREAM_WINDOW = _T_STREAM_WINDOW
TAG_ICI_DOMAIN = _T_ICI_DOMAIN
TLV_CORRELATION = b"\x01\x08\x00\x00\x00"   # _T_CORRELATION, u64 follows
TLV_ATTACHMENT = b"\x03\x04\x00\x00\x00"    # _T_ATTACHMENT, u32 follows
TLV_TIMEOUT = b"\x0d\x04\x00\x00\x00"       # _T_TIMEOUT_MS, u32 follows
TLV_TRACE = b"\x09\x08\x00\x00\x00"         # _T_TRACE_ID, u64 follows
TLV_SPAN = b"\x0a\x08\x00\x00\x00"          # _T_SPAN_ID, u64 follows
# the client fast lane's request tags (client/fast_call.py builds its
# frames from cached TLV bytes, as the JAX lane does)
TAG_SERVICE = _T_SERVICE
TAG_METHOD = _T_METHOD
TAG_AUTH = _T_AUTH
TAG_ICI_DESC = _T_ICI_DESC
TAG_ICI_CONN = _T_ICI_CONN
TAG_TENANT = _T_TENANT
# the drain signal: a response meta's complete TLV (tag 23, length 1,
# value 1; nothing variable follows, so not a 5-byte TLV_* prefix), as
# RpcMeta.encode writes it and native/src/engine.cpp's kDuckTlv splices it
TAG_LAME_DUCK = _T_LAME_DUCK
LAME_DUCK_TLV = b"\x17\x01\x00\x00\x00\x01"


def encode_tlv(tag: int, data: bytes) -> bytes:
    """One field as wire bytes (the JAX package's pre-encoded form)."""
    return bytes([tag]) + struct.pack("<I", len(data)) + data


class CompressType:
    NONE = 0
    GZIP = 1
    ZLIB = 2
    SNAPPY = 3


class RpcMeta:
    __slots__ = ("correlation_id", "compress_type", "attachment_size",
                 "service_name", "method_name", "error_code", "error_text",
                 "auth_data", "trace_id", "span_id", "parent_span_id",
                 "stream_id", "timeout_ms", "stream_window",
                 "ici_domain", "ici_desc", "ici_conn", "timeout_present",
                 "shm_offer", "shm_accept", "shm_release", "shm_desc",
                 "tenant", "lame_duck")

    def __init__(self):
        self.correlation_id = 0
        self.compress_type = CompressType.NONE
        self.attachment_size = 0
        self.service_name = ""
        self.method_name = ""
        self.error_code = 0
        self.error_text = ""
        self.auth_data = b""
        self.trace_id = 0
        self.span_id = 0
        self.parent_span_id = 0
        self.stream_id = 0
        self.timeout_ms = 0
        # decode-side: tag 13 was on the wire (clients stamp ≥ 1, so a
        # crafted explicit 0 means expired-at-arrival — distinguishable
        # from an absent deadline, which also reads timeout_ms == 0)
        self.timeout_present = False
        self.stream_window = 0
        self.ici_domain = b""
        self.ici_desc = b""
        self.ici_conn = b""
        self.shm_offer = b""
        self.shm_accept = b""
        self.shm_release = b""
        self.shm_desc = b""
        self.tenant = b""
        self.lame_duck = 0

    @property
    def is_request(self) -> bool:
        return bool(self.method_name)

    # -- codec -------------------------------------------------------------

    def encode(self) -> bytes:
        out = bytearray()

        def put(tag: int, data: bytes) -> None:
            out.append(tag)
            out.extend(struct.pack("<I", len(data)))
            out.extend(data)

        if self.correlation_id:
            put(_T_CORRELATION, struct.pack("<Q", self.correlation_id))
        if self.compress_type:
            put(_T_COMPRESS, bytes([self.compress_type]))
        if self.attachment_size:
            put(_T_ATTACHMENT, struct.pack("<I", self.attachment_size))
        if self.service_name:
            put(_T_SERVICE, self.service_name.encode())
        if self.method_name:
            put(_T_METHOD, self.method_name.encode())
        if self.error_code:
            put(_T_ERROR_CODE, struct.pack("<i", self.error_code))
        if self.error_text:
            put(_T_ERROR_TEXT, self.error_text.encode())
        if self.auth_data:
            put(_T_AUTH, self.auth_data)
        if self.trace_id:
            put(_T_TRACE_ID, struct.pack("<Q", self.trace_id))
        if self.span_id:
            put(_T_SPAN_ID, struct.pack("<Q", self.span_id))
        if self.parent_span_id:
            put(_T_PARENT_SPAN, struct.pack("<Q", self.parent_span_id))
        if self.stream_id:
            put(_T_STREAM_ID, struct.pack("<Q", self.stream_id))
        if self.timeout_ms:
            put(_T_TIMEOUT_MS, struct.pack("<I", self.timeout_ms))
        if self.stream_window:
            put(_T_STREAM_WINDOW, struct.pack("<I", self.stream_window))
        if self.ici_domain:
            put(_T_ICI_DOMAIN, self.ici_domain)
        if self.ici_desc:
            put(_T_ICI_DESC, self.ici_desc)
        if self.ici_conn:
            put(_T_ICI_CONN, self.ici_conn)
        if self.shm_offer:
            put(_T_SHM_OFFER, self.shm_offer)
        if self.shm_accept:
            put(_T_SHM_ACCEPT, self.shm_accept)
        if self.shm_release:
            put(_T_SHM_RELEASE, self.shm_release)
        if self.shm_desc:
            put(_T_SHM_DESC, self.shm_desc)
        if self.tenant:
            put(_T_TENANT, self.tenant)
        if self.lame_duck:
            out.extend(LAME_DUCK_TLV)
        return bytes(out)

    @staticmethod
    def decode(data: bytes) -> Optional["RpcMeta"]:
        m = RpcMeta()
        off, end = 0, len(data)
        try:
            while off < end:
                tag = data[off]
                (ln,) = struct.unpack_from("<I", data, off + 1)
                off += 5
                field = data[off:off + ln]
                if len(field) != ln:
                    return None
                off += ln
                if tag == _T_CORRELATION:
                    (m.correlation_id,) = struct.unpack("<Q", field)
                elif tag == _T_COMPRESS:
                    m.compress_type = field[0]
                elif tag == _T_ATTACHMENT:
                    (m.attachment_size,) = struct.unpack("<I", field)
                elif tag == _T_SERVICE:
                    m.service_name = field.decode()
                elif tag == _T_METHOD:
                    m.method_name = field.decode()
                elif tag == _T_ERROR_CODE:
                    (m.error_code,) = struct.unpack("<i", field)
                elif tag == _T_ERROR_TEXT:
                    m.error_text = field.decode()
                elif tag == _T_AUTH:
                    m.auth_data = field
                elif tag == _T_TRACE_ID:
                    (m.trace_id,) = struct.unpack("<Q", field)
                elif tag == _T_SPAN_ID:
                    (m.span_id,) = struct.unpack("<Q", field)
                elif tag == _T_PARENT_SPAN:
                    (m.parent_span_id,) = struct.unpack("<Q", field)
                elif tag == _T_STREAM_ID:
                    (m.stream_id,) = struct.unpack("<Q", field)
                elif tag == _T_TIMEOUT_MS:
                    (m.timeout_ms,) = struct.unpack("<I", field)
                    m.timeout_present = True
                elif tag == _T_STREAM_WINDOW:
                    (m.stream_window,) = struct.unpack("<I", field)
                elif tag == _T_ICI_DOMAIN:
                    m.ici_domain = field
                elif tag == _T_ICI_DESC:
                    m.ici_desc = field
                elif tag == _T_ICI_CONN:
                    m.ici_conn = field
                elif tag == _T_SHM_OFFER:
                    m.shm_offer = field
                elif tag == _T_SHM_ACCEPT:
                    m.shm_accept = field
                elif tag == _T_SHM_RELEASE:
                    m.shm_release = field
                elif tag == _T_SHM_DESC:
                    m.shm_desc = field
                elif tag == _T_TENANT:
                    m.tenant = field
                elif tag == _T_LAME_DUCK:
                    m.lame_duck = field[0] if field else 1
                # unknown tags are skipped: forward compatibility
        except (struct.error, IndexError, UnicodeDecodeError):
            return None
        return m
