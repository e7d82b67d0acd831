"""HPACK (RFC 7541) — header compression for HTTP/2.

Capability parity with brpc's src/brpc/details/hpack.cpp (881
LoC): integer/string primitives, indexed + literal representations,
dynamic table with eviction, Huffman coding both ways.  Fresh Python
design: the decoder drives a flat (bit_len, code)->symbol map instead
of a tree; the encoder Huffman-codes a string only when strictly
shorter, like the reference.

A copy of ``brpc_tpu/protocol/hpack.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .hpack_tables import HUFFMAN_CODES, STATIC_TABLE

DEFAULT_TABLE_SIZE = 4096
_EOS = 256

# (bit_len, code) -> symbol, for the linear decoder
_DECODE: Dict[Tuple[int, int], int] = {
    (blen, code): sym for sym, (code, blen) in enumerate(HUFFMAN_CODES)
}
_MIN_BITS = min(b for _, b in HUFFMAN_CODES)

# static table index helpers (1-based per the RFC)
_STATIC_BY_PAIR = {(n, v): i + 1 for i, (n, v) in enumerate(STATIC_TABLE)}
_STATIC_BY_NAME: Dict[str, int] = {}
for i, (n, _v) in enumerate(STATIC_TABLE):
    _STATIC_BY_NAME.setdefault(n, i + 1)


class HpackError(Exception):
    pass


# -- primitives ------------------------------------------------------------

def encode_int(value: int, prefix_bits: int, flags: int = 0) -> bytes:
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([flags | value])
    out = bytearray([flags | limit])
    value -= limit
    while value >= 128:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data: bytes, pos: int, prefix_bits: int) -> Tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    if pos >= len(data):
        raise HpackError("truncated integer")
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated varint")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not (b & 0x80):
            return value, pos
        if shift > 62:
            raise HpackError("varint overflow")


def huffman_encode(data: bytes) -> bytes:
    acc = 0
    nbits = 0
    out = bytearray()
    for byte in data:
        code, blen = HUFFMAN_CODES[byte]
        acc = (acc << blen) | code
        nbits += blen
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if nbits:
        # pad with the EOS prefix (all ones)
        pad = 8 - nbits
        out.append(((acc << pad) | ((1 << pad) - 1)) & 0xFF)
    return bytes(out)


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    acc = 0
    nbits = 0
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= _MIN_BITS:
            sym = None
            # try the shortest code first; codes are ≤ 30 bits
            for blen in range(_MIN_BITS, min(nbits, 30) + 1):
                code = (acc >> (nbits - blen)) & ((1 << blen) - 1)
                sym = _DECODE.get((blen, code))
                if sym is not None:
                    if sym == _EOS:
                        raise HpackError("EOS in huffman stream")
                    out.append(sym)
                    nbits -= blen
                    acc &= (1 << nbits) - 1
                    break
            if sym is None:
                break                  # need more bits
    # remaining bits must be an all-ones EOS prefix (≤ 7 bits)
    if nbits > 7 or (nbits and acc != (1 << nbits) - 1):
        raise HpackError("bad huffman padding")
    return bytes(out)


def _encode_string(s: bytes, huffman: bool = True) -> bytes:
    if huffman:
        h = huffman_encode(s)
        if len(h) < len(s):
            return encode_int(len(h), 7, 0x80) + h
    return encode_int(len(s), 7, 0x00) + s


def _decode_string(data: bytes, pos: int) -> Tuple[bytes, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    huff = bool(data[pos] & 0x80)
    length, pos = decode_int(data, pos, 7)
    raw = data[pos:pos + length]
    if len(raw) != length:
        raise HpackError("truncated string body")
    pos += length
    return (huffman_decode(raw) if huff else raw), pos


# -- dynamic table ---------------------------------------------------------

class _DynTable:
    def __init__(self, max_size: int = DEFAULT_TABLE_SIZE):
        self.entries: List[Tuple[str, str]] = []   # newest first
        self.size = 0
        self.max_size = max_size

    @staticmethod
    def _entry_size(name: str, value: str) -> int:
        return len(name) + len(value) + 32          # RFC 7541 §4.1

    def add(self, name: str, value: str) -> None:
        need = self._entry_size(name, value)
        while self.entries and self.size + need > self.max_size:
            en, ev = self.entries.pop()
            self.size -= self._entry_size(en, ev)
        if need <= self.max_size:
            self.entries.insert(0, (name, value))
            self.size += need

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        while self.entries and self.size > self.max_size:
            en, ev = self.entries.pop()
            self.size -= self._entry_size(en, ev)

    def get(self, index: int) -> Tuple[str, str]:
        """index is 1-based across static+dynamic (RFC §2.3.3)."""
        if 1 <= index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        di = index - len(STATIC_TABLE) - 1
        if 0 <= di < len(self.entries):
            return self.entries[di]
        raise HpackError(f"index {index} out of range")

    def find(self, name: str, value: str) -> Tuple[int, bool]:
        """(index, exact) — 0 when absent."""
        exact = _STATIC_BY_PAIR.get((name, value))
        if exact:
            return exact, True
        for i, (en, ev) in enumerate(self.entries):
            if en == name and ev == value:
                return len(STATIC_TABLE) + 1 + i, True
        ni = _STATIC_BY_NAME.get(name)
        if ni:
            return ni, False
        for i, (en, _ev) in enumerate(self.entries):
            if en == name:
                return len(STATIC_TABLE) + 1 + i, False
        return 0, False


# -- encoder / decoder -----------------------------------------------------

class Encoder:
    def __init__(self, max_table_size: int = DEFAULT_TABLE_SIZE):
        self._table = _DynTable(max_table_size)
        self._pending_resize: Optional[int] = None

    def set_max_table_size(self, size: int) -> None:
        """Peer-imposed decoder cap (SETTINGS_HEADER_TABLE_SIZE): resize
        our table and signal the change in the next header block
        (RFC 7541 §4.2 dynamic table size update)."""
        size = min(size, DEFAULT_TABLE_SIZE)
        if size != self._table.max_size:
            self._table.resize(size)
            self._pending_resize = size

    def encode(self, headers: List[Tuple[str, str]]) -> bytes:
        out = bytearray()
        if self._pending_resize is not None:
            out += encode_int(self._pending_resize, 5, 0x20)
            self._pending_resize = None
        for name, value in headers:
            name = name.lower()
            idx, exact = self._table.find(name, value)
            if exact:
                out += encode_int(idx, 7, 0x80)          # indexed
                continue
            sensitive = name in ("authorization", "cookie", "set-cookie")
            if sensitive:
                # literal, never indexed
                out += encode_int(idx if idx else 0, 4, 0x10)
            else:
                # literal with incremental indexing
                out += encode_int(idx if idx else 0, 6, 0x40)
                self._table.add(name, value)
            if not idx:
                out += _encode_string(name.encode("latin1"))
            out += _encode_string(value.encode("latin1"))
        return bytes(out)


class Decoder:
    def __init__(self, max_table_size: int = DEFAULT_TABLE_SIZE):
        self._table = _DynTable(max_table_size)

    def decode(self, data: bytes) -> List[Tuple[str, str]]:
        headers: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:                                  # indexed
                idx, pos = decode_int(data, pos, 7)
                if idx == 0:
                    raise HpackError("indexed 0")
                headers.append(self._table.get(idx))
            elif b & 0x40:                                # literal + index
                idx, pos = decode_int(data, pos, 6)
                name, value, pos = self._literal(data, pos, idx)
                self._table.add(name, value)
                headers.append((name, value))
            elif b & 0x20:                                # table resize
                size, pos = decode_int(data, pos, 5)
                self._table.resize(size)
            else:                                         # literal no index
                idx, pos = decode_int(data, pos, 4)
                name, value, pos = self._literal(data, pos, idx)
                headers.append((name, value))
        return headers

    def _literal(self, data: bytes, pos: int, idx: int):
        if idx:
            name = self._table.get(idx)[0]
        else:
            raw, pos = _decode_string(data, pos)
            name = raw.decode("latin1")
        rawv, pos = _decode_string(data, pos)
        return name, rawv.decode("latin1"), pos
