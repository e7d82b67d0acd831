"""CRC32-C (Castagnoli) — protocol checksums & consistent hashing input
(≈ brpc's src/butil/crc32c.cc, which uses SSE4.2; bulk payload
checksumming on the card is ``ops.device_ops.checksum_u32``).

Table-driven implementation, polynomial 0x1EDC6F41 (reflected 0x82F63B78).

A copy of ``brpc_tpu/butil/crc32c.py``.
"""

from __future__ import annotations

_POLY = 0x82F63B78


def _make_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()


def crc32c_extend(crc: int, data) -> int:
    """Extend a running crc with data (matches the standard CRC32C)."""
    c = crc ^ 0xFFFFFFFF
    tbl = _TABLE
    for b in bytes(data):
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c(data) -> int:
    return crc32c_extend(0, data)


# murmurhash-style 64-bit mix used by consistent hashing when a fast
# non-crypto hash is wanted (≈ third_party/murmurhash3 usage in hasher.cpp)
def fmix64(k: int) -> int:
    mask = (1 << 64) - 1
    k &= mask
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & mask
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & mask
    k ^= k >> 33
    return k


def hash_bytes64(data: bytes, seed: int = 0) -> int:
    """64-bit hash of bytes built from fmix64 over 8-byte words."""
    h = seed ^ (len(data) << 1)
    for i in range(0, len(data), 8):
        word = int.from_bytes(data[i : i + 8], "little")
        h = fmix64(h ^ word)
    return fmix64(h)
