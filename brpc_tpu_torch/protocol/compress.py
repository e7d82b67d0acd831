"""Compression registry (≈ brpc's src/brpc/compress.h and
policy/gzip_compress.cpp): CompressType → {compress, decompress} handlers,
applied to the RPC payload (never the meta). Snappy is registered only if
the optional python-snappy is importable.

A copy of ``brpc_tpu/protocol/compress.py``.
"""

from __future__ import annotations

import gzip as _gzip
import zlib as _zlib
from typing import Callable, Dict, Optional, Tuple

from .meta import CompressType

_handlers: Dict[int, Tuple[Callable[[bytes], bytes],
                           Callable[[bytes], bytes]]] = {}


def register_compress(ctype: int, compress: Callable[[bytes], bytes],
                      decompress: Callable[[bytes], bytes]) -> None:
    _handlers[ctype] = (compress, decompress)


def compress(data: bytes, ctype: int) -> Optional[bytes]:
    if ctype == CompressType.NONE:
        return data
    h = _handlers.get(ctype)
    return h[0](data) if h else None


def decompress(data: bytes, ctype: int) -> Optional[bytes]:
    if ctype == CompressType.NONE:
        return data
    h = _handlers.get(ctype)
    return h[1](data) if h else None


def supported(ctype: int) -> bool:
    return ctype == CompressType.NONE or ctype in _handlers


register_compress(CompressType.GZIP,
                  lambda d: _gzip.compress(d, compresslevel=6),
                  _gzip.decompress)
register_compress(CompressType.ZLIB, _zlib.compress, _zlib.decompress)

try:                                    # optional dependency
    import snappy as _snappy            # type: ignore

    register_compress(CompressType.SNAPPY, _snappy.compress,
                      _snappy.decompress)
except ImportError:
    pass
