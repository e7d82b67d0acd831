"""rpc_dump — sampled capture of server traffic, replayable bytes.

A copy of ``brpc_tpu/tools/rpc_dump.py`` (≈ brpc's
src/brpc/rpc_dump.h:50-69, SampledRequest and the rpc_dump_* gflags):
when enabled, the server appends a budgeted sample of incoming requests
to a dump file as RAW tpu_std frames — the dump IS wire format, so the
replayer just sends it back out, and a file either package writes is
read frame for frame by the other's :class:`DumpReader`.  The hook is
``server/rpc_dispatch.process_rpc_request`` (the classic lane, both
transports); while the switch is on, ``transport/native_bridge.py``
turns every live engine's native dispatch off, so the engine hands
every request to that lane (its ``rpc_dispatch_off`` fallback row
counts them).  :func:`maybe_dump_request` takes the payload and the
attachment apart, since the port's cut frame holds them apart, and
writes them back to back as the frame carried them.

Flags (live-settable via /flags):
  rpc_dump                      master switch (default off)
  rpc_dump_dir                  directory for dump files
  rpc_dump_max_requests_per_second   sampling budget
  rpc_dump_max_file_mb          rotate/stop cap per file
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Iterator, Optional, Tuple

from ..butil.flags import define_flag, get_flag
from ..butil.logging_util import LOG
from ..protocol.meta import RpcMeta

define_flag("rpc_dump", False, "capture sampled requests to disk",
            lambda v: True)
define_flag("rpc_dump_dir", "./rpc_dump", "dump file directory",
            lambda v: bool(str(v)))
define_flag("rpc_dump_max_requests_per_second", 1000,
            "dump sampling budget", lambda v: int(v) >= 0)
define_flag("rpc_dump_max_file_mb", 256, "per-file size cap",
            lambda v: int(v) > 0)

_lock = threading.Lock()
_file = None
_file_bytes = 0
_window = [0.0, 0]      # window start, taken


def dump_enabled() -> bool:
    return bool(get_flag("rpc_dump", False))


def _open_file():
    global _file, _file_bytes
    d = str(get_flag("rpc_dump_dir", "./rpc_dump"))
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"requests.{os.getpid()}.{int(time.time())}.dump")
    _file = open(path, "ab")
    _file_bytes = 0
    LOG.info("rpc_dump capturing to %s", path)


def maybe_dump_request(meta: RpcMeta, payload_bytes: bytes,
                       attachment: bytes = b"") -> None:
    """Called per request when the switch is on: budgeted sampling, then
    append the frame (re-encoded meta + payload+attachment bytes)."""
    global _file_bytes
    now = time.monotonic()
    with _lock:
        if now - _window[0] >= 1.0:
            _window[0] = now
            _window[1] = 0
        if _window[1] >= int(get_flag("rpc_dump_max_requests_per_second",
                                      1000)):
            return
        _window[1] += 1
        if _file is None:
            try:
                _open_file()
            except OSError as e:
                LOG.warning("rpc_dump cannot open file: %s", e)
                return
        cap = int(get_flag("rpc_dump_max_file_mb", 256)) << 20
        if _file_bytes >= cap:
            return
        mb = meta.encode()
        body = len(mb) + len(payload_bytes) + len(attachment)
        frame = (b"TRPC" + struct.pack("<II", body, len(mb)) + mb
                 + payload_bytes + attachment)
        try:
            _file.write(frame)
            _file.flush()
            _file_bytes += len(frame)
        except OSError as e:
            LOG.warning("rpc_dump write failed: %s", e)


def close_dump() -> Optional[str]:
    """Close the current dump file (tests / rotation); returns its path."""
    global _file
    with _lock:
        if _file is None:
            return None
        path = _file.name
        _file.close()
        _file = None
        return path


class DumpReader:
    """Iterate (meta, payload_bytes) frames out of a dump file."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[Tuple[RpcMeta, bytes]]:
        with open(self.path, "rb") as f:
            data = f.read()
        off = 0
        while off + 12 <= len(data):
            if data[off:off + 4] != b"TRPC":
                raise ValueError(f"bad magic at offset {off}")
            body, msize = struct.unpack_from("<II", data, off + 4)
            frame_end = off + 12 + body
            if frame_end > len(data):
                break                     # truncated tail (partial write)
            meta = RpcMeta.decode(data[off + 12:off + 12 + msize])
            if meta is None:
                raise ValueError(f"bad meta at offset {off}")
            yield meta, data[off + 12 + msize:frame_end]
            off = frame_end

    def frames(self):
        return list(self)
