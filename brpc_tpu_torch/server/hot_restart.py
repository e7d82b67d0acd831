"""Hot restart — listener fd passing over a unix socket.

The port's copy of ``brpc_tpu/server/hot_restart.py``, nothing cut: the
wire shape is the JAX one, so a handoff written by either package is
imported by the other's :func:`import_listeners`.

The second half of the operability plane (the first is graceful drain,
server.py): a binary swap must not drop the kernel listen queue or
refuse a single connect.  The OLD process exports its bound listening
sockets over a unix domain socket (``SCM_RIGHTS`` — the nginx
``USR2``/fd-inheritance discipline, done explicitly so the successor
can be a freshly exec'd binary rather than a fork child); the NEW
process imports them and serves from the SAME kernel sockets:
connections sitting in the listen queue during the swap are accepted
by the successor as if nothing happened.

Two mechanisms compose for zero-failed-request restarts:

1. **SO_REUSEPORT overlap start** — with the engine's sharded
   listeners the successor may simply bind the same port while the
   predecessor drains: the kernel splits new accepts between them, and
   the predecessor's lame-duck signal steers clients over.
2. **fd passing (this module)** — exact listen-queue preservation:
   the predecessor's fds (primary + SO_REUSEPORT shards) move to the
   successor; the predecessor then drains its ESTABLISHED connections
   to completion and exits.

The predecessor and the successor hold two descriptors of one open
listening socket (in one process, as the tests run them, both on the
same event dispatcher).  So the predecessor's ``stop`` takes its
descriptor off the dispatcher (or the engine's loops) and closes it
without ``shutdown``: a shutdown would end the listen of the shared
socket, and an epoll registration left behind would outlive the
descriptor number, which a new socket may take.

Wire shape on the handoff socket: ``b"TPUHR1" + u32 meta_len + meta``
(JSON: the per-fd ``(host, port)`` list) with every fd in one
``SCM_RIGHTS`` ancillary block on the first sendmsg.
"""

from __future__ import annotations

import array
import json
import os
import socket
import struct
from typing import List, Optional, Tuple

from ..butil.logging_util import LOG

MAGIC = b"TPUHR1"
_MAX_FDS = 64


def send_listener_fds(conn: socket.socket, socks: List) -> None:
    """Ship ``socks``' fds (+ their bound addresses as metadata) over
    an accepted handoff connection."""
    addrs = []
    for s in socks:
        name = s.getsockname()
        addrs.append([name[0], name[1]])
    meta = json.dumps({"addrs": addrs}).encode()
    fds = array.array("i", [s.fileno() for s in socks])
    conn.sendmsg([MAGIC + struct.pack("<I", len(meta)) + meta],
                 [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                   fds.tobytes())])


def recv_listener_fds(conn: socket.socket
                      ) -> List[Tuple[socket.socket, str, int]]:
    """Receive the handoff: returns ``[(sock, host, port), ...]`` —
    each ``sock`` is a live ``socket.socket`` wrapping an inherited,
    already-bound-and-listening fd."""
    fds: List[int] = []
    # ancillary data rides the FIRST datagram of the stream
    data, ancdata, _flags, _addr = conn.recvmsg(
        65536, socket.CMSG_LEN(_MAX_FDS * 4))
    for cmsg_level, cmsg_type, cmsg_data in ancdata:
        if cmsg_level == socket.SOL_SOCKET \
                and cmsg_type == socket.SCM_RIGHTS:
            arr = array.array("i")
            arr.frombytes(cmsg_data[:len(cmsg_data)
                                    - len(cmsg_data) % 4])
            fds.extend(arr)
    if not data.startswith(MAGIC) or len(data) < len(MAGIC) + 4:
        for fd in fds:
            os.close(fd)
        raise ValueError("bad hot-restart handoff header")
    (mlen,) = struct.unpack_from("<I", data, len(MAGIC))
    body = data[len(MAGIC) + 4:]
    while len(body) < mlen:
        chunk = conn.recv(65536)  # bounded by settimeout  # static-check: allow
        if not chunk:
            break
        body += chunk
    try:
        meta = json.loads(body[:mlen].decode())
        addrs = meta["addrs"]
    except (ValueError, KeyError):
        for fd in fds:
            os.close(fd)
        raise ValueError("bad hot-restart handoff metadata") from None
    if len(addrs) != len(fds):
        for fd in fds:
            os.close(fd)
        raise ValueError(
            f"hot-restart handoff mismatch: {len(addrs)} addrs vs "
            f"{len(fds)} fds")
    out = []
    for fd, (host, port) in zip(fds, addrs):
        out.append((socket.socket(fileno=fd), host, int(port)))
    return out


def handoff_listeners(path: str, socks: List,
                      timeout_s: float = 30.0) -> int:
    """Predecessor side: serve ONE handoff request at unix-socket
    ``path`` (bounded by ``timeout_s``), shipping every listener fd to
    whoever connects.  Returns 0 on success, -1 on timeout/error.
    Typically run on its own thread while the server keeps serving;
    afterwards the caller drains and stops."""
    if not socks:
        return -1
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(path)
        srv.listen(1)
        srv.settimeout(timeout_s)
        conn, _ = srv.accept()    # bounded by settimeout  # static-check: allow
        try:
            conn.settimeout(timeout_s)
            send_listener_fds(conn, socks)
        finally:
            conn.close()
        return 0
    except (OSError, socket.timeout) as e:
        LOG.warning("hot-restart handoff at %s failed: %s", path, e)
        return -1
    finally:
        srv.close()
        try:
            os.unlink(path)
        except OSError:
            pass


def import_listeners(path: str, timeout_s: float = 10.0
                     ) -> List[Tuple[socket.socket, str, int]]:
    """Successor side: connect to the predecessor's handoff socket and
    take over its listeners.  Raises OSError/ValueError on failure —
    the caller decides whether to fall back to a fresh bind."""
    cli = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    cli.settimeout(timeout_s)
    try:
        cli.connect(path)         # bounded by settimeout  # static-check: allow
        return recv_listener_fds(cli)
    finally:
        cli.close()
