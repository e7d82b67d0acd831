"""Socket -- one connection's identity and write path, shared by the
port's Server and Channel.

The slim core of ``brpc_tpu/transport/socket.py`` for blocking sockets:
a process-unique id with a registry (:meth:`Socket.address`), the
addresses of both ends, the device-attachment lane's per-connection state
(``ici_endpoint``, ``ici_peer_domain``, ``ici_conn_token``), the shm data
plane's negotiation state (``shm``, a ``shm_ring.ShmSockState``), one write
lock, the ack queue of TICI credit returns, and the streams bound to the
connection (``stream_map``: closing the connection closes them).  Reading
stays with the owner (the server's connection thread; the channel's call,
or its reader thread once the connection carries a stream).  An HTTP/1.x
or h2 connection's reader is ``transport/input_messenger.py``, whose
state rides here as in the JAX package: ``read_portal`` (the bytes read
and not yet cut), ``last_protocol``, ``h2_conn`` (the h2 session),
``tag`` (``"internal"`` on a server's internal port) and
:meth:`set_failed`.  :func:`socket_pool` lists the live sockets for the
``/sockets`` page.  ``conn`` may be an ``ssl.SSLSocket`` (TLS at either
end); ``app_data`` holds the server's per-connection auth verdict.

A connection of the native engine has no Python socket: its
``NativeSocket`` (``transport/native_bridge.py``) passes ``conn=None``
with both addresses and fills the three hooks that touch the connection
(:meth:`_send`, :meth:`_shutdown`, :meth:`_close_conn`), so controllers,
streams and device-attachment acks address it through the same registry.

Acks.  :meth:`queue_ack` queues descriptor ids.  While ``defer_acks`` is
set (a server between reading a request and writing its response) they
ride in front of the next frame written, so a request descriptor's ack
always precedes its response on the wire.  Otherwise they are written at
once, unless another thread holds the write lock, in which case that
writer sends them when it is done.  Queuing never blocks, so it is safe
from a finalizer.
"""

from __future__ import annotations

import itertools
import socket
import threading
from typing import Dict, List, Optional

from ..butil.endpoint import EndPoint
from ..butil.iobuf import IOBuf
from ..protocol.tpu_std import pack_ack_frame

_registry: Dict[int, "Socket"] = {}
_registry_lock = threading.Lock()
_ids = itertools.count(1)


def _endpoint(addr) -> Optional[EndPoint]:
    return EndPoint(host=addr[0], port=addr[1]) if addr else None


class Socket:
    def __init__(self, conn: Optional[socket.socket],
                 remote_side: Optional[EndPoint] = None,
                 local_side: Optional[EndPoint] = None):
        self.conn = conn
        self.remote_side = remote_side or _endpoint(conn.getpeername())
        self.local_side = local_side or _endpoint(conn.getsockname())
        self.ici_endpoint = None        # lazy IciEndpoint (device payloads)
        self.ici_peer_domain: Optional[bytes] = None   # learned from meta
        self.ici_conn_token: Optional[bytes] = None    # client: generated;
        #                                 server: pinned from the first frame
        self.shm = None                 # lazy shm_ring.ShmSockState
        self.defer_acks = False
        self.failed = False
        self._write_lock = threading.Lock()
        self._ack_lock = threading.Lock()
        self._pending_acks: List[int] = []
        self.stream_map: Dict[int, object] = {}   # stream id -> Stream
        self._stream_lock = threading.Lock()
        # the input messenger's state (HTTP/1.x and h2 connections)
        self.read_portal = None
        self.last_protocol = None
        self.h2_conn = None
        self.tag: Optional[str] = None
        # the server's per-connection verdict ("authed" once the first
        # message passed ServerOptions.auth), as in the JAX Socket
        self.app_data = None
        with _registry_lock:
            self.id = next(_ids)
            _registry[self.id] = self

    @staticmethod
    def address(socket_id: int) -> Optional["Socket"]:
        """The live socket of an id, or None once it closed."""
        return _registry.get(socket_id)

    def set_failed(self, code: int = 0, text: str = "") -> None:
        """The messenger's verdict on a connection it can no longer read
        (EOF, bytes no protocol claims; ``code`` and ``text`` name it):
        marked failed, shut down."""
        self.failed = True
        self._shutdown()

    def write(self, data) -> None:
        """Write one or more whole frames (bytes, or an ``IOBuf`` sent
        from its blocks), queued acks in front.  Raises OSError when the
        connection is gone (and marks it failed)."""
        with self._write_lock:
            self._send(self._take_acks())
            self._send(data)
        if not self.defer_acks:
            self.flush_acks()

    def queue_ack(self, desc_ids) -> None:
        """Queue credit returns (see the module docstring).  Dropped on a
        failed socket: the poster's TTL sweep or connection teardown
        reclaims them."""
        if self.failed:
            return
        with self._ack_lock:
            self._pending_acks.extend(desc_ids)
        if not self.defer_acks:
            self.flush_acks()

    def flush_acks(self) -> None:
        """Write queued acks now, unless another writer holds the lock
        (it flushes them after its write)."""
        while self._pending_acks and not self.failed \
                and self._write_lock.acquire(blocking=False):
            try:
                self._send(self._take_acks())
            except OSError:
                pass                    # _send marked the socket failed
            finally:
                self._write_lock.release()

    def bind_stream(self, stream) -> bool:
        """Register a stream riding this connection; False once the
        connection failed (the stream must then close itself)."""
        with self._stream_lock:
            if self.failed:
                return False
            self.stream_map[stream.id] = stream
        return True

    def unbind_stream(self, stream_id: int) -> None:
        with self._stream_lock:
            self.stream_map.pop(stream_id, None)

    def close(self) -> None:
        """Close the connection, close every stream bound to it (a
        receive-only stream would not learn otherwise), and reclaim every
        device payload posted on it, every shm ring slot it consumed and
        every KV page exported for it (the peer can no longer redeem, ack,
        release or import them)."""
        self.failed = True
        with _registry_lock:
            _registry.pop(self.id, None)
        with self._stream_lock:
            streams = list(self.stream_map.values())
            self.stream_map.clear()
        for stream in streams:
            stream._on_conn_broken()
        self._shutdown()    # wakes a thread blocked reading the connection
        if self.ici_endpoint is not None:
            from ..ici.fabric import (in_process_fabric,
                                      installed_transfer_fabric)
            in_process_fabric().release_socket(self.id)
            xfab = installed_transfer_fabric()
            if xfab is not None:
                xfab.release_socket(self.id)
        if self.shm is not None:
            # slots whose release TLVs can no longer arrive
            from . import shm_ring
            shm_ring.on_socket_closed(("resp", self.id))
            shm_ring.on_socket_closed(("req", self.id))
        # KV pages exported for this connection's sessions (a handoff in
        # flight when the client died) are swept the same way
        from ..kv.pages import on_socket_closed
        on_socket_closed(("kv", self.id))
        self._close_conn()

    def _take_acks(self) -> bytes:
        with self._ack_lock:
            ids, self._pending_acks = self._pending_acks, []
        return pack_ack_frame(ids) if ids else b""

    def _shutdown(self) -> None:
        try:
            self.conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _close_conn(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass

    def _send(self, data) -> None:
        if not data:
            return
        try:
            if isinstance(data, IOBuf):
                while not data.empty():
                    data.cut_into_socket(self.conn)
            else:
                self.conn.sendall(data)
        except OSError:
            self.failed = True
            raise


class _SocketPool:
    """The live sockets, as the JAX package's ``socket_pool()`` shows
    them to ``/sockets`` and ``/connections``."""

    def live_items(self):
        with _registry_lock:
            return sorted(_registry.items())

    def __len__(self) -> int:
        return len(_registry)


_pool = _SocketPool()


def socket_pool() -> _SocketPool:
    return _pool
