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

The client's connections (``transport/socket_map.py``).  A client socket
carries what the JAX Socket carries for its client half: ``ssl_context``
(TLS: the engine's client calls cannot take it), ``direct_read`` (its
caller reads it itself: the fast lane's pooled and short connections),
``lane_token`` (its reads belong to the client lane's ``ClientDemux``),
``health_check_interval_s`` and the table of calls waiting on it by
correlation id (:meth:`add_waiter`, :meth:`pop_waiter`).  :attr:`fd` is
the plain connection the engine's calls take by ``fileno()``.
:meth:`set_failed` on a client socket fails every waiting call, closes
its streams and reclaims what was posted on it, and hands a socket with
an interval to the health check (``transport/health_check.py``), which
revives it in place with :meth:`reconnect_now`: a fresh connect, TLS
wrapped again, serialized against concurrent revivers, the reader armed
again through ``on_revive``.  A socket revives only while it is
registered: :meth:`close` (``release``) destroys it.
"""

from __future__ import annotations

import itertools
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

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
        # the client half (transport/socket_map.py)
        self.ssl_context = None
        self.direct_read = False
        self.lane_token = 0
        self.health_check_interval_s = 0.0
        self.connect_timeout_s = 1.0
        self.on_revive: Optional[Callable[["Socket"], None]] = None
        self._pooled_home = None
        self._cntl_tails: Optional[Dict[Any, bytes]] = None
        self._torn_down = False
        self._reconnect_lock = threading.Lock()
        self._last_reconnect_at = 0.0
        self.waiters: Dict[int, Any] = {}
        self._waiters_lock = threading.Lock()
        with _registry_lock:
            self.id = next(_ids)
            _registry[self.id] = self

    @staticmethod
    def address(socket_id: int) -> Optional["Socket"]:
        """The live socket of an id, or None once it closed."""
        return _registry.get(socket_id)

    @property
    def fd(self) -> Optional[socket.socket]:
        """The plain connection the engine's client calls take (by
        ``fileno()``); None for a TLS, native or failed connection."""
        if self.ssl_context is not None or self.failed:
            return None
        return self.conn

    def set_failed(self, code: int = 0, text: str = "") -> None:
        """The verdict on a connection that can no longer be read (EOF,
        bytes no protocol claims, a transport error; ``code`` and
        ``text`` name it): marked failed and shut down.  The first
        verdict on a client socket also fails the calls waiting on it,
        closes its streams, reclaims what was posted on it and, with a
        health-check interval, schedules its revival."""
        with self._reconnect_lock:
            self.failed = True
            self._shutdown()
            if self._torn_down or Socket.address(self.id) is None:
                return
            self._torn_down = True
            self._teardown(text or f"socket failed [{code}]")
        if self.health_check_interval_s > 0 and self.remote_side is not None:
            from .health_check import start_health_check
            start_health_check(self.id, self.health_check_interval_s)

    # -- the client's waiting calls and revival ---------------------------

    def add_waiter(self, cid: int, waiter) -> bool:
        """Register the call waiting for response ``cid``; False once the
        connection failed (the call must then fail itself)."""
        with self._waiters_lock:
            if self.failed:
                return False
            self.waiters[cid] = waiter
        return True

    def pop_waiter(self, cid: int):
        with self._waiters_lock:
            return self.waiters.pop(cid, None)

    def _fail_waiters(self, why: str) -> None:
        with self._waiters_lock:
            waiters = list(self.waiters.values())
            self.waiters.clear()
        for waiter in waiters:
            waiter.fail(why)

    def _teardown(self, why: str) -> None:
        """What a dead connection leaves behind: its lane registration,
        its waiting calls, its streams, the device payloads posted on it,
        the shm slots it consumed and the KV pages exported for it."""
        if self.lane_token:
            from .client_lane import global_client_lane
            lane = global_client_lane(create=False)
            if lane is not None:
                lane.detach(self)
        self._fail_waiters(why)
        with self._stream_lock:
            streams = list(self.stream_map.values())
            self.stream_map.clear()
        for stream in streams:
            stream._on_conn_broken()
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

    def reconnect_now(self) -> bool:
        """The revival recipe, shared by the health check and the
        fail-fast path: a fresh connect, TLS wrapped again when
        configured, the per-connection state reset and the reader armed
        again (``on_revive``).  Serialized: two revivers never each
        install a connection.  True once the socket is usable."""
        with self._reconnect_lock:
            if not self.failed:
                return True
            if self.remote_side is None or Socket.address(self.id) is None:
                return False
            try:
                conn = dial(self.remote_side, self.connect_timeout_s,
                            self.ssl_context)
            except (OSError, ValueError):
                return False
            old, self.conn = self.conn, conn
            try:
                old.close()
            except (OSError, AttributeError):
                pass
            self.ici_endpoint = None
            self.ici_peer_domain = None
            self.ici_conn_token = None
            self.shm = None
            self.app_data = None
            self.read_portal = None
            self._cntl_tails = None
            with self._ack_lock:
                self._pending_acks = []
            self._torn_down = False
            with self._waiters_lock:
                self.failed = False
        hook = self.on_revive
        if hook is not None:
            hook(self)
        return True

    def try_reconnect_now(self) -> bool:
        """Fail-fast revival: the health check's action without waiting
        for its tick (a server bounced on the same address), at most one
        attempt every 0.5 s; a caller that loses the race reports the
        current state."""
        if not self.failed:
            return True
        if not self._reconnect_lock.acquire(blocking=False):
            return not self.failed
        try:
            now = time.monotonic()
            if now - self._last_reconnect_at < 0.5:
                return False
            self._last_reconnect_at = now
        finally:
            self._reconnect_lock.release()
        return self.reconnect_now()

    def write_path_idle(self) -> bool:
        """No write in progress and no ack queued: an engine call may own
        the connection's writes."""
        return not self._write_lock.locked() and not self._pending_acks

    def _take_ack_frame(self) -> Optional[bytes]:
        """The queued acks as one lead frame (None when none is queued),
        for a caller that writes them itself ahead of its request."""
        return self._take_acks() or None

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
        """Destroy the socket: close the connection, close every stream
        bound to it (a receive-only stream would not learn otherwise),
        fail the calls waiting on it, and reclaim every device payload
        posted on it, every shm ring slot it consumed and every KV page
        exported for it (the peer can no longer redeem, ack, release or
        import them).  A destroyed socket is never revived."""
        with self._reconnect_lock:
            self.failed = True
            with _registry_lock:
                _registry.pop(self.id, None)
            self._shutdown()    # wakes a thread blocked reading it
            if not self._torn_down:
                self._torn_down = True
                self._teardown("connection closed")
            self._close_conn()

    release = close

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


def dial(remote: EndPoint, connect_timeout_s: float,
         ssl_context=None) -> socket.socket:
    """A fresh client connection to ``remote``: TCP_NODELAY, and wrapped
    in TLS when ``ssl_context`` is given (a blocking handshake bounded by
    the connect timeout plus 4 s, as ``ssl_helper.cpp``'s loop)."""
    conn = socket.create_connection(remote.to_sockaddr(),
                                    timeout=connect_timeout_s)
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    if ssl_context is not None:
        try:
            conn.settimeout(connect_timeout_s + 4.0)
            conn = ssl_context.wrap_socket(conn,
                                           server_hostname=str(remote.host))
        except (OSError, ValueError):
            conn.close()
            raise
    return conn


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
