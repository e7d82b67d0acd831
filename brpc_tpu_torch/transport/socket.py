"""Socket -- one connection's identity, read path and write path, shared
by the port's Server and Channel.

The port of ``brpc_tpu/transport/socket.py`` (brpc's ``socket.h:353,361``
and ``socket.cpp:1575-1750,1994,2111``): a process-unique id with a
registry (:meth:`Socket.address`), the addresses of both ends, the
device-attachment lane's per-connection state (``ici_endpoint``,
``ici_peer_domain``, ``ici_conn_token``), the shm data plane's
negotiation state (``shm``, a ``shm_ring.ShmSockState``), the ack queue
of TICI credit returns, and the streams bound to the connection
(``stream_map``: closing the connection closes them).  ``conn`` may be
an ``ssl.SSLSocket`` (TLS at either end); ``app_data`` holds the
server's per-connection auth verdict; ``tag`` is ``"internal"`` on a
server's internal port.  :func:`socket_pool` lists the live sockets for
``/sockets``.

The read path (``event_dispatcher.py``).  A dispatcher-driven socket
(every connection a server accepts, a client's ``"single"`` connection
the client lane declines, a pooled connection an async, backup or
stream call converted with :meth:`ensure_dispatched`) is read by no
thread of its own: the dispatcher calls :meth:`start_input_event`,
which wakes one consumer fiber (:meth:`_process_events`) that runs
``on_edge_triggered_events`` -- an ``InputMessenger.on_new_messages`` --
until the socket reads EAGAIN, then re-arms the read interest.  Events
that fire while the consumer runs only bump its ``nevent`` counter.
:meth:`read_into_portal` reads one gulp into ``read_portal`` at the
adaptive size (:meth:`suggested_read_size`, fed by
:meth:`note_msg_size`).

The write path.  :meth:`write` never blocks: it appends the frame to the
connection's queue (queued acks in front, taken atomically with the
enqueue), and the first writer becomes the drainer, which sends once
inline and hands what the kernel refused to a keep-write fiber that
parks on EPOLLOUT (:meth:`_wait_epollout`).  One drainer at a time
keeps one connection's frames whole and in the order their writers
enqueued them.  A failed socket drops its queue; :meth:`write` on it
raises OSError.  Acks (:meth:`queue_ack`): while ``defer_acks`` is set
(a server between reading a request and writing its response) they ride
in front of the next frame written, so a request descriptor's ack
always precedes its response on the wire; otherwise they are queued at
once.  Queuing an ack never blocks, so it is safe from a finalizer.

TLS (C15).  One SSL object must never be read and written by two
threads at once: every SSL read of the consumer and every SSL send of a
drainer holds the write lock, and both are non-blocking on a
dispatcher-driven socket (``SSLWantReadError``/``SSLWantWriteError`` are
EAGAIN; a read drains OpenSSL's decrypted bytes, ``pending()``, before
it stops).  The JAX socket does not guard this; the port does, on
purpose.

The client's connections (``transport/socket_map.py``).  A client socket
carries what the JAX Socket carries for its client half: ``ssl_context``
(TLS: the engine's client calls cannot take it), ``direct_read`` (its
caller reads it itself: the fast lane's pooled and short connections;
the engine's ``sync_call`` reads the raw fd and holds the write lock
around each round trip), ``lane_token`` (its reads belong to the client
lane's ``ClientDemux``), ``health_check_interval_s`` and the table of
calls waiting on it by correlation id (:meth:`add_waiter`,
:meth:`pop_waiter`).  Sockets read by the engine are never registered
with the dispatcher: it would steal their bytes.  :attr:`fd` is the
plain connection the engine's calls take by ``fileno()``.
:meth:`set_failed` on a client socket fails every waiting call, closes
its streams and reclaims what was posted on it, and hands a socket with
an interval to the health check (``transport/health_check.py``), which
revives it in place with :meth:`reconnect_now`: a fresh connect, TLS
wrapped again, serialized against concurrent revivers, the reader armed
again through ``on_revive``.  A socket revives only while it is
registered: :meth:`close` (``release``) destroys it.

A connection of the native engine has no Python socket: its
``NativeSocket`` (``transport/native_bridge.py``) passes ``conn=None``
with both addresses and fills the three hooks that touch the connection
(:meth:`_send`, :meth:`_shutdown`, :meth:`_close_conn`), so controllers,
streams and device-attachment acks address it through the same registry.

Cut from the JAX socket: ``SocketOptions`` and ``Socket.create`` (the
port constructs a Socket from its connection), the ResourcePool slot
versions (the registry's ids are never reused), ``id_wait`` on writes
(a call waiting on the connection is failed through its waiter), and
the timer flush of acks (they are queued at once).
"""

from __future__ import annotations

import errno
import itertools
import os
import socket
import ssl
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from ..butil.endpoint import EndPoint
from ..butil.iobuf import IOBuf, IOPortal
from ..butil.logging_util import LOG
from ..butil.status import Errno
from ..fiber import runtime as fiber_runtime
from ..protocol.tpu_std import pack_ack_frame

# brpc_tpu's name for the one TICI credit-return encoder ("TICI", u32
# count, count u64 ids; 4096 ids a frame, frames back to back), which
# lives with the frame's parser in protocol/tpu_std.py
encode_ack_frame = pack_ack_frame

_registry: Dict[int, "Socket"] = {}
_registry_lock = threading.Lock()
_ids = itertools.count(1)

_IOV_MAX = 512              # views per writev
_TLS_CHUNK = 256 * 1024     # bytes per SSL send
_EPOLLOUT_WAIT_S = 60.0     # a keep-write fiber's wait for writability
# _drain_once's verdicts
_DONE, _AGAIN, _BUSY = 0, 1, 2


def _endpoint(addr) -> Optional[EndPoint]:
    return EndPoint(host=addr[0], port=addr[1]) \
        if isinstance(addr, tuple) and addr else None


def _is_tls(conn) -> bool:
    return isinstance(conn, ssl.SSLSocket)


def _views(data) -> List[memoryview]:
    """A frame (bytes-like or ``IOBuf``) as the byte views to send."""
    if isinstance(data, IOBuf):
        return [v.cast("B") if v.format != "B" else v
                for v in data.backing_views() if len(v)]
    if not data:
        return []
    v = memoryview(data)
    return [v.cast("B") if v.format != "B" or v.ndim != 1 else v]


class _Pending:
    """One queued frame: its views and how far they went out."""

    __slots__ = ("views", "idx")

    def __init__(self, views: List[memoryview]):
        self.views = views
        self.idx = 0

    def advance(self, n: int) -> None:
        views = self.views
        while n and self.idx < len(views):
            v = views[self.idx]
            if n >= len(v):
                n -= len(v)
                self.idx += 1
            else:
                views[self.idx] = v[n:]
                n = 0

    @property
    def done(self) -> bool:
        return self.idx >= len(self.views)


class Socket:
    def __init__(self, conn: Optional[socket.socket],
                 remote_side: Optional[EndPoint] = None,
                 local_side: Optional[EndPoint] = None):
        self.conn = conn
        self.remote_side = remote_side or _endpoint(conn.getpeername())
        self.local_side = local_side
        if local_side is None and conn is not None:
            self.pin_local_side()
        self._tls = _is_tls(conn)
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
        # the non-blocking write path: the queue, the drainer role and
        # its epoch (a failure revokes a parked drainer)
        self._q_lock = threading.Lock()
        self._write_queue: Deque[_Pending] = deque()
        self._draining = False
        self._drain_epoch = 0
        self._epollout_event = threading.Event()
        self.stream_map: Dict[int, object] = {}   # stream id -> Stream
        self._stream_lock = threading.Lock()
        # the read path: the input messenger's state and the dispatcher
        self.read_portal: Optional[IOPortal] = None
        self.last_protocol = None
        self.h2_conn = None
        self.tag: Optional[str] = None
        self.on_edge_triggered_events: Optional[Callable] = None
        self._dispatcher = None
        self._nevent = 0
        self._nevent_lock = threading.Lock()
        self._avg_msg_size = 0.0
        self._dispatch_lock = threading.Lock()
        # the server's per-connection verdict ("authed" once the first
        # message passed ServerOptions.auth), as in the JAX Socket, and
        # the gate later messages wait at until the first one's verdict
        self.app_data = None
        self.auth_gate: Optional[threading.Event] = None
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

    def pin_local_side(self) -> Optional[EndPoint]:
        """Resolve and keep the local address of ``conn``, at once when
        the connection is installed: resolved later, a concurrently
        failed connection could leave it unknown, and the device lane
        keys connections by both ends."""
        if self.local_side is None and self.conn is not None:
            try:
                self.local_side = _endpoint(self.conn.getsockname())
            except OSError as e:
                LOG.warning("socket %s: local address unresolvable (%s)",
                            self.id if hasattr(self, "id") else "?", e)
        return self.local_side

    def set_failed(self, code: int = 0, text: str = "") -> None:
        """The verdict on a connection that can no longer be used (EOF,
        bytes no protocol claims, a transport error; ``code`` and
        ``text`` name it): marked failed, its queued writes dropped, its
        read interest removed and the connection shut down.  The first
        verdict also fails the calls waiting on it, closes its streams,
        reclaims what was posted on it and, with a health-check
        interval, schedules its revival."""
        with self._reconnect_lock:
            self._mark_failed()
            self._shutdown()
            if self._torn_down or Socket.address(self.id) is None:
                return
            self._torn_down = True
            self._teardown(text or f"socket failed [{code}]")
        if self.health_check_interval_s > 0 and self.remote_side is not None:
            from .health_check import start_health_check
            start_health_check(self.id, self.health_check_interval_s)

    def _mark_failed(self) -> None:
        with self._q_lock:
            self.failed = True
            self._write_queue.clear()
            self._draining = False
            self._drain_epoch += 1
        self._epollout_event.set()      # a parked drainer exits
        disp = self._dispatcher
        if disp is not None and self.conn is not None:
            try:
                disp.remove_consumer(self.conn)
            except (OSError, ValueError):
                pass

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
            self._tls = _is_tls(conn)
            self.local_side = None
            self.pin_local_side()
            self.ici_endpoint = None
            self.ici_peer_domain = None
            self.ici_conn_token = None
            self.shm = None
            self.app_data = None
            self.auth_gate = None
            self.read_portal = None
            self.last_protocol = None
            self._cntl_tails = None
            self._dispatcher = None
            with self._ack_lock:
                self._pending_acks = []
            self._torn_down = False
            with self._waiters_lock, self._q_lock:
                self.failed = False
                self._write_queue.clear()
                self._draining = False
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

    # -- the write path ----------------------------------------------------

    def write_path_idle(self) -> bool:
        """No write queued, draining or in progress and no ack queued: an
        engine call may own the connection's writes."""
        return not self._draining and not self._write_queue \
            and not self._write_lock.locked() and not self._pending_acks

    def _take_ack_frame(self) -> Optional[bytes]:
        """The queued acks as one lead frame (None when none is queued),
        for a caller that writes them itself ahead of its request."""
        return self._take_acks() or None

    def write(self, data) -> None:
        """Queue one or more whole frames (bytes, or an ``IOBuf`` sent
        from its blocks), queued acks in front, and start draining them
        unless a drainer already runs.  Never blocks.  Raises OSError
        when the connection is already gone."""
        self._enqueue(_views(data), True)
        if not self.defer_acks and self._pending_acks:
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
        """Queue the pending acks as a frame of their own now.  A
        direct-read connection's owner holds the write lock around its
        round trip, so they go out between two of its frames."""
        if self._pending_acks and not self.failed:
            try:
                self._enqueue([], False)
            except OSError:
                pass                    # failed meanwhile: dropped

    def _enqueue(self, views: List[memoryview], block: bool) -> None:
        """Append a frame (and the pending acks in front of it) to the
        queue; the writer that finds no drainer becomes it.  Without
        ``block`` (an ack flush, possibly from a finalizer on a thread
        inside this socket's critical section) a busy queue lock hands
        the flush to a fiber."""
        if not self._q_lock.acquire(blocking=block):
            fiber_runtime.spawn(self.flush_acks, name="flush_acks")
            return
        try:
            if self.failed:
                raise ConnectionError("connection closed")
            acks = self._take_acks()
            if acks:
                self._write_queue.append(_Pending([memoryview(acks)]))
            if views:
                self._write_queue.append(_Pending(views))
            start = bool(self._write_queue) and not self._draining
            if start:
                self._draining = True
                epoch = self._drain_epoch
        finally:
            self._q_lock.release()
        if start:
            self._kick(epoch)

    def _kick(self, epoch: int) -> None:
        """The new drainer's inline attempt; a keep-write fiber takes
        over what the kernel (or a busy write lock) did not take."""
        if self._drain_once(epoch, block=False) != _DONE:
            fiber_runtime.spawn(self._keep_write, epoch, name="keep_write")

    def _drain_once(self, epoch: int, block: bool) -> int:
        """Send queued frames until the queue is empty (``_DONE``, also
        when the role was revoked), the kernel refuses more (``_AGAIN``)
        or, without ``block``, another thread holds the write lock
        (``_BUSY``).  The write lock is held around each send only."""
        while True:
            with self._q_lock:
                if self._drain_epoch != epoch:
                    return _DONE
                if self.failed or not self._write_queue:
                    self._draining = False
                    return _DONE
                head = self._write_queue[0]
            if not self._write_lock.acquire(blocking=block):
                return _BUSY
            try:
                if self._drain_epoch != epoch:
                    return _DONE
                n = self._send(head.views[head.idx:])
                if n > 0:
                    head.advance(n)
            except (OSError, ValueError) as e:
                err = e
            else:
                err = None
            finally:
                self._write_lock.release()
            if err is not None:
                if self._drain_epoch == epoch:
                    self.set_failed(int(Errno.EFAILEDSOCKET), f"send: {err}")
                return _DONE
            if n < 0:
                return _AGAIN
            if head.done:
                with self._q_lock:
                    if self._write_queue and self._write_queue[0] is head:
                        self._write_queue.popleft()

    def _keep_write(self, epoch: int) -> None:
        """≈ the KeepWrite bthread (socket.cpp:1750): drain until empty,
        parking on writability instead of spinning."""
        while True:
            with fiber_runtime.blocking():
                st = self._drain_once(epoch, block=True)
            if st == _DONE or self.failed or self._drain_epoch != epoch:
                return
            if not self._wait_epollout(_EPOLLOUT_WAIT_S):
                if not self.failed and self._drain_epoch == epoch:
                    self.set_failed(int(Errno.EFAILEDSOCKET),
                                    "writability wait timed out")
                return

    def _wait_epollout(self, timeout: float) -> bool:
        """≈ Socket::WaitEpollOut (socket.cpp:1224): one-shot write
        interest with the dispatcher, the fiber parked until it fires."""
        conn = self.conn
        if conn is None or self.failed:
            return False
        self._epollout_event.clear()
        disp = self._dispatcher
        if disp is None:
            from .event_dispatcher import global_dispatcher
            disp = global_dispatcher()
        try:
            disp.add_epollout(conn, self._epollout_event.set)
        except (OSError, ValueError):
            return False
        with fiber_runtime.blocking():
            ok = self._epollout_event.wait(timeout)
        return ok and not self.failed

    def _send(self, views: List[memoryview]) -> int:
        """Send from ``views`` what the connection takes now: the bytes
        sent, or -1 when it would block.  Runs under the write lock."""
        conn = self.conn
        if self._tls:
            try:
                return conn.send(views[0][:_TLS_CHUNK])
            except (ssl.SSLWantWriteError, ssl.SSLWantReadError,
                    BlockingIOError):
                return -1
        try:
            return os.writev(conn.fileno(), views[:_IOV_MAX])
        except BlockingIOError:
            return -1
        except InterruptedError:
            return 0

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
            self._mark_failed()
            with _registry_lock:
                _registry.pop(self.id, None)
            self._shutdown()    # wakes a thread blocked reading it
            if not self._torn_down:
                self._torn_down = True
                self._teardown("connection closed")
            self._close_conn()

    def release(self) -> None:
        """The JAX name of :meth:`close`."""
        self.close()

    def _take_acks(self) -> bytes:
        with self._ack_lock:
            ids, self._pending_acks = self._pending_acks, []
        return encode_ack_frame(ids) if ids else b""

    def _shutdown(self) -> None:
        try:
            self.conn.shutdown(socket.SHUT_RDWR)
        except (OSError, AttributeError):
            pass

    def _close_conn(self) -> None:
        try:
            self.conn.close()
        except (OSError, AttributeError):
            pass

    # -- the read path -----------------------------------------------------

    def attach_dispatcher(self, dispatcher) -> None:
        self._dispatcher = dispatcher

    def dispatch_reads(self, on_events: Callable,
                       dispatcher=None) -> None:
        """From now on the dispatcher reads this connection: the
        descriptor non-blocking, ``on_events(sock)`` run by a consumer
        fiber on every readiness (an ``InputMessenger``'s
        ``on_new_messages``)."""
        from .event_dispatcher import global_dispatcher
        disp = dispatcher or global_dispatcher()
        self.on_edge_triggered_events = on_events
        conn = self.conn
        conn.setblocking(False)
        self.attach_dispatcher(disp)
        disp.add_consumer(conn, self.start_input_event)

    def ensure_dispatched(self) -> None:
        """One-way conversion of a direct-read socket to dispatcher-driven
        reads (an async, backup or stream call on a pooled connection
        made for the fast lane's synchronous reads); its responses go to
        the calls waiting on it through the client messenger."""
        with self._dispatch_lock:
            if not self.direct_read:
                return
            self.direct_read = False
        if self.conn is not None and not self.failed:
            from .input_messenger import client_messenger
            self.dispatch_reads(client_messenger().on_new_messages)

    def start_input_event(self) -> None:
        """≈ Socket::StartInputEvent (socket.cpp:2111): the first event
        spawns the consumer fiber; further events while it runs only
        bump a counter it looks at before it exits."""
        with self._nevent_lock:
            self._nevent += 1
            if self._nevent > 1:
                return
        fiber_runtime.spawn(self._process_events, urgent=True,
                            name="input_event")

    def _process_events(self) -> None:
        while True:
            cb = self.on_edge_triggered_events
            if cb is not None and not self.failed:
                try:
                    cb(self)
                except Exception:
                    LOG.exception("edge-triggered callback failed on %s",
                                  self.remote_side)
                    self.set_failed(int(Errno.EINTERNAL),
                                    "event callback raised")
            with self._nevent_lock:
                # every event seen while the callback ran is consumed
                if self._nevent <= 1 or self.failed:
                    self._nevent = 0
                    break
                self._nevent = 1
        # drained to EAGAIN: read interest again
        disp = self._dispatcher
        if not self.failed and disp is not None:
            try:
                disp.rearm_read(self.conn.fileno())
            except (OSError, ValueError, AttributeError):
                pass

    def read_into_portal(self, suggested: int = 0) -> int:
        """≈ Socket::DoRead (socket.cpp:1994): one gulp into
        ``read_portal``.  Bytes read; 0 at EOF (or once the connection
        failed); -1 when it would block.  A TLS read holds the write
        lock (C15)."""
        conn = self.conn
        if conn is None or self.failed:
            return 0
        if self.read_portal is None:
            self.read_portal = IOPortal()
        size = suggested or self.suggested_read_size()
        try:
            if self._tls:
                with self._write_lock:
                    return self.read_portal.append_from_socket(conn, size)
            return self.read_portal.append_from_socket(conn, size)
        except (BlockingIOError, ssl.SSLWantReadError,
                ssl.SSLWantWriteError, InterruptedError):
            return -1
        except (OSError, ValueError) as e:
            if isinstance(e, OSError) and e.errno in (errno.EAGAIN,
                                                      errno.EWOULDBLOCK):
                return -1
            self.set_failed(int(Errno.EFAILEDSOCKET), f"recv: {e}")
            return 0

    def suggested_read_size(self) -> int:
        """The adaptive read size: 16 average messages, clamped to
        [4 KiB, 1 MiB] (input_messenger.cpp:352-358)."""
        avg = self._avg_msg_size or 1024.0
        return max(4096, min(int(avg * 16), 1024 * 1024))

    def note_msg_size(self, n: int) -> None:
        # a running average with the reference's intent
        self._avg_msg_size = (self._avg_msg_size * 0.875 + n * 0.125
                              if self._avg_msg_size else float(n))

    def __repr__(self) -> str:
        state = "failed" if self.failed else "ok"
        return f"Socket(id={self.id}, remote={self.remote_side}, {state})"


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
