"""SocketMap -- the client's connections, shared process-wide.

The port of ``brpc_tpu/transport/socket_map.py`` (brpc's
``socket_map.cpp`` and the connection types of ``protocol.h:174-181``):

- **single**: one connection per peer and channel signature
  (:func:`conn_key`), shared by every channel with that signature; calls are
  multiplexed on it and matched by correlation id.  Its reads belong to
  the client lane's native demux (``transport/client_lane.py``,
  ``prefer_lane``), or to the event dispatcher and the client messenger
  when the lane declines (TLS, the flag off, no engine), as in the JAX
  package.  A failed one stays in the
  map and the health check revives it in place
  (``transport/health_check.py``, every ``health_check_interval_s``);
  :meth:`SocketMap.get_socket` also tries a rate-limited revival at
  once, for a server bounced on the same address.
- **pooled**: a free list of at most 32 connections per peer; a
  connection carries one call at a time and goes back after it;
- **short**: a connection per call.

Pooled and short connections are born ``direct_read``: their caller
reads them itself (the fast lane, ``client/fast_call.py``), on a
non-blocking descriptor that the engine polls.  An async or hedged
call's attempt converts its connection to the dispatcher
(``Socket.ensure_dispatched``); such a connection leaves the pool after
its call, where the JAX pool keeps it and its fast lane declines it.

A connection the dispatcher reads runs ``transport/input_messenger``'s
``client_messenger`` on its consumer fiber: a response goes to the call
waiting on its correlation id (:func:`hand_over`, tpu_std's
``process_response``), a TICI ack to the device lane and a TSTR frame to
its stream.  The lane's fallback frames go through
:func:`process_client_msg`, which does the same for a frame read whole.

Divergences from the JAX map: the map and the pools are keyed by the
channel's signature, as brpc's ``ChannelSignature`` keys them, and not by
``(remote, ssl is not None)``: the peer, the TLS context itself, the
connect timeout and the credentials (:func:`conn_key`).  A server checks
credentials on a connection's first message only, so a connection shared
by channels with other credentials would serve one channel under
another's, and a TLS connection dialed under one channel's verification
would serve a channel that asked for another.  A connect that fails
leaves nothing in the map (the next call connects again, which is the
fail-fast revival the JAX map runs on the socket it keeps); and an entry
is reference-counted by the channels that use it
(:meth:`SocketMap.insert` / :meth:`SocketMap.remove`, as brpc's
``SocketMapInsert`` / ``SocketMapRemove``), so ``Channel.close`` closes a
shared connection, and the streams it carries, once no other channel
uses it.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from ..butil.endpoint import EndPoint
from ..butil.status import Errno
from .socket import Socket, dial

DEFAULT_HEALTH_CHECK_INTERVAL_S = 3.0   # the flag's default
# a direct-read connection always has a timeout, so its descriptor stays
# non-blocking for the engine; a call without a deadline waits this long
NO_DEADLINE_S = 24 * 3600.0
# a lane-attached connection's writes (the demux reads a non-blocking
# descriptor, so Python's sends poll): one frame may take this long
LANE_WRITE_TIMEOUT_S = 60.0
MAX_POOLED = 32


def conn_key(remote: EndPoint, ssl_context=None,
             connect_timeout_s: float = 1.0, auth=b"") -> tuple:
    """The key a connection is shared under: the peer, the TLS context
    (the object itself: ``Channel.ssl_ctx`` gives channels with the same
    TLS options one context), the connect timeout and the credentials.
    Channels whose keys differ never share a connection."""
    if isinstance(auth, str):
        auth = auth.encode()
    return (remote, ssl_context, float(connect_timeout_s), bytes(auth or b""))


def _new_connection(remote: EndPoint,
                    health_check_interval_s: float = 0.0,
                    direct_read: bool = False,
                    ssl_context=None,
                    prefer_lane: bool = False,
                    connect_timeout_s: float = 1.0) -> Tuple[int, int]:
    """Connect a client socket; ``(socket_id, 0)``, or ``(0, errno)``
    when the connect failed.  ``direct_read``: its caller reads it (no
    reader); else ``prefer_lane`` asks the client lane to read it, and
    the dispatcher reads it when the lane declines."""
    try:
        conn = dial(remote, connect_timeout_s, ssl_context)
    except (OSError, ValueError):
        return 0, int(Errno.EFAILEDSOCKET)
    sock = Socket(conn, remote_side=remote)
    sock.ssl_context = ssl_context
    sock.connect_timeout_s = connect_timeout_s
    sock.health_check_interval_s = health_check_interval_s
    if direct_read:
        sock.direct_read = True
        conn.settimeout(NO_DEADLINE_S)
        return sock.id, 0
    sock.on_revive = lambda s: _arm_reader(s, prefer_lane)
    _arm_reader(sock, prefer_lane)
    return sock.id, 0


def _arm_reader(sock: Socket, prefer_lane: bool) -> None:
    if prefer_lane:
        from .client_lane import try_attach
        if try_attach(sock):
            return
    dispatch_client(sock)


def dispatch_client(sock: Socket) -> None:
    """From now on the dispatcher reads ``sock`` through the client
    messenger, the bytes already in its portal first."""
    from .input_messenger import client_messenger
    messenger = client_messenger()
    if sock.read_portal is not None and not sock.read_portal.empty():
        messenger.process_buffered(sock)
    if not sock.failed:
        sock.dispatch_reads(messenger.on_new_messages)


# -- the Python demux (the lane's fallback frames) ---------------------------

def hand_over(sock: Socket, msg) -> None:
    """A response ``(meta, payload, attachment)`` to the call waiting on
    its correlation id; one whose call already has an outcome is dropped
    (the credit of a device descriptor on it goes back)."""
    waiter = sock.pop_waiter(msg[0].correlation_id)
    if waiter is None:
        from ..ici.endpoint import ack_unused
        ack_unused(msg[0], sock.id)
    else:
        waiter.deliver(msg, sock)


def process_client_msg(sock: Socket, msg) -> None:
    """One frame read off a client connection: an ack, a stream frame or
    a response."""
    from ..protocol.streaming import StreamFrame, dispatch
    from ..protocol.tpu_std import AckFrame
    if isinstance(msg, AckFrame):
        from ..ici.endpoint import process_ack
        process_ack(msg.ids, sock)
    elif isinstance(msg, StreamFrame):
        dispatch(msg, sock)
    else:
        hand_over(sock, msg)


class Replay:
    """Bytes already read (the lane's buffered frames) in front of a
    connection, for ``read_frame``'s ``recv_into``."""

    __slots__ = ("_prefix", "_conn")

    def __init__(self, prefix, conn=None):
        self._prefix = bytearray(prefix)
        self._conn = conn

    def recv_into(self, view) -> int:
        if self._prefix:
            n = min(len(view), len(self._prefix))
            view[:n] = self._prefix[:n]
            del self._prefix[:n]
            return n
        if self._conn is None:
            return 0
        return self._conn.recv_into(view)


# -- the shared "single" connections ----------------------------------------

class SocketMap:
    """Peer -> the shared ``"single"`` connection (socket_map.cpp)."""

    def __init__(self, health_check_interval_s: Optional[float] = None):
        self._lock = threading.Lock()
        self._map: Dict[tuple, int] = {}
        self._refs: Dict[tuple, int] = {}
        # None: follow the live flag at connection time
        self._hc = health_check_interval_s

    def _hc_interval(self) -> float:
        if self._hc is not None:
            return self._hc
        from ..butil.flags import get_flag
        return get_flag("health_check_interval_s",
                        DEFAULT_HEALTH_CHECK_INTERVAL_S)

    def get_socket(self, remote: EndPoint, ssl_context=None,
                   prefer_lane: bool = False,
                   connect_timeout_s: float = 1.0,
                   auth=b"") -> Tuple[int, int]:
        """``(socket_id, 0)`` for the shared connection to ``remote``
        under this signature (:func:`conn_key`), connecting it on first
        use (``prefer_lane`` applies then: the first caller picks the
        reader).  A failed socket is revived at once when its rate limit
        allows; the caller sees it still failed otherwise and may retry
        elsewhere.  ``(0, errno)`` when a first connect failed."""
        key = conn_key(remote, ssl_context, connect_timeout_s, auth)
        with self._lock:
            sid = self._map.get(key)
            s = Socket.address(sid) if sid is not None else None
            if s is None:
                sid, rc = _new_connection(remote, self._hc_interval(),
                                          ssl_context=ssl_context,
                                          prefer_lane=prefer_lane,
                                          connect_timeout_s=connect_timeout_s)
                if rc == 0:
                    self._map[key] = sid
                else:
                    self._map.pop(key, None)
                return sid, rc
        if s.failed:
            # outside the map lock: a connect may block for its timeout
            s.try_reconnect_now()
        return sid, 0

    def peek(self, remote: EndPoint, ssl_context=None,
             connect_timeout_s: float = 1.0, auth=b"") -> Optional[Socket]:
        """The shared socket to ``remote`` under this signature if one is
        open (no connect)."""
        sid = self._map.get(conn_key(remote, ssl_context, connect_timeout_s,
                                     auth))
        return Socket.address(sid) if sid is not None else None

    def insert(self, key: tuple) -> None:
        """One more channel uses the connection under ``key``
        (:func:`conn_key`)."""
        with self._lock:
            self._refs[key] = self._refs.get(key, 0) + 1

    def remove(self, key: tuple) -> None:
        """A channel stopped using the connection under ``key``; the last
        one closes it."""
        with self._lock:
            left = self._refs.get(key, 0) - 1
            if left > 0:
                self._refs[key] = left
                return
            self._refs.pop(key, None)
            sid = self._map.pop(key, None)
        s = Socket.address(sid) if sid is not None else None
        if s is not None:
            s.release()

    def clear(self) -> None:
        with self._lock:
            sids = list(self._map.values())
            self._map.clear()
            self._refs.clear()
        for sid in sids:
            s = Socket.address(sid)
            if s is not None:
                s.release()


# -- pooled and short connections -------------------------------------------

class SocketPool:
    """One peer's pooled connections (≈ Socket::GetPooledSocket)."""

    def __init__(self, remote: EndPoint, max_pooled: int = MAX_POOLED,
                 ssl_context=None, connect_timeout_s: float = 1.0):
        self._remote = remote
        self._lock = threading.Lock()
        self._free: Deque[int] = deque()
        self._max = max_pooled
        self._ssl_context = ssl_context
        self.connect_timeout_s = connect_timeout_s

    def get(self) -> Tuple[int, int]:
        while True:
            with self._lock:
                sid = self._free.popleft() if self._free else None
            if sid is None:
                break
            s = Socket.address(sid)
            if s is not None and not s.failed:
                return sid, 0
            if s is not None:
                s.release()      # a failed pooled connection frees its slot
        sid, rc = _new_connection(self._remote, direct_read=True,
                                  ssl_context=self._ssl_context,
                                  connect_timeout_s=self.connect_timeout_s)
        s = Socket.address(sid) if rc == 0 else None
        if s is not None:
            s._pooled_home = self
        return sid, rc

    def put(self, sid: int) -> None:
        s = Socket.address(sid)
        if s is None:
            return
        if s.failed or not s.direct_read:
            # a connection the dispatcher reads (an async or hedged call
            # converted it) cannot serve the fast lane, which reads its
            # pooled connections itself: it leaves the pool
            s.release()
            return
        if s._pending_acks:
            # credit returns go out while the connection is still ours
            s.flush_acks()
        with self._lock:
            if len(self._free) < self._max:
                self._free.append(sid)
                return
        s.release()

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)


_global_map: Optional[SocketMap] = None
_global_map_lock = threading.Lock()
_pools_lock = threading.Lock()
_pools: Dict[tuple, SocketPool] = {}


def global_socket_map() -> SocketMap:
    global _global_map
    with _global_map_lock:
        if _global_map is None:
            _global_map = SocketMap()
        return _global_map


def socket_pool_of(remote: EndPoint, ssl_context=None,
                   connect_timeout_s: float = 1.0, auth=b"") -> SocketPool:
    """The pool of connections to ``remote`` under this signature
    (:func:`conn_key`)."""
    key = conn_key(remote, ssl_context, connect_timeout_s, auth)
    with _pools_lock:
        pool = _pools.get(key)
        if pool is None:
            pool = _pools[key] = SocketPool(
                remote, ssl_context=ssl_context,
                connect_timeout_s=connect_timeout_s)
    return pool


def pooled_socket(remote: EndPoint, ssl_context=None,
                  connect_timeout_s: float = 1.0,
                  auth=b"") -> Tuple[int, int]:
    return socket_pool_of(remote, ssl_context, connect_timeout_s,
                          auth).get()


def return_pooled_socket(sid: int) -> None:
    s = Socket.address(sid)
    if s is not None and s._pooled_home is not None:
        s._pooled_home.put(sid)


def short_socket(remote: EndPoint, ssl_context=None,
                 connect_timeout_s: float = 1.0) -> Tuple[int, int]:
    return _new_connection(remote, direct_read=True, ssl_context=ssl_context,
                           connect_timeout_s=connect_timeout_s)
