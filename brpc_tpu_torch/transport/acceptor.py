"""Acceptor -- turns a listening socket into dispatcher-driven connection
Sockets.

The port of ``brpc_tpu/transport/acceptor.py`` (brpc's
``acceptor.cpp:50,243,327``): the listener is itself a Socket whose
consumer fiber accepts until EAGAIN, and each accepted connection becomes
a Socket read by the dispatcher through the server's ``InputMessenger``
(``on_new_messages``), tagged with the acceptor's tag (``"internal"`` on a
server's internal port).  A TLS server's connections are wrapped on a
fiber of their own, the handshake bounded by 5 s, so the accept loop
never waits behind a slow peer; a plaintext client fails the handshake
and is closed.  A connection whose consumer sees it fail (EOF, bytes no
protocol claims) is released at once, its descriptor closed;
:meth:`Acceptor.connection_count` and :meth:`Acceptor.live_sockets`
read the live connections (releasing any other failed one, as the JAX
acceptor's sweep does), :meth:`Acceptor.pause_accept` takes the listener off the
dispatcher with its descriptor open and bound (new connections wait in
the kernel's backlog), :meth:`Acceptor.resume_accept` arms it again, and
:meth:`Acceptor.stop_accept` closes the listener and every connection.
The listener leaves the dispatcher before its descriptor closes, and is
never shut down: a hot-restart successor may serve the same listening
socket through a descriptor of its own (``server/hot_restart.py``).

Divergences: ``resume_accept`` is the port's (a drained server that is
started again serves its backlog), and the JAX acceptor releases a
failed connection only at its next sweep.
"""

from __future__ import annotations

import socket as _socket
import threading
from typing import Dict, List, Optional

from ..butil.endpoint import EndPoint
from ..butil.logging_util import LOG
from ..butil.status import Errno
from ..fiber import runtime as fiber_runtime
from .event_dispatcher import EventDispatcher, global_dispatcher
from .input_messenger import InputMessenger
from .socket import Socket

TLS_HANDSHAKE_S = 5.0


class _ListenSocket(Socket):
    """The listener's Socket: closing it takes it off the dispatcher and
    closes its descriptor, but never shuts the socket down.  A
    hot-restart successor may hold another descriptor of the same
    listening socket, and a shutdown would end its listen as well."""

    def _shutdown(self) -> None:
        pass


class Acceptor:
    def __init__(self, messenger: InputMessenger,
                 dispatcher: Optional[EventDispatcher] = None,
                 tag: Optional[str] = None,
                 ssl_context=None):
        self._messenger = messenger
        self._dispatcher = dispatcher or global_dispatcher()
        self._tag = tag                  # stamped on accepted sockets
        self._ssl_context = ssl_context  # TLS: wrap accepted connections
        self._listen_sid = 0
        self._conn_lock = threading.Lock()
        self._connections: Dict[int, int] = {}   # sid -> sid (a set)
        self._stopped = False

    @property
    def tag(self) -> Optional[str]:
        return self._tag

    def start_accept(self, listen_fd: _socket.socket) -> int:
        """≈ Acceptor::StartAccept (acceptor.cpp:50)."""
        host, port = listen_fd.getsockname()[:2]
        ep = EndPoint(host=host, port=port)
        s = _ListenSocket(listen_fd, remote_side=ep, local_side=ep)
        self._listen_sid = s.id
        self._stopped = False
        s.dispatch_reads(self._on_new_connections, self._dispatcher)
        return 0

    def _on_new_connections(self, listen_sock: Socket) -> None:
        """≈ OnNewConnections (acceptor.cpp:243): accept until EAGAIN."""
        while not self._stopped:
            try:
                conn, addr = listen_sock.conn.accept()
            except (BlockingIOError, OSError):
                return
            try:
                conn.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            except OSError:
                pass
            remote = EndPoint(host=addr[0], port=addr[1]) \
                if isinstance(addr, tuple) else EndPoint(host=str(addr),
                                                         port=0)
            if self._ssl_context is not None:
                fiber_runtime.spawn(self._tls_accept, conn, remote,
                                    name="tls_accept")
                continue
            self._register(conn, remote)

    def _tls_accept(self, conn: _socket.socket, remote: EndPoint) -> None:
        try:
            conn.settimeout(TLS_HANDSHAKE_S)
            with fiber_runtime.blocking():
                tls = self._ssl_context.wrap_socket(conn, server_side=True)
        except (OSError, ValueError) as e:
            LOG.warning("TLS handshake with %s failed: %s", remote, e)
            try:
                conn.close()
            except OSError:
                pass
            return
        if self._stopped:
            tls.close()
            return
        self._register(tls, remote)

    def _register(self, conn: _socket.socket, remote: EndPoint) -> None:
        try:
            s = Socket(conn, remote_side=remote)
        except OSError:
            conn.close()                # gone before it was registered
            return
        s.tag = self._tag
        with self._conn_lock:
            self._connections[s.id] = s.id
        s.dispatch_reads(self._on_messages, self._dispatcher)

    def _on_messages(self, sock: Socket) -> None:
        """The connection's consumer: the messenger, and the connection
        released as soon as it has failed (the peer closed it, or sent
        bytes no protocol claims), its descriptor with it."""
        self._messenger.on_new_messages(sock)
        if sock.failed:
            with self._conn_lock:
                self._connections.pop(sock.id, None)
            sock.release()

    def connection_count(self) -> int:
        self._gc()
        with self._conn_lock:
            return len(self._connections)

    def _gc(self) -> None:
        with self._conn_lock:
            dead = []
            for sid in self._connections:
                s = Socket.address(sid)
                if s is None or s.failed:
                    dead.append((sid, s))
            for sid, _ in dead:
                del self._connections[sid]
        for _, s in dead:
            if s is not None:
                s.release()     # a server's connection is never revived

    def live_sockets(self) -> List[Socket]:
        """The live accepted connections (the drain's force-close at
        grace expiry walks them)."""
        self._gc()
        with self._conn_lock:
            sids = list(self._connections)
        return [s for s in (Socket.address(sid) for sid in sids)
                if s is not None]

    def pause_accept(self) -> None:
        """Drain: accept no NEW connection.  The listener leaves the
        dispatcher but stays open and bound, so the kernel keeps queueing
        connections in its backlog; live connections keep serving."""
        self._stopped = True
        ls = Socket.address(self._listen_sid)
        if ls is not None and ls.conn is not None:
            self._dispatcher.remove_consumer(ls.conn)

    def resume_accept(self) -> None:
        """Accept again after :meth:`pause_accept`, the backlog first."""
        ls = Socket.address(self._listen_sid)
        if ls is None or not self._stopped:
            return
        self._stopped = False
        self._dispatcher.add_consumer(ls.conn, ls.start_input_event)

    def stop_accept(self) -> None:
        """≈ Acceptor::StopAccept: close the listener and every
        connection."""
        self._stopped = True
        ls = Socket.address(self._listen_sid)
        if ls is not None:
            ls.close()
        with self._conn_lock:
            sids = list(self._connections)
            self._connections.clear()
        for sid in sids:
            s = Socket.address(sid)
            if s is not None:
                s.set_failed(int(Errno.ELOGOFF), "server stopping")
                s.release()
