"""Streaming RPC — ordered message streams with credit flow control.

The port's copy of ``brpc_tpu/streaming.py``.  A stream is set up over a
normal RPC: the client sends its stream id and receive window in the
request meta (:func:`stream_create` before the call), the server answers
with its own (:func:`stream_accept` inside the method), and from then on
both sides exchange ``TSTR`` frames (:mod:`.protocol.streaming`) on the
same connection.

- Flow control is a credit window: a writer blocks while ``produced -
  remote_consumed >= window`` (the peer's advertised receive buffer) and
  returns ``EOVERCROWDED`` when the window stays full past
  ``write_timeout_s``.  The receiver counts a message consumed when it is
  dequeued for its handler and sends an ``F_FEEDBACK`` ack each time half
  a window more was consumed.
- Messages reach ``on_received`` in order, in batches, from a per-stream
  queue that one long-lived thread drains.
- ``close(reason=...)`` sends an ordered ``F_CLOSE`` whose payload names
  the reason; the peer hands it to ``on_closed`` after every message sent
  before it.  A connection that closes closes every stream bound to it.
- The server drain (``brpc_tpu/streaming.py:267``, ``:357-375``): a
  stream accepted on a server is tagged with it; :func:`server_streams`
  lists a server's live streams and :func:`drain_server_streams` closes
  each with ``drain_close``, a bounded settle of its current window and
  then an ``F_CLOSE`` carrying ``lame_duck``.  The port's streams share
  one settle window where the JAX package gives each its own in turn,
  so a drain of N streams waits 0.25 s, not N times that.  A stream open that
  reaches a draining server is refused by admission (``ELAMEDUCK``)
  before the handler could accept it, so the client's pending stream
  closes with the failed call, as in the JAX package.

- The native write lane (``brpc_tpu/streaming.py:90-93``, ``:155-175``):
  a stream accepted on the native engine's kind-5 lane is registered
  with the engine (``server/stream_slim.py``) and ``_native_tx`` names
  that engine.  ``write`` then goes through ``engine.stream_write``,
  whose credit window lives in C++ (-1 is ``EOVERCROWDED``, anything
  else a closed stream or connection), a drain's settle skips the Python
  ledger (the engine's write queue orders the FIN after the data), and
  the close unregisters the stream from the engine before its FIN.
"""

from __future__ import annotations

import itertools
import logging
import os
import struct
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from .butil.status import Errno
from .protocol.streaming import (F_CLOSE, F_DATA, F_FEEDBACK, F_RST,
                                 pack_stream_frame)
from .transport.socket import Socket

LOG = logging.getLogger(__name__)

DEFAULT_WINDOW = 2 * 1024 * 1024
_SETTLE_CAP_S = 0.25        # a draining stream's window settle, at most
_CLOSE_SENTINEL = object()     # ordered close marker in the deliver queue


class StreamOptions:
    __slots__ = ("max_buf_size", "on_received", "on_closed",
                 "write_timeout_s")

    def __init__(self,
                 on_received: Optional[Callable] = None,
                 on_closed: Optional[Callable] = None,
                 max_buf_size: int = DEFAULT_WINDOW,
                 write_timeout_s: float = 30.0):
        self.on_received = on_received      # (stream, [bytes, ...])
        self.on_closed = on_closed          # (stream)
        self.max_buf_size = max_buf_size
        self.write_timeout_s = write_timeout_s


_streams_lock = threading.Lock()
_streams: Dict[int, "Stream"] = {}
# ids start at a random odd 48-bit offset, so they cannot be enumerated
# from a fresh connection; frames for a stream on another socket are
# dropped besides (protocol.streaming.dispatch)
_next_id = itertools.count(int.from_bytes(os.urandom(6), "little") | 1)


def _register(stream: "Stream") -> int:
    with _streams_lock:
        sid = next(_next_id)
        _streams[sid] = stream
    return sid


def find_stream(stream_id: int) -> Optional["Stream"]:
    return _streams.get(stream_id)


class _DeliverQueue:
    """Items handed to ``fn`` in order, in batches, by one thread that the
    first item starts and that lives as long as the stream.  ``stop``
    refuses new items; the thread delivers those already queued, then
    exits."""

    def __init__(self, fn: Callable, name: str):
        self._fn = fn
        self._name = name
        self._items: deque = deque()
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    def execute(self, item) -> bool:
        with self._cond:
            if self._stopped:
                return False
            self._items.append(item)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._drain, name=self._name, daemon=True)
                self._thread.start()
            else:
                self._cond.notify()
        return True

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify()

    def _drain(self) -> None:
        while True:
            with self._cond:
                self._cond.wait_for(lambda: self._items or self._stopped)
                if not self._items:
                    return
                batch, self._items = list(self._items), deque()
            try:
                self._fn(batch)
            except Exception:
                LOG.exception("stream delivery raised")


class Stream:
    def __init__(self, options: Optional[StreamOptions] = None):
        self.options = options or StreamOptions()
        self.id = _register(self)
        self.socket_id = 0
        self.peer_stream_id = 0
        # the named close reason: set by close(reason=...) or from the
        # peer's F_CLOSE payload; on_closed reads it
        self.close_reason: Optional[str] = None
        self._server = None             # the server that accepted it
        # the native engine owning the write-side credit window of a
        # kind-5 stream (server/stream_slim.py sets it); None = the
        # Python credit path below
        self._native_tx = None
        self._established = threading.Event()
        self._closed = False
        self._close_lock = threading.Lock()
        # writer side: the window is the peer's advertised receive buffer
        # (set at bind; our own size until then).  An RLock: a failed send
        # inside write() re-enters through _close_local's notify
        self._cond = threading.Condition(threading.RLock())
        self._write_window = self.options.max_buf_size
        self._produced = 0
        self._remote_consumed = 0
        # receiver side: acks count messages dequeued for the handler, so
        # a slow handler holds the writer back instead of growing the queue
        self._consumed = 0
        self._acked = 0
        self._deliver = _DeliverQueue(self._deliver_batch,
                                      f"stream-{self.id:x}")

    # -- establishment -----------------------------------------------------

    def _attach(self, socket_id: int) -> bool:
        """Bind to a connection: frames from other sockets are dropped from
        now on, and the connection's close closes this stream.  False (and
        the stream closed) when the connection is already gone."""
        self.socket_id = socket_id
        sock = Socket.address(socket_id)
        if sock is not None and sock.bind_stream(self):
            return True
        self._on_conn_broken()
        return False

    def _bind(self, socket_id: int, peer_stream_id: int,
              peer_window: int = 0) -> None:
        """The handshake's end: the peer's stream id and window are known
        and writes may start."""
        self.peer_stream_id = peer_stream_id
        if peer_window > 0:
            self._write_window = peer_window
        if self.socket_id != socket_id and not self._closed:
            self._attach(socket_id)
        self._established.set()
        self._maybe_ack()           # messages consumed before the bind

    def wait_established(self, timeout: float = 10.0) -> bool:
        return self._established.wait(timeout)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- write side --------------------------------------------------------

    def write(self, data) -> int:
        """Ordered write of one message; blocks while the peer's window is
        full.  0, or ``EOVERCROWDED`` (window full past the write timeout),
        ``EEOF`` (closed) or ``EFAILEDSOCKET``."""
        if isinstance(data, str):
            data = data.encode()
        if not self._established.wait(self.options.write_timeout_s):
            return int(Errno.EINTERNAL)
        if self._closed:
            return int(Errno.EEOF)
        engine = self._native_tx
        if engine is not None:
            st = engine.stream_write(
                self.id, bytes(data),
                int(self.options.write_timeout_s * 1000))
            if st == 0:
                return 0
            if st == -1:
                return int(Errno.EOVERCROWDED)   # credit exhaustion
            self._on_conn_broken()               # closed / conn gone
            return int(Errno.EEOF)
        with self._cond:
            # admit while any credit remains: requiring room for the whole
            # message would deadlock messages larger than the window
            ok = self._cond.wait_for(
                lambda: self._closed or
                self._produced - self._remote_consumed < self._write_window,
                timeout=self.options.write_timeout_s)
            if self._closed:
                return int(Errno.EEOF)
            if not ok:
                return int(Errno.EOVERCROWDED)
            self._produced += len(data)
            # sent under _cond: writers woken together reach the socket in
            # the order they reserved credit
            return self._send_frame(F_DATA, bytes(data))

    def _send_frame(self, flags: int, payload: bytes = b"") -> int:
        sock = Socket.address(self.socket_id)
        if sock is None or sock.failed:
            self._on_conn_broken()
            return int(Errno.EFAILEDSOCKET)
        try:
            sock.write(pack_stream_frame(flags, self.peer_stream_id,
                                         payload))
        except OSError:
            self._on_conn_broken()
            return int(Errno.EFAILEDSOCKET)
        return 0

    # -- frame ingestion (protocol.streaming.dispatch) ---------------------

    def on_frame(self, flags: int, payload: bytes) -> None:
        if flags == F_DATA:
            self._deliver.execute(payload)
        elif flags == F_FEEDBACK:
            (consumed,) = struct.unpack_from("<Q", payload)
            with self._cond:
                if consumed > self._remote_consumed:
                    self._remote_consumed = consumed
                    self._cond.notify_all()
        elif flags == F_RST:
            self._close_local(notify_peer=False)
        elif flags == F_CLOSE:
            # ordered: data cut before the FIN reaches on_received first
            if payload and self.close_reason is None:
                self.close_reason = payload.decode("utf-8", "replace")
            self._deliver.execute(_CLOSE_SENTINEL)

    def _deliver_batch(self, items) -> None:
        close_after = any(m is _CLOSE_SENTINEL for m in items)
        msgs = [m for m in items if m is not _CLOSE_SENTINEL]
        if msgs:
            # consumed = dequeued: ack before the handler, so a handler
            # that writes back and waits for credit cannot stall its acks
            self._consumed += sum(len(m) for m in msgs)
            self._maybe_ack()
            if self.options.on_received is not None:
                try:
                    self.options.on_received(self, msgs)
                except Exception:
                    LOG.exception("stream on_received raised")
        if close_after:
            self._close_local(notify_peer=False)

    def _maybe_ack(self) -> None:
        """An F_FEEDBACK once half a window more was consumed.  Before the
        bind the peer's id is unknown: the ack waits for it."""
        if (self._consumed - self._acked >= self.options.max_buf_size // 2
                and self.peer_stream_id and not self._closed):
            self._acked = self._consumed
            self._send_frame(F_FEEDBACK, struct.pack("<Q", self._consumed))

    # -- teardown ----------------------------------------------------------

    def close(self, reason: Optional[str] = None) -> None:
        """Graceful: an F_CLOSE carrying ``reason`` to the peer, then the
        local close."""
        self._close_local(notify_peer=True, reason=reason)

    def drain_close(self, reason: str, settle_timeout_s: float) -> None:
        """The drain's close: give the current window a short bounded
        settle (a producer mid-window may finish), then close with the
        named ``reason``.  The ``F_CLOSE`` follows every data frame
        already written, so delivery never truncates; the wait is capped
        at 0.25 s, well below a drain's grace, because receivers ack at
        half-window granularity and ``produced == consumed`` may never
        hold."""
        if self._closed:
            return
        if self._native_tx is None:
            # a native-lane stream's ledger lives in the engine, whose
            # write queue orders the FIN after the data
            cap = min(max(settle_timeout_s, 0.0), _SETTLE_CAP_S)
            with self._cond:
                self._cond.wait_for(
                    lambda: self._closed
                    or self._produced <= self._remote_consumed,
                    timeout=cap)
        self.close(reason=reason)

    def _close_local(self, notify_peer: bool,
                     reason: Optional[str] = None) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        if reason is not None and self.close_reason is None:
            self.close_reason = reason
        engine = self._native_tx
        if engine is not None:
            # off the kind-5 lane FIRST: a racing producer fails fast
            # instead of writing after the FIN
            self._native_tx = None
            try:
                engine.stream_unregister(self.id)
            except Exception:
                pass
        if notify_peer and self.peer_stream_id:
            self._send_frame(F_CLOSE, reason.encode() if reason else b"")
        with self._cond:
            self._cond.notify_all()
        sock = Socket.address(self.socket_id)
        if sock is not None:
            sock.unbind_stream(self.id)
        with _streams_lock:
            _streams.pop(self.id, None)
        self._deliver.stop()
        if self.options.on_closed is not None:
            try:
                self.options.on_closed(self)
            except Exception:
                LOG.exception("stream on_closed raised")

    def _on_conn_broken(self) -> None:
        self._close_local(notify_peer=False)


# -- establishment helpers (≈ StreamCreate / StreamAccept) ----------------

def stream_create(cntl, options: Optional[StreamOptions] = None) -> Stream:
    """Client side, before the call: the stream rides the controller's
    request and the response binds it."""
    s = Stream(options)
    cntl._stream_to_create = s
    return s


def stream_accept(cntl, options: Optional[StreamOptions] = None
                  ) -> Optional[Stream]:
    """Server side, inside the method: accept the request's stream, or
    None when the request carries none."""
    peer_id = getattr(cntl, "_remote_stream_id", 0)
    if not peer_id:
        return None
    s = Stream(options)
    s._server = getattr(cntl, "server", None)   # the drain's enumeration
    s._bind(cntl.socket_id, peer_id,
            peer_window=cntl.request_meta.stream_window)
    cntl._accepted_stream_id = s.id
    cntl._accepted_stream_window = s.options.max_buf_size
    return s


def server_streams(server) -> List[Stream]:
    """Live streams accepted by ``server``."""
    with _streams_lock:
        return [s for s in _streams.values() if s._server is server]


def drain_server_streams(server, deadline_mono: float,
                         reason: str = "lame_duck") -> int:
    """End every live stream a draining server accepted: each gets the
    bounded window settle, then an ``F_CLOSE`` carrying ``reason``.  The
    streams share one settle window (at most ``drain_close``'s 0.25 s,
    within ``deadline_mono``, the drain's grace): their producers run on
    during it, so N streams settle in one window, not N.  Returns how
    many streams were closed."""
    window_end = min(deadline_mono, time.monotonic() + _SETTLE_CAP_S)
    n = 0
    for s in server_streams(server):
        s.drain_close(reason, settle_timeout_s=max(
            window_end - time.monotonic(), 0.0))
        n += 1
    return n
