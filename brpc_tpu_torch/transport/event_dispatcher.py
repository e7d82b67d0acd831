"""EventDispatcher -- the port's completion notification for the Python
transport, the twin of ``brpc_tpu/transport/event_dispatcher.py`` (brpc's
``event_dispatcher_epoll.cpp:59,157,190-218``): one thread blocks in
epoll and, on readiness, wakes the socket's consumer *fiber*; it never
runs user code itself.

- Read interest is persistent (:meth:`EventDispatcher.add_consumer`) but
  suspended when an event fires and re-armed by
  :meth:`EventDispatcher.rearm_read` once the consumer is done, so the
  poller does not fire again while the consumer works.  Write interest
  is one-shot (:meth:`EventDispatcher.add_epollout`), for ``Socket``'s
  keep-write parking (brpc's ``WaitEpollOut``).  Every registration is
  ``EPOLLONESHOT``: the kernel suspends a descriptor as it reports it,
  and the loop arms again whatever interest is left.
- Stale descriptors: an operation on a descriptor closed under it
  (EBADF, or ENOENT once the kernel dropped it) drops its interest
  quietly; a new consumer on a descriptor number closed and reused
  behind a stale registration registers anew.

Divergences from the JAX dispatcher, which runs on :mod:`selectors` and
queues every change made from another thread through a self-pipe for
its loop to apply: the port calls ``epoll_ctl`` at once, under the
dispatcher's lock (the kernel takes a change while the loop waits), and
its self-pipe only wakes the loop to stop.  A consumer's re-arm is then
one system call, where the JAX one costs the loop a wake-up and a pass:
with the queued re-arm the default Server's 1 MiB device echoes ran
369-499 calls/s against the engine's 597-873 (``chip_smoke.py`` phases
17 (e) and 18 (e), NVIDIA H100 80GB HBM3, 700 W).  And a new consumer
always registers anew, where the JAX
``modify`` keeps a stale registration whose events and data match (the
selector then skips the kernel call, and a reused descriptor is never
polled).  Linux only, as brpc's epoll dispatcher.
"""

from __future__ import annotations

import errno
import os
import select
import socket as _socket
import threading
from typing import Callable, Dict, Optional

from ..butil.logging_util import LOG

_IN = select.EPOLLIN | select.EPOLLRDHUP
_OUT = select.EPOLLOUT
_ERR = select.EPOLLERR | select.EPOLLHUP


class EventDispatcher:
    def __init__(self, name: str = "event_dispatcher"):
        self._ep = select.epoll()
        self._name = name
        self._lock = threading.Lock()
        self._wakeup_r, self._wakeup_w = os.pipe()
        os.set_blocking(self._wakeup_r, False)
        self._ep.register(self._wakeup_r, select.EPOLLIN)
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        # fd -> [read_cb or None, one-shot write_cb or None, read_armed]
        self._interest: Dict[int, list] = {}

    # -- public API --------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._run, name=self._name, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stopped = True
        try:
            os.write(self._wakeup_w, b"\0")
        except OSError:
            pass
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

    def add_consumer(self, sock: _socket.socket,
                     on_readable: Callable) -> None:
        """Read interest for ``sock`` (≈ ``AddConsumer``): ``on_readable()``
        must not block the dispatcher (it only wakes a fiber).  Suspended
        when an event fires, re-armed by :meth:`rearm_read`."""
        fd = sock.fileno()
        with self._lock:
            ent = self._interest.setdefault(fd, [None, None, True])
            ent[0] = on_readable
            ent[2] = True
            self._arm(fd, ent, fresh=True)
        self.start()

    def rearm_read(self, fd: int) -> None:
        """The consumer is done: read interest again (bytes that arrived
        meanwhile fire at once)."""
        with self._lock:
            ent = self._interest.get(fd)
            if ent is not None and ent[0] is not None:
                ent[2] = True
                self._arm(fd, ent)

    def remove_consumer(self, sock: _socket.socket) -> None:
        fd = sock.fileno()
        with self._lock:
            if self._interest.pop(fd, None) is not None:
                self._unregister(fd)

    def add_epollout(self, sock: _socket.socket,
                     on_writable: Callable) -> None:
        """One-shot write-readiness callback (≈ ``RegisterEvent`` with
        EPOLLOUT, for ``WaitEpollOut``)."""
        fd = sock.fileno()
        with self._lock:
            ent = self._interest.get(fd)
            fresh = ent is None
            if fresh:
                ent = self._interest[fd] = [None, None, False]
            ent[1] = on_writable
            self._arm(fd, ent, fresh=fresh)
        self.start()

    def watched_fds(self) -> int:
        """Descriptors with a read or write interest (``/sockets``)."""
        return len(self._interest)

    # -- internals (under self._lock) --------------------------------------

    def _unregister(self, fd: int) -> None:
        try:
            self._ep.unregister(fd)
        except (OSError, ValueError):
            pass

    def _arm(self, fd: int, ent: list, fresh: bool = False) -> None:
        """Apply ``fd``'s interest.  ``fresh`` (a new consumer or waiter)
        registers anew over any stale registration of the number."""
        events = (_IN if ent[0] is not None and ent[2] else 0) \
            | (_OUT if ent[1] is not None else 0)
        if not events:
            if ent[0] is None and ent[1] is None:
                self._interest.pop(fd, None)
                self._unregister(fd)
            return              # one-shot: the kernel already suspended it
        events |= select.EPOLLONESHOT
        try:
            if fresh:
                self._unregister(fd)
                self._ep.register(fd, events)
            else:
                self._ep.modify(fd, events)
        except OSError as e:
            # closed under us (EBADF), or dropped by the kernel when it
            # closed (ENOENT): the interest is stale, set_failed owns
            # the cleanup
            self._interest.pop(fd, None)
            if e.errno not in (errno.EBADF, errno.ENOENT):
                LOG.warning("dispatcher: fd %d: %s", fd, e)

    def _run(self) -> None:
        while not self._stopped:
            try:
                events = self._ep.poll(1.0)
            except InterruptedError:
                continue
            for fd, mask in events:
                if fd == self._wakeup_r:
                    try:
                        while os.read(self._wakeup_r, 4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    continue
                with self._lock:
                    ent = self._interest.get(fd)
                    if ent is None:
                        continue
                    write_cb = read_cb = None
                    if mask & (_OUT | _ERR) and ent[1] is not None:
                        write_cb, ent[1] = ent[1], None
                    if mask & (_IN | _ERR) and ent[0] is not None \
                            and ent[2]:
                        read_cb = ent[0]
                        ent[2] = False  # until the consumer re-arms
                    if (ent[0] is not None and ent[2]) or ent[1] is not None:
                        self._arm(fd, ent)      # what did not fire
                    elif ent[0] is None:
                        # a write waiter's registration, now spent
                        del self._interest[fd]
                        self._unregister(fd)
                if write_cb is not None:
                    try:
                        write_cb()
                    except Exception:
                        LOG.exception("epollout callback failed")
                if read_cb is not None:
                    try:
                        read_cb()
                    except Exception:
                        LOG.exception("readable callback failed")
        try:
            self._ep.close()
            os.close(self._wakeup_r)
            os.close(self._wakeup_w)
        except OSError:
            pass


_global: Optional[EventDispatcher] = None
_global_lock = threading.Lock()


def global_dispatcher() -> EventDispatcher:
    """The process's one dispatcher (its thread starts on first use)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = EventDispatcher()
            _global.start()
        return _global
