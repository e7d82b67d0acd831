"""Client completion lane -- the Python half of the engine's ClientDemux.

The port of ``brpc_tpu/transport/client_lane.py``.  A ``"single"``
connection attached to the lane (``socket_map``'s ``prefer_lane``) has
its reads owned by one native epoll loop (``native.ClientDemux``, the
engine's ``engine.cpp``): the engine parses the response frames of a
read burst in C++, matches each by correlation id against a native
in-flight table (:func:`lane_expect` before the request is written,
:func:`lane_cancel` when the call ends) and delivers the burst in one
callback.

Per item of a burst:

* **a plain success** (correlation id, attachment size and fabric domain
  in the meta, nothing else) completes here: no frame cut and no
  ``RpcMeta`` decode; the response goes to the call waiting on its
  correlation id (``socket_map.hand_over``).  In the port that hand-off
  is a queue put and an event set, so it runs on the demux thread for
  every call: a call with ``done`` runs its callback on the call's own
  thread, never on the demux loop (the JAX lane hops such a call to a
  fiber worker for the same reason).
* **anything else** -- error responses, compressed, shm and descriptor
  shapes, stream grants, stream frames, unknown correlation ids -- goes
  back to the port's Python demux byte for byte: the engine hands over
  the exact wire bytes under a named reason (:data:`REASONS`, the closed
  ``CliFb`` enum of ``engine.cpp``, in its order), and they are read as
  whole frames (``socket_map.process_client_msg``), serialized per
  connection on an ``ExecutionQueue``.
* **unknown magic** -- the lane detaches the connection and converts it
  to the classic dispatcher (``socket_map.dispatch_client``: the client
  messenger cuts the buffered bytes first), as the JAX lane does.

With ``rpc_native_client_lane`` off, or with no engine, the dispatcher
reads a connection, as in the JAX package; each such choice is counted
in :func:`client_lane_telemetry`'s ``declined`` under a named reason
(:data:`DECLINE_REASONS`).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

from ..butil.flags import define_flag, get_flag
from ..butil.logging_util import LOG
from ..butil.status import Errno
from ..bvar.multi_dimension import PassiveDimension
from ..bvar.passive_status import PassiveStatus

define_flag("rpc_native_client_lane", True,
            "route eligible client sockets' response demux through the "
            "native engine's ClientDemux (batched completion delivery); "
            "off = the classic dispatcher for every socket",
            validator=lambda v: isinstance(v, bool))
define_flag("rpc_client_lane_loops", 0,
            "ClientDemux loops in the process-wide client lane (each "
            "owns an epoll loop + thread; sockets spread round-robin).  "
            "0 = auto: cores//2 capped at 4, min 1.  Read once at lane "
            "creation",
            validator=lambda v: isinstance(v, int) and 0 <= v <= 16)

# the closed fallback reason enum -- MUST mirror engine.cpp's CliFb order
REASONS = ("cli_unknown_cid", "cli_meta_unparsed", "cli_meta_tags",
           "cli_stream_frame", "cli_unknown_magic")
# why a connection that asked for the lane is read by the dispatcher instead
DECLINE_REASONS = ("lane_flag_off", "lane_no_engine", "lane_tls",
                   "lane_attach_failed")

_lane: Optional["ClientLane"] = None
_lane_lock = threading.Lock()
_lane_failed = False
_declines: Dict[str, int] = {}
_declines_lock = threading.Lock()


def _auto_lane_loops() -> int:
    return max(1, min(4, (os.cpu_count() or 1) // 2))


def _decline(reason: str) -> bool:
    with _declines_lock:
        _declines[reason] = _declines.get(reason, 0) + 1
    return False


def global_client_lane(create: bool = True) -> Optional["ClientLane"]:
    """The process-wide client lane, created on the first attach
    (``create=False`` returns the existing one only)."""
    global _lane, _lane_failed
    if _lane is not None or not create or _lane_failed:
        return _lane
    with _lane_lock:
        if _lane is None and not _lane_failed:
            try:
                from ..native import load
                mod = load()
                if mod is None or not hasattr(mod, "ClientDemux"):
                    raise RuntimeError("native module has no ClientDemux")
                _lane = ClientLane(mod)
            except Exception:
                _lane_failed = True
                return None
    return _lane


def try_attach(sock) -> bool:
    """Give ``sock``'s reads to the lane; False (counted under its
    reason) when the caller must read it another way."""
    if not get_flag("rpc_native_client_lane", True):
        return _decline("lane_flag_off")
    if sock.ssl_context is not None:
        return _decline("lane_tls")
    lane = global_client_lane()
    if lane is None:
        return _decline("lane_no_engine")
    if not lane.attach(sock):
        return _decline("lane_attach_failed")
    return True


def lane_expect(sock, cid: int) -> None:
    """Register an in-flight cid of a lane-attached socket (no-op
    otherwise).  Before the request write: a response racing the
    registration would demux as ``cli_unknown_cid``."""
    if sock.lane_token:
        lane = _lane
        if lane is not None:
            lane.expect(sock, cid)


def lane_cancel(sock, cid: int) -> None:
    """Drop an in-flight registration at the call's end (no-op when the
    socket is not lane-attached or the entry completed natively)."""
    if sock.lane_token:
        lane = _lane
        if lane is not None:
            lane.cancel(sock, cid)


def pending_inflight() -> int:
    """In-flight entries still registered across the demux pool (0 when
    the lane was never created)."""
    lane = _lane
    if lane is None:
        return 0
    return sum(int(d.pending()) for d in lane._demuxes)


def drain_settle(deadline_mono_s: float) -> int:
    """Wait, bounded by the drain deadline (monotonic seconds), for the
    in-flight tables to empty; the entries still pending then."""
    ev = threading.Event()
    while True:
        n = pending_inflight()
        if n == 0 or time.monotonic() >= deadline_mono_s:
            return n
        ev.wait(0.005)     # timed: the drain path stays deadline-bound


def client_lane_telemetry() -> dict:
    """The lane's native counters merged across the demux pool, plus the
    ``declined`` reasons: scalars sum, the fallbacks dict sums per
    reason, the completions-per-burst histogram merges bucket-wise, and
    ``loops`` lists each loop's bursts.  Empty when no connection ever
    asked for the lane."""
    with _declines_lock:
        declined = {r: _declines.get(r, 0) for r in DECLINE_REASONS}
    lane = _lane
    snaps = []
    if lane is not None:
        try:
            snaps = [d.telemetry() for d in lane._demuxes]
        except Exception:
            snaps = []
    if not snaps:
        return {"declined": declined} if any(declined.values()) else {}
    out = dict(snaps[0])
    for s in snaps[1:]:
        for k, v in s.items():
            if isinstance(v, dict):
                base = dict(out.get(k, {}))
                for rk, rv in v.items():
                    base[rk] = base.get(rk, 0) + rv
                out[k] = base
            elif isinstance(v, list):
                prev = out.get(k) or []
                out[k] = [a + b for a, b in zip(prev, v)]
            else:
                out[k] = out.get(k, 0) + v
    out["demux_loops"] = len(snaps)
    out["loops"] = [{"bursts": s.get("bursts", 0),
                     "completions": s.get("completions", 0),
                     "attached": s.get("attached", 0),
                     "py_bursts": lane._loop_bursts[i]}
                    for i, s in enumerate(snaps)]
    out["declined"] = declined
    return out


# the families exist in /vars and /metrics from the first scrape
_fallback_var = PassiveDimension(
    ("reason",),
    lambda: client_lane_telemetry().get(
        "fallbacks", {r: 0 for r in REASONS}),
    name="native_client_fallback_total")
_completions_var = PassiveStatus(
    lambda: client_lane_telemetry().get("completions", 0),
    name="native_client_completions")
_bursts_var = PassiveStatus(
    lambda: client_lane_telemetry().get("bursts", 0),
    name="native_client_bursts")


class ClientLane:
    """A pool of ClientDemux loops, each on a thread of its own, and the
    token -> socket routing.  Tokens are process-unique, so one table
    serves every loop; a socket stays on one loop for its life."""

    def __init__(self, mod):
        self._m = mod
        nloops = int(get_flag("rpc_client_lane_loops", 0)) \
            or _auto_lane_loops()
        self._demuxes = [mod.ClientDemux(self._bind_burst(i))
                         for i in range(nloops)]
        self._socks: Dict[int, int] = {}     # token -> socket id
        self._demux_of: Dict[int, int] = {}  # token -> demux index
        self._queues: Dict[int, Any] = {}    # token -> ExecutionQueue
        self._lock = threading.Lock()
        self._rr = 0
        self._loop_bursts = [0] * nloops     # each written by its loop
        self._threads = []
        for i, d in enumerate(self._demuxes):
            t = threading.Thread(target=d.run_loop,
                                 name=f"client-lane-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def _bind_burst(self, idx: int):
        return lambda token, status, comps, fbs, acks, _i=idx: \
            self._on_loop_burst(token, status, comps, fbs, acks, _idx=_i)

    # -- attach / detach ---------------------------------------------------

    def attach(self, sock) -> bool:
        """Take over the reads of ``sock``; False when it cannot (no
        plain descriptor, failed, the engine refused)."""
        fd = sock.fd
        if fd is None:
            return False
        # the demux reads a dup of the descriptor, which shares its
        # O_NONBLOCK: Python's writes must poll, so they get a timeout
        from .socket_map import LANE_WRITE_TIMEOUT_S
        fd.settimeout(LANE_WRITE_TIMEOUT_S)
        with self._lock:
            idx = self._rr % len(self._demuxes)
            self._rr += 1
        demux = self._demuxes[idx]
        try:
            token = demux.attach(fd.fileno())
        except (OSError, ValueError):
            return False
        # routing state before arming: the first burst must find it
        with self._lock:
            self._socks[token] = sock.id
            self._demux_of[token] = idx
        sock.lane_token = token
        if not demux.arm(token):
            self.detach(sock)
            return False
        return True

    def _demux_for(self, token: int):
        idx = self._demux_of.get(token)
        return self._demuxes[idx] if idx is not None else None

    def detach(self, sock, _stop_queue: bool = True) -> None:
        token = sock.lane_token
        if not token:
            return
        sock.lane_token = 0
        demux = self._demux_for(token)
        with self._lock:
            self._socks.pop(token, None)
            self._demux_of.pop(token, None)
            q = self._queues.pop(token, None)
        if demux is not None:
            demux.detach(token)
        if q is not None and _stop_queue:
            q.stop()

    def expect(self, sock, cid: int) -> None:
        demux = self._demux_for(sock.lane_token)
        if demux is not None:
            demux.expect(sock.lane_token, cid)

    def cancel(self, sock, cid: int) -> None:
        demux = self._demux_for(sock.lane_token)
        if demux is not None:
            demux.cancel(sock.lane_token, cid)

    # -- burst delivery (on the demux loop threads, GIL held) --------------

    def _on_loop_burst(self, token: int, status: int, comps, fbs, acks,
                       _idx: int = 0) -> None:
        """The demux's burst callback (through :meth:`_bind_burst`), on
        demux loop ``_idx``: everything reachable from here is
        loop-thread code, which ``tools/check``'s blocking analyzer
        walks."""
        self._loop_bursts[_idx] += 1
        from .socket import Socket
        with self._lock:
            sid = self._socks.get(token)
        sock = Socket.address(sid) if sid is not None else None
        if sock is None or sock.lane_token != token:
            return                    # detached under us
        try:
            if acks:
                from ..ici.endpoint import process_ack
                process_ack(acks, sock)
            if comps:
                self._complete_burst(sock, comps)
            if fbs or status:
                self._enqueue_classic(token, sock, fbs, status)
        except Exception:
            LOG.exception("client lane burst delivery failed")

    @staticmethod
    def _complete_burst(sock, comps) -> None:
        """Plain successes, in arrival order, to their waiting calls."""
        from ..protocol.meta import RpcMeta
        from .socket_map import hand_over
        for cid, buf, att, dom in comps:
            meta = RpcMeta()
            meta.correlation_id = cid
            meta.attachment_size = att
            if dom:
                meta.ici_domain = bytes(dom)
            mv = memoryview(buf)
            split = len(mv) - att
            hand_over(sock, (meta, bytes(mv[:split]), bytes(mv[split:])))

    # -- the Python demux fallback (byte for byte) -------------------------

    def _queue_for(self, token: int, sock):
        with self._lock:
            q = self._queues.get(token)
            if q is not None:
                return q
        from ..fiber.execution_queue import ExecutionQueue

        def executor(it, _sock=sock):
            for kind, payload in it:
                try:
                    if kind == 0:          # one whole frame
                        _classic_frame(_sock, payload)
                    elif kind == 1:        # to the classic dispatcher
                        if not _sock.failed:
                            _convert_to_dispatcher(_sock, payload)
                    else:                  # the connection is gone
                        _sock.set_failed(*payload)
                except Exception:
                    LOG.exception("client lane fallback dispatch failed")

        q = ExecutionQueue(executor, name=f"client_lane_{token}")
        with self._lock:
            q = self._queues.setdefault(token, q)
        return q

    def _enqueue_classic(self, token: int, sock, fbs, status: int) -> None:
        """Fallback frames to the Python demux, serialized per
        connection; a terminal status rides the same queue, so a
        response already on the wire wins against the EOF after it."""
        q = self._queue_for(token, sock)
        prefix = None
        for reason, raw in fbs or ():
            if reason == self._m.CFB_UNKNOWN_MAGIC:
                prefix = raw               # everything from here on
            else:
                q.execute((0, bytes(raw)))
        if prefix is not None:
            # sticky: detach first (on the demux thread: no further lane
            # read can race), then the dispatcher takes over after the
            # queued frames, the buffered bytes first
            self.detach(sock, _stop_queue=False)
            q.execute((1, bytes(prefix)))
            return
        if status:
            code = int(Errno.EEOF) if status == 1 \
                else int(Errno.EFAILEDSOCKET)
            text = "remote closed connection" if status == 1 \
                else "client lane transport error"
            q.execute((2, (code, text)))
            self.detach(sock, _stop_queue=False)


def _convert_to_dispatcher(sock, prefix) -> None:
    """The lane's sticky conversion of an unknown-magic connection: the
    bytes it read (from the unknown magic on) into the socket's portal,
    then the client messenger and the dispatcher own the reads."""
    from ..butil.iobuf import IOPortal
    from .socket_map import dispatch_client
    if sock.read_portal is None:
        sock.read_portal = IOPortal()
    sock.read_portal.append(bytes(prefix))
    dispatch_client(sock)


def _classic_frame(sock, raw: bytes) -> None:
    """One whole frame the lane handed back."""
    from ..protocol.tpu_std import read_frame
    from .socket_map import Replay, process_client_msg
    process_client_msg(sock, read_frame(Replay(raw)))
