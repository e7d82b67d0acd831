"""Bridge between the native C++ IO engine and the port's RPC stack.

The port's twin of ``brpc_tpu/transport/native_bridge.py``.  The engine
(``brpc_tpu_torch/native``) owns connections, framing and writes; this
module gives each native connection a :class:`NativeSocket` (a
``transport.Socket`` in the same registry, so controllers, streams and
device-attachment acks address it exactly like a connection the Python
transport reads) and routes engine events into the dispatch layers:

    EV_MESSAGE -> server.rpc_dispatch.process_rpc_request, the classic
                  lane the Python transport's messenger runs too (inline
                  on the loop, or on a fiber)
    EV_ACK     -> ici.endpoint.process_ack (descriptor ownership
                  enforced: only acks from the posting connection count)
    EV_STREAM  -> protocol.streaming.dispatch (socket binding checked)
    EV_HTTP    -> one complete HTTP/1.x message cut by the engine;
                  protocol.http parses, the server's HTTP dispatch
                  routes (RPC bridge, restful, builtin portal)
    EV_BYTES   -> passthrough gulp for the protocols the engine does not
                  cut (h2/gRPC, RESP, thrift): the server's InputMessenger cuts and
                  dispatches
    EV_UNKNOWN -> connection failed (malformed sniffed HTTP)

and registers the slim lanes: kinds 0/1 (``@raw_method(native=...)``,
answered in C++), kind 2 (plain ``@raw_method``), kind 3 (unary
``(cntl, request)`` methods, ``server/slim_dispatch.py``), kind 4 (HTTP
routes, ``server/http_slim.py``) and kind 5 (stream opens and chunks,
``server/stream_slim.py``).

Differences from the JAX bridge: the port has no ``rpc_dump`` capture,
so native dispatch is never gated off for it (the ``rpc_dispatch_off``
fallback row stays 0), and the port's socket registry hands out ids
itself (no versioned-id pool).
"""

from __future__ import annotations

import struct
import threading as _threading
from struct import unpack_from as _struct_unpack_from
from time import monotonic as _mono_s
from time import monotonic_ns as _mono_ns
from typing import Any, Dict, Optional

from ..butil.endpoint import EndPoint
from ..butil.flags import define_flag, get_flag, watch_flag
from ..butil.iobuf import IOBuf, IOPortal
from ..butil.logging_util import LOG
from ..butil.status import Errno
from ..bvar.multi_dimension import PassiveDimension as _PassiveDim
from ..fiber import runtime as fiber_runtime
from ..ici.endpoint import process_ack
from ..protocol.meta import TLV_ATTACHMENT, TLV_CORRELATION, RpcMeta
from ..protocol.streaming import StreamFrame
from ..protocol.streaming import dispatch as stream_dispatch
from .socket import Socket

_bytes = bytes


class NativeSocket(Socket):
    """A Socket whose write path is the native engine (no fd on the
    Python side).  Lives in the port's socket registry:
    ``Socket.address()`` resolves it, streams bind to it, device
    attachments post on it and its acks release them."""

    def __init__(self, engine, conn_id: int, remote_side: EndPoint,
                 local_side: EndPoint):
        super().__init__(None, remote_side=remote_side,
                         local_side=local_side)
        self.engine = engine
        self.conn_id = conn_id

    def _send(self, views) -> int:
        """The engine queues the whole frame: it never refuses bytes."""
        try:
            self.engine.send(self.conn_id, tuple(views))
        except ConnectionError:
            self.failed = True
            raise
        return sum(len(v) for v in views)

    def _shutdown(self) -> None:
        try:
            self.engine.close_conn(self.conn_id)
        except (ConnectionError, OSError):
            pass

    def _close_conn(self) -> None:
        self._shutdown()


_NATIVE_KINDS = {"echo": 0, "const": 1}

# -- multi-core engine knobs -------------------------------------------------

define_flag("engine_busy_poll_us", 0,
            "spin this many microseconds on zero-timeout polls before "
            "each blocking epoll_wait in every engine loop (latency-"
            "tail knob; 0 = off).  Burns the loop's core while armed — "
            "only worth it with a core per loop",
            validator=lambda v: isinstance(v, int) and 0 <= v <= 1000000)
define_flag("engine_reuseport", True,
            "shard the native engine's accept across loops with one "
            "SO_REUSEPORT listener per loop (connections pinned to "
            "their accepting loop for life); off = single shared "
            "listener with round-robin adopt handoff",
            validator=lambda v: isinstance(v, bool))
define_flag("rpc_native_stream_lane", True,
            "kind-5 native streaming lane: stream opens dispatch "
            "through the stream shim, chunk bursts enter Python once, "
            "write credit is accounted in C++.  Off = every stream "
            "rides the Python lane (the A/B switch; live-flippable — "
            "already-adopted streams keep their lane)",
            validator=lambda v: isinstance(v, bool))


def default_engine_loops() -> int:
    """Placement-aware loops= default: one loop per core up to 4 (the
    GIL serializes the shim lanes anyway — loops beyond the low single
    digits only buy contention on small boxes; big boxes should set
    ServerOptions.native_loops explicitly)."""
    import os
    return max(1, min(4, os.cpu_count() or 1))

# Closed fallback reason-name mirror — MUST match engine.cpp's kFbNames
# order exactly (tests/test_torch_native_engine.py pins it).
# Pre-seeds the native_engine_fallback_total family so every reason row
# exists in /vars and /metrics from the first scrape, fallback traffic
# or not — the same eager-registration discipline as client_lane's
# REASONS tuple.
FB_REASON_NAMES = (
    "rpc_dispatch_off", "rpc_meta_tag", "rpc_no_method",
    "rpc_att_over_cap", "rpc_large_frame", "rpc_trace_raw_lane",
    "rpc_shm_lane",
    "http_slim_off", "http_malformed_line", "http_version",
    "http_no_route", "http_expect", "http_upgrade", "http_connection",
    "http_transfer_encoding", "http_bad_header", "http_large_body",
    "http_chunk_stream", "http_lame_duck",
)

# kind-5 streaming-lane reasons ride the same engine fallback family;
# the authoritative mirror of kStreamFbNames lives next to the lane
# (server/stream_slim.STREAM_FB_NAMES, pinned by the same test) — the
# fallback_total pre-seed below pulls it lazily so every stream reason
# row exists from the first scrape


# ---------------------------------------------------------------------------
# Engine telemetry plumbing: ONE engine.telemetry() snapshot per
# sampling interval serves every native_engine_* bvar read (/vars,
# /metrics, bvar dump and the /native portal page all walk many vars
# back-to-back; per-var engine calls would each pay a GIL crossing).
# ---------------------------------------------------------------------------

class _TelemetryCache:
    """Short-TTL cache over ``engine.telemetry()``.  ``get()`` returns
    the current snapshot (refreshing at most once per TTL); the
    previous snapshot is retained so windowed reads (busy ratio,
    per-second rates) have an interval to diff against."""

    def __init__(self, engine, ttl_s: float = 0.25):
        self._engine = engine
        self._ttl = ttl_s
        self._lock = _threading.Lock()
        self._snap = None
        self._t = 0.0
        self._prev = None
        self._prev_t = 0.0

    def _refresh_locked(self) -> None:
        now = _mono_s()
        if self._snap is None or now - self._t >= self._ttl:
            snap = self._engine.telemetry()
            self._prev, self._prev_t = self._snap, self._t
            self._snap, self._t = snap, now

    def get(self) -> dict:
        with self._lock:
            self._refresh_locked()
            return self._snap

    def window(self):
        """(prev_snapshot_or_None, current_snapshot, dt_seconds) under
        ONE lock hold — a concurrent refresh between a get() and a
        separate prev read could otherwise pair a snapshot with the
        wrong interval (transient zero rates)."""
        with self._lock:
            self._refresh_locked()
            return (self._prev, self._snap,
                    max(self._t - self._prev_t, 1e-9))

    def busy_ratio(self) -> float:
        """Engine-loop busy fraction (callback time vs epoll_wait) over
        the last snapshot window — the C++ loops' /hotspots answer.
        SUMS across loops: a per-loop view (imbalance!) is
        :meth:`per_loop_busy_ratios`."""
        prev, cur, _dt = self.window()

        def _tot(s):
            return (sum(l["busy_ns"] for l in s["loops"]),
                    sum(l["idle_ns"] for l in s["loops"]))

        busy, idle = _tot(cur)
        if prev is not None:
            pb, pi = _tot(prev)
            busy, idle = busy - pb, idle - pi
        denom = busy + idle
        return busy / denom if denom > 0 else 0.0

    def per_loop_busy_ratios(self) -> list:
        """Windowed busy fraction of EACH loop — the aggregate above
        masks imbalance (one pegged loop + three idle ones reads as
        25% busy); the scaling work keys on the spread."""
        prev, cur, _dt = self.window()
        out = []
        for i, lo in enumerate(cur["loops"]):
            busy, idle = lo["busy_ns"], lo["idle_ns"]
            if prev is not None and i < len(prev["loops"]):
                busy -= prev["loops"][i]["busy_ns"]
                idle -= prev["loops"][i]["idle_ns"]
            denom = busy + idle
            out.append(busy / denom if denom > 0 else 0.0)
        return out

    def loop_busy_imbalance(self) -> float:
        """max − min of the per-loop windowed busy ratios (0 on a
        one-loop engine): the flat-scaling smoking gun — high qps
        plateau + high imbalance = placement problem, not a lock."""
        ratios = self.per_loop_busy_ratios()
        return (max(ratios) - min(ratios)) if len(ratios) > 1 else 0.0


def bucket_label(i: int, nbuckets: int) -> str:
    """Exclusive upper-bound label for log2 bucket i of the engine's
    Hist layout (bucket 0 holds zeros, bucket i covers [2^(i-1), 2^i)).
    Deliberately NOT named ``le``: these are per-bucket counts, not the
    cumulative series Prometheus reserves ``le`` for — ``bin`` keeps
    histogram_quantile() from silently mis-reading them."""
    return "+Inf" if i >= nbuckets - 1 else str(1 << i)

class NativeBridge:
    def __init__(self, server, engine_module, loops: int = 0):
        self._server = server
        self._m = engine_module
        if loops <= 0:
            loops = default_engine_loops()   # placement-aware default
        # external_loops: the event loops run on Python-created threads
        # (run_loop below).  A C-created thread pays an mmap + page
        # fault on EVERY cold eval entry (CPython frees the datastack
        # chunk when the last frame pops — measured ~14us/dispatch on
        # this box); a Python thread's resident frames pin the chunk.
        self.engine = engine_module.Engine(self._dispatch, loops=loops,
                                           external_loops=True)
        self._nloops = loops
        self._loop_threads: list = []
        self._listen_socket = None
        self._shard_sockets: list = []
        self._socks: Dict[int, Any] = {}      # engine conn_id -> NativeSocket
        self._pt_queues: Dict[int, Any] = {}  # per-conn dispatch serializers
        self._stream_capable = False          # kind-5 shims registered
        self._native_vars = []                # PassiveStatus keep-alives
        # one engine.telemetry() snapshot per sampling interval feeds
        # every native_engine_* var, the /native portal and /hotspots
        self.telemetry = _TelemetryCache(self.engine)

    def _register_native_methods(self) -> None:
        """Hand eligible methods to the C++ engine:

        - @raw_method(native=...) echo/const semantics (kind 0/1):
          answered GIL-free — no Python per request at all.
        - plain @raw_method (kind 2): the engine calls the handler in
          burst-batched GIL entries and builds the frame natively.
        - plain (cntl, request) methods (kind 3, the SLIM SERVER LANE):
          the engine scans the meta and calls a shim that runs
          admission, MethodStatus accounting, rpcz sampling and the
          user method in ONE batched GIL entry per burst; the response
          frame is built natively (server/slim_dispatch.py).

        Gating: auth/interceptor-bearing servers keep the full Python
        path for everything (verify-on-first / per-request admission
        must observe every call).  Kinds 2 and 3 run user code on the
        engine loop, so they additionally require usercode_inline — on
        a non-inline server raw and full methods keep the fiber-pool
        path (ADVICE r5 #1/#2: a blocking handler must never freeze a
        loop).  Kinds 0/1/2 bypass server/method concurrency caps and
        are skipped when one is set; the slim shim ENFORCES both caps,
        so kind 3 registers regardless.  Counters surface as
        PassiveStatus bvars (rpc_server_<m>_native_{requests,errors});
        kind-2/3 requests additionally keep full MethodStatus."""
        opts = self._server.options
        if opts.auth is not None or opts.interceptor is not None:
            return
        inline = bool(opts.usercode_inline)
        server_cap = bool(getattr(opts, "max_concurrency", 0))
        from ..bvar.passive_status import PassiveStatus
        registered = False
        for (svc, mth), entry in self._server._methods.items():
            if entry.raw_fn is not None:
                if server_cap:
                    continue      # kinds 0/1/2 bypass server admission
                kind = _NATIVE_KINDS.get(entry.native_kind or "")
                if kind is None:
                    if entry.native_kind:
                        continue  # unknown native= tag: Python path
                    # plain @raw_method: the engine calls the handler
                    # directly (kind 2) — burst-batched GIL entry,
                    # response frame built natively
                    kind = 2
                if kind == 2 and not inline:
                    continue      # user code stays off the IO loop
                if entry.status.max_concurrency or entry.status.limiter:
                    continue      # admission must stay in Python
                data = b""
                if kind == 1:
                    # capture the const response once (behavioral spec)
                    out = entry.raw_fn(b"", None)
                    data = bytes(out[0] if type(out) is tuple else out)
                if kind == 2:
                    # accounting shim: the Python raw lane keeps its
                    # FULL MethodStatus observability (request/error
                    # counts, inflight gauge, latency recorder) —
                    # @raw_method promises "per-method stats still
                    # apply".  ~2us on a warm frame.
                    def _observed(payload, att, _fn=entry.raw_fn,
                                  _st=entry.status, _ns=_mono_ns):
                        _st.on_requested()
                        t0 = _ns()
                        code = 0
                        try:
                            return _fn(payload, att)
                        except BaseException:
                            code = int(Errno.EINTERNAL)
                            raise
                        finally:
                            _st.on_responded(code, (_ns() - t0) // 1000)
                    self.engine.register_native_method(svc, mth, 2, b"",
                                                       _observed)
                else:
                    self.engine.register_native_method(svc, mth, kind,
                                                       data)
            else:
                # slim server lane (kind 3): unary (cntl, request)
                # methods only — streaming shapes keep the full path
                if not inline or entry.grpc_streaming:
                    continue
                from ..server.slim_dispatch import make_slim_handler
                shim = make_slim_handler(self, self._server, entry,
                                         svc, mth)
                self.engine.register_native_method(svc, mth, 3, b"",
                                                   shim)
                # kind-5 STREAMING lane: the same method's stream-open
                # variant — requests carrying the stream TLVs dispatch
                # to the stream shim (interceptor-chain binding) and
                # accepted streams are adopted onto the engine's
                # credit-accounted transport
                if bool(get_flag("rpc_native_stream_lane", True)):
                    from ..server.stream_slim import make_stream_handler
                    self.engine.set_stream_shim(
                        svc, mth,
                        make_stream_handler(self, self._server, entry,
                                            svc, mth))
                    self._stream_capable = True
            safe = f"{svc}_{mth}".lower()
            cache = self.telemetry

            def _mstat(key, _n=f"{svc}.{mth}", _c=cache):
                return _c.get()["methods"].get(_n, {}).get(key, 0)

            self._native_vars.append(PassiveStatus(
                lambda _s=_mstat: _s("handled"),
                name=f"rpc_server_{safe}_native_requests"))
            self._native_vars.append(PassiveStatus(
                lambda _s=_mstat: _s("errors"),
                name=f"rpc_server_{safe}_native_errors"))
            registered = True
        if registered:
            self.engine.set_native_dispatch(True)

    def _register_http_routes(self) -> None:
        """Hand eligible HTTP routes to the C++ engine — the SLIM HTTP
        LANE (kind 4, the HTTP analogue of the kind-3 tpu_std lane):
        the engine parses the request line + headers of eligible
        HTTP/1.1 messages itself, batches a read burst's worth, and
        enters Python once per burst calling a per-route shim
        (server/http_slim.py) that keeps admission, MethodStatus and
        rpcz; the response is serialized natively and coalesced into
        the burst's single writev.

        Gating mirrors the tpu_std slim lane: auth/interceptor servers
        keep the full Python path (every request must be observable),
        and the shim runs user code on the engine loop so
        ``usercode_inline`` is required.  Raw/streaming entries and
        everything the engine's header scan rejects (chunked, Expect,
        Upgrade, Connection: close, HTTP/1.0, unregistered paths —
        restful, builtin portal, dotted or slash-suffixed forms) fall
        back to the classic EV_HTTP path byte-identically.  The shim
        enforces both concurrency caps, so capped methods register."""
        opts = self._server.options
        if opts.auth is not None or opts.interceptor is not None:
            return
        if not opts.usercode_inline:
            return
        from ..bvar.passive_status import PassiveStatus
        from ..server.http_slim import make_http_slim_handler
        registered = False
        for (svc, mth), entry in self._server._methods.items():
            if entry.grpc_streaming or entry.raw_fn is not None \
                    or entry.fn is None:
                continue
            path = f"/{svc}/{mth}"
            for http_method in ("POST", "GET"):
                shim = make_http_slim_handler(self, self._server, entry,
                                              svc, mth, http_method)
                self.engine.register_http_route(http_method, path, shim)
            safe = f"{svc}_{mth}".lower()
            cache = self.telemetry

            def _sum(key, _p=path, _c=cache):
                # ONE snapshot per sample covers every HTTP method
                # registered for this path (derived from the live route
                # table, not hard-coded) — the round-7 version called
                # http_slim_stats twice (POST+GET) per var per sample
                routes = _c.get()["routes"]
                return sum(v.get(key, 0) for k, v in routes.items()
                           if k.partition(" ")[2] == _p)

            self._native_vars.append(PassiveStatus(
                lambda _s=_sum: _s("handled"),
                name=f"rpc_server_{safe}_http_slim_requests"))
            self._native_vars.append(PassiveStatus(
                lambda _s=_sum: _s("errors"),
                name=f"rpc_server_{safe}_http_slim_errors"))
            registered = True
        if registered:
            self.engine.set_http_slim(True)

    def _register_engine_vars(self) -> None:
        """Expose the engine's always-on telemetry as ``native_engine_*``
        bvars: every family reads the SAME cached snapshot (one
        engine.telemetry() GIL crossing per sampling interval), appears
        in /vars, and renders as labeled Prometheus exposition lines in
        /metrics.  First native server wins a contended name; stop()
        hides this bridge's vars."""
        from ..bvar.passive_status import PassiveStatus
        cache = self.telemetry
        add = self._native_vars.append
        add(PassiveStatus(
            lambda c=cache: round(c.busy_ratio(), 4),
            name="native_engine_loop_busy_ratio"))
        # the aggregate above sums busy/idle across loops and masks
        # imbalance — the per-loop family plus the max−min spread is
        # what the multi-core scaling work actually watches
        add(_PassiveDim(
            ("loop",),
            lambda c=cache: {str(i): round(r, 4) for i, r
                             in enumerate(c.per_loop_busy_ratios())},
            name="native_engine_loop_busy_ratio_by_loop"))
        add(PassiveStatus(
            lambda c=cache: round(c.loop_busy_imbalance(), 4),
            name="native_engine_loop_busy_imbalance"))
        add(_PassiveDim(
            ("loop",),
            lambda c=cache: {str(i): lo["handoffs"] for i, lo
                             in enumerate(c.get()["loops"])},
            name="native_engine_loop_handoffs"))
        add(PassiveStatus(lambda c=cache: c.get()["wq_hwm"],
                          name="native_engine_wq_hwm"))
        add(PassiveStatus(lambda c=cache: c.get()["inbuf_hwm"],
                          name="native_engine_inbuf_hwm"))
        from ..server.stream_slim import STREAM_FB_NAMES
        add(_PassiveDim(("reason",),
                        lambda c=cache, _sfb=STREAM_FB_NAMES: {
                            **{r: 0 for r in FB_REASON_NAMES},
                            **{r: 0 for r in _sfb},
                            **c.get()["fallbacks"]},
                        name="native_engine_fallback_total"))
        # kind-5 streaming lane: streams open, chunk flow, credit
        # stalls (the /native "streaming" section reads the same
        # snapshot's streams dict)
        add(PassiveStatus(
            lambda c=cache: c.get().get("streams", {}).get("open", 0),
            name="native_stream_open"))
        add(PassiveStatus(
            lambda c=cache: c.get().get("streams", {}).get(
                "chunks_in", 0),
            name="native_stream_chunks_in"))
        add(PassiveStatus(
            lambda c=cache: c.get().get("streams", {}).get(
                "chunks_out", 0),
            name="native_stream_chunks_out"))
        add(PassiveStatus(
            lambda c=cache: c.get().get("streams", {}).get(
                "credit_stalls", 0),
            name="native_stream_credit_stalls"))

        def _chunk_burst(_c=cache):
            bks = _c.get().get("streams", {}).get("chunk_burst", [])
            return {bucket_label(i, len(bks)): n
                    for i, n in enumerate(bks)}

        add(_PassiveDim(("bin",), _chunk_burst,
                        name="native_stream_chunk_burst"))
        add(_PassiveDim(("stage",),
                        lambda c=cache: c.get().get("data_plane_copies",
                                                    {}),
                        name="native_engine_data_plane_copies"))
        add(_PassiveDim(("stage",),
                        lambda c=cache: c.get().get(
                            "data_plane_copy_bytes", {}),
                        name="native_engine_data_plane_copy_bytes"))
        add(_PassiveDim(("lane",), lambda c=cache: {
            ln: d["handled"]
            for ln, d in c.get()["lanes"].items()},
            name="native_engine_lane_requests"))
        add(_PassiveDim(("lane",), lambda c=cache: {
            ln: d["errors"]
            for ln, d in c.get()["lanes"].items()},
            name="native_engine_lane_errors"))

        def _lane_qps(_c=cache):
            # windowed per-second view over the snapshot interval (the
            # Window/PerSecond shape without a sampler thread)
            prev, cur, dt = _c.window()
            out = {}
            for ln, d in cur["lanes"].items():
                base = (prev["lanes"][ln]["handled"]
                        if prev is not None else 0)
                out[ln] = round((d["handled"] - base) / dt, 1) \
                    if prev is not None else 0.0
            return out

        add(_PassiveDim(("lane",), _lane_qps,
                        name="native_engine_lane_qps"))

        def _latency_buckets(_c=cache):
            out = {}
            for ln, d in _c.get()["lanes"].items():
                for stage in ("queue", "shim", "resid"):
                    bks = d[f"{stage}_us"]
                    for i, n in enumerate(bks):
                        out[(ln, stage, bucket_label(i, len(bks)))] = n
            return out

        add(_PassiveDim(("lane", "stage", "bin"), _latency_buckets,
                        name="native_engine_latency_us"))

        def _size_hist(key, _c=cache):
            bks = _c.get()[key]
            return {bucket_label(i, len(bks)): n
                    for i, n in enumerate(bks)}

        add(_PassiveDim(("bin",), lambda _s=_size_hist: _s("burst"),
                        name="native_engine_burst_size"))
        add(_PassiveDim(("bin",), lambda _s=_size_hist: _s("writev_iov"),
                        name="native_engine_writev_iov"))

    def _shard_listen_sockets(self, listen_socket):
        """SO_REUSEPORT sharded accept: one extra listener per loop
        beyond the first, bound to the same (host, port).  Returns the
        full per-loop socket list (index i = loop i) or None when the
        platform/config keeps the single-fd rr-handoff fallback.
        Requires the PRIMARY socket to already carry SO_REUSEPORT
        (server.py sets it pre-bind when the option exists) — the
        kernel refuses mixed-mode binds."""
        import socket as _pysock
        if self._nloops < 2:
            return None
        if not bool(get_flag("engine_reuseport", True)):
            return None
        if not hasattr(_pysock, "SO_REUSEPORT"):
            return None
        try:
            if not listen_socket.getsockopt(_pysock.SOL_SOCKET,
                                            _pysock.SO_REUSEPORT):
                return None
        except OSError:
            return None
        name = listen_socket.getsockname()
        shards = [listen_socket]
        try:
            for _ in range(self._nloops - 1):
                s = _pysock.socket(_pysock.AF_INET, _pysock.SOCK_STREAM)
                try:
                    s.setsockopt(_pysock.SOL_SOCKET,
                                 _pysock.SO_REUSEADDR, 1)
                    s.setsockopt(_pysock.SOL_SOCKET,
                                 _pysock.SO_REUSEPORT, 1)
                    s.bind((name[0], name[1]))
                    s.listen(1024)
                    s.setblocking(False)
                except BaseException:
                    s.close()
                    raise
                shards.append(s)
        except OSError as e:
            LOG.warning("SO_REUSEPORT shard bind failed (%s); falling "
                        "back to single-listener rr placement", e)
            for s in shards[1:]:
                s.close()
            return None
        return shards

    def listen(self, listen_socket) -> None:
        listen_socket.setblocking(False)
        # the bridge owns the fd's lifetime alongside the engine
        self._listen_socket = listen_socket
        self._shard_sockets = []
        name = listen_socket.getsockname()
        self._local_ep = EndPoint(host=name[0], port=name[1])
        self._register_native_methods()
        self._register_http_routes()
        self._register_engine_vars()
        # kind-5 streaming lane: batched chunk delivery (pre-listen)
        # and the lane mode — mode 2 NAMES the non-inline decline,
        # mode 0 the no-capability one (closed StreamFb enum); the
        # lane flag is live-flippable for the native-vs-Python A/B
        # (already-adopted streams keep their lane)
        from ..server.stream_slim import slim_chunks
        self.engine.set_stream_chunks(slim_chunks)

        def _stream_mode(enabled, _self=self) -> int:
            if not _self._server.options.usercode_inline:
                return 2
            return 1 if (_self._stream_capable and bool(enabled)) else 0

        self.engine.set_stream_mode(
            _stream_mode(get_flag("rpc_native_stream_lane", True)))
        watch_flag("rpc_native_stream_lane",
                   lambda v, _e=self.engine, _m=_stream_mode:
                   _e.set_stream_mode(_m(v)))
        from ..protocol.tpu_std import max_body_size
        self.engine.set_http_max_body(int(max_body_size()))
        # kind-3 domain-exchange answers: the local ici-domain TLV is a
        # per-process constant (empty when ici is off) — cache it in
        # the engine so slim responses carry it natively
        from ..server.rpc_dispatch import _domain_tlv
        self.engine.set_domain_tlv(_domain_tlv())
        # per-burst accounting epilogue: the slim fast template
        # aggregates admitted-verdict counts per engine read burst and
        # this hook flushes them under one lock per burst
        from ..server.slim_dispatch import flush_burst_accounting
        self.engine.set_burst_end(flush_burst_accounting)
        # busy-poll spin for the latency tail (live-flippable: the
        # engine reads a relaxed atomic per loop iteration)
        self.engine.set_busy_poll_us(int(get_flag("engine_busy_poll_us")))
        watch_flag("engine_busy_poll_us",
                   lambda v, _e=self.engine: _e.set_busy_poll_us(int(v)))
        # SO_REUSEPORT sharded accept: one listener per loop, each loop
        # accepts and pins its own connections (brpc's per-core
        # EventDispatcher discipline); single-fd rr handoff otherwise
        shards = self._shard_listen_sockets(listen_socket)
        if shards is not None:
            self._shard_sockets = shards[1:]
            self.engine.listen_sharded([s.fileno() for s in shards])
        else:
            self.engine.listen(listen_socket.fileno())
        import threading
        for i in range(self._nloops):
            t = threading.Thread(target=self.engine.run_loop, args=(i,),
                                 name=f"native-loop-{i}", daemon=True)
            t.start()
            self._loop_threads.append(t)

    # -- operability plane: drain / lame duck ----------------------------

    def enter_lame_duck(self, signal: bool = True) -> None:
        """Drain mode: disarm the engine's listeners (the fds stay open)
        and — when ``signal`` — stamp the lame-duck TLV on natively built
        responses; new kind-4 HTTP matches decline to the classic lane,
        whose serializer owns the x-lame-duck / Connection: close
        headers, and new kind-5 stream opens decline under
        ``stream_drain``."""
        self.engine.set_lame_duck(2 if signal else 1)

    def force_close_all(self, reason: str) -> int:
        """Drain-grace expiry: force-close every live native connection
        with the named reason.  Returns the count."""
        n = 0
        for conn_id, sock in list(self._socks.items()):
            try:
                sock.set_failed(Errno.ELOGOFF, reason)
            except Exception:
                pass
            try:
                self.engine.close_conn(conn_id)
            except (ConnectionError, OSError):
                pass
            n += 1
        return n

    def stop(self) -> None:
        for v in self._native_vars:
            v.hide()
        self._native_vars.clear()
        self.engine.stop()
        for t in self._loop_threads:
            t.join(timeout=5.0)
        self._loop_threads.clear()
        # close the listen fd: the engine no longer accepts, but the
        # KERNEL still completes handshakes into the backlog of an open
        # listener — clients (health checks!) would "connect" to a
        # server that never serves them and hang until their deadlines
        ls = getattr(self, "_listen_socket", None)
        if ls is not None:
            try:
                ls.close()
            except OSError:
                pass
            self._listen_socket = None
        for s in getattr(self, "_shard_sockets", []):
            try:
                s.close()
            except OSError:
                pass
        self._shard_sockets = []
        for s in list(self._socks.values()):
            s.close()
        self._socks.clear()

    def connection_count(self) -> int:
        return self.engine.stats()["connections"]

    # -- engine event entry (runs on engine loop threads, GIL held) -----

    def _dispatch(self, event: int, conn_id: int, obj: Any,
                  extra: int) -> None:
        m = self._m
        try:
            if event == m.EV_MESSAGE:
                self._on_message(conn_id, obj, extra)
            elif event == m.EV_ACK:
                self._on_ack(conn_id, obj, extra)
            elif event == m.EV_STREAM:
                self._on_stream(conn_id, obj)
            elif event == getattr(m, "EV_HTTP", -1):
                self._on_http(conn_id, obj)
            elif event == getattr(m, "EV_BYTES", -1):
                self._on_bytes(conn_id, obj)
            elif event == m.EV_OPEN:
                self._on_open(conn_id, obj, extra)
            elif event == m.EV_CLOSE:
                self._on_close(conn_id)
            elif event == m.EV_UNKNOWN:
                LOG.warning("malformed HTTP on native port from conn %d "
                            "(%d bytes); closing (well-formed requests of "
                            "any registered protocol are served here)",
                            conn_id, len(obj))
        except Exception:
            LOG.exception("native dispatch raised (event=%d)", event)

    def _on_open(self, conn_id: int, ip: str, port: int) -> None:
        s = NativeSocket(self.engine, conn_id,
                         EndPoint(host=str(ip), port=int(port)),
                         self._local_ep)  # conn-pair key for ICI binding
        self._socks[conn_id] = s          # the lanes' lookup (one dict hit)

    def _on_close(self, conn_id: int) -> None:
        q = self._pt_queues.pop(conn_id, None)
        if q is not None:
            q.stop()
        s = self._socks.pop(conn_id, None)
        if s is not None:
            s.close()   # streams, device descriptors, shm slots, KV pages

    def _sock(self, conn_id: int) -> Optional[Socket]:
        return self._socks.get(conn_id)

    @staticmethod
    def _scan_request_meta(data):
        """Minimal TLV walk for the raw lane: (cid, service, method,
        att_size, timeout_ms, ici_domain, ici_conn, timeout_present,
        tenant) —
        or None when the
        meta carries any controller-tier tag (compress=2, error=6/7,
        auth=8, trace=9, span=10/11 — raw handlers have no span
        machinery, so traced requests take the full path; the NATIVE
        slim lanes carry trace context through their shims instead —
        stream=12/14, ici desc=16) or is malformed, meaning the full
        RpcMeta path must run.  The tenant tag (22) is tolerated like
        the deadline tag: raw handlers ignore it, the full/slim-meta
        path forwards it to the admission stage.  ~3x cheaper
        than RpcMeta.decode for the echo-class frame; a successful scan
        also lets the FULL method path build its RpcMeta from these
        fields without re-walking (slim-meta path in _on_message)."""
        cid = 0
        svc = mth = None
        att = tmo = 0
        tmo_seen = False
        dom = nonce = ten = b""
        off, end = 0, len(data)
        try:
            while off < end:
                tag = data[off]
                (ln,) = _struct_unpack_from("<I", data, off + 1)
                off += 5
                if off + ln > end:
                    return None
                if tag == 1:
                    (cid,) = _struct_unpack_from("<Q", data, off)
                elif tag == 4:
                    svc = _bytes(data[off:off + ln]).decode()
                elif tag == 5:
                    mth = _bytes(data[off:off + ln]).decode()
                elif tag == 3:
                    (att,) = _struct_unpack_from("<I", data, off)
                elif tag == 13:
                    (tmo,) = _struct_unpack_from("<I", data, off)
                    tmo_seen = True
                elif tag == 15:
                    dom = _bytes(data[off:off + ln])
                elif tag == 17:
                    nonce = _bytes(data[off:off + ln])
                elif tag == 22:
                    ten = _bytes(data[off:off + ln])
                else:
                    return None   # controller-tier tag: full path
                off += ln
        except (struct.error, IndexError, UnicodeDecodeError):
            return None
        if svc is None or mth is None:
            return None
        return cid, svc, mth, att, tmo, dom, nonce, tmo_seen, ten

    def _on_message(self, conn_id: int, buf, meta_size: int) -> None:
        sock = self._sock(conn_id)
        if sock is None:
            return
        recv_ns = _mono_ns()
        mv = memoryview(buf)
        server = self._server
        scan = None
        if server.options.usercode_inline \
                and server.options.auth is None \
                and server.options.interceptor is None:
            # raw latency lane: frame → handler → flat-TLV response on
            # this loop thread, no RpcMeta/ServerController/span in the
            # path (the handler opted into the bytes-in/bytes-out
            # contract via @raw_method)
            scan = self._scan_request_meta(mv[:meta_size])
            if scan is not None:
                entry = server.find_method(scan[1], scan[2])
                if entry is not None and entry.raw_fn is not None:
                    self._raw_dispatch(scan[0], scan[3], mv, meta_size,
                                       sock, entry)
                    return
        if scan is not None:
            # slim-meta path: the scan proved no controller-tier tags —
            # build the RpcMeta from its fields, skip the full decode
            meta = RpcMeta()
            (meta.correlation_id, meta.service_name, meta.method_name,
             meta.attachment_size, meta.timeout_ms, meta.ici_domain,
             meta.ici_conn, meta.timeout_present, meta.tenant) = scan
        else:
            meta = RpcMeta.decode(bytes(mv[:meta_size]))
        if meta is None:
            self.engine.close_conn(conn_id)
            return
        from ..server.rpc_dispatch import (RpcMessage, _send_error,
                                           process_rpc_request)
        body = mv[meta_size:]
        if meta.attachment_size > len(body):
            # malformed: answered EREQUEST, as the JAX engine's classic
            # lane does (the port's Python reader closes instead)
            _send_error(sock, meta, int(Errno.EREQUEST),
                        "attachment size exceeds body")
            return
        split = len(body) - meta.attachment_size
        msg = RpcMessage(meta, bytes(body[:split]), bytes(body[split:]),
                         recv_ns)
        if server.options.usercode_inline:
            # user code on the IO loop thread: zero handoffs between
            # frame cut and response write (any blocking handler stalls
            # this loop — that's the contract).  Acks queued while
            # serving ride in front of the response.
            sock.defer_acks = True
            try:
                process_rpc_request(msg, sock, server)
            finally:
                sock.defer_acks = False
            sock.flush_acks()
            return
        # service code runs on the fiber pool, never on the IO loop
        # (≈ InputMessenger starting a bthread per message batch)
        fiber_runtime.spawn(process_rpc_request, msg, sock, server,
                            name="native_rpc")

    def _raw_dispatch(self, cid: int, na: int, mv, meta_size: int, sock,
                      entry) -> None:
        """Slim turnaround for @raw_method handlers.  Passive rpcz
        SAMPLING deliberately skips raw methods and explicitly traced
        requests never reach here (the meta scan rejects tag 9; the
        native engine mirrors this as the named `rpc_trace_raw_lane`
        fallback) — that is the lane's contract (documented on
        @raw_method)."""
        server = self._server
        if not server.on_request_in():
            self._raw_error(sock, cid, int(Errno.ELIMIT),
                            "server max_concurrency")
            return
        status = entry.status
        if not status.on_requested():
            server.on_request_out()
            self._raw_error(sock, cid, int(Errno.ELIMIT),
                            f"{status.full_name} max_concurrency")
            return
        t0 = _mono_ns()
        payload = mv[meta_size:]
        att = None
        if na:
            if na > len(payload):
                # malformed frame: an attachment-size TLV exceeding the
                # body must be rejected, not silently fused into payload
                status.on_responded(int(Errno.EREQUEST), 0)
                server.on_request_out()
                self._raw_error(sock, cid, int(Errno.EREQUEST),
                                "attachment size exceeds body")
                return
            att = payload[len(payload) - na:]
            payload = payload[:len(payload) - na]
        code = 0
        try:
            # handler AND response build/send under one guard: a bad
            # return value (None, wrong arity, non-buffer) must release
            # the admission slots and answer the client, not leak them
            try:
                out = entry.raw_fn(payload, att)
                resp, ratt = out if type(out) is tuple else (out, None)
                nr = len(ratt) if ratt is not None else 0
                mb = TLV_CORRELATION + struct.pack("<Q", cid)
                if nr:
                    mb += TLV_ATTACHMENT + struct.pack("<I", nr)
                head = (b"TRPC"
                        + struct.pack("<II", len(mb) + len(resp) + nr,
                                      len(mb))
                        + mb)
                if nr:
                    self.engine.send(sock.conn_id, (head, resp, ratt))
                else:
                    self.engine.send(sock.conn_id, (head, resp))
            except ConnectionError as e:
                sock.set_failed(Errno.EFAILEDSOCKET, str(e))
            except Exception as e:
                LOG.exception("raw method %s failed", status.full_name)
                code = int(Errno.EINTERNAL)
                self._raw_error(sock, cid, code,
                                f"{type(e).__name__}: {e}")
        finally:
            status.on_responded(code, (_mono_ns() - t0) // 1000)
            server.on_request_out()

    def _raw_error(self, sock, cid: int, code: int, text: str) -> None:
        m = RpcMeta()
        m.correlation_id = cid
        m.error_code = code
        m.error_text = text
        body = m.encode()
        try:
            self.engine.send(sock.conn_id,
                             (b"TRPC" + struct.pack("<II", len(body),
                                                    len(body)), body))
        except ConnectionError:
            pass

    def _process_http(self, conn_id: int, sock, buf) -> None:
        """One COMPLETE raw HTTP/1.x message cut by the engine: parse
        headers in Python (protocol/http.py — the single source of HTTP
        semantics) and route through the normal server dispatch
        (RPC bridge, restful routes, builtin portal).  This is the
        native port serving every protocol, like the reference's C++
        core does (input_messenger.cpp:329)."""
        from ..protocol import http as http_mod

        source = IOBuf()
        source.append_user_data(memoryview(buf))
        res = http_mod.parse(source, sock, False, self._server)
        if not res.ok or res.message is None \
                or not res.message.is_request:
            self.engine.close_conn(conn_id)
            return
        http_mod._process_request(res.message, sock, self._server)
        if not res.message.keep_alive:
            # HTTP/1.0 (or explicit Connection: close): the SERVER ends
            # the connection after the response — 1.0 clients may wait
            # for EOF as the message delimiter.  The engine's
            # close-after-flush linger drains the queued response first.
            self.engine.close_conn(conn_id)

    def _conn_queue(self, conn_id: int, sock):
        """Per-connection dispatch serializer for non-inline servers:
        user code stays OFF the engine loop (the bridge's EV_MESSAGE
        contract — a blocking handler must never freeze a loop) while
        per-connection FIFO order is preserved, which is exactly what
        HTTP/1.1 pipelining (no correlation id — responses must leave
        in request order) and the passthrough portal's single-consumer
        discipline need.  Items are ("http", buf) messages or
        ("bytes", buf) passthrough gulps."""
        q = self._pt_queues.get(conn_id)
        if q is not None:
            return q
        from ..fiber.execution_queue import ExecutionQueue

        def executor(it, _cid=conn_id, _sock=sock):
            for kind, chunk in it:
                if kind == "http":
                    try:
                        self._process_http(_cid, _sock, chunk)
                    except Exception:
                        LOG.exception("native HTTP dispatch failed")
                        _sock.set_failed(Errno.EREQUEST,
                                         "http dispatch error")
                        # close the engine conn too (mirrors
                        # _pump_passthrough): the client must see EOF,
                        # not hang until its own timeout
                        self.engine.close_conn(_cid)
                else:
                    messenger = getattr(self._server, "_messenger", None)
                    if messenger is None:
                        self.engine.close_conn(_cid)
                        break
                    self._portal(_sock).append_user_data(memoryview(chunk))
                    self._pump_passthrough(_cid, _sock, messenger)
                if _sock.failed:
                    break

        q = self._pt_queues[conn_id] = ExecutionQueue(
            executor, name=f"native_pt_{conn_id}")
        return q

    def _on_http(self, conn_id: int, buf) -> None:
        """Inline servers process on the loop thread (zero handoffs —
        the usercode_inline contract: handlers never block).  Otherwise
        the message runs on the per-connection ExecutionQueue, keeping
        user dispatch off the shared IO loop while preserving the
        request-order response discipline (ADVICE r5 #1)."""
        sock = self._sock(conn_id)
        if sock is None:
            return
        if self._server.options.usercode_inline:
            self._process_http(conn_id, sock, buf)
            return
        self._conn_queue(conn_id, sock).execute(("http", buf))

    def _on_bytes(self, conn_id: int, buf) -> None:
        """Passthrough gulp: the engine recognized none of its natively-
        cut protocols on this connection, so every read lands here whole
        and the server's InputMessenger registry (h2/gRPC, redis,
        thrift, streams — the same table the Python transport uses)
        cuts and dispatches it.  This makes the native port speak EVERY
        registered protocol (≈ input_messenger.cpp:329's all-protocols
        loop), with tpu_std and HTTP/1.x still cut in C++.

        Inline servers process on the loop thread; otherwise the gulps
        ride the per-connection ExecutionQueue (see _conn_queue)."""
        sock = self._sock(conn_id)
        if sock is None:
            return
        messenger = getattr(self._server, "_messenger", None)
        if messenger is None:
            self.engine.close_conn(conn_id)
            return
        if self._server.options.usercode_inline:
            self._portal(sock).append_user_data(memoryview(buf))
            self._pump_passthrough(conn_id, sock, messenger)
            return
        self._conn_queue(conn_id, sock).execute(("bytes", buf))

    @staticmethod
    def _portal(sock):
        if sock.read_portal is None:
            sock.read_portal = IOPortal()
        return sock.read_portal

    def _pump_passthrough(self, conn_id: int, sock, messenger) -> None:
        try:
            messenger.process_buffered(sock)
        except Exception:
            LOG.exception("passthrough processing failed")
            sock.set_failed(Errno.EREQUEST, "passthrough dispatch error")
        if sock.failed:
            self.engine.close_conn(conn_id)

    def _on_ack(self, conn_id: int, buf, count: int) -> None:
        sock = self._sock(conn_id)
        if sock is None:
            return
        # released on the in-process fabric, else the transfer fabric,
        # only when posted on this connection (forged acks are dropped)
        process_ack(struct.unpack(f"<{count}Q", bytes(buf)), sock)

    def _on_stream(self, conn_id: int, buf) -> None:
        sock = self._sock(conn_id)
        if sock is None:
            return
        mv = memoryview(buf)
        (dest,) = struct.unpack_from("<Q", mv, 1)
        stream_dispatch(StreamFrame(mv[0], dest, bytes(mv[13:])), sock)
