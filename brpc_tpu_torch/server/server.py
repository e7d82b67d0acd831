"""Server — serves registered services over tpu_std, HTTP/1.1, h2/gRPC,
RESP and thrift on one port.

The port of ``brpc_tpu/server/server.py``: ``add_service``, ``start``,
``listen_endpoint``, ``stop``, ``drain`` and ``join``.  The Python
transport is the JAX one (``:615-678,700-910``): an
:class:`~brpc_tpu_torch.transport.acceptor.Acceptor` per listener turns
accepted connections into Sockets
read by the process's event dispatcher -- no accept thread and no thread
per connection -- and one :class:`InputMessenger` cuts every message of
every connection through its registry (tpu_std, the streams' TSTR and
the ICI acks' TICI frames, HTTP/1.x, h2/gRPC, RESP, thrift), message by
message, on the connection's consumer fiber.  A message with messages
after it in its gulp runs on a fiber of its own, the gulp's last inline;
stream frames, acks and RESP always inline, in arrival order.  Responses
leave through the socket's non-blocking write path.  Every request frame, whichever
transport read it, goes through ``server/rpc_dispatch.py``'s classic lane
(its stages compiled by ``interceptors.compile_rpc_chain``): the server
learns the peer's fabric domain and pins
its connection nonce from the request meta, splits the request's device
attachment off, answers the domain exchange, settles the request
attachment before it writes the response (so the credit return precedes
it), sends the response's device attachment through ``prepare_send``
(``EOVERCROWDED`` when the window stays full), takes inbound TICI ack
frames, and reclaims a connection's descriptors when it closes.  Streams
(``brpc_tpu/server/rpc_dispatch.py``): a method accepts the request's
stream with ``streaming.stream_accept``, the response meta carries the
accepted stream's id and window, a failed call closes the stream it
accepted, and inbound TSTR frames (the peer's acks and closes) go to
their stream inline on the consumer fiber, never behind a request.
Frames written by other threads on a stream (a decode batcher's tokens)
share the connection's write queue with the responses.
The shm data plane (``brpc_tpu/server/interceptors.py`` and
``rpc_dispatch.py``, ``transport/shm_ring.py``): the server takes a
request's ring offer, accept and release TLVs, resolves a request
descriptor into a view of the client's ring (an unresolvable one answers
EREQUEST), answers every response of that request with the accept and
its own ring's spec, and moves a response attachment of the threshold
or more onto the ring once it can (re-describing the request's slot when
the handler echoes its view; the rest under a named reason), after the
response has serialized.  ``stop`` waits a bounded time for this
process's ring slots to settle.
Observability (``brpc_tpu/server/interceptors.py``'s tpu_std epilogue):
each method has a :class:`~brpc_tpu_torch.server.method_status.MethodStatus`
(a latency recorder and an error counter, exposed as
``rpc_server_<service>_<method>``), settled once per request after its
response has serialized, the error path included, with the latency from
the frame's arrival; and each request of a known method gets an rpcz
server span (``rpcz.start_server_span``: forced for a traced request,
passively sampled under ``rpcz_max_samples_per_second`` otherwise),
backdated to the frame's arrival, on ``cntl.span`` for the handler, and
finished with the response's size and error code.  ``start`` starts the
bvar file dump when its flag is on.

The overload plane (``brpc_tpu/server/server.py:352-371``, ``:444-507``
and the classic lane's order in ``interceptors.compile_rpc_chain``):
:class:`ServerOptions` carries ``max_concurrency`` (an int, or a
``make_limiter`` spec or limiter for the whole server),
``method_max_concurrency`` (per ``"Service.Method"``, with ``"*"`` as
the default spec) and the tenant fair-admission capacity and weights.
A request of a known method runs, in order: admission
(``server/admission.py``, CoDel's sojourn measured from the frame's
arrival), the deadline arm at that arrival and the shed
(``deadline.maybe_shed``, lane ``"tpu_std"``), the handler inside
``inherit_deadline``, and the settle through
``MethodStatus.on_responded`` and ``on_request_out(tenant=...)`` on
every outcome.  A rejection or a shed runs no user code; a shed still
gets its span and its MethodStatus error count, a rejection neither (as
in the JAX lane, where it is answered before the controller exists).
The drain plane (``:813-916``, ``:50-167``): :meth:`Server.drain` pauses
accepting (the listener stays open and bound; a connection made
meanwhile waits in the kernel's backlog, and :meth:`start` on the
drained server serves it -- the port's addition), answers new requests ``ELAMEDUCK`` through admission, sets
the lame-duck TLV on every response while draining, closes the server's
streams under ``lame_duck``, waits for in-flight requests, force-closes
the acceptors' live connections at grace expiry
(``drain_grace_expired``), then settles
the shm ring's slots and the exported KV pages and host spills;
:meth:`join` waits for in-flight work bounded by the grace,
``graceful_quit_on_sigterm`` drains every live server on SIGTERM, and
``server_drain_state`` / ``drain_inflight_remaining`` are exposed.
Fleet membership (``:731-762``, ``:843-848``, ``:899-900``):
:meth:`Server.publish` adds the server's ``host:port`` to a ``file://``
naming list (the format ``FileNamingService`` reads) and
:meth:`unpublish` takes it out; ``start`` records ``fleet_restart``,
``drain`` unpublishes first and then calls ``fleet.on_server_drain``
(the drain and lame-duck events, a final report that says draining, the
registry's deregister), and ``stop`` unpublishes and calls
``fleet.on_server_stop``.  :attr:`methods` is the method table the load
report reads.

One port, every protocol (``brpc_tpu/server/server.py:614-625`` and
``transport/input_messenger.py``): the messenger detects each message's
protocol, so one connection may carry tpu_std, HTTP and RESP one after
another.  HTTP/1.x and h2 reach ``server/http_dispatch.py`` (the RPC
bridge and the builtin portal; gRPC through ``h2_rpc``); RESP reaches a
service added as ``"redis"`` (an object with ``on_command``,
``protocol/resp.py``) and thrift one added as ``"thrift"`` (an object
with ``handle``, ``protocol/thrift_proto.py``); without such a service
their bytes are claimed by no handler and the connection closes.
``ServerOptions.internal_port`` opens a second listener with an
acceptor of its own whose connections are tagged ``"internal"``: with
it set, the builtin pages answer 403 on the main port but for
``/health`` and ``/version``.  ``restful_mappings`` routes HTTP paths
to methods.

The classic lane's stages (``brpc_tpu/server/rpc_dispatch.py:271-359``),
in the JAX order: admission and the shed above, then auth on a
connection's first message (``ServerOptions.auth``'s ``verify(auth_data,
cntl)``; a refusal or a raise answers ``ERPCAUTH``, a pass marks the
connection's ``app_data`` "authed"), the user interceptor
(``ServerOptions.interceptor(cntl)`` -> a bool or ``(ok, code, text)``;
a raise answers ``EINTERNAL "interceptor: ..."``, a bare False ``EREJECT
"rejected"``), the request's decompression (``protocol/compress.py``; an
unknown type answers ``EREQUEST``), the handler, and the response's
compression when ``cntl.response_compress_type`` is set (the meta's
``compress_type`` only when it succeeded).  A refused call runs no
handler.  ``ServerOptions.session_local_data_factory`` backs
``cntl.session_local_data()`` with a ``SimpleDataPool``.  A handler that
calls ``cntl.begin_async()`` answers through ``cntl.finish`` later, from
any thread: its fiber returns at once, so responses may leave in another
order than their requests (the correlation ids pair them), and the
request stays in flight (drain and MethodStatus count it) until it
finishes.

TLS (``brpc_tpu/transport/acceptor.py:62-84``): with ``ssl_cert`` and
``ssl_key`` (or ``ssl_context``) the acceptor wraps every accepted
connection in the standard library's ``ssl`` on a fiber, the handshake
bounded by 5 s, and the dispatcher reads it like any other, the socket
holding its write lock around every SSL read and send (C15).  A
context the server builds from ``ssl_cert`` sends no TLS 1.3 session
ticket (the JAX server's sends two): a ticket read by a client's reader
while its caller writes the first request is the JAX client's SSL race.
A plaintext client fails the handshake and is closed.

The native engine (``brpc_tpu/server/server.py:574-645``): with
``ServerOptions.native`` the main port is served by
``transport/native_bridge.py``'s ``NativeBridge`` over the C++ engine of
``brpc_tpu_torch/native`` (``native_loops`` loops, one SO_REUSEPORT
listener each when there are several and ``engine_reuseport`` is on),
with no acceptor: tpu_std frames and HTTP/1.1 messages
are cut in C++, the slim lanes (kinds 0–5) answer eligible requests,
everything else reaches the classic lane or the InputMessenger through
the bridge.  A TLS server, or one whose engine does not build, serves
through the Python transport with a warning, as in the JAX package.
``connection_count``, ``drain`` (the engine's lame-duck mode, its
connections force-closed at grace expiry) and ``stop`` reach the bridge.
``drain`` and ``stop`` settle the client lane's demux entries within
their deadline (``transport/client_lane.py``'s ``drain_settle``), as the
JAX server does.  Cut, for a later slice of the port:
``export_listeners`` (hot restart).
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

from ..butil.endpoint import EndPoint, parse_endpoint
from ..butil.flags import define_flag, get_flag
from ..butil.simple_data_pool import SimpleDataPool
from ..bvar.dump import ensure_dumper
from ..bvar.passive_status import PassiveStatus
from ..transport import shm_ring
from ..transport.acceptor import Acceptor
from ..transport.input_messenger import InputMessenger
from ..transport.native_bridge import default_engine_loops
from .method_status import MethodStatus
from .service import extract_methods, service_name_of

LOG = logging.getLogger(__name__)
_JOIN_TIMEOUT_S = 5.0       # stop's wait for the requests being served
_DRAIN_S = 1.0              # stop's wait for the ring's slots to settle

# -- operability plane (graceful drain / lame duck) -------------------------

define_flag("drain_grace_ms", 5000,
            "graceful-drain grace: how long Server.drain() (and a "
            "post-stop join()) waits for in-flight requests, staged "
            "shm slots and exported KV pages to settle before "
            "force-closing stragglers with the named reason "
            "'drain_grace_expired'",
            validator=lambda v: isinstance(v, int) and v > 0)
define_flag("enable_lame_duck", True,
            "emit the lame-duck drain signal (tpu_std meta TLV 23) on "
            "every response while draining: clients re-resolve "
            "immediately with no breaker penalty.  Off = drain still "
            "rejects new work (ELAMEDUCK) but peers only learn per "
            "rejection",
            validator=lambda v: isinstance(v, bool))
define_flag("graceful_quit_on_sigterm", False,
            "install a SIGTERM handler that drains every live server "
            "(lame-duck, bounded in-flight + stream settle) and then "
            "stops it — the brpc -graceful_quit_on_sigterm shape.  Read "
            "at Server.start(); the handler can only install from the "
            "main thread",
            validator=lambda v: isinstance(v, bool))

# drain phases (ints so the bvar graphs)
DRAIN_SERVING, DRAIN_DRAINING, DRAIN_STOPPED = 0, 1, 2
_DRAIN_PHASE_NAMES = ("serving", "draining", "stopped")
# the named force-close reason at grace expiry
DRAIN_FORCE_CLOSE_REASON = "drain_grace_expired"

_live_servers: "weakref.WeakSet[Server]" = weakref.WeakSet()
_sigterm_installed = False


def _install_sigterm_drain() -> None:
    """``-graceful_quit_on_sigterm``: SIGTERM -> ``drain()`` then
    ``stop()`` on every live server, on a worker thread (the handler
    itself only spawns it).  A process parked in
    ``run_until_asked_to_quit()``/``join()`` then returns from main.  A
    second SIGTERM restores the default disposition and re-delivers.
    Installable from the main thread only; elsewhere a warning."""
    global _sigterm_installed
    if _sigterm_installed:
        return
    import signal as _signal

    _drain_started = [False]

    def _on_sigterm(_signum, _frame):
        if _drain_started[0]:
            _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
            os.kill(os.getpid(), _signal.SIGTERM)
            return
        _drain_started[0] = True

        def _drain_all():
            for s in list(_live_servers):
                if not s._started:
                    continue
                # one server's failure must not leave the rest serving
                try:
                    s.drain()
                except Exception:
                    LOG.exception("sigterm drain failed for %s",
                                  s._listen_endpoint)
                finally:
                    try:
                        s.stop()
                    except Exception:
                        LOG.exception("sigterm stop failed for %s",
                                      s._listen_endpoint)

        threading.Thread(target=_drain_all, name="sigterm-drain",
                         daemon=True).start()

    try:
        _signal.signal(_signal.SIGTERM, _on_sigterm)
        _sigterm_installed = True
    except ValueError:
        LOG.warning("graceful_quit_on_sigterm: not on the main "
                    "thread; SIGTERM handler not installed")


def _publish_file_edit(path: str, line: str, add: bool) -> None:
    """Atomically add/remove one server line in a file-NS list (the
    ``file://`` naming source): read-modify-replace under an flock so
    replicas publishing while a draining neighbor unpublishes cannot
    lose each other's lines."""
    import fcntl
    lockp = path + ".lock"
    with open(lockp, "a+") as lk:
        fcntl.flock(lk.fileno(), fcntl.LOCK_EX)
        try:
            try:
                with open(path) as f:
                    lines = [ln.strip() for ln in f if ln.strip()]
            except FileNotFoundError:
                lines = []
            if add:
                if line not in lines:
                    lines.append(line)
            else:
                lines = [ln for ln in lines if ln != line]
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write("".join(ln + "\n" for ln in lines))
            os.replace(tmp, path)
        finally:
            fcntl.flock(lk.fileno(), fcntl.LOCK_UN)


def _drain_state_now() -> int:
    """The highest drain phase across started servers (0 once nothing
    serves or drains)."""
    st = DRAIN_SERVING
    for s in list(_live_servers):
        if s._started:
            st = max(st, s._drain_state)
    return st


def _drain_inflight_now() -> int:
    """In-flight requests still settling on draining servers."""
    n = 0
    for s in list(_live_servers):
        if s._drain_state == DRAIN_DRAINING:
            n += s._inflight
    return n


_drain_state_var = PassiveStatus(_drain_state_now,
                                 name="server_drain_state")
_drain_inflight_var = PassiveStatus(_drain_inflight_now,
                                    name="drain_inflight_remaining")


def _ensure_drain_vars() -> None:
    """Re-expose the drain gauges at every Server construction: a test's
    registry wipe must not drop them for the rest of the process."""
    from ..bvar.variable import find_exposed
    for name, var in (("server_drain_state", _drain_state_var),
                      ("drain_inflight_remaining", _drain_inflight_var)):
        if find_exposed(name) is not var:
            var.expose(name)


class ServerOptions:
    """The options of ``brpc_tpu/server/server.py``'s ServerOptions that
    the port's lanes read: the overload plane's, the HTTP lanes', the
    classic lane's stages (``auth``, ``interceptor``,
    ``session_local_data_factory``), TLS (``ssl_*``) and the native
    engine's (``native``, ``native_loops``, ``usercode_inline``)."""

    __slots__ = ("max_concurrency", "method_max_concurrency",
                 "tenant_fair_capacity", "tenant_weights", "internal_port",
                 "restful_mappings", "server_info_name", "auth",
                 "interceptor", "session_local_data_factory", "ssl_cert",
                 "ssl_key", "ssl_context", "native", "native_loops",
                 "usercode_inline")

    def __init__(self):
        # server-wide in-flight cap: an int (0 = off), or a make_limiter
        # spec ("auto" / "timeout[:ms]" / "constant:N") or a
        # ConcurrencyLimiter instance
        self.max_concurrency: Any = 0
        # "Service.Method" -> int cap, spec or ConcurrencyLimiter; "*" is
        # the default spec for every method without its own entry
        self.method_max_concurrency: Dict[str, Any] = {}
        # per-tenant fair admission: the concurrency the tenant scheduler
        # divides (0 = account, never reject), weights default to 1
        self.tenant_fair_capacity = 0
        self.tenant_weights: Dict[str, float] = {}
        # a second, operator-only port (-1 = none, 0 = any free one): the
        # builtin portal pages answer only on connections accepted there
        # (≈ server.cpp:1079-1086); /health and /version stay public
        self.internal_port = -1
        # restful routing (≈ restful.cpp): "PATH => Service.Method" pairs,
        # comma separated; a trailing /* captures the rest of the path
        # into cntl.http_unresolved_path.
        #   "/v1/echo => E.Echo, /files/* => Files.Get"
        self.restful_mappings = ""
        self.server_info_name = ""      # the /version page's suffix
        # .verify(auth_data, cntl) -> bool, on a connection's first
        # tpu_std message (≈ Authenticator)
        self.auth: Optional[Any] = None
        # (cntl) -> bool or (ok, code, text), before the handler
        self.interceptor: Optional[Callable] = None
        # reusable user data for cntl.session_local_data()
        self.session_local_data_factory: Optional[Callable] = None
        # TLS (≈ ServerSSLOptions): cert + key paths, or a ready
        # ssl.SSLContext
        self.ssl_cert = ""
        self.ssl_key = ""
        self.ssl_context = None
        # serve the main port through the native C++ IO engine
        # (brpc_tpu_torch/native): tpu_std and HTTP/1.1 cut in C++, every
        # other protocol passed through to the InputMessenger.  Falls
        # back to the Python transport when the engine cannot build, and
        # is off for a TLS server (the engine speaks cleartext).
        self.native = False
        # engine loops: 0 = one per core up to 4
        # (native_bridge.default_engine_loops); explicit values pin it
        self.native_loops = 0
        # run user code on the engine's IO thread instead of a fiber (≈
        # the reference's usercode_in_pthread): the slim lanes (kinds
        # 2-5) need it.  Only for handlers that never block long (or
        # call begin_async early): a blocked handler stalls its loop.
        self.usercode_inline = False


class _MethodEntry:
    __slots__ = ("service", "fn", "status", "method_name", "request_type",
                 "response_compress", "grpc_streaming", "_http_chain",
                 "raw_fn", "native_kind", "chain")

    def __init__(self, service: Any, fn: Callable, status: MethodStatus,
                 method_name: str = ""):
        self.service = service
        self.fn = fn
        self.status = status
        self.method_name = method_name
        # @method(request_type=, response_compress=)
        self.request_type = getattr(fn, "_rpc_request_type", None)
        self.response_compress = int(getattr(fn, "_rpc_response_compress",
                                             0) or 0)
        self.grpc_streaming = bool(getattr(fn, "_grpc_streaming", False))
        self._http_chain = None         # compiled at the first HTTP call
        # @raw_method: the bytes-in/bytes-out handler, and its C++
        # semantic ("echo"/"const") when the engine may answer alone
        self.raw_fn = fn if getattr(fn, "_rpc_raw", False) else None
        self.native_kind = getattr(fn, "_rpc_native", None)
        self.chain = None   # the compiled tpu_std chain (rpc_dispatch)


class Server:
    def __init__(self, options: Optional[ServerOptions] = None):
        self.options = options or ServerOptions()
        self._services: Dict[str, Any] = {}
        self._methods: Dict[Tuple[str, str], _MethodEntry] = {}
        self._listener: Optional[socket.socket] = None
        self._listen_endpoint: Optional[EndPoint] = None
        self._acceptor: Optional[Acceptor] = None
        self._internal_acceptor: Optional[Acceptor] = None
        self._started = False
        self._stopped_event = threading.Event()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # the drain rendezvous shares the in-flight lock, so
        # on_request_out's decrement and its notify are one section
        self._drain_state = DRAIN_SERVING
        self._drain_cv = threading.Condition(self._inflight_lock)
        self._drain_force_closed = 0
        self._admission = None          # lazy AdmissionControl
        self._server_limiter = None     # from a spec'd max_concurrency
        self._server_limiter_spec = None
        self._published: Optional[Tuple[str, str]] = None
        self._messenger: Optional[InputMessenger] = None
        self._internal_endpoint: Optional[EndPoint] = None
        self._restful: list = []        # (segments, has_rest, method key)
        self._session_pool: Optional[SimpleDataPool] = None
        self._ssl_ctx = None
        self._native_bridge = None      # the engine's, when it serves
        self.version = self.options.server_info_name
        _live_servers.add(self)
        _ensure_drain_vars()

    def add_service(self, service: Any, name: str = "") -> int:
        """Register ``service`` under ``name`` (default: its class name);
        its public methods become ``name.Method``, each with its
        MethodStatus and the cap or limiter ``method_max_concurrency``
        gives it.  An object with ``on_command`` added as ``"redis"``, or
        with ``handle`` added as ``"thrift"``, is served over RESP or
        thrift on the same port instead.  0 on success."""
        if self._listener is not None:
            LOG.error("add_service after start")
            return -1
        sname = name or service_name_of(service)
        if sname in self._services:
            LOG.error("service %s already added", sname)
            return -1
        if (sname == "redis" and hasattr(service, "on_command")) or (
                sname == "thrift" and hasattr(service, "handle")):
            # the one port speaks RESP or thrift to it
            # (protocol/resp.py, protocol/thrift_proto.py)
            self._services[sname] = service
            return 0
        methods = extract_methods(service)
        if not methods:
            LOG.error("service %s has no public methods", sname)
            return -1
        from ..policy.concurrency_limiter import (ConcurrencyLimiter,
                                                  make_limiter)
        default_mc = self.options.method_max_concurrency.get("*", 0)
        if isinstance(default_mc, ConcurrencyLimiter):
            # one instance shared by every method would mix their
            # latencies into one adaptive state: a spec gets a fresh
            # limiter per method
            LOG.error("method_max_concurrency['*'] must be a spec "
                      "(e.g. \"auto\"), not a limiter instance")
            return -1
        self._services[sname] = service
        for mname, fn in methods.items():
            full = f"{sname}.{mname}"
            mc = self.options.method_max_concurrency.get(full, default_mc)
            limiter = None
            if isinstance(mc, ConcurrencyLimiter):
                limiter, mc = mc, 0
            elif isinstance(mc, str):
                limiter = make_limiter(mc)
                mc = 0
            self._methods[(sname, mname)] = _MethodEntry(
                service, fn,
                MethodStatus(full, max_concurrency=mc, limiter=limiter),
                method_name=mname)
        return 0

    @property
    def services(self) -> Dict[str, Any]:
        return self._services

    @property
    def running(self) -> bool:
        return self._started

    @property
    def methods(self) -> Dict[Tuple[str, str], _MethodEntry]:
        """``(service, method)`` -> its entry (``service``, ``fn``,
        ``status``)."""
        return self._methods

    def find_method(self, service_name: str,
                    method_name: str) -> Optional[_MethodEntry]:
        return self._methods.get((service_name, method_name))

    def find_restful(self, parts) -> Optional[Tuple[_MethodEntry, str]]:
        """Match an HTTP path against restful_mappings
        (≈ brpc's src/brpc/restful.cpp pattern table).
        Returns (entry, unresolved_path) or None."""
        for segs, has_rest, key in self._restful:
            n = len(segs)
            if has_rest:
                if len(parts) < n or parts[:n] != segs:
                    continue
                entry = self._methods.get(key)
                if entry is not None:
                    return entry, "/".join(parts[n:])
            elif list(parts) == segs:
                entry = self._methods.get(key)
                if entry is not None:
                    return entry, ""
        return None

    def _parse_restful(self) -> None:
        self._restful = []
        spec = self.options.restful_mappings or ""
        for pair in spec.split(","):
            pair = pair.strip()
            if not pair:
                continue
            pattern, _, target = pair.partition("=>")
            svc, _, mth = target.strip().rpartition(".")
            segs = [p for p in pattern.strip().split("/") if p]
            has_rest = bool(segs) and segs[-1] == "*"
            if has_rest:
                segs = segs[:-1]
            if (svc, mth) not in self._methods:
                LOG.error("restful mapping %r: unknown method %s.%s",
                          pair, svc, mth)
                continue
            self._restful.append((segs, has_rest, (svc, mth)))
        # longest (most specific) patterns first; exact beats wildcard
        # at equal length
        self._restful.sort(key=lambda t: (-len(t[0]), t[1]))

    def method_status(self, full_name: str) -> Optional[MethodStatus]:
        """``"Service.Method"``'s MethodStatus (None for an unknown one)."""
        svc, _, mth = full_name.rpartition(".")
        entry = self._methods.get((svc, mth))
        return entry.status if entry is not None else None

    # -- server-wide concurrency + admission (overload plane) -------------

    @property
    def admission(self):
        """This server's AdmissionControl (lazy)."""
        ctl = self._admission
        if ctl is None:
            from .admission import AdmissionControl
            with self._inflight_lock:
                if self._admission is None:
                    self._admission = AdmissionControl(self)
                ctl = self._admission
        return ctl

    def server_limiter(self):
        """The server-wide limiter when ``options.max_concurrency`` is a
        spec or a limiter (None for the int cap), parsed again whenever
        the option changes."""
        mc = self.options.max_concurrency
        if isinstance(mc, int):
            return None
        if mc is not self._server_limiter_spec:
            from ..policy.concurrency_limiter import (ConcurrencyLimiter,
                                                      make_limiter)
            self._server_limiter = mc if isinstance(mc, ConcurrencyLimiter) \
                else make_limiter(mc)
            self._server_limiter_spec = mc
        return self._server_limiter

    def on_request_in(self) -> bool:
        lim = self.server_limiter()
        limit = lim.max_concurrency() if lim is not None \
            else self.options.max_concurrency
        with self._inflight_lock:
            if limit > 0 and self._inflight >= limit:
                return False
            self._inflight += 1
            return True

    def on_request_out(self, tenant=None, error_code: int = 0,
                       latency_us: float = 0.0) -> None:
        """Settle one admitted request: the in-flight count (the last one
        wakes ``drain``/``join``), the server-wide limiter's feed and the
        tenant's fair-admission slot."""
        with self._inflight_lock:
            if self._inflight > 0:
                self._inflight -= 1
            if self._inflight == 0:
                self._drain_cv.notify_all()
        if error_code or latency_us:
            lim = self._server_limiter
            if lim is not None:
                lim.on_responded(error_code, latency_us)
        if tenant is not None and self._admission is not None:
            self._admission.release(tenant)

    @property
    def inflight(self) -> int:
        return self._inflight

    # -- lifecycle ---------------------------------------------------------

    def start(self, addr: Any = "127.0.0.1:0") -> int:
        """Listen on ``addr`` ("ip:port"; port 0 picks a free one) and
        start accepting.  On a drained server that was not stopped it
        ends the drain instead: the listener, still open and bound,
        accepts again, the backlog first.  0 on success."""
        if self._listener is not None:
            if self._drain_state == DRAIN_DRAINING \
                    and self._native_bridge is None:
                return self._resume()
            LOG.error("server already started")
            return -1
        ep = addr if isinstance(addr, EndPoint) else parse_endpoint(str(addr))
        try:
            self._ssl_ctx = self._server_ssl_context()
        except (OSError, ValueError) as e:
            LOG.error("cannot load the TLS certificate: %s", e)
            return -1
        family = socket.AF_INET6 if ":" in ep.host else socket.AF_INET
        native_mod = None
        if self.options.native and self._ssl_ctx is not None:
            LOG.warning("TLS serving uses the Python transport; native "
                        "engine disabled for %s", ep)
        elif self.options.native:
            from ..native import load as load_native
            native_mod = load_native()
            if native_mod is None:
                LOG.warning("native engine unavailable; serving %s "
                            "through the Python transport", ep)
        lsock = socket.socket(family, socket.SOCK_STREAM)
        try:
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if native_mod is not None and hasattr(socket, "SO_REUSEPORT") \
                    and (self.options.native_loops
                         or default_engine_loops()) > 1 \
                    and bool(get_flag("engine_reuseport", True)):
                # the bridge shards accept across its loops with one
                # SO_REUSEPORT listener each; the primary socket must
                # carry the option from before bind (the kernel refuses
                # mixed-mode binds)
                lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            lsock.bind(ep.to_sockaddr())
            lsock.listen(1024)
        except OSError as e:
            lsock.close()
            LOG.error("cannot listen on %s: %s", ep, e)
            return -1
        host, port = lsock.getsockname()[:2]
        ilsock = None
        if self.options.internal_port >= 0:
            ilsock = socket.socket(family, socket.SOCK_STREAM)
            try:
                ilsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                ilsock.bind((host, self.options.internal_port))
                ilsock.listen(128)
            except OSError as e:
                ilsock.close()
                lsock.close()
                LOG.error("cannot listen on internal port %d: %s",
                          self.options.internal_port, e)
                return -1
            self._internal_endpoint = EndPoint(
                host=host, port=ilsock.getsockname()[1])
        self._listener = lsock
        self._listen_endpoint = EndPoint(host=host, port=port)
        self.version = self.options.server_info_name
        if self.options.restful_mappings:
            self._parse_restful()
        if self.options.session_local_data_factory is not None \
                and self._session_pool is None:
            self._session_pool = SimpleDataPool(
                self.options.session_local_data_factory)
        # the handler table of every connection (≈ Server::BuildAcceptor
        # collecting protocols, server.cpp:572), in the JAX order of
        # registration
        from ..ici.endpoint import ICI_ACK
        from ..protocol.h2_rpc import H2
        from ..protocol.http import HTTP
        from ..protocol.resp import RESP
        from ..protocol.streaming import STREAMING
        from ..protocol.thrift_proto import THRIFT
        from ..protocol.tpu_std import TPU_STD
        self._messenger = InputMessenger(
            [TPU_STD, STREAMING, ICI_ACK, HTTP, H2, RESP, THRIFT], self)
        self._started = True
        self._drain_state = DRAIN_SERVING
        self._drain_force_closed = 0
        self._stopped_event.clear()
        if bool(get_flag("graceful_quit_on_sigterm", False)):
            _install_sigterm_drain()
        if native_mod is not None:
            from ..transport.native_bridge import NativeBridge
            self._native_bridge = NativeBridge(
                self, native_mod, loops=self.options.native_loops)
            self._native_bridge.listen(lsock)
        else:
            self._acceptor = Acceptor(self._messenger,
                                      ssl_context=self._ssl_ctx)
            self._acceptor.start_accept(lsock)
        if ilsock is not None:
            self._internal_acceptor = Acceptor(
                self._messenger, tag="internal", ssl_context=self._ssl_ctx)
            self._internal_acceptor.start_accept(ilsock)
        ensure_dumper()     # a no-op unless the bvar_dump flag is on
        from .. import fleet
        fleet.on_server_start(self)     # flight recorder: restart event
        return 0

    def _resume(self) -> int:
        """End a drain: no lame duck, accepting again."""
        self._drain_state = DRAIN_SERVING
        for acc in (self._acceptor, self._internal_acceptor):
            if acc is not None:
                acc.resume_accept()
        return 0

    def _server_ssl_context(self):
        """The server's TLS context (None when TLS is off)."""
        opts = self.options
        if opts.ssl_context is not None:
            return opts.ssl_context
        if not opts.ssl_cert:
            return None
        import ssl
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(opts.ssl_cert, opts.ssl_key or None)
        # no TLS 1.3 session tickets: no client of this framework resumes
        # a session, and tickets landing just after the handshake race a
        # client's first write on its SSL object (the JAX client reads
        # and writes one SSL object from two threads; ROADMAP C15)
        ctx.num_tickets = 0
        return ctx

    @property
    def listen_endpoint(self) -> Optional[EndPoint]:
        return self._listen_endpoint

    @property
    def internal_endpoint(self) -> Optional[EndPoint]:
        return self._internal_endpoint

    def connection_count(self) -> int:
        n = 0
        for acc in (self._acceptor, self._internal_acceptor):
            if acc is not None:
                n += acc.connection_count()
        if self._native_bridge is not None:
            n += self._native_bridge.connection_count()
        return n

    @property
    def acceptors(self) -> list:
        """The acceptors serving the main and the internal port."""
        return [a for a in (self._acceptor, self._internal_acceptor)
                if a is not None]

    def stop(self) -> int:
        """Close the listeners and every connection; requests being
        served are let finish on their fibers, all of them together
        bounded by a timeout (their answers go nowhere; ``join`` waits
        for them up to the drain grace).  After a completed
        :meth:`drain` nothing is in flight to cut."""
        if self._listener is None:
            return 0
        self._started = False
        self._drain_state = DRAIN_STOPPED
        self.unpublish()
        from .. import fleet
        fleet.on_server_stop(self)      # flight recorder + reporter reap
        if self._native_bridge is not None:
            self._native_bridge.stop()      # closes the listener too
            self._native_bridge = None
        for acc in self.acceptors:
            acc.stop_accept()
        self._acceptor = self._internal_acceptor = None
        self._stopped_event.set()
        with self._inflight_lock:
            # joiners wake even if in-flight never settles: their wait is
            # grace-bounded
            self._drain_cv.notify_all()
        self._wait_inflight_zero(time.monotonic() + _JOIN_TIMEOUT_S)
        settle_by = time.monotonic() + _DRAIN_S
        left = shm_ring.drain_settle(settle_by)
        from ..transport import client_lane as _client_lane
        lane_left = _client_lane.drain_settle(settle_by)
        if left or lane_left:
            LOG.warning("stop: %d shm slot(s) and %d client demux "
                        "entrie(s) of this process still outstanding",
                        left, lane_left)
        try:
            self._listener.close()
        except OSError:
            pass
        self._listener = None
        self._listen_endpoint = None
        self._internal_endpoint = None
        return 0

    def join(self, timeout: Optional[float] = None) -> None:
        """Block until ``stop()`` and every in-flight request has settled,
        the latter bounded by ``drain_grace_ms``."""
        self._stopped_event.wait(timeout)
        if not self._stopped_event.is_set():
            return                      # the caller's timeout
        deadline = time.monotonic() + \
            int(get_flag("drain_grace_ms", 5000)) / 1e3
        with self._inflight_lock:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    LOG.warning("join(): %d request(s) still in flight "
                                "at drain-grace expiry", self._inflight)
                    return
                self._drain_cv.wait(min(left, 0.05))

    def run_until_asked_to_quit(self) -> None:
        try:
            self.join()
        except KeyboardInterrupt:
            self.stop()

    # -- operability plane: drain / lame duck ------------------------------

    @property
    def draining(self) -> bool:
        return self._drain_state == DRAIN_DRAINING

    @property
    def drain_phase(self) -> str:
        return _DRAIN_PHASE_NAMES[self._drain_state]

    @property
    def lame_duck_signal_on(self) -> bool:
        """True while responses carry the lame-duck signal."""
        return self._drain_state == DRAIN_DRAINING \
            and bool(get_flag("enable_lame_duck", True))

    @property
    def drain_force_closed(self) -> int:
        return self._drain_force_closed

    def publish(self, target: str) -> int:
        """Add this server's address to a ``file://`` naming list (one
        ``host:port`` per line, what ``FileNamingService`` reads).
        ``drain()`` unpublishes first, so new clients stop resolving here
        before the lame-duck signal reaches connected ones."""
        if self._listen_endpoint is None:
            return -1
        path = target[len("file://"):] if target.startswith("file://") \
            else target
        line = f"{self._listen_endpoint.host}:{self._listen_endpoint.port}"
        try:
            _publish_file_edit(path, line, add=True)
        except OSError as e:
            LOG.error("publish to %s failed: %s", path, e)
            return -1
        self._published = (path, line)
        return 0

    def unpublish(self) -> None:
        pub = self._published
        if pub is None:
            return
        self._published = None
        path, line = pub
        try:
            _publish_file_edit(path, line, add=False)
        except OSError as e:
            LOG.warning("unpublish from %s failed: %s", path, e)

    def _wait_inflight_zero(self, deadline_mono: float) -> bool:
        with self._inflight_lock:
            while self._inflight > 0:
                left = deadline_mono - time.monotonic()
                if left <= 0:
                    return False
                self._drain_cv.wait(min(left, 0.05))
            return True

    def _force_close_stragglers(self) -> int:
        """Grace expired: close the live connections, each with the named
        reason, so a client sees a closed connection and an operator a
        counted event, never a silent hang."""
        from ..butil.status import Errno
        n = 0
        for acc in self.acceptors:
            for sock in acc.live_sockets():
                sock.set_failed(int(Errno.ELOGOFF), DRAIN_FORCE_CLOSE_REASON)
                sock.release()
                n += 1
        if self._native_bridge is not None:
            n += self._native_bridge.force_close_all(
                DRAIN_FORCE_CLOSE_REASON)
        self._drain_force_closed += n
        if n:
            LOG.warning("drain grace expired: force-closed %d "
                        "connection(s) (%s)", n, DRAIN_FORCE_CLOSE_REASON)
        return n

    def drain(self, grace_ms: Optional[int] = None) -> int:
        """Enter lame duck and finish in-flight work (≈ the graceful half
        of brpc ``Server::Stop``):

        0. unpublish, and tell the fleet registry (``fleet.on_server_drain``);
        1. stop accepting (the listener stays open and bound: a new
           connection waits in its backlog, for :meth:`start` to end the
           drain or for a successor) and stamp the lame-duck signal on
           every response;
        2. answer new requests ``ELAMEDUCK`` through admission;
        3. close the streams this server accepted, each after a short
           settle of its window, with the reason ``lame_duck``;
        4. wait, bounded by ``grace_ms`` (default the ``drain_grace_ms``
           flag), for in-flight requests; at grace expiry force-close
           the connections under ``drain_grace_expired``;
        5. within the same deadline, settle this process's shm ring
           slots, exported KV pages and host-tier spills in flight, and
           the client lane's demux entries (``client_lane.drain_settle``).

        0 when everything settled inside the grace, -1 otherwise.
        ``stop()`` afterwards is client-invisible.  Idempotent while
        draining."""
        if not self._started:
            return -1
        if self._drain_state == DRAIN_DRAINING:
            return 0
        grace = int(grace_ms if grace_ms is not None
                    else get_flag("drain_grace_ms", 5000))
        deadline = time.monotonic() + grace / 1e3
        self._drain_state = DRAIN_DRAINING
        self.unpublish()
        # fleet visibility within one report interval: the drain and
        # lame-duck events, a final report that says "draining", and
        # the registry's deregister (1 s RPCs, outside the grace)
        from .. import fleet
        fleet.on_server_drain(self)
        for acc in self.acceptors:
            acc.pause_accept()
        if self._native_bridge is not None:
            # the engine: disarm its listeners, stamp the lame-duck TLV
            # on natively built responses, decline new kind-4 matches
            # (new kind-5 stream opens decline under `stream_drain`)
            self._native_bridge.enter_lame_duck(
                bool(get_flag("enable_lame_duck", True)))
        from ..streaming import drain_server_streams
        drain_server_streams(self, deadline)
        settled = self._wait_inflight_zero(deadline)
        if not settled:
            self._force_close_stragglers()
        # data-plane residue inside the same deadline (process-wide
        # gauges: a co-hosted client's traffic counts too)
        from ..kv import pages as _kv_pages
        from ..transport import client_lane as _client_lane
        shm_left = shm_ring.drain_settle(deadline)
        lane_left = _client_lane.drain_settle(deadline)
        kv_left = _kv_pages.drain_settle(deadline)
        if shm_left or lane_left or kv_left:
            LOG.warning("drain grace expired with %d shm slot(s), %d "
                        "demux entrie(s) and %d kv page(s) or spill(s) "
                        "unsettled", shm_left, lane_left, kv_left)
        return 0 if settled and not shm_left and not lane_left \
            and not kv_left else -1
