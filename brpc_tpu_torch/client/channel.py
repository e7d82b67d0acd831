"""Channel — the client stub, over blocking tpu_std connections.

The slim core of ``brpc_tpu/client/channel.py``: ``init`` against one
server ("ip:port"), or a cluster (a naming URL, ``"list://a:1,b:2"``,
``"file:///path"``, ``"dns://host:port"``, ``"watch://host:port/path"``,
``"mesh://name"``, with a load balancer's name: ``"rr"``, ``"wrr"``,
``"random"``, ``"wr"``, ``"c_murmurhash"``, ``"c_md5"``, ``"la"``,
``"dynpart"``), then ``call_method`` / ``call``.

Connections (``transport/socket_map.py``, as the JAX client's): a
``"single"`` connection is the process's one connection to its peer,
shared by every channel to it with the same signature (TLS context,
connect timeout, credentials; ``socket_map.conn_key``) and taken from
the socket map; calls are
multiplexed on it and matched by correlation id, its reads owned by the
client lane's native demux (``transport/client_lane.py``) or, when the
lane declines, by the event dispatcher (``transport/event_dispatcher.py``)
and the client messenger.  A call that times out there fails
alone and leaves the connection up; a transport error fails the
connection, every call waiting on it and its streams, and the health
check revives it in place.  ``"pooled"`` and ``"short"`` connections
come from the map's pools.  A blocking call on them takes the fast lane
(``client/fast_call.py``: the engine's ``sync_call`` on the calling
thread) when ``fast_call.eligible`` holds, as in the JAX client
(``brpc_tpu/client/channel.py:201-210``); :meth:`Channel.call_raw` and
:meth:`Channel.call_batch` ride it too.

Device attachments (``brpc_tpu/client/controller.py``'s ICI lane): every
request advertises this process's fabric domain and the connection
nonce; the peer's domain is learned from the first response, and from
then on a device attachment to a peer in this process goes as a
descriptor.  TICI ack frames that arrive ahead of a response are
processed; the credit for a response descriptor goes back when the
caller redeems it (or drops it unredeemed), on the connection's ack
queue.

The shm data plane (``transport/shm_ring.py``, the JAX controller's
lane): a request attachment of ``rpc_shm_threshold`` bytes or more to a
peer on this host rides a descriptor into this process's ring once the
peer has accepted the ring offer (the first eligible request carries
it); slot releases owed to the peer ride the next request; a response
descriptor is resolved into a view of the peer's ring (the
``response_attachment``, a ``memoryview`` whose release settles its
slot); and the request's slot lease is settled once the call has an
outcome.  Every ineligible shape rides the frame, byte for byte as
before, under a named reason.

Streams (``brpc_tpu/client/controller.py``): a call whose controller
carries a stream (``streaming.stream_create``) puts the stream's id and
window into the request meta, binds the stream to the connection before
the write, and the response binds it to the server's stream (a failed
call, or one the server did not accept it on, closes it).  Stream frames
arrive after the call returns, and the first may arrive before the
response: the connection's reader (the lane or the dispatcher) owns
every read, hands each response to its waiting call by correlation id, and
routes TSTR frames to their streams and TICI acks to the lane.  A call
with ``cntl.trace_id`` set is traced (``Controller._begin_trace_span``):
its client span finishes with the call's outcome.

Retries and backup requests (``brpc_tpu/client/channel.py:20-116`` and
the JAX ``Controller``'s attempt machinery): a call reserves
``max_retry + 2`` correlation ids from the process-wide counter the fast
lane draws from too (``fast_call.reserve_cids``), and attempt k carries
``base + k`` on the wire, as the JAX client's ranged id does.  Every
attempt stamps what is left of the call's one deadline (TLV 13).  An attempt that fails under the retry policy is
retried while ``max_retry`` allows and the channel's
:class:`~brpc_tpu_torch.deadline.RetryBudget` grants a token, after
``retry_backoff_ms`` of exponential backoff with jitter (none for the
fail-fast codes).  A backup attempt goes out ``backup_request_ms`` after
the call began if it is still pending, drawing from the same budget;
the first answer wins and the losers' responses are dropped without
error.  Inside a server handler the call's timeout is capped by the
inherited deadline (``deadline.cap_timeout_ms``) and an expired one
fails fast with ``ERPCTIMEDOUT``.  ``connection_type``: ``"single"``
(the peer's shared connection), ``"pooled"`` (a free list of
connections, one per concurrent attempt) or ``"short"`` (a connection
per attempt).  A server runs the last request of a read on the
connection's reading fiber (the JAX rule), so a backup on ``"single"``
that arrives while its primary runs waits behind it and can only lose;
hedging wants ``"pooled"``, whose attempts' connections the dispatcher
reads.

The cluster client (``brpc_tpu/client/controller.py:405-421``): the
connection state above lives per server, one sub-channel per endpoint
the balancer has picked, and every attempt (the first, each retry and
each backup) picks its server through
:class:`~brpc_tpu_torch.client.load_balancer_with_naming.LoadBalancerWithNaming`
and takes its connection from that server's sub-channel; a stream binds
to the connection of the server that answered it.  A failed attempt's
server joins ``excluded_servers``; a draining server's lame-duck TLV (or
its ``ELAMEDUCK``) marks it in the lame-duck registry and a clean answer
clears the mark; each finished call is fed back to the balancer (and to
the circuit breaker, with ``enable_circuit_breaker``; on a single-server
channel straight to the breaker).  Two divergences from the JAX
package, as in brpc itself: a backup request excludes the servers of the
attempts still out, so a consistent-hashing balancer hedges on another
replica (the JAX backup asks the balancer again with the same key and
lands where its primary is), and each attempt that fails and is
superseded feeds the breaker with its own server and error (the JAX
client feeds only the call's final server), so a dead replica that the
retries route around still trips its breaker.

Other protocols (``brpc_tpu/client/channel.py:188``, ``:229``, ``:305``):
``ChannelOptions.protocol`` (or ``Channel(protocol=...)``) is
``"tpu_std"`` (the default), ``"http"`` or ``"grpc"``.  Over ``"http"``
each attempt is one HTTP/1.1 ``POST /Service/Method`` on a connection of
its own, from a pool of the channel's (``"single"`` becomes
``"pooled"``: HTTP/1.1 cannot multiplex),
carrying the attachment after the body (``x-rpc-attachment-size``), the
remaining budget (``x-deadline-ms``), the trace (``traceparent``) and the
tenant (``x-tenant``); its response is cut on the calling thread and
read by ``controller.process_http_response``, so retries, backups, the
balancer and the breaker work as on tpu_std.  Over ``"grpc"`` a call is
one unary gRPC call on the peer's shared h2 connection
(``client/grpc_client.py``), with ``grpc-timeout`` the remaining budget,
no retry, and the balancer's pick on a cluster channel, as in the JAX
client; :meth:`Channel.grpc_stream` opens a streaming call.  Streams
(``stream_create``), device attachments and the shm lane ride tpu_std
only.

Async calls and call ids (``brpc_tpu/client/channel.py:165-194``):
``call_method(method, request, response_type=None, done=None,
cntl=None, attachment=None)`` blocks without ``done``; with it, it
returns at once and ``done(cntl)`` runs on the call's own thread when
the call ends, on every protocol.  Each call holds a versioned id
(``cntl.call_id``) from its launch to its end: ``cntl.join()`` waits for
the end and ``controller.start_cancel(call_id)`` ends it
``ECANCELLED``.  An async call's attempts run on threads of their own,
so a cancel ends it at once; a blocking call's attempt runs on the
caller's thread, so a cancel from another thread ends it when that
attempt returns (its response, if any, is dropped).  A gRPC call honours
a cancel only before it starts.  ``response_type`` parses the response
as the JAX ``parse_payload`` does.

The classic lane's request stages (``brpc_tpu/client/controller.py:
561-581``): ``ChannelOptions.auth_data`` rides every tpu_std request
(the server checks it on a connection's first), and
``request_compress_type`` (the controller's, else the channel's)
compresses the payload once per call, each attempt's meta naming the
type; a compressed response is decompressed (``ERESPONSE`` when it
cannot be).  TLS (``brpc_tpu/transport/socket.py:228-233``):
``ChannelOptions.ssl`` wraps every tpu_std, HTTP and gRPC connection in
the standard library's ``ssl`` after the connect, the handshake bounded
by the connect timeout plus 4 s; ``ssl_context`` replaces the default
client context, ``ssl_ca`` pins a CA file and ``ssl_verify`` turns the
certificate check on (off by default, as in the JAX package).
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..butil.endpoint import EndPoint, parse_endpoint
from ..butil.logging_util import LOG
from ..butil.status import Errno
from ..deadline import RetryBudget, backoff_ms, cap_timeout_ms
from ..ici.endpoint import (ack_unused, conn_nonce_of, ici_enabled,
                            prepare_send, process_ack,
                            split_device_attachment)
from ..ici.fabric import local_domain_id
from ..butil.iobuf import IOPortal
from ..protocol import compress as compress_mod
from ..protocol.base import ParseError
from ..protocol.http import build_request
from ..protocol.http import parse as http_parse
from ..protocol.meta import CompressType, RpcMeta
from ..protocol.streaming import StreamFrame, dispatch
from ..rpcz import format_traceparent
from ..protocol.tpu_std import (AckFrame, FrameError, pack_frame,
                                parse_payload, read_frame, serialize_payload)
from ..transport import shm_ring
from ..transport.client_lane import lane_cancel, lane_expect
from ..transport.socket import Socket, dial
from ..transport.socket_map import (NO_DEADLINE_S, conn_key,
                                    global_socket_map, pooled_socket,
                                    return_pooled_socket, short_socket)
from . import fast_call
from .circuit_breaker import global_circuit_breaker_map
from .controller import (_ELAMEDUCK, _FAIL_FAST, Controller,
                         process_http_response)
from .naming_service import global_lame_ducks

_MAX_POST_WAIT_S = 30.0     # a request descriptor's wait for window credit
_CONNECTION_TYPES = ("single", "pooled", "short")
_PROTOCOLS = ("tpu_std", "http", "grpc")


class ChannelOptions:
    """Defaults mirror the JAX package's: timeout 500 ms, connect 1 s,
    3 retries, no backup request, one connection, no circuit breaker, a
    retry budget of 100 tokens refilled 0.1 per success, no backoff (5 s
    cap), no compression, no auth data, no TLS."""

    __slots__ = ("timeout_ms", "connect_timeout_ms", "max_retry",
                 "backup_request_ms", "connection_type", "tenant",
                 "enable_circuit_breaker", "retry_budget_max",
                 "retry_budget_ratio", "retry_backoff_ms",
                 "retry_backoff_max_ms", "protocol", "request_compress_type",
                 "auth_data", "ssl", "ssl_context", "ssl_ca", "ssl_verify")

    def __init__(self):
        self.protocol = "tpu_std"       # or "http", "grpc"
        self.timeout_ms = 500
        self.connect_timeout_ms = 1000
        self.max_retry = 3
        self.backup_request_ms = -1
        self.connection_type = "single"
        # this channel's tenant identity, stamped on every request as
        # meta TLV 22 (the server's per-tenant fair admission key)
        self.tenant = ""
        # isolate a failing server from selection (off by default, as in
        # brpc's channel.h:49-77)
        self.enable_circuit_breaker = False
        # every retry and backup attempt draws from one token bucket;
        # max <= 0 disables it
        self.retry_budget_max = 100.0
        self.retry_budget_ratio = 0.1
        self.retry_backoff_ms = 0
        self.retry_backoff_max_ms = 5000
        self.request_compress_type = CompressType.NONE
        self.auth_data = b""            # rides every tpu_std request
        # TLS (≈ ChannelSSLOptions): ssl=True wraps every connection;
        # ssl_context overrides the default client context; ssl_ca pins
        # a CA file; ssl_verify turns the certificate check on (off by
        # default: self-signed certificates work out of the box)
        self.ssl = False
        self.ssl_context = None
        self.ssl_ca = None
        self.ssl_verify = False


class RpcError(Exception):
    def __init__(self, code: int, text: str):
        super().__init__(f"[{code}] {text}")
        self.code = code
        self.text = text


class _Waiter:
    """One attempt waiting on a connection another reader reads (the
    client lane or the dispatcher).  The reader delivers the response
    onto the call's results itself (``socket_map.hand_over``): two attempts of one
    call on one connection then reach the call in the order their
    responses arrived.  A failed connection fails it."""

    __slots__ = ("done", "error", "channel", "call", "version", "lease",
                 "offered")

    def __init__(self, channel: "Channel", call: "_Call", version: int,
                 lease, offered: bool):
        self.done = threading.Event()
        self.error: Optional[str] = None
        self.channel = channel
        self.call, self.version = call, version
        self.lease, self.offered = lease, offered

    def deliver(self, msg, sock: Socket) -> None:
        self.channel._deliver(self.call, self.version, (
            "msg", (msg[0], msg[1], msg[2], sock, self.lease,
                    self.offered)))
        self.done.set()

    def fail(self, why: str) -> None:
        self.error = why
        self.done.set()


class _Call:
    """One call's attempts: their results arrive on ``results`` as
    ``(version, kind, data)``; ``kind`` is ``"msg"`` (``data``: the
    response frame's fields, its socket, shm lease and offer flag),
    ``"err"`` (``(code, text)``) or ``"timeout"``."""

    __slots__ = ("c", "method", "payload", "stream", "cid_base", "deadline",
                 "timeout_ms", "ctype", "hedged", "results", "done",
                 "leases", "staged", "lock", "conns", "threaded",
                 "response_type", "wire_payload", "compress_type")

    def __init__(self, c, method, payload, stream, cid_base, deadline,
                 timeout_ms, ctype, hedged, threaded=False,
                 response_type=None):
        self.c, self.method, self.payload = c, method, payload
        self.stream = stream
        self.cid_base = cid_base
        self.deadline = deadline            # time.monotonic(), or None
        self.timeout_ms = timeout_ms
        self.ctype = ctype
        self.hedged = hedged
        # attempts on threads of their own (a hedged or an async call),
        # so that the caller's loop sees a backup's time or a cancel
        self.threaded = hedged or threaded
        self.response_type = response_type
        # the tpu_std payload on the wire: compressed once per call
        self.wire_payload = payload
        self.compress_type = CompressType.NONE
        self.results: "queue.Queue" = queue.Queue()
        self.done = False
        self.leases: list = []              # every attempt's shm lease
        self.staged = False                 # an attempt staged a slot
        self.lock = threading.Lock()
        self.conns: Dict[int, "Channel"] = {}   # version -> its server's

    def remaining_s(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()


_tls_contexts: Dict[tuple, Any] = {}
_tls_contexts_lock = threading.Lock()


def _client_tls_context(ca: Optional[str], verify: bool):
    """The process's client TLS context for a CA file and a verification
    setting, made on first use."""
    key = (ca, verify)
    with _tls_contexts_lock:
        ctx = _tls_contexts.get(key)
        if ctx is None:
            import ssl
            ctx = ssl.create_default_context(cafile=ca) if ca \
                else ssl.create_default_context()
            if not verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            _tls_contexts[key] = ctx
        return ctx


class Channel:
    def __init__(self, options: Optional[ChannelOptions] = None,
                 protocol: Optional[str] = None):
        self.options = options or ChannelOptions()
        if protocol is not None:
            self.options.protocol = protocol
        self.server: Optional[EndPoint] = None
        # a cluster channel's LoadBalancerWithNaming, and one sub-channel
        # (the connection state of one server) per endpoint it picked
        self.load_balancer = None
        self._subs: Dict[EndPoint, "Channel"] = {}
        self._subs_lock = threading.Lock()
        self._lock = threading.Lock()
        # the socket map's "single" entries this channel holds a ref on
        self._map_keys: set = set()
        self._method_tlvs: Dict[str, bytes] = {}   # the fast lane's cache
        self._pool: List[Socket] = []   # idle HTTP/1.1 connections
        self._pool_lock = threading.Lock()
        self._retry_budget: Optional[RetryBudget] = None
        self._retry_budget_lock = threading.Lock()

    def ssl_ctx(self):
        """The channel's client TLS context (None when TLS is off): the
        caller's own, else the process's one context for these options,
        so channels with the same TLS options share connections."""
        opts = self.options
        if opts.ssl_context is not None:
            return opts.ssl_context
        if not opts.ssl:
            return None
        return _client_tls_context(opts.ssl_ca, bool(opts.ssl_verify))

    def _conn_key_args(self) -> tuple:
        """``(ssl_context, connect_timeout_s, auth)``: the rest of this
        channel's connection key (``socket_map.conn_key``)."""
        return (self.ssl_ctx(), self.options.connect_timeout_ms / 1e3,
                self.options.auth_data or b"")

    def init(self, addr: Any, lb_name: str = "") -> int:
        """``addr``: "ip:port" or an EndPoint for one server, or a naming
        URL with a load balancer's name (default ``"rr"``) for a cluster.
        0 on success."""
        text = str(addr)
        if not isinstance(addr, EndPoint) and "://" in text:
            from .load_balancer_with_naming import LoadBalancerWithNaming
            lb = LoadBalancerWithNaming()
            if lb.init(text, lb_name or "rr",
                       self.options.enable_circuit_breaker) != 0:
                LOG.error("failed to init naming/LB for %s", text)
                lb.stop()
                return -1
            self.load_balancer = lb
            return 0
        try:
            self.server = addr if isinstance(addr, EndPoint) \
                else parse_endpoint(text)
        except ValueError:
            return -1
        return 0

    def close(self) -> None:
        """Let go of the shared connections (the last channel to a peer
        closes its connection, and with it the streams it carries) and
        close the HTTP connections.  A cluster channel also closes its
        sub-channels and ends its naming refresh (its balancer keeps the
        last server list).  Pooled connections stay in the process's
        pools."""
        with self._subs_lock:
            subs = list(self._subs.values())
        for sub in subs:
            sub.close()
        if self.load_balancer is not None:
            self.load_balancer.stop()
        with self._lock:
            keys, self._map_keys = self._map_keys, set()
        for key in keys:
            global_socket_map().remove(key)
        with self._pool_lock:
            pool, self._pool = self._pool, []
        for sock in pool:
            sock.close()

    @property
    def _sock(self) -> Optional[Socket]:
        """This channel's shared ``"single"`` connection, if open."""
        if self.server is None:
            return None
        return global_socket_map().peek(self.server, *self._conn_key_args())

    def _shared_socket(self) -> Socket:
        """The peer's ``"single"`` connection under this channel's
        signature, from the socket map (the first use takes a ref on it);
        OSError when it cannot be had."""
        ssl, connect_s, auth = self._conn_key_args()
        key = conn_key(self.server, ssl, connect_s, auth)
        if key not in self._map_keys:
            with self._lock:
                if key not in self._map_keys:
                    self._map_keys.add(key)
                    global_socket_map().insert(key)
        sid, rc = global_socket_map().get_socket(
            self.server, ssl, prefer_lane=True, connect_timeout_s=connect_s,
            auth=auth)
        sock = Socket.address(sid) if rc == 0 else None
        if sock is None or sock.failed:
            raise OSError(f"connect to {self.server} failed")
        return sock

    def _sub(self, ep: EndPoint) -> "Channel":
        """The sub-channel holding ``ep``'s connections."""
        sub = self._subs.get(ep)
        if sub is None:
            with self._subs_lock:
                sub = self._subs.get(ep)
                if sub is None:
                    sub = self._subs[ep] = Channel(self.options)
                    sub.server = ep
        return sub

    # -- retry hardening ---------------------------------------------------

    def retry_budget(self) -> Optional[RetryBudget]:
        """This channel's retry-throttling token bucket (None when
        ``retry_budget_max <= 0``)."""
        if self.options.retry_budget_max <= 0:
            return None
        if self._retry_budget is None:
            with self._retry_budget_lock:
                # two threads racing the first retry share one bucket
                if self._retry_budget is None:
                    self._retry_budget = RetryBudget(
                        self.options.retry_budget_max,
                        self.options.retry_budget_ratio)
        return self._retry_budget

    def acquire_retry_token(self) -> bool:
        """Spend one retry/backup token; True when the attempt may go
        (always, with the budget disabled)."""
        budget = self.retry_budget()
        return True if budget is None else budget.acquire()

    def on_call_success(self) -> None:
        """Refill the retry budget on a successful response."""
        budget = self._retry_budget
        if budget is not None:
            budget.on_success()

    # -- calls -------------------------------------------------------------

    def call_method(self, method_full: str, request: Any,
                    response_type: Any = None,
                    done: Optional[Callable] = None,
                    cntl: Optional[Controller] = None,
                    attachment: Any = None) -> Controller:
        """Call ``"Service.Method"`` with a bytes request.  Without
        ``done`` it blocks and the response (parsed as ``response_type``,
        None: bytes) and any error land in the returned controller; with
        ``done`` it returns at once and ``done(cntl)`` runs when the call
        ends."""
        c = cntl or Controller()
        c._channel = self
        if attachment is not None:
            c.request_attachment = bytes(attachment)
        c._open_call_id()
        if done is None:
            try:
                self._call(c, method_full, request, response_type, False)
            finally:
                c._close_call_id()
            return c
        threading.Thread(target=self._call_async,
                         args=(c, method_full, request, response_type, done),
                         name="rpc-async", daemon=True).start()
        return c

    def _call_async(self, c: Controller, method_full: str, request: Any,
                    response_type: Any, done: Callable) -> None:
        try:
            self._call(c, method_full, request, response_type, True)
        except Exception as e:     # never leave an async call without an end
            LOG.exception("async call of %s raised", method_full)
            c.set_failed(Errno.EINTERNAL, f"{type(e).__name__}: {e}")
        c._close_call_id(done)

    def _call(self, c: Controller, method_full: str, request: Any,
              response_type: Any, threaded: bool) -> None:
        stream = c._stream_to_create
        if c.trace_id:
            # an explicitly traced call: its client span opens before the
            # request is framed, so the meta carries this hop's span id
            c._begin_trace_span(method_full)
        if self.server is None and self.load_balancer is None:
            c.set_failed(Errno.EINTERNAL, "channel not initialized")
        elif self.options.protocol not in _PROTOCOLS:
            c.set_failed(Errno.EINTERNAL, "unknown protocol "
                         f"{self.options.protocol!r}")
        elif self.options.protocol != "tpu_std" and (
                stream is not None
                or c.request_device_attachment is not None):
            c.set_failed(Errno.EREQUEST, "streams and device attachments "
                         "ride tpu_std only")
        else:
            try:
                payload = serialize_payload(request)
            except TypeError as e:
                c.set_failed(Errno.EREQUEST, str(e))
            else:
                if self.options.protocol == "grpc":
                    self._call_grpc(c, method_full, payload, response_type)
                elif not threaded and fast_call.eligible(self, c):
                    self._call_fast(c, method_full, payload, response_type)
                else:
                    self._launch(c, method_full, payload, stream,
                                 response_type, threaded)
        if stream is not None and (c.failed
                                   or not stream._established.is_set()):
            # a failed call, or one the server accepted no stream on:
            # the pending stream dies with it
            stream._close_local(notify_peer=False)
        c._end_trace_span(c.remote_side)

    def _call_fast(self, c: Controller, method_full: str, payload: bytes,
                   response_type: Any) -> None:
        """A blocking pooled or short call on the fast lane.  A cancel
        that came first ends it before it starts; a later one ends it
        when its round trip returns (the response is dropped)."""
        cancel = c._attach_call(None)
        if cancel is None:
            fast_call.run(self, c, method_full, payload, response_type,
                          fast_call.channel_method_tlv(self, method_full))
            cancel = c._cancel
        if cancel is not None:
            c.response = None
            c.set_failed(*cancel)

    def _launch(self, c: Controller, method_full: str, payload: bytes,
                stream, response_type: Any = None,
                threaded: bool = False) -> None:
        opts = self.options
        timeout_ms = opts.timeout_ms if c.timeout_ms is None \
            else c.timeout_ms
        # issued from a deadline'd handler, the call never outlives the
        # upstream budget, and fails fast once it is gone
        timeout_ms, expired = cap_timeout_ms(timeout_ms)
        if expired:
            c.set_failed(Errno.ERPCTIMEDOUT,
                         "inherited deadline already expired (doomed "
                         "downstream call failed fast)")
            return
        c.timeout_ms = timeout_ms
        if c.max_retry is None:
            c.max_retry = opts.max_retry
        if c.backup_request_ms is None:
            c.backup_request_ms = opts.backup_request_ms
        if c.connection_type is None:
            c.connection_type = opts.connection_type
        if opts.protocol == "http" and c.connection_type == "single":
            c.connection_type = "pooled"    # http/1 cannot multiplex
        if stream is not None:
            # a stream binds to one long-lived connection: no second
            # attempt could get a second server to accept it
            c.max_retry = 0
            c.backup_request_ms = -1
            c.connection_type = "single"
        if c.connection_type not in _CONNECTION_TYPES:
            c.set_failed(Errno.EINTERNAL, "unknown connection_type "
                         f"{c.connection_type!r}")
            return
        t0 = time.monotonic()
        deadline = t0 + timeout_ms / 1e3 \
            if timeout_ms and timeout_ms > 0 else None
        backup = c.backup_request_ms
        hedged = bool(backup and backup > 0
                      and backup < (timeout_ms or 1 << 30))
        cid_base = fast_call.reserve_cids(c.max_retry + 2)
        call = _Call(c, method_full, payload, stream, cid_base, deadline,
                     timeout_ms, c.connection_type, hedged, threaded,
                     response_type)
        ctype = c.request_compress_type or opts.request_compress_type
        if ctype and opts.protocol == "tpu_std":
            packed = compress_mod.compress(payload, ctype)
            if packed is not None:
                call.wire_payload, call.compress_type = packed, ctype
        cancel = c._attach_call(call)
        if cancel is not None:
            c.set_failed(*cancel)       # cancelled before it started
            return
        self._run(call, t0 + backup / 1e3 if hedged else None)
        c.latency_us = int((time.monotonic() - t0) * 1e6)
        self._feedback(c)

    def _feedback(self, c: Controller) -> None:
        """The finished call's outcome to the balancer (which feeds the
        breaker when it is on), or on a single-server channel to the
        process-wide breaker map."""
        if self.load_balancer is not None:
            self.load_balancer.feedback(c)
        elif self.options.enable_circuit_breaker \
                and c.remote_side is not None:
            global_circuit_breaker_map().on_call(
                c.remote_side, c.error_code, c.latency_us)

    def _on_attempt_answer(self, c: Controller, version: int, rmeta) -> None:
        """The lame-duck registry learns from every answer of a live
        attempt: a draining server's TLV (or its ``ELAMEDUCK`` without
        one) marks it, a clean answer clears a restarted successor."""
        remote = c.attempt_remotes.get(version, c.remote_side)
        if rmeta.lame_duck or rmeta.error_code == _ELAMEDUCK:
            global_lame_ducks().mark(remote)
        elif not rmeta.error_code:
            global_lame_ducks().clear(remote)

    def _on_attempt_superseded(self, c: Controller, version: int,
                               code: int) -> None:
        """A failed attempt that does not decide the call: its server is
        excluded from the call's later picks and feeds the breaker (the
        deciding outcome goes through :meth:`_feedback`)."""
        remote = c.attempt_remotes.get(version)
        if remote is None:
            return
        c.excluded_servers.add(remote)
        if self.options.enable_circuit_breaker:
            global_circuit_breaker_map().on_call(remote, code, 0)

    def _run(self, call: _Call, backup_at: Optional[float]) -> None:
        """The attempts of one call until it has an outcome (the JAX
        ``Controller``'s ``_retry_locked``, ``_on_id_error`` and backoff
        trampolines, on the caller's thread)."""
        c = call.c
        live = {0}
        nretry = 0
        last_err = None
        pending = None          # (version, time) of a backed-off retry
        self._start(call, 0)
        while True:
            try:
                version, kind, data = call.results.get_nowait()
            except queue.Empty:
                now = time.monotonic()
                if backup_at is not None and now >= backup_at:
                    backup_at = None
                    if nretry < c.max_retry and self.acquire_retry_token():
                        c.has_backup_request = True
                        # the backup goes to another server than the
                        # attempts still out (brpc's backup request)
                        c.excluded_servers.update(
                            c.attempt_remotes[v] for v in live
                            if v in c.attempt_remotes)
                        nretry += 1
                        c.retried_count = nretry
                        live.add(nretry)
                        self._start(call, nretry)
                    continue
                if pending is not None and now >= pending[1]:
                    version, pending = pending[0], None
                    if version == nretry:
                        self._start(call, version)
                        continue
                    # a backup took this version's place during the
                    # backoff: retire it rather than duplicate the cid
                    live.discard(version)
                    if not live:
                        code, text = last_err or (
                            int(Errno.ERPCTIMEDOUT),
                            "all attempts failed during retry backoff")
                        self._finish(call, code, text)
                        return
                    continue
                if call.deadline is not None and now >= call.deadline:
                    self._finish(call, int(Errno.ERPCTIMEDOUT),
                                 f"deadline {call.timeout_ms}ms exceeded")
                    return
                wakes = [t for t in (call.deadline, backup_at,
                                     pending[1] if pending else None)
                         if t is not None]
                wait = max(0.0, min(wakes) - now) if wakes else None
                try:
                    version, kind, data = call.results.get(timeout=wait)
                except queue.Empty:
                    continue
            if kind == "cancel":
                self._finish(call, *data)
                return
            if version not in live:
                self._discard(call, kind, data)     # a stale attempt's
                continue
            if kind == "timeout":
                self._finish(call, int(Errno.ERPCTIMEDOUT),
                             f"deadline {call.timeout_ms}ms exceeded")
                return
            if kind == "msg":
                code, text = data[0].error_code, data[0].error_text
                self._on_attempt_answer(c, version, data[0])
                if not code:
                    self._win(call, version, data)
                    return
            else:
                code, text = data
            live.discard(version)
            if c.retry_policy(c, code) and nretry < c.max_retry \
                    and self.acquire_retry_token():
                self._on_attempt_superseded(c, version, code)
                if kind == "msg":
                    self._discard(call, kind, data)
                nretry += 1
                c.retried_count = nretry
                live.add(nretry)
                delay = 0.0 if code in _FAIL_FAST else backoff_ms(
                    self.options.retry_backoff_ms, nretry,
                    self.options.retry_backoff_max_ms)
                if delay > 0:
                    pending = (nretry, time.monotonic() + delay / 1e3)
                else:
                    self._start(call, nretry)
                continue
            if kind == "msg":
                self._win(call, version, data)  # the server's error answer
                return
            if live:
                # another attempt is still out: it decides the call, and
                # this failure is kept for a retired backoff version
                self._on_attempt_superseded(c, version, code)
                last_err = (code, text)
                continue
            self._finish(call, code, text)
            return

    def _start(self, call: _Call, version: int) -> None:
        """Pick attempt ``version``'s server (the balancer's, on a cluster
        channel) and issue it: inline, or on a thread of its own when the
        call may hedge (its result lands on ``call.results`` either
        way)."""
        c = call.c
        if self.load_balancer is None:
            remote, conn = self.server, self
        else:
            remote = self.load_balancer.select_server(c)
            if remote is None:
                call.results.put((version, "err", (int(Errno.EINTERNAL),
                                                   "no server available")))
                return
            conn = self._sub(remote)
        c.remote_side = remote
        c.attempt_remotes[version] = remote
        call.conns[version] = conn
        if call.threaded:
            threading.Thread(target=self._attempt, args=(call, version),
                             name="tpu_std-attempt", daemon=True).start()
        else:
            self._attempt(call, version)

    def _finish(self, call: _Call, code: int, text: str) -> None:
        with call.lock:
            call.done = True
            leases, call.leases = call.leases, []
        for lease in leases:
            shm_ring.client_complete(lease)
        if code:
            call.c.set_failed(code, text)
        else:
            self.on_call_success()      # refill the retry budget
        self._drain_results(call)

    def _drain_results(self, call: _Call) -> None:
        """Attempts that answered after the outcome: their responses are
        dropped (their socket is released by the attempt itself)."""
        while True:
            try:
                _, kind, data = call.results.get_nowait()
            except queue.Empty:
                return
            self._discard(call, kind, data)

    def _discard(self, call: _Call, kind: str, data) -> None:
        """Drop a response no one takes: the credit of a device
        descriptor on it goes back, and a pooled or short connection that
        carried it closes."""
        if kind != "msg":
            return
        rmeta, _, _, sock, _, _ = data
        ack_unused(rmeta, sock.id)
        if call.ctype != "single":
            sock.close()

    def _attempt(self, call: _Call, version: int) -> None:
        c = call.c
        meta = RpcMeta()
        meta.correlation_id = call.cid_base + version
        meta.service_name, _, meta.method_name = call.method.rpartition(".")
        left = call.remaining_s()
        if left is not None:
            # every attempt stamps what is left of the call's budget
            meta.timeout_ms = max(1, int(left * 1000))
        meta.trace_id, meta.span_id = c.trace_id, c.span_id
        if self.options.tenant:
            meta.tenant = str(self.options.tenant).encode("utf-8")
        if self.options.auth_data:
            # credentials ride every frame; the server verifies them on
            # the connection's first message
            auth = self.options.auth_data
            meta.auth_data = auth.encode() if isinstance(auth, str) else auth
        meta.compress_type = call.compress_type
        conn = call.conns[version]
        try:
            if self.options.protocol == "http":
                result = conn._attempt_http(call, meta)
            elif call.ctype == "single":
                result = conn._attempt_single(call, meta)
            else:
                result = conn._attempt_owned(call, meta)
        except Exception as e:     # never leave the call without a result
            result = ("err", (int(Errno.EINTERNAL),
                              f"{type(e).__name__}: {e}"))
        if result is not None:      # else the reader delivered it
            self._deliver(call, version, result)

    def _deliver(self, call: _Call, version: int, result: tuple) -> None:
        """Attempt ``version``'s result onto the call; one that lands
        after the call's outcome is dropped at once."""
        call.results.put((version,) + result)
        with call.lock:
            late = call.done
        if late:
            self._drain_results(call)

    def _stage(self, call: _Call, sock: Socket, meta: RpcMeta,
               timeout_s: Optional[float]):
        """The attempt's request frame and shm lease: ``(frame, lease,
        offered, error)`` (``error`` a ``(code, text)`` or None).  A
        later attempt while an earlier one staged a slot stays off the
        shm lane (the earlier descriptor may still be unread)."""
        with call.lock:
            multi = call.staged
        frame, lease, offered, err = self._request_frame(
            call.c, sock, meta, call.wire_payload, timeout_s, multi)
        if lease is not None:
            with call.lock:
                call.staged = True
                call.leases.append(lease)
        return frame, lease, offered, err

    def _attempt_single(self, call: _Call, meta: RpcMeta):
        """One attempt on the peer's shared connection: registered under
        its correlation id (with the client lane too) before the write,
        then waited for.  A timeout fails this attempt alone; a write
        error fails the connection.  The result, or None when the reader
        delivered the response onto the call."""
        stream = call.stream
        cid = meta.correlation_id
        try:
            sock = self._shared_socket()
            if stream is not None:
                meta.stream_id = stream.id
                meta.stream_window = stream.options.max_buf_size
                if not stream._attach(sock.id):
                    raise OSError("connection closed")
            frame, lease, offered, err = self._stage(call, sock, meta,
                                                     call.remaining_s())
            if err is not None:
                return "err", err
            waiter = _Waiter(self, call, cid - call.cid_base, lease, offered)
            if not sock.add_waiter(cid, waiter):
                raise OSError("connection closed")
            lane_expect(sock, cid)
            try:
                sock.write(frame)
            except OSError as e:
                sock.pop_waiter(cid)
                lane_cancel(sock, cid)
                sock.set_failed(int(Errno.EFAILEDSOCKET), str(e))
                raise
        except (OSError, EOFError, FrameError) as e:
            return "err", (int(Errno.EFAILEDSOCKET),
                           f"{type(e).__name__}: {e}")
        left = call.remaining_s()
        if not waiter.done.wait(None if left is None else max(left, 0.0)):
            if sock.pop_waiter(cid) is not None:
                lane_cancel(sock, cid)
                return "timeout", None
            waiter.done.wait()      # its response is being handed over
        lane_cancel(sock, cid)
        if waiter.error is not None:
            return "err", (int(Errno.EFAILEDSOCKET), waiter.error)
        return None                 # the reader delivered the response

    def _attempt_owned(self, call: _Call, meta: RpcMeta) -> tuple:
        """One attempt on a connection of its own: from the pool
        (``"pooled"``) or fresh (``"short"``).  A pooled connection goes
        back to the pool only after a call it won.  An async or hedged
        call's connection becomes dispatcher-driven
        (``Socket.ensure_dispatched``, as the JAX controller converts
        it): its response reaches the attempt like a ``"single"`` one's;
        a blocking call reads its connection itself."""
        sock = None
        try:
            ssl, connect_s, auth = self._conn_key_args()
            sid, rc = pooled_socket(self.server, ssl, connect_s, auth) \
                if call.ctype == "pooled" \
                else short_socket(self.server, ssl, connect_s)
            sock = Socket.address(sid) if rc == 0 else None
            if sock is None:
                raise OSError(f"connect to {self.server} failed")
            if call.threaded:
                sock.ensure_dispatched()
            if not sock.direct_read:
                return self._attempt_dispatched(call, meta, sock)
            left = call.remaining_s()
            frame, lease, offered, err = self._stage(call, sock, meta, left)
            if err is not None:
                self._release_owned(call, sock, ok=True)
                return "err", err
            sock.conn.settimeout(NO_DEADLINE_S if left is None
                                 else max(left, 1e-3))
            sock.write(frame)
            msg = self._read_response(sock)
        except socket.timeout:
            sock.close()
            return "timeout", None
        except (OSError, EOFError, FrameError) as e:
            if sock is not None:
                sock.close()
            return "err", (int(Errno.EFAILEDSOCKET),
                           f"{type(e).__name__}: {e}")
        if msg[0].correlation_id != meta.correlation_id:
            ack_unused(msg[0], sock.id)
            sock.close()
            return "err", (int(Errno.ERESPONSE),
                           f"response for call {msg[0].correlation_id}, "
                           f"expected {meta.correlation_id}")
        return "msg", (msg[0], msg[1], msg[2], sock, lease, offered)

    def _attempt_dispatched(self, call: _Call, meta: RpcMeta,
                            sock: Socket):
        """An owned attempt on a dispatcher-driven connection: waited for
        as on ``"single"``; a timeout or an error closes the
        connection."""
        cid = meta.correlation_id
        frame, lease, offered, err = self._stage(call, sock, meta,
                                                 call.remaining_s())
        if err is not None:
            self._release_owned(call, sock, ok=True)
            return "err", err
        waiter = _Waiter(self, call, cid - call.cid_base, lease, offered)
        if not sock.add_waiter(cid, waiter):
            sock.close()
            return "err", (int(Errno.EFAILEDSOCKET), "connection closed")
        try:
            sock.write(frame)
        except OSError as e:
            sock.pop_waiter(cid)
            sock.close()
            return "err", (int(Errno.EFAILEDSOCKET),
                           f"{type(e).__name__}: {e}")
        left = call.remaining_s()
        if not waiter.done.wait(None if left is None else max(left, 0.0)):
            if sock.pop_waiter(cid) is not None:
                sock.close()
                return "timeout", None
            waiter.done.wait()      # its response is being handed over
        if waiter.error is not None:
            sock.close()
            return "err", (int(Errno.EFAILEDSOCKET), waiter.error)
        return None                 # the messenger delivered the response

    def _attempt_http(self, call: _Call, meta: RpcMeta) -> tuple:
        """One HTTP/1.1 attempt on a connection of its own (pooled or
        short), its response cut on this thread: the result in the
        tpu_std attempt's shape, the meta from
        ``controller.process_http_response``.  A response that closes
        the connection keeps it out of the pool."""
        c = call.c
        sock = None
        if call.ctype == "pooled":
            with self._pool_lock:
                while self._pool and sock is None:
                    s = self._pool.pop()
                    if not s.failed:
                        sock = s
        headers = []
        att = bytes(c.request_attachment or b"")
        if att:
            headers.append(("x-rpc-attachment-size", str(len(att))))
        if meta.timeout_ms:
            # x-deadline-ms: the HTTP/1.1 spelling of TLV 13, what is
            # left of the call's budget for this attempt
            headers.append(("x-deadline-ms", str(meta.timeout_ms)))
        if c.trace_id and c.span_id:
            headers.append(("traceparent",
                            format_traceparent(c.trace_id, c.span_id)))
        if self.options.tenant:
            headers.append(("x-tenant", str(self.options.tenant)))
        try:
            if sock is None:
                sock = self._dial()
            frame = build_request(
                "POST", f"/{meta.service_name}/{meta.method_name}",
                body=bytes(call.payload) + att, host=str(self.server),
                headers=headers or None)
            left = call.remaining_s()
            sock.conn.settimeout(None if left is None else max(left, 1e-3))
            sock.write(frame)
            msg = _read_http_response(sock)
        except socket.timeout:
            sock.close()
            return "timeout", None
        except (OSError, EOFError, FrameError) as e:
            if sock is not None:
                sock.close()
            return "err", (int(Errno.EFAILEDSOCKET),
                           f"{type(e).__name__}: {e}")
        if not msg.keep_alive:
            sock.failed = True          # not pooled: _release_owned closes
        rmeta, body, ratt = process_http_response(msg)
        rmeta.correlation_id = meta.correlation_id
        return "msg", (rmeta, body, ratt, sock, None, False)

    def _call_grpc(self, c: Controller, method_full: str,
                   payload: bytes, response_type: Any = None) -> None:
        """gRPC unary over the peer's multiplexed h2 connection: one
        attempt (a cluster channel's balancer picks its server),
        ``grpc-timeout`` the call's budget capped by an inherited
        deadline, ``traceparent`` and ``x-tenant`` as HPACK metadata."""
        from ..protocol.h2_rpc import errno_of_grpc_status
        from .grpc_client import grpc_connection
        cancel = c._attach_call(None)
        if cancel is not None:
            c.set_failed(*cancel)       # cancelled before it started
            return
        remote = self.server
        if remote is None:
            remote = self.load_balancer.select_server(c)
        if remote is None:
            c.set_failed(Errno.EINTERNAL, "no server available")
            return
        c.remote_side = remote
        tmo_ms, expired = cap_timeout_ms(
            c.timeout_ms or self.options.timeout_ms or 30000)
        if expired:
            c.set_failed(Errno.ERPCTIMEDOUT,
                         "inherited deadline already expired (doomed "
                         "downstream call failed fast)")
            return
        metadata = []
        if c.trace_id and c.span_id:
            metadata.append(("traceparent",
                             format_traceparent(c.trace_id, c.span_id)))
        if self.options.tenant:
            metadata.append(("x-tenant", str(self.options.tenant)))
        svc, _, mth = method_full.rpartition(".")
        t0 = time.monotonic()
        status, message, body = grpc_connection(
            remote, self.ssl_ctx()).unary_call(
            f"/{svc}/{mth}", payload, timeout_s=tmo_ms / 1e3,
            metadata=metadata or None)
        c.latency_us = int((time.monotonic() - t0) * 1e6)
        if status != 0:
            c.set_failed(errno_of_grpc_status(status),
                         f"grpc-status {status}: {message}")
        else:
            try:
                c.response = parse_payload(body, response_type)
                self.on_call_success()
            except Exception as e:
                c.set_failed(Errno.ERESPONSE, f"response parse failed: {e}")
        self._feedback(c)

    def grpc_stream(self, method_full: str,
                    timeout_ms: Optional[int] = None, metadata=None):
        """Open a full-duplex gRPC stream to a single-server channel:
        a ``GrpcStreamCall`` with ``write``/``read``/``done_writing``/
        ``status``."""
        from .grpc_client import grpc_connection
        if self.server is None:
            raise RpcError(int(Errno.EINTERNAL),
                           "grpc_stream needs a single-server channel")
        svc, _, mth = method_full.rpartition(".")
        timeout_s = (timeout_ms or self.options.timeout_ms or 30000) / 1e3
        return grpc_connection(self.server, self.ssl_ctx()).streaming_call(
            f"/{svc}/{mth}", timeout_s, metadata)

    def _win(self, call: _Call, version: int, data) -> None:
        """The call's outcome is attempt ``version``'s response (success or
        the server's error answer): settle its shm lease and resolve its
        descriptor, split its device attachment, bind the stream."""
        c = call.c
        conn = call.conns[version]
        c.remote_side = c.attempt_remotes.get(version, c.remote_side)
        rmeta, body, ratt, sock, lease, offered = data
        with call.lock:
            call.done = True
            others = [x for x in call.leases if x is not lease]
            call.leases = []
        for other in others:
            shm_ring.client_complete(other)
        owned = call.ctype != "single"
        if rmeta.ici_domain:
            sock.ici_peer_domain = rmeta.ici_domain
        view = settle = None
        if rmeta.shm_offer or rmeta.shm_accept or rmeta.shm_desc \
                or offered or lease is not None:
            # learn the accept and the server's ring, settle the request
            # slot, resolve a response descriptor (an error answer proves
            # nothing about the capability)
            try:
                view, settle = shm_ring.client_on_response_meta(
                    sock, rmeta, offered_now=offered and not rmeta.error_code,
                    staged_slot=lease)
            except shm_ring.ShmDescriptorError as e:
                ack_unused(rmeta, sock.id)
                if owned:
                    sock.close()
                c.set_failed(Errno.ERESPONSE, str(e))
                self._drain_results(call)
                return
        if rmeta.error_code:
            ack_unused(rmeta, sock.id)
            conn._release_owned(call, sock, ok=False)
            c.set_failed(rmeta.error_code, rmeta.error_text)
            self._drain_results(call)
            return
        try:
            if rmeta.compress_type:
                body = compress_mod.decompress(bytes(body),
                                               rmeta.compress_type)
                if body is None:
                    raise ValueError("undecompressable response")
            c.response = parse_payload(body, call.response_type)
        except Exception as e:
            ack_unused(rmeta, sock.id)
            conn._release_owned(call, sock, ok=False)
            c.set_failed(Errno.ERESPONSE, f"response parse failed: {e}")
            self._drain_results(call)
            return
        self.on_call_success()
        c.response_attachment, c.response_device_attachment = \
            split_device_attachment(rmeta, ratt, sock.id)
        if view is not None:
            # the attachment rode the ring: its slot recycles when the
            # caller drops the view
            c.response_attachment = shm_ring.settled_view(view, settle)
        if call.stream is not None and rmeta.stream_id:
            # the accepted stream rides the connection that answered
            call.stream._bind(sock.id, rmeta.stream_id,
                              peer_window=rmeta.stream_window)
        conn._release_owned(call, sock, ok=True)
        self._drain_results(call)

    def _release_owned(self, call: _Call, sock: Socket, ok: bool) -> None:
        """A won pooled connection returns to its pool (the channel's own
        for HTTP); every other owned connection closes."""
        if call.ctype == "single":
            return
        if ok and call.ctype == "pooled" and not sock.failed:
            if self.options.protocol == "http":
                with self._pool_lock:
                    self._pool.append(sock)
            else:
                return_pooled_socket(sock.id)
        else:
            sock.close()

    @staticmethod
    def _read_response(sock: Socket):
        """The next response on ``sock``, read inline by the call that
        owns the connection; acks and stream frames ahead of it are
        handed on."""
        while True:
            msg = read_frame(sock.conn)
            if isinstance(msg, AckFrame):
                process_ack(msg.ids, sock)
            elif isinstance(msg, StreamFrame):
                dispatch(msg, sock)
            else:
                return msg

    def _dial(self) -> Socket:
        """A fresh connection of the channel's own (HTTP/1.1)."""
        return Socket(dial(self.server, self.options.connect_timeout_ms / 1e3,
                           self.ssl_ctx()))

    @staticmethod
    def _request_frame(c: Controller, sock: Socket, meta: RpcMeta,
                       payload: bytes, timeout_s: Optional[float],
                       multi_attempt: bool = False):
        """``(frame, shm slot lease, offer carried, error)``: the request
        frame, with the domain exchange, the device attachment and the
        shm lane; ``error`` is a ``(code, text)`` and the frame None when
        it cannot be built."""
        if ici_enabled():
            meta.ici_domain = local_domain_id()
            meta.ici_conn = conn_nonce_of(sock)
        attachment = c.request_attachment
        device = c.request_device_attachment is not None
        if device:
            # with ici off prepare_send sends the bytes inline itself: the
            # attachment is never dropped
            wait_s = _MAX_POST_WAIT_S if timeout_s is None else \
                min(_MAX_POST_WAIT_S, max(0.001, timeout_s))
            try:
                tail = prepare_send(sock, meta, c.request_device_attachment,
                                    timeout_s=wait_s)
            except RuntimeError as e:
                return None, None, False, (int(Errno.EOVERCROWDED), str(e))
            if tail is not None:
                attachment = bytes(attachment) + tail if attachment else tail
        extra, lease, offered = b"", None, False
        if attachment or sock.shm is not None:
            extra, wire, lease, offered = shm_ring.client_prepare(
                sock, attachment or None, device=device,
                multi_attempt=multi_attempt)
            attachment = b"" if wire is None else wire
        try:
            return pack_frame(meta, payload, attachment, extra), lease, \
                offered, None
        except FrameError as e:
            shm_ring.client_complete(lease)
            return None, None, False, (int(Errno.EREQUEST), str(e))

    def call(self, method_full: str, request: Any,
             timeout_ms: Optional[int] = None,
             response_type: Any = None) -> Any:
        """``channel.call("LM.Info", b"")`` -> the response, or raises
        :class:`RpcError`."""
        cntl = Controller()
        cntl.timeout_ms = timeout_ms
        c = self.call_method(method_full, request, response_type, cntl=cntl)
        if c.failed:
            raise RpcError(c.error_code, c.error_text)
        return c.response

    def call_raw(self, method_full: str, payload, attachment=b"",
                 timeout_ms: Optional[int] = None):
        """The raw lane (pairs with ``@raw_method`` on the server): bytes
        in, ``(response_view, attachment_view)`` out, views into the
        response frame.  No Controller, one attempt, no balancer; raises
        :class:`RpcError`.  An attachment view that rode the shm lane
        aliases a ring slot recycled at this thread's next call on the
        channel: consume or copy it before then."""
        return fast_call.run_raw(self, method_full, payload, attachment,
                                 timeout_ms)

    def call_batch(self, method_full: str, requests,
                   response_type: Any = None,
                   timeout_ms: Optional[int] = None) -> list:
        """Pipelined unary calls: every request on one pooled connection
        in one vectored write, the responses matched by correlation id.
        A cluster channel, TLS or another protocol makes one call per
        request.  Raises :class:`RpcError` on the first failure."""
        if self.server is None and self.load_balancer is None:
            raise RpcError(int(Errno.EINTERNAL), "channel not initialized")
        if self.options.protocol != "tpu_std" or self.ssl_ctx() is not None:
            return [self.call(method_full, r, timeout_ms=timeout_ms,
                              response_type=response_type)
                    for r in requests]
        return fast_call.run_batch(
            self, method_full, list(requests), response_type, timeout_ms,
            fast_call.channel_method_tlv(self, method_full))


def _read_http_response(sock: Socket):
    """Cut one HTTP/1.1 response off ``sock`` (blocking), keeping bytes
    read past it in the socket's portal for the next attempt."""
    if sock.read_portal is None:
        sock.read_portal = IOPortal()
    portal = sock.read_portal
    while True:
        if len(portal) >= 4:
            r = http_parse(portal, sock, False, None)
            if r.ok:
                if r.message.is_request:
                    raise FrameError("an HTTP request where a response "
                                     "was expected")
                return r.message
            if r.error != ParseError.NOT_ENOUGH_DATA:
                raise FrameError(f"unparsable HTTP response "
                                 f"({portal.fetch(16)!r})")
        if portal.append_from_socket(sock.conn, 65536) == 0:
            raise EOFError("connection closed before the HTTP response")
