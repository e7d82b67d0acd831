"""The fault-injection suite of ``tests/test_fault_injection.py``, every
case, against ``brpc_tpu_torch``: the full client/server stack through a
fault-injecting transport (``tests/fault_proxy.py``: drops, delays,
partitions, corruption, reordering), naming churned during in-flight
calls, stream close raced against writes, correlation-id versions
recycled, the raw lane and device attachments through the proxy, the
shed under an injected delay, the retry storm capped by the budget and
the breaker tripped from the raw lane.

Three cases also run across the packages through the proxy, the port's
client against the JAX server and the JAX client against the port's
server: the clean baseline, the cut mid-response with retries and the
corrupted byte.  The port's idiom where it differs: device attachments
are torch tensors redeemed with ``tensor(device="cpu")``.  Every call
carries its own time limit, as in the JAX file."""

import threading
import time

import pytest
import torch

from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import ChannelOptions as JChannelOptions
from brpc_tpu.client import Controller as JController
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
from brpc_tpu_torch.server import Server, Service
from fault_proxy import FaultyTransport

# the client package by name: the cross-package cases pick the JAX client
CLIENTS = {"port": (Channel, ChannelOptions, Controller),
           "jax": (JChannel, JChannelOptions, JController)}
# (server behind the proxy, client) of the cross-package cases
CROSS = pytest.mark.parametrize(
    "proxy,client", [("port", "port"), ("jax", "port"), ("port", "jax")],
    ids=["port", "port-client-jax-server", "jax-client-port-server"],
    indirect=["proxy"])


class Echo(Service):
    def Echo(self, cntl, request):
        return request

    def Slow(self, cntl, request):
        time.sleep(0.2)
        return b"slow"


class JEcho(JService):
    def Echo(self, cntl, request):
        return request


@pytest.fixture(scope="module")
def backend():
    srv = Server()
    srv.add_service(Echo(), name="E")
    assert srv.start("127.0.0.1:0") == 0
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def jax_backend():
    srv = JServer()
    srv.add_service(JEcho(), name="E")
    assert srv.start("127.0.0.1:0") == 0
    yield srv
    srv.stop()


@pytest.fixture()
def proxy(request, backend):
    """The proxy in front of the port's server, or of the JAX server when
    the case is parametrized with ``"jax"``."""
    srv = backend
    if getattr(request, "param", "port") == "jax":
        srv = request.getfixturevalue("jax_backend")
    ep = srv.listen_endpoint
    p = FaultyTransport(ep.host, ep.port)
    yield p
    p.close()


def _channel(proxy, timeout_ms=2000, max_retry=3, ctype="pooled",
             client="port"):
    channel, options, _ = CLIENTS[client]
    co = options()
    co.timeout_ms = timeout_ms
    co.max_retry = max_retry
    co.connection_type = ctype
    ch = channel(co)
    assert ch.init(proxy.address) == 0
    return ch


@CROSS
def test_clean_proxy_baseline(proxy, client):
    ch = _channel(proxy, client=client)
    for i in range(10):
        assert ch.call("E.Echo", b"m%d" % i) == b"m%d" % i


def test_injected_delay_adds_latency_then_heals(proxy):
    ch = _channel(proxy, timeout_ms=5000)
    assert ch.call("E.Echo", b"warm") == b"warm"
    proxy.delay_s = 0.15
    cntl = Controller()
    cntl.timeout_ms = 5000
    ch.call_method("E.Echo", b"delayed", cntl=cntl)
    assert not cntl.failed
    assert cntl.latency_us >= 140_000          # both directions delayed
    proxy.heal()
    cntl = Controller()
    cntl.timeout_ms = 5000
    ch.call_method("E.Echo", b"fast-again", cntl=cntl)
    assert not cntl.failed and cntl.latency_us < 140_000


def test_delay_beyond_deadline_times_out_and_recovers(proxy):
    ch = _channel(proxy, timeout_ms=300, max_retry=0)
    assert ch.call("E.Echo", b"warm") == b"warm"
    proxy.delay_s = 1.0
    cntl = Controller()
    cntl.timeout_ms = 300
    ch.call_method("E.Echo", b"too-slow", cntl=cntl)
    assert cntl.failed and cntl.error_code == int(Errno.ERPCTIMEDOUT)
    proxy.heal()
    # the timed-out pooled connection was failed, a fresh one works
    assert ch.call("E.Echo", b"recovered") == b"recovered"


def test_connection_cut_mid_response_fails_cleanly(proxy):
    ch = _channel(proxy, timeout_ms=2000, max_retry=0)
    assert ch.call("E.Echo", b"warm") == b"warm"
    proxy.drop_after_bytes = proxy.forwarded_bytes + 10   # cut mid-frame
    cntl = Controller()
    cntl.timeout_ms = 2000
    ch.call_method("E.Echo", b"x" * 4096, cntl=cntl)
    assert cntl.failed
    proxy.heal()
    assert ch.call("E.Echo", b"back") == b"back"


@CROSS
def test_connection_cut_with_retries_succeeds(proxy, client):
    ch = _channel(proxy, timeout_ms=5000, max_retry=3, client=client)
    assert ch.call("E.Echo", b"warm") == b"warm"
    proxy.drop_after_bytes = proxy.forwarded_bytes + 5
    # first attempt dies on the cut; the retry reconnects (cut cleared
    # once tripped by the break) and must succeed
    cntl = CLIENTS[client][2]()
    cntl.timeout_ms = 5000
    proxy.drop_after_bytes = proxy.forwarded_bytes + 5
    ch.call_method("E.Echo", b"retry-me", cntl=cntl)
    proxy.heal()
    if cntl.failed:
        # retried attempts may race the cut marker; the channel must
        # still converge once healed
        assert ch.call("E.Echo", b"converged") == b"converged"
    else:
        assert cntl.response == b"retry-me"


def test_partition_then_heal(proxy):
    ch = _channel(proxy, timeout_ms=400, max_retry=1)
    assert ch.call("E.Echo", b"warm") == b"warm"
    proxy.partition = True
    cntl = Controller()
    cntl.timeout_ms = 400
    t0 = time.monotonic()
    ch.call_method("E.Echo", b"void", cntl=cntl)
    assert cntl.failed
    assert time.monotonic() - t0 < 5.0
    proxy.partition = False
    proxy.kill_connections()          # stale blackholed conns die
    assert ch.call("E.Echo", b"healed") == b"healed"


@CROSS
def test_corrupted_byte_detected(proxy, client):
    ch = _channel(proxy, timeout_ms=2000, max_retry=0, client=client)
    assert ch.call("E.Echo", b"warm") == b"warm"
    # the pumps count forwarded bytes AFTER sendall, so the client can
    # see the warm response before the counter includes it — wait for
    # the counter to go quiet or the +2 offset can land in the past
    # (never matching) and the poisoned call sails through clean
    stable, deadline = -1, time.time() + 2.0
    while time.time() < deadline:
        cur = proxy.forwarded_bytes
        if cur == stable:
            break
        stable = cur
        time.sleep(0.05)
    proxy.corrupt_byte_at = proxy.forwarded_bytes + 2   # clobber a header
    cntl = CLIENTS[client][2]()
    cntl.timeout_ms = 2000
    ch.call_method("E.Echo", b"poisoned", cntl=cntl)
    # corruption may hit the request (server kills conn) or the
    # response (client parse fails): either way the call must FAIL,
    # never deliver corrupt payload silently
    assert cntl.failed
    proxy.heal()
    assert ch.call("E.Echo", b"clean") == b"clean"


def test_reordered_segments_still_parse_or_fail(proxy):
    """TCP-level reordering through the proxy (bytes swap across
    segments): the framed parser must either reassemble correctly (if
    offsets happen to align) or fail the connection — never deliver
    wrong bytes as a valid response."""
    ch = _channel(proxy, timeout_ms=2000, max_retry=3)
    assert ch.call("E.Echo", b"warm") == b"warm"
    proxy.reorder_window = 2
    payload = bytes(range(256)) * 64          # multi-segment
    for _ in range(3):
        cntl = Controller()
        cntl.timeout_ms = 2000
        ch.call_method("E.Echo", payload, cntl=cntl)
        if not cntl.failed:
            assert cntl.response == payload
    proxy.heal()
    assert ch.call("E.Echo", b"after") == b"after"


# -- naming churn during in-flight traffic ----------------------------------

def test_naming_churn_under_load(backend):
    """Cluster channel whose server list flips every few ms while calls
    are in flight: no crashes, and calls keep succeeding (retries may
    fire, wrong-server attempts excluded)."""
    srv2 = Server()
    srv2.add_service(Echo(), name="E")
    assert srv2.start("127.0.0.1:0") == 0
    try:
        ep1, ep2 = backend.listen_endpoint, srv2.listen_endpoint
        co = ChannelOptions()
        co.timeout_ms = 2000
        ch = Channel(co)
        assert ch.init(f"list://{ep1},{ep2}", "rr") == 0
        lb = ch.load_balancer

        stop = threading.Event()

        def churn():
            from brpc_tpu_torch.client.naming_service import ServerNode
            flip = False
            while not stop.is_set():
                flip = not flip
                nodes = [ServerNode(endpoint=ep1)] if flip else \
                    [ServerNode(endpoint=ep1), ServerNode(endpoint=ep2)]
                lb._lb.reset_servers(nodes) if hasattr(lb, "_lb") \
                    else lb.reset_servers(nodes)
                time.sleep(0.002)

        t = threading.Thread(target=churn)
        t.start()
        try:
            ok = 0
            for i in range(300):
                cntl = Controller()
                cntl.timeout_ms = 2000
                ch.call_method("E.Echo", b"c%d" % i, cntl=cntl)
                if not cntl.failed:
                    ok += 1
            assert ok >= 295, f"only {ok}/300 under naming churn"
        finally:
            stop.set()
            t.join()
    finally:
        srv2.stop()


# -- stream close/write races -----------------------------------------------

def test_stream_close_write_race(backend):
    from brpc_tpu_torch.streaming import (StreamOptions, stream_accept,
                                          stream_create)

    class Sink(Service):
        def Start(self, cntl, request):
            stream_accept(cntl, StreamOptions(on_received=lambda s, m: None))
            return b"ok"

    srv = Server()
    srv.add_service(Sink(), name="SK")
    assert srv.start("127.0.0.1:0") == 0
    try:
        for round_ in range(10):
            ch = Channel()
            ch.init(str(srv.listen_endpoint))
            cntl = Controller()
            cntl.timeout_ms = 3000
            stream = stream_create(cntl, StreamOptions())
            c = ch.call_method("SK.Start", b"", cntl=cntl)
            assert not c.failed, c.error_text
            errs = []

            def writer():
                for _ in range(100):
                    rc = stream.write(b"data")
                    if rc != 0:
                        errs.append(rc)
                        return

            w = threading.Thread(target=writer)
            w.start()
            time.sleep(0.001 * (round_ % 4))
            stream.close()
            w.join(5)
            assert not w.is_alive(), "writer deadlocked against close"
            # post-close writes must fail, not hang or crash
            assert stream.write(b"late") != 0
    finally:
        srv.stop()


# -- correlation id version recycling ---------------------------------------

def test_id_version_recycling_rejects_stale():
    from brpc_tpu_torch.fiber.versioned_id import global_id_pool

    idp = global_id_pool()
    seen = set()
    stale = []
    for i in range(2000):
        holder = object()
        cid = idp.create_ranged(holder, lambda *a: None, 4)
        assert cid not in seen          # versions never collide while live
        seen.add(cid)
        ok, data = idp.lock(cid)
        assert ok and data is holder
        idp.unlock_and_destroy(cid)
        stale.append(cid)
    # every destroyed id must refuse to lock (stale version)
    for cid in stale[-50:]:
        ok, _ = idp.lock(cid)
        assert not ok


class RawAndTensor(Service):
    from brpc_tpu_torch.server.service import raw_method

    @raw_method
    def REcho(self, payload, attachment):
        return bytes(payload), attachment

    def TEcho(self, cntl, request):
        att = cntl.request_device_attachment
        if att is not None:
            cntl.response_device_attachment = att.tensor(device="cpu")
        return b"t"


@pytest.fixture(scope="module")
def raw_backend():
    srv = Server()
    srv.add_service(RawAndTensor(), name="RT")
    assert srv.start("127.0.0.1:0") == 0
    yield srv
    srv.stop()


@pytest.fixture()
def raw_proxy(raw_backend):
    ep = raw_backend.listen_endpoint
    p = FaultyTransport(ep.host, ep.port)
    yield p
    p.close()


def test_raw_lane_through_faulty_proxy_baseline(raw_proxy):
    ch = _channel(raw_proxy, timeout_ms=3000)
    for i in range(8):
        r, a = ch.call_raw("RT.REcho", b"p%d" % i, b"a%d" % i,
                           timeout_ms=3000)
        assert bytes(r) == b"p%d" % i and bytes(a) == b"a%d" % i


def test_raw_lane_survives_connection_cut(raw_proxy):
    """Cut the connection mid-traffic: the raw lane reports the failure
    (no retries by contract) and the NEXT call transparently pins a
    fresh connection."""
    from brpc_tpu_torch.client.channel import RpcError
    ch = _channel(raw_proxy, timeout_ms=3000)
    r, _ = ch.call_raw("RT.REcho", b"warm", timeout_ms=3000)
    assert bytes(r) == b"warm"
    raw_proxy.drop_after_bytes = raw_proxy.forwarded_bytes  # cut NOW
    try:
        ch.call_raw("RT.REcho", b"dead", timeout_ms=1000)
    except RpcError:
        pass          # expected: cut or timeout
    raw_proxy.heal()
    deadline = time.time() + 5.0
    ok = False
    while time.time() < deadline and not ok:
        try:
            r, _ = ch.call_raw("RT.REcho", b"back", timeout_ms=2000)
            ok = bytes(r) == b"back"
        except RpcError:
            time.sleep(0.05)
    assert ok, "raw lane never recovered after heal"


def test_raw_lane_with_delay(raw_proxy):
    """An injected 50ms delay must surface as latency, not corruption."""
    ch = _channel(raw_proxy, timeout_ms=5000)
    r, _ = ch.call_raw("RT.REcho", b"warm", timeout_ms=5000)
    raw_proxy.delay_s = 0.05
    t0 = time.time()
    r, _ = ch.call_raw("RT.REcho", b"slowpath", timeout_ms=5000)
    assert bytes(r) == b"slowpath"
    assert time.time() - t0 >= 0.05
    raw_proxy.heal()


def test_device_attachment_calls_through_faulty_proxy(raw_proxy):
    """Device-descriptor RPCs (with piggybacked TICI acks on the wire)
    parse correctly through a proxy that re-segments the byte stream,
    and the window drains."""
    from brpc_tpu_torch.ici.endpoint import live_endpoints

    ch = _channel(raw_proxy, timeout_ms=10_000)
    x = torch.arange(4096, dtype=torch.float32)
    for i in range(6):
        cntl = Controller()
        cntl.timeout_ms = 10_000
        cntl.request_device_attachment = x
        c = ch.call_method("RT.TEcho", b"", cntl=cntl)
        assert not c.failed, (i, c.error_text)
        att = c.response_device_attachment
        assert att is not None
        torch.testing.assert_close(att.tensor(device="cpu"), x,
                                   rtol=0, atol=0)
    deadline = time.time() + 5.0
    while time.time() < deadline:
        if all(ep.outstanding_bytes == 0 for ep in live_endpoints()):
            break
        time.sleep(0.01)
    assert all(ep.outstanding_bytes == 0 for ep in live_endpoints())


def test_corrupted_tici_ack_fails_or_recovers_never_corrupts(raw_proxy):
    """A corrupted byte inside the credit-return path must never make a
    call deliver wrong payload bytes: either the call fails (connection
    killed on parse error) or the payload round-trips intact."""
    ch = _channel(raw_proxy, timeout_ms=5000)
    x = torch.arange(1024, dtype=torch.float32)
    cntl = Controller()
    cntl.timeout_ms = 5000
    cntl.request_device_attachment = x
    c = ch.call_method("RT.TEcho", b"", cntl=cntl)
    assert not c.failed, c.error_text
    c.response_device_attachment.tensor(device="cpu")
    # corrupt a byte a little into the upcoming exchange (lands in the
    # next request frame or its piggybacked ack, depending on timing)
    stable, deadline = -1, time.time() + 2.0
    while time.time() < deadline:
        cur = raw_proxy.forwarded_bytes
        if cur == stable:
            break
        stable = cur
        time.sleep(0.05)
    raw_proxy.corrupt_byte_at = raw_proxy.forwarded_bytes + 5
    cntl = Controller()
    cntl.timeout_ms = 5000
    cntl.request_device_attachment = x
    c = ch.call_method("RT.TEcho", b"", cntl=cntl)
    if not c.failed and c.response_device_attachment is not None:
        torch.testing.assert_close(
            c.response_device_attachment.tensor(device="cpu"), x,
            rtol=0, atol=0)
    raw_proxy.heal()


# -- deadline plane under injected faults -----------------------------------

def test_deadline_expiry_sheds_server_side_under_delay():
    """Through a delay-injecting proxy, a pipelined burst whose first
    request chews the native batch makes the second one's propagated
    budget expire IN QUEUE: the server answers ERPCTIMEDOUT without
    running the handler (deadline plane; ≈ brpc -server_fail_fast)."""
    import socket as pysock
    import struct

    from brpc_tpu_torch.deadline import shed_counters
    from brpc_tpu_torch.protocol.meta import RpcMeta, TLV_CORRELATION, \
        TLV_TIMEOUT, encode_tlv
    from brpc_tpu_torch.server import ServerOptions
    from conftest import require_native
    require_native()

    class SlowEcho(Service):
        def __init__(self):
            self.echo_calls = 0

        def Echo(self, cntl, request):
            self.echo_calls += 1
            return bytes(request)

        def Slow(self, cntl, request):
            time.sleep(0.25)
            return b"slow"

    opts = ServerOptions()
    opts.native = True
    opts.usercode_inline = True
    opts.native_loops = 1
    svc = SlowEcho()
    srv = Server(opts)
    srv.add_service(svc, name="DL")
    assert srv.start("127.0.0.1:0") == 0
    ep = srv.listen_endpoint
    p = FaultyTransport(ep.host, ep.port)
    try:
        p.delay_s = 0.02

        def frame(cid, mth, payload, tmo=None):
            mb = TLV_CORRELATION + struct.pack("<Q", cid)
            mb += encode_tlv(4, b"DL") + encode_tlv(5, mth)
            if tmo is not None:
                mb += TLV_TIMEOUT + struct.pack("<I", tmo)
            body = mb + payload
            return b"TRPC" + struct.pack("<II", len(body), len(mb)) + body

        before = shed_counters().get(("slim", "DL.Echo"), 0)
        with pysock.create_connection(("127.0.0.1", p.port),
                                      timeout=10) as c:
            c.sendall(frame(1, b"Slow", b"") +
                      frame(2, b"Echo", b"doomed", tmo=60))
            c.settimeout(10)
            buf = b""
            metas = {}
            while len(metas) < 2:
                while True:
                    if len(buf) >= 12:
                        (blen,) = struct.unpack_from("<I", buf, 4)
                        if len(buf) >= 12 + blen:
                            break
                    buf += c.recv(65536)
                (blen,) = struct.unpack_from("<I", buf, 4)
                (mlen,) = struct.unpack_from("<I", buf, 8)
                m = RpcMeta.decode(buf[12:12 + mlen])
                metas[m.correlation_id] = m
                buf = buf[12 + blen:]
        assert metas[1].error_code == 0
        assert metas[2].error_code == int(Errno.ERPCTIMEDOUT)
        assert svc.echo_calls == 0          # the handler never ran
        assert shed_counters().get(("slim", "DL.Echo"), 0) == before + 1
    finally:
        p.close()
        srv.stop()


def test_retry_storm_capped_by_budget():
    """A dead backend behind the proxy: the channel retry budget bounds
    proxy-observed attempts; an unbudgeted channel storms.  Attempts
    are counted AT THE PROXY (connections — every failed attempt costs
    a fresh connect)."""
    # a port with no listener: the proxy accepts, fails upstream, and
    # closes — every client attempt is one accepted connection
    import socket as pysock
    probe = pysock.socket()
    probe.bind(("127.0.0.1", 0))
    dead_port = probe.getsockname()[1]
    probe.close()

    p = FaultyTransport("127.0.0.1", dead_port)
    try:
        def storm(budget_max):
            co = ChannelOptions()
            co.timeout_ms = 2000
            co.max_retry = 3
            co.connection_type = "pooled"
            co.retry_budget_max = budget_max
            ch = Channel(co)
            assert ch.init(p.address) == 0
            start = p.connections
            for _ in range(8):
                cntl = Controller()
                cntl.timeout_ms = 2000
                c = ch.call_method("E.Echo", b"x", cntl=cntl)
                assert c.failed
            # the proxy accept loop is async: settle
            deadline = time.time() + 2.0
            last = -1
            while time.time() < deadline:
                cur = p.connections
                if cur == last:
                    break
                last = cur
                time.sleep(0.05)
            return p.connections - start, ch

        capped_attempts, capped_ch = storm(budget_max=4)
        uncapped_attempts, _ = storm(budget_max=0)
        # budget 4 → exactly 2 granted retries: 8 originals + 2
        assert capped_attempts <= 12, capped_attempts
        assert capped_ch.retry_budget().denied_count > 0
        # no budget → full 1 + max_retry amplification
        assert uncapped_attempts >= 24, uncapped_attempts
        assert uncapped_attempts > capped_attempts * 2
    finally:
        p.close()


def test_flapping_backend_trips_breaker_from_raw_lane():
    """The pinned raw lane (call_raw) has no LB in the path, yet its
    outcomes must feed the GLOBAL circuit breaker when the channel opts
    in — a flapping backend observed only through raw calls still gets
    isolated for every cluster channel sharing it."""
    from brpc_tpu_torch.client.channel import RpcError
    from brpc_tpu_torch.client.circuit_breaker import (
        global_circuit_breaker_map)
    from brpc_tpu_torch.server.service import raw_method

    class RawSvc(Service):
        @raw_method
        def REcho(self, payload, attachment):
            return bytes(payload), attachment

    m = global_circuit_breaker_map()
    m.reset()
    srv = Server()
    srv.add_service(RawSvc(), name="RW")
    assert srv.start("127.0.0.1:0") == 0
    ep = srv.listen_endpoint
    try:
        co = ChannelOptions()
        co.timeout_ms = 1000
        co.enable_circuit_breaker = True
        ch = Channel(co)
        ch.init(str(ep))
        for _ in range(2):
            r, _a = ch.call_raw("RW.REcho", b"warm", timeout_ms=1000)
            assert bytes(r) == b"warm"
        srv.stop()
        fails = 0
        deadline = time.time() + 10
        while fails < 12 and time.time() < deadline:
            try:
                ch.call_raw("RW.REcho", b"down", timeout_ms=300)
            except RpcError:
                fails += 1
        assert fails >= 12
        assert m.isolated(ep), "raw-lane failures never tripped the breaker"
        # and an LB consulting the shared map skips the dead node: only
        # the live server survives candidate filtering
        from brpc_tpu_torch.client.load_balancer import LoadBalancer
        from brpc_tpu_torch.client.naming_service import ServerNode

        class _RR(LoadBalancer):
            def select(self, nodes, cntl):
                return nodes[0]

        live = Server()
        live.add_service(RawSvc(), name="RW")
        assert live.start("127.0.0.1:0") == 0
        try:
            lb = _RR()
            lb.use_circuit_breaker = True
            lb.reset_servers([ServerNode(endpoint=ep),
                              ServerNode(endpoint=live.listen_endpoint)])
            cand = lb.candidates(Controller())
            assert [n.endpoint for n in cand] == [live.listen_endpoint]
        finally:
            live.stop()
    finally:
        m.reset()
        srv.stop()
