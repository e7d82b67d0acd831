"""Every registered protocol on the port's NATIVE port: the cases of
``tests/test_native_passthrough.py``, every one, against
``brpc_tpu_torch``.

tpu_std and HTTP/1.x are cut in C++; anything else (h2/gRPC, redis,
thrift) flips the connection to PASSTHROUGH — the engine delivers raw
gulps (``EV_BYTES``) and the server's InputMessenger registry (the same
table the Python transport uses) cuts and dispatches.  Real grpcio and
the port's RESP and thrift clients are the peers."""

import threading

import pytest

from brpc_tpu_torch.client import Channel
from brpc_tpu_torch.client.redis_client import RedisClient
from brpc_tpu_torch.server import Server, ServerOptions, Service
from brpc_tpu_torch.server.service import raw_method


class MiniRedis:
    def __init__(self):
        self.store = {}
        self.lock = threading.Lock()

    def on_command(self, args):
        cmd = args[0].upper()
        with self.lock:
            if cmd == b"PING":
                return "PONG"
            if cmd == b"SET":
                self.store[args[1]] = args[2]
                return "OK"
            if cmd == b"GET":
                return self.store.get(args[1])
        from brpc_tpu_torch.protocol.resp import RedisError
        raise RedisError(f"unknown command {cmd.decode()}")


class EchoSvc(Service):
    def Echo(self, cntl, request):
        return request

    @raw_method(native="echo")
    def EchoRaw(self, payload, attachment):
        return payload, attachment


@pytest.fixture(scope="module")
def server():
    opts = ServerOptions()
    opts.native = True
    opts.native_loops = 1
    opts.usercode_inline = True
    srv = Server(opts)
    srv.add_service(EchoSvc(), name="EchoSvc")
    srv.add_service(MiniRedis(), name="redis")
    assert srv.start("127.0.0.1:0") == 0
    yield srv
    srv.stop()


def test_grpcio_client_against_native_port(server):
    grpc = pytest.importorskip("grpc")
    ep = server.listen_endpoint
    ident = lambda b: b  # noqa: E731
    with grpc.insecure_channel(f"{ep.host}:{ep.port}") as ch:
        fn = ch.unary_unary("/EchoSvc/Echo", request_serializer=ident,
                            response_deserializer=ident)
        for i in range(5):
            assert fn(b"over-h2-%d" % i, timeout=10) == b"over-h2-%d" % i


def test_redis_client_against_native_port(server):
    r = RedisClient(str(server.listen_endpoint))
    try:
        assert r.ping() == "PONG"
        assert r.set("k", b"v") == "OK"
        assert r.get("k") == b"v"
    finally:
        r.close()


def test_thrift_client_against_native_port():
    """Thrift framed-binary against a native-port server (own fixture:
    the thrift service shape differs from the shared one)."""
    from brpc_tpu_torch.protocol.thrift_proto import ThriftClient

    class EchoThrift:
        def handle(self, method, body):
            if method == "echo":
                return body
            raise KeyError(method)

    opts = ServerOptions()
    opts.native = True
    opts.native_loops = 1
    opts.usercode_inline = True
    srv = Server(opts)
    srv.add_service(EchoThrift(), name="thrift")
    assert srv.start("127.0.0.1:0") == 0
    try:
        tc = ThriftClient(str(srv.listen_endpoint))
        try:
            assert tc.call("echo", b"\x0b\x00\x01payload\x00") \
                == b"\x0b\x00\x01payload\x00"
        finally:
            tc.close()
    finally:
        srv.stop()


def test_passthrough_off_loop_on_noninline_server():
    """usercode_inline=False: passthrough handlers run on the fiber
    pool (per-connection ExecutionQueue), so a handler that blocks must
    not stall the engine loop — natively-dispatched tpu_std traffic
    keeps flowing while a gRPC handler sleeps."""
    import time as _time

    grpc = pytest.importorskip("grpc")
    opts = ServerOptions()
    opts.native = True
    opts.native_loops = 1          # usercode_inline stays False
    srv = Server(opts)

    class Slow(Service):
        def Echo(self, cntl, request):
            _time.sleep(0.5)       # blocking handler
            return request

        @raw_method(native="echo")
        def EchoRaw(self, payload, attachment):
            return payload, attachment

    srv.add_service(Slow(), name="Slow")
    assert srv.start("127.0.0.1:0") == 0
    try:
        ep = srv.listen_endpoint
        ident = lambda b: b  # noqa: E731
        gch = grpc.insecure_channel(f"{ep.host}:{ep.port}")
        fn = gch.unary_unary("/Slow/Echo", request_serializer=ident,
                             response_deserializer=ident)
        fut = fn.future(b"slow-one", timeout=30)
        _time.sleep(0.1)           # the handler is now sleeping
        # the loop must still answer native traffic promptly.  One
        # bounded retry on a CONNECTION-level error: under full-suite
        # load a transient conn failure was observed once (~1/6 runs,
        # order-dependent); the property under test is the TIMING of a
        # successful call — a genuinely blocked loop fails the dt
        # assert on every attempt, never with a socket error.
        from brpc_tpu_torch.client.channel import RpcError

        ch = Channel()
        ch.init(str(ep))
        for attempt in range(2):
            t0 = _time.perf_counter()
            try:
                resp, _ = ch.call_raw("Slow.EchoRaw", b"fast",
                                      timeout_ms=5_000)
                break
            except RpcError as e:
                if attempt:
                    raise AssertionError(
                        f"raw lane failed twice: [{e.code}] {e}") \
                        from e
        dt = _time.perf_counter() - t0
        assert bytes(resp) == b"fast"
        assert dt < 0.4, f"native lane stalled {dt:.2f}s behind a " \
                         "blocking passthrough handler"
        assert fut.result(timeout=30) == b"slow-one"
        gch.close()
    finally:
        srv.stop()


def test_all_protocols_one_native_port(server):
    """tpu_std (native cut) + HTTP (native cut) + gRPC (passthrough) +
    redis (passthrough), interleaved against one listener."""
    import http.client

    grpc = pytest.importorskip("grpc")
    ep = server.listen_endpoint
    # tpu_std
    ch = Channel()
    ch.init(str(ep))
    resp, _ = ch.call_raw("EchoSvc.EchoRaw", b"std", timeout_ms=5_000)
    assert bytes(resp) == b"std"
    # http
    hc = http.client.HTTPConnection(ep.host, ep.port, timeout=10)
    hc.request("POST", "/EchoSvc/Echo", body=b"via-http")
    r = hc.getresponse()
    assert r.status == 200 and r.read() == b"via-http"
    hc.close()
    # grpc
    ident = lambda b: b  # noqa: E731
    with grpc.insecure_channel(f"{ep.host}:{ep.port}") as gch:
        fn = gch.unary_unary("/EchoSvc/Echo", request_serializer=ident,
                             response_deserializer=ident)
        assert fn(b"via-grpc", timeout=10) == b"via-grpc"
    # redis
    rc = RedisClient(str(ep))
    try:
        assert rc.ping() == "PONG"
    finally:
        rc.close()
    # tpu_std again (the earlier channels unaffected)
    resp, _ = ch.call_raw("EchoSvc.EchoRaw", b"still", timeout_ms=5_000)
    assert bytes(resp) == b"still"
