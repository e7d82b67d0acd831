"""gRPC over h2c on the port's one serving port: ``grpcio`` (a gRPC we
did not write) as the oracle against a port server (unary, a payload
past one frame and the initial window, package-qualified paths, unknown
methods, the status mapping, concurrent streams, the three streaming
kinds), the deadline shed from ``grpc-timeout``; then the port's gRPC
client against the JAX server, the JAX client against the port's, and
the port's client against a grpcio server."""

import threading
import time

import pytest

grpc = pytest.importorskip("grpc")

from brpc_tpu.client import Channel as JChannel  # noqa: E402
from brpc_tpu.client import ChannelOptions as JChannelOptions  # noqa: E402
from brpc_tpu.server import Server as JServer  # noqa: E402
from brpc_tpu.server import Service as JService  # noqa: E402
from brpc_tpu.server import grpc_streaming as jgrpc_streaming  # noqa: E402
from brpc_tpu_torch.butil.endpoint import parse_endpoint  # noqa: E402
from brpc_tpu_torch.client import Channel  # noqa: E402
from brpc_tpu_torch.client.grpc_client import GrpcConnection  # noqa: E402
from brpc_tpu_torch.protocol.h2_rpc import (  # noqa: E402
    errno_of_grpc_status, grpc_status_of, parse_grpc_timeout)
from brpc_tpu_torch.server import Server, Service, grpc_streaming  # noqa

_ident = lambda b: b  # noqa: E731


class _Echo:
    def Echo(self, cntl, request):
        return request

    def Upper(self, cntl, request):
        return request.upper()

    def Fail(self, cntl, request):
        cntl.set_failed(1003, "bad arg here")
        return None

    def Busy(self, cntl, request):
        cntl.set_failed(2004, "over the limit")
        return None


def _streams(deco):
    class _S:
        @deco
        def Countdown(self, cntl, msgs):
            first = msgs.read()
            for i in range(int(first or b"0"), 0, -1):
                cntl.grpc_stream.write(b"%d" % i)
            return None

        @deco
        def Sum(self, cntl, msgs):
            return b"%d" % sum(int(m) for m in msgs)

        @deco
        def Chat(self, cntl, msgs):
            for m in msgs:
                cntl.grpc_stream.write(m.upper())
            return None

        @deco
        def FailMid(self, cntl, msgs):
            cntl.grpc_stream.write(b"one")
            cntl.set_failed(1003, "stream failed midway")
            return None
    return _S


class TEcho(Service, _Echo):
    pass


class JEcho(JService, _Echo):
    pass


class TStreams(Service, _streams(grpc_streaming)):
    pass


class JStreams(JService, _streams(jgrpc_streaming)):
    pass


@pytest.fixture(scope="module")
def servers():
    srvs = {}
    for which, S, E, St in (("port", Server, TEcho, TStreams),
                            ("jax", JServer, JEcho, JStreams)):
        srv = S()
        srv.add_service(E(), name="EchoSvc")
        srv.add_service(St(), name="S")
        assert srv.start("127.0.0.1:0") == 0
        srvs[which] = srv
    yield srvs
    for srv in srvs.values():
        srv.stop()


@pytest.fixture(scope="module")
def server(servers):
    return servers["port"]


def _target(srv):
    ep = srv.listen_endpoint
    return f"{ep.host}:{ep.port}"


def _grpcio_call(srv, method, payload, timeout=10):
    with grpc.insecure_channel(_target(srv)) as ch:
        fn = ch.unary_unary(method, request_serializer=_ident,
                            response_deserializer=_ident)
        return fn(payload, timeout=timeout)


# -- grpcio client -> port server ------------------------------------------

def test_grpcio_client_unary_echo(server):
    assert _grpcio_call(server, "/EchoSvc/Echo", b"hello-over-grpc") == \
        b"hello-over-grpc"


def test_grpcio_client_large_payload(server):
    payload = bytes(range(256)) * 4096          # 1 MB
    assert _grpcio_call(server, "/EchoSvc/Echo", payload, 30) == payload


def test_grpcio_client_package_qualified_path(server):
    assert _grpcio_call(server, "/some.pkg.EchoSvc/Upper", b"abc") == b"ABC"


@pytest.mark.parametrize("method,code", [
    ("/EchoSvc/Nope", "UNIMPLEMENTED"), ("/Nope/Echo", "UNIMPLEMENTED"),
    ("/EchoSvc/Fail", "INVALID_ARGUMENT"),
    ("/EchoSvc/Busy", "RESOURCE_EXHAUSTED")])
def test_grpcio_client_status_mapping(servers, method, code):
    """The port and the JAX server answer each error with the same
    grpc status."""
    for srv in servers.values():
        with pytest.raises(grpc.RpcError) as ei:
            _grpcio_call(srv, method, b"x")
        assert ei.value.code() == getattr(grpc.StatusCode, code)
    with pytest.raises(grpc.RpcError) as ei:
        _grpcio_call(servers["port"], "/EchoSvc/Fail", b"x")
    assert "bad arg" in (ei.value.details() or "")


def test_status_maps_equal_jax():
    from brpc_tpu.protocol import h2_rpc as jh
    for code in (0, 1001, 1002, 1003, 1004, 1008, 1011, 2001, 2004, 9999):
        assert grpc_status_of(code) == jh.grpc_status_of(code)
    for status in range(17):
        assert errno_of_grpc_status(status) == jh.errno_of_grpc_status(status)
    for value in ("100m", "1S", "2M", "1H", "5u", "7n", "x", "", "123456789m"):
        assert parse_grpc_timeout(value) == jh.parse_grpc_timeout(value)


def test_grpcio_client_many_sequential_calls(server):
    with grpc.insecure_channel(_target(server)) as ch:
        fn = ch.unary_unary("/EchoSvc/Echo", request_serializer=_ident,
                            response_deserializer=_ident)
        for i in range(50):
            assert fn(b"m%d" % i, timeout=10) == b"m%d" % i


def test_grpcio_client_concurrent_streams(server):
    errors = []
    with grpc.insecure_channel(_target(server)) as ch:
        fn = ch.unary_unary("/EchoSvc/Echo", request_serializer=_ident,
                            response_deserializer=_ident)

        def worker(i):
            try:
                body = bytes([i]) * 10000
                assert fn(body, timeout=20) == body
            except Exception as e:
                errors.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert not errors, errors


def test_grpc_timeout_sheds_deadline_exceeded(servers):
    """An expired ``grpc-timeout`` (sub-millisecond: expired at arrival)
    is shed before the handler: DEADLINE_EXCEEDED from both servers, and
    the shed counted on the port's grpc lane."""
    from brpc_tpu_torch.deadline import shed_counters
    before = shed_counters().get(("grpc", "EchoSvc.Echo"), 0)
    for which, srv in servers.items():
        # grpc-timeout 0.5 ms: 0 ms on the server, expired at arrival
        st, msg = _raw_grpc_call(srv, "/EchoSvc/Echo", b"late", "500u")
        assert st == 4, (which, st, msg)
        assert _raw_grpc_call(srv, "/EchoSvc/Echo", b"ok", "5S") == (0, "")
    assert shed_counters().get(("grpc", "EchoSvc.Echo"), 0) == before + 1


def _raw_grpc_call(srv, path, payload, grpc_timeout):
    """A hand-framed unary call whose only grpc-timeout is ours."""
    import socket

    from brpc_tpu_torch.protocol.h2_rpc import pack_grpc_message
    from brpc_tpu_torch.protocol.h2_session import H2Session
    ep = srv.listen_endpoint
    sess = H2Session(is_server=False)
    sess.start()
    sid = sess.next_stream_id()
    sess.send_headers(sid, [(":method", "POST"), (":scheme", "http"),
                            (":path", path), (":authority", "x"),
                            ("content-type", "application/grpc"),
                            ("te", "trailers"),
                            ("grpc-timeout", grpc_timeout)])
    sess.send_data(sid, pack_grpc_message(payload), end_stream=True)
    headers = []
    with socket.create_connection((ep.host, ep.port), timeout=10) as s:
        s.sendall(sess.take_output())
        done = False
        while not done:
            data = s.recv(65536)
            assert data
            for ev in sess.feed(data):
                if ev[0] == "headers" and ev[1] == sid:
                    headers += ev[2]
                    done = done or ev[3]
                if ev[0] == "data" and ev[1] == sid:
                    done = done or ev[3]
            out = sess.take_output()
            if out:
                s.sendall(out)
    h = dict(headers)
    return int(h.get("grpc-status", "2")), h.get("grpc-message", "")


# -- streaming: grpcio client -> port server --------------------------------

def test_grpcio_server_streaming(server):
    with grpc.insecure_channel(_target(server)) as ch:
        fn = ch.unary_stream("/S/Countdown", request_serializer=_ident,
                             response_deserializer=_ident)
        assert list(fn(b"4", timeout=10)) == [b"4", b"3", b"2", b"1"]


def test_grpcio_client_streaming(server):
    with grpc.insecure_channel(_target(server)) as ch:
        fn = ch.stream_unary("/S/Sum", request_serializer=_ident,
                             response_deserializer=_ident)
        assert fn(iter([b"1", b"2", b"3", b"4"]), timeout=10) == b"10"


def test_grpcio_bidi_streaming(server):
    with grpc.insecure_channel(_target(server)) as ch:
        fn = ch.stream_stream("/S/Chat", request_serializer=_ident,
                              response_deserializer=_ident)
        got = list(fn(iter([b"alpha", b"beta", b"gamma"]), timeout=10))
    assert got == [b"ALPHA", b"BETA", b"GAMMA"]


def test_grpcio_streaming_error_propagates(server):
    with grpc.insecure_channel(_target(server)) as ch:
        fn = ch.unary_stream("/S/FailMid", request_serializer=_ident,
                             response_deserializer=_ident)
        it = fn(b"", timeout=10)
        assert next(it) == b"one"
        with pytest.raises(grpc.RpcError) as ei:
            list(it)
        assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_grpcio_large_server_stream(server):
    """Many pushed messages > initial window: flow control on streams."""
    with grpc.insecure_channel(_target(server)) as ch:
        fn = ch.stream_stream("/S/Chat", request_serializer=_ident,
                              response_deserializer=_ident)
        reqs = [bytes([65 + (i % 26)]) * 8000 for i in range(40)]
        got = list(fn(iter(reqs), timeout=30))
    assert got == [r.upper() for r in reqs]


# -- the port's client and the JAX client, both ways ------------------------

def _port_grpc_channel(ep):
    ch = Channel(protocol="grpc")
    assert ch.init(str(ep)) == 0
    return ch


def _jax_grpc_channel(ep):
    opts = JChannelOptions()
    opts.protocol = "grpc"
    ch = JChannel(opts)
    assert ch.init(str(ep)) == 0
    return ch


@pytest.mark.parametrize("client,server_kind", [("port", "port"),
                                                ("port", "jax"),
                                                ("jax", "port")])
def test_channel_grpc_cross_wired(servers, client, server_kind):
    ep = servers[server_kind].listen_endpoint
    ch = _port_grpc_channel(ep) if client == "port" \
        else _jax_grpc_channel(ep)
    c = ch.call_method("EchoSvc.Echo", b"self-grpc")
    assert not c.failed, c.error_text
    assert bytes(c.response) == b"self-grpc"
    c = ch.call_method("EchoSvc.Fail", b"x")
    assert c.failed and c.error_code == 1003
    assert "grpc-status 3" in c.error_text


@pytest.mark.parametrize("server_kind", ["port", "jax"])
def test_port_streaming_client(servers, server_kind):
    ep = servers[server_kind].listen_endpoint
    conn = GrpcConnection(parse_endpoint(f"{ep.host}:{ep.port}"))
    try:
        call = conn.streaming_call("/S/Chat", 10.0)
        call.write(b"xyz")
        assert call.read() == b"XYZ"
        call.write(b"q")
        assert call.read() == b"Q"
        call.done_writing()
        assert call.read() is None
        assert call.status() == 0, call.message()
    finally:
        conn.close()
    call = _port_grpc_channel(ep).grpc_stream("S.Sum")
    for i in (b"5", b"6"):
        call.write(i)
    call.done_writing()
    assert list(call) == [b"11"]


# -- the port's client against a grpcio server ------------------------------

class _GrpcioEcho(grpc.GenericRpcHandler):
    def service(self, handler_call_details):
        method = handler_call_details.method
        if method == "/oracle.Echo/Echo":
            return grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: req,
                request_deserializer=_ident, response_serializer=_ident)
        if method == "/oracle.Echo/Fail":
            def fail(req, ctx):
                ctx.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, "nope")
            return grpc.unary_unary_rpc_method_handler(
                fail, request_deserializer=_ident,
                response_serializer=_ident)
        if method == "/oracle.Echo/Rev":
            def rev(req_iter, ctx):
                for r in req_iter:
                    yield r[::-1]
            return grpc.stream_stream_rpc_method_handler(
                rev, request_deserializer=_ident,
                response_serializer=_ident)
        return None


@pytest.fixture(scope="module")
def grpcio_server():
    from concurrent import futures
    srv = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    srv.add_generic_rpc_handlers((_GrpcioEcho(),))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    yield port
    srv.stop(0)


def test_port_client_against_grpcio_server(grpcio_server):
    conn = GrpcConnection(parse_endpoint(f"127.0.0.1:{grpcio_server}"))
    try:
        status, msg, body = conn.unary_call("/oracle.Echo/Echo",
                                            b"ping-from-port", 10.0)
        assert (status, body) == (0, b"ping-from-port"), msg
        big = bytes(200000)
        status, msg, body = conn.unary_call("/oracle.Echo/Echo", big, 30.0)
        assert (status, body) == (0, big), msg
        status, msg, body = conn.unary_call("/oracle.Echo/Fail", b"x", 10.0)
        assert status == 8 and "nope" in msg
        call = conn.streaming_call("/oracle.Echo/Rev", 10.0)
        call.write(b"abc")
        assert call.read() == b"cba"
        call.done_writing()
        assert call.read() is None and call.status() == 0
    finally:
        conn.close()
    ch = _port_grpc_channel(f"127.0.0.1:{grpcio_server}")
    c = ch.call_method("oracle.Echo.Fail", b"x")
    assert c.failed and "grpc-status 8" in c.error_text
    assert c.error_code == 2004                 # RESOURCE_EXHAUSTED: ELIMIT


def test_connections_share_one_reader_thread(grpcio_server):
    before = {t.name for t in threading.enumerate()}
    conns = [GrpcConnection(parse_endpoint(f"127.0.0.1:{grpcio_server}"))
             for _ in range(6)]
    try:
        for i, conn in enumerate(conns):
            status, msg, body = conn.unary_call(
                "/oracle.Echo/Echo", f"c{i}".encode(), 10.0)
            assert (status, body) == (0, f"c{i}".encode()), msg
        after = [t.name for t in threading.enumerate()
                 if t.name not in before]
        assert [n for n in after if "reader" in n] in (
            [], ["grpc_shared_reader"])
    finally:
        for conn in conns:
            conn.close()


def test_goaway_while_draining(servers):
    """A draining port server answers in-flight h2 work and follows the
    first response on each connection with a NO_ERROR GOAWAY, as the
    JAX server does."""
    srv = Server()
    srv.add_service(TEcho(), name="EchoSvc")
    assert srv.start("127.0.0.1:0") == 0
    conn = GrpcConnection(srv.listen_endpoint)
    try:
        assert conn.unary_call("/EchoSvc/Echo", b"a", 10.0)[0] == 0
        assert srv.drain(200) == 0
        status, msg, _ = conn.unary_call("/EchoSvc/Echo", b"b", 10.0)
        assert status == 8 and "lame" in msg.lower() or status == 14, \
            (status, msg)
        deadline = time.monotonic() + 5
        while not conn._dead and time.monotonic() < deadline:
            time.sleep(0.01)
        assert conn._dead            # the GOAWAY closed the connection
    finally:
        conn.close()
        srv.stop()


def test_grpc_span_backdated_to_assembly_unlike_jax(servers):
    """Divergence: a unary gRPC call's server span is backdated to the
    stream's assembly (and its latency runs from it) in the port, as on
    its tpu_std lane; the JAX package starts both at dispatch."""
    from brpc_tpu import rpcz as jrpcz
    from brpc_tpu.protocol import h2_rpc as jh
    from brpc_tpu_torch import rpcz as trpcz
    from brpc_tpu_torch.protocol import h2_rpc as th
    from brpc_tpu_torch.protocol.h2_rpc import pack_grpc_message

    class _Conn:
        def __init__(self):
            self.sent = []

        def send_grpc_response(self, sock, sid, payload, status,
                               message=""):
            self.sent.append((payload, status))

    class _Sock:
        id = 0
        remote_side = None

    queued_us = 50_000
    out = {}
    for which, mod, store, tid in (("port", th, trpcz, 0xB0A1),
                                   ("jax", jh, jrpcz, 0xB0A2)):
        conn = _Conn()
        headers = [(":path", "/EchoSvc/Echo"),
                   ("content-type", "application/grpc"),
                   ("traceparent", f"00-{tid:032x}-{'cd' * 8}-01")]
        req = mod.H2Request(1, headers, pack_grpc_message(b"q"), conn)
        req.recv_us -= queued_us
        mod._process_grpc(req, _Sock(), servers[which])
        assert conn.sent == [(b"q", 0)]
        span, = store.global_span_store().by_trace(tid)
        out[which] = span.start_us - span.received_us
    assert out["port"] >= queued_us * 0.9
    assert out["jax"] < queued_us * 0.5
