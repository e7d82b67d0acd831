"""The port's native engine against the JAX package's, lane by lane.

A port ``Server(native=True, usercode_inline=True)`` and a JAX one serve
the same service.  The same request bytes, sent over a raw socket, come
back as the same response bytes from both engines for kinds 0–3 (native
echo and const, a plain raw method, a ``(cntl, request)`` method on the
slim lane, with and without attachments) and for an HTTP/1.1 call on
the kind-4 lane; a JAX client calls the port's engine and the port's
client calls JAX's for kinds 0–3, HTTP, gRPC (h2 passed through to the
InputMessenger) and a kind-5 stream.  Then the slim lanes' admission
(``ELIMIT`` under a method cap, ``ELAMEDUCK`` while draining, no handler
run for either), the lame-duck TLV on a response the engine built
itself, the portal's ``/native`` and ``/hotspots/engine`` pages, and the
classic lane's ``@raw_method`` on the Python transport.

The engines build with g++ (``brpc_tpu_torch/native`` into its
``_build/``, the JAX one in place); without a toolchain the tests skip.
"""

import http.client
import json
import socket
import struct
import threading
import time

import pytest

from brpc_tpu import streaming as jstreaming
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import ChannelOptions as JChannelOptions
from brpc_tpu.client import Controller as JController
from brpc_tpu.native import load as jload
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import ServerOptions as JServerOptions
from brpc_tpu.server.service import raw_method as jraw_method
from brpc_tpu_torch import native
from brpc_tpu_torch.butil.flags import set_flag
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
from brpc_tpu_torch.protocol.meta import RpcMeta
from brpc_tpu_torch.server import Server, ServerOptions, raw_method
from brpc_tpu_torch.streaming import (StreamOptions, stream_accept,
                                      stream_create)
from brpc_tpu_torch.transport.socket_map import (pooled_socket,
                                                 return_pooled_socket)
from conftest import wire_tlv

TIMEOUT_MS = 10_000
STREAM_MSGS = [b"chunk-%d" % i for i in range(5)]


def _engines_or_skip():
    if native.load() is None or jload() is None:
        pytest.skip("a native engine is unavailable (no toolchain)")


def _make_service(raw, accept):
    """The one service both packages serve: kinds 0/1 (native echo and
    const), kind 2 (a plain raw method), kind 3 (``Upper``, ``Hold``)
    and a stream opener (``Talk``)."""

    class Svc:
        def __init__(self):
            self.calls = 0
            self.release = threading.Event()

        @raw(native="echo")
        def Echo(self, payload, attachment):
            return payload, attachment

        @raw(native="const")
        def Ping(self, payload, attachment):
            return b"pong"

        @raw
        def Rev(self, payload, attachment):
            out = bytes(payload)[::-1]
            return (out, bytes(attachment)[::-1]) if attachment else out

        def Upper(self, cntl, request):
            self.calls += 1
            return bytes(request).upper()

        def Hold(self, cntl, request):
            self.calls += 1
            self.release.wait(10)
            return b"held"

        def Talk(self, cntl, request):
            s = accept(cntl, None)
            if s is None:
                cntl.set_failed(int(Errno.EREQUEST), "no stream")
                return None

            def push():
                for m in STREAM_MSGS:
                    s.write(m)
                s.close(reason="done")

            threading.Timer(0.05, push).start()
            return b"ok"

    return Svc()


def _port_server(options=None):
    opts = options or ServerOptions()
    opts.native = True
    opts.usercode_inline = True
    srv = Server(opts)
    svc = _make_service(raw_method, stream_accept)
    assert srv.add_service(svc, name="S") == 0
    assert srv.start("127.0.0.1:0") == 0
    assert srv._native_bridge is not None
    return srv, svc


def _jax_server():
    opts = JServerOptions()
    opts.native = True
    opts.usercode_inline = True
    srv = JServer(opts)
    svc = _make_service(jraw_method, jstreaming.stream_accept)
    assert srv.add_service(svc, name="S") == 0
    assert srv.start("127.0.0.1:0") == 0
    assert srv._native_bridge is not None
    return srv, svc


@pytest.fixture(scope="module")
def servers():
    _engines_or_skip()
    port, psvc = _port_server()
    jaxs, jsvc = _jax_server()
    yield {"port": (port, psvc), "jax": (jaxs, jsvc)}
    port.stop()
    jaxs.stop()


def _frame(cid: int, svc: str, mth: str, payload: bytes,
           att: bytes = b"") -> bytes:
    meta = wire_tlv(1, struct.pack("<Q", cid))
    if att:
        meta += wire_tlv(3, struct.pack("<I", len(att)))
    meta += wire_tlv(4, svc.encode()) + wire_tlv(5, mth.encode())
    body = meta + payload + att
    return b"TRPC" + struct.pack("<II", len(body), len(meta)) + body


def _recv_frame(conn) -> bytes:
    buf = b""
    while len(buf) < 12 or len(buf) < 12 + struct.unpack_from(
            "<I", buf, 4)[0]:
        chunk = conn.recv(65536)
        if not chunk:
            raise EOFError(f"closed after {len(buf)} bytes")
        buf += chunk
    return buf


def _raw_roundtrip(ep, frame: bytes) -> bytes:
    with socket.create_connection((ep.host, ep.port), timeout=10) as c:
        c.sendall(frame)
        return _recv_frame(c)


_RAW_CASES = {
    "kind0-echo": ("Echo", b"hello", b""),
    "kind0-echo-att": ("Echo", b"hello", b"attach"),
    "kind1-const": ("Ping", b"ignored", b""),
    "kind2-raw": ("Rev", b"abcdef", b""),
    "kind2-raw-att": ("Rev", b"abcdef", b"xyz"),
    "kind3-slim": ("Upper", b"slim lane", b""),
    "kind3-slim-att": ("Upper", b"slim lane", b"tail"),
    "unknown-method": ("Nope", b"x", b""),
}


@pytest.mark.parametrize("case", sorted(_RAW_CASES))
def test_response_bytes_equal_port_and_jax_engines(servers, case):
    mth, payload, att = _RAW_CASES[case]
    frame = _frame(77, "S", mth, payload, att)
    got = {k: _raw_roundtrip(srv.listen_endpoint, frame)
           for k, (srv, _) in servers.items()}
    assert got["port"] == got["jax"], case
    meta_size = struct.unpack_from("<I", got["port"], 8)[0]
    meta = RpcMeta.decode(got["port"][12:12 + meta_size])
    assert meta.correlation_id == 77
    if case == "unknown-method":
        assert meta.error_code == int(Errno.ENOMETHOD)
    else:
        assert meta.error_code == 0


_WANT = {"Echo": (b"hello", b"attach"), "Ping": (b"pong", b""),
         "Rev": (b"fedcba", b"zyx"), "Upper": (b"HELLO", b"")}


@pytest.mark.parametrize("mth", sorted(_WANT))
@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_cross_client_kinds_0_to_3(servers, mth, direction):
    payload = b"hello" if mth != "Rev" else b"abcdef"
    att = b"attach" if mth == "Echo" else b"xyz" if mth == "Rev" else b""
    want_resp, want_att = _WANT[mth]
    if direction == "jax->port":
        ch, cntl = JChannel(), JController()
        ep = servers["port"][0].listen_endpoint
    else:
        ch, cntl = Channel(), Controller()
        ep = servers["jax"][0].listen_endpoint
    assert ch.init(str(ep)) == 0
    cntl.timeout_ms = TIMEOUT_MS
    if att:
        if direction == "jax->port":
            cntl.request_attachment.append(att)
        else:
            cntl.request_attachment = att
    c = ch.call_method(f"S.{mth}", payload, cntl=cntl)
    assert not c.failed, (c.error_code, c.error_text)
    assert bytes(c.response) == want_resp
    got_att = c.response_attachment
    got_att = got_att.to_bytes() if hasattr(got_att, "to_bytes") \
        else bytes(got_att or b"")
    assert got_att == want_att


def test_slim_lanes_served_natively(servers):
    """Kinds 2, 3 and 4 were counted on the port engine's lanes (0 and 1
    never enter Python), and the bridge owns a connection while a
    client holds one."""
    srv = servers["port"][0]
    ch = Channel()
    ch.init(str(srv.listen_endpoint))
    t0 = srv._native_bridge.engine.telemetry()["lanes"]
    for mth in ("Rev", "Upper"):
        assert not ch.call_method(f"S.{mth}", b"ab").failed
    _http(srv.listen_endpoint, "POST", "/S/Upper", b"x")
    assert srv.connection_count() >= 1
    t1 = srv._native_bridge.engine.telemetry()["lanes"]
    ch.close()
    assert t1["raw"]["handled"] - t0["raw"]["handled"] == 1
    assert t1["slim"]["handled"] - t0["slim"]["handled"] == 1
    assert t1["http"]["handled"] - t0["http"]["handled"] == 1


def _http_raw(ep, request: bytes) -> bytes:
    with socket.create_connection((ep.host, ep.port), timeout=10) as c:
        c.sendall(request)
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += c.recv(65536)
        head, _, body = buf.partition(b"\r\n\r\n")
        n = int([ln.split(b":")[1] for ln in head.split(b"\r\n")
                 if ln.lower().startswith(b"content-length")][0])
        while len(body) < n:
            body += c.recv(65536)
        return head + b"\r\n\r\n" + body


@pytest.mark.parametrize("request_bytes", [
    b"POST /S/Upper HTTP/1.1\r\nHost: x\r\nContent-Length: 5\r\n"
    b"Content-Type: application/octet-stream\r\n\r\nhello",
    b"GET /S/Upper?a=1&b=two HTTP/1.1\r\nHost: x\r\n\r\n",
], ids=["post", "get-query"])
def test_http_slim_bytes_equal_port_and_jax_engines(servers,
                                                    request_bytes):
    got = {k: _http_raw(srv.listen_endpoint, request_bytes)
           for k, (srv, _) in servers.items()}
    assert got["port"] == got["jax"]
    assert got["port"].startswith(b"HTTP/1.1 200")


def _http(ep, method, path, body=None):
    c = http.client.HTTPConnection(ep.host, ep.port, timeout=10)
    try:
        c.request(method, path, body=body)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_http_and_grpc_cross_clients(servers, proto):
    """A JAX client over HTTP/1.1 (kind 4) or gRPC (h2 passed through to
    the InputMessenger) on the port's engine, and the port's client on
    JAX's, answer alike."""
    opts = JChannelOptions()
    opts.protocol = proto
    opts.timeout_ms = TIMEOUT_MS
    jch = JChannel(opts)
    assert jch.init(str(servers["port"][0].listen_endpoint)) == 0
    c = jch.call_method("S.Upper", b"grpc and http", cntl=JController())
    assert not c.failed, c.error_text
    assert bytes(c.response) == b"GRPC AND HTTP"
    pch = Channel(protocol=proto)
    assert pch.init(str(servers["jax"][0].listen_endpoint)) == 0
    c = pch.call_method("S.Upper", b"grpc and http")
    pch.close()
    assert not c.failed, c.error_text
    assert bytes(c.response) == b"GRPC AND HTTP"


def _stream_call(ch, cntl, create, opts_cls):
    got, closed = [], []
    create(cntl, opts_cls(
        on_received=lambda s, msgs: got.extend(bytes(m) for m in msgs),
        on_closed=lambda s: closed.append(s.close_reason)))
    cntl.timeout_ms = TIMEOUT_MS
    c = ch.call_method("S.Talk", b"", cntl=cntl)
    assert not c.failed, c.error_text
    deadline = time.time() + 10
    while not closed and time.time() < deadline:
        time.sleep(0.01)
    return got, closed


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_stream_kind5_cross_clients(servers, direction):
    if direction == "jax->port":
        srv = servers["port"][0]
        opens0 = srv._native_bridge.engine.telemetry()["lanes"]["stream"]
        ch = JChannel()
        ch.init(str(srv.listen_endpoint))
        got, closed = _stream_call(ch, JController(),
                                   jstreaming.stream_create,
                                   jstreaming.StreamOptions)
        opens = srv._native_bridge.engine.telemetry()["lanes"]["stream"]
        assert opens["handled"] - opens0["handled"] == 1   # kind 5
    else:
        ch = Channel()
        ch.init(str(servers["jax"][0].listen_endpoint))
        got, closed = _stream_call(ch, Controller(), stream_create,
                                   StreamOptions)
        ch.close()
    assert got == STREAM_MSGS and closed == ["done"]


def test_slim_admission_answers_elimit_without_a_handler_run():
    """A method cap of 1 on the kind-3 lane: the held call runs, a second
    call on another loop is refused ``ELIMIT`` and its handler never
    runs."""
    _engines_or_skip()
    opts = ServerOptions()
    opts.method_max_concurrency = {"S.Hold": 1}
    opts.native_loops = 2
    set_flag("engine_reuseport", False)      # round-robin placement
    try:
        srv, svc = _port_server(opts)
    finally:
        set_flag("engine_reuseport", True)
    try:
        # two connections, made before the held call (the shared
        # listener is read by a loop that the held handler will occupy):
        # "single" is one connection per peer and signature, shared by
        # both channels, so the channels ride two pooled connections,
        # both in the pool before the first call
        co = ChannelOptions()
        co.connection_type = "pooled"
        first, second = Channel(co), Channel(co)
        warm = [pooled_socket(srv.listen_endpoint)[0] for _ in range(2)]
        for sid in warm:
            return_pooled_socket(sid)
        for ch in (first, second):
            ch.init(str(srv.listen_endpoint))
            assert not ch.call_method("S.Upper", b"connect").failed
        held = {}
        t = threading.Thread(target=lambda: held.__setitem__(
            "c", first.call_method("S.Hold", b"")))
        t.start()
        deadline = time.time() + 10
        while svc.calls < 3 and time.time() < deadline:
            time.sleep(0.005)
        c = second.call_method("S.Hold", b"")
        assert c.error_code == int(Errno.ELIMIT), c.error_text
        assert svc.calls == 3
        svc.release.set()
        t.join(10)
        assert not held["c"].failed
        first.close()
        second.close()
    finally:
        svc.release.set()
        srv.stop()


def test_drain_answers_elameduck_and_engine_responses_carry_lame_duck():
    """While draining, a kind-3 call is refused ``ELAMEDUCK`` before its
    handler, and a kind-0 echo the engine answers alone carries the
    lame-duck TLV; both frames equal the JAX engine's."""
    _engines_or_skip()
    out = {}
    for which, make in (("port", _port_server), ("jax", _jax_server)):
        srv, svc = make()
        conn = socket.create_connection(("127.0.0.1",
                                         srv.listen_endpoint.port))
        try:
            conn.sendall(_frame(1, "S", "Echo", b"warm"))
            _recv_frame(conn)
            hold = threading.Thread(target=lambda: srv.drain(2000))
            hold.start()
            deadline = time.time() + 5
            while not srv.draining and time.time() < deadline:
                time.sleep(0.005)
            conn.sendall(_frame(2, "S", "Echo", b"during"))
            echo = _recv_frame(conn)
            conn.sendall(_frame(3, "S", "Upper", b"refused"))
            refused = _recv_frame(conn)
            hold.join(10)
            out[which] = (echo, refused, svc.calls)
        finally:
            conn.close()
            srv.stop()
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    meta = RpcMeta.decode(out["port"][0][12:12 + struct.unpack_from(
        "<I", out["port"][0], 8)[0]])
    assert meta.lame_duck == 1 and out["port"][0].endswith(b"during")
    meta = RpcMeta.decode(out["port"][1][12:12 + struct.unpack_from(
        "<I", out["port"][1], 8)[0]])
    assert meta.error_code == int(Errno.ELAMEDUCK) and meta.lame_duck == 1
    assert out["port"][2] == 0


def test_portal_native_pages(servers):
    srv = servers["port"][0]
    status, body = _http(srv.listen_endpoint, "GET", "/native")
    assert status == 200
    page = json.loads(body)
    jstatus, jbody = _http(servers["jax"][0].listen_endpoint, "GET",
                           "/native")
    assert jstatus == 200
    assert sorted(page) == sorted(json.loads(jbody))
    assert set(page["lanes"]) == {"raw", "slim", "http", "stream"}
    status, body = _http(srv.listen_endpoint, "GET",
                         "/hotspots/engine?seconds=0.2")
    assert status == 200 and b"native engine loops" in body
    plain = Server()
    assert plain.add_service(_make_service(raw_method, stream_accept),
                             name="S") == 0
    assert plain.start("127.0.0.1:0") == 0
    try:
        assert _http(plain.listen_endpoint, "GET", "/native")[0] == 404
    finally:
        plain.stop()


@pytest.mark.parametrize("att", [b"", b"tail"], ids=["no-att", "att"])
def test_raw_method_on_the_python_transport(att):
    """Without the engine the classic lane calls a ``@raw_method`` with
    the same ``(payload, attachment)`` shape."""
    srv = Server()
    assert srv.add_service(_make_service(raw_method, stream_accept),
                           name="S") == 0
    assert srv.start("127.0.0.1:0") == 0
    try:
        assert srv._native_bridge is None
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        cntl = Controller()
        cntl.request_attachment = att
        c = ch.call_method("S.Rev", b"abc", cntl=cntl)
        ch.close()
        assert not c.failed, c.error_text
        assert bytes(c.response) == b"cba"
        assert bytes(c.response_attachment or b"") == att[::-1]
    finally:
        srv.stop()


def test_inline_off_serves_through_the_classic_lane():
    """``usercode_inline`` off: the engine cuts the frames, the classic
    lane answers on a fiber (no slim lane registered)."""
    _engines_or_skip()
    opts = ServerOptions()
    opts.native = True
    srv = Server(opts)
    assert srv.add_service(_make_service(raw_method, stream_accept),
                           name="S") == 0
    assert srv.start("127.0.0.1:0") == 0
    try:
        ch = Channel(ChannelOptions())
        ch.init(str(srv.listen_endpoint))
        for mth, want in (("Upper", b"AB"), ("Rev", b"ba"),
                          ("Echo", b"ab"), ("Ping", b"pong")):
            c = ch.call_method(f"S.{mth}", b"ab")
            assert not c.failed and bytes(c.response) == want, mth
        ch.close()
        lanes = srv._native_bridge.engine.telemetry()["lanes"]
        assert lanes["slim"]["handled"] == lanes["raw"]["handled"] == 0
    finally:
        srv.stop()
