"""HTTP/1.1 on the port's one serving port, held against the JAX
package's: ``tests/test_http.py``'s cases with stdlib ``http.client``
as the interop peer against a port server and a JAX server carrying the
same service (equal status and headers, equal bodies or equal JSON key
sets), and each package's ``Channel(protocol="http")`` calling the
other's server; then what the port adds to those cases: the same port
serving tpu_std, error mapping, attachments, ``max_body_size``,
``internal_port`` gating, restful mappings, ``http_reject``'s 503, the
deadline shed, the drain's lame-duck headers, a progressive attachment
and a connection's protocol fixed at its first bytes."""

import http.client
import json
import socket
import struct
import threading
import time

import pytest

from brpc_tpu.butil import flags as jflags
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import ChannelOptions as JChannelOptions
from brpc_tpu.client import Controller as JController
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import ServerOptions as JServerOptions
from brpc_tpu.server import Service as JService
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.server import Server, ServerOptions, Service


class _Calc:
    def Add(self, cntl, request):
        data = json.loads(request or b"{}")
        return {"sum": int(data.get("a", 0)) + int(data.get("b", 0))}

    def Echo(self, cntl, request):
        att = cntl.request_attachment     # bytes here, an IOBuf in JAX
        if len(att):
            cntl.response_attachment = att
        return bytes(request)

    def Fail(self, cntl, request):
        cntl.set_failed(1003, "bad calc")
        return None

    def Boom(self, cntl, request):
        raise RuntimeError("kaput")

    def Path(self, cntl, request):
        return {"method": cntl.http_method, "path": cntl.http_path,
                "rest": cntl.http_unresolved_path}

    def Chunks(self, cntl, request):
        pa = cntl.create_progressive_attachment()

        def later():
            time.sleep(0.05)
            for part in (b"one,", b"two,", b"three"):
                pa.write(part)
            pa.close()
        threading.Thread(target=later, daemon=True).start()
        return b""


class TCalc(Service, _Calc):
    pass


class JCalc(JService, _Calc):
    pass


def _start(which, options=None):
    srv = Server(options) if which == "port" else JServer(options)
    srv.add_service(TCalc() if which == "port" else JCalc(), name="Calc")
    assert srv.start("127.0.0.1:0") == 0
    return srv


@pytest.fixture(scope="module")
def servers():
    srvs = {"port": _start("port"), "jax": _start("jax")}
    yield srvs
    for srv in srvs.values():
        srv.stop()


def _request(ep, method, path, body=None, headers=None, timeout=10):
    c = http.client.HTTPConnection(ep.host, ep.port, timeout=timeout)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        c.close()


def _both(servers, method, path, body=None, headers=None):
    return {k: _request(s.listen_endpoint, method, path, body, headers)
            for k, s in servers.items()}


def _same_head(out):
    """Equal status, header names and content types."""
    (ps, ph, _), (js, jh, _) = out["port"], out["jax"]
    assert ps == js
    assert set(ph) == set(jh)
    assert ph.get("content-type") == jh.get("content-type")


# -- tests/test_http.py's cases, cross-wired ------------------------------

@pytest.mark.parametrize("path", ["/health", "/Calc/Add?a=1&b=2",
                                  "/nope", "/vlog", "/hotspots/nope",
                                  "/vars/no_such_var", "/native"])
def test_plain_pages_equal(servers, path):
    out = _both(servers, "GET", path)
    _same_head(out)
    assert out["port"][2] == out["jax"][2]


def test_index_lists_methods_and_pages_like_jax(servers):
    out = _both(servers, "GET", "/")
    _same_head(out)
    port, jax = (out[k][2].decode().splitlines() for k in ("port", "jax"))
    assert [ln for ln in port if ln.startswith("  /Calc/")] == \
        [ln for ln in jax if ln.startswith("  /Calc/")]
    assert "  /Calc/Add" in port and "  /health" in port


@pytest.mark.parametrize("path", ["/status", "/connections", "/fibers",
                                  "/overload", "/protobufs", "/rpcz",
                                  "/lm", "/fleet", "/trackme?ver=0.0.1"])
def test_json_pages_have_jax_keys(servers, path):
    out = _both(servers, "GET", path)
    _same_head(out)
    port, jax = (json.loads(out[k][2]) for k in ("port", "jax"))
    assert set(port) == set(jax)
    if path == "/status":
        assert set(port["services"]) == set(jax["services"])
        assert set(port["services"]["Calc.Add"]) == \
            set(jax["services"]["Calc.Add"])
    if path == "/protobufs":
        assert port == jax


def test_vars_and_metrics(servers):
    from brpc_tpu.bvar.reducer import Adder as JAdder
    from brpc_tpu_torch.bvar.reducer import Adder as TAdder
    probes = [TAdder("http_test_probe_var"), JAdder("http_test_probe_var")]
    for p in probes:
        p << 7
    try:
        for path in ("/vars", "/vars/http_test_probe_var", "/metrics",
                     "/brpc_metrics", "/list_vars",
                     "/vars?filter=http_test_probe"):
            out = _both(servers, "GET", path)
            _same_head(out)
            assert b"http_test_probe_var" in out["port"][2]
        out = _both(servers, "GET", "/vars/http_test_probe_var")
        assert out["port"][2] == out["jax"][2] == \
            b"http_test_probe_var : 7\n"
    finally:
        for p in probes:
            p.hide()


def test_flags_get_and_live_set(servers):
    out = _both(servers, "GET", "/flags")
    _same_head(out)
    assert b"max_body_size" in out["port"][2]
    try:
        out = _both(servers, "GET", "/flags/drain_grace_ms?setvalue=7000")
        _same_head(out)
        assert out["port"][2] == out["jax"][2]
        assert tflags.get_flag("drain_grace_ms") == 7000
        assert jflags.get_flag("drain_grace_ms") == 7000
        out = _both(servers, "GET", "/flags/drain_grace_ms?setvalue=-1")
        assert out["port"][0] == out["jax"][0] == 403
        out = _both(servers, "GET", "/flags/no_such_flag")
        assert out["port"][0] == out["jax"][0] == 404
    finally:
        tflags.set_flag("drain_grace_ms", 5000)
        jflags.set_flag("drain_grace_ms", 5000)


def test_max_body_size_flag_is_effective(servers):
    from brpc_tpu_torch.butil.iobuf import IOBuf
    from brpc_tpu_torch.protocol.base import ParseError
    from brpc_tpu_torch.protocol.http import parse
    assert tflags.set_flag("max_body_size", 16)
    try:
        buf = IOBuf(b"POST /Calc/Echo HTTP/1.1\r\nContent-Length: 100"
                    b"\r\n\r\n" + b"x" * 100)
        assert parse(buf, None, False, None).error == \
            ParseError.TOO_BIG_DATA
        # over the wire the port server refuses the frame and closes
        with pytest.raises((http.client.HTTPException, OSError)):
            _request(servers["port"].listen_endpoint, "POST", "/Calc/Echo",
                     body=b"x" * 100)
    finally:
        tflags.set_flag("max_body_size", 64 * 1024 * 1024)
    status, _, body = _request(servers["port"].listen_endpoint, "POST",
                               "/Calc/Echo", body=b"x" * 100)
    assert status == 200 and body == b"x" * 100


def test_rpc_bridge_post_json_and_keep_alive(servers):
    for srv in servers.values():
        ep = srv.listen_endpoint
        c = http.client.HTTPConnection(ep.host, ep.port, timeout=10)
        c.request("POST", "/Calc/Add", body=json.dumps({"a": 20, "b": 22}),
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        assert r.status == 200
        assert json.loads(r.read()) == {"sum": 42}
        c.request("POST", "/Calc/Echo", body=b"raw-bytes")
        r = c.getresponse()
        assert r.status == 200 and r.read() == b"raw-bytes"
        # /Service.Method spells the same route
        c.request("POST", "/Calc.Echo", body=b"dotted")
        r = c.getresponse()
        assert r.status == 200 and r.read() == b"dotted"
        c.close()


@pytest.mark.parametrize("path,code,status", [
    ("/Calc/Fail", "1003", 400), ("/Calc/Boom", "2001", 500)])
def test_rpc_bridge_error_mapping(servers, path, code, status):
    out = _both(servers, "POST", path, body=b"")
    _same_head(out)
    for st, hdrs, body in out.values():
        assert st == status and hdrs["x-rpc-error-code"] == code
    assert out["port"][2] == out["jax"][2]


def _port_http_channel(ep):
    ch = Channel(protocol="http")
    assert ch.init(str(ep)) == 0
    return ch


def _jax_http_channel(ep):
    opts = JChannelOptions()
    opts.protocol = "http"
    ch = JChannel(opts)
    assert ch.init(str(ep)) == 0
    return ch


@pytest.mark.parametrize("client,server", [("port", "port"),
                                           ("port", "jax"),
                                           ("jax", "port")])
def test_http_channel_cross_wired(servers, client, server):
    ep = servers[server].listen_endpoint
    if client == "port":
        ch = _port_http_channel(ep)
        cntl = Controller()
        cntl.request_attachment = b"ATTACH" * 10
    else:
        ch = _jax_http_channel(ep)
        cntl = JController()
        cntl.request_attachment.append(b"ATTACH" * 10)
    c = ch.call_method("Calc.Echo", b"over-http", cntl=cntl)
    assert not c.failed, c.error_text
    assert bytes(c.response) == b"over-http"
    att = c.response_attachment
    assert (bytes(att) if client == "port" else att.to_bytes()) == \
        b"ATTACH" * 10
    c = ch.call_method("Calc.Fail", b"")
    assert c.failed and c.error_code == 1003
    assert "bad calc" in c.error_text


def test_same_port_serves_tpu_std_and_http(servers):
    srv = servers["port"]
    ch = Channel()
    assert ch.init(str(srv.listen_endpoint)) == 0
    assert ch.call("Calc.Echo", b"native") == b"native"
    status, _, body = _request(srv.listen_endpoint, "GET", "/health")
    assert status == 200 and body == b"OK\n"
    assert _port_http_channel(srv.listen_endpoint).call(
        "Calc.Echo", b"http") == b"http"
    assert ch.call("Calc.Echo", b"again") == b"again"
    ch.close()


def _one_connection(ep, first, second):
    """Both answers on one connection: ``first`` then ``second`` sent
    after the first's answer, each answer read whole."""
    def answer(s, got):
        while True:
            if got.startswith(b"HTTP/1.1"):
                head, sep, rest = got.partition(b"\r\n\r\n")
                if sep:
                    n = int(next(ln.split(b":")[1] for ln in
                                 head.split(b"\r\n")
                                 if ln.lower().startswith(b"content-length")))
                    if len(rest) >= n:
                        return got[:len(head) + 4 + n], rest[n:]
            elif got.startswith(b"TRPC") and len(got) >= 12:
                (body,) = struct.unpack_from("<I", got, 4)
                if len(got) >= 12 + body:
                    return got[:12 + body], got[12 + body:]
            chunk = s.recv(65536)
            assert chunk, "the server closed the connection"
            got += chunk

    with socket.create_connection((ep.host, ep.port), timeout=10) as s:
        s.sendall(first)
        a, rest = answer(s, b"")
        s.sendall(second)
        b, _ = answer(s, rest)
    return a, b


def test_connection_protocol_is_fixed_at_first_bytes(servers):
    """The protocol is no longer fixed at a connection's first bytes:
    the port's messenger detects each message, as the JAX one does, so a
    tpu_std frame after an HTTP request on one connection is answered,
    and an HTTP request after a tpu_std frame too -- byte for byte as
    the JAX server answers them (its date and version headers aside)."""
    from brpc_tpu_torch.protocol.meta import RpcMeta
    from brpc_tpu_torch.protocol.tpu_std import pack_frame
    meta = RpcMeta()
    meta.correlation_id = 1
    meta.service_name, meta.method_name = "Calc", "Echo"
    frame = pack_frame(meta, b"x")
    http_req = (b"GET /health HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: 0\r\n\r\n")
    for first, second in ((http_req, frame), (frame, http_req)):
        got = {}
        for which in ("port", "jax"):
            got[which] = _one_connection(servers[which].listen_endpoint,
                                         first, second)
        for (pa, ja) in zip(got["port"], got["jax"]):
            if pa.startswith(b"TRPC"):
                assert pa == ja
            else:
                assert pa.startswith(b"HTTP/1.1 200") \
                    and pa.endswith(b"OK\n") and ja.endswith(b"OK\n")


def test_internal_port_gates_builtin_pages():
    out = {}
    for which, Opts in (("port", ServerOptions), ("jax", JServerOptions)):
        opts = Opts()
        opts.internal_port = 0
        srv = _start(which, opts)
        try:
            ep, iep = srv.listen_endpoint, srv.internal_endpoint
            assert iep is not None and iep.port != ep.port
            out[which] = [
                _request(ep, "GET", "/flags")[0],
                _request(ep, "GET", "/health")[:3:2],
                _request(ep, "GET", "/version")[0],
                _request(ep, "POST", "/Calc/Echo", body=b"ping")[::2],
                _request(iep, "GET", "/flags")[0],
                _request(iep, "GET", "/status")[0]]
        finally:
            srv.stop()
    assert out["port"] == out["jax"] == [
        403, (200, b"OK\n"), 200, (200, b"ping"), 200, 200]


def test_restful_mappings():
    opts = ServerOptions()
    opts.restful_mappings = ("/v1/echo => Calc.Echo, /files/* => Calc.Path,"
                             " /bad => Calc.Nope")
    jopts = JServerOptions()
    jopts.restful_mappings = opts.restful_mappings
    srvs = {"port": _start("port", opts), "jax": _start("jax", jopts)}
    try:
        out = _both(srvs, "POST", "/v1/echo", body=b"restful")
        assert out["port"][::2] == out["jax"][::2] == (200, b"restful")
        out = _both(srvs, "GET", "/files/a/b/c.txt")
        assert json.loads(out["port"][2]) == json.loads(out["jax"][2]) == {
            "method": "GET", "path": "/files/a/b/c.txt", "rest": "a/b/c.txt"}
        out = _both(srvs, "GET", "/bad")
        assert out["port"][0] == out["jax"][0] == 404
    finally:
        for srv in srvs.values():
            srv.stop()


def test_http_reject_is_the_jax_503():
    from brpc_tpu.server.admission import Rejection as JRejection
    from brpc_tpu.server.admission import http_reject as jreject
    from brpc_tpu_torch.server.admission import Rejection, http_reject
    assert http_reject(Rejection("method_cap", "too many", 2)) == \
        jreject(JRejection("method_cap", "too many", 2))
    # a method cap of 1 with one call in flight answers the next with it
    for which, Opts in (("port", ServerOptions), ("jax", JServerOptions)):
        opts = Opts()
        opts.method_max_concurrency = {"Calc.Slow": 1}
        gate = threading.Event()

        class Slow(_Calc):
            def Slow(self, cntl, request):
                gate.wait(10)
                return b"slow"
        Base = Service if which == "port" else JService
        srv = Server(opts) if which == "port" else JServer(opts)
        srv.add_service(type("Calc", (Base, Slow), {})(), name="Calc")
        assert srv.start("127.0.0.1:0") == 0
        try:
            first = threading.Thread(target=_request, args=(
                srv.listen_endpoint, "POST", "/Calc/Slow", b""))
            first.start()
            deadline = time.monotonic() + 10
            while srv.find_method("Calc", "Slow").status.inflight < 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            status, hdrs, body = _request(srv.listen_endpoint, "POST",
                                          "/Calc/Slow", b"")
            assert status == 503, which
            assert hdrs["retry-after"] == "1"
            assert hdrs["x-overload-reason"] == "method_cap"
            assert hdrs["x-rpc-error-code"] == "2004"
            gate.set()
            first.join(10)
        finally:
            gate.set()
            srv.stop()


def test_deadline_header_sheds_as_jax(servers):
    out = _both(servers, "POST", "/Calc/Echo", body=b"late",
                headers={"x-deadline-ms": "0"})
    _same_head(out)
    for status, hdrs, _ in out.values():
        assert status == 500 and hdrs["x-rpc-error-code"] == "1008"
    out = _both(servers, "POST", "/Calc/Echo", body=b"in time",
                headers={"x-deadline-ms": "5000"})
    assert out["port"][::2] == out["jax"][::2] == (200, b"in time")


def test_drain_sets_lame_duck_headers():
    for which in ("port", "jax"):
        srv = _start(which)
        try:
            ep = srv.listen_endpoint
            c = http.client.HTTPConnection(ep.host, ep.port, timeout=10)
            c.request("GET", "/health")
            assert c.getresponse().read() == b"OK\n"
            assert srv.drain(200) == 0
            c.request("POST", "/Calc/Echo", body=b"x")
            r = c.getresponse()
            r.read()
            # the draining server answers 503 ELAMEDUCK with the signal
            # and closes the keep-alive connection
            assert r.status == 503, which
            assert r.getheader("x-lame-duck") == "1"
            assert r.getheader("x-rpc-error-code") == "2008"
            assert (r.getheader("connection") or "").lower() == "close"
            c.close()
        finally:
            srv.stop()


def test_progressive_attachment_streams_chunks(servers):
    for srv in servers.values():
        status, hdrs, body = _request(srv.listen_endpoint, "POST",
                                      "/Calc/Chunks", body=b"")
        assert status == 200
        assert hdrs["transfer-encoding"] == "chunked"
        assert body == b"one,two,three"


def test_json2pb_hooks_match_jax():
    pytest.importorskip("google.protobuf")
    from google.protobuf import struct_pb2

    from brpc_tpu.protocol import json2pb as jj
    from brpc_tpu_torch.protocol import json2pb as tj
    raw = json.dumps({"a": 2, "who": "json2pb"}).encode()
    for mod in (tj, jj):
        assert mod.maybe_parse_request(raw, None, "application/json") is None
    msg = tj.maybe_parse_request(raw, struct_pb2.Struct, "application/json")
    assert msg == jj.maybe_parse_request(raw, struct_pb2.Struct,
                                         "application/json")
    assert tj.maybe_encode_response(msg) == jj.maybe_encode_response(msg)
    assert tj.maybe_encode_response(b"bytes") is None


def test_chunked_request_body(servers):
    for srv in servers.values():
        ep = srv.listen_endpoint
        with socket.create_connection((ep.host, ep.port), timeout=10) as s:
            s.sendall(b"POST /Calc/Echo HTTP/1.1\r\nHost: x\r\n"
                      b"Transfer-Encoding: chunked\r\n\r\n"
                      b"5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n")
            got = b""
            while not got.endswith(b"hello world"):
                chunk = s.recv(65536)
                assert chunk
                got += chunk
        assert got.startswith(b"HTTP/1.1 200 OK")


def test_compress_registry_matches_jax():
    from brpc_tpu.protocol import compress as jc
    from brpc_tpu_torch.protocol import compress as tc
    data = b"compress me " * 100
    for ctype in (0, 1, 2):
        assert tc.supported(ctype) == jc.supported(ctype)
        assert tc.decompress(tc.compress(data, ctype), ctype) == data
        assert jc.decompress(tc.compress(data, ctype), ctype) == data


def test_http_span_backdated_to_arrival_unlike_jax():
    """Divergence: the port's HTTP chain backdates a request's server
    span to the message's arrival and settles its latency from it, as
    the port's tpu_std lane does; the JAX package's HTTP chain starts
    both when the chain runs.  A message that arrived 50 ms before the
    chain ran shows the queue in the port's span alone."""
    from brpc_tpu.protocol.http import HttpMessage as JMsg
    from brpc_tpu.server.interceptors import compile_http_chain as jchain
    from brpc_tpu_torch.protocol.http import HttpMessage
    from brpc_tpu_torch.server.interceptors import compile_http_chain

    class _Sock:
        id = 0
        remote_side = None

        def write(self, data):
            raise AssertionError("nothing is written on admission")

    queued_us = 50_000
    out = {}
    for which, Msg, chain in (("port", HttpMessage, compile_http_chain),
                              ("jax", JMsg, jchain)):
        srv = _start(which)
        try:
            entry = srv.find_method("Calc", "Echo")
            enter, settle = chain(srv, entry)
            msg = Msg()
            msg.method, msg.path = "POST", "/Calc/Echo"
            msg.headers.set("traceparent", "00-" + "ab" * 16 + "-"
                            + "cd" * 8 + "-01")
            msg.recv_us -= queued_us
            cntl = enter(msg, _Sock(), "Calc", "Echo", "",
                         lambda c, r: None)
            span = cntl.span
            out[which] = (span.start_us - span.received_us,
                          cntl.begin_time_us == msg.recv_us)
            settle(cntl, 0)
        finally:
            srv.stop()
    assert out["port"][0] >= queued_us * 0.9 and out["port"][1]
    assert out["jax"][0] < queued_us * 0.5 and not out["jax"][1]
