"""TLS at both ends, held against the JAX package (``tests/test_ssl.py``'s
cases, both ways): the port's TLS client against a JAX TLS server and
the JAX TLS client against a port TLS server, on single connections
(pooled and short ones from the port's client); a pinned CA; a plaintext client refused by a TLS
server and a TLS client against a plaintext server, both failing
cleanly; the protocol check after the handshake (HTTP/1.1 and gRPC over
TLS on the same port as tpu_std).  The certificates are made with the
``openssl`` CLI, as ``tests/test_ssl.py`` makes them."""

import http.client
import ssl
import subprocess
import time

import pytest

from brpc_tpu.butil.iobuf import IOBuf as JIOBuf
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import ChannelOptions as JChannelOptions
from brpc_tpu.client import Controller as JController
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import ServerOptions as JServerOptions
from brpc_tpu.server import Service as JService
from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
from brpc_tpu_torch.server import Server, ServerOptions, Service


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("certs")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1",
         "-subj", "/CN=localhost",
         "-addext", "subjectAltName=IP:127.0.0.1,DNS:localhost"],
        check=True, capture_output=True, timeout=60)
    return cert, key


class _Echo:
    def Echo(self, cntl, request):
        return bytes(request)


class TEcho(Service, _Echo):
    def Att(self, cntl, request):
        cntl.response_attachment = cntl.request_attachment
        return b"ok"


class JEcho(JService, _Echo):
    def Att(self, cntl, request):
        cntl.response_attachment.append_iobuf(cntl.request_attachment)
        return b"ok"


def _start(which, certs=None):
    opts = ServerOptions() if which == "port" else JServerOptions()
    if certs is not None:
        opts.ssl_cert, opts.ssl_key = certs
    srv = Server(opts) if which == "port" else JServer(opts)
    srv.add_service(TEcho() if which == "port" else JEcho(), name="E")
    assert srv.start("127.0.0.1:0") == 0
    return srv


@pytest.fixture(scope="module")
def tls_servers(certs):
    srvs = {w: _start(w, certs) for w in ("port", "jax")}
    yield srvs
    for s in srvs.values():
        s.stop()


def _channel(which, server, ctype="single", ssl_on=True, **kw):
    co = ChannelOptions() if which == "port" else JChannelOptions()
    co.ssl = ssl_on
    co.connection_type = ctype
    co.timeout_ms = 5000
    for k, v in kw.items():
        setattr(co, k, v)
    ch = Channel(co) if which == "port" else JChannel(co)
    assert ch.init(str(server.listen_endpoint)) == 0
    return ch


def _close(ch):
    if hasattr(ch, "close"):
        ch.close()


PAIRS = [("port", "jax"), ("jax", "port"), ("port", "port")]
IDS = [f"{c}-to-{s}" for c, s in PAIRS]


@pytest.mark.parametrize("client,server", PAIRS, ids=IDS)
def test_tls_echo_single(tls_servers, client, server):
    ch = _channel(client, tls_servers[server])
    try:
        assert ch.call("E.Echo", b"secret-hello") == b"secret-hello"
        for i in range(20):
            assert ch.call("E.Echo", b"m%d" % i) == b"m%d" % i
    finally:
        _close(ch)


# the JAX client's pooled and short TLS connections lose a response now
# and then under load, against either package's server (ROADMAP C6):
# these cases run the port's client, to both servers
@pytest.mark.parametrize("client,server", [("port", "jax"), ("port", "port")],
                         ids=["port-to-jax", "port-to-port"])
def test_tls_echo_pooled_and_short(tls_servers, client, server):
    for ctype in ("pooled", "short"):
        ch = _channel(client, tls_servers[server], ctype=ctype)
        try:
            for i in range(3):
                want = b"via-" + ctype.encode() + b"%d" % i
                assert ch.call("E.Echo", want) == want
        finally:
            _close(ch)


@pytest.mark.parametrize("client,server", PAIRS, ids=IDS)
def test_tls_large_payload_and_attachment(tls_servers, client, server):
    """512 KiB attachments: the reader loops over partial TLS reads until
    each frame is whole."""
    ch = _channel(client, tls_servers[server])
    big = bytes(range(256)) * 2048
    try:
        cntl = Controller() if client == "port" else JController()
        cntl.timeout_ms = 20_000
        cntl.request_attachment = big if client == "port" else JIOBuf(big)
        c = ch.call_method("E.Att", b"", cntl=cntl)
        assert not c.failed, c.error_text
        att = c.response_attachment
        assert (bytes(att) if client == "port" else att.to_bytes()) == big
    finally:
        _close(ch)


@pytest.mark.parametrize("client,server", PAIRS, ids=IDS)
def test_tls_verified_against_pinned_ca(tls_servers, certs, client, server):
    ch = _channel(client, tls_servers[server], ssl_ca=certs[0],
                  ssl_verify=True)
    try:
        assert ch.call("E.Echo", b"verified") == b"verified"
    finally:
        _close(ch)


def test_port_client_with_ssl_context(tls_servers, certs):
    ctx = ssl.create_default_context(cafile=certs[0])
    for server in tls_servers.values():
        ch = _channel("port", server, ssl_on=False, ssl_context=ctx)
        try:
            assert ch.call("E.Echo", b"ctx") == b"ctx"
        finally:
            ch.close()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_plaintext_client_rejected_by_tls_server(tls_servers, client):
    srv = tls_servers["port"]
    ch = _channel(client, srv, ssl_on=False, max_retry=0, timeout_ms=2000)
    cntl = Controller() if client == "port" else JController()
    t0 = time.monotonic()
    ch.call_method("E.Echo", b"plaintext", cntl=cntl)
    assert cntl.failed
    assert time.monotonic() - t0 < 3.0
    _close(ch)
    # and the server still serves TLS clients afterwards
    ch2 = _channel(client, srv)
    try:
        assert ch2.call("E.Echo", b"still-works") == b"still-works"
    finally:
        _close(ch2)


@pytest.mark.parametrize("client,server", PAIRS, ids=IDS)
def test_tls_client_against_plaintext_server_fails_cleanly(client, server):
    srv = _start(server)
    try:
        ch = _channel(client, srv, max_retry=0, timeout_ms=2000)
        cntl = Controller() if client == "port" else JController()
        t0 = time.monotonic()
        ch.call_method("E.Echo", b"x", cntl=cntl)
        assert cntl.failed
        assert time.monotonic() - t0 < 6.0      # an error, not a hang
        _close(ch)
        plain = _channel(client, srv, ssl_on=False)
        try:
            assert plain.call("E.Echo", b"plain") == b"plain"
        finally:
            _close(plain)
    finally:
        srv.stop()


# -- the protocol check after the handshake ----------------------------------

def _unverified():
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


def test_http_over_tls_on_the_same_port(tls_servers):
    """HTTP/1.1 over TLS reaches the RPC bridge and the portal of the
    port that serves tpu_std over TLS, as on the JAX server."""
    got = {}
    for which, srv in tls_servers.items():
        ep = srv.listen_endpoint
        conn = http.client.HTTPSConnection(ep.host, ep.port, timeout=10,
                                           context=_unverified())
        try:
            conn.request("POST", "/E/Echo", body=b"over-https")
            r = conn.getresponse()
            echo = (r.status, r.read())
            conn.request("GET", "/health")
            r = conn.getresponse()
            health = (r.status, r.read())
        finally:
            conn.close()
        got[which] = (echo, health[0])
    assert got["port"] == got["jax"] == ((200, b"over-https"), 200)


@pytest.mark.parametrize("server", ["port", "jax"])
def test_http_and_grpc_channels_over_tls(tls_servers, server):
    for protocol in ("http", "grpc"):
        ch = _channel("port", tls_servers[server], protocol=protocol)
        try:
            assert ch.call("E.Echo", b"via-" + protocol.encode()) \
                == b"via-" + protocol.encode()
        finally:
            ch.close()
