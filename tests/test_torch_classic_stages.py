"""The classic tpu_std lane's stages (ROADMAP C13) held against the JAX
package's, both ways: compression (a GZIP echo and a GZIP ``LMService``
Generate on ``device="cpu"``, port client to JAX server and JAX client
to port server; response compression; an unknown type), auth on a
connection's first message (``ERPCAUTH``), the user interceptor's
verdicts (its own code and text, a raise, a bare False), session-local
data reused across one connection's calls, and ``@method(
response_compress=)``.  A refused call runs no handler."""

import socket
import threading

import jax
import numpy as np
import pytest

from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import ChannelOptions as JChannelOptions
from brpc_tpu.client import Controller as JController
from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import ServerOptions as JServerOptions
from brpc_tpu.server import Service as JService
from brpc_tpu.server import method as jmethod
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.protocol import compress
from brpc_tpu_torch.protocol.meta import CompressType, RpcMeta
from brpc_tpu_torch.protocol.tpu_std import pack_frame, read_frame
from brpc_tpu_torch.server import Server, ServerOptions, Service, method
from brpc_tpu_torch.utils.convert import params_from_numpy

GZIP = CompressType.GZIP
PAYLOAD = b"compress me " * 1000
TIMEOUT_MS = 60_000
CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)

CALLS = {"port": 0, "jax": 0}        # handler runs, by server package
_calls_lock = threading.Lock()


class _Stages:
    PKG = ""

    def _count(self):
        with _calls_lock:
            CALLS[self.PKG] += 1

    def Echo(self, cntl, request):
        self._count()
        return bytes(request)

    def SeenCompress(self, cntl, request):
        self._count()
        return b"%d:%d" % (cntl.request_meta.compress_type, len(request))

    def SetGz(self, cntl, request):
        self._count()
        cntl.response_compress_type = GZIP
        return bytes(request) * 2

    def Use(self, cntl, request):
        self._count()
        d = cntl.session_local_data()
        d["hits"] = d.get("hits", 0) + 1
        return b"%d:%d" % (d["hits"], id(d))


class TStages(Service, _Stages):
    PKG = "port"

    @method(response_compress=GZIP)
    def Gz(self, cntl, request):
        self._count()
        return bytes(request)


class JStages(JService, _Stages):
    PKG = "jax"

    @jmethod(response_compress=GZIP)
    def Gz(self, cntl, request):
        self._count()
        return bytes(request)


class Auth:
    def verify(self, auth_data, cntl):
        if auth_data == b"boom":
            raise RuntimeError("verifier broke")
        return auth_data == b"secret"


def interceptor(cntl):
    name = cntl.request_meta.method_name
    if name == "Deny":
        return (False, int(Errno.ELIMIT), "tenant over quota")
    if name == "Bare":
        return False
    if name == "Raise":
        raise ValueError("interceptor broke")
    if name == "Pass":
        return (True, 0, "")
    return True


class _Verdicts:
    PKG = ""

    def _run(self, cntl, request):
        with _calls_lock:
            CALLS[self.PKG] += 1
        return b"ran"

    Deny = Bare = Raise = Pass = Fine = _run


class TVerdicts(Service, _Verdicts):
    PKG = "port"


class JVerdicts(JService, _Verdicts):
    PKG = "jax"


def _server(which, **opts):
    options = ServerOptions() if which == "port" else JServerOptions()
    for k, v in opts.items():
        setattr(options, k, v)
    srv = Server(options) if which == "port" else JServer(options)
    assert srv.add_service(TStages() if which == "port" else JStages(),
                           name="S") == 0
    assert srv.add_service(TVerdicts() if which == "port" else JVerdicts(),
                           name="V") == 0
    assert srv.start("127.0.0.1:0") == 0
    return srv


@pytest.fixture(scope="module")
def plain():
    srvs = {w: _server(w) for w in ("port", "jax")}
    yield srvs
    for s in srvs.values():
        s.stop()


def _channel(which, ep, **opts):
    co = ChannelOptions() if which == "port" else JChannelOptions()
    co.timeout_ms = TIMEOUT_MS
    for k, v in opts.items():
        setattr(co, k, v)
    ch = Channel(co) if which == "port" else JChannel(co)
    assert ch.init(str(ep)) == 0
    return ch


def _call(which, ch, method_full, request, **cntl_opts):
    c = Controller() if which == "port" else JController()
    c.timeout_ms = TIMEOUT_MS
    for k, v in cntl_opts.items():
        setattr(c, k, v)
    return ch.call_method(method_full, request, cntl=c)


def _response_bytes(c):
    r = c.response
    return r.to_bytes() if hasattr(r, "to_bytes") else bytes(r)


def _close(ch):
    if hasattr(ch, "close"):
        ch.close()


def _raw(ep, meta: RpcMeta, payload: bytes, conn=None):
    """One request frame on a raw connection: (response meta, payload)."""
    own = conn is None
    if own:
        conn = socket.create_connection((ep.host, ep.port), timeout=10)
    try:
        conn.sendall(pack_frame(meta, payload))
        rmeta, body, _ = read_frame(conn)
        return rmeta, body
    finally:
        if own:
            conn.close()


def _meta(service, method_name, cid=1, **kw):
    m = RpcMeta()
    m.correlation_id = cid
    m.service_name, m.method_name = service, method_name
    for k, v in kw.items():
        setattr(m, k, v)
    return m


PAIRS = [("port", "jax"), ("jax", "port"), ("port", "port"), ("jax", "jax")]


# -- compression -------------------------------------------------------------

@pytest.mark.parametrize("client,server", PAIRS,
                         ids=[f"{c}-to-{s}" for c, s in PAIRS])
def test_gzip_echo_both_ways(plain, client, server):
    ch = _channel(client, plain[server].listen_endpoint)
    try:
        c = _call(client, ch, "S.Echo", PAYLOAD, request_compress_type=GZIP)
        assert not c.failed, c.error_text
        assert _response_bytes(c) == PAYLOAD
        # the request rode compressed: the handler saw the type and the
        # decompressed bytes
        c = _call(client, ch, "S.SeenCompress", PAYLOAD,
                  request_compress_type=GZIP)
        assert _response_bytes(c) == b"1:%d" % len(PAYLOAD)
    finally:
        _close(ch)


@pytest.mark.parametrize("client,server", PAIRS[:2],
                         ids=[f"{c}-to-{s}" for c, s in PAIRS[:2]])
def test_channel_option_compresses_every_call(plain, client, server):
    ch = _channel(client, plain[server].listen_endpoint,
                  request_compress_type=GZIP)
    try:
        for _ in range(3):
            c = _call(client, ch, "S.SeenCompress", PAYLOAD)
            assert _response_bytes(c) == b"1:%d" % len(PAYLOAD)
    finally:
        _close(ch)


def test_compressed_frames_match_jax(plain):
    """A GZIP request frame answered by both servers: equal metas and
    bodies; a response compressed in the handler carries the type."""
    packed = compress.compress(PAYLOAD, GZIP)
    out = {}
    for which, srv in plain.items():
        ep = srv.listen_endpoint
        echo = _raw(ep, _meta("S", "Echo", compress_type=GZIP), packed)
        gz = _raw(ep, _meta("S", "SetGz", cid=2), b"ab" * 500)
        out[which] = (echo[0].compress_type, echo[0].error_code, echo[1],
                      gz[0].compress_type,
                      compress.decompress(gz[1], gz[0].compress_type))
    assert out["port"] == out["jax"]
    assert out["port"] == (0, 0, PAYLOAD, GZIP, b"ab" * 1000)


def test_unknown_compress_type_answers_erequest(plain):
    got = {}
    for which, srv in plain.items():
        rmeta, _ = _raw(srv.listen_endpoint,
                        _meta("S", "Echo", compress_type=9), b"xyz")
        got[which] = (rmeta.error_code, rmeta.error_text)
    assert got["port"] == got["jax"] == (int(Errno.EREQUEST),
                                         "unsupported compress_type 9")


def test_undecompressable_request_answers_erequest(plain):
    """A GZIP-typed payload that is not gzip: the port answers EREQUEST
    and runs no handler (the JAX lane lets the decompressor's error
    escape its dispatcher, ROADMAP C9)."""
    before = CALLS["port"]
    rmeta, _ = _raw(plain["port"].listen_endpoint,
                    _meta("S", "Echo", compress_type=GZIP), b"not gzip")
    assert rmeta.error_code == int(Errno.EREQUEST)
    assert rmeta.error_text.startswith("request decompression failed")
    assert CALLS["port"] == before


@pytest.mark.parametrize("client", ["port", "jax"])
def test_method_response_compress(plain, client):
    """``@method(response_compress=GZIP)``: the port's server answers
    compressed and both clients read it back.  The JAX package records
    the option and never reads it (``brpc_tpu/server/service.py:29``),
    so its server answers the same method uncompressed (ROADMAP C9)."""
    rmeta, body = _raw(plain["port"].listen_endpoint,
                       _meta("S", "Gz"), PAYLOAD)
    assert rmeta.compress_type == GZIP and len(body) < len(PAYLOAD)
    assert compress.decompress(body, GZIP) == PAYLOAD
    ch = _channel(client, plain["port"].listen_endpoint)
    try:
        c = _call(client, ch, "S.Gz", PAYLOAD)
        assert not c.failed, c.error_text
        assert _response_bytes(c) == PAYLOAD
    finally:
        _close(ch)
    jmeta, jbody = _raw(plain["jax"].listen_endpoint, _meta("S", "Gz"),
                        PAYLOAD)
    assert jmeta.compress_type == 0 and jbody == PAYLOAD


# -- a GZIP Generate on the CPU, both ways -----------------------------------

@pytest.fixture(scope="module")
def lm_servers():
    cfg = jlm.LMConfig(**CFG)
    jp = jlm.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    port = Server()
    assert port.add_service(tsvc.LMService(cfg=tlm.LMConfig(**CFG),
                                           params=tp, device="cpu"),
                            name="LM") == 0
    jsrv = JServer()
    assert jsrv.add_service(jsvc.LMService(cfg=cfg, params=jp),
                            name="LM") == 0
    for s in (port, jsrv):
        assert s.start("127.0.0.1:0") == 0
    yield {"port": port, "jax": jsrv}
    port.stop()
    jsrv.stop()


@pytest.mark.parametrize("client,server", PAIRS[:2],
                         ids=[f"{c}-to-{s}" for c, s in PAIRS[:2]])
def test_gzip_generate_both_ways(lm_servers, client, server):
    """A GZIP Generate answers the tokens of the same call uncompressed
    on the same server."""
    prompt = np.random.default_rng(3).integers(0, CFG["vocab"], (2, 6),
                                               dtype=np.int32)
    req = tsvc.pack_generate_request(prompt, 5)
    ch = _channel(client, lm_servers[server].listen_endpoint)
    try:
        plain_c = _call(client, ch, "LM.Generate", req)
        gz_c = _call(client, ch, "LM.Generate", req,
                     request_compress_type=GZIP)
        assert not plain_c.failed and not gz_c.failed, gz_c.error_text
        a = tsvc.unpack_generated(_response_bytes(plain_c))
        b = tsvc.unpack_generated(_response_bytes(gz_c))
        assert a.shape == (2, 5)
        np.testing.assert_array_equal(a, b)
    finally:
        _close(ch)


# -- auth --------------------------------------------------------------------

@pytest.fixture(scope="module")
def authed():
    srvs = {w: _server(w, auth=Auth()) for w in ("port", "jax")}
    yield srvs
    for s in srvs.values():
        s.stop()


@pytest.mark.parametrize("client,server", PAIRS,
                         ids=[f"{c}-to-{s}" for c, s in PAIRS])
def test_auth_refuses_bad_and_serves_good(authed, client, server):
    ep = authed[server].listen_endpoint
    for bad in (b"", b"wrong", b"boom"):
        ch = _channel(client, ep, auth_data=bad, max_retry=0)
        try:
            before = dict(CALLS)
            c = _call(client, ch, "S.Echo", b"x")
            assert c.failed
            assert (c.error_code, c.error_text) == (
                int(Errno.ERPCAUTH), "authentication failed")
            assert CALLS == before          # no handler ran
        finally:
            _close(ch)
    ch = _channel(client, ep, auth_data=b"secret")
    try:
        for i in range(3):
            c = _call(client, ch, "S.Echo", b"ok%d" % i)
            assert not c.failed, c.error_text
            assert _response_bytes(c) == b"ok%d" % i
    finally:
        _close(ch)


def test_auth_on_first_message_only(authed):
    """Both servers check a connection's first message; once it passed,
    later frames on that connection need no credentials, and a refused
    connection stays refused."""
    got = {}
    for which, srv in authed.items():
        ep = srv.listen_endpoint
        with socket.create_connection((ep.host, ep.port), timeout=10) as c:
            first = _raw(ep, _meta("S", "Echo", auth_data=b"secret"),
                         b"a", c)
            second = _raw(ep, _meta("S", "Echo", cid=2), b"b", c)
        with socket.create_connection((ep.host, ep.port), timeout=10) as c:
            bad = _raw(ep, _meta("S", "Echo", auth_data=b"no"), b"c", c)
            after = _raw(ep, _meta("S", "Echo", cid=2), b"d", c)
        got[which] = [(m.error_code, m.error_text, body)
                      for m, body in (first, second, bad, after)]
    assert got["port"] == got["jax"]
    assert [g[0] for g in got["port"]] == [0, 0, int(Errno.ERPCAUTH),
                                           int(Errno.ERPCAUTH)]


# -- the interceptor ---------------------------------------------------------

@pytest.fixture(scope="module")
def intercepted():
    srvs = {w: _server(w, interceptor=interceptor) for w in ("port", "jax")}
    yield srvs
    for s in srvs.values():
        s.stop()


@pytest.mark.parametrize("name,want", [
    ("Deny", (int(Errno.ELIMIT), "tenant over quota")),
    ("Bare", (int(Errno.EREJECT), "rejected")),
    ("Raise", (int(Errno.EINTERNAL), "interceptor: interceptor broke")),
    ("Pass", (0, "")),
    ("Fine", (0, ""))])
@pytest.mark.parametrize("client", ["port", "jax"])
def test_interceptor_verdicts_match_jax(intercepted, client, name, want):
    got = {}
    for which, srv in intercepted.items():
        ch = _channel(client, srv.listen_endpoint, max_retry=0)
        try:
            before = CALLS[which]
            c = _call(client, ch, f"V.{name}", b"q")
            ran = CALLS[which] - before
            got[which] = (c.error_code, c.error_text, ran)
        finally:
            _close(ch)
    assert got["port"] == got["jax"] == (*want, 0 if want[0] else 1)


# -- session-local data ------------------------------------------------------

@pytest.fixture(scope="module")
def sessions():
    srvs = {w: _server(w, session_local_data_factory=dict)
            for w in ("port", "jax")}
    yield srvs
    for s in srvs.values():
        s.stop()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_session_local_data_reused_on_one_connection(sessions, client):
    seen = {}
    for which, srv in sessions.items():
        ch = _channel(client, srv.listen_endpoint)
        try:
            outs = [_response_bytes(_call(client, ch, "S.Use", b""))
                    for _ in range(8)]
        finally:
            _close(ch)
        hits = [int(o.split(b":")[0]) for o in outs]
        objs = {o.split(b":")[1] for o in outs}
        seen[which] = (hits[-1] - hits[0], len(objs),
                       srv._session_pool.created)
    # one object served all eight calls, given back after each (the last
    # give-back may trail the last response)
    assert seen["port"] == seen["jax"] == (7, 1, 1)


def test_session_data_none_without_factory(plain):
    from brpc_tpu_torch.server.controller import ServerController
    cntl = ServerController(RpcMeta())
    cntl.server = plain["port"]
    assert cntl.session_local_data() is None
