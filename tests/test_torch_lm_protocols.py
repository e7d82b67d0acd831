"""``LM.Generate`` over every protocol of the one port: HTTP/1.1 (raw
``http.client`` and ``Channel(protocol="http")``) and gRPC over h2c
(``Channel(protocol="grpc")``), on a CPU port server and on a JAX server
with the same params.  The greedy tokens equal the tpu_std call's and
each other (on a prompt whose top-1 margins are clear of the
frameworks' logit difference, as ``tests/test_torch_lm_service.py``
picks it), and each lane's errors, deadline and trace answer as the
JAX lanes do."""

import http.client

import jax
import numpy as np
import pytest
import torch

from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import ChannelOptions as JChannelOptions
from brpc_tpu.client import Controller as JController
from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.server import Server as JServer
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.rpcz import global_span_store
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.utils.convert import params_from_numpy

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)
TIMEOUT_MS = 60_000
MAX_NEW = 4


@pytest.fixture(scope="module")
def params():
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**CFG))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def servers(params):
    port = Server()
    assert port.add_service(tsvc.LMService(
        cfg=tlm.LMConfig(**CFG), params=params[1], device="cpu"),
        name="LM") == 0
    jaxs = JServer()
    assert jaxs.add_service(jsvc.LMService(
        cfg=jlm.LMConfig(**CFG), params=params[0]), name="LM") == 0
    for srv in (port, jaxs):
        assert srv.start("127.0.0.1:0") == 0
    yield {"port": port, "jax": jaxs}
    for srv in (port, jaxs):
        srv.stop()


@pytest.fixture(scope="module")
def prompt(params):
    """A prompt whose greedy picks all have a top-1 margin well above
    the frameworks' logit difference (2e-2)."""
    cfg = tlm.LMConfig(**CFG)
    pre, step = tlm.make_decode(cfg, device="cpu")
    for seed in range(60):
        ids = np.random.default_rng(200 + seed).integers(
            0, CFG["vocab"], (2, 6), dtype=np.int32)
        cache, logits = pre(params[1], torch.from_numpy(ids))
        ok = True
        for i in range(MAX_NEW):
            top2 = torch.topk(logits, 2, dim=-1).values
            if (top2[:, 0] - top2[:, 1]).min() <= 0.08:
                ok = False
                break
            if i < MAX_NEW - 1:
                cache, logits = step(params[1], cache,
                                     torch.argmax(logits, -1))
        if ok:
            return ids
    pytest.fail("no prompt with clear top-1 margins among 60 seeds")


def _port_call(ep, req, protocol="tpu_std", method="LM.Generate",
               cntl=None):
    ch = Channel(protocol=protocol)
    assert ch.init(str(ep)) == 0
    cntl = cntl or Controller()
    cntl.timeout_ms = cntl.timeout_ms or TIMEOUT_MS
    try:
        return ch.call_method(method, req, cntl=cntl)
    finally:
        ch.close()


def _jax_call(ep, req, protocol):
    opts = JChannelOptions()
    opts.protocol = protocol
    opts.timeout_ms = TIMEOUT_MS
    ch = JChannel(opts)
    assert ch.init(str(ep)) == 0
    cntl = JController()
    cntl.timeout_ms = TIMEOUT_MS
    return ch.call_method("LM.Generate", req, cntl=cntl)


def _raw_http(ep, req, headers=None):
    c = http.client.HTTPConnection(ep.host, ep.port, timeout=60)
    try:
        c.request("POST", "/LM/Generate", body=req,
                  headers={"Content-Type": "application/octet-stream",
                           **(headers or {})})
        r = c.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        c.close()


def test_tokens_equal_over_every_lane(servers, prompt):
    req = tsvc.pack_generate_request(prompt, MAX_NEW)
    port_ep = servers["port"].listen_endpoint
    jax_ep = servers["jax"].listen_endpoint
    ref = _port_call(port_ep, req)
    assert not ref.failed, ref.error_text
    want = tsvc.unpack_generated(ref.response)
    assert want.shape == (2, MAX_NEW)
    outs = {}
    for which, ep in (("port", port_ep), ("jax", jax_ep)):
        status, hdrs, body = _raw_http(ep, req)
        assert status == 200 and \
            hdrs["content-type"] == "application/octet-stream"
        outs[f"raw_http->{which}"] = body
        for proto in ("http", "grpc"):
            c = _port_call(ep, req, proto)
            assert not c.failed, (which, proto, c.error_text)
            outs[f"port_{proto}->{which}"] = c.response
    for proto in ("http", "grpc"):
        c = _jax_call(port_ep, req, proto)
        assert not c.failed, (proto, c.error_text)
        outs[f"jax_{proto}->port"] = bytes(c.response)
    for name, body in outs.items():
        np.testing.assert_array_equal(tsvc.unpack_generated(body), want,
                                      err_msg=name)


def test_bad_request_answers_alike(servers):
    bad = tsvc.pack_generate_request(np.zeros((1, 30)), 4)   # over max_seq
    for which, srv in servers.items():
        status, hdrs, _ = _raw_http(srv.listen_endpoint, bad)
        assert status == 400 and hdrs["x-rpc-error-code"] == \
            str(int(Errno.EREQUEST)), which
        c = _port_call(srv.listen_endpoint, bad, "grpc")
        assert c.failed and c.error_code == int(Errno.EREQUEST), which
        assert "grpc-status 3" in c.error_text


def test_expired_budget_is_shed_on_both_lanes(servers, prompt):
    """A budget that has run out before dispatch: HTTP 500 with
    ``ERPCTIMEDOUT`` (``x-deadline-ms: 0``), gRPC status 4 (a
    sub-millisecond ``grpc-timeout``), the handler never run."""
    from brpc_tpu_torch.deadline import shed_counters
    from brpc_tpu_torch.models import transformer_lm
    req = tsvc.pack_generate_request(prompt, MAX_NEW)
    calls = []
    orig = transformer_lm.attention

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    transformer_lm.attention = counting
    before = dict(shed_counters())
    try:
        for which, srv in servers.items():
            status, hdrs, _ = _raw_http(srv.listen_endpoint, req,
                                        {"x-deadline-ms": "0"})
            assert status == 500, which
            assert hdrs["x-rpc-error-code"] == str(int(Errno.ERPCTIMEDOUT))
            assert _raw_grpc_call(srv.listen_endpoint, "/LM/Generate", req,
                                  "500u") == 4, which
    finally:
        transformer_lm.attention = orig
    assert not calls                         # no prefill ran
    after = shed_counters()
    assert after.get(("http", "LM.Generate"), 0) == \
        before.get(("http", "LM.Generate"), 0) + 1
    assert after.get(("grpc", "LM.Generate"), 0) == \
        before.get(("grpc", "LM.Generate"), 0) + 1


def _raw_grpc_call(ep, path, payload, grpc_timeout):
    """A hand-framed unary call whose only grpc-timeout is ours; returns
    its grpc-status."""
    import socket

    from brpc_tpu_torch.protocol.h2_rpc import pack_grpc_message
    from brpc_tpu_torch.protocol.h2_session import H2Session
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
    with socket.create_connection((ep.host, ep.port), timeout=30) as s:
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
    return int(dict(headers).get("grpc-status", "2"))


@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_traced_generate_parents_the_server_span(servers, prompt,
                                                 protocol):
    """A traced call over HTTP (``traceparent``) or gRPC (the same
    header over HPACK): the server span is parented to the client span
    and carries the trace id, as on tpu_std."""
    import time
    srv = servers["port"]
    trace_id = 0x7E57 + (1 if protocol == "grpc" else 0)
    cntl = Controller()
    cntl.trace_id = trace_id
    c = _port_call(srv.listen_endpoint,
                   tsvc.pack_generate_request(prompt, MAX_NEW), protocol,
                   cntl=cntl)
    assert not c.failed, c.error_text
    deadline = time.monotonic() + 5
    spans = []
    while len(spans) < 2 and time.monotonic() < deadline:
        spans = [s.describe() for s in global_span_store().by_trace(
            trace_id)]
        time.sleep(0.02)
    client = [s for s in spans if s["side"] == "client"]
    server = [s for s in spans if s["side"] == "server"]
    assert len(client) == 1 and len(server) == 1, spans
    assert server[0]["parent_span_id"] == client[0]["span_id"]
    assert server[0]["method"] == "LM.Generate"
    assert server[0]["error_code"] == 0
