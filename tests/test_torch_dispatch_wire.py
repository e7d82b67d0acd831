"""The port's default Server on the event dispatcher against the JAX
one, on the wire: the same tpu_std, HTTP/1.1 and h2/gRPC requests get
byte-equal answers from both (the HTTP ``date`` and ``server`` headers
aside; the h2 answer compared as its decoded headers and body), several
requests in one write included, and the LM's Generate tokens over each
protocol equal the JAX server's.  The LM is a 2-layer narrow one from
the reference's ``init_params``, converted through numpy."""

import socket
import struct

import jax
import numpy as np
import pytest
import torch

from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.protocol.h2_rpc import GRPC_CT, pack_grpc_message
from brpc_tpu_torch.protocol.h2_session import H2Session
from brpc_tpu_torch.protocol.meta import RpcMeta
from brpc_tpu_torch.protocol.tpu_std import pack_frame, unpack_frame
from brpc_tpu_torch.server import Server, Service
from brpc_tpu_torch.utils.convert import params_from_numpy

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)
MAX_NEW = 4


class _Echo:
    def Echo(self, cntl, request):
        return b"echo:" + bytes(request)

    def Fail(self, cntl, request):
        cntl.set_failed(1003, "bad " + bytes(request).decode())
        return None


class TEcho(Service, _Echo):
    pass


class JEcho(JService, _Echo):
    pass


@pytest.fixture(scope="module")
def params():
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**CFG))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def servers(params):
    port, jaxs = Server(), JServer()
    assert port.add_service(tsvc.LMService(
        cfg=tlm.LMConfig(**CFG), params=params[1], device="cpu"),
        name="LM") == 0
    assert jaxs.add_service(jsvc.LMService(
        cfg=jlm.LMConfig(**CFG), params=params[0]), name="LM") == 0
    assert port.add_service(TEcho(), name="E") == 0
    assert jaxs.add_service(JEcho(), name="E") == 0
    for srv in (port, jaxs):
        assert srv.start("127.0.0.1:0") == 0
    yield {"port": port, "jax": jaxs}
    for srv in (port, jaxs):
        srv.stop()


@pytest.fixture(scope="module")
def prompt(params):
    """A prompt whose greedy picks all clear the frameworks' logit
    difference by a wide margin (as ``test_torch_lm_protocols.py``)."""
    cfg = tlm.LMConfig(**CFG)
    pre, step = tlm.make_decode(cfg, device="cpu")
    for seed in range(60):
        ids = np.random.default_rng(300 + seed).integers(
            0, CFG["vocab"], (1, 6), dtype=np.int32)
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
    pytest.fail("no prompt with clear margins")


def _frame(cid: int, service: str, method: str, payload: bytes) -> bytes:
    meta = RpcMeta()
    meta.correlation_id = cid
    meta.service_name, meta.method_name = service, method
    return pack_frame(meta, payload)


def _read_frames(c, n: int) -> dict:
    """``n`` whole tpu_std answers off ``c``, by correlation id."""
    buf, out = b"", {}
    while len(out) < n:
        while len(buf) >= 12:
            (body,) = struct.unpack_from("<I", buf, 4)
            if len(buf) < 12 + body:
                break
            raw, buf = buf[:12 + body], buf[12 + body:]
            out[unpack_frame(raw)[0].correlation_id] = raw
        if len(out) < n:
            chunk = c.recv(65536)
            assert chunk, "the server closed the connection"
            buf += chunk
    return out


def _tpu_std(ep, frames) -> dict:
    with socket.create_connection((ep.host, ep.port), timeout=60) as c:
        c.sendall(b"".join(frames))       # one write: one gulp or more
        return _read_frames(c, len(frames))


def test_tpu_std_answers_equal_the_jax_servers(servers):
    frames = [_frame(1, "E", "Echo", b"a"), _frame(2, "E", "Fail", b"x"),
              _frame(3, "E", "Nope", b""), _frame(4, "Nope", "M", b""),
              _frame(5, "E", "Echo", bytes(range(256)) * 64)]
    got = {w: _tpu_std(srv.listen_endpoint, frames)
           for w, srv in servers.items()}
    assert got["port"] == got["jax"]
    assert unpack_frame(got["port"][1])[1] == b"echo:a"
    assert unpack_frame(got["port"][2])[0].error_code == 1003


def _http(ep, request: bytes) -> bytes:
    with socket.create_connection((ep.host, ep.port), timeout=60) as c:
        c.sendall(request)
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += c.recv(65536)
        head, _, body = buf.partition(b"\r\n\r\n")
        n = next(int(ln.split(b":")[1]) for ln in head.split(b"\r\n")
                 if ln.lower().startswith(b"content-length"))
        while len(body) < n:
            body += c.recv(65536)
    lines = [ln for ln in head.split(b"\r\n")
             if not ln.lower().startswith((b"date:", b"server:"))]
    return b"\r\n".join(lines) + b"\r\n\r\n" + body


@pytest.mark.parametrize("request_", [
    b"POST /E/Echo HTTP/1.1\r\nHost: x\r\nContent-Length: 3\r\n\r\nabc",
    b"POST /E/Fail HTTP/1.1\r\nHost: x\r\nContent-Length: 1\r\n\r\nz",
    b"POST /E/Nope HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n",
    b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n"],
    ids=["echo", "fail", "no-method", "health"])
def test_http_answers_equal_the_jax_servers(servers, request_):
    got = {w: _http(srv.listen_endpoint, request_)
           for w, srv in servers.items()}
    assert got["port"] == got["jax"]


def _grpc(ep, path: str, payload: bytes):
    """One unary gRPC call over a fresh h2c connection: its decoded
    response headers (in order) and body bytes."""
    sess = H2Session(is_server=False)
    sess.start()
    sid = sess.next_stream_id()
    sess.send_headers(sid, [(":method", "POST"), (":scheme", "http"),
                            (":path", path), (":authority", "x"),
                            ("content-type", GRPC_CT), ("te", "trailers")])
    sess.send_data(sid, pack_grpc_message(payload), end_stream=True)
    headers, body = [], b""
    with socket.create_connection((ep.host, ep.port), timeout=60) as c:
        c.sendall(sess.take_output())
        done = False
        while not done:
            data = c.recv(65536)
            assert data, "h2 connection closed early"
            for ev in sess.feed(data):
                if ev[0] in ("headers", "data") and ev[1] == sid:
                    if ev[0] == "headers":
                        headers += ev[2]
                    else:
                        body += bytes(ev[2])
                    done = done or ev[3]
            out = sess.take_output()
            if out:
                c.sendall(out)
    return headers, body


@pytest.mark.parametrize("path,payload", [("/E/Echo", b"h2"),
                                          ("/E/Fail", b"q"),
                                          ("/E/Nope", b"")],
                         ids=["echo", "fail", "no-method"])
def test_h2_answers_equal_the_jax_servers(servers, path, payload):
    got = {w: _grpc(srv.listen_endpoint, path, payload)
           for w, srv in servers.items()}
    assert got["port"] == got["jax"]


def test_generate_tokens_equal_the_jax_servers_on_every_protocol(
        servers, prompt):
    """LM.Generate over tpu_std (two requests in one write), HTTP/1.1 and
    gRPC: the same tokens from both servers."""
    req = tsvc.pack_generate_request(prompt, MAX_NEW)
    outs = {}
    for w, srv in servers.items():
        ep = srv.listen_endpoint
        raw = _tpu_std(ep, [_frame(7, "LM", "Generate", req),
                            _frame(8, "LM", "Generate", req)])
        http_body = _http(ep, b"POST /LM/Generate HTTP/1.1\r\nHost: x\r\n"
                          b"Content-Length: %d\r\n\r\n" % len(req) + req)
        _, grpc_body = _grpc(ep, "/LM/Generate", req)
        outs[w] = (unpack_frame(raw[7])[1], unpack_frame(raw[8])[1],
                   http_body.partition(b"\r\n\r\n")[2], grpc_body[5:])
    assert outs["port"] == outs["jax"]
    ids = tsvc.unpack_generated(outs["port"][0])
    assert ids.shape == (1, MAX_NEW)
    assert len(set(outs["port"])) == 1
