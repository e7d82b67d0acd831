"""The port's RPC path and LM service, on the CPU over loopback.

- the port's RpcMeta / tpu_std frames are byte-identical to the JAX
  package's, both ways;
- the port's Server + LMService + Channel answer Generate and Info and
  reject bad requests with the JAX service's error codes;
- cross-wire: the JAX Channel calls the port's Server, and the port's
  Channel calls a JAX Server running the JAX LMService with the same
  params; the greedy tokens agree both ways (on a prompt whose top-1
  margins are clear of the frameworks' logit difference, see
  test_torch_transformer_lm.py).
"""

import contextlib
import json
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from brpc_tpu.butil.iobuf import IOBuf
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import Controller as JController
from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.protocol import meta as jmeta
from brpc_tpu.protocol import tpu_std as jstd
from brpc_tpu.server import Server as JServer
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, Controller, RpcError
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.protocol import meta as tmeta
from brpc_tpu_torch.protocol import tpu_std as tstd
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.utils.convert import params_from_numpy

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)
TIMEOUT_MS = 60_000


def _full_meta(mod):
    m = mod.RpcMeta()
    m.correlation_id = 2 ** 40 + 7
    m.compress_type = 1
    m.attachment_size = 3
    m.service_name, m.method_name = "LM", "Generate"
    m.error_code, m.error_text = -5, "bad é"
    m.auth_data = b"\x00key"
    m.trace_id, m.span_id, m.parent_span_id = 11, 12, 13
    m.stream_id, m.timeout_ms, m.stream_window = 14, 15, 16
    m.ici_domain, m.ici_desc, m.ici_conn = b"d", b"e", b"f"
    m.shm_offer, m.shm_accept, m.shm_release, m.shm_desc = (
        b"g", b"h", b"i", b"j")
    m.tenant, m.lame_duck = b"team", 1
    return m


def test_meta_bytes_identical_both_ways():
    jb, tb = _full_meta(jmeta).encode(), _full_meta(tmeta).encode()
    assert jb == tb
    back = tmeta.RpcMeta.decode(jb)
    assert back.encode() == jb and back.timeout_present
    assert jmeta.RpcMeta.decode(tb).encode() == tb
    # unknown tags are skipped by both
    extra = tb + bytes([99]) + (2).to_bytes(4, "little") + b"zz"
    assert tmeta.RpcMeta.decode(extra).encode() == tb
    assert tmeta.RpcMeta.decode(tb[:-1]) is None


def test_frames_identical_both_ways():
    for att in (b"", b"tail"):
        m_j, m_t = jmeta.RpcMeta(), tmeta.RpcMeta()
        for m in (m_j, m_t):
            m.correlation_id, m.service_name, m.method_name = 9, "LM", "Info"
        jf = jstd.pack_frame(m_j, IOBuf(b"payload"),
                             attachment=IOBuf(att) if att else None)
        tf = tstd.pack_frame(m_t, b"payload", att)
        assert jf.to_bytes() == tf
        meta, payload, got_att = tstd.unpack_frame(tf)
        assert (meta.method_name, payload, got_att) == ("Info", b"payload",
                                                        att)
    with pytest.raises(tstd.FrameError):
        tstd.unpack_frame(b"HTTP" + tf[4:])


@pytest.fixture(scope="module")
def params():
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**CFG))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def port_server(params):
    srv = Server()
    svc = tsvc.LMService(cfg=tlm.LMConfig(**CFG), params=params[1],
                         device="cpu")
    assert srv.add_service(svc, name="LM") == 0
    assert srv.start("127.0.0.1:0") == 0
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def jax_server(params):
    srv = JServer()
    assert srv.add_service(jsvc.LMService(cfg=jlm.LMConfig(**CFG),
                                          params=params[0]), name="LM") == 0
    assert srv.start("127.0.0.1:0") == 0
    yield srv
    srv.stop()


def _port_call(ep, req, method="LM.Generate"):
    ch = Channel()
    assert ch.init(str(ep)) == 0
    cntl = Controller()
    cntl.timeout_ms = TIMEOUT_MS
    try:
        return ch.call_method(method, req, cntl=cntl)
    finally:
        ch.close()


def _jax_call(ep, req, method="LM.Generate"):
    ch = JChannel()
    assert ch.init(str(ep)) == 0
    cntl = JController()
    cntl.timeout_ms = TIMEOUT_MS
    return ch.call_method(method, req, cntl=cntl)


def _clear_prompt(tp, max_new):
    """A prompt whose greedy picks all have a top-1 margin well above
    the frameworks' logit difference (2e-2)."""
    cfg = tlm.LMConfig(**CFG)
    pre, step = tlm.make_decode(cfg, device="cpu")
    for seed in range(60):
        ids = np.random.default_rng(200 + seed).integers(
            0, CFG["vocab"], (2, 6), dtype=np.int32)
        cache, logits = pre(tp, torch.from_numpy(ids))
        ok = True
        for i in range(max_new):
            top2 = torch.topk(logits, 2, dim=-1).values
            if (top2[:, 0] - top2[:, 1]).min() <= 0.08:
                ok = False
                break
            if i < max_new - 1:
                cache, logits = step(tp, cache, torch.argmax(logits, -1))
        if ok:
            return ids
    pytest.fail("no prompt with clear top-1 margins among 60 seeds")


def test_generate_and_info(port_server, params):
    ep = port_server.listen_endpoint
    prompt = np.arange(10, dtype=np.int32).reshape(2, 5) % CFG["vocab"]
    c = _port_call(ep, tsvc.pack_generate_request(prompt, 5))
    assert not c.failed, c.error_text
    out = tsvc.unpack_generated(c.response)
    assert out.shape == (2, 5) and out.dtype == np.int32
    assert out.min() >= 0 and out.max() < CFG["vocab"]
    # the service's bucketed run (8 steps, sliced to 5) equals a plain
    # 5-token generation: greedy decoding is prefix-stable
    gen = tlm.make_scan_generator(tlm.LMConfig(**CFG), params[1], "cpu")
    np.testing.assert_array_equal(out, gen(torch.from_numpy(prompt),
                                           5).numpy())
    ch = Channel()
    ch.init(str(ep))
    info = json.loads(ch.call("LM.Info", b"", timeout_ms=TIMEOUT_MS))
    ch.close()
    assert info == {"vocab": 64, "dim": 32, "heads": 4, "depth": 2,
                    "max_seq": 32, "quantized": False,
                    "param_bytes": info["param_bytes"]}
    assert info["param_bytes"] == 4 * sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params[0]))


BAD_REQUESTS = {
    "truncated": b"\x01\x00",
    "short_ids": tsvc.pack_generate_request(np.zeros((1, 4)), 2)[:-4],
    "empty": tsvc.pack_generate_request(np.zeros((1, 0)), 2),
    "max_new_zero": tsvc.pack_generate_request(np.zeros((1, 4)), 0),
    "max_new_cap": tsvc.pack_generate_request(np.zeros((1, 4)), 129),
    "over_max_seq": tsvc.pack_generate_request(np.zeros((1, 30)), 4),
    "out_of_vocab": tsvc.pack_generate_request(np.full((1, 4), 64), 2),
    "negative_id": tsvc.pack_generate_request(np.full((1, 4), -1), 2),
}


@pytest.mark.parametrize("name", sorted(BAD_REQUESTS))
def test_bad_requests_match_jax(port_server, jax_server, name):
    req = BAD_REQUESTS[name]
    got = _port_call(port_server.listen_endpoint, req)
    want = _jax_call(jax_server.listen_endpoint, req)
    assert want.failed and want.error_code == int(Errno.EREQUEST)
    assert got.failed and got.error_code == want.error_code
    assert got.error_text.split(":")[0] == want.error_text.split(":")[0]


def test_unknown_service_and_method(port_server):
    ch = Channel()
    ch.init(str(port_server.listen_endpoint))
    with pytest.raises(RpcError) as e:
        ch.call("LM.Nope", b"", timeout_ms=TIMEOUT_MS)
    assert e.value.code == Errno.ENOMETHOD
    with pytest.raises(RpcError) as e:
        ch.call("Nope.Info", b"", timeout_ms=TIMEOUT_MS)
    assert e.value.code == Errno.ENOSERVICE
    # the connection survives error answers
    assert json.loads(ch.call("LM.Info", b"", timeout_ms=TIMEOUT_MS))
    ch.close()


def test_channel_connection_failure():
    ch = Channel()
    ch.init("127.0.0.1:1")
    c = ch.call_method("LM.Info", b"")
    assert c.failed and c.error_code == Errno.EFAILEDSOCKET


def test_cross_wire_tokens_equal(port_server, jax_server, params):
    max_new = 4
    ids = _clear_prompt(params[1], max_new)
    req = tsvc.pack_generate_request(ids, max_new)
    jax_to_port = _jax_call(port_server.listen_endpoint, req)
    port_to_jax = _port_call(jax_server.listen_endpoint, req)
    assert not jax_to_port.failed, jax_to_port.error_text
    assert not port_to_jax.failed, port_to_jax.error_text
    a = jsvc.unpack_generated(jax_to_port.response)
    b = tsvc.unpack_generated(port_to_jax.response)
    assert a.shape == (2, max_new)
    np.testing.assert_array_equal(a, b)
    info = _jax_call(port_server.listen_endpoint, b"", "LM.Info")
    assert json.loads(info.response)["vocab"] == CFG["vocab"]


class _Faulty:
    def Boom(self, cntl, request):
        raise RuntimeError("boom")

    def NotBytes(self, cntl, request):
        return 3

    def Echo(self, cntl, request):
        return request + cntl.request_attachment


def test_method_failures_answer_einternal():
    srv = Server()
    assert srv.add_service(_Faulty(), name="F") == 0
    assert srv.add_service(_Faulty(), name="F") == -1
    assert srv.start("127.0.0.1:0") == 0
    try:
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        for method, text in (("F.Boom", "RuntimeError: boom"),
                             ("F.NotBytes", "response serialization")):
            with pytest.raises(RpcError) as e:
                ch.call(method, b"", timeout_ms=TIMEOUT_MS)
            assert e.value.code == Errno.EINTERNAL
            assert e.value.text.startswith(text)
        assert ch.call("F.Echo", b"abc", timeout_ms=TIMEOUT_MS) == b"abc"
        with pytest.raises(RpcError) as e:
            ch.call("F.Echo", 3, timeout_ms=TIMEOUT_MS)
        assert e.value.code == Errno.EREQUEST
        ch.close()
        # a JAX client's attachment reaches the port's handler
        jcntl = JController()
        jcntl.timeout_ms = TIMEOUT_MS
        jch = JChannel()
        jch.init(str(srv.listen_endpoint))
        c = jch.call_method("F.Echo", b"ab", cntl=jcntl, attachment=b"cd")
        assert not c.failed, c.error_text
        assert bytes(c.response) == b"abcd"
    finally:
        srv.stop()
    assert srv.listen_endpoint is None


def test_generate_loop_runs_at_a_short_switch_interval():
    """Generate's launch loop holds the interpreter lock between
    launches, so it runs with the switch interval cut to
    ``_LAUNCH_LOOP_SWITCH_S``; the interval is back after the call."""
    svc = tsvc.LMService(cfg=tlm.LMConfig(**CFG), device="cpu")
    gen, seen = svc._gen, []

    def spy(ids, n):
        seen.append(sys.getswitchinterval())
        return gen(ids, n)

    svc._gen = spy
    before = sys.getswitchinterval()
    prompt = np.arange(6, dtype=np.int32).reshape(1, 6)
    out = svc.Generate(Controller(),
                       tsvc.pack_generate_request(prompt, 3))
    assert tsvc.unpack_generated(out).shape == (1, 3)
    assert seen == [pytest.approx(min(before, tsvc._LAUNCH_LOOP_SWITCH_S))]
    assert sys.getswitchinterval() == before


def test_short_switch_interval_overlaps_and_keeps_a_later_change():
    before = sys.getswitchinterval()
    short = min(before, tsvc._LAUNCH_LOOP_SWITCH_S)
    a, b = tsvc._short_switch_interval(), tsvc._short_switch_interval()
    a.__enter__()
    b.__enter__()
    a.__exit__(None, None, None)
    assert sys.getswitchinterval() == pytest.approx(short)
    b.__exit__(None, None, None)
    assert sys.getswitchinterval() == before
    try:
        with tsvc._short_switch_interval():
            sys.setswitchinterval(0.001)
        assert sys.getswitchinterval() == pytest.approx(0.001)
    finally:
        sys.setswitchinterval(before)


def test_a_thread_beside_a_lock_holding_loop_waits_less():
    """A thread that wakes beside a loop holding the interpreter lock
    waits about a switch interval for it: less inside the context."""
    def lateness(short: bool) -> float:
        stop = threading.Event()

        def hog():
            ctx = tsvc._short_switch_interval() if short \
                else contextlib.nullcontext()
            with ctx:
                x = 0
                while not stop.is_set():
                    x += 1

        t = threading.Thread(target=hog)
        t.start()
        late = []
        try:
            time.sleep(0.02)
            for _ in range(20):
                t0 = time.perf_counter()
                time.sleep(0.002)
                late.append(time.perf_counter() - t0 - 0.002)
        finally:
            stop.set()
            t.join()
        return sorted(late)[len(late) // 2]

    plain, short = lateness(False), lateness(True)
    assert short < plain / 2, (short, plain)
