"""The LM on the port's native engine: ``LM.Generate`` on the kind-3 slim
lane and ``LM.Decode`` streams on the kind-5 lane, against the JAX
package's LMService on the same numpy params, on the CPU.

- Generate gives the JAX service's tokens on the port's Python
  transport, on the engine with ``usercode_inline`` off (the classic
  lane on a fiber) and on the kind-3 lane.
- Decode gives the JAX service's tokens on the Python transport, on the
  engine's kind-5 lane (the batcher writes a round in one
  ``stream_write_many`` per engine) and on the engine with the stream
  lane flag off (the Python stream lane over the engine's connection).
- A stalled kind-5 session is evicted with ``backpressure`` while the
  rest of the batch goes on; a drain of a native paged server during
  streams closes them ``lame_duck`` and leaves no page held.
- ``ContinuousBatcher._emit`` groups native-lane sessions by engine
  (statuses -1 and -2 evict as ``backpressure`` and gone, a spec round's
  second failure evicts nothing twice) and writes Python-lane sessions
  one by one; ``Stream.write`` on the native lane maps the engine's
  statuses, and a close unregisters the stream from the engine.

Params: the JAX ``init_params(PRNGKey(0))`` tree through numpy into
``params_from_numpy``; prompts are kept only where every greedy pick's
top-1 margin clears 0.08 (the frameworks' logits may differ by 2e-2),
so the token streams must be equal.
"""

import struct
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from brpc_tpu import streaming as jstreaming
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import Controller as JController
from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.server import Server as JServer
from brpc_tpu_torch import native
from brpc_tpu_torch.butil.flags import set_flag
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.server import Server, ServerOptions
from brpc_tpu_torch.streaming import Stream, StreamOptions, stream_create
from brpc_tpu_torch.utils.convert import params_from_numpy

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)
TIMEOUT = 60.0
MARGIN = 0.08


def _engine_or_skip():
    if native.load() is None:
        pytest.skip("native engine unavailable (no toolchain)")


@pytest.fixture(scope="module")
def params():
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**CFG))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jp, tp


def _clear_prompt(tp, shape, max_new, seed):
    pre, step = tlm.make_decode(tlm.LMConfig(**CFG), device="cpu")
    for s in range(seed, seed + 200):
        p = np.random.default_rng(s).integers(0, CFG["vocab"], shape,
                                              dtype=np.int32)
        cache, logits = pre(tp, torch.from_numpy(p))
        ok = True
        for i in range(max_new):
            top2 = torch.topk(logits, 2, dim=-1).values
            if (top2[:, 0] - top2[:, 1]).min() <= MARGIN:
                ok = False
                break
            cache, logits = step(tp, cache, torch.argmax(logits, -1))
        if ok:
            return p
    pytest.fail(f"no clear prompt of shape {shape} near seed {seed}")


@pytest.fixture(scope="module")
def prompts(params):
    tp = params[1]
    return {"gen": _clear_prompt(tp, (2, 6), 4, 200),
            "a": _clear_prompt(tp, (1, 8), 8, 100)[0],
            "b": _clear_prompt(tp, (1, 5), 5, 400)[0]}


def _decode(ep, prompt, max_new, client="port", window=None, wedge=None):
    """One Decode session: (tokens, close reason)."""
    toks, closed = [], []

    def on_received(st, msgs):
        if wedge is not None:
            wedge.wait(60)
        toks.extend(tsvc.unpack_token(bytes(m)) for m in msgs)

    on_closed = lambda st: closed.append(st.close_reason)  # noqa: E731
    if client == "port":
        ch, cntl = Channel(), Controller()
        opts = StreamOptions(on_received=on_received, on_closed=on_closed)
        if window:
            opts.max_buf_size = window
        stream_create(cntl, opts)
    else:
        ch, cntl = JChannel(), JController()
        jstreaming.stream_create(cntl, jstreaming.StreamOptions(
            on_received=on_received, on_closed=on_closed))
    ch.init(str(ep))
    cntl.timeout_ms = int(TIMEOUT * 1000)
    c = ch.call_method("LM.Decode", tsvc.pack_generate_request(
        np.asarray(prompt)[None], max_new), cntl=cntl)
    assert not c.failed, (c.error_code, c.error_text)
    return ch, toks, closed


def _wait_closed(closed, timeout=TIMEOUT):
    deadline = time.time() + timeout
    while not closed and time.time() < deadline:
        time.sleep(0.01)
    assert closed, "a stream never closed"


@pytest.fixture(scope="module")
def jax_ref(params, prompts):
    """The JAX service's Generate and Decode tokens on the same params."""
    srv = JServer()
    assert srv.add_service(jsvc.LMService(cfg=jlm.LMConfig(**CFG),
                                          params=params[0]),
                           name="LM") == 0
    assert srv.start("127.0.0.1:0") == 0
    try:
        ch, cntl = JChannel(), JController()
        ch.init(str(srv.listen_endpoint))
        cntl.timeout_ms = int(TIMEOUT * 1000)
        c = ch.call_method("LM.Generate", tsvc.pack_generate_request(
            prompts["gen"], 4), cntl=cntl)
        assert not c.failed, c.error_text
        gen = tsvc.unpack_generated(bytes(c.response)).tolist()
        dec = {}
        for k, n in (("a", 8), ("b", 5)):
            _, toks, closed = _decode(srv.listen_endpoint, prompts[k], n,
                                      client="jax")
            _wait_closed(closed)
            assert closed == ["finished"]
            dec[k] = toks
        return gen, dec
    finally:
        srv.stop()


def _serve(tp, lane: str, **kw):
    opts = ServerOptions()
    if lane != "python":
        opts.native = True
        opts.usercode_inline = lane != "native-fiber"
    srv = Server(opts)
    svc = tsvc.LMService(cfg=tlm.LMConfig(**CFG), params=tp, device="cpu",
                         decode_slots=4, **kw)
    assert srv.add_service(svc, name="LM") == 0
    assert srv.start("127.0.0.1:0") == 0
    assert (srv._native_bridge is not None) == (lane != "python")
    return srv, svc


def _stop(srv, svc):
    srv.stop()
    if svc._batcher is not None:
        assert svc._batcher.shutdown()


def _lanes(srv):
    t = srv._native_bridge.engine.telemetry()
    return {k: v["handled"] for k, v in t["lanes"].items()}, t["streams"]


@pytest.mark.parametrize("lane", ["python", "native-fiber",
                                  "native-inline"])
def test_generate_tokens_equal_jax(params, prompts, jax_ref, lane):
    _engine_or_skip()
    srv, svc = _serve(params[1], lane)
    try:
        before = _lanes(srv)[0] if lane != "python" else None
        ch, cntl = Channel(), Controller()
        ch.init(str(srv.listen_endpoint))
        cntl.timeout_ms = int(TIMEOUT * 1000)
        c = ch.call_method("LM.Generate", tsvc.pack_generate_request(
            prompts["gen"], 4), cntl=cntl)
        ch.close()
        assert not c.failed, c.error_text
        assert tsvc.unpack_generated(bytes(c.response)).tolist() \
            == jax_ref[0]
        if before is not None:
            slim = _lanes(srv)[0]["slim"] - before["slim"]
            assert slim == (1 if lane == "native-inline" else 0)
    finally:
        _stop(srv, svc)


@pytest.mark.parametrize("lane", ["python", "kind5", "kind5-flag-off"])
def test_decode_tokens_equal_jax(params, prompts, jax_ref, lane):
    """Two sessions in one batch; on kind 5 the batcher's rounds go out
    through ``stream_write_many``."""
    _engine_or_skip()
    srv, svc = _serve(params[1], "python" if lane == "python"
                      else "native-inline")
    set_flag("rpc_native_stream_lane", lane != "kind5-flag-off")
    try:
        before = _lanes(srv) if lane != "python" else None
        a = _decode(srv.listen_endpoint, prompts["a"], 8)
        b = _decode(srv.listen_endpoint, prompts["b"], 5)
        for ch, toks, closed in (a, b):
            _wait_closed(closed)
            ch.close()
            assert closed == ["finished"]
        assert a[1] == jax_ref[1]["a"] and b[1] == jax_ref[1]["b"]
        if before is not None:
            lanes, streams = _lanes(srv)
            opens = lanes["stream"] - before[0]["stream"]
            batches = streams["write_batches"] - before[1]["write_batches"]
            chunks = streams["chunks_out"] - before[1]["chunks_out"]
            if lane == "kind5":
                assert opens == 2 and chunks == 13 and 0 < batches <= 13
            else:
                assert opens == 0 and chunks == 0 and batches == 0
    finally:
        set_flag("rpc_native_stream_lane", True)
        _stop(srv, svc)


def test_stalled_kind5_session_evicted_with_backpressure(params, prompts,
                                                         jax_ref):
    """A client that stops consuming (a 16-byte window, its handler
    wedged) is evicted with ``backpressure`` after the engine's credit
    wait; the other session of the batch completes with JAX's tokens."""
    _engine_or_skip()
    srv, svc = _serve(params[1], "native-inline")
    wedge = threading.Event()
    try:
        before = _lanes(srv)[0]["stream"]
        stalled = _decode(srv.listen_endpoint, prompts["a"], 20,
                          window=16, wedge=wedge)
        healthy = _decode(srv.listen_endpoint, prompts["b"], 5)
        _wait_closed(healthy[2])
        assert healthy[2] == ["finished"]
        assert healthy[1] == jax_ref[1]["b"]
        deadline = time.time() + TIMEOUT
        while svc.batcher().live_slots() and time.time() < deadline:
            time.sleep(0.02)
        assert svc.batcher().live_slots() == 0
        wedge.set()
        _wait_closed(stalled[2], 10)
        assert stalled[2] == ["backpressure"]
        assert _lanes(srv)[0]["stream"] - before == 2
        for ch, _, _ in (stalled, healthy):
            ch.close()
    finally:
        wedge.set()
        _stop(srv, svc)


def test_native_drain_during_streams_leaves_no_pages(params, prompts):
    _engine_or_skip()
    srv, svc = _serve(params[1], "native-inline", paged=True, page=8)
    slow = threading.Event()
    batcher = svc.batcher()
    emit = batcher._emit

    def slowed(pairs):
        slow.wait(0.05)
        return emit(pairs)

    batcher._emit = slowed
    try:
        sessions = [_decode(srv.listen_endpoint, prompts[k], 20)
                    for k in ("a", "b")]
        deadline = time.time() + TIMEOUT
        while not all(s[1] for s in sessions) and time.time() < deadline:
            time.sleep(0.01)
        assert srv.drain(5000) == 0
        for ch, toks, closed in sessions:
            _wait_closed(closed, 10)
            assert closed == ["lame_duck"] and 0 < len(toks) < 20
            ch.close()
        deadline = time.time() + 10
        while batcher.kv_stats()["alloc"]["in_use"] \
                - batcher.kv_stats().get("prefix", {}).get("nodes", 0) \
                and time.time() < deadline:
            time.sleep(0.01)
        st = batcher.kv_stats()
        assert st["alloc"]["in_use"] - st.get("prefix", {}).get(
            "nodes", 0) == 0
    finally:
        _stop(srv, svc)


class _FakeEngine:
    def __init__(self, statuses):
        self.statuses = list(statuses)
        self.calls = []

    def stream_write_many(self, items, timeout_ms):
        self.calls.append((list(items), timeout_ms))
        return [self.statuses.pop(0) for _ in items]


class _FakeStream:
    _ids = iter(range(100, 1000))

    def __init__(self, engine=None, rc=0):
        self.id = next(self._ids)
        self._native_tx = engine
        self.closed = False
        self.options = types.SimpleNamespace(write_timeout_s=30.0)
        self.rc, self.writes = rc, []

    def write(self, data):
        self.writes.append((data, self.options.write_timeout_s))
        return self.rc


def _sess(stream):
    return types.SimpleNamespace(stream=stream)


def _emit(pairs):
    return tsvc.ContinuousBatcher._emit(
        types.SimpleNamespace(EMIT_TIMEOUT_MS=200), pairs)


def test_emit_groups_native_sessions_per_engine():
    a = _FakeEngine([0, -1, -2])
    b = _FakeEngine([0])
    s1, s2, s3 = (_sess(_FakeStream(a)) for _ in range(3))
    s4 = _sess(_FakeStream(b))
    py = _sess(_FakeStream(None))
    py_full = _sess(_FakeStream(None, rc=int(Errno.EOVERCROWDED)))
    gone = _sess(_FakeStream(a))
    gone.stream.closed = True
    dead = _emit([(s1, 1), (py, 2), (s2, 3), (s4, 4), (s3, 5),
                  (py_full, 6), (gone, 7)])
    assert len(a.calls) == 1 and len(b.calls) == 1
    assert a.calls[0] == ([(s1.stream.id, struct.pack("<i", 1)),
                           (s2.stream.id, struct.pack("<i", 3)),
                           (s3.stream.id, struct.pack("<i", 5))], 200)
    assert b.calls[0][0] == [(s4.stream.id, struct.pack("<i", 4))]
    assert py.stream.writes == [(struct.pack("<i", 2), 0.2)]
    assert py.stream.options.write_timeout_s == 30.0
    assert {(id(s), r) for s, r in dead} == {
        (id(s2), "backpressure"), (id(s3), None),
        (id(py_full), "backpressure"), (id(gone), None)}


def test_emit_spec_round_evicts_a_session_once():
    """A spec round hands a session several tokens: on the native lane
    they ride one group; two failures evict it once."""
    eng = _FakeEngine([-1, -1, 0])
    s, other = _sess(_FakeStream(eng)), _sess(_FakeStream(eng))
    dead = _emit([(s, 1), (s, 2), (other, 3)])
    assert len(eng.calls) == 1 and len(eng.calls[0][0]) == 3
    assert [(id(x), r) for x, r in dead] == [(id(s), "backpressure")]


@pytest.mark.parametrize("status,want,closed", [
    (0, 0, False), (-1, int(Errno.EOVERCROWDED), False),
    (-2, int(Errno.EEOF), True)], ids=["queued", "credit", "gone"])
def test_stream_write_on_the_native_lane(status, want, closed):
    class Eng:
        def __init__(self):
            self.writes, self.unregistered = [], []

        def stream_write(self, sid, data, timeout_ms):
            self.writes.append((sid, data, timeout_ms))
            return status

        def stream_unregister(self, sid):
            self.unregistered.append(sid)

    eng = Eng()
    s = Stream(StreamOptions(write_timeout_s=0.5))
    s._established.set()
    s._native_tx = eng
    assert s.write(b"tok") == want
    assert eng.writes == [(s.id, b"tok", 500)]
    assert s.closed == closed
    if not closed:
        s.close()
    # the close takes the stream off the engine's lane first
    assert eng.unregistered == [s.id] and s._native_tx is None
