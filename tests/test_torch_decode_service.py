"""``LM.Decode`` on the port: the contiguous ContinuousBatcher behind the
port's LMService, Server, Channel and streams, on the CPU over loopback.

- counterparts of tests/test_lm_decode.py's Decode cases: streams and
  finishes, join mid-batch and evict, TTFT under load, a stalled client
  evicted with ``backpressure`` without holding the others back, bad
  requests answered with the JAX service's codes and texts;
- counterparts of tests/test_slo_sched.py's contiguous cases: the tier
  registry and the closed event enums, a join resolving its tier,
  chunked prefill emitting the tokens of a whole-prompt prefill, and the
  interactive tier taking the chunk budget first;
- the token stream across the wire both ways (a JAX client on the port's
  server, the port's client on a JAX server), equal to JAX's own Decode;
- the batcher's crash path and its shutdown.

Params: the JAX ``init_params(PRNGKey(0))`` tree through numpy into
``params_from_numpy``.  Prompts are drawn from numpy seeds and kept only
where every greedy pick's top-1 margin clears 0.08, well above the 2e-2
the frameworks' logits may differ by (test_torch_transformer_lm.py), so
the token streams must be equal.
"""

import struct
import threading
import time

import jax
import numpy as np
import pytest
import torch

from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import Controller as JController
from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.server import Server as JServer
from brpc_tpu.server.admission import _MAX_TENANTS as J_MAX_TENANTS
from brpc_tpu import streaming as jstreaming
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import lm_telemetry as tlmt
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.server.admission import _MAX_TENANTS
from brpc_tpu_torch.streaming import StreamOptions, stream_create
from brpc_tpu_torch.utils.convert import params_from_numpy

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)
TIMEOUT = 120.0
MARGIN = 0.08


@pytest.fixture(scope="module")
def params():
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**CFG))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jp, tp


def _solo(tp, prompt, max_new):
    """Greedy tokens of a solo generation, and the smallest top-1 margin."""
    pre, step = tlm.make_decode(tlm.LMConfig(**CFG), device="cpu")
    cache, logits = pre(tp, torch.from_numpy(prompt[None]))
    toks, worst = [], float("inf")
    for _ in range(max_new):
        top2 = torch.topk(logits[0], 2).values
        worst = min(worst, float(top2[0] - top2[1]))
        toks.append(int(torch.argmax(logits[0])))
        cache, logits = step(tp, cache, torch.tensor([toks[-1]]))
    return toks, worst


def _clear_prompt(tp, length, max_new, seed):
    for s in range(seed, seed + 200):
        p = np.random.default_rng(s).integers(0, CFG["vocab"], length,
                                              dtype=np.int32)
        toks, worst = _solo(tp, p, max_new)
        if worst > MARGIN:
            return p, toks
    pytest.fail(f"no clear prompt of length {length} near seed {seed}")


@pytest.fixture(scope="module")
def prompts(params):
    tp = params[1]
    return {"p8": _clear_prompt(tp, 8, 10, 100),
            "p5": _clear_prompt(tp, 5, 4, 400),
            "p17": _clear_prompt(tp, 17, 6, 700),
            "pa": _clear_prompt(tp, 29, 3, 1000),
            "pb": _clear_prompt(tp, 29, 3, 1300)}


def _port_server(tp, slots=4, **kw):
    srv = Server()
    svc = tsvc.LMService(cfg=tlm.LMConfig(**CFG), params=tp, device="cpu",
                         decode_slots=slots, **kw)
    assert srv.add_service(svc, name="LM") == 0
    assert srv.start("127.0.0.1:0") == 0
    return srv, svc


def _stop(srv, svc):
    srv.stop()
    if svc._batcher is not None:
        assert svc._batcher.shutdown()


def _stream_decode(ep, prompt, max_new, client="port"):
    """One streamed Decode session: (tokens, close reason, TTFT s)."""
    toks, closed, first = [], [], []

    def on_received(st, msgs):
        if not first:
            first.append(time.monotonic())
        toks.extend(tsvc.unpack_token(bytes(m)) for m in msgs)

    on_closed = lambda st: closed.append(st.close_reason)  # noqa: E731
    req = tsvc.pack_generate_request(np.asarray(prompt)[None], max_new)
    if client == "port":
        ch, cntl = Channel(), Controller()
        create, opts = stream_create, StreamOptions
    else:
        ch, cntl = JChannel(), JController()
        create, opts = jstreaming.stream_create, jstreaming.StreamOptions
    ch.init(str(ep))
    cntl.timeout_ms = int(TIMEOUT * 1000)
    create(cntl, opts(on_received=on_received, on_closed=on_closed))
    t0 = time.monotonic()
    c = ch.call_method("LM.Decode", req, cntl=cntl)
    assert not c.failed, (c.error_code, c.error_text)
    assert struct.unpack("<I", bytes(c.response)) == (max_new,)
    deadline = time.monotonic() + TIMEOUT
    while not closed and time.monotonic() < deadline:
        time.sleep(0.005)
    assert closed, "decode stream never closed"
    if client == "port":
        ch.close()
    return toks, closed[0], (first[0] - t0 if first else None)


def test_decode_streams_tokens_and_finishes(params, prompts):
    srv, svc = _port_server(params[1])
    try:
        p, want = prompts["p8"]
        toks, reason, ttft = _stream_decode(srv.listen_endpoint, p, 6)
        assert toks == want[:6]
        assert toks == svc._gen(torch.from_numpy(p[None]), 6)[0].tolist()
        assert reason == "finished" and ttft is not None
        stats = svc.batcher().kv_stats()
        assert stats["prefills_run"] == 1 and stats["steps"] == 6
        assert stats["phases"]["decode_round"] >= 6
    finally:
        _stop(srv, svc)


def test_decode_join_mid_batch_and_evict(params, prompts):
    (pa, wa), (pb, wb) = prompts["p8"], prompts["p5"]
    srv, svc = _port_server(params[1], slots=2)
    ep = srv.listen_endpoint
    try:
        res = {}
        t1 = threading.Thread(target=lambda: res.__setitem__(
            "a", _stream_decode(ep, pa, 10)))
        t1.start()
        time.sleep(0.3)          # a is mid-generation; b joins the batch
        res["b"] = _stream_decode(ep, pb, 4)
        t1.join(TIMEOUT)
        assert res["a"][0] == wa and res["b"][0] == wb
        assert res["a"][1] == res["b"][1] == "finished"
        deadline = time.time() + 10
        while svc.batcher().live_slots() and time.time() < deadline:
            time.sleep(0.01)
        assert svc.batcher().live_slots() == 0
        toks, reason, _ = _stream_decode(ep, pb, 3)     # reuses a slot
        assert toks == wb[:3] and reason == "finished"
    finally:
        _stop(srv, svc)


def test_decode_ttft_under_load(params, prompts):
    """Five sessions over two slots: the queued ones get their first token
    once a slot frees, and every session completes correctly."""
    p, want = prompts["p8"]
    srv, svc = _port_server(params[1], slots=2)
    try:
        results = {}

        def one(i):
            results[i] = _stream_decode(srv.listen_endpoint, p, 5)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert sorted(results) == list(range(5))
        for i, (toks, reason, ttft) in results.items():
            assert toks == want[:5], i
            assert reason == "finished"
            assert ttft is not None and ttft < TIMEOUT
    finally:
        _stop(srv, svc)


def test_decode_stalled_client_evicted_not_hol_blocking(params, prompts):
    """A client that stops consuming (a 16-byte window, its handler
    wedged) is evicted with reason 'backpressure' after one bounded stall;
    a healthy session in the same batch completes."""
    p, want = prompts["p8"]
    srv, svc = _port_server(params[1])
    wedge = threading.Event()
    try:
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        stall_closed = []
        cntl = Controller()
        cntl.timeout_ms = int(TIMEOUT * 1000)
        stream_create(cntl, StreamOptions(
            on_received=lambda s, m: wedge.wait(60),
            on_closed=lambda s: stall_closed.append(s.close_reason),
            max_buf_size=16))           # 4 tokens of credit, no acks
        c = ch.call_method("LM.Decode",
                           tsvc.pack_generate_request(p[None], 20),
                           cntl=cntl)
        assert not c.failed, c.error_text
        toks, reason, _ = _stream_decode(srv.listen_endpoint, p, 8)
        assert toks == want[:8] and reason == "finished"
        deadline = time.time() + 60
        while svc.batcher().live_slots() and time.time() < deadline:
            time.sleep(0.02)
        assert svc.batcher().live_slots() == 0
        # once the wedged handler returns, the queued FIN names the reason
        wedge.set()
        deadline = time.time() + 10
        while not stall_closed and time.time() < deadline:
            time.sleep(0.02)
        assert stall_closed == ["backpressure"], stall_closed
        ch.close()
    finally:
        wedge.set()
        _stop(srv, svc)


BAD_DECODES = {
    "truncated": (b"\x01\x00", True),
    "batch_two": (tsvc.pack_generate_request(np.zeros((2, 4)), 4), True),
    "empty": (tsvc.pack_generate_request(np.zeros((1, 0)), 2), True),
    "max_new_zero": (tsvc.pack_generate_request(np.zeros((1, 4)), 0), True),
    "max_new_cap": (tsvc.pack_generate_request(np.zeros((1, 4)), 999),
                    True),
    "over_max_seq": (tsvc.pack_generate_request(np.zeros((1, 30)), 4), True),
    "out_of_vocab": (tsvc.pack_generate_request(np.full((1, 4), 64), 2),
                     True),
    "no_stream": (tsvc.pack_generate_request(np.zeros((1, 4)), 4), False),
}


@pytest.fixture(scope="module")
def both_servers(params):
    tsrv, tsv = _port_server(params[1])
    jsrv = JServer()
    assert jsrv.add_service(jsvc.LMService(cfg=jlm.LMConfig(**CFG),
                                           params=params[0],
                                           decode_slots=4), name="LM") == 0
    assert jsrv.start("127.0.0.1:0") == 0
    yield tsrv, jsrv
    jsrv.stop()
    _stop(tsrv, tsv)


@pytest.mark.parametrize("name", sorted(BAD_DECODES))
def test_bad_decode_requests_match_jax(both_servers, name):
    req, with_stream = BAD_DECODES[name]
    tsrv, jsrv = both_servers
    ch, cntl = Channel(), Controller()
    ch.init(str(tsrv.listen_endpoint))
    cntl.timeout_ms = 30_000
    if with_stream:
        st = stream_create(cntl, StreamOptions())
    got = ch.call_method("LM.Decode", req, cntl=cntl)
    ch.close()
    jch, jcntl = JChannel(), JController()
    jch.init(str(jsrv.listen_endpoint))
    jcntl.timeout_ms = 30_000
    if with_stream:
        jstreaming.stream_create(jcntl, jstreaming.StreamOptions())
    want = jch.call_method("LM.Decode", req, cntl=jcntl)
    assert want.failed and want.error_code == int(Errno.EREQUEST)
    assert got.failed and got.error_code == want.error_code
    assert got.error_text.split(":")[0] == want.error_text.split(":")[0]
    if with_stream:
        assert st.closed            # the failed call closed it


def test_decode_tokens_equal_across_the_wire(both_servers, prompts):
    """A JAX client on the port's server and the port's client on a JAX
    server get the tokens of JAX's own Decode."""
    tsrv, jsrv = both_servers
    for key, max_new in (("p8", 8), ("p17", 6)):
        p, solo = prompts[key]
        want, wreason, _ = _stream_decode(jsrv.listen_endpoint, p, max_new,
                                          client="jax")
        assert want == solo[:max_new] and wreason == "finished"
        for ep, client in ((tsrv.listen_endpoint, "jax"),
                           (jsrv.listen_endpoint, "port"),
                           (tsrv.listen_endpoint, "port")):
            toks, reason, ttft = _stream_decode(ep, p, max_new,
                                                client=client)
            assert toks == want, (key, client)
            assert reason == "finished" and ttft is not None


# -- SLO tiers ----------------------------------------------------------------

SLO_SCHED_PINS = ("sched_chunk_slice", "sched_catchup_slice",
                  "sched_interactive_first", "sched_preempt_batch")


def test_sched_enums_match_jax():
    assert tsvc.SLO_SCHED_EVENTS == jsvc.SLO_SCHED_EVENTS == SLO_SCHED_PINS
    assert set(tsvc.sched_counters()) == set(SLO_SCHED_PINS)
    with pytest.raises(ValueError):
        tsvc.count_sched("sched_some_new_event")
    assert tsvc.SLO_TIERS == jsvc.SLO_TIERS
    from brpc_tpu.models import lm_telemetry as jlmt
    assert tlmt.LM_STEP_PHASES == jlmt.LM_STEP_PHASES
    assert tlmt.LM_SLO_VERDICTS == jlmt.LM_SLO_VERDICTS
    assert [getattr(tlmt, n) for n in dir(tlmt) if n.startswith("PH_")] \
        == [getattr(jlmt, n) for n in dir(tlmt) if n.startswith("PH_")]


def test_tier_registry():
    reg = tsvc.TierRegistry()
    assert reg.tier_of(b"nobody") == "standard"      # default tier
    reg.set_tier(b"alice", "interactive")
    reg.set_tier("bob", "batch")
    # keyed on the normalized TLV-22 identity: bytes and str agree
    assert reg.tier_of("alice") == "interactive"
    assert reg.tier_of(b" bob ") == "batch"
    assert reg.rank_of(b"alice") < reg.rank_of(b"nobody") \
        < reg.rank_of("bob")
    with pytest.raises(ValueError, match="unknown SLO tier"):
        reg.set_tier(b"x", "platinum")
    with pytest.raises(ValueError, match="unknown SLO tier"):
        tsvc.TierRegistry(default="gold")
    assert _MAX_TENANTS == J_MAX_TENANTS
    full = tsvc.TierRegistry()
    for i in range(_MAX_TENANTS):
        full.set_tier(f"t{i}", "batch")
    with pytest.raises(ValueError, match="registry full"):
        full.set_tier("one-too-many", "batch")
    full.set_tier("t0", "interactive")               # updates still land
    reg.set_slo("interactive", ttft_ms=5.0)
    assert reg.slo_of("interactive") == (5.0, None)
    assert reg.slo_of("batch") == (None, None)


def test_join_resolves_tier_from_registry():
    reg = tsvc.TierRegistry()
    reg.set_tier(b"alice", "interactive")
    bat = tsvc.ContinuousBatcher(tlm.LMConfig(**CFG), params=None,
                                 tiers=reg, device="cpu")
    sess = tsvc._Session(None, np.zeros((3,), np.int32), 4)
    assert sess.tier == "standard"
    bat._assign_tier(sess, b"alice")
    assert sess.tier == "interactive" and sess.tier_rank == 0
    bat._assign_tier(sess, b"unknown-tenant")
    assert sess.tier == "standard"


class _FakeStream:
    """The batcher's view of a stream: closed, options, write, close."""

    def __init__(self):
        self.closed = False
        self.close_reason = None
        self.tokens = []
        self.options = StreamOptions()

    def write(self, data):
        self.tokens.append(struct.unpack("<i", bytes(data))[0])
        return 0

    def close(self, reason=None):
        self.closed = True
        self.close_reason = reason


def _finish(*streams, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not all(s.closed for s in streams) \
            and time.monotonic() < deadline:
        time.sleep(0.002)
    assert all(s.closed for s in streams), "decode session never closed"


def test_chunked_prefill_identity_contiguous(params, prompts):
    """A chunk-filled session (context 16 in slices of 4) emits the tokens
    of a whole-prompt prefill."""
    p, want = prompts["p17"]
    before = tsvc.sched_counters()["sched_chunk_slice"]
    bat = tsvc.ContinuousBatcher(tlm.LMConfig(**CFG), params[1], slots=2,
                                 prefill_chunk_tokens=4, device="cpu")
    st = _FakeStream()
    bat.join(st, p, 6)
    _finish(st)
    assert st.tokens == want[:6] and st.close_reason == "finished"
    assert tsvc.sched_counters()["sched_chunk_slice"] - before >= 4
    assert bat.prefills_run == 1
    assert bat.shutdown() and bat._cache is None


def test_interactive_gets_chunk_budget_first(params, prompts):
    """Two long prompts filling together: the interactive join's slices
    outrank the standard one's for the budget (the decision is counted),
    and both streams stay exact."""
    (pa, wa), (pb, wb) = prompts["pa"], prompts["pb"]
    reg = tsvc.TierRegistry()
    reg.set_tier(b"alice", "interactive")
    before = tsvc.sched_counters()["sched_interactive_first"]
    bat = tsvc.ContinuousBatcher(tlm.LMConfig(**CFG), params[1], slots=2,
                                 prefill_chunk_tokens=2, tiers=reg,
                                 device="cpu")
    st_b, st_a = _FakeStream(), _FakeStream()
    bat.join(st_b, pb, 3, tenant=b"bob")
    bat.join(st_a, pa, 3, tenant=b"alice")
    _finish(st_a, st_b)
    assert st_a.tokens == wa and st_b.tokens == wb
    assert tsvc.sched_counters()["sched_interactive_first"] - before >= 1
    assert bat.shutdown()


def test_slo_verdicts_counted_at_close(params, prompts):
    """A targeted tier judges its sessions at close; an untargeted one
    counts slo_untargeted."""
    p, want = prompts["p5"]
    reg = tsvc.TierRegistry()
    reg.set_tier(b"alice", "interactive")
    reg.set_slo("interactive", ttft_ms=60_000.0, itl_ms=60_000.0)
    before = tlmt.slo_counters()
    bat = tsvc.ContinuousBatcher(tlm.LMConfig(**CFG), params[1], slots=2,
                                 tiers=reg, device="cpu")
    st_a, st_n = _FakeStream(), _FakeStream()
    bat.join(st_a, p, 4, tenant=b"alice")
    bat.join(st_n, p, 4, tenant=b"nobody")
    _finish(st_a, st_n)
    assert st_a.tokens == st_n.tokens == want
    after = tlmt.slo_counters()
    assert after[("interactive", "slo_ok")] \
        - before[("interactive", "slo_ok")] == 1
    assert after[("standard", "slo_untargeted")] \
        - before[("standard", "slo_untargeted")] == 1
    assert bat.shutdown()


def test_batcher_crash_closes_sessions_and_recovers(params, prompts):
    """A step that raises closes every session with decode_error and
    drops the pool; the next join builds a fresh engine and serves."""
    p, want = prompts["p5"]
    bat = tsvc.ContinuousBatcher(tlm.LMConfig(**CFG), params[1], slots=2,
                                 device="cpu")
    bat._ensure_engine()
    real_step = bat._step

    def boom(*args):
        raise RuntimeError("device fault")

    bat._step = boom
    sts = [_FakeStream(), _FakeStream()]
    for st in sts:
        bat.join(st, p, 4)
    _finish(*sts)
    assert [st.close_reason for st in sts] == ["decode_error"] * 2
    deadline = time.monotonic() + 10
    while bat._thread is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert bat._cache is None and bat.live_slots() == 0
    bat._step = real_step
    st = _FakeStream()
    bat.join(st, p, 4)
    _finish(st)
    assert st.tokens == want and st.close_reason == "finished"
    assert bat.shutdown()
