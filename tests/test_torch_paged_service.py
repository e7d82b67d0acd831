"""``LM.Decode`` through a paged ``LMService`` on the port, on the CPU over
loopback: the port's Server, streams and Channel in front of the paged
ContinuousBatcher (with its prefix cache, a host tier, and speculative
decoding).

- a port client and a JAX client on the port's paged server, and the
  port's client on a JAX paged server, all get the tokens of JAX's own
  paged Decode;
- a session live on a pool too small for it and a second join spills to
  the host tier and resumes, both streams ending ``finished`` with their
  solo tokens; without a host tier the second join closes
  ``kv_pool_exhausted``;
- a re-sent prompt is a full prefix hit (no second prefill);
- a spec-decoding service (``spec_decode_k=3``, the target as its draft)
  streams the same tokens.

Params: the JAX ``init_params(PRNGKey(0))`` tree through numpy into
``params_from_numpy``.  Prompts are kept only where every greedy pick's
top-1 margin clears 0.08, well above the 2e-2 the frameworks' logits may
differ by, so the token streams must be equal.
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
from brpc_tpu import streaming as jstreaming
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.kv import pages as tpages
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.streaming import StreamOptions, stream_create
from brpc_tpu_torch.utils.convert import params_from_numpy

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)
TIMEOUT = 120.0
MARGIN = 0.08
PAGED = dict(paged=True, page=4)


@pytest.fixture(scope="module")
def params():
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**CFG))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jp, tp


def _solo(tp, prompt, max_new, max_seq=32):
    pre, step = tlm.make_decode(tlm.LMConfig(**{**CFG, "max_seq": max_seq}),
                                device="cpu")
    cache, logits = pre(tp, torch.from_numpy(prompt[None]))
    toks, worst = [], float("inf")
    for _ in range(max_new):
        top2 = torch.topk(logits[0], 2).values
        worst = min(worst, float(top2[0] - top2[1]))
        toks.append(int(torch.argmax(logits[0])))
        cache, logits = step(tp, cache, torch.tensor([toks[-1]]))
    return toks, worst


def _clear_prompt(tp, length, max_new, seed, max_seq=32):
    for s in range(seed, seed + 300):
        p = np.random.default_rng(s).integers(0, CFG["vocab"], length,
                                              dtype=np.int32)
        toks, worst = _solo(tp, p, max_new, max_seq)
        if worst > MARGIN:
            return p, toks
    pytest.fail(f"no clear prompt of length {length} near seed {seed}")


@pytest.fixture(scope="module")
def prompts(params):
    tp = params[1]
    return {"p8": _clear_prompt(tp, 8, 10, 100),
            "p17": _clear_prompt(tp, 17, 6, 700),
            "p14": _clear_prompt(tp, 14, 12, 200),
            "p10": _clear_prompt(tp, 10, 8, 500),
            # for a max_seq 64 service (the params do not depend on it)
            "long": _clear_prompt(tp, 8, 40, 100, max_seq=64),
            "short": _clear_prompt(tp, 14, 12, 200, max_seq=64)}


def _port_server(tp, slots=4, max_seq=32, **kw):
    srv = Server()
    svc = tsvc.LMService(cfg=tlm.LMConfig(**{**CFG, "max_seq": max_seq}),
                         params=tp, device="cpu", decode_slots=slots, **kw)
    assert srv.add_service(svc, name="LM") == 0
    assert srv.start("127.0.0.1:0") == 0
    return srv, svc


def _stop(srv, svc):
    srv.stop()
    if svc._batcher is not None:
        assert svc._batcher.shutdown()


def _stream_decode(ep, prompt, max_new, client="port"):
    """One streamed Decode session: (tokens, close reason)."""
    toks, closed = [], []

    def on_received(st, msgs):
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
    c = ch.call_method("LM.Decode", req, cntl=cntl)
    assert not c.failed, (c.error_code, c.error_text)
    assert struct.unpack("<I", bytes(c.response)) == (max_new,)
    deadline = time.monotonic() + TIMEOUT
    while not closed and time.monotonic() < deadline:
        time.sleep(0.005)
    assert closed, "decode stream never closed"
    if client == "port":
        ch.close()
    return toks, closed[0]


@pytest.fixture(scope="module")
def both_servers(params):
    tsrv, tsv = _port_server(params[1], **PAGED)
    jsrv = JServer()
    assert jsrv.add_service(jsvc.LMService(cfg=jlm.LMConfig(**CFG),
                                           params=params[0],
                                           decode_slots=4, **PAGED),
                            name="LM") == 0
    assert jsrv.start("127.0.0.1:0") == 0
    yield tsrv, tsv, jsrv
    jsrv.stop()
    _stop(tsrv, tsv)


def test_paged_decode_tokens_equal_across_the_wire(both_servers, prompts):
    """A JAX client on the port's paged server and the port's client on a
    JAX paged server get the tokens of JAX's own paged Decode; the port's
    second run of each prompt is a full prefix hit."""
    tsrv, tsv, jsrv = both_servers
    for key, max_new in (("p8", 8), ("p17", 6)):
        p, solo = prompts[key]
        want, wreason = _stream_decode(jsrv.listen_endpoint, p, max_new,
                                       client="jax")
        assert want == solo[:max_new] and wreason == "finished"
        prefills = tsv.batcher().prefills_run
        for ep, client in ((tsrv.listen_endpoint, "jax"),
                           (jsrv.listen_endpoint, "port"),
                           (tsrv.listen_endpoint, "port")):
            toks, reason = _stream_decode(ep, p, max_new, client=client)
            assert toks == want, (key, client)
            assert reason == "finished"
        assert tsv.batcher().prefills_run == prefills + 1
    stats = tsv.batcher().kv_stats()
    assert stats["paged"] and stats["prefix"]["hits"] >= 2


def test_paged_service_spills_and_resumes_under_pressure(params, prompts):
    """16 usable pages of 4 and a host tier: a long session (12 pages) is
    live when a second one (7 pages) joins, so it parks and resumes once
    the second finishes; each stream carries its solo tokens."""
    srv, svc = _port_server(params[1], slots=2, max_seq=64, kv_pages=17,
                            kv_host_slots=16, prefix=False, **PAGED)
    try:
        results = {}
        t = threading.Thread(target=lambda: results.__setitem__(
            "long", _stream_decode(srv.listen_endpoint,
                                   prompts["long"][0], 40)))
        t.start()
        deadline = time.monotonic() + TIMEOUT
        while svc.batcher().steps_run() < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.002)            # the long one is decoding
        results["short"] = _stream_decode(srv.listen_endpoint,
                                          prompts["short"][0], 12)
        t.join(TIMEOUT)
        for key, n in (("long", 40), ("short", 12)):
            assert results[key] == (prompts[key][1][:n], "finished"), key
        bat = svc.batcher()
        assert bat.spills >= 1 and bat.resumes == bat.spills
        assert bat.kv_stats()["alloc"]["in_use"] == 0
    finally:
        _stop(srv, svc)
    assert svc._batcher._alloc is None and svc._batcher._host is None


def test_spec_decoding_service_streams_plain_tokens(params, prompts):
    """``spec_decode_k=3`` with the target as its own draft: the streams
    carry plain decoding's tokens, and spec rounds ran."""
    srv, svc = _port_server(params[1], slots=2, spec_decode_k=3,
                            draft_params=params[1], **PAGED)
    before = tsvc.spec_counters()["spec_round"]
    try:
        for key, n in (("p8", 10), ("p17", 6)):
            p, want = prompts[key]
            assert _stream_decode(srv.listen_endpoint, p, n) \
                == (want[:n], "finished")
        assert tsvc.spec_counters()["spec_round"] - before >= 1
    finally:
        _stop(srv, svc)


def test_paged_service_without_host_tier_names_the_exhaustion(params,
                                                              prompts):
    """No host tier and 12 usable pages: while a long session holds them
    all, a second join's stream closes ``kv_pool_exhausted``."""
    srv, svc = _port_server(params[1], slots=2, max_seq=64, kv_pages=13,
                            prefix=False, **PAGED)
    before = tpages.kv_evict_counters()["kv_pool_exhausted"]
    try:
        res = {}
        t = threading.Thread(target=lambda: res.__setitem__(
            "long", _stream_decode(srv.listen_endpoint, prompts["long"][0],
                                   40)))
        t.start()
        deadline = time.monotonic() + TIMEOUT
        while svc.batcher().steps_run() < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.002)            # the long one is decoding
        toks, reason = _stream_decode(srv.listen_endpoint,
                                      prompts["short"][0], 12)
        t.join(TIMEOUT)
        assert (toks, reason) == ([], "kv_pool_exhausted")
        assert res["long"] == (prompts["long"][1], "finished")
        assert tpages.kv_evict_counters()["kv_pool_exhausted"] - before == 1
    finally:
        _stop(srv, svc)
