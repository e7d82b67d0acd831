"""The LM served across replicas, on the CPU: two port
``LMService(device="cpu")`` replicas of a small LM (params converted from
the JAX ``init_params(PRNGKey(0))``), each on a port ``Server`` of its
own, behind a port cluster ``Channel``.

- ``list://A,B`` with ``"rr"``: the calls alternate between the replicas
  and every Generate's tokens equal the JAX service's for the same
  prompt (prompts whose greedy top-1 margins clear the frameworks'
  logit difference);
- a drain of A under two client threads looping Generate through a
  ``file://`` channel: A unpublishes, its ``ELAMEDUCK`` answers are
  retried on B, no call fails, and after the naming refresh no attempt
  picks A;
- a hedge: A held busy, a call pinned to A by ``c_murmurhash``'s request
  code, its backup answered by B;
- a Decode stream stays on its ``c_murmurhash`` replica and streams the
  solo tokens;
- ``ParallelChannel`` and ``SelectiveChannel`` over the replicas;
- each replica's load report carries its decode slots.
"""

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
from brpc_tpu_torch import fleet
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import (Channel, ChannelOptions, Controller,
                                   ParallelChannel, SelectiveChannel)
from brpc_tpu_torch.client.circuit_breaker import global_circuit_breaker_map
from brpc_tpu_torch.client.load_balancer import create_load_balancer
from brpc_tpu_torch.client.naming_service import (global_lame_ducks,
                                                  parse_server_line)
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.streaming import StreamOptions, stream_create
from brpc_tpu_torch.utils.convert import params_from_numpy

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)
TIMEOUT_MS = 60_000
MARGIN = 0.08


@pytest.fixture(scope="module")
def params():
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**CFG))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jp, tp


def _replica(tp):
    svc = tsvc.LMService(cfg=tlm.LMConfig(**CFG), params=tp, device="cpu",
                         decode_slots=2)
    srv = Server()
    assert srv.add_service(svc, name="LM") == 0
    assert srv.start("127.0.0.1:0") == 0
    return srv, svc


@pytest.fixture()
def replicas(params):
    global_circuit_breaker_map().reset()
    global_lame_ducks().reset()
    pair = [_replica(params[1]) for _ in range(2)]
    yield pair
    for srv, svc in pair:
        srv.stop()
        if svc._batcher is not None:
            svc._batcher.shutdown()
    global_lame_ducks().reset()


def _url(pair):
    return "list://" + ",".join(str(srv.listen_endpoint) for srv, _ in pair)


def _solo(tp, prompt, max_new):
    """Greedy tokens of ``prompt`` (b, s) and the smallest top-1 margin."""
    pre, step = tlm.make_decode(tlm.LMConfig(**CFG), device="cpu")
    cache, logits = pre(tp, torch.from_numpy(prompt))
    toks, worst = [], float("inf")
    for _ in range(max_new):
        top2 = torch.topk(logits, 2, dim=-1).values
        worst = min(worst, float((top2[:, 0] - top2[:, 1]).min()))
        tok = torch.argmax(logits, -1)
        toks.append(tok)
        cache, logits = step(tp, cache, tok)
    return torch.stack(toks, 1).numpy(), worst


def _clear_prompts(tp, n, shape, max_new, seed):
    out = []
    for s in range(seed, seed + 400):
        p = np.random.default_rng(s).integers(0, CFG["vocab"], shape,
                                              dtype=np.int32)
        toks, worst = _solo(tp, p, max_new)
        if worst > MARGIN:
            out.append((p, toks))
            if len(out) == n:
                return out
    pytest.fail("not enough prompts with clear top-1 margins")


def _generate(ch, prompt, max_new, cntl=None):
    c = cntl or Controller()
    if c.timeout_ms is None:
        c.timeout_ms = TIMEOUT_MS
    return ch.call_method("LM.Generate",
                          tsvc.pack_generate_request(prompt, max_new),
                          cntl=c)


def _count(srv, method="LM.Generate"):
    return srv.method_status(method).latency.count()


def test_rr_generate_spreads_and_equals_jax(params, replicas):
    jsrv = JServer()
    assert jsrv.add_service(jsvc.LMService(cfg=jlm.LMConfig(**CFG),
                                           params=params[0]), name="LM") == 0
    assert jsrv.start("127.0.0.1:0") == 0
    ch = Channel()
    try:
        assert ch.init(_url(replicas), "rr") == 0
        jch = JChannel()
        assert jch.init(str(jsrv.listen_endpoint)) == 0
        seen = []
        for prompt, toks in _clear_prompts(params[1], 4, (1, 6), 4, 300):
            c = _generate(ch, prompt, 4)
            assert not c.failed, c.error_text
            got = tsvc.unpack_generated(c.response)
            np.testing.assert_array_equal(got, toks)
            jc = JController()
            jc.timeout_ms = TIMEOUT_MS
            want = jch.call_method("LM.Generate",
                                   jsvc.pack_generate_request(prompt, 4),
                                   cntl=jc)
            assert not want.failed, want.error_text
            np.testing.assert_array_equal(
                got, jsvc.unpack_generated(want.response))
            seen.append(c.remote_side)
        assert seen[0] != seen[1] and seen[:2] == seen[2:]
        assert [_count(srv) for srv, _ in replicas] == [2, 2]
    finally:
        ch.close()
        jsrv.stop()


def test_drain_fails_no_call(params, replicas, tmp_path):
    (a, _), (b, _) = replicas
    naming = tmp_path / "lm.naming"
    for srv, _ in replicas:
        assert srv.publish(f"file://{naming}") == 0
    ch = Channel()
    assert ch.init(f"file://{naming}", "rr") == 0
    prompt = np.random.default_rng(7).integers(0, CFG["vocab"], (1, 8),
                                               dtype=np.int32)
    stop = threading.Event()
    results = []
    lock = threading.Lock()

    def loop():
        while not stop.is_set():
            c = _generate(ch, prompt, 4)
            with lock:
                results.append((c.error_code, c.retried_count,
                                c.remote_side, dict(c.attempt_remotes)))

    threads = [threading.Thread(target=loop) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 30
        while len(results) < 10 and time.monotonic() < deadline:
            time.sleep(0.01)
        drained = a.drain(grace_ms=2000)
        assert drained in (0, -1)
        assert naming.read_text().split() == [str(b.listen_endpoint)]
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert results and all(code == 0 for code, *_ in results), \
        [r for r in results if r[0]][:3]
    assert {r[2] for r in results} == {a.listen_endpoint, b.listen_endpoint}
    ch.load_balancer._ns.run_once()     # the naming refresh
    assert [str(n.endpoint) for n in ch.load_balancer.servers] == \
        [str(b.listen_endpoint)]
    for _ in range(4):
        c = _generate(ch, prompt, 4)
        assert not c.failed, c.error_text
        assert a.listen_endpoint not in c.attempt_remotes.values()
    ch.close()


def _code_for(pair, port, name="c_murmurhash"):
    lb = create_load_balancer(name)
    lb.reset_servers([parse_server_line(str(srv.listen_endpoint))
                      for srv, _ in pair])

    class C:
        excluded_servers = ()
        request_code = 0

    for code in range(1000):
        C.request_code = code
        if lb.select_server(C()).port == port:
            return code
    raise AssertionError("no request code hashes there")


def test_hedge_is_won_by_the_other_replica(params, replicas):
    (a, svc_a), (b, _) = replicas
    opts = ChannelOptions()
    opts.connection_type = "pooled"
    ch = Channel(opts)
    assert ch.init(_url(replicas), "c_murmurhash") == 0
    prompt, toks = _clear_prompts(params[1], 1, (1, 6), 4, 500)[0]
    code = _code_for(replicas, a.listen_endpoint.port)
    held = threading.Event()
    release = threading.Event()

    def hold():
        with svc_a._device_lock:      # A busy: its Generate queues
            held.set()
            release.wait(10)

    holder = threading.Thread(target=hold)
    holder.start()
    try:
        assert held.wait(5)
        cntl = Controller()
        cntl.request_code = code
        cntl.backup_request_ms = 50
        cntl.timeout_ms = TIMEOUT_MS
        t0 = time.monotonic()
        c = _generate(ch, prompt, 4, cntl)
        ms = (time.monotonic() - t0) * 1e3
    finally:
        release.set()
        holder.join(10)
    assert not c.failed, c.error_text
    assert c.has_backup_request
    assert c.attempt_remotes[0] == a.listen_endpoint
    assert c.remote_side == b.listen_endpoint
    np.testing.assert_array_equal(tsvc.unpack_generated(c.response), toks)
    assert ms < 5000
    ch.close()


def test_decode_stream_stays_on_its_hashed_replica(params, replicas):
    ch = Channel()
    assert ch.init(_url(replicas), "c_murmurhash") == 0
    prompts = _clear_prompts(params[1], 2, (1, 6), 6, 700)
    try:
        for target in (0, 1):
            srv = replicas[target][0]
            before = [_count(s, "LM.Decode") for s, _ in replicas]
            prompt, toks = prompts[target]
            tokens, closed = [], threading.Event()
            cntl = Controller()
            cntl.timeout_ms = TIMEOUT_MS
            cntl.request_code = _code_for(replicas, srv.listen_endpoint.port)
            stream_create(cntl, StreamOptions(
                on_received=lambda s, msgs: tokens.extend(
                    tsvc.unpack_token(m) for m in msgs),
                on_closed=lambda s: closed.set()))
            c = ch.call_method("LM.Decode",
                               tsvc.pack_generate_request(prompt, 6),
                               cntl=cntl)
            assert not c.failed, c.error_text
            assert c.remote_side == srv.listen_endpoint
            assert closed.wait(30)
            assert tokens == toks[0].tolist()
            after = [_count(s, "LM.Decode") for s, _ in replicas]
            assert after[target] == before[target] + 1
            assert after[1 - target] == before[1 - target]
    finally:
        ch.close()


def test_fan_out_and_selective_over_replicas(params, replicas):
    prompt, toks = _clear_prompts(params[1], 1, (1, 6), 4, 900)[0]
    req = tsvc.pack_generate_request(prompt, 4)
    pc = ParallelChannel()
    subs = []
    for srv, _ in replicas:
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        pc.add_channel(ch)
        subs.append(ch)
    cntl = Controller()
    cntl.timeout_ms = TIMEOUT_MS
    c = pc.call_method("LM.Generate", req, cntl=cntl)
    assert not c.failed, c.error_text
    for resp in c.response:
        np.testing.assert_array_equal(tsvc.unpack_generated(resp), toks)
    sc = SelectiveChannel()
    dead = Channel()
    dead.init("127.0.0.1:1")
    sc.add_channel(dead)
    sc.add_channel(subs[0])
    for _ in range(2):
        cntl = Controller()
        cntl.timeout_ms = TIMEOUT_MS
        c = sc.call_method("LM.Generate", req, cntl=cntl)
        assert not c.failed, c.error_text
        np.testing.assert_array_equal(tsvc.unpack_generated(c.response),
                                      toks)
    for ch in subs:
        ch.close()


def test_replica_reports_carry_decode_slots(replicas):
    """Each replica reports its own slots; its KV planes once its batcher
    runs (a report never builds one)."""
    for srv, svc in replicas:
        rep = fleet.build_load_report(srv)
        assert rep["instance"] == str(srv.listen_endpoint)
        assert rep["slots"] == {"live": 0, "total": 2, "free": 2,
                                "steps": 0}
        assert rep["kv"] is None and svc._batcher is None
        svc.batcher()
        assert fleet.build_load_report(srv)["kv"]["parked"] == 0


def test_elameduck_without_a_balancer_is_not_retried(params, replicas):
    """The single-server channel keeps the JAX policy: a draining
    server's ``ELAMEDUCK`` is the call's answer."""
    (a, _), _ = replicas
    ch = Channel()
    assert ch.init(str(a.listen_endpoint)) == 0
    prompt = np.zeros((1, 4), np.int32)
    assert not _generate(ch, prompt, 2).failed
    done = threading.Thread(target=a.drain, args=(2000,))
    done.start()
    deadline = time.monotonic() + 5
    while not a.draining and time.monotonic() < deadline:
        time.sleep(0.01)
    c = _generate(ch, prompt, 2)
    assert c.error_code == int(Errno.ELAMEDUCK)
    assert c.retried_count == 0
    done.join(10)
    ch.close()
