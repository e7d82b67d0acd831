"""The port's ContinuousBatcher in paged and speculative mode, on the CPU:
counterparts of tests/test_slo_sched.py's paged cases and
tests/test_lm_observability.py's spec-phase case.

- chunked paged prefill emits the tokens of a whole-prompt prefill, and
  its context enters the prefix cache (a second join is a full hit);
- a partial prefix hit aliases its covered page and catches the rest up
  through chunk slices, with no prefill;
- speculative decoding emits plain decoding's tokens with a draft from
  another seed (the rejection path) and with the target as its own draft
  (acceptance), and falls back to plain steps without k+1 rows of room;
- the constructor's contracts; an interactive session is never spilled
  while a batch-tier victim exists; spill and resume on a tiny pool with
  a host tier give the unspilled tokens; without a host tier the join
  closes ``kv_pool_exhausted``; spec rounds record their phases;
  ``shutdown`` drops every plane.

Every session's tokens equal the port's solo greedy generation and the
JAX batcher's on the same parameters (the JAX ``init_params(PRNGKey)``
trees through numpy into ``params_from_numpy``).  Prompts are drawn from
numpy seeds and kept only where every greedy pick's top-1 margin clears
0.08, well above the 2e-2 the frameworks' logits may differ by, so the
streams must be equal.
"""

import struct
import time

import jax
import numpy as np
import pytest
import torch

from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu import streaming as jstreaming
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.kv import pages as tpages
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import lm_telemetry as tlmt
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.streaming import StreamOptions
from brpc_tpu_torch.utils.convert import params_from_numpy

KW = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)
TIMEOUT = 120.0
MARGIN = 0.08


def _params(seed):
    jp = jlm.init_params(jax.random.PRNGKey(seed), jlm.LMConfig(**KW))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.fixture(scope="module")
def params():
    return _params(0)


@pytest.fixture(scope="module")
def draft():
    return _params(1)


def _solo(tp, prompt, max_new, max_seq=32):
    """Greedy tokens of a solo generation, and the smallest top-1 margin."""
    pre, step = tlm.make_decode(tlm.LMConfig(**{**KW, "max_seq": max_seq}),
                                device="cpu")
    cache, logits = pre(tp, torch.from_numpy(prompt[None]))
    toks, worst = [], float("inf")
    for _ in range(max_new):
        top2 = torch.topk(logits[0], 2).values
        worst = min(worst, float(top2[0] - top2[1]))
        toks.append(int(torch.argmax(logits[0])))
        cache, logits = step(tp, cache, torch.tensor([toks[-1]]))
    return toks, worst


def _clear(tp, make, max_new, seed, max_seq=32):
    """``make(rng)``'s first prompt near ``seed`` whose solo run has clear
    margins, and its tokens."""
    for s in range(seed, seed + 300):
        p = make(np.random.default_rng(s)).astype(np.int32)
        toks, worst = _solo(tp, p, max_new, max_seq)
        if worst > MARGIN:
            return p, toks
    pytest.fail(f"no clear prompt near seed {seed}")


def _randp(n):
    return lambda rng: rng.integers(0, KW["vocab"], n)


class _FakeStream:
    """The batchers' view of a stream (the JAX one also reads ``id`` and
    ``_native_tx``)."""

    def __init__(self, options):
        self.closed = False
        self.close_reason = None
        self.tokens = []
        self.id = 0
        self._native_tx = None
        self.options = options

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


def _port(tp, cfg_kw=None, **kw):
    return tsvc.ContinuousBatcher(tlm.LMConfig(**(cfg_kw or KW)), tp,
                                  device="cpu", **kw)


def _jax(jp, cfg_kw=None, **kw):
    # a short linger: the JAX batcher has no shutdown, and its thread
    # must end before the interpreter does
    return jsvc.ContinuousBatcher(jlm.LMConfig(**(cfg_kw or KW)), jp,
                                  idle_linger_s=0.05, **kw)


def _jax_done(jbat):
    deadline = time.monotonic() + 10
    while jbat._thread is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert jbat._thread is None


def _run(bat, joins, make_stream, sequential=True):
    """Join ``(prompt, max_new, tenant)`` sessions one after another (each
    finishing first when ``sequential``); their streams."""
    streams = []
    for prompt, max_new, tenant in joins:
        st = make_stream()
        bat.join(st, prompt, max_new, tenant=tenant)
        streams.append(st)
        if sequential:
            _finish(st)
    _finish(*streams)
    return streams


def _both(params, joins, cfg_kw=None, draft=None, **kw):
    """The same joins through the port's batcher and the JAX one: the
    port's batcher (shut down) and both sets of streams."""
    jkw, tkw = dict(kw), dict(kw)
    if draft is not None:
        jkw["draft_params"], tkw["draft_params"] = draft
    tbat = _port(params[1], cfg_kw, **tkw)
    tst = _run(tbat, joins, lambda: _FakeStream(StreamOptions()))
    jbat = _jax(params[0], cfg_kw, **jkw)
    jst = _run(jbat, joins, lambda: _FakeStream(jstreaming.StreamOptions()))
    _jax_done(jbat)
    assert [s.tokens for s in tst] == [s.tokens for s in jst]
    assert [s.close_reason for s in tst] == [s.close_reason for s in jst]
    assert tbat.shutdown()
    return tbat, tst


def test_chunked_paged_identity_and_full_prefix_hit(params):
    p, want = _clear(params[1], _randp(17), 6, 700)
    hits = tpages.prefix_event_counters()["prefix_hit"]
    slices = tsvc.sched_counters()["sched_chunk_slice"]
    bat, (st, st2) = _both(params, [(p, 6, None), (p, 6, None)], slots=4,
                           paged=True, page=16, prefill_chunk_tokens=4)
    assert st.tokens == st2.tokens == want
    assert st.close_reason == st2.close_reason == "finished"
    assert bat.prefills_run == 1                 # the second: a full hit
    assert tsvc.sched_counters()["sched_chunk_slice"] - slices >= 4
    assert tpages.prefix_event_counters()["prefix_hit"] - hits == 1


def test_paged_whole_prefill_tokens_and_stats(params):
    p, want = _clear(params[1], _randp(8), 10, 100)
    bat, (st,) = _both(params, [(p, 10, None)], slots=2, paged=True,
                       page=4)
    assert st.tokens == want and st.close_reason == "finished"
    stats = bat.kv_stats()
    assert stats["paged"] and stats["steps"] == 10
    assert stats["prefills_run"] == 1
    assert set(stats["spec"]) == set(tsvc.SPEC_DECODE_EVENTS)
    # dropped at shutdown: the stats show no allocator planes
    assert "alloc" not in stats and "prefix" not in stats
    bat2 = _port(params[1], slots=2, paged=True, page=4)
    st2 = _FakeStream(StreamOptions())
    bat2.join(st2, p, 10)
    _finish(st2)
    stats = bat2.kv_stats()
    assert stats["alloc"]["peak_in_use"] == 5    # ceil((7 + 10) / 4)
    assert stats["alloc"]["in_use"] == 1         # the cached full page
    assert stats["prefix"]["inserts"] == 1 and stats["prefix"]["nodes"] == 1
    assert bat2.shutdown()


def test_partial_prefix_hit_catches_up_via_chunks(params):
    """A context sharing only its first full page with the cache aliases
    that page; the rest catches up through chunk slices (counted as
    catch-up, not as a prefill), and the tokens equal the uncached
    path's."""
    cfg48 = {**KW, "max_seq": 48}
    base = np.random.default_rng(6).integers(0, 64, 16)
    pa = np.concatenate([base, np.random.default_rng(7).integers(0, 64, 17)]
                        ).astype(np.int32)
    pb, want = _clear(params[1], lambda rng: np.concatenate(
        [base, rng.integers(0, 64, 17)]), 4, 800, max_seq=48)
    partial = tpages.prefix_event_counters()["prefix_partial_hit"]
    catchup = tsvc.sched_counters()["sched_catchup_slice"]
    bat, (_, st_b) = _both(params, [(pa, 4, None), (pb, 4, None)],
                           cfg_kw=cfg48, slots=2, paged=True, page=16)
    assert st_b.tokens == want and st_b.close_reason == "finished"
    assert bat.prefills_run == 1                 # the hit avoided one
    assert tpages.prefix_event_counters()["prefix_partial_hit"] \
        - partial == 1
    assert tsvc.sched_counters()["sched_catchup_slice"] - catchup >= 1


def test_spec_decode_identity_rejection_path(params, draft):
    """A draft from another seed: rejections rewind len, and the stream
    equals plain greedy decoding's."""
    p, want = _clear(params[1], _randp(8), 6, 100)
    before = tsvc.spec_counters()
    _, (st,) = _both(params, [(p, 6, None)], draft=draft, slots=2,
                     paged=True, page=16, spec_decode_k=3)
    assert st.tokens == want and st.close_reason == "finished"
    after = tsvc.spec_counters()
    assert after["spec_round"] - before["spec_round"] >= 1
    assert after["spec_reject"] - before["spec_reject"] >= 1


def test_spec_decode_acceptance_and_fallback(params):
    """The target as its own draft: drafts verify, the stream equals plain
    decoding's; a session without k+1 rows of room (ctx 29 + 4 > 32)
    falls back to plain steps under the named event, tokens still
    equal."""
    p, want = _clear(params[1], _randp(8), 24, 100)
    lp, want2 = _clear(params[1], _randp(30), 2, 900)
    before = tsvc.spec_counters()
    _, (st, st2) = _both(params, [(p, 24, None), (lp, 2, None)],
                         draft=params, slots=2, paged=True, page=16,
                         spec_decode_k=3)
    assert st.tokens == want and st2.tokens == want2
    assert st.close_reason == st2.close_reason == "finished"
    after = tsvc.spec_counters()
    assert after["spec_accept"] - before["spec_accept"] >= 1
    assert after["spec_fallback_plain"] - before["spec_fallback_plain"] >= 1


def test_spec_decode_constructor_contract(params):
    tp = params[1]
    with pytest.raises(ValueError, match="paged"):
        _port(tp, spec_decode_k=3, draft_params=tp)
    with pytest.raises(ValueError, match="draft_params"):
        _port(tp, paged=True, spec_decode_k=3)
    # the same contracts, and the same order, as the JAX batcher's
    with pytest.raises(ValueError, match="paged"):
        _jax(params[0], spec_decode_k=3, draft_params=params[0])


def test_spec_round_phases_recorded(params):
    p, _ = _clear(params[1], _randp(8), 6, 100)
    c0 = tlmt.phase_counters()
    bat = _port(params[1], slots=2, paged=True, page=16, spec_decode_k=3,
                draft_params=params[1])
    st = _FakeStream(StreamOptions())
    bat.join(st, p, 6)
    _finish(st)
    c = tlmt.phase_counters()
    assert c["spec_draft"] - c0["spec_draft"] >= 1
    assert c["spec_verify"] - c0["spec_verify"] >= 1
    assert c["decode_round"] - c0["decode_round"] == bat.steps_run()
    assert c["prefix_lookup"] - c0["prefix_lookup"] == 1
    assert c["page_alloc"] - c0["page_alloc"] == 1
    assert bat.shutdown()
    assert bat._d_cache is None and bat._cache is None


class _StallStream(_FakeStream):
    """A client that takes ``credit`` tokens and is then out of credit."""

    def __init__(self, options, credit):
        super().__init__(options)
        self.credit = credit
        self.refused = 0

    def write(self, data):
        if len(self.tokens) >= self.credit:
            self.refused += 1
            return int(Errno.EOVERCROWDED)
        return super().write(data)


def test_spec_round_stalled_client_costs_one_credit_wait(params):
    """A spec round hands a session up to k + 1 tokens.  Once one write
    finds the client out of credit, the rest of that session's tokens are
    skipped: one bounded wait, then one ``backpressure`` eviction (the JAX
    batcher writes, and waits for, every token of the round)."""
    p, want = _clear(params[1], _randp(8), 12, 100)
    before = tsvc.spec_counters()["spec_accept"]
    bat = _port(params[1], slots=2, paged=True, page=16, spec_decode_k=3,
                draft_params=params[1])
    bat.EMIT_TIMEOUT_MS = 1
    st = _StallStream(StreamOptions(), credit=1)
    bat.join(st, p, 12)
    _finish(st)
    assert tsvc.spec_counters()["spec_accept"] > before
    assert st.tokens == want[:1]
    assert st.refused == 1
    assert st.close_reason == "backpressure"
    assert bat.shutdown()


def _timelines(monkeypatch):
    """Every timeline the port's batcher closes, in close order."""
    closed = []
    real = tlmt.close_timeline

    def spy(tl, *args):
        closed.append(tl)
        return real(tl, *args)

    monkeypatch.setattr(tsvc._lmt, "close_timeline", spy)
    return closed


def test_interactive_never_spilled_while_batch_victim_exists(params,
                                                            monkeypatch):
    """Pool pressure from an interactive join: the spill victim is the
    batch session (every _park call is watched), never the interactive
    one, and the preempted batch session resumes bit-exact."""
    p, want = _clear(params[1], _randp(14), 16, 200)
    reg = tsvc.TierRegistry()
    reg.set_tier(b"alice", "interactive")
    reg.set_tier(b"bob", "batch")
    parked = []
    real_park = tsvc.ContinuousBatcher._park

    def spy(self, sess):
        parked.append(sess.tier)
        return real_park(self, sess)

    monkeypatch.setattr(tsvc.ContinuousBatcher, "_park", spy)
    closed = _timelines(monkeypatch)
    preempts = tsvc.sched_counters()["sched_preempt_batch"]
    # 10 usable pages of 4: bob (ctx 13 + 16 new: 8 pages) fits alone,
    # alice (6 pages) only if bob spills
    bat = _port(params[1], slots=3, paged=True, page=4, pages=11,
                host_slots=32, prefix=False, tiers=reg)
    st_bob = _FakeStream(StreamOptions())
    bat.join(st_bob, p, 16, tenant=b"bob")
    deadline = time.monotonic() + TIMEOUT
    while not st_bob.tokens and time.monotonic() < deadline:
        time.sleep(0.002)                # bob is live before alice asks
    assert st_bob.tokens, "batch session never started"
    st_alice = _FakeStream(StreamOptions())
    bat.join(st_alice, p, 8, tenant=b"alice")
    _finish(st_alice, st_bob)
    assert st_alice.tokens == want[:8]
    assert st_bob.tokens == want                 # park/resume bit-exact
    assert st_alice.close_reason == st_bob.close_reason == "finished"
    assert bat.spills >= 1 and bat.resumes >= 1
    assert parked and set(parked) == {"batch"}, parked
    assert tsvc.sched_counters()["sched_preempt_batch"] - preempts >= 1
    bob = [tl for tl in closed if tl.tier == "batch"][0]
    assert bob.spills >= 1 and bob.resumes == bob.spills
    assert bob.preempts >= 1 and bob.pages_peak == 8
    assert bob.prefix == "prefix_miss"           # as JAX names it, cache off
    assert bat.kv_stats()["host"]["staged"] >= 1
    assert bat.shutdown() and bat._host is None and bat._alloc is None


def test_spill_and_resume_give_the_unspilled_tokens(params, monkeypatch):
    """Two standard sessions on a pool that holds one: the second join
    spills the first to the host tier, and it resumes once the second
    finishes; both streams equal their unspilled runs (and the JAX
    batcher's on the same pool)."""
    pa, wa = _clear(params[1], _randp(14), 12, 200)
    pb, wb = _clear(params[1], _randp(10), 6, 500)
    closed = _timelines(monkeypatch)
    joins = [(pa, 12, None), (pb, 6, None)]
    kw = dict(slots=2, paged=True, page=4, pages=9, host_slots=16,
              prefix=False)
    tbat = _port(params[1], **kw)
    tst = _run(tbat, joins, lambda: _FakeStream(StreamOptions()),
               sequential=False)
    assert [s.tokens for s in tst] == [wa, wb]
    assert [s.close_reason for s in tst] == ["finished"] * 2
    assert tbat.spills >= 1 and tbat.resumes == tbat.spills
    first = [tl for tl in closed if tl.prompt_len == 14][0]
    assert first.spills == tbat.spills and first.resumes == tbat.resumes
    stats = tbat.kv_stats()
    assert stats["alloc"]["in_use"] == 0 and stats["parked"] == 0
    assert stats["host"]["free"] == 16
    assert stats["host"]["staged"] == stats["host"]["fetched"] >= 1
    assert tbat.shutdown()
    jbat = _jax(params[0], **kw)
    jst = _run(jbat, joins, lambda: _FakeStream(jstreaming.StreamOptions()),
               sequential=False)
    _jax_done(jbat)
    assert [s.tokens for s in jst] == [wa, wb]


def test_pool_exhausted_without_host_tier(params):
    """No host tier: a join that needs more pages than the pool has free
    closes ``kv_pool_exhausted`` (counted), and the live session goes on
    to finish."""
    pa, wa = _clear(params[1], _randp(14), 12, 200)
    pb, _ = _clear(params[1], _randp(10), 6, 500)
    before = tpages.kv_evict_counters()["kv_pool_exhausted"]
    bat = _port(params[1], slots=2, paged=True, page=4, pages=9,
                prefix=False)
    st_a = _FakeStream(StreamOptions())
    bat.join(st_a, pa, 12)
    deadline = time.monotonic() + TIMEOUT
    while not st_a.tokens and time.monotonic() < deadline:
        time.sleep(0.002)
    st_b = _FakeStream(StreamOptions())
    bat.join(st_b, pb, 6)
    _finish(st_a, st_b)
    assert st_b.close_reason == "kv_pool_exhausted" and not st_b.tokens
    assert st_a.tokens == wa and st_a.close_reason == "finished"
    assert tpages.kv_evict_counters()["kv_pool_exhausted"] - before == 1
    assert bat.spills == 0
    assert bat.shutdown()


def test_paged_batcher_crash_closes_parked_and_live_sessions(params):
    """A step that raises closes every session with decode_error and drops
    the pools and the allocator planes; the next join serves again."""
    p, want = _clear(params[1], _randp(8), 4, 100)
    bat = _port(params[1], slots=2, paged=True, page=4, host_slots=4)
    bat._ensure_engine()
    real_step = bat._step

    def boom(*args):
        raise RuntimeError("device fault")

    bat._step = boom
    sts = [_FakeStream(StreamOptions()) for _ in range(2)]
    for st in sts:
        bat.join(st, p, 4)
    _finish(*sts)
    assert [st.close_reason for st in sts] == ["decode_error"] * 2
    deadline = time.monotonic() + 10
    while bat._thread is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert bat._cache is None and bat._alloc is None and bat._host is None
    bat._step = real_step
    st = _FakeStream(StreamOptions())
    bat.join(st, p, 4)
    _finish(st)
    assert st.tokens == want and st.close_reason == "finished"
    assert bat.shutdown()


def test_spec_and_sched_enums_match_jax():
    assert tsvc.SPEC_DECODE_EVENTS == jsvc.SPEC_DECODE_EVENTS
    assert set(tsvc.spec_counters()) == set(jsvc.SPEC_DECODE_EVENTS)
    with pytest.raises(ValueError):
        tsvc.count_spec("spec_some_new_event")
