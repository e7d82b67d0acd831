"""The port's serving-plane observability held against the JAX package's,
on the CPU: ``models/lm_telemetry`` and the decode-session spans.

- the step profiler: the same ns sequence through both ``record_phase``
  gives equal phase histograms, counts, totals and quantiles; the
  ``lm_telemetry`` flag stops recording live;
- session timelines on a fake clock: the same session events give equal
  SLO verdicts, timeline records, per-tier TTFT and ITL rows and windowed
  ratios (``windowed_slo_deltas`` among them), a bounded ring, and the
  same ``lm_*`` Prometheus lines;
- the slice as a whole, through both packages' servers on the same seeded
  params: a traced monolithic ``LM.Decode`` and a traced disaggregated one
  over the ici lane give the same tokens, span names, parentage and
  annotation sequences (``tests/test_lm_observability.py``'s stitched
  trace is the reference), and a session the paged batcher spills and
  resumes carries ``lm_spill`` then ``lm_resume`` in both.

Params: the JAX ``init_params(PRNGKey(0))`` tree through numpy into
``params_from_numpy``; prompts are kept only where every greedy pick's
top-1 margin clears 0.08, so the token streams must be equal.
"""

import struct
import threading
import time

import jax
import numpy as np
import pytest
import torch

from brpc_tpu.butil import flags as jflags
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import Controller as JController
from brpc_tpu.kv import DecodeTierService as JDecodeTierService
from brpc_tpu.kv import KvTransport as JKvTransport
from brpc_tpu.kv import PrefillService as JPrefillService
from brpc_tpu.kv import pages as jpages
from brpc_tpu.kv import transport as jtr
from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import lm_telemetry as jlmt
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu import rpcz as jrpcz
from brpc_tpu import streaming as jstreaming
from brpc_tpu.bvar import render_prometheus as jrender
from brpc_tpu.server import Server as JServer
from brpc_tpu_torch import rpcz as trpcz
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.bvar import render_prometheus as trender
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.kv import DecodeTierService, KvTransport, PrefillService
from brpc_tpu_torch.kv import pages as tpages
from brpc_tpu_torch.kv import transport as ttr
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import lm_telemetry as tlmt
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.server import Server
from brpc_tpu_torch import streaming as tstreaming
from brpc_tpu_torch.utils.convert import params_from_numpy

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)
TIMEOUT = 120.0
MARGIN = 0.08
N = 6
# the JAX package's module and its port, side by side
PAIRS = ((jlmt, jsvc, jpages, jflags), (tlmt, tsvc, tpages, tflags))


@pytest.fixture(autouse=True)
def _fresh():
    for lmt, svc, pages, _ in PAIRS:
        lmt._reset_for_tests()
        svc._reset_sched_for_tests()
        pages._reset_for_tests()
    yield
    for lmt, svc, pages, _ in PAIRS:
        lmt._reset_for_tests()


class _Clock:
    """A monotonic clock the test moves by hand (ns and s views)."""

    def __init__(self):
        self.ns = 10_000_000_000

    def mono_ns(self):
        return self.ns

    def mono_s(self):
        return self.ns / 1e9


@pytest.fixture()
def clock(monkeypatch):
    c = _Clock()
    for lmt, *_ in PAIRS:
        monkeypatch.setattr(lmt, "_mono_ns", c.mono_ns)
        monkeypatch.setattr(lmt, "_mono_s", c.mono_s)
    return c


# -- the step profiler -------------------------------------------------------

def _phase_ns(seed, n=400):
    rng = np.random.default_rng(seed)
    ns = [int(v) for v in rng.lognormal(13.0, 3.0, n)]
    return ns + [0, -5, 1, 2, 3, 1 << 39, (1 << 45) + 7]


def test_record_phase_gives_the_jax_histograms():
    seqs = {p: _phase_ns(i) for i, p in enumerate(tlmt.LM_STEP_PHASES)}
    out = []
    for lmt, *_ in PAIRS:
        for p, seq in seqs.items():
            idx = lmt.phase_index(p)
            for ns in seq:
                lmt.record_phase(idx, ns)
        hists = {p: lmt.phase_histogram(p) for p in lmt.LM_STEP_PHASES}
        quant = {p: [lmt._hist_quantile_ms(h, q)
                     for q in (0.0, 0.5, 0.95, 0.99, 1.0)]
                 for p, h in hists.items()}
        out.append((hists, lmt.phase_counters(), lmt.phase_total_ns(),
                    quant, [lmt.bucket_label(i) for i in range(lmt.NBUCKETS)]))
    assert out[1] == out[0]
    hists, counts, totals, _, _ = out[1]
    for p, seq in seqs.items():
        assert sum(hists[p]) == counts[p] == len(seq)
        assert totals[p] == sum(max(ns, 0) for ns in seq)
        assert hists[p][0] == sum(ns <= 0 for ns in seq)
        assert hists[p][tlmt.NBUCKETS - 1] >= 1      # 2^45 clamps


def test_phase_index_is_closed():
    for i, p in enumerate(jlmt.LM_STEP_PHASES):
        assert tlmt.phase_index(p) == jlmt.phase_index(p) == i
    with pytest.raises(AssertionError):
        jlmt.phase_index("some_new_phase")
    with pytest.raises(ValueError):         # loud where JAX asserts
        tlmt.phase_index("some_new_phase")


def test_lm_telemetry_flag_stops_recording_live():
    for lmt, _, _, flags in PAIRS:
        before = lmt.phase_counters()
        assert flags.set_flag("lm_telemetry", False)
        try:
            assert not lmt.telemetry_enabled()
            lmt.record_phase(lmt.PH_DECODE_ROUND, 1000)
            assert lmt.phase_counters() == before
            assert lmt.open_timeline("standard", b"t", 4, 4,
                                     "fresh") is None
        finally:
            assert flags.set_flag("lm_telemetry", True)
        assert lmt.telemetry_enabled()
        lmt.record_phase(lmt.PH_DECODE_ROUND, 1000)
        assert lmt.phase_counters()["decode_round"] == \
            before["decode_round"] + 1


# -- session timelines on a fake clock ---------------------------------------

class _Span:
    def __init__(self):
        self.annotations = []

    def annotate(self, text):
        self.annotations.append(text)


class _Sess:
    def __init__(self, tl):
        self.tl = tl
        self.span = _Span()


# (tier, tenant, prompt_len, max_new, ms to the first token, ms gaps,
#  ttft target, itl target)
SESSIONS = [
    ("standard", b"a", 16, 4, 12.0, [3.0, 4.0, 2.5], 50.0, 10.0),
    ("standard", b"b", 8, 3, 80.0, [3.0, 3.0], 50.0, 10.0),       # ttft
    ("interactive", "c", 32, 4, 5.0, [2.0, 30.0, 2.0], 20.0, 10.0),  # itl
    ("batch", None, 4, 2, 200.0, [50.0], None, None),          # untargeted
    ("interactive", b"d", 12, 3, 7.0, [1.0, 1.5], 20.0, 10.0),
]


def _run_sessions(lmt, clock, sessions):
    """Open, emit and close each session, one at a time."""
    spans = []
    for tier, tenant, plen, max_new, first, gaps, ttft_t, itl_t in sessions:
        tl = lmt.open_timeline(tier, tenant, plen, max_new, "fresh")
        sess = _Sess(tl)
        clock.ns += int(first * 1e6)
        lmt.on_emit([(sess, 1)])
        for g in gaps:
            clock.ns += int(g * 1e6)
            lmt.on_emit([(sess, 2)])
        lmt.close_timeline(tl, "finished", ttft_t, itl_t)
        spans.append(sess.span.annotations)
        clock.ns += 1_000_000
    return spans


def _view(lmt, spans):
    recs = [{k: v for k, v in r.items() if k != "seq"}
            for r in lmt.timeline_records()]
    return (spans, lmt.slo_counters(), recs, lmt._ttft_rows(),
            lmt._itl_rows(), lmt.live_sessions(), lmt.ring_len())


def test_session_events_give_the_jax_verdicts(clock):
    views = [_view(lmt, _run_sessions(lmt, clock, SESSIONS))
             for lmt, *_ in PAIRS]
    assert views[1] == views[0]
    spans, slo, recs, ttft, itl, live, n = views[1]
    assert spans == [["lm_first_token"]] * len(SESSIONS)
    assert [r["verdict"] for r in recs] == [
        "slo_ok", "slo_ttft_miss", "slo_itl_miss", "slo_untargeted",
        "slo_ok"]
    assert slo[("interactive", "slo_ok")] == 1
    assert recs[2]["itl_max_ms"] == pytest.approx(30.0)
    assert recs[0]["tokens"] == 4 and recs[0]["ttft_ms"] == \
        pytest.approx(12.0)
    assert ttft[("batch", "p50")] > ttft[("interactive", "p99")]
    assert live == [] and n == len(SESSIONS)


def test_ring_is_bounded_like_jax(clock):
    out = []
    for lmt, *_ in PAIRS:
        lmt._reset_for_tests(ring=3)
        _run_sessions(lmt, clock, SESSIONS)
        out.append((lmt.ring_len(), lmt.ring_maxlen(),
                    [r["prompt_len"] for r in lmt.timeline_records()],
                    [r["prompt_len"] for r in lmt.timeline_records(2)]))
    assert out[1] == out[0] == (3, 3, [32, 4, 12], [4, 12])


def test_windowed_ratios_match_jax(clock):
    """Two snapshot windows over the same counter movements: the windowed
    spec, prefix and SLO answers describe the last window in both, while
    the lifetime ratios keep the whole history."""
    out = []
    for lmt, svc, pages, _ in PAIRS:
        cache = lmt.LmTelemetryCache(ttl_s=0.25)
        cache.get()
        svc.count_spec("spec_accept", 6)
        svc.count_spec("spec_reject", 2)
        for e in ("prefix_hit", "prefix_miss", "prefix_miss"):
            pages.count_prefix(e)
        _run_sessions(lmt, clock, SESSIONS[:2])
        clock.ns += 1_000_000_000
        first = (lmt.windowed_spec_accept_rate(cache),
                 lmt.windowed_prefix_hit_ratio(cache),
                 lmt.windowed_slo_deltas(cache))
        svc.count_spec("spec_accept", 1)
        svc.count_spec("spec_reject", 3)
        pages.count_prefix("prefix_partial_hit")
        _run_sessions(lmt, clock, SESSIONS[2:])
        clock.ns += 1_000_000_000
        second = (lmt.windowed_spec_accept_rate(cache),
                  lmt.windowed_prefix_hit_ratio(cache),
                  lmt.windowed_slo_deltas(cache))
        out.append((first, second, lmt.lifetime_spec_accept_rate(),
                    lmt.lifetime_prefix_hit_ratio(), cache.builds))
    assert out[1] == out[0]
    first, second, life_spec, life_prefix, builds = out[1]
    assert first[:2] == (0.75, pytest.approx(1 / 3))
    assert first[2] == {"standard": {"slo_ok": 1, "slo_ttft_miss": 1}}
    assert second == (0.25, 1.0, {"interactive": {"slo_itl_miss": 1,
                                                  "slo_ok": 1},
                                  "batch": {"slo_untargeted": 1}})
    assert life_spec == pytest.approx(7 / 12) and life_prefix == 0.5
    assert builds == 3


def _lm_lines(text):
    """The exposition's lines of the ``lm_*`` families."""
    out = []
    for line in text.splitlines():
        name = line.split()[2] if line.startswith("# TYPE") \
            else line.split("{")[0].split(" ")[0]
        if name.startswith("lm_"):
            out.append(line)
    return sorted(out)


def _expose_lm_families():
    """Put both packages' ``lm_*`` families into the same registry state:
    an earlier test in this process may have cleared one package's bvar
    registry (``tests/test_bvar.py``, ``tests/test_torch_bvar.py``), and
    ``lm_service``'s two families are exposed only at its import."""
    for lmt, svc, *_ in PAIRS:
        lmt.expose_lm_variables()
        svc._sched_var.expose("lm_slo_sched_total")
        svc._spec_var.expose("lm_spec_decode_total")


def test_exposed_families_render_like_jax(clock):
    for lmt, *_ in PAIRS:
        for i, ns in enumerate(_phase_ns(5, 50)):
            lmt.record_phase(i % len(lmt.LM_STEP_PHASES), ns)
        _run_sessions(lmt, clock, SESSIONS)
    _expose_lm_families()
    mine, theirs = _lm_lines(trender()), _lm_lines(jrender())
    assert mine == theirs
    for family in ("lm_step_phase_ns", "lm_step_phase_total",
                   "lm_ttft_ms", "lm_itl_ms", "lm_slo_attained_total",
                   "lm_windowed"):
        assert f"# TYPE {family} gauge" in mine
    assert 'lm_ttft_ms{tier="batch",quantile="p99"} 268.435' in mine


def test_exposed_families_render_alike_after_registry_clears(clock):
    """The repair above, shown: with both packages' registries cleared (as
    ``tests/test_bvar.py`` and ``tests/test_torch_bvar.py`` clear them),
    re-exposing the ``lm_*`` families gives equal renders again, the two
    families ``lm_service`` exposes at import among them."""
    from brpc_tpu.bvar import variable as jvariable
    from brpc_tpu_torch.bvar import variable as tvariable
    saved = [(mod, dict(mod._registry)) for mod in (jvariable, tvariable)]
    try:
        for mod, _ in saved:
            mod.clear_registry_for_tests()
        for lmt, *_ in PAIRS:
            _run_sessions(lmt, clock, SESSIONS)
        assert _lm_lines(trender()) == _lm_lines(jrender()) == []
        _expose_lm_families()
        mine, theirs = _lm_lines(trender()), _lm_lines(jrender())
        assert mine == theirs
        for family in ("lm_slo_sched_total", "lm_spec_decode_total",
                       "lm_ttft_ms", "lm_step_phase_ns"):
            assert f"# TYPE {family} gauge" in mine
    finally:
        for mod, reg in saved:
            with mod._registry_lock:
                mod._registry.clear()
                mod._registry.update(reg)


# -- the slice as a whole ----------------------------------------------------

@pytest.fixture(scope="module")
def params():
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**CFG))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jp, tp


def _solo(tp, prompt, max_new):
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
    for s in range(seed, seed + 300):
        p = np.random.default_rng(s).integers(0, CFG["vocab"], length,
                                              dtype=np.int32)
        toks, worst = _solo(tp, p, max_new)
        if worst > MARGIN:
            return p, toks
    pytest.fail(f"no clear prompt of length {length} near seed {seed}")


def _decode(port, ep, prompt, trace_id):
    """One traced Decode through a port or JAX client: (tokens, reason)."""
    toks, reasons, closed = [], [], threading.Event()
    unpack = tsvc.unpack_token if port else jsvc.unpack_token

    def on_received(st, msgs):
        toks.extend(unpack(bytes(m)) for m in msgs)

    def on_closed(st):
        reasons.append(st.close_reason)
        closed.set()

    if port:
        ch, cntl, sm = Channel(), Controller(), tstreaming
    else:
        ch, cntl, sm = JChannel(), JController(), jstreaming
    ch.init(str(ep))
    cntl.timeout_ms = int(TIMEOUT * 1000)
    cntl.trace_id = trace_id
    sm.stream_create(cntl, sm.StreamOptions(on_received=on_received,
                                            on_closed=on_closed))
    c = ch.call_method("LM.Decode",
                       tsvc.pack_generate_request(prompt[None], N),
                       cntl=cntl)
    assert not c.failed, (c.error_code, c.error_text)
    assert struct.unpack("<I", bytes(c.response)) == (N,)
    assert closed.wait(TIMEOUT), "decode stream never closed"
    if port:
        ch.close()
    return toks, reasons[0]


def _trace(store, trace_id, want):
    """The trace's spans once every method in ``want`` has a session span
    (session spans finish on the batcher thread, after the stream)."""
    deadline = time.monotonic() + TIMEOUT
    while True:
        spans = store.by_trace(trace_id)
        if want <= {s.full_method for s in spans} \
                or time.monotonic() > deadline:
            return spans
        time.sleep(0.01)


def _shape(spans):
    """Method names, parentage by name, and annotation sequences."""
    by_id = {s.span_id: s for s in spans}

    def key(s):
        return (s.full_method, "server" if s.is_server else "client")

    return sorted((key(s),
                   key(by_id[s.parent_span_id])
                   if s.parent_span_id in by_id else None,
                   tuple(t for _, t in s.annotations))
                  for s in spans)


@pytest.fixture()
def stores():
    for mod in (trpcz, jrpcz):
        mod.global_span_store().clear()
    yield trpcz.global_span_store(), jrpcz.global_span_store()
    for mod in (trpcz, jrpcz):
        mod.global_span_store().clear()


def test_monolithic_decode_trace_matches_jax(params, stores):
    jp, tp = params
    prompt, want = _clear_prompt(tp, 8, N, 100)
    tstore, jstore = stores
    tlm_svc = tsvc.LMService(cfg=tlm.LMConfig(**CFG), params=tp,
                             device="cpu", decode_slots=2)
    tsrv = Server()
    assert tsrv.add_service(tlm_svc, name="LM") == 0
    assert tsrv.start("127.0.0.1:0") == 0
    jlm_svc = jsvc.LMService(cfg=jlm.LMConfig(**CFG), params=jp,
                             decode_slots=2)
    jsrv = JServer()
    jsrv.add_service(jlm_svc, name="LM")
    assert jsrv.start("127.0.0.1:0") == 0
    want_methods = {"LMService.DecodeSession", "LM.Decode"}
    try:
        got = _decode(True, tsrv.listen_endpoint, prompt, 0xA11CE)
        ref = _decode(False, jsrv.listen_endpoint, prompt, 0xA11CE)
        mine = _shape(_trace(tstore, 0xA11CE, want_methods))
        theirs = _shape(_trace(jstore, 0xA11CE, want_methods))
    finally:
        tsrv.stop()
        jsrv.stop()
        assert tlm_svc.batcher().shutdown()
    assert got == ref == (want[:N], "finished")
    assert mine == theirs
    session = (("LMService.DecodeSession", "server"),
               ("LM.Decode", "server"),
               ("lm_join", "lm_first_token", "lm_evict:finished"))
    assert session in mine


def test_disagg_decode_trace_stitched_like_jax(params, stores):
    """One traced Decode through a prefill tier that hands the session to
    a decode tier over the ici lane: the same trace (both tiers' session
    spans under their tiers' server spans, the handoff's client and
    server spans between them) and the same tokens in both packages."""
    jp, tp = params
    prompt, want = _clear_prompt(tp, 8, N, 100)
    tstore, jstore = stores
    ttr._reset_for_tests()
    jtr._reset_for_tests()
    # the port's tiers
    tdec = tsvc.LMService(cfg=tlm.LMConfig(**CFG), params=tp, device="cpu",
                          decode_slots=2)
    tdsrv = Server()
    assert tdsrv.add_service(tdec, name="LM") == 0
    assert tdsrv.add_service(DecodeTierService(tdec), name="KV") == 0
    assert tdsrv.start("127.0.0.1:0") == 0
    tdch = Channel()
    tdch.init(str(tdsrv.listen_endpoint))
    tpre = PrefillService(cfg=tlm.LMConfig(**CFG), params=tp, device="cpu",
                          decode_slots=2, decode_channel=tdch,
                          transport=KvTransport())
    tpsrv = Server()
    assert tpsrv.add_service(tpre, name="LM") == 0
    assert tpsrv.start("127.0.0.1:0") == 0
    # the JAX package's
    jdec = jsvc.LMService(cfg=jlm.LMConfig(**CFG), params=jp,
                          decode_slots=2)
    jdsrv = JServer()
    jdsrv.add_service(jdec, name="LM")
    jdsrv.add_service(JDecodeTierService(jdec), name="KV")
    assert jdsrv.start("127.0.0.1:0") == 0
    jdch = JChannel()
    jdch.init(str(jdsrv.listen_endpoint))
    # pinned to the ici lane: about 6% of JAX processes cannot reach their
    # own fabric (a token holding b"@", ROADMAP C5) and would take shm
    jpre = JPrefillService(cfg=jlm.LMConfig(**CFG), params=jp,
                           decode_channel=jdch,
                           transport=JKvTransport(force_lane="ici"),
                           decode_slots=2)
    jpsrv = JServer()
    jpsrv.add_service(jpre, name="LM")
    assert jpsrv.start("127.0.0.1:0") == 0
    want_methods = {"LMService.DecodeSession", "KV.DecodeTierSession",
                    "LM.Decode", "KV.ImportSession"}
    try:
        got = _decode(True, tpsrv.listen_endpoint, prompt, 0x1517)
        ref = _decode(False, jpsrv.listen_endpoint, prompt, 0x1517)
        mine = _shape(_trace(tstore, 0x1517, want_methods))
        theirs = _shape(_trace(jstore, 0x1517, want_methods))
        # a tier counts its handoff once the import call has returned,
        # which may be after the decode tier has streamed every token
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline and not all(
                m.kv_stats()["sessions"] for m in (ttr, jtr)):
            time.sleep(0.01)
        lanes = (ttr.kv_stats()["ici_sessions"],
                 jtr.kv_stats()["ici_sessions"])
        fallbacks = [{k: v for k, v in m.kv_fallback_counters().items() if v}
                     for m in (ttr, jtr)]
    finally:
        tpsrv.stop()
        tdsrv.stop()
        tdch.close()
        jpsrv.stop()
        jdsrv.stop()
        for svc in (tpre, tdec):
            if svc._batcher is not None:
                assert svc._batcher.shutdown()
    assert got == ref == (want[:N], "finished")
    assert lanes == (1, 1), fallbacks
    assert mine == theirs
    assert (("LMService.DecodeSession", "server"), ("LM.Decode", "server"),
            ("lm_join", "lm_chunk_slice", "lm_handoff")) in mine
    assert (("KV.DecodeTierSession", "server"),
            ("KV.ImportSession", "server"),
            ("lm_join", "lm_first_token", "lm_evict:finished")) in mine
    assert (("KV.ImportSession", "server"), ("KV.ImportSession", "client"),
            ()) in mine
    assert (("KV.ImportSession", "client"),
            ("LMService.DecodeSession", "server"), ()) in mine
    assert {s.trace_id for s in tstore.by_trace(0x1517)} == {0x1517}


class _FakeStream:
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


def _spill_run(bat, span_mod, options, prompts):
    """Two sessions on a pool that holds one: the second joins once the
    first has streamed a token and spills it, and the first resumes once
    the second finishes; (tokens, annotation names of each session's
    span)."""
    streams, spans = [], []
    for prompt, max_new in prompts:
        deadline = time.monotonic() + TIMEOUT
        while streams and not streams[0].tokens \
                and time.monotonic() < deadline:
            time.sleep(0.002)          # the first session is live
        st = _FakeStream(options)
        span = span_mod.Span("LMService.DecodeSession", trace_id=0x5B111)
        bat.join(st, prompt, max_new, span=span)
        streams.append(st)
        spans.append(span)
    deadline = time.monotonic() + TIMEOUT
    while not all(s.closed for s in streams) \
            and time.monotonic() < deadline:
        time.sleep(0.002)
    assert all(s.closed for s in streams)
    deadline = time.monotonic() + TIMEOUT
    while any(not sp.end_us for sp in spans) \
            and time.monotonic() < deadline:
        time.sleep(0.002)
    return [(s.tokens, [t for _, t in sp.annotations])
            for s, sp in zip(streams, spans)]


def test_paged_spill_and_resume_annotated_like_jax(params, stores):
    """The first session (16 tokens: all 8 usable pages) is live when the
    second (4 pages) joins; the second's admit parks the first, which
    resumes when the second finishes: the same tokens and annotations in
    both packages."""
    jp, tp = params
    pa, wa = _clear_prompt(tp, 14, 16, 200)
    pb, wb = _clear_prompt(tp, 10, 6, 500)
    kw = dict(slots=2, paged=True, page=4, pages=9, host_slots=16,
              prefix=False)
    tbat = tsvc.ContinuousBatcher(tlm.LMConfig(**CFG), tp, device="cpu",
                                  **kw)
    mine = _spill_run(tbat, trpcz, tstreaming.StreamOptions(),
                      [(pa, 16), (pb, 6)])
    assert (tbat.spills, tbat.resumes) == (1, 1) and tbat.shutdown()
    jbat = jsvc.ContinuousBatcher(jlm.LMConfig(**CFG), jp,
                                  idle_linger_s=0.05, **kw)
    theirs = _spill_run(jbat, jrpcz, jstreaming.StreamOptions(),
                        [(pa, 16), (pb, 6)])
    deadline = time.monotonic() + 10
    while jbat._thread is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert [t for t, _ in mine] == [t for t, _ in theirs] == [wa, wb]
    assert [n for _, n in mine] == [n for _, n in theirs] == [
        ["lm_join", "lm_first_token", "lm_spill", "lm_resume",
         "lm_evict:finished"],
        ["lm_join", "lm_first_token", "lm_evict:finished"]]
