"""Disaggregated prefill and decode in the port, on the CPU over loopback:
a ``PrefillService`` on one port ``Server`` prefills each ``LM.Decode``
session, hands its KV pages to a ``DecodeTierService`` on a second, and
the decode tier's batcher streams the tokens to the original client.

- end to end: two-tier tokens equal the port's monolithic tokens and JAX
  ``generate``'s on the ici lane, the copy lane, and a forced shm lane
  (the pages staged in this process's shm ring, every slot back after
  the handoff), into a contiguous, a paged and a spec decode tier; the
  ici lane aliases the exporter's tensors and sends no attachment; a
  handed-off session joins a live batch;
- lifecycle: a stale import answers ERESPONSE and seats nothing, a forged
  stream adoption is refused before any page resolves, an ambiguous
  handoff never decodes twice, a dead client connection sweeps its pages;
- every named fallback, each pinned, and a strict tier's named close;
- the batcher's import path alone (``join_imported`` with a stub stream);
- across the packages in one process: each package's prefill tier
  against the other's decode tier ends at the auth check
  (``kv_stream_not_local``) and decodes locally; and the over-cap copy
  lane, where the packages diverge (pinned).

Params: the JAX ``init_params(PRNGKey(0))`` tree through numpy into
``params_from_numpy``.  Prompts are kept only where every greedy pick's
top-1 margin clears 0.08, well above the 2e-2 the frameworks' logits may
differ by, so the token streams must be equal.  Every wait is bounded by
an event (a stream's close, a batcher hook) with a timeout.
"""

import struct
import threading
import time

import jax
import numpy as np
import pytest
import torch

from brpc_tpu.butil.flags import get_flag as jget_flag
from brpc_tpu.butil.flags import set_flag as jset_flag
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.kv import DecodeTierService as JDecodeTierService
from brpc_tpu.kv import KvTransport as JKvTransport
from brpc_tpu.kv import PrefillService as JPrefillService
from brpc_tpu.kv import pages as jpages
from brpc_tpu.kv import transport as jtr
from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.server import Server as JServer
from brpc_tpu.transport import shm_ring as jshm
from brpc_tpu_torch.butil.flags import get_flag, set_flag
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.kv import DecodeTierService, KvTransport, PrefillService
from brpc_tpu_torch.kv import disagg as tdisagg
from brpc_tpu_torch.kv import pages as tpages
from brpc_tpu_torch.kv import transport as ttr
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.streaming import Stream, StreamOptions, stream_create
from brpc_tpu_torch.transport import shm_ring as tshm
from brpc_tpu_torch.transport.socket import Socket
from brpc_tpu_torch.utils.convert import params_from_numpy

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)
TIMEOUT = 120.0
MARGIN = 0.08
N = 6                     # new tokens per session


@pytest.fixture(autouse=True)
def _fresh_kv():
    tpages._reset_for_tests()
    ttr._reset_for_tests()
    tshm._reset_for_tests()
    yield
    tpages._reset_for_tests()
    ttr._reset_for_tests()
    tshm._reset_for_tests()


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


@pytest.fixture(scope="module")
def prompts(params):
    """Clear prompts with JAX ``generate``'s tokens, which the port's solo
    run and its monolithic service give too."""
    jp, tp = params
    out = {}
    for key, (length, max_new, seed) in {"p8": (8, 12, 100),
                                         "p5": (5, N, 300),
                                         "p11": (11, N, 400)}.items():
        p, toks = _clear_prompt(tp, length, max_new, seed)
        want = np.asarray(jlm.generate(jp, jlm.LMConfig(**CFG), p[None],
                                       max_new))[0].tolist()
        assert toks == want, key
        out[key] = (p, want)
    return out


# -- harness

class _Tiers:
    """A decode tier (an LMService and a DecodeTierService on one port
    Server) and a prefill tier pointed at it (a PrefillService on
    another); ``stop`` ends both servers and every batcher."""

    def __init__(self, tp, lane=None, decode_cfg=None, decode_params=None,
                 decode_kw=None, prefill_kw=None):
        self.dec = tsvc.LMService(
            cfg=tlm.LMConfig(**(decode_cfg or CFG)),
            params=tp if decode_params is None else decode_params,
            device="cpu", decode_slots=4, **(decode_kw or {}))
        self.dsrv = Server()
        assert self.dsrv.add_service(self.dec, name="LM") == 0
        assert self.dsrv.add_service(DecodeTierService(self.dec),
                                     name="KV") == 0
        assert self.dsrv.start("127.0.0.1:0") == 0
        self.dch = Channel()
        self.dch.init(str(self.dsrv.listen_endpoint))
        kw = {"decode_channel": self.dch,
              "transport": KvTransport(force_lane=lane),
              **(prefill_kw or {})}
        self.pre = PrefillService(cfg=tlm.LMConfig(**CFG), params=tp,
                                  device="cpu", decode_slots=4, **kw)
        self.psrv = Server()
        assert self.psrv.add_service(self.pre, name="LM") == 0
        assert self.psrv.start("127.0.0.1:0") == 0

    @property
    def ep(self):
        return self.psrv.listen_endpoint

    def stop(self):
        self.psrv.stop()
        self.dsrv.stop()
        self.dch.close()
        for svc in (self.pre, self.dec):
            if svc._batcher is not None:
                assert svc._batcher.shutdown()


def _stream_decode(ep, prompt, max_new, expect_ok=True):
    """One streamed Decode session through a port client: (tokens, close
    reason, the controller).  Waits on the stream's close."""
    toks, reasons = [], []
    closed = threading.Event()

    def on_closed(st):
        reasons.append(st.close_reason)
        closed.set()

    ch, cntl = Channel(), Controller()
    ch.init(str(ep))
    cntl.timeout_ms = int(TIMEOUT * 1000)
    stream_create(cntl, StreamOptions(
        on_received=lambda st, msgs: toks.extend(
            tsvc.unpack_token(bytes(m)) for m in msgs),
        on_closed=on_closed))
    c = ch.call_method("LM.Decode",
                       tsvc.pack_generate_request(prompt[None], max_new),
                       cntl=cntl)
    if expect_ok:
        assert not c.failed, (c.error_code, c.error_text)
        assert struct.unpack("<I", c.response) == (max_new,)
    assert closed.wait(TIMEOUT), "decode stream never closed"
    ch.close()
    return toks, reasons[0], c


def _fallback_counts():
    return {k: v for k, v in ttr.kv_fallback_counters().items() if v}


# -- end to end

@pytest.fixture(scope="module")
def monolithic(params, prompts):
    """The port's monolithic Decode of each prompt."""
    srv = Server()
    svc = tsvc.LMService(cfg=tlm.LMConfig(**CFG), params=params[1],
                         device="cpu", decode_slots=4)
    assert srv.add_service(svc, name="LM") == 0
    assert srv.start("127.0.0.1:0") == 0
    try:
        out = {key: _stream_decode(srv.listen_endpoint, p, N)[:2]
               for key, (p, _) in prompts.items()}
    finally:
        srv.stop()
        assert svc.batcher().shutdown()
    for key, (toks, reason) in out.items():
        assert (toks, reason) == (prompts[key][1][:N], "finished"), key
    return out


@pytest.mark.parametrize("lane", [None, "copy", "shm"],
                         ids=["auto-ici", "copy", "shm"])
def test_two_tier_tokens_identical_to_monolithic(params, prompts, monolithic,
                                                 lane):
    """The prefill tier exports each session's pages and the decode tier
    imports them mid-request; the tokens equal the port's monolithic
    Decode and JAX ``generate``.  A forced shm lane stages every page in
    the ring and hands every slot back (where this host can make no ring
    it rides the copy lane under ``kv_shm_unavailable``)."""
    if lane == "shm" and not tshm.shm_supported():
        landed, fallbacks = "copy", {"kv_shm_unavailable": 2}
    else:
        landed, fallbacks = lane or "ici", {}
    t = _Tiers(params[1], lane=lane)
    try:
        for key in ("p8", "p5"):
            p, _ = prompts[key]
            toks, reason, _ = _stream_decode(t.ep, p, N)
            assert (toks, reason) == monolithic[key], key
        st = ttr.kv_stats()
        assert st["sessions"] == st[f"{landed}_sessions"] == 2
        assert st["local_fallbacks"] == 0
        assert st["pages_moved"] == 2 * 2 * CFG["depth"]
        assert st["bytes_moved"] == 2 * sum(
            n for _, _, n in tlm.kv_page_specs(tlm.LMConfig(**CFG)))
        assert _fallback_counts() == fallbacks
        if landed == "shm":
            assert tshm.shm_stats()["staged"] == 2 * 2 * CFG["depth"]
            assert tshm.outstanding_tx_slots() == 0
        bat = t.dec.batcher()
        assert bat.steps_run() >= N and bat.prefills_run == 0
        assert tpages.outstanding_pages() == 0
        assert t.pre._batcher is None          # nothing decoded locally
    finally:
        t.stop()


def test_ici_lane_aliases_and_sends_no_attachment(params, prompts,
                                                  monkeypatch):
    """On the ici lane the decode tier seats the prefill tier's own cache
    tensors (same storage), and the ImportSession request carries no
    attachment: no page byte crosses the message path."""
    exported, imported, attachments = [], [], []
    real_export = tdisagg.export_decode_cache
    real_import = tdisagg.import_pages

    def export(cfg, cache):
        pages = real_export(cfg, cache)
        exported.append([t for t, _ in pages])
        return pages

    def import_(man, att, specs, device):
        attachments.append(att)
        got = real_import(man, att, specs, device)
        imported.append(got)
        return got

    monkeypatch.setattr(tdisagg, "export_decode_cache", export)
    monkeypatch.setattr(tdisagg, "import_pages", import_)
    t = _Tiers(params[1])
    try:
        p, want = prompts["p8"]
        assert _stream_decode(t.ep, p, N)[:2] == (want[:N], "finished")
    finally:
        t.stop()
    assert attachments == [b""]
    assert len(imported) == len(exported) == 1
    for a, b in zip(imported[0], exported[0]):
        assert a is b and a.data_ptr() == b.data_ptr()
    assert ttr.kv_stats()["ici_sessions"] == 1


def test_handed_off_session_joins_live_batch(params, prompts):
    """A session decoding directly on the decode tier and a handed-off one
    share rounds of one batch; both stream their solo tokens.  The decode
    tier's second round waits until the import is queued, so the two
    always overlap."""
    t = _Tiers(params[1])
    bat = t.dec.batcher()
    queued, entered = threading.Event(), threading.Event()
    real_round, real_join = bat._plain_round, bat.join_imported
    rounds, widths = [0], []

    def gated_round():
        rounds[0] += 1
        if rounds[0] == 2:
            entered.set()
            assert queued.wait(TIMEOUT)
        pairs, finished = real_round()
        widths.append(len(pairs))
        return pairs, finished

    def join_imported(*a, **kw):
        real_join(*a, **kw)
        queued.set()

    bat._plain_round = gated_round
    bat.join_imported = join_imported
    res = {}
    try:
        direct = threading.Thread(target=lambda: res.__setitem__(
            "direct", _stream_decode(t.dsrv.listen_endpoint,
                                     prompts["p8"][0], 12)[:2]))
        direct.start()
        assert entered.wait(TIMEOUT)
        res["handoff"] = _stream_decode(t.ep, prompts["p5"][0], N)[:2]
        direct.join(TIMEOUT)
        assert not direct.is_alive()
    finally:
        queued.set()
        t.stop()
    assert res["direct"] == (prompts["p8"][1], "finished")
    assert res["handoff"] == (prompts["p5"][1][:N], "finished")
    assert max(widths) == 2
    assert ttr.kv_stats()["ici_sessions"] == 1


def _prefilled_pages(t, prompt):
    cache1, ctx_len = tsvc.bucketed_prefill(t.pre._ensure_prefill(),
                                            t.pre.cfg, prompt)
    return tlm.export_decode_cache(t.pre.cfg, cache1), ctx_len


def _import_call(t, man):
    cntl = Controller()
    cntl.timeout_ms = int(TIMEOUT * 1000)
    return t.dch.call_method("KV.ImportSession", ttr.encode_manifest(man),
                             cntl=cntl)


def test_stale_import_over_rpc_is_eresponse(params, prompts):
    """A manifest naming pages already settled fails the RPC with
    ERESPONSE; the decode tier seats nothing and runs no step."""
    t = _Tiers(params[1])
    client_stream = Stream()             # adoptable, never written
    try:
        p = prompts["p8"][0]
        pages, ctx_len = _prefilled_pages(t, p)
        store = tpages.process_kv_store()
        handles = [store.export_array(a, n) for a, n in pages]
        descs = [h.describe() for h in handles]
        store.settle_handles(handles)
        man = ttr.SessionManifest(ttr.LANE_ICI, client_stream.id,
                                  ttr.stream_auth(client_stream.id),
                                  ctx_len, int(p[-1]), 4,
                                  t.dec.model_fingerprint(), descs)
        c = _import_call(t, man)
        assert c.failed and c.error_code == int(Errno.ERESPONSE), \
            (c.error_code, c.error_text)
        assert c.error_text.startswith("kv_import_rejected")
        assert t.dec._batcher is None          # nothing was ever seated
        assert not client_stream.closed
    finally:
        client_stream.close()
        t.stop()


def test_forged_stream_adoption_rejected(params, prompts):
    """A manifest naming another client's live stream without the
    process-keyed tag is refused before any page resolves."""
    t = _Tiers(params[1])
    victim = Stream()
    store = tpages.process_kv_store()
    try:
        p = prompts["p8"][0]
        pages, ctx_len = _prefilled_pages(t, p)
        handles = [store.export_array(a, n) for a, n in pages]
        man = ttr.SessionManifest(ttr.LANE_ICI, victim.id, b"\0" * 8,
                                  ctx_len, int(p[-1]), 4,
                                  t.dec.model_fingerprint(),
                                  [h.describe() for h in handles])
        c = _import_call(t, man)
        assert c.failed and c.error_code == int(Errno.EREQUEST)
        assert c.error_text.startswith("kv_stream_not_local")
        assert store.outstanding() == len(handles)   # none imported
        assert store.stats()["imported"] == 0
        assert t.dec._batcher is None
    finally:
        victim.close()
        store.settle_handles(handles)
        t.stop()


@pytest.mark.parametrize("field,value,reason", [
    ("max_new", 0, "kv_import_rejected: session bounds"),
    ("ctx_len", 31, "kv_import_rejected: session bounds"),
    ("last_token", 64, "kv_import_rejected: session bounds"),
    ("model_fp", b"1:2:3", "kv_model_mismatch"),
    ("bad", None, "kv_import_rejected: bad manifest")])
def test_import_checks_answer_erequest(params, field, value, reason):
    """The manifest's checks, before any page or stream: each refusal
    answers EREQUEST with its named text."""
    t = _Tiers(params[1])
    s = Stream()
    try:
        man = ttr.SessionManifest(ttr.LANE_ICI, s.id, ttr.stream_auth(s.id),
                                  8, 3, 4, t.dec.model_fingerprint(), [])
        if field == "bad":
            cntl = Controller()
            cntl.timeout_ms = int(TIMEOUT * 1000)
            c = t.dch.call_method("KV.ImportSession", b"KVH1\0", cntl=cntl)
        else:
            setattr(man, field, value)
            c = _import_call(t, man)
        assert c.failed and c.error_code == int(Errno.EREQUEST)
        assert c.error_text.startswith(reason), c.error_text
        assert t.dec._batcher is None
    finally:
        s.close()
        t.stop()


def test_ambiguous_handoff_never_double_decodes(params, prompts):
    """A failure that does not prove the decode tier never seated the
    session (a timeout, a dead connection) closes the stream under
    ``kv_handoff_failed`` even with ``fallback_local``: two batchers on
    one client stream would break at-most-once."""

    class _Ambiguous:
        def handoff(self, *a, **kw):
            return ttr.HandoffResult(False, None, "kv_import_rejected",
                                     ambiguous=True)

    t = _Tiers(params[1])
    t.pre.transport = _Ambiguous()
    try:
        toks, reason, c = _stream_decode(t.ep, prompts["p8"][0], 4,
                                         expect_ok=False)
        assert c.failed and c.error_code == int(Errno.EINTERNAL)
        assert (toks, reason) == ([], "kv_handoff_failed")
        assert t.pre._batcher is None          # never decoded locally
    finally:
        t.stop()


def test_ambiguous_results_are_the_unproven_failures(params, prompts):
    """The transport marks a failure ambiguous unless the import handler
    itself refused (EREQUEST, ERESPONSE): a timed-out import is
    ambiguous, a refused one is not."""
    t = _Tiers(params[1])
    try:
        p = prompts["p8"][0]
        pages, ctx_len = _prefilled_pages(t, p)
        s = Stream()
        try:
            fp = t.pre.model_fingerprint()
            res = t.pre.transport.handoff(t.dch, s.id, ctx_len, int(p[-1]),
                                          4, b"other-model", pages)
            assert (res.ok, res.reason, res.ambiguous) \
                == (False, "kv_model_mismatch", False)
            real = t.dec.batcher().join_imported
            gate = threading.Event()

            def slow_join(*a, **kw):    # outlasts the import's deadline
                gate.wait(TIMEOUT)
                real(*a, **kw)

            t.dec.batcher().join_imported = slow_join
            tr = KvTransport(import_timeout_ms=200)
            res = tr.handoff(t.dch, s.id, ctx_len, int(p[-1]), 4, fp, pages)
            gate.set()
            assert (res.ok, res.reason, res.ambiguous) \
                == (False, "kv_import_rejected", True)
            assert tpages.outstanding_pages() == 0
        finally:
            s.close()
    finally:
        t.stop()


def test_owner_sweep_on_client_death(monkeypatch):
    """Pages exported for a client's connection are swept when that
    connection closes before their handoff settles; the swept
    descriptors then refuse to import."""
    store = tpages.process_kv_store()
    exported, closed = [], threading.Event()

    class _Hold:
        """Exports a session's pages for the caller's connection and
        leaves them unsettled, as a handoff in flight does."""

        def Hold(self, cntl, request):
            t = torch.ones(8)
            exported.extend(store.export_array(t, 32,
                                               owner=("kv", cntl.socket_id))
                            for _ in range(3))
            return b"ok"

    real_close = Socket.close

    def close(sock):
        real_close(sock)
        if any(store._recs[h.page_id] is None for h in exported):
            closed.set()

    srv = Server()
    assert srv.add_service(_Hold(), name="H") == 0
    assert srv.start("127.0.0.1:0") == 0
    monkeypatch.setattr(Socket, "close", close)
    try:
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        assert ch.call("H.Hold", b"", timeout_ms=int(TIMEOUT * 1000)) == b"ok"
        assert store.outstanding() == 3
        ch.close()                        # the client dies
        assert closed.wait(TIMEOUT)
        assert store.outstanding() == 0 and store.stats()["swept"] == 3
        for h in exported:
            with pytest.raises(tpages.KvPageError):
                store.import_page(h.page_id, h.gen, 32)
    finally:
        srv.stop()


# -- named fallbacks

def _fallback_session(ep, prompt, want, reason, lands=None):
    """One session expecting ``reason``: the client still gets the
    monolithic tokens; ``lands`` names the lane that carried it (None:
    decoded locally)."""
    before = ttr.kv_fallback_counters()[reason]
    st0 = ttr.kv_stats()
    toks, close_reason, _ = _stream_decode(ep, prompt, N)
    assert (toks, close_reason) == (want[:N], "finished")
    assert ttr.kv_fallback_counters()[reason] == before + 1
    st = ttr.kv_stats()
    if lands is None:
        assert st["local_fallbacks"] == st0["local_fallbacks"] + 1
        assert st["sessions"] == st0["sessions"]
    else:
        assert st[f"{lands}_sessions"] == st0[f"{lands}_sessions"] + 1
        assert st["local_fallbacks"] == st0["local_fallbacks"]
    assert tpages.outstanding_pages() == 0


def test_fallback_no_decode_tier(params, prompts):
    t = _Tiers(params[1], prefill_kw={"decode_channel": None})
    try:
        _fallback_session(t.ep, *prompts["p8"], "kv_no_decode_tier")
        assert t.pre.batcher().steps_run() >= N      # decoded locally
        assert t.pre.batcher().prefills_run == 0     # on the same cache
    finally:
        t.stop()


def test_fallback_probe_failed_against_kv_less_peer(params, prompts):
    """A decode channel to a server with no KV service."""
    plain = Server()
    lm = tsvc.LMService(cfg=tlm.LMConfig(**CFG), params=params[1],
                        device="cpu")
    assert plain.add_service(lm, name="LM") == 0
    assert plain.start("127.0.0.1:0") == 0
    ch = Channel()
    ch.init(str(plain.listen_endpoint))
    t = _Tiers(params[1], prefill_kw={"decode_channel": ch})
    try:
        _fallback_session(t.ep, *prompts["p8"], "kv_probe_failed")
    finally:
        t.stop()
        plain.stop()
        ch.close()


def test_fallback_model_mismatch(params, prompts):
    """The decode tier serves another model (depth 3): refused at the
    fingerprint, before any page moves."""
    cfg2 = {**CFG, "depth": 3}
    jp2 = jlm.init_params(jax.random.PRNGKey(9), jlm.LMConfig(**cfg2))
    tp2 = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp2),
                            device="cpu")
    t = _Tiers(params[1], decode_cfg=cfg2, decode_params=tp2)
    try:
        _fallback_session(t.ep, *prompts["p8"], "kv_model_mismatch")
        assert t.dec._batcher is None
    finally:
        t.stop()


def test_fallback_stream_not_local(params, prompts):
    """A handoff naming a stream the decode tier cannot resolve falls back
    under ``kv_stream_not_local`` and settles its leases."""
    t = _Tiers(params[1])
    try:
        p = prompts["p8"][0]
        pages, ctx_len = _prefilled_pages(t, p)
        res = t.pre.transport.handoff(t.dch, 999_999_999_999, ctx_len,
                                      int(p[-1]), 4,
                                      t.pre.model_fingerprint(), pages)
        assert (res.ok, res.reason, res.ambiguous) \
            == (False, "kv_stream_not_local", False)
        assert _fallback_counts() == {"kv_stream_not_local": 1}
        assert tpages.process_kv_store().outstanding() == 0
    finally:
        t.stop()


@pytest.mark.parametrize("peer,reason", [
    ("same-host-no-shm", "kv_shm_unavailable"),
    ("same-host-shm", "kv_shm_unavailable"),
    ("other-host", "kv_peer_remote")])
def test_fallback_lane_demotions(params, prompts, monkeypatch, peer, reason):
    """A peer outside this process.  On this host the shm lane is next: a
    peer that offers it gets it while this process's lane is on, and the
    copy lane under ``kv_shm_unavailable`` once the lane is off; a peer
    that offers no ring gets the copy lane under that reason at once.  On
    another host (the prefill side's host token patched) there is no
    fabric.  Each handoff completes, on the lane named."""
    t = _Tiers(params[1])
    try:
        host = ttr._host_token()
        if peer == "other-host":
            monkeypatch.setattr(ttr, "_host_token", lambda: b"prefill-host")
        # a synthetic probe answer: a domain this process cannot reach
        t.pre.transport._peers[t.dch] = (
            (b"0" * 16, host, peer == "same-host-shm"),
            time.monotonic() + TIMEOUT)
        if peer == "same-host-shm" and tshm.lane_enabled():
            p, want = prompts["p8"]
            toks, close_reason, _ = _stream_decode(t.ep, p, N)
            assert (toks, close_reason) == (want[:N], "finished")
            assert ttr.kv_stats()["shm_sessions"] == 1
            assert _fallback_counts() == {}
            assert tshm.outstanding_tx_slots() == 0
            monkeypatch.setattr(tshm, "lane_enabled", lambda: False)
        _fallback_session(t.ep, *prompts["p8"], reason, lands="copy")
    finally:
        t.stop()


def test_fallback_pages_exhausted(params, prompts):
    """An export table smaller than one session demotes to the copy lane
    under ``kv_pages_exhausted`` and settles the partial export."""
    old = get_flag("kv_pages")
    assert set_flag("kv_pages", 2)
    tpages._reset_for_tests()
    t = _Tiers(params[1])
    try:
        _fallback_session(t.ep, *prompts["p8"], "kv_pages_exhausted",
                          lands="copy")
    finally:
        t.stop()
        set_flag("kv_pages", old)


def test_fallback_disabled_flag(params, prompts):
    assert set_flag("kv_transfer_enabled", False)
    t = _Tiers(params[1])
    try:
        _fallback_session(t.ep, *prompts["p8"], "kv_disabled", lands="copy")
    finally:
        t.stop()
        assert set_flag("kv_transfer_enabled", True)


def test_fallback_copy_lane_over_the_frame_cap(params, prompts):
    """A copy-lane handoff larger than ``max_body_size`` is refused where
    it is framed (EREQUEST, before any byte is sent): named
    ``kv_import_rejected``, not ambiguous, so the session decodes locally
    on the same cache and the stream finishes."""
    page_bytes = tlm.kv_page_specs(tlm.LMConfig(**CFG))[0][2]
    old = get_flag("max_body_size")
    t = _Tiers(params[1], lane="copy")
    try:
        assert set_flag("max_body_size", 2 * page_bytes)
        _fallback_session(t.ep, *prompts["p8"], "kv_import_rejected")
        assert t.pre.batcher().steps_run() >= N
        assert t.dec._batcher is None
    finally:
        set_flag("max_body_size", old)
        t.stop()


def test_strict_tier_closes_with_named_reason(params, prompts):
    """``fallback_local=False``: a failed handoff refuses the session, the
    stream closing ``kv_handoff_failed`` and the call answering
    EINTERNAL."""
    t = _Tiers(params[1], prefill_kw={"decode_channel": None,
                                      "fallback_local": False})
    try:
        toks, reason, c = _stream_decode(t.ep, prompts["p8"][0], 4,
                                         expect_ok=False)
        assert c.failed and c.error_code == int(Errno.EINTERNAL)
        assert "kv_no_decode_tier" in c.error_text
        assert (toks, reason) == ([], "kv_handoff_failed")
        assert t.pre._batcher is None
    finally:
        t.stop()


# -- paged and spec decode tiers

@pytest.mark.parametrize("lane", [None, "copy"], ids=["auto-ici", "copy"])
def test_two_tier_into_paged_decode_tier(params, prompts, monolithic, lane):
    """The imported cache lands in the paged tier's pages (no prefix
    lookup, no insert, no prefill); tokens stay monolithic."""
    ev0 = tpages.prefix_event_counters()
    t = _Tiers(params[1], lane=lane,
               decode_kw={"paged": True, "page": 4})
    try:
        for key in ("p8", "p11", "p8"):
            assert _stream_decode(t.ep, prompts[key][0], N)[:2] \
                == monolithic[key]
        bst = t.dec.batcher().kv_stats()
        assert bst["paged"] and bst["steps"] >= N
        assert bst["prefills_run"] == 0
        assert bst["alloc"]["in_use"] == 0
        # ctx + N rows: 13 (p8) and 16 (p11), 4 pages of 4 tokens each
        assert bst["alloc"]["peak_in_use"] >= 4
        assert bst["prefix"]["nodes"] == 0
        assert tpages.prefix_event_counters() == ev0
        assert ttr.kv_stats()[f"{lane or 'ici'}_sessions"] == 3
        assert tpages.outstanding_pages() == 0
    finally:
        t.stop()


def test_two_tier_into_spec_decode_tier_runs_plain_rounds(params, prompts,
                                                          monolithic):
    """A spec decode tier (``spec_decode_k=3``, self-draft) takes an
    imported session, which has no prompt for the draft: every round
    while it is live falls back to a plain step, with the same tokens."""
    t = _Tiers(params[1], decode_kw={
        "paged": True, "page": 4, "spec_decode_k": 3,
        "draft_params": params[1]})
    sp0 = tsvc.spec_counters()
    try:
        assert _stream_decode(t.ep, prompts["p8"][0], N)[:2] \
            == monolithic["p8"]
    finally:
        t.stop()
    sp = {k: v - sp0[k] for k, v in tsvc.spec_counters().items()}
    assert sp["spec_round"] == 0 and sp["spec_fallback_plain"] >= N
    assert t.dec._batcher.prefills_run == 0


# -- the batcher's import path alone

class _StubStream:
    """What the batcher uses of a server stream."""

    def __init__(self):
        self.options = StreamOptions()
        self.closed = False
        self.tokens = []
        self.reason = None
        self.done = threading.Event()

    def write(self, data):
        self.tokens.append(tsvc.unpack_token(data))
        return 0

    def close(self, reason=None):
        self.closed = True
        self.reason = reason
        self.done.set()


@pytest.mark.parametrize("kw", [
    {}, {"prefill_chunk_tokens": 4},
    {"paged": True, "page": 4},
    {"paged": True, "page": 4, "prefill_chunk_tokens": 4,
     "spec_decode_k": 2}],
    ids=["contiguous", "chunked", "paged", "paged-chunked-spec"])
def test_join_imported_gives_the_fresh_sessions_tokens(params, prompts, kw,
                                                       monkeypatch):
    """An imported session (a prefill's cache and the prompt's last token)
    and a fresh session of the same prompt stream the same tokens in one
    batcher; the imported one runs no prefill and no chunk slice, and its
    timeline's source is ``imported``."""
    tp = params[1]
    cfg = tlm.LMConfig(**CFG)
    if kw.get("spec_decode_k"):
        kw = {**kw, "draft_params": tp}
    bat = tsvc.ContinuousBatcher(cfg, tp, slots=2, device="cpu", **kw)
    p, want = prompts["p11"]
    pre = tlm.make_decode(cfg, device="cpu")[0]
    with torch.inference_mode():
        cache1, ctx_len = tsvc.bucketed_prefill(
            lambda ids: pre(tp, ids), cfg, p)
    sources = []
    real_open = tsvc._lmt.open_timeline

    def open_timeline(*a):
        tl = real_open(*a)
        sources.append(tl.prefix)
        return tl

    monkeypatch.setattr(tsvc._lmt, "open_timeline", open_timeline)
    slices = tsvc.sched_counters()["sched_chunk_slice"]
    try:
        imp, fresh = _StubStream(), _StubStream()
        bat.join_imported(imp, int(p[-1]), ctx_len, N, cache1)
        assert imp.done.wait(TIMEOUT)
        assert bat.prefills_run == 0
        assert tsvc.sched_counters()["sched_chunk_slice"] == slices
        bat.join(fresh, p, N)
        assert fresh.done.wait(TIMEOUT)
    finally:
        assert bat.shutdown()
    assert sources == ["imported", "fresh"]
    assert (imp.tokens, imp.reason) == (want[:N], "finished")
    assert (fresh.tokens, fresh.reason) == (want[:N], "finished")
    assert bat.prefills_run == 1
    if kw.get("prefill_chunk_tokens"):
        assert tsvc.sched_counters()["sched_chunk_slice"] > slices


# -- across the packages

def _jax_reset():
    jpages._reset_for_tests()
    jtr._reset_for_tests()


def test_jax_prefill_tier_to_port_decode_tier(params, prompts):
    """A JAX ``PrefillService`` pointed at the port's decode tier: the
    probe, the manifest and the fingerprint interoperate, the lane is
    shm (the port's probe offers its ring; copy under
    ``kv_shm_unavailable`` where a package has none), and the import ends
    at the auth check (``kv_stream_not_local``: each package keys its own
    tag), so the JAX tier decodes locally with ``generate``'s tokens."""
    jp, tp = params
    _jax_reset()
    dec = tsvc.LMService(cfg=tlm.LMConfig(**CFG), params=tp, device="cpu",
                         decode_slots=4)
    dsrv = Server()
    assert dsrv.add_service(dec, name="LM") == 0
    assert dsrv.add_service(DecodeTierService(dec), name="KV") == 0
    assert dsrv.start("127.0.0.1:0") == 0
    dch = JChannel()
    dch.init(str(dsrv.listen_endpoint))
    pre = JPrefillService(cfg=jlm.LMConfig(**CFG), params=jp,
                          decode_channel=dch, transport=JKvTransport(),
                          decode_slots=4)
    psrv = JServer()
    assert psrv.add_service(pre, name="LM") == 0
    assert psrv.start("127.0.0.1:0") == 0
    try:
        p, want = prompts["p8"]
        assert _stream_decode(psrv.listen_endpoint, p, N)[:2] \
            == (want[:N], "finished")
        fb = jtr.kv_fallback_counters()
        assert (fb["kv_stream_not_local"], fb["kv_shm_unavailable"]) \
            == (1, 0 if _both_rings() else 1)
        assert jshm.outstanding_tx_slots() == 0
        assert fb["kv_probe_failed"] == fb["kv_model_mismatch"] == 0
        assert jtr.kv_stats()["local_fallbacks"] == 1
        assert dec._batcher is None            # the port seated nothing
    finally:
        psrv.stop()
        dsrv.stop()
        _jax_reset()


def _both_rings() -> bool:
    """Both packages' shm lanes are up here, so each prefill tier takes
    the shm lane to the other's decode tier (it stages its pages in its
    own ring and settles them after the refusal)."""
    return tshm.lane_enabled() and jshm.lane_enabled()


def test_port_prefill_tier_to_jax_decode_tier(params, prompts):
    """The port's ``PrefillService`` pointed at the JAX decode tier: the
    same path the other way (the shm lane, or the copy lane under
    ``kv_shm_unavailable`` where a package has no ring; then
    ``kv_stream_not_local``), decoded locally by the port."""
    jp, tp = params
    _jax_reset()
    dec = jsvc.LMService(cfg=jlm.LMConfig(**CFG), params=jp, decode_slots=4)
    dsrv = JServer()
    assert dsrv.add_service(dec, name="LM") == 0
    assert dsrv.add_service(JDecodeTierService(dec), name="KV") == 0
    assert dsrv.start("127.0.0.1:0") == 0
    dch = Channel()
    dch.init(str(dsrv.listen_endpoint))
    pre = PrefillService(cfg=tlm.LMConfig(**CFG), params=tp, device="cpu",
                         decode_channel=dch, decode_slots=4)
    psrv = Server()
    assert psrv.add_service(pre, name="LM") == 0
    assert psrv.start("127.0.0.1:0") == 0
    try:
        p, want = prompts["p8"]
        assert _stream_decode(psrv.listen_endpoint, p, N)[:2] \
            == (want[:N], "finished")
        assert _fallback_counts() == (
            {"kv_stream_not_local": 1} if _both_rings() else
            {"kv_stream_not_local": 1, "kv_shm_unavailable": 1})
        assert tshm.outstanding_tx_slots() == 0
        assert ttr.kv_stats()["local_fallbacks"] == 1
        assert jtr.kv_stats()["sessions"] == 0
    finally:
        psrv.stop()
        dsrv.stop()
        dch.close()
        if pre._batcher is not None:
            assert pre._batcher.shutdown()
        _jax_reset()


def test_jax_over_cap_copy_lane_diverges(params, prompts):
    """Pinned divergence.  The JAX package checks the frame cap only where
    a frame is received: its over-cap copy-lane handoff reaches the decode
    tier, which drops the connection, so the failure is ambiguous and even
    a ``fallback_local`` prefill tier closes the stream
    ``kv_handoff_failed`` (EINTERNAL, no token).  The port refuses the
    frame at send (EREQUEST), so the same session decodes locally and
    finishes (``test_fallback_copy_lane_over_the_frame_cap``)."""
    jp = params[0]
    _jax_reset()
    dec = jsvc.LMService(cfg=jlm.LMConfig(**CFG), params=jp, decode_slots=4)
    dsrv = JServer()
    assert dsrv.add_service(dec, name="LM") == 0
    assert dsrv.add_service(JDecodeTierService(dec), name="KV") == 0
    assert dsrv.start("127.0.0.1:0") == 0
    dch = JChannel()
    dch.init(str(dsrv.listen_endpoint))
    pre = JPrefillService(cfg=jlm.LMConfig(**CFG), params=jp,
                          decode_channel=dch,
                          transport=JKvTransport(force_lane="copy"),
                          decode_slots=4)
    psrv = JServer()
    assert psrv.add_service(pre, name="LM") == 0
    assert psrv.start("127.0.0.1:0") == 0
    page_bytes = jlm.kv_page_specs(jlm.LMConfig(**CFG))[0][2]
    old = jget_flag("max_body_size")
    try:
        assert pre.transport.peer_info(dch) is not None
        jset_flag("max_body_size", 2 * page_bytes)
        toks, reason, c = _stream_decode(psrv.listen_endpoint,
                                         prompts["p8"][0], N,
                                         expect_ok=False)
        assert c.failed and c.error_code == int(Errno.EINTERNAL)
        assert "kv_import_rejected" in c.error_text
        assert (toks, reason) == ([], "kv_handoff_failed")
        assert jtr.kv_fallback_counters()["kv_import_rejected"] == 1
    finally:
        jset_flag("max_body_size", old)
        psrv.stop()
        dsrv.stop()
        _jax_reset()
