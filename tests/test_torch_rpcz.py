"""The port's rpcz (spans, the span store, sampling, the W3C trace-context
helpers, the sqlite persistence) and its per-method status, on the CPU,
held against the JAX package's rpcz in the same process.

- a span's ``describe()`` has the JAX package's keys, and the traceparent
  helpers give the JAX package's answers on the same inputs;
- the persistence cases of ``tests/test_rpcz_persist.py`` (browse by time,
  survive the in-memory store, uint64 trace ids), and a traced call
  through the port's Server and Channel browsed from the file;
- the tpu_std server path: a traced call records a client and a server
  span (parentage, sizes, annotations, remote side); an untraced one is
  sampled under ``rpcz_max_samples_per_second``; a failing method's span
  and MethodStatus carry its error; ``enable_rpcz`` off stops collection;
- each method's MethodStatus is exposed (``rpc_server_<svc>_<method>``)
  and counts every call once, as the JAX package's server does.
"""

import time

import pytest

from brpc_tpu import rpcz as jrpcz
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import Controller as JController
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu_torch import rpcz as trpcz
from brpc_tpu_torch.butil.flags import get_flag, set_flag
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.bvar import find_exposed, render_prometheus
from brpc_tpu_torch.bvar import tick_once_for_tests
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.rpcz import Span, browse_persisted, global_span_store
from brpc_tpu_torch.server import Server, Service


class Traced(Service):
    def Work(self, cntl, request):
        cntl.annotate("step-one")
        cntl.annotate("step-two")
        cntl.response_attachment = b"att" * 5
        return b"done"

    def Fail(self, cntl, request):
        raise RuntimeError("boom")


@pytest.fixture()
def server():
    global_span_store().clear()
    srv = Server()
    assert srv.add_service(Traced()) == 0
    assert srv.start("127.0.0.1:0") == 0
    ch = Channel()
    assert ch.init(str(srv.listen_endpoint)) == 0
    yield srv, ch
    ch.close()
    srv.stop()
    global_span_store().clear()


def _call(ch, method, payload=b"payload", trace_id=0, att=b""):
    cntl = Controller()
    cntl.timeout_ms = 10_000
    cntl.trace_id = trace_id
    cntl.request_attachment = att
    return ch.call_method(method, payload, cntl=cntl)


# -- spans and trace context, against the JAX package ------------------------

def test_span_describe_has_jax_keys():
    spans = []
    for mod in (jrpcz, trpcz):
        s = mod.Span("S.M", trace_id=0x77, parent_span_id=5, is_server=False)
        s.annotate("note")
        s.request_size, s.response_size = 10, 20
        s.finish(3)
        spans.append(s.describe())
        mod.global_span_store().clear()
    jd, td = spans
    assert set(td) == set(jd)
    same = {"trace_id", "parent_span_id", "method", "remote", "error_code",
            "request_size", "response_size", "side"}
    assert {k: td[k] for k in same} == {k: jd[k] for k in same}
    assert [a["text"] for a in td["annotations"]] == ["note"]
    assert td["latency_us"] == td["end_us"] - td["received_us"] >= 0


TRACEPARENT_INPUTS = [
    "00-000000000000000000000000deadbeef-0000000000001234-01",
    b"00-000000000000000000000000deadbeef-0000000000001234-01",
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-00",      # 128-bit foreign id
    "ff-" + "12" * 16 + "-" + "34" * 8 + "-01-extra",  # unknown version
    "", "00-zz-11-00", "00-" + "0" * 32 + "-" + "0" * 16 + "-00",
    "garbage", None, b"\xff\xfe",
]


@pytest.mark.parametrize("value", TRACEPARENT_INPUTS,
                         ids=[str(i) for i in range(len(TRACEPARENT_INPUTS))])
def test_parse_traceparent_matches_jax(value):
    assert trpcz.parse_traceparent(value) == jrpcz.parse_traceparent(value)


@pytest.mark.parametrize("ids", [(0xDEADBEEF, 0x1234), (1, 0),
                                 ((1 << 64) - 1, (1 << 64) - 1),
                                 ((1 << 63) + 5, 1 << 47)])
def test_format_traceparent_round_trips_like_jax(ids):
    v = trpcz.format_traceparent(*ids)
    assert v == jrpcz.format_traceparent(*ids)
    assert trpcz.parse_traceparent(v) == ids


def test_backdate_span_moves_the_receive_stamp():
    s = Span("S.Backdated", trace_id=1)
    start = s.start_us
    recv_ns = time.monotonic_ns() - 5_000_000
    trpcz.backdate_span(s, recv_ns)
    assert start - s.received_us >= 5_000 and s.start_us == start
    assert s.mono_ns == recv_ns
    trpcz.backdate_span(None, recv_ns)       # no span: nothing to do
    global_span_store().clear()


def test_store_keeps_the_newest_spans_by_trace():
    store = global_span_store()
    store.clear()
    keep = get_flag("rpcz_keep_spans")
    assert set_flag("rpcz_keep_spans", 3)
    try:
        for i in range(5):
            Span(f"S.K{i}", trace_id=0x500 + i % 2).finish()
        assert [s.full_method for s in store.recent()] == \
            ["S.K2", "S.K3", "S.K4"]
        assert [s.full_method for s in store.by_trace(0x500)] == \
            ["S.K2", "S.K4"]
        assert [s.full_method for s in store.by_trace(0x500, limit=1)] \
            == ["S.K4"]
    finally:
        set_flag("rpcz_keep_spans", keep)
        store.clear()


# -- persistence (tests/test_rpcz_persist.py's cases) ------------------------

@pytest.fixture()
def rpcz_dir(tmp_path):
    d = str(tmp_path / "rpcz")
    assert set_flag("rpcz_dir", d)
    store = global_span_store()
    store.clear()
    yield d
    store.flush_now()
    set_flag("rpcz_dir", "")
    store.clear()


def test_span_persists_and_browses_by_time(rpcz_dir):
    t0 = int(time.time() * 1e6)
    early = Span("S.Old", trace_id=0x11)
    early.received_us = t0 - 10_000_000
    early.annotate("ancient")
    early.finish()
    late = Span("S.New", trace_id=0x12)
    late.finish(error_code=7)
    global_span_store().flush_now()
    assert {"S.Old", "S.New"} <= {s["method"]
                                  for s in browse_persisted(limit=10)}
    recent = browse_persisted(start_us=t0 - 1_000_000, limit=10)
    assert {s["method"] for s in recent} == {"S.New"}
    assert recent[0]["error_code"] == 7
    old = browse_persisted(end_us=t0 - 1_000_000, limit=10)
    assert {s["method"] for s in old} == {"S.Old"}
    assert old[0]["annotations"][0]["text"] == "ancient"


def test_spans_survive_the_in_memory_store(rpcz_dir):
    import os
    Span("Dead.Rank", trace_id=0x13).finish()
    store = global_span_store()
    store.flush_now()
    store.clear()
    assert store.recent() == []
    assert any(r["method"] == "Dead.Rank" for r in browse_persisted(limit=5))
    assert any(f.startswith("rpcz.") and f.endswith(".db")
               for f in os.listdir(rpcz_dir))


def test_uint64_trace_ids_persist(rpcz_dir):
    big = (1 << 63) + 12345
    Span("Big.Id", trace_id=big).finish()
    Span("Small.Id", trace_id=0x42).finish()
    global_span_store().flush_now()
    spans = browse_persisted(limit=10)
    assert {"Big.Id", "Small.Id"} <= {r["method"] for r in spans}
    (rec,) = [r for r in spans if r["method"] == "Big.Id"]
    assert int(rec["trace_id"], 16) == big
    assert [r["method"] for r in browse_persisted(limit=10, trace_id=big)] \
        == ["Big.Id"]


def test_persisted_records_have_jax_columns(rpcz_dir):
    """The port's sqlite file holds the JAX package's columns: a JAX
    reader browses a port file, and the record keys agree."""
    Span("Port.Row", trace_id=0x14).finish()
    global_span_store().flush_now()
    (mine,) = browse_persisted(limit=5)
    (theirs,) = jrpcz.browse_persisted(limit=5, rpcz_dir=rpcz_dir)
    assert set(mine) == set(theirs)
    assert theirs["method"] == "Port.Row" and theirs["trace_id"] == "14"


def test_traced_call_browsed_from_the_file(rpcz_dir, server):
    srv, ch = server
    assert not _call(ch, "Traced.Work", trace_id=0xABCD).failed
    global_span_store().flush_now()
    rows = browse_persisted(limit=50, trace_id=0xABCD)
    assert sorted(r["side"] for r in rows) == ["client", "server"]
    assert {r["method"] for r in rows} == {"Traced.Work"}


# -- the tpu_std server path -------------------------------------------------

def test_traced_call_records_client_and_server_spans(server):
    srv, ch = server
    c = _call(ch, "Traced.Work", trace_id=0xABCDEF, att=b"x" * 7)
    assert not c.failed and c.response == b"done"
    spans = global_span_store().by_trace(0xABCDEF)
    (s,) = [s for s in spans if s.is_server]
    (cs,) = [s for s in spans if not s.is_server]
    assert s.full_method == cs.full_method == "Traced.Work"
    assert s.parent_span_id == cs.span_id
    assert c.span_id == cs.span_id            # the controller's hop id
    assert s.request_size == len(b"payload") + 7
    assert s.response_size == len(b"done") + 15
    assert [t for _, t in s.annotations] == ["step-one", "step-two"]
    assert s.error_code == cs.error_code == 0
    assert s.received_us <= s.start_us <= s.end_us
    assert cs.remote_side == str(srv.listen_endpoint)
    assert s.remote_side.startswith("127.0.0.1:")


def test_failed_method_span_and_status_carry_the_error(server):
    srv, ch = server
    st = srv.method_status("Traced.Fail")
    c = _call(ch, "Traced.Fail", trace_id=0xFA11)
    assert c.error_code == int(Errno.EINTERNAL)
    spans = global_span_store().by_trace(0xFA11)
    assert sorted((s.is_server, s.error_code) for s in spans) == \
        [(False, int(Errno.EINTERNAL)), (True, int(Errno.EINTERNAL))]
    assert st.errors.get_value() == 1 and st.latency.count() == 0
    assert st.inflight == 0
    # an unknown method has no status and no span
    assert _call(ch, "Traced.Nope", trace_id=0xFA12).error_code == \
        int(Errno.ENOMETHOD)
    assert srv.method_status("Traced.Nope") is None
    assert [s.is_server for s in global_span_store().by_trace(0xFA12)] \
        == [False]


def test_untraced_calls_sampled_under_the_budget(server):
    srv, ch = server
    budget = get_flag("rpcz_max_samples_per_second")
    window = list(trpcz._sample_window)
    try:
        assert set_flag("rpcz_max_samples_per_second", 0)
        trpcz._sample_window[0] = 0.0      # the next call opens a window
        assert not _call(ch, "Traced.Work").failed
        assert global_span_store().recent() == []
        assert not _call(ch, "Traced.Work", trace_id=0x5A).failed
        assert len(global_span_store().by_trace(0x5A)) == 2   # forced
        assert set_flag("rpcz_max_samples_per_second", 1000)
        trpcz._sample_window[0] = 0.0
        global_span_store().clear()
        assert not _call(ch, "Traced.Work").failed
        (s,) = global_span_store().recent()
        # a sampled untraced call: its own trace, no parent, no client span
        assert s.is_server and s.parent_span_id == 0 and not s.forced
    finally:
        set_flag("rpcz_max_samples_per_second", budget)
        trpcz._sample_window[:] = window


def test_enable_rpcz_flag_stops_collection(server):
    srv, ch = server
    assert set_flag("enable_rpcz", "false")
    try:
        assert not _call(ch, "Traced.Work", trace_id=0xD15).failed
        assert global_span_store().recent() == []
    finally:
        assert set_flag("enable_rpcz", "true")
    assert not _call(ch, "Traced.Work", trace_id=0xD16).failed
    assert len(global_span_store().by_trace(0xD16)) == 2


def test_method_status_counts_each_call_like_jax():
    """Five good calls and two failing ones: the port's MethodStatus and
    the JAX server's read the same counts, and the port exposes its
    recorder and error counter under the JAX package's names (a service
    name of its own keeps them apart from other tests' servers)."""

    class JCounted(JService):
        def Work(self, cntl, request):
            return b"done"

        def Fail(self, cntl, request):
            raise RuntimeError("boom")

    srv, jsrv = Server(), JServer()
    assert srv.add_service(Traced(), name="Counted") == 0
    jsrv.add_service(JCounted(), name="Counted")
    assert srv.start("127.0.0.1:0") == 0
    assert jsrv.start("127.0.0.1:0") == 0
    ch, jch = Channel(), JChannel()
    ch.init(str(srv.listen_endpoint))
    jch.init(str(jsrv.listen_endpoint))

    def jcall(method):
        jc = JController()
        jc.timeout_ms = 10_000
        return jch.call_method(method, b"payload", cntl=jc)

    try:
        for _ in range(5):
            assert not _call(ch, "Counted.Work").failed
            assert not jcall("Counted.Work").failed
        for _ in range(2):
            assert _call(ch, "Counted.Fail").failed
            assert jcall("Counted.Fail").failed
        mine = srv.method_status("Counted.Work")
        theirs = jsrv.find_method("Counted", "Work").status
        assert mine.latency.count() == theirs.latency.count() == 5
        fails = (srv.method_status("Counted.Fail"),
                 jsrv.find_method("Counted", "Fail").status)
        assert [f.errors.get_value() for f in fails] == [2, 2]
        assert mine.full_name == theirs.full_name == "Counted.Work"
        assert mine.inflight == theirs.inflight == 0
        tick_once_for_tests()
        assert find_exposed("rpc_server_counted_work") is mine.latency
        assert find_exposed("rpc_server_counted_fail_error") \
            is fails[0].errors
        text = render_prometheus()
        assert "rpc_server_counted_work_count 5" in text
        assert 'rpc_server_counted_work_latency{quantile="0.99"}' in text
    finally:
        ch.close()
        srv.stop()
        jsrv.stop()
        global_span_store().clear()
        jrpcz.global_span_store().clear()
