"""The port's fleet plane held against the JAX package's, on the CPU
(after ``tests/test_fleet.py``): the closed ``FLEET_EVENTS`` (equal to
the JAX tuple), the flight-recorder ring, the one-build-per-interval
report cache, registry TTL/drain semantics, federation through
``federate(fetch=)`` (the portal's HTTP reads are cut: ``Fleet.List``
over RPC and each member's ``render_prometheus()`` stand in), the
KV.Probe load-report tail parsed across the packages both ways, a port
reporter into a JAX registry and the reverse, a load report's keys equal
to the JAX package's for a server hosting a paged ``LMService``, and the
3-process soak with port members."""

import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from brpc_tpu import fleet as jfleet
from brpc_tpu.kv import transport as jtransport
from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu_torch import fleet
from brpc_tpu_torch.bvar.prometheus import render_prometheus
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.kv import transport as ttransport
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.server.service import Service
from brpc_tpu_torch.utils.convert import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_fleet():
    fleet._reset_for_tests()
    jfleet._reset_for_tests()
    yield
    fleet._reset_for_tests()
    jfleet._reset_for_tests()


# ---------------------------------------------------------------------------
# Flight recorder: closed enum + bounded ring
# ---------------------------------------------------------------------------

FLEET_EVENT_PINS = (
    "fleet_restart",
    "fleet_drain",
    "fleet_lame_duck",
    "fleet_stop",
    "fleet_register",
    "fleet_deregister",
    "fleet_member_stale",
    "fleet_breaker_trip",
    "fleet_kv_handoff_failed",
    "fleet_kv_evict",
    "fleet_host_spill",
)


def test_fleet_events_closed_pinned_and_equal_jax():
    assert fleet.FLEET_EVENTS == jfleet.FLEET_EVENTS
    assert set(FLEET_EVENT_PINS) == set(fleet.FLEET_EVENTS)
    assert fleet.LOAD_REPORT_VERSION == jfleet.LOAD_REPORT_VERSION
    assert fleet.FLEET_MEMBER_STATES == jfleet.FLEET_MEMBER_STATES
    for e in FLEET_EVENT_PINS:
        fleet.record_event(e, "pin")
    counts = fleet.event_counters()
    for e in FLEET_EVENT_PINS:
        assert counts[e] == 1, e
    with pytest.raises(AssertionError):
        fleet.record_event("fleet_" + "unregistered")


def test_flight_recorder_ring_bounded():
    fleet._reset_for_tests(ring=8)
    for i in range(30):
        fleet.record_event("fleet_kv_evict", f"n{i}")
    rows = fleet.recent_events(100)
    assert len(rows) == 8
    assert rows[-1]["detail"] == "n29"
    assert rows[0]["detail"] == "n22"
    assert fleet.event_counters()["fleet_kv_evict"] == 30


def test_flight_recorder_flag_gated():
    from brpc_tpu_torch.butil.flags import set_flag
    set_flag("fleet_obs", False)
    try:
        fleet.record_event("fleet_kv_evict", "off")
        assert fleet.event_counters()["fleet_kv_evict"] == 0
        assert fleet.recent_events() == []
    finally:
        set_flag("fleet_obs", True)
    fleet.record_event("fleet_kv_evict", "on")
    assert fleet.event_counters()["fleet_kv_evict"] == 1


def test_kv_evict_records_its_event():
    from brpc_tpu_torch.kv import pages
    pages.count_evict("kv_pool_exhausted")
    rows = fleet.recent_events()
    assert rows[-1]["event"] == "fleet_kv_evict"
    assert rows[-1]["detail"] == "kv_pool_exhausted"


# ---------------------------------------------------------------------------
# Load report + snapshot cache
# ---------------------------------------------------------------------------

def test_load_report_shape_equal_jax():
    r = fleet.build_load_report()
    assert r["v"] == fleet.LOAD_REPORT_VERSION
    assert r["drain"] == "serving"
    assert isinstance(r["events"], list)
    assert isinstance(r["trace_roots"], list)
    assert r["busy_ratio"] is None
    assert fleet.build_load_report()["seq"] == r["seq"] + 1
    assert set(r) == set(jfleet.build_load_report())


def test_report_cache_one_build_per_interval():
    cache = fleet.report_cache()
    for _ in range(20):
        cache.get()
    assert cache.builds == 1


def test_probe_response_carries_report_tail():
    report = fleet.build_load_report()
    report["instance"] = "10.0.0.1:99"
    data = ttransport.encode_probe_response(report=report)
    cap = ttransport.decode_probe_response(data)
    assert cap is not None and isinstance(cap[2], bool)
    tail = ttransport.decode_probe_report(data)
    assert tail is not None
    assert tail["instance"] == "10.0.0.1:99"
    assert tail["v"] == fleet.LOAD_REPORT_VERSION
    bare = ttransport.encode_probe_response()
    assert ttransport.decode_probe_response(bare) is not None
    assert ttransport.decode_probe_report(bare) is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_probe_tail_parses_across_packages(writer):
    """A port probe answer's tail parses with the JAX decoder, and a JAX
    one's with the port's; the capability fields too."""
    src, dst = (ttransport, jtransport) if writer == "port" \
        else (jtransport, ttransport)
    report = {"v": 1, "instance": "10.0.0.2:7", "slots": {"free": 3}}
    data = src.encode_probe_response(report=report)
    assert dst.decode_probe_report(data) == report
    assert dst.decode_probe_response(data) == src.decode_probe_response(data)
    assert dst.decode_probe_report(src.encode_probe_response()) is None


# ---------------------------------------------------------------------------
# Registry semantics
# ---------------------------------------------------------------------------

def _mk_report(instance, drain="serving", trace_roots=()):
    r = fleet.build_load_report()
    r["instance"] = instance
    r["drain"] = drain
    r["trace_roots"] = list(trace_roots)
    return r


def test_registry_fresh_stale_draining():
    reg = fleet.FleetRegistry(ttl_s=0.4)
    assert reg.ingest(_mk_report("a:1")) == 0
    assert reg.ingest(_mk_report("b:2")) == 0
    states = {m["instance"]: m["state"] for m in reg.members()}
    assert states == {"a:1": "ok", "b:2": "ok"}
    time.sleep(0.5)
    states = {m["instance"]: m["state"] for m in reg.members()}
    assert states == {"a:1": "stale", "b:2": "stale"}
    reg.members()
    assert fleet.event_counters()["fleet_member_stale"] == 2
    assert reg.ingest(_mk_report("a:1")) == 0
    assert reg.deregister("b:2") == 0
    states = {m["instance"]: m["state"] for m in reg.members()}
    assert states == {"a:1": "ok", "b:2": "draining"}
    assert reg.ingest(_mk_report("b:2")) == 0
    assert {m["instance"]: m["state"]
            for m in reg.members()}["b:2"] == "ok"


def test_registry_rejects_unaddressable():
    reg = fleet.FleetRegistry()
    assert reg.ingest({"v": 1}) == -1
    assert reg.ingest({"instance": "a:1"}) == -1
    assert reg.ingest("junk") == -1


def test_registry_seed_from_file(tmp_path):
    p = tmp_path / "fleet.naming"
    p.write_text("10.0.0.1:80\n# comment\n10.0.0.2:80 extra\n\n")
    reg = fleet.FleetRegistry()
    assert reg.seed_from_url(f"file://{p}") == 2
    states = {m["instance"]: m["state"] for m in reg.members()}
    assert states == {"10.0.0.1:80": "seeded", "10.0.0.2:80": "seeded"}
    assert reg.ingest(_mk_report("10.0.0.1:80")) == 0
    assert {m["instance"]: m["state"]
            for m in reg.members()}["10.0.0.1:80"] == "ok"


def test_registry_trace_index():
    reg = fleet.FleetRegistry()
    reg.ingest(_mk_report("a:1", trace_roots=("dead0", "beef1")))
    reg.ingest(_mk_report("b:2", trace_roots=("beef1",)))
    assert reg.trace_owners("dead0") == ["a:1"]
    assert reg.trace_owners("beef1") == ["a:1", "b:2"]
    assert reg.trace_owners("cafe2") == []
    assert reg.trace_index()["dead0"] == ["a:1"]


def test_registry_timeline_merges_member_events():
    fleet.record_event("fleet_restart", "registry-local")
    reg = fleet.FleetRegistry()
    rep = _mk_report("a:1")
    rep["events"] = [{"seq": 1, "wall_s": time.time(),
                      "event": "fleet_drain", "detail": "member-side"}]
    reg.ingest(rep)
    rows = reg.timeline()
    assert {"a:1", "(registry)"} <= {r["instance"] for r in rows}
    assert {"fleet_drain", "fleet_restart"} <= {r["event"] for r in rows}


def test_rollups_and_outliers_equal_jax():
    regs = (fleet.FleetRegistry(), jfleet.FleetRegistry())
    for i, busy in enumerate((0.9, 0.2, 0.5)):
        rep = _mk_report(f"n:{i}")
        rep["busy_ratio"] = busy
        rep["slo"] = {"interactive": {"slo_ok": 8, "slo_ttft_miss": 2}}
        rep["slots"] = {"live": 3, "total": 8}
        for reg in regs:
            reg.ingest(dict(rep))
    roll = regs[0].rollups()
    assert roll["slo"]["interactive"]["slo_ok"] == 24
    assert roll["slots"] == {"live": 9, "total": 24}
    assert roll["top_busy"][0]["instance"] == "n:0"
    assert roll["top_slo_miss"][0]["miss_ratio"] == pytest.approx(0.2)
    assert roll == regs[1].rollups()


def _fake_fetch(instance, timeout_s=1.0):
    return '# TYPE x_total counter\nx_total 5\ny{lane="shm"} 2\n'


def test_federation_injects_instance_label_like_jax():
    reg, jreg = fleet.FleetRegistry(), jfleet.FleetRegistry()
    for r in (reg, jreg):
        r.ingest(_mk_report("a:1"))
        r.ingest(_mk_report("b:2"))
    body = reg.federate(fetch=_fake_fetch)
    assert 'x_total{instance="a:1"} 5' in body
    assert 'y{instance="b:2",lane="shm"} 2' in body
    assert 'fleet_members{state="ok"} 2' in body
    for line in body.splitlines():
        if not line or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        assert series and value, line
        float(value)
    reg.federate(fetch=_fake_fetch)
    assert reg.fed_builds == 1
    assert body == jreg.federate(fetch=_fake_fetch)


def test_federate_needs_a_fetch():
    """``federate()``'s fetch defaults to ``fetch_member_metrics``, the
    JAX package's: each live member's ``/metrics`` page over HTTP, a
    dead member's scrape logged and skipped."""
    srv = Server()
    srv.add_service(Echo(), name="E")
    assert srv.start("127.0.0.1:0") == 0
    try:
        addr = str(srv.listen_endpoint)
        reg = fleet.FleetRegistry()
        reg.ingest(_mk_report(addr))
        reg.ingest(_mk_report("127.0.0.1:1"))       # nobody listens
        body = reg.federate()
        assert f'instance="{addr}"' in body
        assert 'instance="127.0.0.1:1"' not in body
        assert 'fleet_members{state="ok"} 2' in body
        assert "# TYPE rpc_server_e_echo" in fleet.fetch_member_metrics(addr)
    finally:
        srv.stop()


def test_fleet_vars_exposed():
    from brpc_tpu_torch.bvar.variable import find_exposed
    fleet.expose_fleet_variables()
    assert find_exposed("fleet_events_total") is not None
    assert find_exposed("fleet_members") is not None
    assert find_exposed("fleet_report_builds") is not None


def test_stitch_seed_remotes():
    from brpc_tpu_torch.rpcz_stitch import collect_trace
    fetched = []

    def fake_fetch(remote, trace_id, timeout_s=2.0, limit=512):
        fetched.append(remote)
        return [{"span_id": 42, "trace_id": f"{trace_id:x}",
                 "parent_span_id": 0, "side": "server",
                 "received_us": 1}]

    out = collect_trace(0xF1EE7, fetch=fake_fetch,
                        seed_remotes=("10.9.9.9:1",))
    assert fetched == ["10.9.9.9:1"]
    assert any(s["span_id"] == 42 for s in out["spans"])
    assert out["remotes"]["10.9.9.9:1"] == "ok"


# ---------------------------------------------------------------------------
# In-process end-to-end: registry server + member server
# ---------------------------------------------------------------------------

class Echo(Service):
    def Echo(self, cntl, request):
        return request


class JEcho(Echo, JService):
    pass


def _wait(pred, timeout=10.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


def _fleet_list(addr):
    """``Fleet.List`` over RPC: the registry's member rows."""
    ch = Channel()
    assert ch.init(addr) == 0
    try:
        cntl = Controller()
        cntl.timeout_ms = 5000
        c = ch.call_method("Fleet.List", b"", cntl=cntl)
        assert not c.failed, c.error_text
        return {m["instance"]: m for m in json.loads(c.response)["members"]}
    finally:
        ch.close()


def test_fleet_end_to_end_two_servers(tmp_path):
    reg_srv = Server()
    reg_srv.add_service(Echo(), name="E")
    reg = fleet.host_registry(reg_srv, ttl_s=3.0)
    assert fleet.registry_of(reg_srv) is reg
    assert reg_srv.start("127.0.0.1:0") == 0
    mem_srv = Server()
    mem_srv.add_service(Echo(), name="E")
    assert mem_srv.start("127.0.0.1:0") == 0
    reg_addr = str(reg_srv.listen_endpoint)
    mem_addr = str(mem_srv.listen_endpoint)
    naming = tmp_path / "members"
    try:
        assert fleet.event_counters()["fleet_restart"] == 2
        assert mem_srv.publish(f"file://{naming}") == 0
        assert naming.read_text().split() == [mem_addr]
        rep = fleet.attach_reporter(mem_srv, reg_addr, interval_s=0.2)
        assert fleet.reporter_of(mem_srv) is rep
        assert _wait(lambda: any(
            m["instance"] == mem_addr and m["state"] == "ok"
            for m in reg.members()))
        row = _fleet_list(reg_addr)[mem_addr]
        assert row["state"] == "ok"
        assert row["report"]["v"] == fleet.LOAD_REPORT_VERSION
        assert row["report"]["instance"] == mem_addr
        # federation over the members' own registries
        fed = reg.federate(fetch=lambda inst, timeout_s=1.0:
                           render_prometheus())
        assert f'instance="{mem_addr}"' in fed
        assert 'fleet_members{state="ok"} 1' in fed
        # drain: unpublished, then draining within ~one interval
        assert mem_srv.drain(grace_ms=1000) in (0, -1)
        assert naming.read_text() == ""
        assert _wait(lambda: _fleet_list(reg_addr)[mem_addr]["state"]
                     == "draining", timeout=2.0)
        counts = fleet.event_counters()
        assert counts["fleet_drain"] >= 1
        assert counts["fleet_lame_duck"] >= 1
        assert counts["fleet_register"] >= 1
        assert counts["fleet_deregister"] >= 1
    finally:
        mem_srv.stop()
        reg_srv.stop()
    assert fleet.event_counters()["fleet_stop"] == 2
    assert fleet.reporter_of(mem_srv) is None


@pytest.mark.parametrize("direction", ["port_into_jax", "jax_into_port"])
def test_reporter_into_the_other_packages_registry(direction):
    """A port member registers, reports and deregisters with a JAX
    registry, and a JAX member with a port one."""
    if direction == "port_into_jax":
        reg_srv, host = JServer(), jfleet
        mem_srv, svc, member = Server(), Echo(), fleet
    else:
        reg_srv, host = Server(), fleet
        mem_srv, svc, member = JServer(), JEcho(), jfleet
    reg = host.host_registry(reg_srv, ttl_s=5.0)
    assert reg_srv.start("127.0.0.1:0") == 0
    assert mem_srv.add_service(svc, name="E") == 0
    assert mem_srv.start("127.0.0.1:0") == 0
    inst = str(mem_srv.listen_endpoint)
    try:
        member.attach_reporter(mem_srv, str(reg_srv.listen_endpoint),
                               interval_s=0.2)

        def state():
            return {m["instance"]: m["state"]
                    for m in reg.members()}.get(inst)

        assert _wait(lambda: state() == "ok")
        row = next(m for m in reg.members() if m["instance"] == inst)
        assert row["report"]["v"] == 1
        assert set(row["report"]) == set(fleet.build_load_report())
        mem_srv.drain(grace_ms=1000)
        assert _wait(lambda: state() == "draining", timeout=3.0)
    finally:
        mem_srv.stop()
        reg_srv.stop()


CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)


def _keys(report):
    """The report's keys, nested one level into its dict fields."""
    out = set(report)
    for k, v in report.items():
        if isinstance(v, dict) and k != "slo":
            out |= {f"{k}.{kk}" for kk in v}
            for kk, vv in v.items():
                if isinstance(vv, dict):
                    out |= {f"{k}.{kk}.{x}" for x in vv}
    return out


def test_report_keys_equal_jax_for_a_paged_lm_server():
    """A server hosting a paged ``LMService`` (Decode, its batcher, the
    allocator, prefix cache and host tier): the load report carries
    ``slots`` and ``kv`` with the JAX package's keys."""
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**CFG))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    kw = dict(decode_slots=2, paged=True, page=4, kv_host_slots=8)
    tservice = tsvc.LMService(cfg=tlm.LMConfig(**CFG), params=tp,
                              device="cpu", **kw)
    jservice = jsvc.LMService(cfg=jlm.LMConfig(**CFG), params=jp, **kw)
    tsrv, jsrv = Server(), JServer()
    assert tsrv.add_service(tservice, name="LM") == 0
    assert jsrv.add_service(jservice, name="LM") == 0
    assert tsrv.start("127.0.0.1:0") == 0 and jsrv.start("127.0.0.1:0") == 0
    try:
        # a report never builds a batcher: slots from the service's
        # count, no KV planes yet
        fresh = fleet.build_load_report(tsrv)
        assert tservice._batcher is None and fresh["kv"] is None
        tservice.batcher()      # the JAX report builds its batcher
        mine = fleet.build_load_report(tsrv)
        theirs = jfleet.build_load_report(jsrv)
        assert fresh["slots"] == mine["slots"]
        assert mine["slots"] == {"live": 0, "total": 2, "free": 2,
                                 "steps": 0} == theirs["slots"]
        assert mine["kv"] is not None
        assert _keys(mine) == _keys(theirs)
        assert mine["instance"] == str(tsrv.listen_endpoint)
    finally:
        tsrv.stop()
        jsrv.stop()
        if tservice._batcher is not None:
            tservice._batcher.shutdown()


# ---------------------------------------------------------------------------
# 3-process soak: register / kill -9 → stale / drain → draining
# ---------------------------------------------------------------------------

_CHILD = r"""
import sys
sys.path.insert(0, %(repo)r)
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.server.service import Service
from brpc_tpu_torch import fleet
from brpc_tpu_torch.client import Channel, Controller

class E(Service):
    def Echo(self, cntl, request):
        return request

srv = Server()
srv.add_service(E(), name="E")
assert srv.start("127.0.0.1:0") == 0
inst = str(srv.listen_endpoint)
# one traced self-call so this process holds a trace root the load
# report can index
ch = Channel()
ch.init(inst)
cntl = Controller()
cntl.timeout_ms = 5000
cntl.trace_id = %(trace_id)d
c = ch.call_method("E.Echo", b"traced", cntl=cntl)
assert not c.failed, c.error_text
fleet.attach_reporter(srv, %(registry)r, interval_s=0.25)
print("PORT=%%d" %% srv.listen_endpoint.port, flush=True)
for line in sys.stdin:
    if line.strip() == "drain":
        srv.drain(grace_ms=1000)
        print("DRAINED", flush=True)
srv.stop()
"""


def _spawn_child(registry_addr, trace_id):
    proc = subprocess.Popen(
        [sys.executable, "-c",
         _CHILD % {"repo": REPO, "registry": registry_addr,
                   "trace_id": trace_id}],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    port = [None]

    def _read():
        for line in proc.stdout:
            if line.startswith("PORT="):
                port[0] = int(line.strip().split("=", 1)[1])
                return

    reader = threading.Thread(target=_read, daemon=True)
    reader.start()
    reader.join(timeout=120)
    if port[0] is None:
        proc.kill()
        raise RuntimeError("fleet child did not report a port")
    return proc, f"127.0.0.1:{port[0]}"


def test_three_process_fleet_soak():
    reg_srv = Server()
    reg = fleet.host_registry(reg_srv, ttl_s=2.0)
    assert reg_srv.start("127.0.0.1:0") == 0
    reg_addr = str(reg_srv.listen_endpoint)
    t1, t2 = 0xF1EE70001, 0xF1EE70002
    p1 = p2 = None
    try:
        p1, a1 = _spawn_child(reg_addr, t1)
        p2, a2 = _spawn_child(reg_addr, t2)

        def _states():
            return {m["instance"]: m["state"] for m in reg.members()}

        assert _wait(lambda: _states().get(a1) == "ok"
                     and _states().get(a2) == "ok", timeout=30.0), \
            _states()
        rows = _fleet_list(reg_addr)
        assert rows[a1]["report"]["drain"] == "serving"
        assert rows[a1]["age_s"] < 2.0
        # the trace index finds the root-holding process
        assert reg.trace_owners(f"{t1:x}") == [a1]
        assert reg.trace_owners(f"{t2:x}") == [a2]
        # federation over live members is valid exposition
        fed = reg.federate(fetch=_fake_fetch)
        assert f'instance="{a1}"' in fed and f'instance="{a2}"' in fed
        # kill -9 one member → stale within TTL (never dropped)
        p1.kill()
        p1.wait(timeout=10)
        assert _wait(lambda: _states().get(a1) == "stale",
                     timeout=8.0), _states()
        assert _states().get(a2) == "ok"
        # drained member → draining within ~one report interval
        p2.stdin.write("drain\n")
        p2.stdin.flush()
        assert _wait(lambda: _states().get(a2) == "draining",
                     timeout=5.0), _states()
    finally:
        for p in (p1, p2):
            if p is not None:
                try:
                    p.stdin.close()
                except OSError:
                    pass
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=10)
        reg_srv.stop()


def test_report_cache_keeps_one_report_per_server():
    """Two servers in one process each get their own cached report (the
    JAX cache keeps one for the process: the second server would be
    handed the first's)."""
    a, b = Server(), Server()
    for s in (a, b):
        assert s.add_service(Echo(), name="E") == 0
        assert s.start("127.0.0.1:0") == 0
    try:
        cache = fleet.report_cache()
        ra, rb = cache.get(a), cache.get(b)
        assert ra["instance"] == str(a.listen_endpoint)
        assert rb["instance"] == str(b.listen_endpoint)
        assert cache.get(a) is ra and cache.get(b) is rb
        assert cache.builds == 2
        jcache = jfleet.report_cache()
        assert jcache.get(a)["instance"] == jcache.get(b)["instance"]
    finally:
        a.stop()
        b.stop()


def test_two_replicas_report_themselves(tmp_path):
    """Both replicas of one process register with one registry, each
    under its own instance, and each probe answer carries its own
    server's report."""
    from brpc_tpu_torch.kv.transport import decode_probe_report

    class Probe(Service):
        def Probe(self, cntl, request):
            return ttransport.encode_probe_response(
                report=fleet.report_cache().get(cntl.server))

    reg_srv = Server()
    reg = fleet.host_registry(reg_srv, ttl_s=5.0)
    assert reg_srv.start("127.0.0.1:0") == 0
    members = []
    for _ in range(2):
        s = Server()
        assert s.add_service(Probe(), name="KV") == 0
        assert s.start("127.0.0.1:0") == 0
        members.append(s)
    try:
        for s in members:
            fleet.attach_reporter(s, str(reg_srv.listen_endpoint),
                                  interval_s=0.2)
        want = {str(s.listen_endpoint) for s in members}
        assert _wait(lambda: {m["instance"] for m in reg.members()
                              if m["state"] == "ok"} == want, timeout=3.0)
        for s in members:
            ch = Channel()
            ch.init(str(s.listen_endpoint))
            c = ch.call_method("KV.Probe", b"")
            ch.close()
            assert not c.failed, c.error_text
            assert decode_probe_report(c.response)["instance"] == \
                str(s.listen_endpoint)
    finally:
        for s in members:
            s.stop()
        reg_srv.stop()
