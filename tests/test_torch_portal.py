"""The port's builtin portal against the JAX package's: every page on a
port server carrying a small CPU ``LMService``, held against a JAX
server with the same services (its native engine off, the default):
equal status and content type, equal JSON key sets or equal text where
the page is deterministic.  Then ``/hotspots`` as
``tests/test_hotspots.py`` drives it, ``rpcz_stitch``'s HTTP fetches
(``fetch_remote_spans``, ``locate_trace_root``, ``collect_trace``
without ``fetch=``) across two port servers, and ``fleet``'s
(``fetch_member_metrics``, ``fetch_member_report``)."""

import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest

from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu_torch import fleet, rpcz_stitch
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.rpcz import global_span_store
from brpc_tpu_torch.server import Server, Service
from brpc_tpu_torch.utils.convert import params_from_numpy

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)


class _Busy:
    def Spin(self, cntl, request):
        t0 = time.monotonic()
        x = 0
        while time.monotonic() - t0 < 0.3:
            x += sum(range(200))
        return b"%d" % x


class TBusy(Service, _Busy):
    pass


class JBusy(JService, _Busy):
    pass


@pytest.fixture(scope="module")
def servers():
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**CFG))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    port = Server()
    assert port.add_service(tsvc.LMService(
        cfg=tlm.LMConfig(**CFG), params=tp, device="cpu", decode_slots=2),
        name="LM") == 0
    assert port.add_service(TBusy(), name="B") == 0
    jaxs = JServer()
    assert jaxs.add_service(jsvc.LMService(
        cfg=jlm.LMConfig(**CFG), params=jp, decode_slots=2),
        name="LM") == 0
    assert jaxs.add_service(JBusy(), name="B") == 0
    for srv in (port, jaxs):
        assert srv.start("127.0.0.1:0") == 0
    srvs = {"port": port, "jax": jaxs}
    # one Generate on each, so MethodStatus, spans and /lm have data
    req = tsvc.pack_generate_request(np.arange(6).reshape(1, 6), 3)
    for srv in srvs.values():
        status, _, body = _request(srv, "POST", "/LM/Generate", req)
        assert status == 200, body
    yield srvs
    for srv in srvs.values():
        srv.stop()


def _request(srv, method, path, body=None, timeout=30):
    ep = srv.listen_endpoint
    c = http.client.HTTPConnection(ep.host, ep.port, timeout=timeout)
    try:
        c.request(method, path, body=body)
        r = c.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        c.close()


def _get(srv, path, timeout=30):
    return _request(srv, "GET", path, timeout=timeout)


def _both(servers, path):
    out = {k: _get(s, path) for k, s in servers.items()}
    (ps, ph, _), (js, jh, _) = out["port"], out["jax"]
    assert ps == js, (path, out["port"][2][:200], out["jax"][2][:200])
    assert ph.get("content-type") == jh.get("content-type"), path
    return out["port"][2], out["jax"][2]


_JSON_PAGES = ("/status", "/connections", "/fibers", "/overload",
               "/protobufs", "/rpcz", "/rpcz?trace_id=abc", "/lm",
               "/fleet", "/fleet?self=1", "/trackme?ver=0.0.1")


@pytest.mark.parametrize("path", _JSON_PAGES)
def test_json_pages_have_the_jax_keys(servers, path):
    port, jax_ = (json.loads(b) for b in _both(servers, path))
    assert set(port) == set(jax_)
    if path == "/status":
        assert set(port["services"]) == set(jax_["services"]) >= {
            "LM.Generate", "LM.Decode", "LM.Info", "B.Spin"}
        for name, row in jax_["services"].items():
            assert set(row) == set(port["services"][name])
        assert port["services"]["LM.Generate"]["count"] >= 1
    if path == "/protobufs":
        assert port == jax_
    if path in ("/fleet?self=1",):
        assert set(port["slots"] or {}) == set(jax_["slots"] or {})


_TEXT_PAGES = ("/", "/health", "/version", "/vars", "/metrics", "/flags",
               "/list_vars", "/sockets", "/threads", "/vlog", "/dir",
               "/native", "/hotspots/heap", "/hotspots/engine",
               "/hotspots/nope", "/nope", "/vars/no_such_var",
               "/rpcz?trace_id=zz", "/rpcz?limit=x")


@pytest.mark.parametrize("path", _TEXT_PAGES)
def test_text_pages_answer_as_jax(servers, path):
    port, jax_ = _both(servers, path)
    if path in ("/health", "/native", "/hotspots/engine", "/hotspots/nope",
                "/nope", "/vars/no_such_var", "/rpcz?trace_id=zz",
                "/rpcz?limit=x"):
        assert port == jax_
    if path == "/":
        want = {ln for ln in jax_.decode().splitlines()
                if ln.startswith("  /LM/") or ln.startswith("  /B/")}
        assert want <= set(port.decode().splitlines())
    if path in ("/vars", "/metrics"):
        # the LM families and the per-method recorders on both
        for name in (b"rpc_server_lm_generate", b"lm_step_phase_total",
                     b"lm_ttft_ms"):
            assert name in port and name in jax_, name


def test_metrics_page_is_the_prometheus_render(servers):
    from brpc_tpu_torch.bvar.prometheus import render_prometheus
    _, _, body = _get(servers["port"], "/metrics")
    names = {ln.split()[2] for ln in body.decode().splitlines()
             if ln.startswith("# TYPE")}
    assert names == {ln.split()[2] for ln in render_prometheus().splitlines()
                     if ln.startswith("# TYPE")}


def test_vars_expand_and_flags_on_a_port_server(servers):
    status, _, body = _get(servers["port"],
                           "/vars?expand=rpc_server_lm_generate_count")
    assert status == 200 and b"<svg" in body
    status, _, body = _get(servers["port"], "/flags/rpcz_max_samples_"
                           "per_second?setvalue=500")
    assert status == 200, body
    from brpc_tpu_torch.butil.flags import get_flag, set_flag
    try:
        assert get_flag("rpcz_max_samples_per_second") == 500
    finally:
        set_flag("rpcz_max_samples_per_second", 1000)


def test_lm_page_reads_the_decode_batcher(servers):
    """After a Decode, ``/lm`` shows the batcher's KV occupancy and the
    finished session's timeline, with the JAX page's keys."""
    from brpc_tpu_torch.streaming import StreamOptions, stream_create
    srv = servers["port"]
    ch = Channel()
    ch.init(str(srv.listen_endpoint))
    got = []
    done = threading.Event()
    cntl = Controller()
    cntl.timeout_ms = 60_000
    stream_create(cntl, StreamOptions(
        on_received=lambda s, msgs: got.extend(msgs),
        on_closed=lambda s: done.set()))
    c = ch.call_method("LM.Decode", tsvc.pack_generate_request(
        np.arange(6).reshape(1, 6), 4), cntl=cntl)
    assert not c.failed, c.error_text
    assert done.wait(60)
    ch.close()
    status, _, body = _get(srv, "/lm")
    page = json.loads(body)
    assert status == 200 and page["kv"], page
    deadline = time.monotonic() + 10
    while not page["recent_sessions"] and time.monotonic() < deadline:
        time.sleep(0.3)             # the telemetry cache's window
        page = json.loads(_get(srv, "/lm")[2])
    assert page["recent_sessions"], page


def test_internal_port_gates_the_portal_on_h2():
    """gRPC clients' h2 connections are gated too: a portal page over
    h2 answers 403 on the main port with an internal port set."""
    from brpc_tpu_torch.protocol.h2_session import H2Session
    from brpc_tpu_torch.server import ServerOptions
    import socket
    opts = ServerOptions()
    opts.internal_port = 0
    srv = Server(opts)
    srv.add_service(TBusy(), name="B")
    assert srv.start("127.0.0.1:0") == 0
    try:
        for ep, want in ((srv.listen_endpoint, "403"),
                         (srv.internal_endpoint, "200")):
            sess = H2Session(is_server=False)
            sess.start()
            sid = sess.next_stream_id()
            sess.send_headers(sid, [(":method", "GET"), (":scheme", "http"),
                                    (":path", "/status"),
                                    (":authority", "x")], end_stream=True)
            status = None
            with socket.create_connection((ep.host, ep.port),
                                          timeout=10) as s:
                s.sendall(sess.take_output())
                while status is None:
                    data = s.recv(65536)
                    assert data
                    for ev in sess.feed(data):
                        if ev[0] == "headers" and ev[1] == sid:
                            status = dict(ev[2])[":status"]
                    out = sess.take_output()
                    if out:
                        s.sendall(out)
            assert status == want
    finally:
        srv.stop()


# -- /hotspots, as tests/test_hotspots.py drives it --------------------------

def test_cpu_profile_names_hot_function(servers):
    srv = servers["port"]
    ch = Channel()
    ch.init(str(srv.listen_endpoint))
    stop = [False]

    def load():
        while not stop[0]:
            ch.call("B.Spin", b"", timeout_ms=10_000)

    t = threading.Thread(target=load, daemon=True)
    t.start()
    try:
        status, _, body = _get(srv, "/hotspots/cpu?seconds=1&view=flat")
        assert status == 200
        assert b"Spin" in body or b"test_torch_portal" in body, body[:800]
        status, _, body = _get(srv, "/hotspots/cpu?seconds=0.5&view=folded")
        assert status == 200 and b";" in body
        status, _, body = _get(srv, "/hotspots/cpu?seconds=0.5")
        assert status == 200 and body.startswith(b"<!doctype html>")
        assert b'class="f"' in body
    finally:
        stop[0] = True
        t.join(timeout=10)
        ch.close()


def test_contention_reports_butex_wait_sites(servers):
    from brpc_tpu_torch.fiber.butex import Butex
    bx = Butex(0)

    def waiter():
        bx.wait(0, timeout=1.0)

    threads = [threading.Thread(target=waiter) for _ in range(2)]

    def kick():
        time.sleep(0.05)
        for t in threads:
            t.start()
        time.sleep(0.4)
        bx.add_and_wake(1)

    k = threading.Thread(target=kick)
    k.start()
    status, _, body = _get(servers["port"], "/hotspots/contention?seconds=1")
    k.join()
    for t in threads:
        t.join()
    assert status == 200
    assert b"butex" in body, body[:800]
    assert b"test_torch_portal" in body   # the wait site is named


def test_growth_names_allocation_site(servers):
    hoard = []

    def alloc():
        time.sleep(0.2)
        for _ in range(200):
            hoard.append(bytearray(10_000))

    t = threading.Thread(target=alloc)
    t.start()
    status, _, body = _get(servers["port"], "/hotspots/growth?seconds=1")
    t.join()
    assert status == 200
    assert b"test_torch_portal" in body, body[:800]
    hoard.clear()


def test_device_trace_tarball(servers):
    status, headers, body = _request(servers["port"], "GET",
                                     "/hotspots/device?seconds=0.3",
                                     timeout=120)
    assert status == 200, body[:300]
    assert body[:2] == b"\x1f\x8b"
    assert "attachment" in headers.get("content-disposition", "")


def test_butex_and_countdown_match_jax():
    from brpc_tpu.fiber.butex import Butex as JButex
    from brpc_tpu_torch.fiber.butex import Butex, CountdownEvent
    for B in (Butex, JButex):
        bx = B(3)
        assert bx.wait(2, timeout=0.01) is True      # value changed
        assert bx.wait(3, timeout=0.01) is False     # timed out
        assert bx.add_and_wake(2) == 5
    ev = CountdownEvent(2)
    threading.Timer(0.05, ev.signal, args=(2,)).start()
    assert ev.wait(5) and ev.count == 0


# -- rpcz_stitch and fleet over the portal ----------------------------------

class _Hop:
    def __init__(self, downstream=None):
        self.downstream = downstream

    def Call(self, cntl, request):
        if self.downstream is None:
            return b"leaf:" + bytes(request)
        ch = Channel()
        ch.init(self.downstream)
        c = Controller()
        c.trace_id = cntl.request_meta.trace_id
        c.span_id = cntl.span.span_id if cntl.span is not None else 0
        c.timeout_ms = 10_000
        try:
            c = ch.call_method("Hop.Call", request, cntl=c)
        finally:
            ch.close()
        return b"mid>" + bytes(c.response)


class THop(Service, _Hop):
    pass


def test_fetch_remote_spans_and_stitch_across_two_servers():
    leaf = Server()
    leaf.add_service(THop(), name="Hop")
    assert leaf.start("127.0.0.1:0") == 0
    mid = Server()
    mid.add_service(THop(str(leaf.listen_endpoint)), name="Hop")
    assert mid.start("127.0.0.1:0") == 0
    try:
        trace_id = 0x5EED1234
        ch = Channel()
        ch.init(str(mid.listen_endpoint))
        c = Controller()
        c.trace_id = trace_id
        c.timeout_ms = 10_000
        c = ch.call_method("Hop.Call", b"x", cntl=c)
        ch.close()
        assert c.response == b"mid>leaf:x"
        deadline = time.monotonic() + 5
        while len(global_span_store().by_trace(trace_id)) < 4 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        local = [s.describe() for s in global_span_store().by_trace(
            trace_id)]
        # one hop over the leaf's portal returns the same span dicts
        fetched = rpcz_stitch.fetch_remote_spans(str(leaf.listen_endpoint),
                                                 trace_id)
        assert {s["span_id"] for s in fetched} == \
            {s["span_id"] for s in local}
        with pytest.raises(Exception):
            rpcz_stitch.fetch_remote_spans("127.0.0.1:1", trace_id,
                                           timeout_s=0.5)
        # the default fetch walks the client spans' remotes over HTTP
        out = rpcz_stitch.collect_trace(trace_id)
        assert out["remotes"] and set(out["remotes"].values()) == {"ok"}
        assert {s["span_id"] for s in out["spans"]} == \
            {s["span_id"] for s in local}
        tree = rpcz_stitch.build_tree(out["spans"])
        assert len(tree) == 1                    # one root: the caller
        # the portal's own stitch of the same trace
        status, _, body = _request(mid, "GET", f"/rpcz?trace_id="
                                   f"{trace_id:x}&stitch=1")
        page = json.loads(body)
        assert status == 200 and page["stitched"]
        assert len(page["spans"]) == len(local)
    finally:
        mid.stop()
        leaf.stop()


def test_locate_trace_root_and_member_fetches():
    reg_srv = Server()
    reg_srv.add_service(TBusy(), name="B")
    reg = fleet.host_registry(reg_srv, ttl_s=5.0)
    assert reg_srv.start("127.0.0.1:0") == 0
    mem = Server()
    mem.add_service(TBusy(), name="B")
    assert mem.start("127.0.0.1:0") == 0
    reg_addr, mem_addr = str(reg_srv.listen_endpoint), \
        str(mem.listen_endpoint)
    try:
        report = fleet.build_load_report()
        report["instance"] = mem_addr
        report["trace_roots"] = ["dead0", "beef1"]
        assert reg.ingest(report) == 0
        assert rpcz_stitch.locate_trace_root(reg_addr, 0xDEAD0) == \
            [mem_addr]
        assert rpcz_stitch.locate_trace_root(reg_addr, 0xCAFE) == []
        with pytest.raises(RuntimeError):
            # a plain member hosts no registry: /fleet?trace_id is a 404
            rpcz_stitch.locate_trace_root(mem_addr, 0xDEAD0)
        got = fleet.fetch_member_report(mem_addr)
        assert got["instance"] == mem_addr
        assert set(got) == set(fleet.build_load_report())
        text = fleet.fetch_member_metrics(mem_addr)
        assert "# TYPE rpc_server_b_spin" in text
        body = reg.federate()
        assert f'instance="{mem_addr}"' in body
        # the registry's /metrics?fleet=1 page renders the same scrape
        status, _, page = _request(reg_srv, "GET", "/metrics?fleet=1")
        assert status == 200 and f'instance="{mem_addr}"'.encode() in page
        status, _, page = _request(reg_srv, "GET", "/fleet")
        assert json.loads(page)["registry"] is True
    finally:
        mem.stop()
        reg_srv.stop()
