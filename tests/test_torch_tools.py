"""The port's operational tools held against the JAX package's
(``tests/test_tools.py``, ``tests/test_tools_proxy.py``): ``rpc_press``
load generation, ``rpc_dump`` capture on both transports (the engine's
native dispatch off while capturing) and ``rpc_replay``, the dump files
read frame for frame by both packages' ``DumpReader``, the press and the
replay across the packages, ``rpc_view``'s fetch, link rewriting and
browsing proxy, ``parallel_http``, ``trace_dump``, ``fleet_dump``'s
rendering, ``perf_guard``'s verdicts, and trackme's client."""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu.tools import fleet_dump as jfleet_dump
from brpc_tpu.tools import perf_guard as jperf_guard
from brpc_tpu.tools import rpc_dump as jrpc_dump
from brpc_tpu.tools.rpc_press import Press as JPress
from brpc_tpu.tools.rpc_press import PressOptions as JPressOptions
from brpc_tpu.tools.rpc_view import rewrite_links as jrewrite_links
from brpc_tpu_torch.butil.flags import set_flag
from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
from brpc_tpu_torch.server import Server, ServerOptions, Service, raw_method
from brpc_tpu_torch.tools import fleet_dump, perf_guard
from brpc_tpu_torch.tools.parallel_http import parallel_fetch
from brpc_tpu_torch.tools.rpc_dump import DumpReader, close_dump
from brpc_tpu_torch.tools.rpc_press import Press, PressOptions
from brpc_tpu_torch.tools.rpc_replay import Replayer, ReplayOptions
from brpc_tpu_torch.tools.rpc_view import ViewProxy, fetch, rewrite_links
from brpc_tpu_torch.tools.trace_dump import fetch_trace


class Echo(Service):
    def __init__(self):
        super().__init__()
        self.seen = []
        self.echoed = []

    def Echo(self, cntl, request):
        self.echoed.append(bytes(request))
        return request

    def Record(self, cntl, request):
        self.seen.append((bytes(request), bytes(cntl.request_attachment)))
        return b"ok"

    @raw_method
    def Raw(self, payload, attachment):
        return bytes(payload)


class JEcho(JService):
    def __init__(self):
        super().__init__()
        self.seen = []

    def Echo(self, cntl, request):
        return request

    def Record(self, cntl, request):
        self.seen.append((bytes(request),
                          cntl.request_attachment.to_bytes()))
        return b"ok"


def _port_server(native=False):
    opts = ServerOptions()
    if native:
        opts.native = True
        opts.usercode_inline = True
    srv = Server(opts)
    svc = Echo()
    assert srv.add_service(svc, name="E") == 0
    assert srv.start("127.0.0.1:0") == 0
    if native:
        assert srv._native_bridge is not None, "the engine did not build"
    srv.test_svc = svc
    return srv


@pytest.fixture()
def server():
    srv = _port_server()
    yield srv
    srv.stop()


@pytest.fixture()
def jax_server():
    svc = JEcho()
    srv = JServer()
    srv.add_service(svc, name="E")
    assert srv.start("127.0.0.1:0") == 0
    srv.test_svc = svc
    yield srv
    srv.stop()


@pytest.fixture()
def dump_dir(tmp_path):
    """Both packages capture into ``tmp_path``; every capture is off and
    closed afterwards."""
    from brpc_tpu.butil.flags import set_flag as jset_flag
    assert set_flag("rpc_dump_dir", str(tmp_path))
    assert jset_flag("rpc_dump_dir", str(tmp_path))
    yield tmp_path
    set_flag("rpc_dump", False)
    jset_flag("rpc_dump", False)
    close_dump()
    jrpc_dump.close_dump()


def _press_opts(cls, ep, method="E.Echo", **kw):
    opts = cls()
    opts.server = str(ep)
    opts.method = method
    opts.report_interval_s = 10
    for k, v in kw.items():
        setattr(opts, k, v)
    return opts


# -- rpc_press ---------------------------------------------------------------

def test_press_unlimited(server):
    s = Press(_press_opts(PressOptions, server.listen_endpoint,
                          duration_s=1.0, input=b"press-payload")).run()
    assert s["errors"] == 0
    assert s["sent"] > 50
    assert s["latency_us_p50"] >= 0


def test_press_target_qps(server):
    s = Press(_press_opts(PressOptions, server.listen_endpoint, qps=100,
                          duration_s=2.0)).run()
    assert s["errors"] == 0
    assert 50 <= s["qps"] <= 160, s


def test_press_errors_and_payloads(server):
    """A method the server lacks fails every call; a list of payloads is
    sent in turn, each call answered (the echo service's record)."""
    s = Press(_press_opts(PressOptions, server.listen_endpoint,
                          method="E.Nope", duration_s=0.3)).run()
    assert s["errors"] == s["sent"] > 0
    s = Press(_press_opts(PressOptions, server.listen_endpoint,
                          duration_s=0.5, input=[b"a", b"bb"])).run()
    assert s["errors"] == 0 and s["sent"] > 1
    n = s["sent"]
    assert server.test_svc.echoed == [b"a", b"bb"] * (n // 2) + [b"a"] * (n % 2)


def test_press_cli(server):
    from brpc_tpu_torch.tools.rpc_press import main
    assert main(["--server", str(server.listen_endpoint), "--method",
                 "E.Echo", "--duration", "0.3", "--qps", "50"]) == 0


@pytest.mark.parametrize("way", ["port-press-jax-server",
                                 "jax-press-port-server"])
def test_press_across_the_packages(way, server, jax_server):
    if way == "port-press-jax-server":
        s = Press(_press_opts(PressOptions, jax_server.listen_endpoint,
                              duration_s=0.5, input=b"x")).run()
    else:
        s = JPress(_press_opts(JPressOptions, server.listen_endpoint,
                               duration_s=0.5, input=b"x")).run()
    assert s["errors"] == 0 and s["sent"] > 10


# -- rpc_dump and rpc_replay --------------------------------------------------

def _record_calls(ep, n=10, jax_client=False):
    if jax_client:
        from brpc_tpu.client import Channel as JChannel
        from brpc_tpu.client import Controller as JController
        ch = JChannel()
        ch.init(str(ep))
        for i in range(n):
            c = JController()
            c.timeout_ms = 5000
            c.request_attachment.append(b"att%d" % i)
            c = ch.call_method("E.Record", b"body%d" % i, cntl=c)
            assert not c.failed, c.error_text
        return
    ch = Channel()
    ch.init(str(ep))
    try:
        for i in range(n):
            c = Controller()
            c.timeout_ms = 5000
            c.request_attachment = b"att%d" % i
            c = ch.call_method("E.Record", b"body%d" % i, cntl=c)
            assert not c.failed, c.error_text
    finally:
        ch.close()


@pytest.mark.parametrize("transport", ["python", "native"])
def test_dump_and_replay(transport, dump_dir):
    srv = _port_server(native=transport == "native")
    try:
        fb0 = None
        if transport == "native":
            fb0 = srv._native_bridge.engine.telemetry()["fallbacks"][
                "rpc_dispatch_off"]
        set_flag("rpc_dump", True)
        try:
            _record_calls(srv.listen_endpoint)
        finally:
            set_flag("rpc_dump", False)
        path = close_dump()
        assert path is not None
        if transport == "native":
            # capture turned the engine's native dispatch off: every call
            # reached the classic lane under rpc_dispatch_off; after it,
            # the slim lane answers again and nothing more is counted
            tel = srv._native_bridge.engine.telemetry()
            assert tel["fallbacks"]["rpc_dispatch_off"] - fb0 == 10
            slim0 = tel["lanes"]["slim"]["handled"]
            _record_calls(srv.listen_endpoint, n=2)
            tel = srv._native_bridge.engine.telemetry()
            assert tel["fallbacks"]["rpc_dispatch_off"] - fb0 == 10
            assert tel["lanes"]["slim"]["handled"] - slim0 == 2
        frames = DumpReader(path).frames()
        assert len(frames) == 10
        for i, (meta, payload) in enumerate(frames):
            assert meta.service_name == "E" and meta.method_name == "Record"
            n = meta.attachment_size
            assert payload[:len(payload) - n] == b"body%d" % i
            assert payload[len(payload) - n:] == b"att%d" % i
        srv2 = _port_server()
        try:
            ropts = ReplayOptions()
            ropts.server = str(srv2.listen_endpoint)
            ropts.dump_files = [path]
            summary = Replayer(ropts).run()
            assert summary["errors"] == 0 and summary["sent"] == 10
            assert srv2.test_svc.seen == srv.test_svc.seen[:10]
        finally:
            srv2.stop()
    finally:
        srv.stop()


def test_capture_flipped_while_calls_run_loses_none(dump_dir):
    """Capture turned on and off again and again while callers run on an
    engine server: every call is answered right while its method moves
    between the native lanes and the classic lane, and what was dumped is
    what was called."""
    import threading
    srv = _port_server(native=True)
    stop = threading.Event()
    bad, sent = [], []

    def caller(k):
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        i = 0
        while not stop.is_set():
            body = b"k%d-%d" % (k, i)
            c = ch.call_method("E.Echo", body)
            sent.append(body)
            if c.failed or c.response != body:
                bad.append((body, c.error_code, c.error_text))
            i += 1
        ch.close()

    threads = [threading.Thread(target=caller, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    try:
        for _ in range(10):
            set_flag("rpc_dump", True)
            time.sleep(0.03)
            set_flag("rpc_dump", False)
            time.sleep(0.03)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        srv.stop()
    path = close_dump()
    assert bad == [] and len(sent) > 30
    frames = DumpReader(path).frames()
    assert frames and {bytes(p) for _m, p in frames} <= set(sent)


def test_raw_lane_declines_while_capturing(dump_dir):
    """A plain ``@raw_method`` on an inline engine server is answered by
    the raw lane; while capture is on it declines to the classic lane,
    which dumps it."""
    srv = _port_server(native=True)
    ch = Channel()
    ch.init(str(srv.listen_endpoint))
    try:
        set_flag("rpc_dump", True)
        try:
            assert ch.call("E.Raw", b"raw-bytes", timeout_ms=5000) \
                == b"raw-bytes"
        finally:
            set_flag("rpc_dump", False)
        frames = DumpReader(close_dump()).frames()
        assert [(m.method_name, p) for m, p in frames] \
            == [("Raw", b"raw-bytes")]
        assert ch.call("E.Raw", b"again", timeout_ms=5000) == b"again"
        assert close_dump() is None
    finally:
        ch.close()
        srv.stop()


def test_replay_loop_and_qps(server, dump_dir):
    set_flag("rpc_dump", True)
    try:
        ch = Channel()
        ch.init(str(server.listen_endpoint))
        ch.call("E.Echo", b"once", timeout_ms=5000)
        ch.close()
    finally:
        set_flag("rpc_dump", False)
    path = close_dump()
    ropts = ReplayOptions()
    ropts.server = str(server.listen_endpoint)
    ropts.dump_files = [path]
    ropts.loop = 5
    ropts.qps = 50
    t0 = time.monotonic()
    summary = Replayer(ropts).run()
    assert summary["sent"] == 5 and summary["errors"] == 0
    assert time.monotonic() - t0 >= 0.05


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dump_files_read_alike_by_both_packages(writer, server, jax_server,
                                                dump_dir):
    """A dump written by either package's server is read frame for frame,
    byte for byte, by both packages' ``DumpReader``; and each package's
    ``Replayer`` replays it into the other's server."""
    if writer == "port":
        set_flag("rpc_dump", True)
        try:
            _record_calls(server.listen_endpoint, n=6)
        finally:
            set_flag("rpc_dump", False)
        path = close_dump()
        src, dst = server, jax_server
    else:
        from brpc_tpu.butil.flags import set_flag as jset_flag
        jset_flag("rpc_dump", True)
        try:
            _record_calls(jax_server.listen_endpoint, n=6, jax_client=True)
        finally:
            jset_flag("rpc_dump", False)
        path = jrpc_dump.close_dump()
        src, dst = jax_server, server
    mine = [(m.encode(), bytes(p)) for m, p in DumpReader(path)]
    theirs = [(m.encode(), bytes(p)) for m, p in jrpc_dump.DumpReader(path)]
    assert len(mine) == 6 and mine == theirs
    with open(path, "rb") as f:
        data = f.read()
    assert data == b"".join(
        b"TRPC" + len(mb + p).to_bytes(4, "little")
        + len(mb).to_bytes(4, "little") + mb + p for mb, p in mine)
    from brpc_tpu.tools.rpc_replay import ReplayOptions as JReplayOptions
    from brpc_tpu.tools.rpc_replay import Replayer as JReplayer
    for opts_cls, rep_cls in ((ReplayOptions, Replayer),
                              (JReplayOptions, JReplayer)):
        opts = opts_cls()
        opts.server = str(dst.listen_endpoint)
        opts.dump_files = [path]
        summary = rep_cls(opts).run()
        assert summary["errors"] == 0 and summary["sent"] == 6
    assert dst.test_svc.seen == src.test_svc.seen * 2


# -- rpc_view and parallel_http ------------------------------------------------

def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def test_rpc_view(server):
    body = fetch(str(server.listen_endpoint), "status")
    assert "E.Echo" in body
    assert fetch(str(server.listen_endpoint), "health") == "OK\n"
    with pytest.raises(RuntimeError):
        fetch(str(server.listen_endpoint), "no_such_page")


def test_rewrite_links_as_jax(server):
    body = (b'<a href="/vars">v</a> <img src="/static/x.png"> '
            b'<form action="/flags?setvalue"> '
            b'<a href="http://elsewhere/abs">keep</a> '
            b'<a href="//proto-relative">keep</a>')
    out = rewrite_links(body, "10.0.0.5:8080")
    assert b'href="/10.0.0.5:8080/vars"' in out
    assert b'href="//proto-relative"' in out
    assert out == jrewrite_links(body, "10.0.0.5:8080")
    # a live page of the port's portal: the trend page's link to /vars
    target = str(server.listen_endpoint)
    page = fetch(target, "vars?expand=drain_inflight_remaining").encode()
    assert b"href='/vars'" in page
    assert rewrite_links(page, target) == jrewrite_links(page, target)
    assert f"href='/{target}/vars'".encode() in rewrite_links(page, target)


def test_proxy_serves_and_rewrites(server):
    target = str(server.listen_endpoint)
    proxy = ViewProxy()
    port = proxy.start()
    try:
        status, body = _get(f"http://127.0.0.1:{port}/{target}/status")
        assert status == 200 and b"E.Echo" in body
        status, body = _get(f"http://127.0.0.1:{port}/{target}/vars"
                            "?expand=drain_inflight_remaining")
        assert status == 200 and f"href='/{target}/vars'".encode() in body
        status, body = _get(f"http://127.0.0.1:{port}/{target}/vars")
        assert status == 200
        status, body = _get(f"http://127.0.0.1:{port}/")
        assert status == 200 and b"rpc_view proxy" in body
        try:
            status, body = _get(f"http://127.0.0.1:{port}/127.0.0.1:1/status")
        except urllib.error.HTTPError as e:
            status = e.code
        assert status == 502
    finally:
        proxy.stop()


def test_parallel_fetch(server, jax_server):
    a, b = str(server.listen_endpoint), str(jax_server.listen_endpoint)
    results = parallel_fetch([a, b, "127.0.0.1:1"], "/vars", concurrency=8,
                             timeout=5.0)
    assert results[a].ok and results[b].ok
    assert not results["127.0.0.1:1"].ok and results["127.0.0.1:1"].error


# -- trace_dump and fleet_dump -------------------------------------------------

def test_trace_dump_chrome_of_a_traced_call(server, capsys):
    from brpc_tpu_torch.rpcz import global_span_store
    from brpc_tpu_torch.tools.trace_dump import main
    tid = 0x7D00_0000 + os.getpid()
    ch = Channel()
    ch.init(str(server.listen_endpoint))
    try:
        c = Controller()
        c.trace_id = tid
        c.timeout_ms = 5000
        assert not ch.call_method("E.Echo", b"traced", cntl=c).failed
    finally:
        ch.close()
    deadline = time.monotonic() + 10
    while len(global_span_store().by_trace(tid)) < 2:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    doc = json.loads(fetch_trace(str(server.listen_endpoint), tid))
    spans = [ev for ev in doc["traceEvents"] if ev.get("ph") == "X"]
    assert {ev["cat"] for ev in spans} >= {"client", "server"}
    assert main([str(server.listen_endpoint), f"{tid:x}", "--tree"]) == 0
    assert "E.Echo" in capsys.readouterr().out
    assert main([str(server.listen_endpoint), "zz"]) == 2


def test_fleet_dump_renders_as_jax(capsys):
    """The port's ``/fleet`` JSON rendered by both packages' ``render``
    alike; the CLI's table, ``--json`` and ``--self``."""
    from brpc_tpu_torch import fleet
    fleet._reset_for_tests()
    srv = Server()
    srv.add_service(Echo(), name="E")
    reg = fleet.host_registry(srv, ttl_s=5.0)
    assert srv.start("127.0.0.1:0") == 0
    addr = str(srv.listen_endpoint)
    try:
        rep = fleet.build_load_report(srv)
        rep["instance"] = addr
        assert reg.ingest(rep) == 0
        fleet.record_event("fleet_restart", addr)
        doc = fleet_dump.fetch_fleet(addr)
        assert doc["registry"] is True
        assert fleet_dump.render(doc) == jfleet_dump.render(doc)
        me = fleet_dump.fetch_fleet(addr, self_only=True)
        assert fleet_dump.render(me) == jfleet_dump.render(me)
        assert fleet_dump.main([addr]) == 0
        out = capsys.readouterr().out
        assert addr in out and "timeline" in out and "fleet_restart" in out
        assert fleet_dump.main([addr, "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["registry"] is True
        assert fleet_dump.main(["127.0.0.1:1", "--timeout", "0.3"]) == 1
    finally:
        srv.stop()
        fleet._reset_for_tests()


# -- perf_guard ----------------------------------------------------------------

_LINES = {
    "within": {"x_qps": 900.0, "lat_ms": 11.0, "http_slim_vs_classic": 1.9,
               "rolling_restart_failed_rpcs": 0, "plain": 3.0},
    "regressed": {"x_qps": 400.0, "lat_ms": 11.0,
                  "http_slim_vs_classic": 2.0,
                  "rolling_restart_failed_rpcs": 0},
    "pinned": {"x_qps": 1000.0, "rolling_restart_failed_rpcs": 2},
    "ratio": {"x_qps": 1000.0, "http_slim_vs_classic": 1.2,
              "cntl_vs_raw_gap": 1.0},
    "missing": {"x_qps": 1000.0, "new_gbps": 3.0},
}
_BASE = {"x_qps": 1000.0, "lat_ms": 10.0, "http_slim_vs_classic": 2.0,
         "cntl_vs_raw_gap": 1.5, "rolling_restart_failed_rpcs": 0}


def _bench_line(extra):
    return json.dumps({"metric": "x_qps", "value": extra.get("x_qps", 0.0),
                       "extra": extra})


@pytest.mark.parametrize("case", sorted(_LINES))
def test_perf_guard_verdicts_as_jax(case, tmp_path):
    new = tmp_path / "new.out"
    new.write_text("noise line\n" + _bench_line(_LINES[case]) + "\n")
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"n": 1, "tail": "",
                                "parsed": {"metric": "x_qps",
                                           "value": 1000.0,
                                           "extra": _BASE}}))
    a = perf_guard.load_metrics(str(new))
    assert a == jperf_guard.load_metrics(str(new))
    b = perf_guard.load_metrics(str(base))
    assert perf_guard.compare(a, b, 0.5, 0.25) \
        == jperf_guard.compare(a, b, 0.5, 0.25)
    rc = perf_guard.main([str(new), "--baseline", str(base)])
    assert rc == jperf_guard.main([str(new), "--baseline", str(base)])
    assert rc == (0 if case in ("within", "missing") else 1)


def test_perf_guard_check_runs_the_ports_suite(tmp_path, capsys):
    new = tmp_path / "new.out"
    new.write_text(_bench_line(_LINES["within"]) + "\n")
    base = tmp_path / "base.out"
    base.write_text(_bench_line(_BASE) + "\n")
    assert perf_guard.main([str(new), "--baseline", str(base),
                            "--check"]) == 0
    assert "static suite clean" in capsys.readouterr().out
    assert perf_guard.RECORDED_BASELINE == {}


# -- trackme's client -----------------------------------------------------------

def test_trackme_roundtrip(server):
    """The port's ``/trackme`` page and its client: the verdicts by the
    version gates, then ``start_trackme`` pings until ``stop_trackme``."""
    from brpc_tpu_torch import __version__, trackme
    from brpc_tpu_torch.tools import rpc_view
    addr = str(server.listen_endpoint)
    reply = json.loads(fetch(addr, f"trackme?ver={__version__}"))
    assert reply["severity"] == trackme.SEV_OK
    set_flag("trackme_min_version", "99.0.0")
    try:
        reply = json.loads(fetch(addr, "trackme?ver=0.0.1"))
        assert reply["severity"] == trackme.SEV_WARN
        set_flag("trackme_fatal_version", "98.0.0")
        reply = json.loads(fetch(addr, "trackme?ver=0.0.1"))
        assert reply["severity"] == trackme.SEV_FATAL
    finally:
        set_flag("trackme_min_version", "")
        set_flag("trackme_fatal_version", "")
    assert not trackme.start_trackme("")        # no server configured
    answered = []
    real = rpc_view.fetch

    def counted(*a, **kw):
        body = real(*a, **kw)
        answered.append(json.loads(body)["severity"])
        return body

    rpc_view.fetch = counted
    try:
        assert trackme.start_trackme(addr, interval_s=0.05)
        assert trackme.start_trackme(addr)       # idempotent
        deadline = time.monotonic() + 10
        while len(answered) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        trackme.stop_trackme()
        n = len(answered)
        time.sleep(0.3)
        assert len(answered) == n and set(answered) == {trackme.SEV_OK}
    finally:
        trackme.stop_trackme()
        rpc_view.fetch = real


def test_trackme_flags_drive_the_client(server):
    from brpc_tpu_torch import trackme
    assert set_flag("trackme_server", str(server.listen_endpoint))
    assert set_flag("trackme_interval_s", 60)
    try:
        assert trackme.start_trackme()
        assert trackme._task is not None and trackme._task.run_count >= 1
    finally:
        trackme.stop_trackme()
        set_flag("trackme_server", "")
        set_flag("trackme_interval_s", 300)
