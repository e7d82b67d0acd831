"""The mixed-load soaks of ``tests/test_soak.py``, both, against
``brpc_tpu_torch``: four client lanes (sync unary, pipelined batch,
streaming, device attachments) hammer one process concurrently.  Catches
cross-lane interference — shared reader stalls, fabric window leaks,
correlation-id mixups — that single-lane tests cannot.

The port's idiom where it differs: controller attachments are bytes
(ROADMAP C9), so the echo handler assigns where the JAX one appends;
device attachments are torch tensors on the CPU (``PSService(
device="cpu")``, ``tensor(device="cpu")``)."""

import threading
import time

import torch

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
from brpc_tpu_torch.models.ps_service import PSService
from brpc_tpu_torch.server import Server, ServerOptions, Service
from brpc_tpu_torch.streaming import (StreamOptions, stream_accept,
                                      stream_create)

SOAK_S = 5.0


class _Echo(Service):
    def Echo(self, cntl, request):
        cntl.response_attachment = bytes(cntl.request_attachment)
        return request


class _Sink(Service):
    def Start(self, cntl, request):
        stream_accept(cntl, StreamOptions(on_received=lambda s, m: None,
                                          max_buf_size=1 << 20))
        return b"ok"


def test_mixed_load_soak():
    opts = ServerOptions()
    opts.native = True
    opts.usercode_inline = True
    srv = Server(opts)
    srv.add_service(_Echo(), name="E")
    srv.add_service(PSService(device="cpu"), name="PS")
    psrv = Server()                      # python transport for streams
    psrv.add_service(_Sink(), name="S")
    assert srv.start("127.0.0.1:0") == 0
    assert psrv.start("127.0.0.1:0") == 0
    addr, paddr = str(srv.listen_endpoint), str(psrv.listen_endpoint)

    stop = time.time() + SOAK_S
    errors = []
    counts = {}

    def lane(name, fn):
        def run():
            n = 0
            try:
                while time.time() < stop:
                    fn()
                    n += 1
            except Exception as e:       # noqa: BLE001 - recorded
                errors.append((name, repr(e)))
            counts[name] = n
        return threading.Thread(target=run, name=f"soak_{name}")

    co = ChannelOptions(); co.connection_type = "pooled"
    uch = Channel(co); uch.init(addr)
    def unary():
        cntl = Controller()
        cntl.request_attachment = IOBuf(b"u" * 512)
        c = uch.call_method("E.Echo", b"ping", cntl=cntl)
        assert not c.failed, c.error_text
        assert len(c.response_attachment) == 512

    bo = ChannelOptions(); bo.connection_type = "pooled"
    bch = Channel(bo); bch.init(addr)
    reqs = [b"b" * 64] * 32
    def batch():
        out = bch.call_batch("E.Echo", reqs)
        assert len(out) == 32 and all(o == b"b" * 64 for o in out)

    sch = Channel(); sch.init(paddr)
    def stream():
        cntl = Controller(); cntl.timeout_ms = 10_000
        s = stream_create(cntl, StreamOptions(max_buf_size=1 << 20))
        c = sch.call_method("S.Start", b"", cntl=cntl)
        assert not c.failed, c.error_text
        for _ in range(8):
            if s.write(b"x" * 4096) != 0:
                break
        s.close()

    dch = Channel(); dch.init(addr)
    x = torch.arange(2048, dtype=torch.float32)
    def device():
        cntl = Controller(); cntl.timeout_ms = 30_000
        cntl.request_device_attachment = x
        c = dch.call_method("PS.EchoTensor", b"", cntl=cntl)
        assert not c.failed, c.error_text
        c.response_device_attachment.tensor(device="cpu")

    threads = [lane("unary", unary), lane("batch", batch),
               lane("stream", stream), lane("device", device)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SOAK_S + 30)
    srv.stop()
    psrv.stop()

    assert not errors, errors[:3]
    # every lane made real progress under contention
    for name in ("unary", "batch", "stream", "device"):
        assert counts.get(name, 0) > 5, counts


@__import__("pytest").mark.soak
def test_full_mixed_soak():
    """The full soak: pooled + short connections, pipelined
    batches, streaming, device attachments, live flag flips, and a
    fault-proxy partition mid-run — sustained for SOAK_SECONDS (default
    12 for CI; run SOAK_SECONDS=75 for the full 60-90s window).

    Pass bar: zero failures on the healthy lanes, recovery on the
    partitioned lane, zero leaked ICI window credit, zero stuck-fiber
    watchdog hits, and a stable raw-lane p99 (second half no worse than
    5x the first half)."""
    import os

    import pytest

    from brpc_tpu_torch.butil.flags import get_flag, set_flag
    from brpc_tpu_torch.butil.sanitizers import check_stalls
    from brpc_tpu_torch.ici.endpoint import live_endpoints
    from brpc_tpu_torch.server.service import raw_method
    from conftest import require_native
    from fault_proxy import FaultyTransport

    require_native()
    soak_s = float(os.environ.get("SOAK_SECONDS", "12"))

    class RawEcho(Service):
        @raw_method(native="echo")
        def Echo(self, payload, attachment):
            return payload, attachment

        @raw_method()
        def EchoPy(self, payload, attachment):
            # kind-2 lane: the engine calls this Python handler from
            # the loop thread (burst-batched GIL entry)
            return payload, attachment

    opts = ServerOptions()
    opts.native = True
    opts.usercode_inline = True
    srv = Server(opts)
    srv.add_service(_Echo(), name="E")
    srv.add_service(RawEcho(), name="R")
    srv.add_service(PSService(device="cpu"), name="PS")
    psrv = Server()                      # python transport for streams
    psrv.add_service(_Sink(), name="S")
    assert srv.start("127.0.0.1:0") == 0
    assert psrv.start("127.0.0.1:0") == 0
    addr, paddr = str(srv.listen_endpoint), str(psrv.listen_endpoint)
    ep = srv.listen_endpoint
    proxy = FaultyTransport(str(ep.host), ep.port)

    set_flag("stall_watchdog_s", 8.0)
    # earlier suites may deliberately strand descriptor credit (timeout
    # tests rely on the 120s TTL sweep); the soak asserts ITS OWN
    # workload's hygiene: per-endpoint baselines with STRONG refs (an
    # id()-keyed set could alias a GC'd endpoint to a new allocation
    # and mask a genuine soak leak)
    baseline = {e: e.outstanding_bytes for e in live_endpoints()}
    stop_at = time.time() + soak_s
    errors = []
    counts = {}
    lat: list = []                       # (t, us) raw-lane samples

    def lane(name, fn, tolerate=False):
        def run():
            n = 0
            while time.time() < stop_at:
                try:
                    fn()
                    n += 1
                except Exception as e:   # noqa: BLE001
                    if not tolerate:
                        errors.append((name, repr(e)))
                        break
                    time.sleep(0.05)
            counts[name] = n
        return threading.Thread(target=run, name=f"soak_{name}")

    co = ChannelOptions(); co.connection_type = "pooled"
    uch = Channel(co); uch.init(addr)
    def unary_pooled():
        cntl = Controller()
        cntl.request_attachment = IOBuf(b"u" * 512)
        c = uch.call_method("E.Echo", b"ping", cntl=cntl)
        assert not c.failed, c.error_text

    so = ChannelOptions(); so.connection_type = "short"
    sch_short = Channel(so); sch_short.init(addr)
    def unary_short():
        cntl = Controller(); cntl.timeout_ms = 10_000
        c = sch_short.call_method("E.Echo", b"s", cntl=cntl)
        assert not c.failed, c.error_text

    rch = Channel(co); rch.init(addr)
    def raw_lane():
        t0 = time.perf_counter()
        r, _ = rch.call_raw("R.Echo", b"", b"r" * 1024,
                            timeout_ms=10_000)
        lat.append((time.time(), (time.perf_counter() - t0) * 1e6))

    prch = Channel(co); prch.init(addr)
    def pyraw_lane():
        r, _ = prch.call_raw("R.EchoPy", b"k2", b"p" * 256,
                             timeout_ms=10_000)
        assert bytes(r) == b"k2"

    import http.client as _hc
    hconn = [None]
    def native_http():
        if hconn[0] is None:
            hconn[0] = _hc.HTTPConnection(ep.host, ep.port, timeout=10)
        try:
            hconn[0].request("POST", "/E/Echo", body=b"h" * 256)
            resp = hconn[0].getresponse()
            assert resp.status == 200 and len(resp.read()) == 256
        except Exception:
            try:
                hconn[0].close()
            finally:
                hconn[0] = None
            raise

    bch = Channel(co); bch.init(addr)
    reqs = [b"b" * 64] * 64
    def batch():
        out = bch.call_batch("E.Echo", reqs)
        assert len(out) == 64

    stch = Channel(); stch.init(paddr)
    def stream():
        cntl = Controller(); cntl.timeout_ms = 10_000
        s = stream_create(cntl, StreamOptions(max_buf_size=1 << 20))
        c = stch.call_method("S.Start", b"", cntl=cntl)
        assert not c.failed, c.error_text
        for _ in range(8):
            if s.write(b"x" * 4096) != 0:
                break
        s.close()

    dch = Channel(); dch.init(addr)
    x = torch.arange(2048, dtype=torch.float32)
    def device():
        cntl = Controller(); cntl.timeout_ms = 30_000
        cntl.request_device_attachment = x
        c = dch.call_method("PS.EchoTensor", b"", cntl=cntl)
        assert not c.failed, c.error_text
        c.response_device_attachment.tensor(device="cpu")

    import brpc_tpu_torch.rpcz                     # defines the rpcz flags
    def flag_flipper():
        cur = int(get_flag("rpcz_max_samples_per_second", 1000))
        assert set_flag("rpcz_max_samples_per_second",
                        500 if cur == 1000 else 1000)
        mb = int(get_flag("max_body_size", 64 << 20))
        assert set_flag("max_body_size",
                        (32 << 20) if mb == (64 << 20) else (64 << 20))
        time.sleep(0.2)

    pch = Channel(co); pch.init(proxy.address)
    partition_recovered = [0]
    def through_proxy():
        cntl = Controller(); cntl.timeout_ms = 3_000
        c = pch.call_method("E.Echo", b"via-proxy", cntl=cntl)
        assert not c.failed, c.error_text
        if partition_done[0]:
            partition_recovered[0] += 1

    partition_done = [False]
    def partitioner():
        # one partition event mid-run, then heal
        time.sleep(max(1.0, soak_s * 0.3))
        proxy.partition = True
        proxy.kill_connections()
        time.sleep(min(3.0, soak_s * 0.2))
        proxy.heal()
        partition_done[0] = True

    threads = [lane("unary_pooled", unary_pooled),
               lane("unary_short", unary_short),
               lane("raw", raw_lane),
               lane("pyraw", pyraw_lane),
               lane("http", native_http),
               lane("batch", batch),
               lane("stream", stream),
               lane("device", device),
               lane("flags", flag_flipper),
               lane("proxy", through_proxy, tolerate=True),
               threading.Thread(target=partitioner, name="partitioner")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(soak_s + 60)
    try:
        assert not errors, errors[:4]
        for name in ("unary_pooled", "unary_short", "raw", "pyraw",
                     "http", "batch", "stream", "device"):
            assert counts.get(name, 0) > 5, counts
        # the partitioned lane recovered after heal
        assert partition_recovered[0] > 0, counts
        # zero leaked ICI window credit (descriptors all settled)
        deadline = time.time() + 10
        def drained():
            return all(e.outstanding_bytes <= baseline.get(e, 0)
                       for e in live_endpoints())
        while not drained() and time.time() < deadline:
            time.sleep(0.05)
        assert drained(), [
            (e.socket_id, e.outstanding_bytes) for e in live_endpoints()
            if e.outstanding_bytes > baseline.get(e, 0)]
        # zero stuck fibers
        assert check_stalls() == 0
        # p99 stability: second half no worse than 5x first half
        if len(lat) >= 200:
            mid = (lat[0][0] + lat[-1][0]) / 2
            h1 = sorted(us for t, us in lat if t <= mid)
            h2 = sorted(us for t, us in lat if t > mid)
            if h1 and h2:
                p99_1 = h1[int(len(h1) * 0.99)]
                p99_2 = h2[int(len(h2) * 0.99)]
                assert p99_2 < max(5 * p99_1, 5_000.0), (p99_1, p99_2)
    finally:
        set_flag("stall_watchdog_s", 0.0)
        set_flag("max_body_size", 64 << 20)
        set_flag("rpcz_max_samples_per_second", 1000)
        proxy.close()
        srv.stop()
        psrv.stop()


def test_server_start_imports_json2pb_before_serving():
    """The full soak's startup stall (ROADMAP C17): the first HTTP request
    on an inline native server imported json2pb's protobuf on the serving
    loop, holding every connection of that loop past a 500 ms deadline
    under load.  ``Server.start`` now does that import, so a fresh
    process has json2pb (and protobuf, where installed) loaded once a
    server listens, before any HTTP request arrives."""
    import os
    import subprocess
    import sys

    code = (
        "import sys\n"
        "from brpc_tpu_torch.server import Server\n"
        "name = 'brpc_tpu_torch.protocol.json2pb'\n"
        "assert name not in sys.modules\n"
        "srv = Server()\n"
        "assert srv.start('127.0.0.1:0') == 0\n"
        "print(name in sys.modules)\n"
        "srv.stop()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "True", r.stdout
