"""The port's client completion lane (``transport/client_lane.py``), as
``tests/test_client_lane.py`` holds the JAX lane:

- the eligible matrix (plain, deadline, traced, attachment, async) on a
  shared ``"single"`` connection completes natively with no fallback;
- an error response and stream frames fall back under their named
  reasons, and a backup's stale response is consumed without harm;
- every Controller observable of a call matrix is the same with the lane
  on and off (the dispatcher), and the breaker is fed alike;
- the demux's reasons on crafted wire bytes, and EOF after a last
  completion;
- ``drain_settle`` waits for the in-flight table and returns what is
  left at its deadline;
- :data:`REASONS` is ``engine.cpp``'s ``CliFb`` enum, in its order;
- calls from several channels share the one connection and are
  multiplexed on it, where the old port serialized them.
"""

import os
import re
import socket as pysock
import struct
import threading
import time

import pytest

from brpc_tpu_torch.butil.flags import set_flag
from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
from brpc_tpu_torch.native import SOURCE, load
from brpc_tpu_torch.server import Server, ServerOptions
from brpc_tpu_torch.server.service import Service
from brpc_tpu_torch.transport import client_lane
from brpc_tpu_torch.transport.client_lane import (REASONS,
                                                  client_lane_telemetry)
from brpc_tpu_torch.transport.socket_map import global_socket_map


def _require_native():
    if load() is None:
        pytest.skip("native engine unavailable (no toolchain)")


def _lane_counts():
    t = client_lane_telemetry()
    fb = t.get("fallbacks", {}) or {r: 0 for r in REASONS}
    return t.get("completions", 0), dict(fb)


def _fb_delta(before, after):
    return {r: after.get(r, 0) - before.get(r, 0) for r in REASONS
            if after.get(r, 0) != before.get(r, 0)}


class Probe(Service):
    def Echo(self, cntl, request):
        cntl.response_attachment = cntl.request_attachment
        return request

    def Err(self, cntl, request):
        cntl.set_failed(1234, "boom")
        return b""

    def Slow(self, cntl, request):
        time.sleep(float(request or b"0.05"))
        return b"slow"


def _mk_server(native=True, inline=True):
    opts = ServerOptions()
    opts.native = native
    opts.usercode_inline = inline
    opts.native_loops = 1
    srv = Server(opts)
    srv.add_service(Probe(), name="CL")
    assert srv.start("127.0.0.1:0") == 0
    return srv


def _single_channel(srv, **copt):
    o = ChannelOptions()
    o.connection_type = "single"
    o.timeout_ms = 5000
    for k, v in copt.items():
        setattr(o, k, v)
    ch = Channel(o)
    assert ch.init(str(srv.listen_endpoint)) == 0
    return ch


@pytest.fixture()
def lane_server():
    _require_native()
    srv = _mk_server()
    yield srv
    srv.stop()


def test_eligible_matrix_stays_native(lane_server):
    ch = _single_channel(lane_server, tenant="acme")
    ch.call_method("CL.Echo", b"warm")
    assert ch._sock.lane_token, "the shared connection rides the lane"
    comp0, fb0 = _lane_counts()
    c = ch.call_method("CL.Echo", b"plain")
    assert not c.failed and c.response == b"plain"
    cntl = Controller()
    cntl.timeout_ms = 5000
    c = ch.call_method("CL.Echo", b"deadline", cntl=cntl)
    assert not c.failed and c.response == b"deadline"
    cntl = Controller()
    cntl.trace_id = 0xBEEF01
    c = ch.call_method("CL.Echo", b"traced", cntl=cntl)
    assert not c.failed and c.response == b"traced"
    cntl = Controller()
    cntl.request_attachment = b"A" * 512
    c = ch.call_method("CL.Echo", b"att", cntl=cntl)
    assert not c.failed and bytes(c.response_attachment) == b"A" * 512
    ev = threading.Event()
    out = {}

    def done(cc):
        out["resp"] = cc.response
        out["thread"] = threading.current_thread().name
        ev.set()

    ch.call_method("CL.Echo", b"async", done=done)
    assert ev.wait(5) and out["resp"] == b"async"
    assert not out["thread"].startswith("client-lane")
    comp1, fb1 = _lane_counts()
    assert comp1 - comp0 == 5, "eligible traffic must demux natively"
    assert _fb_delta(fb0, fb1) == {}
    from brpc_tpu_torch.rpcz import global_span_store
    kinds = {s.is_server for s in global_span_store().by_trace(0xBEEF01)}
    assert kinds == {True, False}
    ch.close()


def test_error_response_falls_back_named(lane_server):
    ch = _single_channel(lane_server)
    ch.call_method("CL.Echo", b"warm")
    _, fb0 = _lane_counts()
    c = ch.call_method("CL.Err", b"x")
    assert c.error_code == 1234 and c.error_text == "boom"
    _, fb1 = _lane_counts()
    assert _fb_delta(fb0, fb1) == {"cli_meta_tags": 1}
    ch.close()


def test_stream_frames_fall_back_named():
    _require_native()
    from brpc_tpu_torch.streaming import (StreamOptions, stream_accept,
                                          stream_create)
    got = []
    done = threading.Event()

    class Sink(Service):
        def Start(self, cntl, request):
            def on_received(stream, msgs):
                got.extend(bytes(m) for m in msgs)
                done.set()
            stream_accept(cntl, StreamOptions(on_received=on_received))
            return b"ok"

        def Push(self, cntl, request):
            return b"ok"

    o = ServerOptions()
    o.native = True
    o.usercode_inline = True
    srv = Server(o)
    srv.add_service(Sink(), name="SK")
    assert srv.start("127.0.0.1:0") == 0
    try:
        ch = _single_channel(srv)
        assert ch.call("SK.Push", b"") == b"ok"      # the lane attaches
        _, fb0 = _lane_counts()
        cntl = Controller()
        cntl.timeout_ms = 5000
        received = []
        cdone = threading.Event()

        def on_client(stream, msgs):
            received.extend(bytes(m) for m in msgs)
            cdone.set()

        stream = stream_create(cntl, StreamOptions(on_received=on_client))
        c = ch.call_method("SK.Start", b"", cntl=cntl)
        assert not c.failed, c.error_text
        assert stream.write(b"chunk-1") == 0
        assert done.wait(5) and got[0] == b"chunk-1"
        _, fb1 = _lane_counts()
        d = _fb_delta(fb0, fb1)
        assert set(d) <= {"cli_meta_tags", "cli_stream_frame"}, d
        assert d.get("cli_meta_tags", 0) >= 1     # the stream grant
        stream.close()
        ch.close()
    finally:
        srv.stop()


def test_backup_request_stale_response_handled(lane_server):
    ch = _single_channel(lane_server)
    ch.call_method("CL.Echo", b"warm")
    comp0, fb0 = _lane_counts()
    cntl = Controller()
    cntl.timeout_ms = 5000
    cntl.backup_request_ms = 20
    cntl.max_retry = 1
    c = ch.call_method("CL.Slow", b"0.1", cntl=cntl)
    assert not c.failed and c.response == b"slow"
    assert c.has_backup_request
    consumed = 0
    deadline = time.time() + 5
    while time.time() < deadline:
        comp1, fb1 = _lane_counts()
        consumed = (comp1 - comp0) + (fb1.get("cli_unknown_cid", 0)
                                      - fb0.get("cli_unknown_cid", 0))
        if consumed >= 2:
            break
        time.sleep(0.01)
    assert consumed >= 2, "the loser's response must be consumed"
    c2 = ch.call_method("CL.Echo", b"after")
    assert not c2.failed and c2.response == b"after"
    ch.close()


def _run_matrix(srv):
    out = []
    ch = _single_channel(srv, tenant="cmp")
    c = ch.call_method("CL.Echo", b"ok")
    out.append(("ok", c.error_code, c.response,
                bytes(c.response_attachment)))
    c = ch.call_method("CL.Err", b"x")
    out.append(("err", c.error_code, c.error_text))
    cntl = Controller()
    cntl.timeout_ms = 5000
    cntl.request_attachment = b"B" * 300
    c = ch.call_method("CL.Echo", b"a", cntl=cntl)
    out.append(("att", c.error_code, c.response,
                bytes(c.response_attachment)))
    cntl = Controller()
    cntl.timeout_ms = 30
    cntl.max_retry = 0
    c = ch.call_method("CL.Slow", b"0.5", cntl=cntl)
    out.append(("timeout", c.error_code))
    cntl = Controller()
    cntl.trace_id = 0xCAFE
    c = ch.call_method("CL.Echo", b"t", cntl=cntl)
    out.append(("traced", c.error_code, c.response))
    attached = bool(ch._sock.lane_token)
    ch.close()
    return out, attached


def test_lane_on_off_state_comparison():
    _require_native()
    results = {}
    for lane_on in (True, False):
        set_flag("rpc_native_client_lane", lane_on)
        try:
            srv = _mk_server()
            try:
                results[lane_on] = _run_matrix(srv)
            finally:
                srv.stop()
        finally:
            set_flag("rpc_native_client_lane", True)
    assert results[True][0] == results[False][0]
    assert results[True][1] and not results[False][1]


def test_breaker_feed_identical_on_lane():
    _require_native()
    from brpc_tpu_torch.client.circuit_breaker import \
        global_circuit_breaker_map

    def fed(lane_on):
        set_flag("rpc_native_client_lane", lane_on)
        try:
            srv = _mk_server()
            try:
                ch = _single_channel(srv, enable_circuit_breaker=True)
                for _ in range(4):
                    assert ch.call("CL.Echo", b"x") == b"x"
                ch.close()
                return global_circuit_breaker_map()._node(
                    srv.listen_endpoint) is not None
            finally:
                srv.stop()
        finally:
            set_flag("rpc_native_client_lane", True)

    assert fed(True) == fed(False) is True


def test_lane_flag_off_counts_a_named_decline():
    _require_native()
    set_flag("rpc_native_client_lane", False)
    try:
        srv = _mk_server()
        try:
            before = client_lane_telemetry().get("declined", {}).get(
                "lane_flag_off", 0)
            comp0, _ = _lane_counts()
            ch = _single_channel(srv)
            assert ch.call("CL.Echo", b"reader") == b"reader"
            assert not ch._sock.lane_token
            comp1, _ = _lane_counts()
            assert comp1 == comp0
            assert client_lane_telemetry()["declined"]["lane_flag_off"] \
                == before + 1
            ch.close()
        finally:
            srv.stop()
    finally:
        set_flag("rpc_native_client_lane", True)


@pytest.mark.parametrize("native_server", [True, False],
                         ids=["engine_server", "python_server"])
def test_single_connection_is_shared_and_multiplexed(native_server):
    """Two channels to one peer share the connection, and a fast call
    overtakes a slow one on it (the engine runs the handlers on fibers
    here; the port's Python transport answers a connection in order, so
    there the fast call waits)."""
    _require_native()
    srv = _mk_server(native=native_server, inline=False)
    try:
        a, b = _single_channel(srv), _single_channel(srv)
        a.call("CL.Echo", b"w")
        b.call("CL.Echo", b"w")
        assert a._sock is b._sock
        slow_done = threading.Event()
        a.call_method("CL.Slow", b"0.5", done=lambda c: slow_done.set())
        time.sleep(0.05)
        t0 = time.monotonic()
        assert b.call("CL.Echo", b"quick") == b"quick"
        took = time.monotonic() - t0
        assert slow_done.wait(5)
        if native_server:
            assert took < 0.3, took
        a.close()
        assert b._sock is not None and not b._sock.failed
        assert b.call("CL.Echo", b"still") == b"still"
        b.close()
        assert global_socket_map().peek(srv.listen_endpoint) is None
    finally:
        srv.stop()


# -- the demux on crafted wire bytes ------------------------------------------

def _tlv(tag, data):
    return bytes([tag]) + struct.pack("<I", len(data)) + data


def _resp_frame(cid, payload=b"", extra_meta=b""):
    meta = _tlv(1, struct.pack("<Q", cid)) + extra_meta
    return (b"TRPC" + struct.pack("<II", len(meta) + len(payload),
                                  len(meta)) + meta + payload)


class _DemuxHarness:
    def __init__(self):
        self.m = load()
        self.events = []
        self.cv = threading.Condition()
        self.demux = self.m.ClientDemux(self._cb)
        self.thread = threading.Thread(target=self.demux.run_loop,
                                       daemon=True)
        self.thread.start()
        self.a, self.b = pysock.socketpair()
        self.a.setblocking(False)
        self.token = self.demux.attach(self.a.fileno())
        assert self.demux.arm(self.token)

    def _cb(self, *args):
        with self.cv:
            self.events.append(args)
            self.cv.notify_all()

    def wait_events(self, n, timeout=5.0):
        with self.cv:
            self.cv.wait_for(lambda: len(self.events) >= n, timeout)
            return list(self.events)

    def close(self):
        self.demux.stop()
        self.thread.join(timeout=5)
        self.a.close()
        self.b.close()


def test_demux_unit_reasons_and_completions():
    _require_native()
    h = _DemuxHarness()
    try:
        m = h.m
        assert h.demux.expect(h.token, 7)
        assert h.demux.pending() == 1
        h.b.sendall(_resp_frame(7, b"PAY") + _resp_frame(99, b"zz")
                    + b"TICI" + struct.pack("<I", 1)
                    + struct.pack("<Q", 4242))
        evs = h.wait_events(1)
        _token, status, comps, fbs, acks = evs[0]
        assert status == 0
        assert [(c[0], bytes(c[1]), c[2]) for c in comps] \
            == [(7, b"PAY", 0)]
        assert [f[0] for f in fbs] == [m.CFB_UNKNOWN_CID]
        assert bytes(fbs[0][1]) == _resp_frame(99, b"zz")
        assert list(acks) == [4242]
        assert h.demux.pending() == 0         # completed natively
        assert h.demux.expect(h.token, 8)
        h.b.sendall(_resp_frame(8, b"", _tlv(6, struct.pack("<i", 1003))))
        evs = h.wait_events(2)
        _t, _s, comps, fbs, _a = evs[1]
        assert comps is None and [f[0] for f in fbs] == [m.CFB_META_TAGS]
        assert h.demux.cancel(h.token, 8)     # the entry survived
        h.b.sendall(b"TRPC" + struct.pack("<II", 4, 4) + b"\x00" * 4)
        evs = h.wait_events(3)
        assert [f[0] for f in evs[2][3]] == [m.CFB_META_UNPARSED]
        h.b.sendall(b"*1\r\nPING\r\n")
        evs = h.wait_events(4)
        assert [f[0] for f in evs[3][3]] == [m.CFB_UNKNOWN_MAGIC]
        h.b.sendall(b"more-bytes")
        evs = h.wait_events(5)
        assert [f[0] for f in evs[4][3]] == [m.CFB_UNKNOWN_MAGIC]
        tel = h.demux.telemetry()
        assert set(tel["fallbacks"]) == set(REASONS)
    finally:
        h.close()


def test_demux_unit_stream_frame_and_eof():
    _require_native()
    h = _DemuxHarness()
    try:
        m = h.m
        payload = b"S" * 10
        tstr = (b"TSTR" + bytes([0]) + struct.pack("<Q", 5)
                + struct.pack("<I", len(payload)) + payload)
        h.b.sendall(tstr)
        evs = h.wait_events(1)
        assert [f[0] for f in evs[0][3]] == [m.CFB_STREAM_FRAME]
        assert bytes(evs[0][3][0][1]) == tstr
        assert h.demux.expect(h.token, 11)
        h.b.sendall(_resp_frame(11, b"last"))
        h.b.close()
        deadline = time.time() + 5
        while time.time() < deadline:
            evs = h.wait_events(2)
            if any(e[1] == 1 for e in evs[1:]):
                break
            time.sleep(0.01)
        flat = [c for e in evs[1:] if e[2] for c in e[2]]
        assert [(c[0], bytes(c[1])) for c in flat] == [(11, b"last")]
        assert any(e[1] == 1 for e in evs[1:])
    finally:
        h.demux.stop()
        h.thread.join(timeout=5)
        h.a.close()


def test_unknown_magic_hands_the_connection_to_a_reader():
    """A lane connection that receives bytes of no tpu_std kind is
    detached and converted to the classic dispatcher, as the JAX lane
    converts it; the client messenger then fails it (no client protocol
    claims the bytes), failing the call waiting on it at once."""
    _require_native()
    lsock = pysock.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    ep = "127.0.0.1:%d" % lsock.getsockname()[1]

    def serve():
        c, _ = lsock.accept()
        c.recv(65536)
        c.sendall(b"HTTP/1.1 200 OK\r\n\r\n")
        time.sleep(2)
        c.close()

    threading.Thread(target=serve, daemon=True).start()
    try:
        o = ChannelOptions()
        o.max_retry = 0
        o.timeout_ms = 5000
        ch = Channel(o)
        assert ch.init(ep) == 0
        _, fb0 = _lane_counts()
        t0 = time.monotonic()
        c = ch.call_method("X.Y", b"")
        assert c.failed and time.monotonic() - t0 < 1.5
        _, fb1 = _lane_counts()
        assert _fb_delta(fb0, fb1) == {"cli_unknown_magic": 1}
        ch.close()
    finally:
        lsock.close()


def test_drain_settle_waits_for_the_table():
    _require_native()
    srv = _mk_server()
    try:
        ch = _single_channel(srv)
        ch.call("CL.Echo", b"warm")
        done = threading.Event()
        ch.call_method("CL.Slow", b"0.3", done=lambda c: done.set())
        time.sleep(0.05)
        assert client_lane.pending_inflight() >= 1
        # a deadline already past returns what is left at once
        assert client_lane.drain_settle(time.monotonic()) >= 1
        assert client_lane.drain_settle(time.monotonic() + 5) == 0
        assert done.wait(5)
        ch.close()
    finally:
        srv.stop()


def test_reasons_mirror_engine_enum():
    src = open(SOURCE).read()
    body = re.search(r"enum CliFb : int \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"\b(CFB_[A-Z_]+)\b", body)
    assert names[-1] == "CFB_REASONS"
    enum = [n[len("CFB_"):].lower() for n in names[:-1]]
    assert tuple("cli_" + n for n in enum) == REASONS
    table = re.search(r"kCliFbNames\[CFB_REASONS\] = \{(.*?)\};", src,
                      re.S).group(1)
    assert tuple(re.findall(r'"([a-z_]+)"', table)) == REASONS
    assert os.path.basename(SOURCE) == "engine.cpp"
