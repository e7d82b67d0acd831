"""The port's deadline plane held against the JAX package's, on the CPU
(after ``tests/test_deadline_plane.py``'s classic-lane cases):

- a request whose propagated deadline expired before dispatch is shed
  with ``ERPCTIMEDOUT`` and no handler run, counted in
  ``deadline_shed_total{lane="tpu_std",method}``: a raw frame and a JAX
  client on the port's server, the port's client on a JAX server; the
  ``enable_deadline_shed`` flag lets it through;
- the server controller's deadline API; a handler's downstream call
  inheriting the remaining budget, and failing fast once it is gone;
- ``RetryBudget`` and ``backoff_ms`` given the same sequences in both
  packages; the budget capping retries against a dead port, a backup
  drawing from it, backoff spacing; a pooled backup that wins, a backup
  on the single connection that can only lose;
- each attempt's correlation id and TLV-13 budget on the wire, and
  ``retried_count``/``has_backup_request``, equal to the JAX client's.
"""

import importlib
import sys
import threading
import time

import pytest

from brpc_tpu import deadline as jdl
from brpc_tpu.butil import flags as jflags
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import ChannelOptions as JChannelOptions
from brpc_tpu.client import Controller as JController
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu_torch import deadline as tdl
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
from brpc_tpu_torch.server import Server

from torch_overload_cases import (HoldSvc, Recorder, connect, frame,
                                  read_frames, wait_for)

TIMEDOUT = int(Errno.ERPCTIMEDOUT)
# the modules (each package's ``butil`` exports the function under the
# module's name)
jfr = importlib.import_module("brpc_tpu.butil.fast_rand")
tfr = importlib.import_module("brpc_tpu_torch.butil.fast_rand")


class JHoldSvc(HoldSvc, JService):
    pass


def _port_server(svc=None, name="D"):
    svc = svc or HoldSvc()
    srv = Server()
    assert srv.add_service(svc, name=name) == 0
    assert srv.start("127.0.0.1:0") == 0
    return srv, svc


def _jax_server(name="D"):
    svc = JHoldSvc()
    srv = JServer()
    assert srv.add_service(svc, name=name) == 0
    assert srv.start("127.0.0.1:0") == 0
    return srv, svc


def _delta(mod, before, method):
    after = mod.shed_counters()
    key = ("tpu_std", method)
    return after.get(key, 0) - before.get(key, 0)


# -- the shed -----------------------------------------------------------------

def test_shed_raw_frame_expired_at_arrival():
    """An explicit on-wire budget of 0 is answered ERPCTIMEDOUT before the
    handler; the port's MethodStatus counts the error."""
    srv, svc = _port_server()
    try:
        before = tdl.shed_counters()
        with connect(srv.listen_endpoint) as c:
            c.sendall(frame(b"D", 11, b"Echo", b"doomed", timeout_ms=0))
            metas = read_frames(c, 1)
        assert metas[11].error_code == TIMEDOUT
        assert "doomed work shed" in metas[11].error_text
        assert svc.echo_calls == []
        assert _delta(tdl, before, "D.Echo") == 1
        assert srv.method_status("D.Echo").errors.get_value() == 1
    finally:
        srv.stop()


def _held_behind_a_slow_call(make, client, then=None):
    """Two calls on one connection, the second (100 ms budget) sent
    while a 300 ms handler runs: ``(error code of the second, the shed
    counter's delta)`` once the second has run; ``then(channel)`` runs
    before the server stops."""
    srv, svc = make()
    dl = tdl if make is _port_server else jdl
    try:
        before = dl.shed_counters()
        ch = (JChannel if client == "jax" else Channel)()
        assert ch.init(str(srv.listen_endpoint)) == 0
        out = {}
        slow = threading.Thread(target=lambda: out.__setitem__(
            "slow", ch.call("D.Sleep", b"0.3", timeout_ms=5000)))
        slow.start()
        wait_for(lambda: srv.inflight == 1, what="the slow call")
        cntl = (JController if client == "jax" else Controller)()
        cntl.timeout_ms = 100
        ch.call_method("D.Echo", b"late", cntl=cntl)
        assert "slow" not in out       # held back: it timed out first
        slow.join(10)
        assert out["slow"] == b"slept"
        # read once the slow handler returned, with a fresh arrival
        # stamp: run, not shed, its answer dropped by the caller
        wait_for(lambda: svc.echo_calls == [b"late"], what="its run")
        if then is not None:
            then(ch)
        return cntl.error_code, _delta(dl, before, "D.Echo")
    finally:
        srv.stop()


def test_shed_queued_behind_a_slow_call_from_a_jax_client():
    """A JAX client's two calls on its one connection: the second, sent
    while a 300 ms handler runs, waits in the kernel -- the server runs
    the gulp's last message inline, as the JAX server does -- so its
    caller times out at its 100 ms budget, and the server reads it when
    the handler returns and runs it, unshed, its arrival stamped at that
    read.  The JAX server does the same.  (The port's in-order worker,
    gone, read it at once and shed it: ROADMAP C9.)"""
    for make in (_port_server, _jax_server):
        code, shed = _held_behind_a_slow_call(make, "jax")
        assert (code, shed) == (TIMEDOUT, 0), make.__name__


def test_shed_queued_behind_a_slow_call_on_the_ports_single_connection():
    """The port's client multiplexes two threads' calls on its one
    connection: the second is held back behind a 300 ms handler past
    its 100 ms budget and times out, the server runs it when the handler
    returns (unshed, as the JAX server does), the first's answer comes
    back, and the connection keeps serving four threads' calls at once
    (the late answer is dropped without error)."""
    def four_at_once(ch):
        res = []
        ts = [threading.Thread(target=lambda i=i: res.append(
            ch.call("D.Echo", b"%d" % i, timeout_ms=5000)))
            for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert sorted(res) == [b"ok:0", b"ok:1", b"ok:2", b"ok:3"]
        ch.close()

    for make in (_port_server, _jax_server):
        code, shed = _held_behind_a_slow_call(make, "port", four_at_once)
        assert (code, shed) == (TIMEDOUT, 0), make.__name__


@pytest.mark.parametrize("ctype", ["single", "pooled"])
def test_many_callers_get_their_own_answers(ctype):
    """16 threads x 12 calls on one channel with the interpreter switching
    threads every 10 µs: each call gets the answer to its own request
    (the single connection hands responses over by correlation id), none
    fails, and the server settles every one."""
    import sys
    srv, svc = _port_server()
    co = ChannelOptions()
    co.connection_type = ctype
    co.timeout_ms = 30_000
    ch = Channel(co)
    ch.init(str(srv.listen_endpoint))
    bad = []
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def caller(i):
            for j in range(12):
                req = b"%d-%d" % (i, j)
                c = ch.call_method("D.Echo", req)
                if c.failed or c.response != b"ok:" + req:
                    bad.append((req, c.error_code, c.response))

        ts = [threading.Thread(target=caller, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(prev)
        ch.close()
        srv.stop()
    assert bad == []
    assert len(svc.echo_calls) == 16 * 12
    assert srv.inflight == 0


@pytest.mark.parametrize("side", ["jax-client-port-server",
                                  "port-client-jax-server"])
def test_shed_across_the_packages(monkeypatch, side):
    """Each server sees every request as having waited 10 s past its
    arrival (its shed clock moved on): the other package's client gets
    that server's ERPCTIMEDOUT, and no handler runs."""
    if side == "jax-client-port-server":
        srv, svc = _port_server()
        mod, ch, cntl = tdl, JChannel(), JController()
    else:
        srv, svc = _jax_server()
        mod, ch, cntl = jdl, Channel(), Controller()
    real = mod.monotonic_us
    monkeypatch.setattr(mod, "monotonic_us", lambda: real() + 10_000_000)
    try:
        before = mod.shed_counters()
        assert ch.init(str(srv.listen_endpoint)) == 0
        cntl.timeout_ms = 2000
        cntl.max_retry = 0
        ch.call_method("D.Echo", b"doomed", cntl=cntl)
        assert cntl.error_code == TIMEDOUT
        assert "doomed work shed" in cntl.error_text
        assert svc.echo_calls == []
        assert _delta(mod, before, "D.Echo") == 1
    finally:
        srv.stop()


def test_shed_togglable_via_flag():
    """``enable_deadline_shed=False`` lets an expired request through."""
    srv, svc = _port_server()
    prev = tflags.get_flag("enable_deadline_shed")
    tflags.set_flag("enable_deadline_shed", False)
    try:
        with connect(srv.listen_endpoint) as c:
            c.sendall(frame(b"D", 41, b"Echo", b"letin", timeout_ms=0))
            metas = read_frames(c, 1)
        assert metas[41].error_code == 0
        assert svc.echo_calls == [b"letin"]
        # the JAX package's flag is its own
        assert jflags.get_flag("enable_deadline_shed") is True
    finally:
        tflags.set_flag("enable_deadline_shed", prev)
        srv.stop()


# -- the controller API and inheritance ----------------------------------------

@pytest.mark.parametrize("client", ["port", "jax"])
def test_server_controller_deadline_api(client):
    srv, svc = _port_server()
    try:
        if client == "port":
            co = ChannelOptions()
            co.connection_type = "pooled"
            ch, cntl = Channel(co), Controller()
        else:
            ch, cntl = JChannel(), JController()
        ch.init(str(srv.listen_endpoint))
        cntl.timeout_ms = 3000
        ch.call_method("D.Echo", b"x", cntl=cntl)
        assert not cntl.failed, cntl.error_text
        rem = svc.seen_remaining[-1]
        assert rem is not None and 0 < rem <= 3000
    finally:
        srv.stop()


class _Front:
    """A port service whose handler calls ``downstream`` on its own call
    stack, with no timeout of its own (the inherited budget supplies
    it)."""

    def __init__(self, downstream, nap_s):
        self.downstream, self.nap_s = downstream, nap_s
        self.codes = []

    def Relay(self, cntl, request):
        time.sleep(self.nap_s)
        co = ChannelOptions()
        co.connection_type = "pooled"
        co.timeout_ms = 0
        ch = Channel(co)
        ch.init(str(self.downstream))
        sub = Controller()
        ch.call_method("D.Echo", b"inner", cntl=sub)
        self.codes.append(sub.error_code)
        ch.close()
        return b"relayed"


@pytest.mark.parametrize("down", ["port", "jax"])
def test_downstream_call_inherits_remaining_budget(down):
    down_srv, down_svc = _port_server() if down == "port" else _jax_server()
    front = _Front(down_srv.listen_endpoint, 0.05)
    fsrv, _ = _port_server(front, name="F")
    try:
        ch, cntl = Channel(), Controller()
        ch.init(str(fsrv.listen_endpoint))
        cntl.timeout_ms = 2000
        ch.call_method("F.Relay", b"", cntl=cntl)
        assert not cntl.failed, cntl.error_text
        assert front.codes == [0]
        rem = down_svc.seen_remaining[-1]
        assert rem is not None and 0 < rem <= 1980
    finally:
        fsrv.stop()
        down_srv.stop()


def test_downstream_call_fails_fast_after_budget_gone():
    """Past its 150 ms budget the handler's downstream call fails
    ERPCTIMEDOUT without dispatching: the downstream handler never
    runs."""
    down_srv, down_svc = _jax_server()
    front = _Front(down_srv.listen_endpoint, 0.3)
    fsrv, _ = _port_server(front, name="F")
    try:
        ch, cntl = Channel(), Controller()
        ch.init(str(fsrv.listen_endpoint))
        cntl.timeout_ms = 150
        cntl.max_retry = 0
        ch.call_method("F.Relay", b"", cntl=cntl)
        assert cntl.error_code == TIMEDOUT
        wait_for(lambda: front.codes, what="the relay's downstream call")
        assert front.codes == [TIMEDOUT]
        assert down_svc.echo_calls == []
    finally:
        fsrv.stop()
        down_srv.stop()


def test_cap_timeout_ms_matches_jax():
    class C:
        deadline_us = 0
    for mod in (jdl, tdl):
        assert mod.cap_timeout_ms(250) == (250, False)
    out = []
    for mod in (jdl, tdl):
        c = C()
        c.deadline_us = mod.monotonic_us() + 400_000
        row = []
        with mod.inherit_deadline(c):
            for t in (None, 0, 100, 10_000):
                eff, expired = mod.cap_timeout_ms(t)
                row.append((eff <= 400 and eff >= 300, expired))
        c.deadline_us = mod.monotonic_us() - 1
        with mod.inherit_deadline(c):
            row.append(mod.cap_timeout_ms(100))
        assert mod.ambient_deadline_us() == 0
        out.append(row)
    assert out[0] == out[1]
    assert out[1][1] == (True, False) and out[1][-1] == (0, True)
    assert tdl.parse_deadline_ms(b" 25 ") == jdl.parse_deadline_ms(b" 25 ")
    assert tdl.parse_deadline_ms("x") is jdl.parse_deadline_ms("x") is None


# -- retry hardening ------------------------------------------------------------

def test_retry_budget_sequences_match():
    ops = ["a", "a", "a", "s", "a", "a"] + ["s"] * 7 + ["a"] * 5 \
        + ["s"] * 100 + ["a"]
    rows = []
    for mod in (jdl, tdl):
        b = mod.RetryBudget(max_tokens=4, token_ratio=0.5)
        row = []
        for op in ops:
            if op == "a":
                row.append(b.acquire())
            else:
                b.on_success()
            row.append(b.tokens)
        rows.append((row, b.denied_count))
    assert rows[0] == rows[1]
    assert rows[1][1] > 0 and rows[1][0][-1] == 3.0


def test_backoff_ms_sequences_match(monkeypatch):
    """The same jitter draws give the same delays in both packages."""
    draws = [0, 9_999, 5_000, 1234, 77_777_777, 42] * 8
    out = []
    for mod, fr in ((jdl, jfr), (tdl, tfr)):
        it = iter(draws)
        monkeypatch.setattr(fr, "fast_rand", lambda: next(it))
        out.append([mod.backoff_ms(b, n, m, j)
                    for b, n, m, j in ((50, 1, 5000, 0.2), (50, 3, 5000, 0.2),
                                       (1000, 10, 3000, 0.2), (0, 3, 5000, 0.2),
                                       (80, 2, 5000, 0.0), (80, 0, 5000, 0.2),
                                       (10, 40, 1 << 40, 0.5),
                                       (7, 2, 5000, 0.2))])
    assert out[0] == out[1]
    monkeypatch.undo()
    d1 = [tdl.backoff_ms(50, 1) for _ in range(50)]
    assert all(40.0 <= d <= 60.0 for d in d1) and len(set(d1)) > 1


def _dead_port_calls(package):
    if package == "port":
        co, ch_cls, cntl_cls = ChannelOptions(), Channel, Controller
    else:
        co, ch_cls, cntl_cls = JChannelOptions(), JChannel, JController
    co.timeout_ms = 2000
    co.max_retry = 3
    co.retry_budget_max = 4
    ch = ch_cls(co)
    assert ch.init("127.0.0.1:1") == 0      # nothing listens here
    retries = []
    for _ in range(6):
        cntl = cntl_cls()
        cntl.timeout_ms = 2000
        c = ch.call_method("D.Echo", b"x", cntl=cntl)
        assert c.failed
        retries.append(c.retried_count)
    return retries, ch.retry_budget().denied_count


def test_channel_retry_budget_caps_attempts():
    """4 tokens: exactly 2 retries are ever granted, then the budget
    gates, in both packages."""
    mine, theirs = _dead_port_calls("port"), _dead_port_calls("jax")
    assert mine == theirs
    assert sum(mine[0]) == 2 and mine[1] > 0


def test_backup_request_draws_from_budget():
    srv, svc = _port_server()
    try:
        co = ChannelOptions()
        co.timeout_ms = 2000
        co.backup_request_ms = 50
        co.connection_type = "pooled"
        co.retry_budget_max = 4
        ch = Channel(co)
        ch.init(str(srv.listen_endpoint))
        budget = ch.retry_budget()
        while budget.acquire():
            pass
        cntl = Controller()
        ch.call_method("D.Sleep", b"0.3", cntl=cntl)
        assert not cntl.failed, cntl.error_text
        assert not cntl.has_backup_request and cntl.retried_count == 0
        time.sleep(0.1)
        assert srv.method_status("D.Sleep").latency.count() == 1
    finally:
        srv.stop()


def test_backoff_spaces_retries():
    co = ChannelOptions()
    co.timeout_ms = 5000
    co.max_retry = 2
    co.retry_backoff_ms = 80
    ch = Channel(co)
    assert ch.init("127.0.0.1:1") == 0
    t0 = time.monotonic()
    c = ch.call_method("D.Echo", b"x")
    elapsed = time.monotonic() - t0
    assert c.failed and c.error_code == int(Errno.EFAILEDSOCKET)
    assert c.retried_count == 2
    # backoff 80 + 160 ms (±20% jitter) shows in wall time
    assert elapsed >= 0.18, elapsed


class _FirstSlow(HoldSvc):
    """``Nap``: the first call sleeps 1.5 s, the later ones answer at
    once."""

    def __init__(self):
        super().__init__()
        self.naps = 0

    def Nap(self, cntl, request):
        self.naps += 1
        if self.naps == 1:
            time.sleep(1.5)
            return b"primary"
        return b"backup"


@pytest.mark.parametrize("ctype", ["pooled", "short"])
def test_pooled_backup_wins(ctype):
    srv, svc = _port_server(_FirstSlow())
    try:
        co = ChannelOptions()
        co.timeout_ms = 5000
        co.backup_request_ms = 100
        co.connection_type = ctype
        ch = Channel(co)
        ch.init(str(srv.listen_endpoint))
        t0 = time.monotonic()
        c = ch.call_method("D.Nap", b"")
        elapsed = time.monotonic() - t0
        assert not c.failed, c.error_text
        assert c.response == b"backup"
        assert c.has_backup_request and c.retried_count == 1
        assert elapsed < 1.2, elapsed
        # the channel serves the next call: the loser's connection closed
        # (pooled: the winner's went back to the pool)
        assert ch.call("D.Echo", b"next", timeout_ms=5000) == b"ok:next"
        ch.close()
    finally:
        srv.stop()


def test_backup_on_the_single_connection_can_only_lose():
    """On ``"single"`` the backup is sent but queues behind its primary on
    the in-order server: the primary's answer wins, and the backup's
    late answer is dropped without error."""
    srv, svc = _port_server(_FirstSlow())
    try:
        co = ChannelOptions()
        co.timeout_ms = 5000
        co.backup_request_ms = 100
        ch = Channel(co)
        ch.init(str(srv.listen_endpoint))
        c = ch.call_method("D.Nap", b"")
        assert not c.failed, c.error_text
        assert c.response == b"primary"
        assert c.has_backup_request and c.retried_count == 1
        wait_for(lambda: svc.naps == 2, what="the backup's run")
        assert ch.call("D.Echo", b"next", timeout_ms=5000) == b"ok:next"
        ch.close()
    finally:
        srv.stop()


def _recorded(package, script, **opts):
    rec = Recorder(script)
    try:
        if package == "port":
            co, ch_cls, cntl_cls = ChannelOptions(), Channel, Controller
        else:
            co, ch_cls, cntl_cls = JChannelOptions(), JChannel, JController
        for k, v in opts.items():
            setattr(co, k, v)
        ch = ch_cls(co)
        assert ch.init(rec.addr) == 0
        cntl = cntl_cls()
        cntl.timeout_ms = 3000
        c = ch.call_method("R.Any", b"q", cntl=cntl)
        out = (c.error_code, bytes(c.response or b""), c.retried_count,
               c.has_backup_request)
        time.sleep(0.1)
        frames = list(rec.frames)
        base = frames[0][1]
        # (connection, cid offset, budget within the call's timeout)
        wire = [(conn, cid - base, 0 < t <= 3000) for conn, cid, t in frames]
        return out, wire
    finally:
        rec.close()


@pytest.mark.parametrize("case", ["retries-pooled", "retries-short",
                                  "backup"])
def test_attempts_on_the_wire_match_jax(case):
    """Against a recording server: the connection each attempt rode, its
    correlation id's offset from the call's first, and its TLV-13 budget,
    with the call's outcome, equal between the packages."""
    if case.startswith("retries"):
        # two attempts dropped unanswered, the third answered (on the JAX
        # client's "single" connection a retry right after a drop fails
        # EEOF until its health check revives the socket, where the
        # port's reconnects: the wire is compared on connections of the
        # attempts' own)
        def script(n):
            return "close" if n < 2 else ("answer", 0.0)
        opts = dict(max_retry=3, connection_type=case.split("-")[1])
    else:
        # the primary answered late, the backup at once
        def script(n):
            return ("answer", 0.8) if n == 0 else ("answer", 0.0)
        opts = dict(backup_request_ms=100, connection_type="pooled")
    mine = _recorded("port", script, **opts)
    theirs = _recorded("jax", script, **opts)
    assert mine == theirs
    if case.startswith("retries"):
        assert mine[0] == (0, b"answer-2", 2, False)
        assert [w[1] for w in mine[1]] == [0, 1, 2]
    else:
        assert mine[0] == (0, b"answer-1", 1, True)
        assert [w[:2] for w in mine[1]] == [(0, 0), (1, 1)]


# -- the KV handoff inherits the Decode's budget ---------------------------------

KV_CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)


def _doomed_handoff(package, cached, monkeypatch):
    """A prefill tier of ``package`` whose prefill outlasts the Decode's
    150 ms budget: its handoff RPCs, issued on the handler's stack,
    inherit the spent budget and fail fast.  Returns the fallback
    counters' deltas."""
    import jax
    import numpy as np
    if package == "port":
        from brpc_tpu_torch.kv import (DecodeTierService, PrefillService,
                                       disagg as dis, pages, transport)
        from brpc_tpu_torch.models import lm_service as svc_mod
        from brpc_tpu_torch.models import transformer_lm as lm
        from brpc_tpu_torch.streaming import StreamOptions, stream_create
        from brpc_tpu_torch.utils.convert import params_from_numpy
        jp = jax.tree_util.tree_map(np.asarray, _jax_params())
        params = params_from_numpy(jp, device="cpu")
        kw = dict(device="cpu")
        srv_cls, ch_cls, cntl_cls = Server, Channel, Controller
    else:
        from brpc_tpu import streaming as jst
        from brpc_tpu.kv import (DecodeTierService, PrefillService,
                                 disagg as dis, pages, transport)
        from brpc_tpu.models import lm_service as svc_mod
        from brpc_tpu.models import transformer_lm as lm
        params, kw = _jax_params(), {}
        stream_create, StreamOptions = jst.stream_create, jst.StreamOptions
        srv_cls, ch_cls, cntl_cls = JServer, JChannel, JController
    pages._reset_for_tests()
    transport._reset_for_tests()
    cfg = lm.LMConfig(**KV_CFG)
    dec = svc_mod.LMService(cfg=cfg, params=params, decode_slots=2, **kw)
    dsrv = srv_cls()
    assert dsrv.add_service(dec, name="LM") == 0
    assert dsrv.add_service(DecodeTierService(dec), name="KV") == 0
    assert dsrv.start("127.0.0.1:0") == 0
    dch = ch_cls()
    dch.init(str(dsrv.listen_endpoint))
    pre = PrefillService(cfg=cfg, params=params, decode_channel=dch,
                         decode_slots=2, **kw)
    psrv = srv_cls()
    assert psrv.add_service(pre, name="LM") == 0
    assert psrv.start("127.0.0.1:0") == 0
    prompt = np.arange(1, 9, dtype=np.int32)[None]
    req = svc_mod.pack_generate_request(prompt, 4)

    def decode(timeout_ms):
        ch, cntl = ch_cls(), cntl_cls()
        ch.init(str(psrv.listen_endpoint))
        cntl.timeout_ms = timeout_ms
        cntl.max_retry = 0
        closed = threading.Event()
        stream_create(cntl, StreamOptions(on_closed=lambda s: closed.set()))
        return ch.call_method("LM.Decode", req, cntl=cntl), closed

    try:
        if cached:
            c, closed = decode(30_000)     # a handoff that caches the probe
            assert not c.failed, c.error_text
            assert closed.wait(30)
        before = transport.kv_fallback_counters()
        real = dis.bucketed_prefill

        def slow(*a, **k):
            time.sleep(0.3)
            return real(*a, **k)

        monkeypatch.setattr(dis, "bucketed_prefill", slow)
        c, _ = decode(150)
        assert c.error_code == TIMEDOUT
        wait_for(lambda: transport.kv_fallback_counters() != before, 30,
                 "the handoff's outcome")
        after = transport.kv_fallback_counters()
        return {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)}
    finally:
        monkeypatch.undo()
        psrv.stop()
        dsrv.stop()
        for svc_obj in (pre, dec):
            if package == "port" and svc_obj._batcher is not None:
                svc_obj._batcher.shutdown()
        pages._reset_for_tests()
        transport._reset_for_tests()


_JP = []


def _jax_params():
    if not _JP:
        import jax
        from brpc_tpu.models import transformer_lm as jlm
        _JP.append(jlm.init_params(jax.random.PRNGKey(0),
                                   jlm.LMConfig(**KV_CFG)))
    return _JP[0]


@pytest.mark.parametrize("cached", [False, True],
                         ids=["probe-uncached", "probe-cached"])
def test_doomed_handoff_ends_at_the_jax_reason(cached, monkeypatch):
    """Before the probe is cached the handoff ends at ``kv_probe_failed``
    (and the tier decodes locally); after, the import fails fast and ends
    at ``kv_import_rejected``: the same reason in both packages."""
    mine = _doomed_handoff("port", cached, monkeypatch)
    theirs = _doomed_handoff("jax", cached, monkeypatch)
    assert mine == theirs
    assert mine == ({"kv_import_rejected": 1} if cached
                    else {"kv_probe_failed": 1})


class _SlowThenFast(HoldSvc):
    """``Nap``: the first call of each round sleeps 0.2 s, the next
    answers at once."""

    def __init__(self):
        super().__init__()
        self.naps = 0

    def Nap(self, cntl, request):
        self.naps += 1
        if self.naps % 2:
            time.sleep(0.2)
            return b"primary"
        return b"backup"


def test_backup_on_the_single_connection_loses_every_time():
    """The race behind the test above, stressed: the primary's and the
    backup's answers arrive back to back on one connection, and the
    attempt threads are switched every instruction; the primary's answer,
    which arrived first, must win every round."""
    srv, svc = _port_server(_SlowThenFast())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        won = []
        for i in range(12):
            co = ChannelOptions()
            co.timeout_ms = 5000
            co.backup_request_ms = 30
            ch = Channel(co)
            ch.init(str(srv.listen_endpoint))
            c = ch.call_method("D.Nap", b"")
            assert not c.failed, c.error_text
            won.append(c.response)
            wait_for(lambda: svc.naps == 2 * (i + 1), what="the backup")
            ch.close()
        assert won == [b"primary"] * 12
    finally:
        sys.setswitchinterval(old)
        srv.stop()
