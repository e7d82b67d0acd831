"""The port's drain plane held against the JAX package's, on the CPU
(after ``tests/test_operability.py``'s classic-lane cases):

- ``join`` waits for in-flight work to settle, bounded by the grace;
- ``drain`` finishes in-flight work (its response carries the lame-duck
  TLV) while a new request gets ``ELAMEDUCK`` with the TLV, seen through
  the JAX package's meta decoder and by a JAX client, which marks the
  server lame; grace expiry force-closes the connection with
  ``drain_grace_expired``; staged shm slots settle; the
  ``server_drain_state`` and ``drain_inflight_remaining`` gauges read the
  drain; ``graceful_quit_on_sigterm`` drains a child process;
- the slice as a whole: both packages' servers, on the same seeded
  params, drain during live paged Decode streams (one of them spilled to
  the host tier): every stream ends ``lame_duck`` with a prefix of its
  solo tokens, the prefixes agree between the packages, and both reach
  zero pages held by sessions, zero host spills in flight and zero
  exported pages.
"""

import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from brpc_tpu import streaming as jstreaming
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import Controller as JController
from brpc_tpu.client.naming_service import global_lame_ducks
from brpc_tpu.kv import pages as jpages
from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.server import Server as JServer
from brpc_tpu_torch.butil.flags import get_flag, set_flag
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.bvar.variable import find_exposed
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.kv import pages as tpages
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.server.server import DRAIN_FORCE_CLOSE_REASON
from brpc_tpu_torch.streaming import StreamOptions, stream_create
from brpc_tpu_torch.transport import shm_ring
from brpc_tpu_torch.utils.convert import params_from_numpy

from torch_overload_cases import HoldSvc, connect, frame, read_frames, \
    wait_for

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELAMEDUCK = int(Errno.ELAMEDUCK)


def _server(svc=None):
    svc = svc or HoldSvc()
    srv = Server()
    assert srv.add_service(svc, name="OP") == 0
    assert srv.start("127.0.0.1:0") == 0
    return srv, svc


def _hold(srv, svc, cid=900):
    c = connect(srv.listen_endpoint)
    c.sendall(frame(b"OP", cid, b"Hold"))
    wait_for(lambda: svc.holding >= 1, what="the held call")
    return c


def _drain_on_thread(srv, grace_ms=5000):
    out = {}
    t = threading.Thread(target=lambda: out.__setitem__(
        "rc", srv.drain(grace_ms)), daemon=True)
    t.start()
    wait_for(lambda: srv.draining, what="the drain's start")
    return t, out


# -- join ----------------------------------------------------------------------

def test_join_waits_for_inflight_settle():
    srv, svc = _server()
    conn = _hold(srv, svc)
    try:
        released = [0.0]

        def releaser():
            time.sleep(0.4)
            released[0] = time.monotonic()
            svc.release.set()

        threading.Thread(target=releaser, daemon=True).start()
        stopper = threading.Thread(target=srv.stop)
        stopper.start()
        srv.join(timeout=5)
        assert released[0] and time.monotonic() >= released[0] - 0.01
        assert srv.inflight == 0
        stopper.join(10)
    finally:
        svc.release.set()
        conn.close()
        srv.stop()


def test_join_bounded_by_drain_grace():
    srv, svc = _server()
    conn = _hold(srv, svc)
    old = get_flag("drain_grace_ms")
    set_flag("drain_grace_ms", 300)
    try:
        stopper = threading.Thread(target=srv.stop)
        stopper.start()
        t0 = time.monotonic()
        srv.join(timeout=5)
        assert time.monotonic() - t0 < 2.0
        assert srv.inflight == 1          # still held: join gave up
    finally:
        set_flag("drain_grace_ms", old)
        svc.release.set()
        stopper.join(10)
        conn.close()


# -- drain ---------------------------------------------------------------------

def test_drain_finishes_inflight_and_answers_lame_duck():
    """An in-flight request finishes during the drain with the lame-duck
    TLV; a new one on an open connection gets ELAMEDUCK with the TLV
    (read by the JAX package's decoder), and a JAX client's call gets
    ELAMEDUCK and marks the server lame; drain returns 0 once the
    in-flight request settles."""
    srv, svc = _server()
    probe = connect(srv.listen_endpoint)
    jch = JChannel()
    assert jch.init(str(srv.listen_endpoint)) == 0
    assert jch.call("OP.Echo", b"warm") == b"ok:warm"
    held = _hold(srv, svc)
    global_lame_ducks().reset()
    try:
        t, out = _drain_on_thread(srv)
        probe.sendall(frame(b"OP", 51, b"Echo", b"probe"))
        meta = read_frames(probe, 1)[51]
        assert (meta.error_code, meta.lame_duck) == (ELAMEDUCK, 1)
        cntl = JController()
        cntl.max_retry = 0
        jch.call_method("OP.Echo", b"jax-probe", cntl=cntl)
        assert cntl.error_code == ELAMEDUCK
        assert global_lame_ducks().is_lame(cntl.remote_side)
        assert svc.echo_calls == [b"warm"]
        assert t.is_alive()                # still waiting on the hold
        assert find_exposed("server_drain_state").get_value() == 1
        assert find_exposed("drain_inflight_remaining").get_value() == 1
        svc.release.set()
        t.join(5)
        assert out.get("rc") == 0
        meta = read_frames(held, 1)[900]
        assert (meta.error_code, meta.lame_duck) == (0, 1)
        assert srv.drain_phase == "draining"
        srv.stop()
        assert srv.drain_phase == "stopped"
        assert find_exposed("server_drain_state").get_value() == 0
        assert find_exposed("drain_inflight_remaining").get_value() == 0
    finally:
        svc.release.set()
        probe.close()
        held.close()
        srv.stop()
        global_lame_ducks().reset()


def test_drain_refuses_a_stream_open():
    """A Decode-style stream open that reaches a draining server is
    answered ELAMEDUCK before its handler could accept it: the client's
    pending stream closes with the failed call."""
    class Streamer(HoldSvc):
        def Open(self, cntl, request):
            from brpc_tpu_torch.streaming import stream_accept
            stream_accept(cntl, StreamOptions())
            return b"opened"

    srv, svc = _server(Streamer())
    held = _hold(srv, svc)
    ch = Channel()
    ch.init(str(srv.listen_endpoint))
    assert ch.call("OP.Echo", b"warm") == b"ok:warm"
    try:
        t, out = _drain_on_thread(srv)
        cntl = Controller()
        closed = []
        st = stream_create(cntl, StreamOptions(
            on_closed=lambda s: closed.append(s)))
        ch.call_method("OP.Open", b"", cntl=cntl)
        assert cntl.error_code == ELAMEDUCK
        assert st.closed and closed == [st]
        svc.release.set()
        t.join(5)
        assert out.get("rc") == 0
    finally:
        svc.release.set()
        ch.close()
        held.close()
        srv.stop()


def test_drain_closes_accepted_streams_with_lame_duck():
    """Streams the server accepted end with the named reason, after the
    data already written, all within one settle window."""
    from brpc_tpu_torch.streaming import server_streams, stream_accept

    class Streamer(HoldSvc):
        def __init__(self):
            super().__init__()
            self.streams = []

        def Open(self, cntl, request):
            s = stream_accept(cntl, StreamOptions())
            self.streams.append(s)
            return b"opened"

    svc = Streamer()
    srv, _ = _server(svc)
    ch = Channel()
    ch.init(str(srv.listen_endpoint))
    try:
        got, reasons = [], []
        for _ in range(4):
            cntl = Controller()
            stream_create(cntl, StreamOptions(
                on_received=lambda s, msgs: got.extend(msgs),
                on_closed=lambda s: reasons.append(s.close_reason)))
            assert not ch.call_method("OP.Open", b"", cntl=cntl).failed
        wait_for(lambda: len(svc.streams) == 4, what="the accepts")
        assert set(server_streams(srv)) == set(svc.streams)
        for s in svc.streams:
            assert s.write(b"tok") == 0
        # each stream's window stays unacked (acks come at half a
        # window): the four share one 0.25 s settle, where the JAX
        # package waits for each in turn
        t0 = time.monotonic()
        assert srv.drain(2000) == 0
        assert time.monotonic() - t0 < 0.6
        wait_for(lambda: len(reasons) == 4, what="the closes")
        assert reasons == ["lame_duck"] * 4
        assert got == [b"tok"] * 4
        assert server_streams(srv) == []
    finally:
        ch.close()
        srv.stop()


def test_drain_grace_expiry_force_closes_with_named_reason():
    srv, svc = _server()
    conn = _hold(srv, svc)
    try:
        t0 = time.monotonic()
        assert srv.drain(grace_ms=250) == -1
        assert 0.2 <= time.monotonic() - t0 < 2.0
        assert srv.drain_force_closed == 1
        assert DRAIN_FORCE_CLOSE_REASON == "drain_grace_expired"
        conn.settimeout(2)
        try:
            got = conn.recv(4096)
        except OSError:
            got = b""
        assert got == b""
    finally:
        svc.release.set()
        conn.close()
        srv.stop()


def test_drain_settles_shm_slots():
    if not shm_ring.shm_supported():
        pytest.skip("no shm support here")
    shm_ring._reset_for_tests()

    class Echo(HoldSvc):
        def Bytes(self, cntl, request):
            cntl.response_attachment = cntl.request_attachment
            return b""

    srv, svc = _server(Echo())
    try:
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        big = os.urandom(int(get_flag("rpc_shm_threshold")) + 1024)
        for _ in range(3):            # the later calls ride the ring
            cntl = Controller()
            cntl.timeout_ms = 10_000
            cntl.request_attachment = big
            r = ch.call_method("OP.Bytes", b"", cntl=cntl)
            assert not r.failed, (r.error_code, r.error_text)
            assert bytes(r.response_attachment) == big
            del cntl, r               # the views go: their slots settle
        assert shm_ring.shm_stats()["staged"] >= 1
        t0 = time.monotonic()
        assert srv.drain(grace_ms=2000) == 0
        assert shm_ring.outstanding_tx_slots() == 0
        assert time.monotonic() - t0 < 1.5
        ch.close()
    finally:
        srv.stop()
        shm_ring._reset_for_tests()


_CHILD = r"""
import sys, time
sys.path.insert(0, {root!r})
from brpc_tpu_torch.butil.flags import set_flag
from brpc_tpu_torch.server import Server
set_flag("graceful_quit_on_sigterm", True)

class T:
    def Echo(self, cntl, request):
        return b"ok"

    def Slow(self, cntl, request):
        time.sleep(0.8)
        return b"slow-done"

srv = Server()
srv.add_service(T(), name="T")
assert srv.start("127.0.0.1:0") == 0
print("PORT=%d" % srv.listen_endpoint.port, flush=True)
srv.run_until_asked_to_quit()
print("QUIT %s %d %d" % (srv.drain_phase, srv.drain_force_closed,
                         srv.inflight), flush=True)
"""


def test_sigterm_drains_a_child_server():
    """``graceful_quit_on_sigterm``: SIGTERM drains the child's server (a
    slow call in flight finishes, a new one gets ELAMEDUCK), stops it,
    and the child returns from ``run_until_asked_to_quit`` and exits."""
    import signal
    proc = subprocess.Popen([sys.executable, "-c", _CHILD.format(root=ROOT)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        line = [None]
        reader = threading.Thread(
            target=lambda: line.__setitem__(0, proc.stdout.readline()),
            daemon=True)
        reader.start()
        reader.join(60)
        assert line[0] and line[0].startswith("PORT="), line[0]
        addr = f"127.0.0.1:{int(line[0].strip()[5:])}"
        slow_ch, probe_ch = Channel(), Channel()
        slow_ch.init(addr)
        probe_ch.init(addr)
        assert probe_ch.call("T.Echo", b"", timeout_ms=10_000) == b"ok"
        out = {}
        slow = threading.Thread(target=lambda: out.__setitem__(
            "slow", slow_ch.call("T.Slow", b"", timeout_ms=10_000)))
        slow.start()
        time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.2)
        cntl = Controller()
        cntl.timeout_ms = 5000
        probe_ch.call_method("T.Echo", b"", cntl=cntl)
        assert cntl.error_code == ELAMEDUCK, cntl.error_text
        slow.join(10)
        assert out.get("slow") == b"slow-done"
        stdout, stderr = proc.communicate(timeout=30)
        assert proc.returncode == 0, stderr
        assert stdout.strip() == "QUIT stopped 0 0", (stdout, stderr)
        slow_ch.close()
        probe_ch.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# -- the slice as a whole: a drain during live paged Decode streams --------------

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=64, remat=False)
MARGIN = 0.08
ROUND_S = 0.03          # each batcher round made this much slower
PAGED = dict(decode_slots=2, paged=True, page=4, kv_pages=17,
             kv_host_slots=16, prefix=False)


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


class _Session:
    """One Decode stream from ``client`` ("port" or "jax"), on a thread."""

    def __init__(self, ep, prompt, max_new, client):
        self.tokens, self.reason = [], None
        self.closed = threading.Event()
        self.error = None
        if client == "port":
            self.ch, self.cntl = Channel(), Controller()
            create, opts = stream_create, StreamOptions
        else:
            self.ch, self.cntl = JChannel(), JController()
            create, opts = jstreaming.stream_create, jstreaming.StreamOptions
        self.ch.init(str(ep))
        self.cntl.timeout_ms = 60_000
        create(self.cntl, opts(on_received=self._on_received,
                               on_closed=self._on_closed))
        self._req = tsvc.pack_generate_request(prompt[None], max_new)
        self.client = client
        threading.Thread(target=self._run, daemon=True).start()

    def _on_received(self, st, msgs):
        self.tokens.extend(tsvc.unpack_token(bytes(m)) for m in msgs)

    def _on_closed(self, st):
        self.reason = st.close_reason
        self.closed.set()

    def _run(self):
        c = self.ch.call_method("LM.Decode", self._req, cntl=self.cntl)
        if c.failed:
            self.error = (c.error_code, c.error_text)
            self.closed.set()


def _drain_paged(package, params, prompts, monkeypatch):
    """Serve ``package``'s paged LMService, start the long session, then
    the short one that spills it, drain, and read what every plane
    holds after."""
    if package == "port":
        svc_mod, pages, client = tsvc, tpages, "jax"
        svc = tsvc.LMService(cfg=tlm.LMConfig(**CFG), params=params[1],
                             device="cpu", **PAGED)
        srv = Server()
    else:
        svc_mod, pages, client = jsvc, jpages, "port"
        svc = jsvc.LMService(cfg=jlm.LMConfig(**CFG), params=params[0],
                             **PAGED)
        srv = JServer()
    emit = svc_mod.ContinuousBatcher._emit

    def slow_emit(self, pairs):
        time.sleep(ROUND_S)
        return emit(self, pairs)

    monkeypatch.setattr(svc_mod.ContinuousBatcher, "_emit", slow_emit)
    assert srv.add_service(svc, name="LM") == 0
    assert srv.start("127.0.0.1:0") == 0
    try:
        (lp, lref), (sp, sref) = prompts
        long_s = _Session(srv.listen_endpoint, lp, 40, client)
        wait_for(lambda: len(long_s.tokens) >= 2, 60, "the long stream")
        short_s = _Session(srv.listen_endpoint, sp, 30, client)
        bat = svc.batcher()
        wait_for(lambda: bat.spills >= 1 and short_s.tokens, 60,
                 "the spill and the short stream")
        t0 = time.monotonic()
        rc = srv.drain(5000)
        drain_s = time.monotonic() - t0
        for s in (long_s, short_s):
            assert s.closed.wait(30), "a stream never closed"
            assert s.error is None, s.error
        # the batcher evicts the closed sessions on its next round
        wait_for(lambda: bat.kv_stats()["alloc"]["in_use"] == 0, 30,
                 "the sessions' pages")
        held = (bat.kv_stats()["alloc"]["in_use"],
                pages.host_inflight_spills(), pages.outstanding_pages())
        out = dict(rc=rc, spills=bat.spills, drain_s=drain_s, held=held,
                   long=(long_s.reason, list(long_s.tokens)),
                   short=(short_s.reason, list(short_s.tokens)))
        for s in (long_s, short_s):
            if s.client == "port":
                s.ch.close()
        return out
    finally:
        srv.stop()
        if package == "port" and svc._batcher is not None:
            assert svc._batcher.shutdown()
        monkeypatch.setattr(svc_mod.ContinuousBatcher, "_emit", emit)


def test_drain_during_live_paged_decode_matches_jax(params, monkeypatch):
    tp = params[1]
    prompts = (_clear_prompt(tp, 8, 40, 100), _clear_prompt(tp, 14, 30, 200))
    mine = _drain_paged("port", params, prompts, monkeypatch)
    theirs = _drain_paged("jax", params, prompts, monkeypatch)
    for res in (mine, theirs):
        assert res["rc"] == 0 and res["spills"] >= 1
        assert res["held"] == (0, 0, 0)
        for key, (_, ref) in zip(("long", "short"), prompts):
            reason, toks = res[key]
            assert reason == "lame_duck", (key, reason)
            assert 1 <= len(toks) < len(ref) and toks == ref[:len(toks)]
    for key in ("long", "short"):
        a, b = mine[key][1], theirs[key][1]
        n = min(len(a), len(b))
        assert a[:n] == b[:n]
