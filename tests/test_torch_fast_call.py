"""The port's client fast lane (``client/fast_call.py``) against the JAX
package's, on the CPU over loopback.

- the request frames of ``run`` (a pooled and a short call, with and
  without an attachment and a deadline), ``run_raw``, ``run_batch`` and
  ``run_scatter`` are byte-equal to the JAX client's for the same call,
  captured on a raw listening socket, with the correlation id and the
  remaining-deadline value normalized (the ici lane off in both, so no
  domain or nonce TLV rides);
- the port's client calls a JAX server and the JAX client calls the
  port's server on every lane;
- ``eligible`` agrees with the JAX screen on every shape;
- a retriable failure retries inside the lane, an inherited deadline
  already spent fails fast, and errors map to the JAX codes;
- on a pooled channel, Generate's tokens equal the JAX service's.
"""

import socket
import struct
import threading
import time
import types

import jax
import numpy as np
import pytest

from brpc_tpu.butil.flags import set_flag as jset_flag
from brpc_tpu.butil.iobuf import IOBuf
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import ChannelOptions as JChannelOptions
from brpc_tpu.client import Controller as JController
from brpc_tpu.client import fast_call as jfast
from brpc_tpu.client.parallel_channel import ParallelChannel as JParallel
from brpc_tpu.deadline import inherit_deadline as jinherit
from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu_torch.butil.flags import set_flag
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import (Channel, ChannelOptions, Controller,
                                   RpcError)
from brpc_tpu_torch.client import fast_call
from brpc_tpu_torch.client.parallel_channel import ParallelChannel
from brpc_tpu_torch.deadline import inherit_deadline
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.server.service import Service
from brpc_tpu_torch.utils.convert import params_from_numpy

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)


@pytest.fixture(autouse=True, scope="module")
def _ici_off():
    """No domain or connection-nonce TLV: both packages' frames then
    carry the same bytes (their process tokens differ by design)."""
    jset_flag("ici_enabled", False)
    set_flag("ici_enabled", False)
    yield
    jset_flag("ici_enabled", True)
    set_flag("ici_enabled", True)


# -- a raw listening socket that records requests ---------------------------

def _tlvs(meta: bytes):
    off, out = 0, []
    while off < len(meta):
        tag = meta[off]
        (ln,) = struct.unpack_from("<I", meta, off + 1)
        out.append((tag, meta[off + 5:off + 5 + ln]))
        off += 5 + ln
    return out


def _normalized(frame: bytes) -> bytes:
    """The frame with its correlation id (TLV 1) and remaining deadline
    (TLV 13) zeroed."""
    body, msize = struct.unpack_from("<II", frame, 4)
    meta = b""
    for tag, val in _tlvs(frame[12:12 + msize]):
        if tag in (1, 13):
            val = b"\0" * len(val)
        meta += bytes([tag]) + struct.pack("<I", len(val)) + val
    return frame[:12] + meta + frame[12 + msize:]


def _cid_of(frame: bytes) -> int:
    (msize,) = struct.unpack_from("<I", frame, 8)
    for tag, val in _tlvs(frame[12:12 + msize]):
        if tag == 1:
            return struct.unpack("<Q", val)[0]
    raise AssertionError("no cid")


def _resp(cid: int, payload: bytes) -> bytes:
    meta = b"\x01" + struct.pack("<I", 8) + struct.pack("<Q", cid)
    return (b"TRPC" + struct.pack("<II", len(meta) + len(payload), len(meta))
            + meta + payload)


class Capture:
    """Accepts connections, records every request frame, and answers
    each with a plain success echoing its payload."""

    def __init__(self):
        self.lsock = socket.socket()
        self.lsock.bind(("127.0.0.1", 0))
        self.lsock.listen(16)
        self.ep = "127.0.0.1:%d" % self.lsock.getsockname()[1]
        self.frames = []
        self.lock = threading.Lock()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                c, _ = self.lsock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(c,),
                             daemon=True).start()

    def _serve(self, c):
        buf = b""
        while True:
            try:
                chunk = c.recv(65536)
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            while len(buf) >= 12 and len(buf) >= 12 + struct.unpack_from(
                    "<I", buf, 4)[0]:
                n = 12 + struct.unpack_from("<I", buf, 4)[0]
                frame, buf = buf[:n], buf[n:]
                with self.lock:
                    self.frames.append(frame)
                msize = struct.unpack_from("<I", frame, 8)[0]
                c.sendall(_resp(_cid_of(frame), frame[12 + msize:]))

    def take(self):
        with self.lock:
            out, self.frames = self.frames, []
        return [_normalized(f) for f in out]

    def close(self):
        self.lsock.close()


@pytest.fixture()
def capture():
    cap = Capture()
    yield cap
    cap.close()


def _pair(ep, ctype="pooled", **opts):
    co, jco = ChannelOptions(), JChannelOptions()
    for o in (co, jco):
        o.connection_type = ctype
        o.timeout_ms = 5000
        for k, v in opts.items():
            setattr(o, k, v)
    ch, jch = Channel(co), JChannel(jco)
    assert ch.init(ep) == 0 and jch.init(ep) == 0
    return ch, jch


@pytest.mark.parametrize("ctype", ["pooled", "short"])
@pytest.mark.parametrize("shape", ["plain", "attachment", "deadline",
                                   "tenant"])
def test_run_frames_byte_equal(capture, ctype, shape):
    ch, jch = _pair(capture.ep, ctype,
                    **({"tenant": "acme"} if shape == "tenant" else {}))
    got = []
    for chan, mk, att in ((ch, Controller, b"tail"),
                          (jch, JController, IOBuf(b"tail"))):
        c = mk()
        c.timeout_ms = 2000 if shape == "deadline" else -1
        if shape == "attachment":
            c.request_attachment = att
        c = chan.call_method("Cap.Echo", b"payload", cntl=c)
        assert not c.failed, c.error_text
        got.append(capture.take())
    assert len(got[0]) == 1 and got[0] == got[1]


def test_run_raw_frames_byte_equal(capture):
    ch, jch = _pair(capture.ep)
    body, att = ch.call_raw("Cap.Echo", b"raw-payload", b"att")
    assert bytes(body) == b"raw-payloadatt"
    port = capture.take()
    jch.call_raw("Cap.Echo", b"raw-payload", b"att")
    assert port == capture.take() and len(port) == 1


def test_run_batch_frames_byte_equal(capture):
    ch, jch = _pair(capture.ep)
    reqs = [b"a", b"bb", b"ccc"]
    assert ch.call_batch("Cap.Echo", reqs) == reqs
    port = capture.take()
    assert jch.call_batch("Cap.Echo", reqs) == reqs
    assert port == capture.take() and len(port) == 3


def test_run_scatter_frames_byte_equal():
    caps = [Capture(), Capture()]
    try:
        got = []
        for pc_cls, ch_cls in ((ParallelChannel, Channel),
                               (JParallel, JChannel)):
            pc = pc_cls()
            for cap in caps:
                sub = ch_cls()
                assert sub.init(cap.ep) == 0
                pc.add_channel(sub)
            c = pc.call_method("Cap.Echo", b"fan")
            assert not c.failed and c.response == [b"fan", b"fan"]
            got.append([cap.take() for cap in caps])
        assert got[0] == got[1]
        assert all(len(frames) == 1 for frames in got[0])
    finally:
        for cap in caps:
            cap.close()


# -- both directions ----------------------------------------------------------

class _Echo:
    def Echo(self, cntl, request):
        att = cntl.request_attachment
        if isinstance(att, IOBuf):
            cntl.response_attachment.append(att.to_bytes())
        else:
            cntl.response_attachment = att
        return request

    def Fail(self, cntl, request):
        cntl.set_failed(1234, "boom")
        return b""

    def Slow(self, cntl, request):
        time.sleep(0.3)
        return b"slow"


class PortEcho(_Echo, Service):
    pass


class JaxEcho(_Echo, JService):
    pass


@pytest.fixture(scope="module")
def servers():
    srv = Server()
    srv.add_service(PortEcho(), name="E")
    assert srv.start("127.0.0.1:0") == 0
    jsrv = JServer()
    jsrv.add_service(JaxEcho(), name="E")
    assert jsrv.start("127.0.0.1:0") == 0
    yield {"port": str(srv.listen_endpoint), "jax": str(jsrv.listen_endpoint)}
    srv.stop()
    jsrv.stop()


@pytest.mark.parametrize("lane", ["pooled", "short", "raw", "batch",
                                  "scatter"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_cross_package(servers, lane, direction):
    port_client = direction == "port_to_jax"
    ep = servers["jax" if port_client else "port"]
    mk_ch, mk_opts = (Channel, ChannelOptions) if port_client \
        else (JChannel, JChannelOptions)
    opts = mk_opts()
    opts.connection_type = "short" if lane == "short" else "pooled"
    ch = mk_ch(opts)
    assert ch.init(ep) == 0
    if lane in ("pooled", "short"):
        c = ch.call_method("E.Echo", b"hello", attachment=b"att")
        assert not c.failed, c.error_text
        assert bytes(c.response) == b"hello"
        att = c.response_attachment
        assert (att.to_bytes() if isinstance(att, IOBuf) else bytes(att)) \
            == b"att"
    elif lane == "raw":
        body, att = ch.call_raw("E.Echo", b"hello", b"att")
        assert bytes(body) == b"hello" and bytes(att) == b"att"
    elif lane == "batch":
        assert [bytes(r) for r in ch.call_batch(
            "E.Echo", [b"1", b"22", b"333"])] == [b"1", b"22", b"333"]
    else:
        pc = (ParallelChannel if port_client else JParallel)()
        for _ in range(2):
            sub = mk_ch()
            assert sub.init(ep) == 0
            pc.add_channel(sub)
        c = pc.call_method("E.Echo", b"fan")
        assert not c.failed and [bytes(r) for r in c.response] \
            == [b"fan", b"fan"]
    if port_client and lane in ("pooled", "short"):
        # every round trip on the engine
        assert fast_call.lane_counters()["py_sync_call"] == 0


# -- the screen, retries, deadlines, errors -----------------------------------

SHAPES = {
    "pooled": ({"connection_type": "pooled"}, {}),
    "short": ({"connection_type": "short"}, {}),
    "single": ({"connection_type": "single"}, {}),
    "http": ({"connection_type": "pooled", "protocol": "http"}, {}),
    "ssl": ({"connection_type": "pooled", "ssl": True}, {}),
    "compress": ({"connection_type": "pooled"},
                 {"request_compress_type": 1}),
    "backup_cntl": ({"connection_type": "pooled"},
                    {"backup_request_ms": 10}),
    "backup_channel": ({"connection_type": "pooled",
                        "backup_request_ms": 10}, {}),
    "cntl_overrides_type": ({"connection_type": "single"},
                            {"connection_type": "short"}),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_eligible_matrix(shape):
    chan_opts, cntl_fields = SHAPES[shape]
    verdicts = []
    for mk_opts, mk_ch, mk_cntl, elig in (
            (ChannelOptions, Channel, Controller, fast_call.eligible),
            (JChannelOptions, JChannel, JController, jfast.eligible)):
        o = mk_opts()
        for k, v in chan_opts.items():
            setattr(o, k, v)
        ch = mk_ch(o)
        c = mk_cntl()
        for k, v in cntl_fields.items():
            setattr(c, k, v)
        verdicts.append(bool(elig(ch, c)))
    assert verdicts[0] == verdicts[1]
    assert verdicts[0] == (shape in ("pooled", "short",
                                     "cntl_overrides_type"))


class _DropFirst:
    """A raw server that closes the first connection on its first
    request and answers every later one."""

    def __init__(self):
        self.cap = Capture()
        self.dropped = False
        self.cap._serve = self._serve
        self.ep = self.cap.ep

    def _serve(self, c):
        if not self.dropped:
            self.dropped = True
            c.recv(65536)
            c.close()
            return
        Capture._serve(self.cap, c)


def test_retry_inside_the_lane():
    outcomes = []
    for mk_opts, mk_ch, mk_cntl in ((ChannelOptions, Channel, Controller),
                                    (JChannelOptions, JChannel,
                                     JController)):
        srv = _DropFirst()
        o = mk_opts()
        o.connection_type = "pooled"
        o.max_retry = 2
        ch = mk_ch(o)
        assert ch.init(srv.ep) == 0
        c = ch.call_method("Cap.Echo", b"again", cntl=mk_cntl())
        outcomes.append((c.failed, bytes(c.response or b""),
                         c.retried_count))
        srv.cap.close()
    assert outcomes[0] == outcomes[1] == (False, b"again", 1)


def test_inherited_deadline_already_expired(servers):
    spent = types.SimpleNamespace(deadline_us=1)   # long past
    outcomes = []
    for mk_opts, mk_ch, inherit in ((ChannelOptions, Channel,
                                     inherit_deadline),
                                    (JChannelOptions, JChannel, jinherit)):
        o = mk_opts()
        o.connection_type = "pooled"
        ch = mk_ch(o)
        assert ch.init(servers["port"]) == 0
        t0 = time.monotonic()
        with inherit(spent):
            c = ch.call_method("E.Slow", b"")
            with pytest.raises(Exception) as e:
                ch.call_raw("E.Echo", b"x")
            with pytest.raises(Exception) as eb:
                ch.call_batch("E.Echo", [b"x"])
        assert time.monotonic() - t0 < 0.2     # failed fast, nothing sent
        outcomes.append((c.error_code, e.value.code, eb.value.code))
    assert outcomes[0] == outcomes[1] == (int(Errno.ERPCTIMEDOUT),) * 3


def _dead_ep():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    ep = "127.0.0.1:%d" % s.getsockname()[1]
    s.close()
    return ep


@pytest.mark.parametrize("case", ["app_error", "no_method", "timeout",
                                  "refused"])
def test_error_mapping(servers, case):
    codes = []
    for mk_opts, mk_ch, mk_cntl, ep in (
            (ChannelOptions, Channel, Controller, servers["port"]),
            (JChannelOptions, JChannel, JController, servers["jax"])):
        if case == "refused":
            ep = _dead_ep()
        o = mk_opts()
        o.connection_type = "pooled"
        o.max_retry = 0
        ch = mk_ch(o)
        assert ch.init(ep) == 0
        c = mk_cntl()
        c.timeout_ms = 100 if case == "timeout" else 2000
        method = {"app_error": "E.Fail", "no_method": "E.Nope",
                  "timeout": "E.Slow", "refused": "E.Echo"}[case]
        c = ch.call_method(method, b"", cntl=c)
        codes.append((c.error_code, c.error_text if case == "app_error"
                      else ""))
    assert codes[0] == codes[1] and codes[0][0] != 0


def test_call_raw_and_batch_raise_rpc_error(servers):
    ch = Channel()
    assert ch.init(servers["port"]) == 0
    with pytest.raises(RpcError) as e:
        ch.call_raw("E.Fail", b"")
    assert e.value.code == 1234
    assert ch.call_batch("E.Echo", [b"ok", b"x"]) == [b"ok", b"x"]
    with pytest.raises(RpcError) as e:
        ch.call_batch("E.Fail", [b"x"])
    assert e.value.code == 1234


# -- Generate on a pooled channel ---------------------------------------------

def _clear_prompt(tp, max_new):
    """A prompt whose greedy picks all clear the frameworks' logit
    difference (as ``test_torch_lm_service.py`` picks its prompt)."""
    import torch
    cfg = tlm.LMConfig(**CFG)
    pre, step = tlm.make_decode(cfg, device="cpu")
    for seed in range(60):
        ids = np.random.default_rng(200 + seed).integers(
            0, CFG["vocab"], (2, 6), dtype=np.int32)
        cache, logits = pre(tp, torch.from_numpy(ids))
        ok = True
        for i in range(max_new):
            top2 = torch.topk(logits, 2, dim=-1).values
            if (top2[:, 0] - top2[:, 1]).min() <= 0.08:
                ok = False
                break
            if i < max_new - 1:
                cache, logits = step(tp, cache, torch.argmax(logits, -1))
        if ok:
            return ids
    pytest.fail("no prompt with clear top-1 margins among 60 seeds")


def test_pooled_generate_tokens_equal_jax():
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**CFG))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    srv = Server()
    srv.add_service(tsvc.LMService(cfg=tlm.LMConfig(**CFG), params=tp,
                                   device="cpu"), name="LM")
    assert srv.start("127.0.0.1:0") == 0
    jsrv = JServer()
    jsrv.add_service(jsvc.LMService(cfg=jlm.LMConfig(**CFG), params=jp),
                     name="LM")
    assert jsrv.start("127.0.0.1:0") == 0
    try:
        ids = _clear_prompt(tp, 4)
        req = tsvc.pack_generate_request(ids, 4)
        co = ChannelOptions()
        co.connection_type = "pooled"
        co.timeout_ms = 60_000
        ch = Channel(co)
        assert ch.init(str(srv.listen_endpoint)) == 0
        before = fast_call.lane_counters()["sync_call"]
        c = ch.call_method("LM.Generate", req)
        assert not c.failed, c.error_text
        assert fast_call.lane_counters()["sync_call"] == before + 1
        jc = JChannel()
        assert jc.init(str(jsrv.listen_endpoint)) == 0
        jctl = JController()
        jctl.timeout_ms = 60_000
        jr = jc.call_method("LM.Generate", req, cntl=jctl)
        assert not jr.failed, jr.error_text
        np.testing.assert_array_equal(tsvc.unpack_generated(c.response),
                                      jsvc.unpack_generated(jr.response))
        batch = ch.call_batch("LM.Generate", [req, req], timeout_ms=60_000)
        for r in batch:
            np.testing.assert_array_equal(tsvc.unpack_generated(r),
                                          tsvc.unpack_generated(c.response))
    finally:
        srv.stop()
        jsrv.stop()


def test_one_cid_counter_for_both_lanes(capture):
    """The fast lane and the Channel's Python path draw correlation ids
    from one process-wide counter, so a connection shared by channels
    never sees an id twice (the JAX fast lane keeps a range of its own,
    apart from its id pool)."""
    cids = []
    for ctype in ("pooled", "single", "pooled"):
        co = ChannelOptions()
        co.connection_type = ctype
        ch = Channel(co)
        assert ch.init(capture.ep) == 0
        assert not ch.call_method("Cap.Echo", b"x").failed
        with capture.lock:
            cids.append(_cid_of(capture.frames[-1]))
        ch.close()
    assert cids == sorted(cids) and len(set(cids)) == 3
