"""The port's streams (``brpc_tpu_torch/streaming.py``) on the CPU over
loopback, through the port's Server and Channel:

- TSTR frames are byte-identical with the JAX package's, both ways;
- the writer blocks on a full credit window and answers ``EOVERCROWDED``
  when it stays full; the receiver's ``F_FEEDBACK`` acks reopen it;
- ``close(reason=...)`` arrives, after the data sent before it, as the
  peer's named close reason; ``F_RST`` closes without one;
- a failed call closes the stream at both ends, and a closed connection
  closes every stream on it;
- a frame for a stream that arrives on another connection is dropped.
"""

import queue
import socket
import struct
import threading
import time

import pytest

from brpc_tpu.butil.iobuf import IOBuf
from brpc_tpu.protocol import streaming as jproto
from brpc_tpu import streaming as jstreaming
from brpc_tpu.transport import socket as jsocket
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.protocol import streaming as tproto
from brpc_tpu_torch.protocol.tpu_std import read_frame
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.streaming import (StreamOptions, find_stream,
                                      stream_accept, stream_create)

TIMEOUT_MS = 30_000


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


class _Capture:
    """A JAX Socket stand-in that keeps what a JAX stream writes."""

    failed = False

    def __init__(self):
        self.out = b""
        self.stream_map = {}
        self._stream_lock = threading.Lock()

    def write(self, buf):
        self.out += buf.to_bytes()
        return 0


@pytest.mark.parametrize("flags,payload", [
    (tproto.F_DATA, struct.pack("<i", -7)), (tproto.F_FEEDBACK,
                                             struct.pack("<Q", 1 << 40)),
    (tproto.F_CLOSE, b"finished"), (tproto.F_RST, b"")])
def test_frames_identical_both_ways(monkeypatch, flags, payload):
    cap = _Capture()
    monkeypatch.setattr(jsocket.Socket, "address",
                        staticmethod(lambda sid: cap))
    js = jstreaming.Stream()
    js.socket_id, js.peer_stream_id = 5, 0x1234_5678_9ABC
    try:
        js._send_frame(flags, payload)
    finally:
        js._close_local(notify_peer=False)
    frame = tproto.pack_stream_frame(flags, 0x1234_5678_9ABC, payload)
    assert cap.out == frame and len(frame) == tproto.HEADER + len(payload)
    # the JAX parser cuts the port's frame, the port's reader the JAX one
    res = jproto.parse(IOBuf(frame), None, False, None)
    assert res.ok and res.message == (flags, 0x1234_5678_9ABC, payload)
    a, b = socket.socketpair()
    try:
        a.sendall(cap.out)
        assert read_frame(b) == tproto.StreamFrame(flags, 0x1234_5678_9ABC,
                                                   payload)
    finally:
        a.close()
        b.close()
    assert (tproto.MAGIC, tproto.HEADER) == (jproto.MAGIC, jproto.HEADER)
    assert (tproto.F_DATA, tproto.F_FEEDBACK, tproto.F_CLOSE,
            tproto.F_RST) == (jproto.F_DATA, jproto.F_FEEDBACK,
                              jproto.F_CLOSE, jproto.F_RST)


class _StreamService:
    """``Open`` accepts the request's stream with the window the request
    names; ``Refuse`` accepts one, then fails the call."""

    def __init__(self):
        self.accepted = queue.Queue()
        self.received = []
        self.closed = []
        self.refused = None

    def Open(self, cntl, request):
        window = int(request or b"0") or 2 * 1024 * 1024
        s = stream_accept(cntl, StreamOptions(
            on_received=lambda st, msgs: self.received.extend(msgs),
            on_closed=lambda st: self.closed.append(st.close_reason),
            max_buf_size=window))
        if s is None:
            cntl.set_failed(Errno.EREQUEST, "no stream")
            return None
        self.accepted.put(s)
        return b"ok"

    def Refuse(self, cntl, request):
        self.refused = stream_accept(cntl, StreamOptions())
        cntl.set_failed(Errno.EREQUEST, "refused")
        return None


@pytest.fixture()
def served():
    svc = _StreamService()
    srv = Server()
    assert srv.add_service(svc, name="S") == 0
    assert srv.start("127.0.0.1:0") == 0
    yield srv, svc
    srv.stop()


class _Client:
    """A client stream over a fresh Channel: what it received, and its
    close reasons."""

    def __init__(self, srv, window=2 * 1024 * 1024, wedge=None,
                 method="S.Open", request=b""):
        self.msgs, self.closed, self.threads = [], [], []
        self.ch = Channel()
        self.ch.init(str(srv.listen_endpoint))
        cntl = Controller()
        cntl.timeout_ms = TIMEOUT_MS

        def on_received(st, msgs):
            self.msgs.extend(bytes(m) for m in msgs)
            self.threads.append(threading.current_thread())
            if wedge is not None:
                wedge.wait(30)

        self.stream = stream_create(cntl, StreamOptions(
            on_received=on_received,
            on_closed=lambda st: self.closed.append(st.close_reason),
            max_buf_size=window))
        self.cntl = self.ch.call_method(method, request, cntl=cntl)


def test_stream_roundtrip_and_named_close(served):
    srv, svc = served
    cl = _Client(srv)
    assert not cl.cntl.failed, cl.cntl.error_text
    s = svc.accepted.get(timeout=5)
    assert cl.stream.wait_established(5) and s.peer_stream_id == cl.stream.id
    assert cl.stream.peer_stream_id == s.id
    for i in range(20):
        assert s.write(struct.pack("<i", i)) == 0
    assert cl.stream.write(b"up") == 0
    assert _wait(lambda: svc.received == [b"up"])
    s.close(reason="finished")
    assert _wait(lambda: cl.closed)
    # every message sent before the FIN came first, in order
    assert cl.msgs == [struct.pack("<i", i) for i in range(20)]
    assert cl.closed == ["finished"] and cl.stream.closed
    assert find_stream(s.id) is None and find_stream(cl.stream.id) is None
    assert s.write(b"late") == Errno.EEOF
    cl.ch.close()


def test_one_delivery_thread_per_stream(served):
    """Messages that arrive one at a time, the queue idle between them,
    all reach on_received on one thread, which ends with the stream."""
    srv, svc = served
    cl = _Client(srv)
    s = svc.accepted.get(timeout=5)
    for i in range(5):
        assert s.write(struct.pack("<i", i)) == 0
        assert _wait(lambda: len(cl.msgs) == i + 1)
    assert len(cl.threads) == 5 and len(set(cl.threads)) == 1
    s.close(reason="finished")
    assert _wait(lambda: cl.closed)
    cl.threads[0].join(5)
    assert not cl.threads[0].is_alive()
    cl.ch.close()


def _fill_window_behind_wedge(s, cl):
    """Four 4-byte messages into a 16-byte window whose handler wedges on
    the first.  The first goes alone and the handler takes it before the
    other three are written: the delivery thread dequeues whatever is
    queued as one batch, and a batch of two or more would reach half the
    window, so its ack would reopen the window before the handler
    wedged."""
    assert s.write(struct.pack("<i", 0)) == 0
    assert _wait(lambda: len(cl.msgs) == 1)
    for i in range(1, 4):
        assert s.write(struct.pack("<i", i)) == 0


def test_window_blocks_then_overcrowded(served):
    """A client window of 16 bytes and a wedged handler: four 4-byte
    messages fit, the fifth waits, and with the window still full after
    the write timeout the write answers EOVERCROWDED."""
    srv, svc = served
    wedge = threading.Event()
    cl = _Client(srv, window=16, wedge=wedge)
    s = svc.accepted.get(timeout=5)
    try:
        _fill_window_behind_wedge(s, cl)
        s.options.write_timeout_s = 0.2
        t0 = time.monotonic()
        assert s.write(b"xxxx") == Errno.EOVERCROWDED
        assert time.monotonic() - t0 >= 0.19
    finally:
        wedge.set()
    cl.ch.close()


def test_feedback_acks_reopen_the_window(served):
    """The receiver acks at half its window, on dequeue: a writer blocked
    on a full window resumes once the handler drains."""
    srv, svc = served
    wedge = threading.Event()
    cl = _Client(srv, window=16, wedge=wedge)
    s = svc.accepted.get(timeout=5)
    _fill_window_behind_wedge(s, cl)
    s.options.write_timeout_s = 10.0
    rc = []
    writer = threading.Thread(target=lambda: rc.extend(
        s.write(struct.pack("<i", i)) for i in range(4, 12)))
    writer.start()
    time.sleep(0.2)
    assert not rc and writer.is_alive()          # blocked on credit
    wedge.set()
    writer.join(10)
    assert not writer.is_alive() and rc == [0] * 8
    assert s._remote_consumed >= 8               # acks arrived
    assert _wait(lambda: len(cl.msgs) == 12)
    assert cl.msgs == [struct.pack("<i", i) for i in range(12)]
    cl.ch.close()


def test_rst_closes_without_reason(served):
    srv, svc = served
    cl = _Client(srv)
    s = svc.accepted.get(timeout=5)
    s._send_frame(tproto.F_RST)
    assert _wait(lambda: cl.closed)
    assert cl.closed == [None]
    s.close()
    cl.ch.close()


def test_failed_call_closes_both_ends(served):
    srv, svc = served
    cl = _Client(srv, method="S.Refuse")
    assert cl.cntl.failed and cl.cntl.error_text == "refused"
    assert cl.stream.closed and cl.closed == [None]
    assert svc.refused is not None and svc.refused.closed
    # a call the server accepts no stream on closes the pending one too
    cl2 = _Client(srv, method="S.Nope")
    assert cl2.cntl.failed and cl2.stream.closed
    cl.ch.close()
    cl2.ch.close()


def test_connection_loss_closes_streams(served):
    srv, svc = served
    cl = _Client(srv)
    s = svc.accepted.get(timeout=5)
    cl.ch.close()                       # client side goes away
    assert cl.stream.closed
    assert _wait(lambda: s.closed) and svc.closed == [None]
    # and the other way: the server stops, the client's stream closes
    cl2 = _Client(srv)
    s2 = svc.accepted.get(timeout=5)
    srv.stop()
    assert _wait(lambda: cl2.stream.closed) and cl2.closed == [None]
    assert s2.closed
    # a new call on that channel reconnects (and fails: no server)
    c = cl2.ch.call_method("S.Open", b"")
    assert c.failed and c.error_code == Errno.EFAILEDSOCKET


def test_frame_on_another_connection_is_dropped(served):
    srv, svc = served
    cl = _Client(srv)
    s = svc.accepted.get(timeout=5)
    forged = socket.create_connection(
        (srv.listen_endpoint.host, srv.listen_endpoint.port))
    try:
        forged.sendall(tproto.pack_stream_frame(tproto.F_DATA, s.id, b"evil")
                       + tproto.pack_stream_frame(tproto.F_CLOSE, s.id,
                                                  b"forged"))
        assert cl.stream.write(b"real") == 0
        assert _wait(lambda: svc.received == [b"real"])
        time.sleep(0.1)
        assert svc.received == [b"real"] and not s.closed
    finally:
        forged.close()
    cl.ch.close()
    assert _wait(lambda: s.closed)


def test_calls_share_a_connection_with_a_stream(served):
    """Once the connection carries a stream, its reader hands each
    response to its call, concurrent calls included, while stream frames
    keep flowing."""
    srv, svc = served
    cl = _Client(srv)
    s = svc.accepted.get(timeout=5)
    stop = threading.Event()

    def pump():
        i = 0
        while not stop.is_set() and s.write(struct.pack("<i", i)) == 0:
            i += 1
            time.sleep(0.001)

    t = threading.Thread(target=pump)
    t.start()
    try:
        results = []

        def call():
            c = Controller()
            c.timeout_ms = TIMEOUT_MS
            results.append(cl.ch.call_method("S.Open", b"", cntl=c))

        callers = [threading.Thread(target=call) for _ in range(6)]
        for c in callers:
            c.start()
        for c in callers:
            c.join(30)
        # no stream on these calls: the server answers EREQUEST
        assert len(results) == 6
        assert all(r.error_text == "no stream" for r in results)
    finally:
        stop.set()
        t.join(10)
    n = len(cl.msgs)
    assert n > 0 and cl.msgs == [struct.pack("<i", i) for i in range(n)]
    s.close(reason="done")
    assert _wait(lambda: cl.closed == ["done"])
    cl.ch.close()
