"""Hot restart on the port (``brpc_tpu_torch/server/hot_restart.py``,
``Server.export_listeners``, ``start(inherit_from=)``,
``NativeBridge.listen(inherited_shards=)``), held to the JAX package's
cases (``tests/test_operability.py:698-785``) and across the packages:

- the successor inherits the listener (its kernel queue included) while
  the predecessor finishes its established connections, on the Python
  transport and on the engine (shards adopted, a surplus closed);
- a caller on fresh connections through the swap sees no failed call and
  no refused connect;
- the ``TPUHR1`` handoff crosses between the packages both ways, at the
  wire and as whole servers (a JAX server swapped for a port one, and a
  port server for a JAX one);
- in one process, two descriptors of one listening socket share the
  event dispatcher: the predecessor's stop takes its listener off the
  dispatcher before it closes it and never shuts the shared socket
  down, so a reused descriptor number gets no event of the listener.
"""

import contextlib
import logging
import os
import socket
import threading
import time

import pytest

from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu.server import hot_restart as jhot_restart
from brpc_tpu.server.server import ServerOptions as JServerOptions
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
from brpc_tpu_torch.server import Server, ServerOptions, Service
from brpc_tpu_torch.server import hot_restart
from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher


class Op(Service):
    """Echo, and a call that parks until released (an established
    connection's in-flight work on the predecessor)."""

    def __init__(self):
        super().__init__()
        self.calls = []
        self.parked = threading.Event()
        self.release = threading.Event()

    def Echo(self, cntl, request):
        self.calls.append(bytes(request))
        return request

    def Park(self, cntl, request):
        self.parked.set()
        self.release.wait(10)
        return b"parked-done"


class JOp(JService):
    def __init__(self):
        super().__init__()
        self.calls = []

    def Echo(self, cntl, request):
        self.calls.append(bytes(request))
        return request


@contextlib.contextmanager
def _warnings():
    """The port's warnings while the block runs (its ``brpc_tpu_torch``
    logger does not propagate to the root logger)."""
    got = []

    class Keep(logging.Handler):
        def emit(self, record):
            got.append(record.getMessage())

    h = Keep(level=logging.WARNING)
    lg = logging.getLogger("brpc_tpu_torch")
    lg.addHandler(h)
    try:
        yield got
    finally:
        lg.removeHandler(h)


def _server(native=False, loops=0):
    opts = ServerOptions()
    if native:
        opts.native = True
        opts.usercode_inline = True
        opts.native_loops = loops
    srv = Server(opts)
    svc = Op()
    assert srv.add_service(svc, name="OP") == 0
    return srv, svc


def _short_call(ep, payload, timeout_ms=5000):
    opts = ChannelOptions()
    opts.connection_type = "short"
    opts.timeout_ms = timeout_ms
    ch = Channel(opts)
    ch.init(str(ep))
    c = Controller()
    c.timeout_ms = timeout_ms
    c.max_retry = 0
    ch.call_method("OP.Echo", payload, cntl=c)
    ch.close()
    return c


def _export(srv, path, timeout_s=10.0):
    got = {}
    t = threading.Thread(target=lambda: got.__setitem__(
        "rc", srv.export_listeners(path, timeout_s)), daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while not os.path.exists(path):
        assert time.monotonic() < deadline, "no handoff socket"
        time.sleep(0.005)
    time.sleep(0.05)
    return t, got


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_hot_restart_preserves_service(native, tmp_path):
    """The binary-swap story: the successor inherits the listener while the
    predecessor finishes its established connection's parked call; a new
    connection lands on the successor through the same socket."""
    handoff = str(tmp_path / "handoff.sock")
    old, old_svc = _server(native)
    assert old.start("127.0.0.1:0") == 0
    ep = old.listen_endpoint
    ch = Channel()
    ch.init(str(ep))
    out = {}
    parked = threading.Thread(target=lambda: out.__setitem__(
        "park", ch.call("OP.Park", b"", timeout_ms=10_000)))
    new = None
    try:
        parked.start()
        assert old_svc.parked.wait(10)
        t, got = _export(old, handoff)
        new, new_svc = _server(native)
        assert new.start(f"127.0.0.1:{ep.port}", inherit_from=handoff) == 0
        t.join(5)
        assert got["rc"] == 0
        assert new.listen_endpoint.port == ep.port
        if native:
            assert new._native_bridge is not None
        drained = {}
        d = threading.Thread(target=lambda: drained.__setitem__(
            "rc", old.drain(5000)))
        d.start()
        time.sleep(0.05)
        old_svc.release.set()
        d.join(10)
        parked.join(10)
        assert drained["rc"] == 0 and out["park"] == b"parked-done"
        old.stop()
        c = _short_call(ep, b"post-swap")
        assert not c.failed, c.error_text
        assert c.response == b"post-swap"
        assert new_svc.calls == [b"post-swap"] and old_svc.calls == []
    finally:
        old_svc.release.set()
        ch.close()
        old.stop()
        if new is not None:
            new.stop()


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_no_failed_call_or_refused_connect_through_the_swap(native,
                                                            tmp_path):
    """A caller on fresh connections, without pause, while the predecessor
    exports, the successor starts and the predecessor drains and stops: no
    call fails, no connect is refused, and no call the predecessor ran is
    lost.  A call the predecessor refused before running it (answered
    ``ELAMEDUCK`` or ``ELOGOFF``, or its connection closed unanswered --
    brpc's client retries all three) is sent again on a new connection,
    as chip_smoke's phase 20 (c) does.  Every call carries its own
    payload, so the services' records show that no call sent again had
    run, and that every call the predecessor ran was answered."""
    handoff = str(tmp_path / "handoff.sock")
    old, old_svc = _server(native)
    assert old.start("127.0.0.1:0") == 0
    ep = old.listen_endpoint
    stop = threading.Event()
    res = {"calls": 0, "failed": [], "resent": [], "answered": set()}

    def caller():
        opts = ChannelOptions()
        opts.connection_type = "short"
        ch = Channel(opts)
        ch.init(str(ep))
        seq = 0
        while not stop.is_set():
            res["calls"] += 1
            for attempt in range(4):
                seq += 1
                payload = b"x%d" % seq
                c = Controller()
                c.timeout_ms = 5000
                c.max_retry = 0
                ch.call_method("OP.Echo", payload, cntl=c)
                if not c.failed:
                    if c.response == payload:
                        res["answered"].add(payload)
                    else:
                        res["failed"].append((0, "wrong answer"))
                    break
                if attempt == 3 or not _refused_unrun(c):
                    res["failed"].append((c.error_code, c.error_text))
                    break
                res["resent"].append(payload)
        ch.close()

    th = threading.Thread(target=caller)
    new = None
    try:
        th.start()
        time.sleep(0.2)
        t, got = _export(old, handoff)
        new, new_svc = _server(native)
        assert new.start(f"127.0.0.1:{ep.port}", inherit_from=handoff) == 0
        t.join(5)
        assert got["rc"] == 0
        assert old.drain(2000) == 0
        old.stop()
        n = len(new_svc.calls)
        deadline = time.monotonic() + 10
        while len(new_svc.calls) < n + 20:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        stop.set()
        th.join(30)
        old.stop()
        if new is not None:
            new.stop()
    assert res["failed"] == [] and res["calls"] > 20
    assert old_svc.calls and new_svc.calls
    ran = set(old_svc.calls) | set(new_svc.calls)
    assert not ran & set(res["resent"]), "a call sent again had run"
    assert set(old_svc.calls) <= res["answered"], \
        "the predecessor ran a call whose answer was lost"


def _refused_unrun(c) -> bool:
    """The predecessor refused the call: answered ``ELAMEDUCK`` (a drained
    server's lame duck) or ``ELOGOFF`` (a stopped server's), or closed its
    connection unanswered (not a failed connect)."""
    if c.error_code in (int(Errno.ELAMEDUCK), int(Errno.ELOGOFF)):
        return True
    return c.error_code in (int(Errno.EFAILEDSOCKET), int(Errno.EEOF)) \
        and not c.error_text.startswith("connect to ")


def test_native_shards_adopted_and_surplus_closed(tmp_path):
    """The engine's SO_REUSEPORT shard listeners move to a successor with
    as many loops (adopted, not bound anew); a one-loop successor closes
    the surplus with the JAX warning and serves on its primary."""
    old, _ = _server(native=True, loops=2)
    assert old.start("127.0.0.1:0") == 0
    ep = old.listen_endpoint
    socks = old._native_bridge.listener_sockets()
    assert len(socks) == 2, "the predecessor did not shard"
    inodes = sorted(os.fstat(s.fileno()).st_ino for s in socks)
    mid = lone = None
    try:
        t, got = _export(old, str(tmp_path / "a.sock"))
        mid, mid_svc = _server(native=True, loops=2)
        assert mid.start(f"127.0.0.1:{ep.port}",
                         inherit_from=str(tmp_path / "a.sock")) == 0
        t.join(5)
        assert got["rc"] == 0
        adopted = mid._native_bridge.listener_sockets()
        assert sorted(os.fstat(s.fileno()).st_ino for s in adopted) == inodes
        assert old.drain(2000) == 0
        old.stop()
        c = _short_call(ep, b"mid")
        assert not c.failed and mid_svc.calls == [b"mid"]
        t, got = _export(mid, str(tmp_path / "b.sock"))
        lone, lone_svc = _server(native=True, loops=1)
        with _warnings() as warned:
            assert lone.start(f"127.0.0.1:{ep.port}",
                              inherit_from=str(tmp_path / "b.sock")) == 0
        t.join(5)
        assert got["rc"] == 0
        assert any("inherited shard listener(s) beyond" in w
                   for w in warned), warned
        assert len(lone._native_bridge.listener_sockets()) == 1
        assert mid.drain(2000) == 0
        mid.stop()
        c = _short_call(ep, b"lone")
        assert not c.failed and lone_svc.calls == [b"lone"]
    finally:
        old.stop()
        for s in (mid, lone):
            if s is not None:
                s.stop()


def test_python_transport_closes_inherited_shards(tmp_path):
    """A default successor of a sharded engine server serves the primary
    and closes the shards it cannot serve, with a warning."""
    old, _ = _server(native=True, loops=2)
    assert old.start("127.0.0.1:0") == 0
    ep = old.listen_endpoint
    new = None
    try:
        t, got = _export(old, str(tmp_path / "h.sock"))
        new, new_svc = _server(native=False)
        with _warnings() as warned:
            assert new.start(f"127.0.0.1:{ep.port}",
                             inherit_from=str(tmp_path / "h.sock")) == 0
        t.join(5)
        assert got["rc"] == 0
        assert any("closing 1 inherited shard listener" in w
                   for w in warned), warned
        assert old.drain(2000) == 0
        old.stop()
        c = _short_call(ep, b"py")
        assert not c.failed and new_svc.calls == [b"py"]
    finally:
        old.stop()
        if new is not None:
            new.stop()


def test_export_and_inherit_refusals(tmp_path):
    srv, _ = _server()
    assert srv.export_listeners(str(tmp_path / "x.sock"), 0.1) == -1
    assert srv.start("127.0.0.1:0",
                     inherit_from=str(tmp_path / "nobody.sock")) == -1
    # a handoff that carries no listener on the asked port
    old, _ = _server()
    assert old.start("127.0.0.1:0") == 0
    try:
        t, got = _export(old, str(tmp_path / "p.sock"))
        other, _ = _server()
        busy = socket.socket()
        busy.bind(("127.0.0.1", 0))
        want = busy.getsockname()[1]
        try:
            assert other.start(f"127.0.0.1:{want}",
                               inherit_from=str(tmp_path / "p.sock")) == -1
        finally:
            busy.close()
        t.join(5)
        assert got["rc"] == 0
        c = _short_call(old.listen_endpoint, b"still-mine")
        assert not c.failed
    finally:
        old.stop()


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_handoff_wire_crosses_the_packages(direction, tmp_path):
    """A ``TPUHR1`` handoff written by either package is imported by the
    other's ``import_listeners``: the same listening socket, its queued
    connection accepted by the importer."""
    path = str(tmp_path / "wire.sock")
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(16)
    port = lst.getsockname()[1]
    queued = socket.create_connection(("127.0.0.1", port), timeout=5)
    sender = hot_restart if direction == "port-to-jax" else jhot_restart
    importer = jhot_restart if direction == "port-to-jax" else hot_restart
    got = {}
    t = threading.Thread(target=lambda: got.__setitem__(
        "rc", sender.handoff_listeners(path, [lst], 10.0)))
    t.start()
    while not os.path.exists(path):
        time.sleep(0.005)
    time.sleep(0.05)
    try:
        out = importer.import_listeners(path)
        t.join(5)
        assert got["rc"] == 0
        assert [(h, p) for _s, h, p in out] == [("127.0.0.1", port)]
        s = out[0][0]
        assert os.fstat(s.fileno()).st_ino == os.fstat(lst.fileno()).st_ino
        s.settimeout(5)
        conn, _ = s.accept()
        conn.close()
        s.close()
    finally:
        queued.close()
        lst.close()


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_server_swap_across_the_packages(direction, tmp_path):
    """A JAX server hands its listener to a port server, and a port server
    to a JAX one: after the predecessor drains and stops, new connections
    are the successor's."""
    path = str(tmp_path / "swap.sock")
    if direction == "jax-to-port":
        old, old_svc = JServer(JServerOptions()), JOp()
        old.add_service(old_svc, name="OP")
    else:
        old, old_svc = _server()
    assert old.start("127.0.0.1:0") == 0
    ep = old.listen_endpoint
    new = None
    try:
        t, got = _export(old, path)
        if direction == "jax-to-port":
            new, new_svc = _server()
        else:
            new, new_svc = JServer(JServerOptions()), JOp()
            new.add_service(new_svc, name="OP")
        assert new.start(f"127.0.0.1:{ep.port}", inherit_from=path) == 0
        t.join(5)
        assert got["rc"] == 0
        assert old.drain(2000) == 0
        old.stop()
        for i in range(3):
            c = _short_call(ep, b"swap%d" % i)
            assert not c.failed, c.error_text
        assert new_svc.calls == [b"swap0", b"swap1", b"swap2"]
        assert old_svc.calls == []
    finally:
        old.stop()
        if new is not None:
            new.stop()


def _epoll_targets(epfd: int) -> list:
    """``(descriptor number, inode)`` of every registration in an epoll
    set, from ``/proc/self/fdinfo``."""
    out = []
    with open(f"/proc/self/fdinfo/{epfd}") as f:
        for line in f:
            if line.startswith("tfd:"):
                fields = line.split()
                tfd = int(fields[1])
                ino = [int(f[4:], 16) for f in fields
                       if f.startswith("ino:")]
                out.append((tfd, ino[0] if ino else None))
    return out


@pytest.mark.parametrize("drained", [True, False],
                         ids=["drain-then-stop", "stop"])
def test_reused_descriptor_gets_no_event_of_the_inherited_listener(
        drained, tmp_path):
    """Both servers in one process on ``global_dispatcher()``: after the
    predecessor stops, no registration of the shared listening socket
    remains under its old descriptor number, and when a new socket takes
    that number, connections to the listener (served by the successor)
    deliver no event to the new socket's consumer."""
    old, _ = _server()
    assert old.start("127.0.0.1:0") == 0
    ep = old.listen_endpoint
    old_fd = old._listener.fileno()
    disp = global_dispatcher()
    new = None
    spare, held = [], []
    try:
        t, got = _export(old, str(tmp_path / "e.sock"))
        new, new_svc = _server()
        assert new.start(f"127.0.0.1:{ep.port}",
                         inherit_from=str(tmp_path / "e.sock")) == 0
        t.join(5)
        assert got["rc"] == 0
        ino = os.fstat(new._listener.fileno()).st_ino
        assert (old_fd, ino) in _epoll_targets(disp._ep.fileno())
        if drained:
            assert old.drain(2000) == 0
        old.stop()
        assert (old_fd, ino) not in _epoll_targets(disp._ep.fileno())
        # a new socket takes the old descriptor number
        mine = None
        for _ in range(256):
            a, b = socket.socketpair()
            if a.fileno() == old_fd:
                mine = (a, b)
                break
            if b.fileno() == old_fd:
                mine = (b, a)
                break
            spare.append((a, b))
        assert mine is not None, "the descriptor number was not reused"
        events = []
        disp.add_consumer(mine[0], lambda: events.append(1))
        held.append(mine)
        for i in range(5):
            c = _short_call(ep, b"after%d" % i)
            assert not c.failed
        time.sleep(0.1)
        assert events == [] and len(new_svc.calls) == 5
        mine[1].send(b"!")          # its own readiness still reaches it
        deadline = time.monotonic() + 5
        while not events:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        disp.remove_consumer(mine[0])
    finally:
        old.stop()
        if new is not None:
            new.stop()
        for a, b in spare + held:
            a.close()
            b.close()


def test_predecessor_stop_never_shuts_the_shared_socket_down(tmp_path):
    """The predecessor's stop closes its descriptor only: the successor's
    descriptor of the same socket still listens (a shutdown would have
    ended the listen for both)."""
    old, _ = _server()
    assert old.start("127.0.0.1:0") == 0
    ep = old.listen_endpoint
    new = None
    try:
        t, got = _export(old, str(tmp_path / "s.sock"))
        new, new_svc = _server()
        assert new.start(f"127.0.0.1:{ep.port}",
                         inherit_from=str(tmp_path / "s.sock")) == 0
        t.join(5)
        old.stop()                  # no drain: straight to stop
        lst = new._listener
        assert lst.getsockopt(socket.SOL_SOCKET, socket.SO_ACCEPTCONN) == 1
        c = _short_call(ep, b"alive")
        assert not c.failed and new_svc.calls == [b"alive"]
    finally:
        old.stop()
        if new is not None:
            new.stop()
