"""The port's dispatcher-driven transport held against the JAX package's
(``tests/test_transport.py:33-184``): the same cases, the same inputs,
through both packages' ``Socket``, ``EventDispatcher``, ``Acceptor`` and
``InputMessenger`` -- versioned addressing, a socketpair write, a large
write that drains by keep-write, write order under concurrency, a failed
socket refusing writes and failing the calls waiting on it, an acceptor
echo round trip over a toy length-prefixed protocol, the dispatcher's
stale-descriptor cases, and no thread per connection on a server with
50 open connections."""

import socket
import struct
import threading
import time

import pytest

from brpc_tpu.butil.iobuf import IOBuf as JIOBuf
from brpc_tpu.protocol.base import ParseResult as JParseResult
from brpc_tpu.protocol.base import Protocol as JProtocol
from brpc_tpu.protocol.base import ProtocolType as JProtocolType
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu.transport.acceptor import Acceptor as JAcceptor
from brpc_tpu.transport.event_dispatcher import \
    EventDispatcher as JEventDispatcher
from brpc_tpu.transport.input_messenger import \
    InputMessenger as JInputMessenger
from brpc_tpu.transport.socket import Socket as JSocket
from brpc_tpu.transport.socket import SocketOptions as JSocketOptions
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel
from brpc_tpu_torch.protocol.base import ParseResult, Protocol, ProtocolType
from brpc_tpu_torch.server import Server, Service
from brpc_tpu_torch.transport.acceptor import Acceptor
from brpc_tpu_torch.transport.event_dispatcher import EventDispatcher
from brpc_tpu_torch.transport.input_messenger import InputMessenger
from brpc_tpu_torch.transport.socket import Socket

PACKAGES = ("port", "jax")


def _wait_until(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


# -- the two packages behind one shape ---------------------------------------

def _socket_of(which, fd):
    if which == "port":
        return Socket(fd)
    return JSocket.address(JSocket.create(JSocketOptions(fd=fd)))


def _address(which, sid):
    return (Socket if which == "port" else JSocket).address(sid)


def _write(which, s, data: bytes) -> bool:
    """True when the write was accepted."""
    if which == "port":
        try:
            s.write(data)
        except OSError:
            return False
        return True
    return s.write(JIOBuf(data)) == 0


def _recv_exact(sock, n, timeout=10.0):
    sock.settimeout(timeout)
    out = bytearray()
    while len(out) < n:
        chunk = sock.recv(min(65536, n - len(out)))
        assert chunk, "peer closed early"
        out.extend(chunk)
    return bytes(out)


@pytest.mark.parametrize("which", PACKAGES)
def test_socket_versioned_addressing(which):
    a, b = socket.socketpair()
    s = _socket_of(which, a)
    sid = s.id
    assert _address(which, sid) is s
    s.release()
    assert _address(which, sid) is None
    b.close()


@pytest.mark.parametrize("which", PACKAGES)
def test_socket_write_over_socketpair(which):
    a, b = socket.socketpair()
    s = _socket_of(which, a)
    assert _write(which, s, b"hello world")
    assert _recv_exact(b, 11) == b"hello world"
    s.release()
    b.close()


@pytest.mark.parametrize("which", PACKAGES)
def test_socket_large_write_drains_via_keepwrite(which):
    a, b = socket.socketpair()
    a.setblocking(False)            # the dispatcher-driven shape
    s = _socket_of(which, a)
    payload = bytes(range(256)) * (4 * 1024 * 1024 // 256)
    t0 = time.monotonic()
    assert _write(which, s, payload)
    # the write returned before the peer read a byte: the kernel took
    # part of it, a keep-write fiber drains the rest
    assert time.monotonic() - t0 < 2.0
    assert _recv_exact(b, len(payload)) == payload
    s.release()
    b.close()


@pytest.mark.parametrize("which", PACKAGES)
def test_socket_write_order_preserved_under_concurrency(which):
    a, b = socket.socketpair()
    a.setblocking(False)
    s = _socket_of(which, a)
    n_threads, per_thread = 8, 50
    counter = threading.Lock()
    seq = [0]

    def writer():
        for _ in range(per_thread):
            with counter:
                i = seq[0]
                seq[0] += 1
                # the number taken and the frame queued atomically: the
                # wire must carry the numbers in order
                assert _write(which, s, struct.pack("<I", i) * 64)

    threads = [threading.Thread(target=writer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    total = n_threads * per_thread * 256
    data = _recv_exact(b, total)
    for t in threads:
        t.join()
    values = [struct.unpack_from("<I", data, off)[0]
              for off in range(0, total, 256)]
    assert values == list(range(n_threads * per_thread))
    # every frame whole: its 64 copies of one number
    assert all(data[off:off + 256] == data[off:off + 4] * 64
               for off in range(0, total, 256))
    s.release()
    b.close()


class _Waiter:
    def __init__(self):
        self.why = None
        self.done = threading.Event()

    def fail(self, why):
        self.why = why
        self.done.set()


@pytest.mark.parametrize("which", PACKAGES)
def test_set_failed_refuses_writes(which):
    a, b = socket.socketpair()
    s = _socket_of(which, a)
    assert _write(which, s, b"zzz")
    s.set_failed(int(Errno.EFAILEDSOCKET), "test")
    assert s.failed
    # a write after the failure is refused at once
    assert not _write(which, s, b"after")
    b.close()


def test_set_failed_wakes_the_calls_waiting():
    """The port's waiters (where the JAX socket notifies ``id_wait``):
    each call waiting on the connection fails with the verdict, and a
    registration after it is refused."""
    a, b = socket.socketpair()
    s = Socket(a)
    waiters = [_Waiter() for _ in range(3)]
    for cid, w in enumerate(waiters, 1):
        assert s.add_waiter(cid, w)
    s.set_failed(int(Errno.EFAILEDSOCKET), "peer gone")
    assert all(w.done.wait(1) and w.why == "peer gone" for w in waiters)
    assert not s.add_waiter(9, _Waiter())
    s.release()
    b.close()


# -- a toy framed protocol (4-byte magic + u32 length + body) ----------------

MAGIC = b"TOY0"


def _toy_parse(result_cls):
    def parse(source, sock, read_eof, arg):
        if len(source) < 8:
            got = source.fetch(min(4, len(source)))
            if MAGIC.startswith(got):
                return result_cls.not_enough_data()
            return result_cls.try_others()
        head = source.fetch(8)
        if head[:4] != MAGIC:
            return result_cls.try_others()
        (ln,) = struct.unpack_from("<I", head, 4)
        if len(source) < 8 + ln:
            return result_cls.not_enough_data()
        source.pop_front(8)
        return result_cls.make_message(source.cutn(ln).to_bytes())
    return parse


def _toy_frame(payload: bytes) -> bytes:
    return MAGIC + struct.pack("<I", len(payload)) + payload


def _toy_acceptor(which):
    seen = []

    def process(msg, sock, arg):
        seen.append(msg)
        _write(which, sock, _toy_frame(msg.upper()))

    if which == "port":
        proto = Protocol(ProtocolType.UNKNOWN, "toy", _toy_parse(ParseResult),
                         process_request=process)
        return Acceptor(InputMessenger([proto], arg="server")), seen
    proto = JProtocol(JProtocolType.UNKNOWN, "toy", _toy_parse(JParseResult),
                      process_request=process)
    return JAcceptor(JInputMessenger([proto], arg="server")), seen


@pytest.mark.parametrize("which", PACKAGES)
def test_acceptor_echo_roundtrip(which):
    acceptor, seen = _toy_acceptor(which)
    listener = socket.socket()
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind(("127.0.0.1", 0))
    listener.listen(16)
    port = listener.getsockname()[1]
    acceptor.start_accept(listener)
    c = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    c.sendall(_toy_frame(b"hello") + _toy_frame(b"there"))
    got = _recv_exact(c, 2 * (8 + 5))
    # the first message ran on a fiber of its own, the gulp's last
    # inline: either answer may leave first
    assert sorted((got[:13], got[13:])) == [_toy_frame(b"HELLO"),
                                            _toy_frame(b"THERE")]
    assert sorted(seen) == [b"hello", b"there"]
    assert _wait_until(lambda: acceptor.connection_count() == 1)
    c.close()
    assert _wait_until(lambda: acceptor.connection_count() == 0)
    acceptor.stop_accept()


# -- the dispatcher's stale descriptors --------------------------------------

def _dispatcher(which):
    return EventDispatcher("test_dispatcher") if which == "port" \
        else JEventDispatcher("test_dispatcher")


@pytest.mark.parametrize("which", PACKAGES)
def test_dispatcher_drops_an_op_on_a_closed_descriptor(which):
    """EBADF: interest queued for a descriptor closed before the
    dispatcher applies it is dropped quietly, and the dispatcher goes on
    serving the others."""
    disp = _dispatcher(which)
    try:
        c, d = socket.socketpair()      # made first: no number reused
        a, b = socket.socketpair()
        disp.add_consumer(a, lambda: None)
        a.close()
        b.close()
        fired = threading.Event()
        disp.add_consumer(c, fired.set)
        d.sendall(b"x")
        assert fired.wait(5)
        c.close()
        d.close()
    finally:
        disp.stop()


def test_dispatcher_reregisters_a_reused_descriptor_number():
    """A descriptor number closed and reused behind a stale registration:
    the new connection's interest replaces it and fires.  The port's
    dispatcher only: the JAX one keeps the stale registration here (its
    ``modify`` with equal events and data never reaches the kernel), a
    divergence ROADMAP C9 records."""
    which = "port"
    disp = _dispatcher(which)
    try:
        a, b = socket.socketpair()
        stale = threading.Event()
        disp.add_consumer(a, stale.set)
        time.sleep(0.05)                # the registration is applied
        num = a.fileno()
        a.close()
        b.close()
        pairs = []
        for _ in range(64):             # reuse the number
            c, d = socket.socketpair()
            if c.fileno() == num:
                break
            pairs.append((c, d))
        else:
            pytest.skip("the kernel did not reuse the descriptor number")
        fresh = threading.Event()
        disp.add_consumer(c, fresh.set)
        d.sendall(b"y")
        assert fresh.wait(5)
        assert not stale.is_set()
        for x, y in pairs + [(c, d)]:
            x.close()
            y.close()
    finally:
        disp.stop()


@pytest.mark.parametrize("which", PACKAGES)
def test_dispatcher_read_interest_suspends_until_rearmed(which):
    """Read interest is suspended when an event fires: bytes that arrive
    before the consumer re-arms fire once, at the re-arm."""
    disp = _dispatcher(which)
    try:
        a, b = socket.socketpair()
        fired = []
        disp.add_consumer(a, lambda: fired.append(1))
        b.sendall(b"1")
        assert _wait_until(lambda: len(fired) == 1)
        b.sendall(b"2")
        time.sleep(0.1)
        assert len(fired) == 1          # not re-armed yet
        disp.rearm_read(a.fileno())
        assert _wait_until(lambda: len(fired) == 2)
        a.close()
        b.close()
    finally:
        disp.stop()


# -- no thread per connection ------------------------------------------------

class _Echo:
    def Echo(self, cntl, request):
        return bytes(request)


class TEcho(Service, _Echo):
    pass


class JEcho(JService, _Echo):
    pass


@pytest.mark.parametrize("which", PACKAGES)
def test_no_thread_per_connection(which):
    srv = Server() if which == "port" else JServer()
    srv.add_service(TEcho() if which == "port" else JEcho(), name="E")
    assert srv.start("127.0.0.1:0") == 0
    ep = srv.listen_endpoint
    conns = []
    try:
        ch = Channel()
        assert ch.init(str(ep)) == 0
        assert ch.call("E.Echo", b"warm") == b"warm"
        before = {t.ident for t in threading.enumerate()}
        frame = _echo_frame(b"ping")
        for _ in range(50):
            c = socket.create_connection((ep.host, ep.port), timeout=10)
            c.sendall(frame)
            conns.append(c)
        for c in conns:
            assert _recv_frame(c)[-4:] == b"ping"
        assert _wait_until(lambda: srv.connection_count() >= 51)
        grown = [t.name for t in threading.enumerate()
                 if t.ident not in before]
        # the fiber pool may grow under load (its starvation monitor);
        # a thread per connection would add at least 50
        assert len(grown) < 25, grown
        ch.close()
    finally:
        for c in conns:
            c.close()
        srv.stop()


def _echo_frame(payload: bytes) -> bytes:
    from brpc_tpu_torch.protocol.meta import RpcMeta
    from brpc_tpu_torch.protocol.tpu_std import pack_frame
    meta = RpcMeta()
    meta.correlation_id = 7
    meta.service_name, meta.method_name = "E", "Echo"
    return pack_frame(meta, payload)


def _recv_frame(c) -> bytes:
    head = _recv_exact(c, 12)
    (body,) = struct.unpack_from("<I", head, 4)
    return head + _recv_exact(c, body)
