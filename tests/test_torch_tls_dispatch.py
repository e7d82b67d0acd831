"""The port's TLS server on the event dispatcher under load, from the
JAX client and from the port's client: many concurrent calls with 1 MiB
attachments, and one call at a time, on one ``"single"`` connection
while four threads keep the cores and the interpreter busy.  The dispatcher's consumer reads the SSL object and
the write path's drainer writes it, each holding the socket's write
lock (ROADMAP C15: one SSL object is never read and written by two
threads at once); a race between them shows as an SSL error
(``SSLV3_ALERT_BAD_RECORD_MAC``), a failed call or a corrupted
attachment.  The certificates are made with the ``openssl`` CLI, as
``tests/test_ssl.py`` makes them."""

import hashlib
import socket
import ssl
import struct
import subprocess
import threading
import time

import pytest

from brpc_tpu.butil.iobuf import IOBuf as JIOBuf
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import ChannelOptions as JChannelOptions
from brpc_tpu.client import Controller as JController
from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
from brpc_tpu_torch.protocol.meta import RpcMeta
from brpc_tpu_torch.protocol.tpu_std import pack_frame
from brpc_tpu_torch.server import Server, ServerOptions, Service

CALLERS = 8
CALLS_EACH = 4
ATT = 1 << 20


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("certs")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1",
         "-subj", "/CN=localhost",
         "-addext", "subjectAltName=IP:127.0.0.1,DNS:localhost"],
        check=True, capture_output=True, timeout=60)
    return cert, key


class Att(Service):
    def Att(self, cntl, request):
        cntl.response_attachment = cntl.request_attachment
        return bytes(request)


@pytest.fixture(scope="module")
def tls_server(certs):
    opts = ServerOptions()
    opts.ssl_cert, opts.ssl_key = certs
    srv = Server(opts)
    srv.add_service(Att(), name="E")
    assert srv.start("127.0.0.1:0") == 0
    yield srv
    srv.stop()


def _busy(stop: threading.Event, in_interpreter: bool) -> None:
    """A core kept busy: inside the interpreter's lock (the connection's
    threads then hand it over at every switch interval), or mostly
    outside it (the hash releases it), so they race on the cores."""
    data = b"\x5a" * (1 << 20)
    while not stop.is_set():
        if in_interpreter:
            sum(range(2000))
        else:
            hashlib.sha256(data).digest()


def _busy_threads(stop: threading.Event, in_interpreter=(1, 1, 0, 0)
                  ) -> list:
    return [threading.Thread(target=_busy, args=(stop, bool(x)),
                             daemon=True) for x in in_interpreter]


def _channel(client, server):
    co = ChannelOptions() if client == "port" else JChannelOptions()
    co.ssl = True
    co.connection_type = "single"
    co.timeout_ms = 30_000
    co.max_retry = 0
    ch = Channel(co) if client == "port" else JChannel(co)
    assert ch.init(str(server.listen_endpoint)) == 0
    return ch


def _call(client, ch, i: int, j: int, size: int = ATT):
    """One echo of an attachment (1 MiB by default) whose bytes name the
    call: an error text, or None when the answer is whole."""
    att = bytes([(i * 31 + j) % 251]) * size
    req = b"c%d-%d" % (i, j)
    if client == "port":
        c = ch.call_method("E.Att", req, cntl=Controller(), attachment=att)
        got = None if c.failed else bytes(c.response_attachment or b"")
    else:
        c = JController()
        c.request_attachment = JIOBuf(att)
        ch.call_method("E.Att", req, cntl=c)
        got = None if c.failed else c.response_attachment.to_bytes()
    if c.failed:
        return f"{c.error_code} {c.error_text}"
    if bytes(c.response) != req or got != att:
        return "a corrupted answer"
    return None


@pytest.mark.parametrize("client", ["port", "jax"])
def test_tls_sequential_echoes_under_busy_threads(tls_server, client):
    """``test_tls.py``'s echo pattern, longer: one call at a time on one
    connection, the server reading the next request while it writes the
    last answer."""
    ch = _channel(client, tls_server)
    stop = threading.Event()
    busy = _busy_threads(stop)
    try:
        for t in busy:
            t.start()
        errors = [e for e in (_call(client, ch, i, 0, 64 << 10)
                              for i in range(40)) if e is not None]
    finally:
        stop.set()
        for t in busy:
            t.join(5)
        if hasattr(ch, "close"):
            ch.close()
    assert errors == []


@pytest.mark.parametrize("client", ["port", "jax"])
def test_tls_concurrent_attachments_on_one_connection(tls_server, client):
    ch = _channel(client, tls_server)
    stop = threading.Event()
    busy = _busy_threads(stop)
    errors = []
    try:
        assert _call(client, ch, 0, 0) is None        # the handshake
        for t in busy:
            t.start()

        def caller(i):
            for j in range(CALLS_EACH):
                err = _call(client, ch, i, j)
                if err is not None:
                    errors.append(err)

        callers = [threading.Thread(target=caller, args=(i,))
                   for i in range(CALLERS)]
        for t in callers:
            t.start()
        for t in callers:
            t.join(120)
        assert not any(t.is_alive() for t in callers)
    finally:
        stop.set()
        for t in busy:
            t.join(5)
        if hasattr(ch, "close"):
            ch.close()
    assert errors == []
    # one connection carried every call (an earlier test's closed one
    # leaves once the server reads its end)
    deadline = time.monotonic() + 10
    while tls_server.connection_count() > 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert tls_server.connection_count() <= 1


class _Watched(ssl.SSLSocket):
    """An SSLSocket that notes every time one thread enters a read while
    another is inside a write on the same SSL object, or the reverse."""

    lock = threading.Lock()
    inside = {}              # id(sock) -> {"r"/"w": {thread id: depth}}
    overlaps = []
    seen = {"r": 0, "w": 0}

    def _enter(self, kind):
        me = threading.get_ident()
        with self.lock:
            self.seen[kind] += 1
            st = self.inside.setdefault(id(self), {"r": {}, "w": {}})
            other = st["w" if kind == "r" else "r"]
            if any(t != me for t in other):
                self.overlaps.append(kind)
            st[kind][me] = st[kind].get(me, 0) + 1

    def _leave(self, kind):
        me = threading.get_ident()
        with self.lock:
            st = self.inside[id(self)][kind]
            st[me] -= 1
            if not st[me]:
                del st[me]

    def read(self, *a, **k):
        self._enter("r")
        try:
            return super().read(*a, **k)
        finally:
            self._leave("r")

    def send(self, *a, **k):
        self._enter("w")
        try:
            return super().send(*a, **k)
        finally:
            self._leave("w")

    def write(self, *a, **k):
        self._enter("w")
        try:
            return super().write(*a, **k)
        finally:
            self._leave("w")


class _WatchedContext(ssl.SSLContext):
    sslsocket_class = _Watched


@pytest.mark.parametrize("client", ["port", "jax"])
def test_tls_server_never_reads_and_writes_one_ssl_object_at_once(
        certs, client):
    """Every SSL read and write of the server's connections, watched: a
    read never overlaps a write on one SSL object (ROADMAP C15).  A
    server whose reader sits in a blocking SSL read while the
    connection's worker writes the answer breaks this on every call."""
    ctx = _WatchedContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(*certs)
    ctx.num_tickets = 0
    opts = ServerOptions()
    opts.ssl_context = ctx
    srv = Server(opts)
    srv.add_service(Att(), name="E")
    assert srv.start("127.0.0.1:0") == 0
    del _Watched.overlaps[:]
    _Watched.seen.update(r=0, w=0)
    ch = _channel(client, srv)
    try:
        errors = [e for e in (_call(client, ch, i, 0, 64 << 10)
                              for i in range(12)) if e is not None]
    finally:
        if hasattr(ch, "close"):
            ch.close()
        srv.stop()
    assert errors == []
    assert _Watched.seen["r"] >= 12 and _Watched.seen["w"] >= 12
    assert _Watched.overlaps == []


def _frame(cid: int, payload: bytes) -> bytes:
    meta = RpcMeta()
    meta.correlation_id = cid
    meta.service_name, meta.method_name = "E", "Att"
    return pack_frame(meta, payload)


def _answers(conn, n: int) -> list:
    """The correlation ids and payload sizes of the next ``n`` frames."""
    got, out = b"", []
    while len(out) < n:
        while len(got) < 12 or len(got) < 12 + struct.unpack_from(
                "<I", got, 4)[0]:
            chunk = conn.recv(65536)
            assert chunk, "the server closed the connection"
            got += chunk
        body, meta_size = struct.unpack_from("<II", got, 4)
        meta = RpcMeta.decode(got[12:12 + meta_size])
        out.append((meta.correlation_id, body - meta_size))
        got = got[12 + body:]
    return out


def test_tls_frames_left_decrypted_in_openssl_are_served(tls_server):
    """Two frames in one TLS record larger than a read: the consumer's
    first read leaves the rest of the record decrypted inside OpenSSL,
    where no readiness event will show it; both are answered."""
    cctx = ssl.create_default_context()
    cctx.check_hostname = False
    cctx.verify_mode = ssl.CERT_NONE
    ep = tls_server.listen_endpoint
    raw = socket.create_connection((str(ep.host), ep.port), timeout=10)
    with cctx.wrap_socket(raw, server_hostname="localhost") as conn:
        # small messages first: the adaptive read size falls to 4 KiB
        for cid in range(1, 33):
            conn.sendall(_frame(cid, b"x"))
            assert _answers(conn, 1) == [(cid, 1)]
        big = 12 << 10
        conn.sendall(_frame(100, b"a") + _frame(101, b"b" * big))
        conn.settimeout(5)
        assert sorted(_answers(conn, 2)) == [(100, 1), (101, big)]
