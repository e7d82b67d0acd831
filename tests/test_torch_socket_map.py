"""The port's socket map and health check (``transport/socket_map.py``,
``transport/health_check.py``), as ``tests/test_transport.py:186,205``
holds the JAX ones: one shared connection per peer, pooled connections
reused from the free list, a failed socket revived in place, and the
``health_check_interval_s`` flag's default and validator as in the JAX
package."""

import socket
import ssl
import threading
import time

import pytest

from brpc_tpu.butil import flags as jflags
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.butil.endpoint import parse_endpoint
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
from brpc_tpu_torch.server import Server, ServerOptions
from brpc_tpu_torch.server.service import Service
from brpc_tpu_torch.transport import health_check
from brpc_tpu_torch.transport.socket import Socket
from brpc_tpu_torch.transport.socket_map import (MAX_POOLED, SocketMap,
                                                 conn_key,
                                                 global_socket_map,
                                                 pooled_socket,
                                                 return_pooled_socket,
                                                 short_socket,
                                                 socket_pool_of)


def _wait_until(pred, timeout=5.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


@pytest.fixture()
def listener():
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(64)
    accepted = []

    def accept():
        while True:
            try:
                accepted.append(lsock.accept()[0])
            except OSError:
                return

    threading.Thread(target=accept, daemon=True).start()
    yield parse_endpoint("127.0.0.1:%d" % lsock.getsockname()[1]), lsock
    lsock.close()
    for c in accepted:
        c.close()


def test_socket_map_dedup_and_pooled(listener):
    ep, _ = listener
    m = SocketMap(health_check_interval_s=0.0)
    sid1, rc1 = m.get_socket(ep)
    sid2, rc2 = m.get_socket(ep)
    assert rc1 == 0 and rc2 == 0 and sid1 == sid2
    psid1, _ = pooled_socket(ep)
    return_pooled_socket(psid1)
    psid2, _ = pooled_socket(ep)
    assert psid1 == psid2          # reused from the free list
    assert Socket.address(psid2).direct_read
    ssid, rc = short_socket(ep)
    assert rc == 0 and ssid not in (psid1, sid1)
    Socket.address(ssid).release()
    return_pooled_socket(psid2)
    m.clear()
    assert Socket.address(sid1) is None


def test_ssl_is_part_of_the_key(listener):
    ep, _ = listener
    m = SocketMap(health_check_interval_s=0.0)
    plain, _ = m.get_socket(ep)
    assert m.peek(ep) is Socket.address(plain)
    assert m.peek(ep, ssl_context=ssl.create_default_context()) is None
    m.clear()


def test_pool_keeps_at_most_max_pooled(listener):
    ep, _ = listener
    pool = socket_pool_of(ep)
    sids = [pooled_socket(ep)[0] for _ in range(MAX_POOLED + 3)]
    for sid in sids:
        return_pooled_socket(sid)
    assert pool.free_count() == MAX_POOLED == 32
    assert sum(Socket.address(s) is None for s in sids) == 3


def test_refcounted_by_channels(listener):
    ep, _ = listener
    m = global_socket_map()
    key = conn_key(ep)
    m.insert(key)
    m.insert(key)
    sid, rc = m.get_socket(ep)
    assert rc == 0
    m.remove(key)
    assert Socket.address(sid) is not None     # one channel still uses it
    m.remove(key)
    assert Socket.address(sid) is None and m.peek(ep) is None


def test_health_check_revives(listener):
    ep, _ = listener
    m = SocketMap(health_check_interval_s=0.05)
    sid, rc = m.get_socket(ep)
    assert rc == 0
    before = health_check.revive_count()
    s = Socket.address(sid)
    s.set_failed(int(Errno.EFAILEDSOCKET), "injected")
    assert s.failed
    # the count follows the revival (after the reader is armed again);
    # other tests' sockets may revive meanwhile
    assert _wait_until(lambda: not Socket.address(sid).failed
                       and health_check.revive_count() >= before + 1)
    m.clear()


def test_health_check_stops_when_destroyed_or_after_max_attempts():
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    ep = parse_endpoint("127.0.0.1:%d" % lsock.getsockname()[1])
    m = SocketMap(health_check_interval_s=0.0)
    sid, _ = m.get_socket(ep)
    s = Socket.address(sid)
    lsock.close()                                 # nothing to reconnect to
    s.set_failed(int(Errno.EFAILEDSOCKET), "injected")
    attempts = []
    real = Socket.reconnect_now

    def counting(self):
        if self.id == sid:      # other tests' sockets may be revived too
            attempts.append(1)
        return real(self)

    Socket.reconnect_now = counting
    try:
        health_check.start_health_check(sid, 0.02, max_attempts=3)
        time.sleep(0.5)
        assert len(attempts) == 3 and s.failed
        health_check.start_health_check(sid, 0.02)
        time.sleep(0.1)
        s.release()                               # destroyed: revival stops
        n = len(attempts)
        time.sleep(0.2)
        assert len(attempts) <= n + 1
    finally:
        Socket.reconnect_now = real
    m.clear()


class _Echo(Service):
    def Echo(self, cntl, request):
        return request


def test_shared_socket_revived_after_server_restart():
    """A server stopped and started again on its port: the channel's
    shared connection is revived in place (same socket id) within the
    health-check interval, and calls work again."""
    flags.set_flag("health_check_interval_s", 0.1)
    try:
        srv = Server()
        srv.add_service(_Echo(), name="E")
        assert srv.start("127.0.0.1:0") == 0
        ep = srv.listen_endpoint
        co = ChannelOptions()
        co.max_retry = 0
        ch = Channel(co)
        assert ch.init(str(ep)) == 0
        assert ch.call("E.Echo", b"one") == b"one"
        sock = ch._sock
        sid, conn0 = sock.id, sock.conn
        before = health_check.revive_count()
        srv.stop()
        # failed, or already revived (the listener closes last in stop)
        assert _wait_until(lambda: sock.failed or sock.conn is not conn0)
        srv2 = Server()
        srv2.add_service(_Echo(), name="E")
        assert srv2.start(str(ep)) == 0
        try:
            assert _wait_until(
                lambda: health_check.revive_count() >= before + 1
                and not sock.failed, 3.0)
            assert ch._sock is sock and sock.id == sid
            cntl = Controller()
            cntl.max_retry = 3
            c = ch.call_method("E.Echo", b"two", cntl=cntl)
            assert not c.failed and c.response == b"two"
        finally:
            ch.close()
            srv2.stop()
    finally:
        flags.set_flag("health_check_interval_s", 3.0)


def test_health_check_flag_default_and_validator():
    f = {x.name: x for x in flags.list_flags()}["health_check_interval_s"]
    jf = {x.name: x for x in jflags.list_flags()}["health_check_interval_s"]
    assert f.default == jf.default == 3.0
    assert f.reloadable and jf.reloadable
    for v in (0, -1.0):
        assert flags.set_flag("health_check_interval_s", v) is False
        assert jflags.set_flag("health_check_interval_s", v) is False
    assert flags.get_flag("health_check_interval_s") == 3.0


def test_failed_first_connect_leaves_no_entry():
    """A first connect that fails leaves nothing in the map (the JAX map
    keeps the failed socket for its health check); the next call simply
    connects again."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    ep = parse_endpoint("127.0.0.1:%d" % s.getsockname()[1])
    s.close()
    m = SocketMap(health_check_interval_s=0.0)
    sid, rc = m.get_socket(ep)
    assert (sid, rc) == (0, int(Errno.EFAILEDSOCKET))
    assert m.peek(ep) is None


# -- the connection key: credentials and TLS settings ------------------------

class _Auth:
    def verify(self, auth_data, cntl):
        return auth_data == b"secret"


@pytest.fixture()
def authed_server():
    opts = ServerOptions()
    opts.auth = _Auth()
    srv = Server(opts)
    srv.add_service(_Echo(), name="E")
    assert srv.start("127.0.0.1:0") == 0
    yield srv.listen_endpoint
    srv.stop()


def _auth_channel(ep, ctype, auth):
    co = ChannelOptions()
    co.connection_type = ctype
    co.auth_data = auth
    co.max_retry = 0
    co.timeout_ms = 5000
    ch = Channel(co)
    assert ch.init(str(ep)) == 0
    return ch


def _outcome(ch, body):
    c = ch.call_method("E.Echo", body, cntl=Controller())
    return (c.error_code, None) if c.failed else (0, c.response)


@pytest.mark.parametrize("first", ["good", "bad"])
@pytest.mark.parametrize("ctype", ["single", "pooled"])
def test_channels_with_other_credentials_never_share(authed_server, ctype,
                                                     first):
    """A server checks credentials on a connection's first message only:
    a channel with wrong credentials beside a live good one to the same
    peer is refused on a connection of its own, the good one keeps being
    served, and a refused pooled connection is closed, not pooled."""
    ep = authed_server
    good = _auth_channel(ep, ctype, b"secret")
    bad = _auth_channel(ep, ctype, b"wrong")
    order = [good, bad] if first == "good" else [bad, good]
    try:
        for round_ in range(2):
            for ch in order:
                code, resp = _outcome(ch, b"r%d" % round_)
                if ch is good:
                    assert (code, resp) == (0, b"r%d" % round_)
                else:
                    assert code == int(Errno.ERPCAUTH)
        if ctype == "single":
            assert good._sock is not None and bad._sock is not None
            assert good._sock is not bad._sock
        else:
            assert socket_pool_of(ep, None, 1.0, b"wrong").free_count() == 0
            assert socket_pool_of(ep, None, 1.0, b"secret").free_count() >= 1
    finally:
        good.close()
        bad.close()


@pytest.fixture(scope="module")
def two_cas(tmp_path_factory):
    """Two self-signed certificates: the server's, and another CA."""
    import subprocess
    d = tmp_path_factory.mktemp("certs")
    out = []
    for name in ("server", "other"):
        cert, key = str(d / f"{name}.pem"), str(d / f"{name}.key")
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", key, "-out", cert, "-days", "1",
             "-subj", "/CN=localhost",
             "-addext", "subjectAltName=IP:127.0.0.1,DNS:localhost"],
            check=True, capture_output=True, timeout=60)
        out.append((cert, key))
    return out


@pytest.mark.parametrize("ctype", ["single", "pooled"])
def test_tls_channels_with_other_verification_never_share(two_cas, ctype):
    """A channel that pins another CA is not served on a connection an
    unverified channel dialed: its own handshake fails; channels with the
    same TLS options share one context and one connection."""
    (cert, key), (other_ca, _) = two_cas
    opts = ServerOptions()
    opts.ssl_cert, opts.ssl_key = cert, key
    srv = Server(opts)
    srv.add_service(_Echo(), name="E")
    assert srv.start("127.0.0.1:0") == 0
    ep = srv.listen_endpoint

    def tls_channel(**kw):
        co = ChannelOptions()
        co.ssl = True
        co.connection_type = ctype
        co.max_retry = 0
        co.timeout_ms = 5000
        for k, v in kw.items():
            setattr(co, k, v)
        ch = Channel(co)
        assert ch.init(str(ep)) == 0
        return ch

    loose = tls_channel(ssl_verify=False)
    loose2 = tls_channel(ssl_verify=False)
    pinned_wrong = tls_channel(ssl_ca=other_ca, ssl_verify=True)
    pinned_right = tls_channel(ssl_ca=cert, ssl_verify=True)
    try:
        assert _outcome(loose, b"a") == (0, b"a")
        assert _outcome(loose2, b"b") == (0, b"b")
        code, _ = _outcome(pinned_wrong, b"c")
        assert code != 0                    # its handshake fails
        assert _outcome(pinned_right, b"d") == (0, b"d")
        assert loose.ssl_ctx() is loose2.ssl_ctx()
        assert pinned_right.ssl_ctx() is not loose.ssl_ctx()
        if ctype == "single":
            assert loose._sock is loose2._sock
            assert pinned_right._sock is not loose._sock
            assert pinned_wrong._sock is None
    finally:
        for ch in (loose, loose2, pinned_wrong, pinned_right):
            ch.close()
        srv.stop()


@pytest.mark.parametrize("lane", ["raw", "batch", "scatter"])
def test_fast_lanes_send_credentials_until_accepted(authed_server, lane):
    """The raw, batch and scatter lanes carry a channel's credentials on
    a fresh connection's first message, a good channel is served, and a
    bad one beside it is refused on connections of its own."""
    from brpc_tpu_torch.client.channel import RpcError
    from brpc_tpu_torch.client.parallel_channel import ParallelChannel
    ep = authed_server

    def attempt(auth, body):
        if lane == "raw":
            ch = _auth_channel(ep, "pooled", auth)
            try:
                return bytes(ch.call_raw("E.Echo", body, b"")[0])
            finally:
                ch.close()
        if lane == "batch":
            ch = _auth_channel(ep, "pooled", auth)
            try:
                return [bytes(r) for r in ch.call_batch(
                    "E.Echo", [body, body])][0]
            finally:
                ch.close()
        pc = ParallelChannel()
        subs = [_auth_channel(ep, "pooled", auth) for _ in range(2)]
        for sub in subs:
            pc.add_channel(sub)
        c = pc.call_method("E.Echo", body)
        for sub in subs:
            sub.close()
        if c.failed:
            raise RpcError(c.error_code, c.error_text)
        return bytes(c.response[0])

    for round_ in range(2):
        assert attempt(b"secret", b"g%d" % round_) == b"g%d" % round_
        with pytest.raises(RpcError):
            attempt(b"wrong", b"b%d" % round_)
    assert socket_pool_of(ep, None, 1.0, b"wrong").free_count() == 0
