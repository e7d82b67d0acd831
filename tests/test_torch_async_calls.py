"""Async calls and call ids, held against the JAX package's
(``tests/test_echo_e2e.py``'s ``test_async_call``, ``test_cancel`` and
``test_server_async_method``): the port's ``call_method(done=)``,
``call_id``/``join`` and ``start_cancel`` against a port server and a
JAX server; a handler's ``begin_async`` finishing on another thread over
tpu_std, HTTP and gRPC on both servers; and a JAX async client (with its
cancel) against a port server."""

import http.client
import threading
import time

import pytest

from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import Controller as JController
from brpc_tpu.client import start_cancel as jstart_cancel
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import (Channel, ChannelOptions, Controller,
                                   start_cancel)
from brpc_tpu_torch.fiber import global_id_pool

SLOW_S = 1.0


class _Echo:
    def Echo(self, cntl, request):
        return bytes(request)

    def Slow(self, cntl, request):
        time.sleep(SLOW_S)
        return b"slow done"

    def AsyncEcho(self, cntl, request):
        cntl.begin_async()
        data = bytes(request)

        def later():
            time.sleep(0.05)
            cntl.finish(b"async:" + data)
        threading.Thread(target=later, daemon=True).start()
        return None

    def AsyncFail(self, cntl, request):
        cntl.begin_async()

        def later():
            time.sleep(0.02)
            cntl.set_failed(int(Errno.EREQUEST), "late refusal")
            cntl.finish(None)
        threading.Thread(target=later, daemon=True).start()
        return None

    def AsyncSlow(self, cntl, request):
        cntl.begin_async()

        def later():
            time.sleep(SLOW_S)
            cntl.finish(b"late")
            cntl.finish(b"twice")        # the first finish wins
        threading.Thread(target=later, daemon=True).start()
        return None


class TEcho(_Echo):
    pass


class JEcho(JService, _Echo):
    pass


@pytest.fixture(scope="module")
def servers():
    from brpc_tpu_torch.server import Server
    port = Server()
    assert port.add_service(TEcho(), name="E") == 0
    jsrv = JServer()
    assert jsrv.add_service(JEcho(), name="E") == 0
    for s in (port, jsrv):
        assert s.start("127.0.0.1:0") == 0
    yield {"port": port, "jax": jsrv}
    port.stop()
    jsrv.stop()


def _channel(srv, protocol="tpu_std", **opts):
    co = ChannelOptions()
    co.timeout_ms = 5000
    co.protocol = protocol
    for k, v in opts.items():
        setattr(co, k, v)
    ch = Channel(co)
    assert ch.init(str(srv.listen_endpoint)) == 0
    return ch


SERVERS = ["port", "jax"]


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("protocol", ["tpu_std", "http", "grpc"])
def test_call_method_done(servers, server, protocol):
    ch = _channel(servers[server], protocol)
    done = threading.Event()
    seen = {}

    def on_done(c):
        seen.update(failed=c.failed, resp=c.response, text=c.error_text)
        done.set()

    try:
        c = ch.call_method("E.Echo", b"async-req", done=on_done)
        assert c.call_id != 0
        assert done.wait(5.0)
        assert not seen["failed"], seen["text"]
        assert seen["resp"] == b"async-req"
    finally:
        ch.close()


@pytest.mark.parametrize("server", SERVERS)
def test_call_id_join(servers, server):
    ch = _channel(servers[server])
    try:
        ran = []
        c = ch.call_method("E.Slow", b"x", done=lambda c: ran.append(1))
        cid = c.call_id
        assert global_id_pool().valid(cid)
        assert c.join(0.01) is False            # still running
        assert c.join(5.0) is True
        assert not c.failed and c.response == b"slow done"
        assert not global_id_pool().valid(cid)  # the id died at the end
        time.sleep(0.01)
        assert ran == [1]
        # a blocking call's id is dead when it returns
        c2 = ch.call_method("E.Echo", b"y")
        assert c2.response == b"y" and c2.join(0) is True
        start_cancel(c2.call_id)                # a no-op after the end
        assert not c2.failed
    finally:
        ch.close()


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("ctype", ["single", "pooled"])
def test_start_cancel(servers, server, ctype):
    ch = _channel(servers[server], connection_type=ctype)
    cntl = Controller()
    cntl.timeout_ms = 5000
    done_evt = threading.Event()
    try:
        t0 = time.monotonic()
        ch.call_method("E.Slow", b"x", done=lambda c: done_evt.set(),
                       cntl=cntl)
        start_cancel(cntl.call_id)
        assert done_evt.wait(2.0)
        assert time.monotonic() - t0 < SLOW_S       # not the response
        assert cntl.failed
        assert cntl.error_code == int(Errno.ECANCELLED)
        assert cntl.response is None
        # the late response is dropped; the channel serves the next call
        time.sleep(SLOW_S + 0.1)
        assert cntl.response is None
        assert ch.call_method("E.Echo", b"next").response == b"next"
    finally:
        ch.close()


def test_blocking_call_cancelled_from_another_thread(servers):
    """A cancel from another thread ends a blocking call ECANCELLED when
    its attempt returns, the response dropped."""
    ch = _channel(servers["port"])
    cntl = Controller()
    try:
        timer = threading.Timer(0.1, lambda: start_cancel(cntl.call_id))
        timer.start()
        c = ch.call_method("E.Slow", b"x", cntl=cntl)
        timer.join()
        assert c.error_code == int(Errno.ECANCELLED)
        assert c.response is None
    finally:
        ch.close()


@pytest.mark.parametrize("server", SERVERS)
def test_response_type(servers, server):
    class Upper:
        def parse(self, data):
            self.text = bytes(data).decode().upper()

    ch = _channel(servers[server])
    try:
        c = ch.call_method("E.Echo", b"abc", response_type=Upper)
        assert not c.failed and c.response.text == "ABC"
        c = ch.call_method("E.Echo", b"abc", response_type=bytes,
                           attachment=b"")
        assert c.response == b"abc"
    finally:
        ch.close()


# -- begin_async on the server ----------------------------------------------

@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("protocol", ["tpu_std", "http", "grpc"])
def test_server_async_method(servers, server, protocol):
    ch = _channel(servers[server], protocol)
    try:
        c = ch.call_method("E.AsyncEcho", b"ping")
        assert not c.failed, c.error_text
        assert c.response == b"async:ping"
        c = ch.call_method("E.AsyncFail", b"ping")
        assert c.failed and c.error_code == int(Errno.EREQUEST)
    finally:
        ch.close()


def test_async_handlers_over_raw_http_match_jax(servers):
    got = {}
    for which, srv in servers.items():
        ep = srv.listen_endpoint
        conn = http.client.HTTPConnection(ep.host, ep.port, timeout=10)
        try:
            conn.request("POST", "/E/AsyncEcho", body=b"hi")
            r = conn.getresponse()
            got[which] = (r.status, r.read())
        finally:
            conn.close()
    assert got["port"] == got["jax"] == (200, b"async:hi")


@pytest.mark.parametrize("server", SERVERS)
def test_async_response_overtaken_on_one_connection(servers, server):
    """An async handler does not hold its connection: a later call on the
    same connection is answered first, its response pairs with its call
    by correlation id (both packages)."""
    ch = _channel(servers[server], connection_type="single")
    try:
        order = []
        first = ch.call_method("E.AsyncSlow", b"a",
                               done=lambda c: order.append("slow"))
        time.sleep(0.05)
        second = ch.call_method("E.Echo", b"b")
        order.append("echo")
        assert first.join(5.0)
        assert order == ["echo", "slow"]
        assert second.response == b"b" and first.response == b"late"
    finally:
        ch.close()


def test_async_request_in_flight_until_finish(servers):
    """An async request counts as in flight (what a drain waits for) and
    in MethodStatus only once it finishes."""
    srv = servers["port"]
    status = srv.method_status("E.AsyncSlow")
    ch = _channel(srv)
    try:
        before = status.latency.count()
        c = ch.call_method("E.AsyncSlow", b"a", done=lambda c: None)
        deadline = time.monotonic() + SLOW_S / 2
        while srv.inflight != 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert srv.inflight == 1
        assert status.latency.count() == before
        assert c.join(5.0) and c.response == b"late"
        deadline = time.monotonic() + 2
        while srv.inflight and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.inflight == 0
        assert status.latency.count() == before + 1
    finally:
        ch.close()


# -- the JAX async client against a port server ------------------------------

def test_jax_async_client_against_port_server(servers):
    ch = JChannel()
    assert ch.init(str(servers["port"].listen_endpoint)) == 0
    done_evt = threading.Event()
    result = {}

    def on_done(c):
        result.update(failed=c.failed, resp=c.response)
        done_evt.set()

    ch.call_method("E.Echo", b"async-req", done=on_done)
    assert done_evt.wait(5.0)
    assert not result["failed"] and result["resp"] == b"async-req"
    c = ch.call_method("E.AsyncEcho", b"ping")
    assert not c.failed and c.response == b"async:ping"
    cntl = JController()
    cntl.timeout_ms = 5000
    cancelled = threading.Event()
    ch.call_method("E.Slow", b"x", done=lambda c: cancelled.set(),
                   cntl=cntl)
    jstart_cancel(cntl.call_id)
    assert cancelled.wait(2.0)
    assert cntl.error_code == int(Errno.ECANCELLED)
