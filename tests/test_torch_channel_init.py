"""A channel's first call is charged its connect, never the native
engine's build.

The engine behind the client lane and the fast lane loads on its first
use, and on a fresh checkout that first use builds it (seconds with g++).
``Channel.init`` now loads it, as brpc's ``Channel::Init`` runs
``GlobalInitializeOrDie``, so a first call with the default 500 ms budget
no longer times out behind the build (the cause of
``test_torch_ecosystem.py::test_redis_and_rpc_share_the_port`` failing in
a whole parallel run whose worker built the engine during that call).
"""

import threading
import time

import pytest

from brpc_tpu_torch.butil.flags import set_flag
from brpc_tpu_torch.client import Channel, ChannelOptions
from brpc_tpu_torch.server import Server, Service
from brpc_tpu_torch.transport import client_lane

BUILD_S = 1.0       # a stand-in for the engine's build, over the budget


class Echo(Service):
    def Echo(self, cntl, request):
        return request


@pytest.fixture()
def server():
    srv = Server()
    assert srv.add_service(Echo(), name="E") == 0
    assert srv.start("127.0.0.1:0") == 0
    yield srv
    srv.stop()


@pytest.fixture()
def slow_first_load(monkeypatch):
    """The client lane's first load takes BUILD_S, as a build would."""
    real = client_lane.global_client_lane
    state = {"first": True, "loads": []}

    def slow(create=True):
        if create and state["first"]:
            state["first"] = False
            state["loads"].append(threading.current_thread().name)
            time.sleep(BUILD_S)
        return real(create)

    monkeypatch.setattr(client_lane, "global_client_lane", slow)
    return state


def test_first_call_is_not_charged_the_engine_build(server,
                                                    slow_first_load):
    ch = Channel()                      # default budget: 500 ms
    t0 = time.monotonic()
    assert ch.init(str(server.listen_endpoint)) == 0
    init_s = time.monotonic() - t0
    try:
        t0 = time.monotonic()
        assert ch.call("E.Echo", b"first") == b"first"
        call_s = time.monotonic() - t0
    finally:
        ch.close()
    assert slow_first_load["loads"], "the lane was never loaded"
    assert init_s >= BUILD_S > call_s


def test_init_leaves_the_lane_alone_when_it_is_not_used(server,
                                                       slow_first_load):
    assert set_flag("rpc_native_client_lane", False)
    try:
        ch = Channel()
        assert ch.init(str(server.listen_endpoint)) == 0
        assert slow_first_load["loads"] == []
        ch.close()
    finally:
        set_flag("rpc_native_client_lane", True)
    # an HTTP channel never uses the lane
    http = Channel(ChannelOptions(), protocol="http")
    assert http.init(str(server.listen_endpoint)) == 0
    assert slow_first_load["loads"] == []
    http.close()
