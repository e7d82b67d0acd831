"""The port's combo channels, case by case as
``tests/test_combo_channels.py`` (Parallel fan-out with partial failure,
Selective failover, Partition sharding by naming tags), plus the fan-out
over JAX servers, a traced fan-out's root span, and the shared budget."""

import time

import pytest

from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import (SKIP, Channel, Controller,
                                   ParallelChannel, PartitionChannel,
                                   SelectiveChannel)
from brpc_tpu_torch.client.circuit_breaker import global_circuit_breaker_map
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.server.service import Service


class Tagged(Service):
    def __init__(self, who):
        self.who = who

    def Who(self, cntl, request):
        return f"{self.who}:{request.decode()}".encode()


def _server(who):
    srv = Server()
    srv.add_service(Tagged(who), name="T")
    assert srv.start("127.0.0.1:0") == 0
    return srv


@pytest.fixture(autouse=True)
def _clean_breakers():
    global_circuit_breaker_map().reset()
    yield
    global_circuit_breaker_map().reset()


def test_parallel_channel_fanout_and_merge():
    servers = [_server(w) for w in "abc"]
    try:
        pc = ParallelChannel()
        for s in servers:
            ch = Channel()
            ch.init(str(s.listen_endpoint))
            pc.add_channel(ch)
        c = pc.call_method("T.Who", b"x",
                           merger=lambda rs: b",".join(rs))
        assert not c.failed, c.error_text
        assert c.response == b"a:x,b:x,c:x"
    finally:
        for s in servers:
            s.stop()


def test_parallel_channel_call_mapper_skip():
    servers = [_server(w) for w in "ab"]
    try:
        pc = ParallelChannel()
        for i, s in enumerate(servers):
            ch = Channel()
            ch.init(str(s.listen_endpoint))
            pc.add_channel(ch, call_mapper=lambda i, sub, req, _i=i:
                           SKIP if _i == 1 else req + b"!")
        c = pc.call_method("T.Who", b"q")
        assert not c.failed
        assert c.response == [b"a:q!"]
    finally:
        for s in servers:
            s.stop()


def test_parallel_channel_fail_limit():
    s1 = _server("a")
    try:
        pc = ParallelChannel(fail_limit=1)
        ok = Channel()
        ok.init(str(s1.listen_endpoint))
        dead = Channel()
        dead.init("127.0.0.1:1")        # nothing listens
        pc.add_channel(ok)
        pc.add_channel(dead)
        cntl = Controller()
        cntl.timeout_ms = 2000
        c = pc.call_method("T.Who", b"x", cntl=cntl)
        assert c.failed
        assert c.error_code == int(Errno.ETOOMANYFAILS)
    finally:
        s1.stop()


def test_parallel_channel_tolerates_failures_under_limit():
    s1 = _server("a")
    try:
        pc = ParallelChannel(fail_limit=2)
        ok = Channel()
        ok.init(str(s1.listen_endpoint))
        dead = Channel()
        dead.init("127.0.0.1:1")
        pc.add_channel(ok)
        pc.add_channel(dead)
        cntl = Controller()
        cntl.timeout_ms = 2000
        c = pc.call_method("T.Who", b"x", cntl=cntl)
        assert not c.failed, c.error_text
        assert c.response == [b"a:x", None]
    finally:
        s1.stop()


def test_selective_channel_failover():
    s1 = _server("alive")
    try:
        sc = SelectiveChannel()
        dead = Channel()
        dead.init("127.0.0.1:1")
        ok = Channel()
        ok.init(str(s1.listen_endpoint))
        sc.add_channel(dead)
        sc.add_channel(ok)
        for _ in range(4):
            cntl = Controller()
            cntl.timeout_ms = 2000
            c = sc.call_method("T.Who", b"z", cntl=cntl)
            assert not c.failed, c.error_text
            assert c.response == b"alive:z"
    finally:
        s1.stop()


def test_partition_channel_shards_by_tag():
    # 2 partitions × 2 replicas
    servers = {w: _server(w) for w in ("p0a", "p0b", "p1a", "p1b")}
    try:
        url = ("list://"
               f"{servers['p0a'].listen_endpoint} 0/2,"
               f"{servers['p0b'].listen_endpoint} 0/2,"
               f"{servers['p1a'].listen_endpoint} 1/2,"
               f"{servers['p1b'].listen_endpoint} 1/2")
        pch = PartitionChannel()
        assert pch.init(url, "rr") == 0
        assert pch.partitions == [0, 1]

        # per-partition request shaping: partition k gets its own slice
        c = pch.call_method(
            "T.Who", b"k0|k1",
            call_mapper=lambda i, sub, req: req.split(b"|")[i])
        assert not c.failed, c.error_text
        assert len(c.response) == 2
        assert c.response[0].endswith(b":k0")
        assert c.response[0][:2] == b"p0"
        assert c.response[1].endswith(b":k1")
        assert c.response[1][:2] == b"p1"
        pch.stop()
    finally:
        for s in servers.values():
            s.stop()


class JTagged(Tagged, JService):
    pass


def test_parallel_channel_over_jax_servers_matches_port_servers():
    """The same fan-out through port sub-channels to JAX servers and to
    port servers merges the same bytes."""
    got = {}
    for package, srv_cls, svc_cls in (("port", Server, Tagged),
                                      ("jax", JServer, JTagged)):
        servers = []
        for w in "ab":
            s = srv_cls()
            assert s.add_service(svc_cls(w), name="T") == 0
            assert s.start("127.0.0.1:0") == 0
            servers.append(s)
        try:
            pc = ParallelChannel()
            for s in servers:
                ch = Channel()
                ch.init(str(s.listen_endpoint))
                pc.add_channel(ch, call_mapper=lambda i, sub, req:
                               req + b"%d" % i)
            c = pc.call_method("T.Who", b"r",
                               merger=lambda rs: b"|".join(rs))
            assert not c.failed, c.error_text
            got[package] = c.response
        finally:
            for s in servers:
                s.stop()
    assert got["port"] == got["jax"] == b"a:r0|b:r1"


def test_parallel_channel_branches_run_together():
    """Each branch is a blocking call on its own thread: three 0.3 s
    handlers answer in about 0.3 s, not 0.9."""

    class Slow(Service):
        def Who(self, cntl, request):
            time.sleep(0.3)
            return b"x"

    servers = []
    for _ in range(3):
        s = Server()
        s.add_service(Slow(), name="T")
        assert s.start("127.0.0.1:0") == 0
        servers.append(s)
    try:
        pc = ParallelChannel()
        for s in servers:
            ch = Channel()
            ch.init(str(s.listen_endpoint))
            pc.add_channel(ch)
        cntl = Controller()
        cntl.timeout_ms = 5000
        t0 = time.monotonic()
        c = pc.call_method("T.Who", b"", cntl=cntl)
        assert not c.failed and c.response == [b"x"] * 3
        assert time.monotonic() - t0 < 0.8
    finally:
        for s in servers:
            s.stop()


def test_parallel_channel_all_skipped_and_merger_error():
    s1 = _server("a")
    try:
        pc = ParallelChannel()
        ch = Channel()
        ch.init(str(s1.listen_endpoint))
        pc.add_channel(ch, call_mapper=lambda i, sub, req: SKIP)
        c = pc.call_method("T.Who", b"x")
        assert c.error_code == int(Errno.EPCHANFINISH)
        pc2 = ParallelChannel()
        pc2.add_channel(ch)

        def bad(rs):
            raise ValueError("no")

        c = pc2.call_method("T.Who", b"x", merger=bad)
        assert c.error_code == int(Errno.EINTERNAL)
        assert "merger raised" in c.error_text
    finally:
        s1.stop()


def test_traced_fan_out_has_one_root_span():
    """A traced fan-out opens one root client span; each branch's client
    span parents to it and each server span to its branch."""
    from brpc_tpu_torch.rpcz import global_span_store
    servers = [_server(w) for w in "ab"]
    try:
        pc = ParallelChannel()
        for s in servers:
            ch = Channel()
            ch.init(str(s.listen_endpoint))
            pc.add_channel(ch)
        trace_id = 0x5EED0C0FFEE
        cntl = Controller()
        cntl.trace_id = trace_id
        cntl.timeout_ms = 5000
        c = pc.call_method("T.Who", b"t", cntl=cntl)
        assert not c.failed, c.error_text
        deadline = time.monotonic() + 5
        spans = []
        while time.monotonic() < deadline:
            spans = global_span_store().by_trace(trace_id)
            if len(spans) >= 5:
                break
            time.sleep(0.02)
        roots = [s for s in spans
                 if s.full_method == "ParallelChannel.T.Who"]
        assert len(roots) == 1
        root = roots[0]
        branches = [s for s in spans if s.full_method == "T.Who"
                    and not s.is_server
                    and s.parent_span_id == root.span_id]
        assert len(branches) == 2
        servers_ = [s for s in spans if s.is_server
                    and s.parent_span_id in {b.span_id for b in branches}]
        assert len(servers_) == 2
    finally:
        for s in servers:
            s.stop()


def test_selective_channel_fails_when_every_sub_fails():
    sc = SelectiveChannel()
    for _ in range(2):
        dead = Channel()
        dead.init("127.0.0.1:1")
        sc.add_channel(dead)
    cntl = Controller()
    cntl.timeout_ms = 2000
    c = sc.call_method("T.Who", b"z", cntl=cntl)
    assert c.failed and c.error_code == int(Errno.EFAILEDSOCKET)
    assert SelectiveChannel().call_method("T.Who", b"").error_code == \
        int(Errno.EINTERNAL)
