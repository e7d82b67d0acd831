"""The port's cluster client held against the JAX package's, on the CPU
over loopback: ``tests/test_cluster_client.py``'s cases (naming, the
balancers, the breaker, a cluster channel losing a server) and the
balancer cases of ``tests/test_cluster_hardening.py`` (cluster recover,
``WeightTree``, ``la``, ``dynpart``) run on the port; the deterministic
balancers pick the same servers as the JAX package's for the same node
lists, request codes and exclusions; a port cluster channel calls JAX
servers and a JAX cluster channel calls port servers; with a balancer
``ELIMIT`` and ``ELAMEDUCK`` are retried at once on the other replica;
and the port's two divergences (a backup hedges on another replica, a
superseded attempt feeds the breaker) hold."""

import collections
import threading
import time

import pytest

from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import ChannelOptions as JChannelOptions
from brpc_tpu.client import Controller as JController
from brpc_tpu.client.load_balancer import create_load_balancer as jcreate_lb
from brpc_tpu.client.naming_service import parse_server_line as jparse
from brpc_tpu.policy import load_balancers as jlbs
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu_torch import fleet
from brpc_tpu_torch.butil.endpoint import EndPoint, parse_endpoint
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
from brpc_tpu_torch.client.circuit_breaker import (CircuitBreakerMap,
                                                   global_circuit_breaker_map)
from brpc_tpu_torch.client.load_balancer import create_load_balancer
from brpc_tpu_torch.client.naming_service import (ServerNode,
                                                  create_naming_service,
                                                  global_lame_ducks,
                                                  parse_server_line)
from brpc_tpu_torch.policy import load_balancers  # noqa: F401 (registers)
from brpc_tpu_torch.policy import naming          # noqa: F401 (registers)
from brpc_tpu_torch.policy.load_balancers import (LocalityAwareLB,
                                                  RoundRobinLB, WeightTree)
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.server.service import Service


@pytest.fixture(autouse=True)
def _clean_breakers():
    global_circuit_breaker_map().reset()
    global_lame_ducks().reset()
    yield
    global_circuit_breaker_map().reset()
    global_lame_ducks().reset()


class _Cntl:
    """Minimal selection context."""
    request_code = 0
    excluded_servers = ()
    remote_side = None
    error_code = 0
    latency_us = 1000


def _nodes(*specs):
    return [parse_server_line(s) for s in specs]


def _node(port, tag=""):
    return ServerNode(endpoint=EndPoint(host="10.0.0.1", port=port), tag=tag)


# -- tests/test_cluster_client.py ------------------------------------------

def test_parse_server_line():
    n = parse_server_line("10.0.0.1:80 1/4 w=3")
    assert n.endpoint == EndPoint(host="10.0.0.1", port=80)
    assert n.tag == "1/4 w=3"
    assert parse_server_line("# comment") is None
    assert parse_server_line("") is None
    for line in ("10.0.0.1:80 1/4 w=3", "[::1]:9 x", "h:1", "bad:port"):
        mine, theirs = parse_server_line(line), jparse(line)
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert (str(mine), mine.tag) == (str(theirs), theirs.tag)


def test_list_naming_service():
    ns = create_naming_service("list://1.1.1.1:10,2.2.2.2:20 tagx")
    assert ns is not None
    eps = ns.current
    assert len(eps) == 2
    assert eps[1].tag == "tagx"
    ns.stop()
    assert create_naming_service("list://") is None
    assert create_naming_service("nope://x") is None


def test_file_naming_service_reload(tmp_path):
    p = tmp_path / "servers"
    p.write_text("1.1.1.1:10\n# comment\n2.2.2.2:20\n")
    ns = create_naming_service(f"file://{p}")
    assert ns is not None
    ns.refresh_interval_s = 0.05
    assert len(ns.current) == 2
    p.write_text("1.1.1.1:10\n")
    deadline = time.time() + 3.0
    while time.time() < deadline and len(ns.current) != 1:
        ns.run_once()
        time.sleep(0.02)
    assert len(ns.current) == 1
    ns.stop()


def test_mesh_naming_service(tmp_path):
    """``mesh://`` over a transport the caller made on the CPU (a gloo
    group at world size one): one rank, tagged ``0/1``."""
    import torch.distributed as dist

    from brpc_tpu_torch.parallel import mesh_transport
    from brpc_tpu_torch.parallel.spmd import init_world
    init_world(0, 1, "cpu", str(tmp_path / "rendezvous"))
    try:
        mt = mesh_transport.global_mesh_transport(device="cpu")
        assert mt.device.type == "cpu"
        ns = create_naming_service("mesh://testmesh")
        assert ns is not None
        nodes = ns.current
        assert len(nodes) == 1
        assert nodes[0].endpoint.is_device
        assert str(nodes[0].endpoint) == "ici://testmesh/0"
        assert nodes[0].tag == "0/1"
        ns.stop()
    finally:
        mesh_transport._default_transport = None
        dist.destroy_process_group()


def test_mesh_naming_makes_no_cpu_transport_of_its_own(monkeypatch):
    """Without a transport the caller made, the scheme asks for the
    default (cuda) one: here, with no card, it fails to start, and no
    transport is left behind."""
    from brpc_tpu_torch.parallel import mesh_transport
    monkeypatch.setattr(mesh_transport, "_default_transport", None)
    assert create_naming_service("mesh://m") is None
    assert mesh_transport._default_transport is None


def test_rr_cycles():
    lb = create_load_balancer("rr")
    lb.reset_servers(_nodes("1.1.1.1:1", "1.1.1.1:2", "1.1.1.1:3"))
    picks = [str(lb.select_server(_Cntl())) for _ in range(6)]
    assert picks[:3] == picks[3:]
    assert len(set(picks)) == 3


def test_wrr_respects_weights():
    lb = create_load_balancer("wrr")
    lb.reset_servers(_nodes("1.1.1.1:1 w=3", "1.1.1.1:2 w=1"))
    counts = collections.Counter(
        lb.select_server(_Cntl()).port for _ in range(40))
    assert counts[1] == 30 and counts[2] == 10


def test_consistent_hash_stability():
    lb = create_load_balancer("c_murmurhash")
    lb.reset_servers(_nodes("1.1.1.1:1", "1.1.1.1:2", "1.1.1.1:3",
                            "1.1.1.1:4"))
    mapping = {}
    for code in range(200):
        c = _Cntl()
        c.request_code = code
        mapping[code] = lb.select_server(c).port
    for code in range(200):
        c = _Cntl()
        c.request_code = code
        assert lb.select_server(c).port == mapping[code]
    assert len(set(mapping.values())) == 4
    # removing one server only remaps its keys
    lb.reset_servers(_nodes("1.1.1.1:1", "1.1.1.1:2", "1.1.1.1:3"))
    moved = 0
    for code in range(200):
        c = _Cntl()
        c.request_code = code
        new = lb.select_server(c).port
        if mapping[code] != 4 and new != mapping[code]:
            moved += 1
    assert moved < 40


def test_locality_aware_prefers_fast():
    lb = create_load_balancer("la")
    lb.reset_servers([parse_server_line("1.1.1.1:1"),
                      parse_server_line("1.1.1.1:2")])
    picks = collections.Counter()
    for i in range(150):
        node = lb.select_server(_Cntl())
        if i >= 50:
            picks[node.port] += 1
        c = _Cntl()
        c.remote_side = node
        c.latency_us = 1_000 if node.port == 1 else 100_000
        lb.feedback(c)
    assert picks[1] > 80


def test_circuit_breaker_trips_and_recovers():
    m = CircuitBreakerMap()
    ep = parse_endpoint("9.9.9.9:99")
    trips = fleet.event_counters()["fleet_breaker_trip"]
    for _ in range(20):
        m.on_call(ep, 1009, 1000)
    assert m.isolated(ep)
    assert fleet.event_counters()["fleet_breaker_trip"] == trips + 1
    time.sleep(0.15)     # base isolation window passes
    assert not m.isolated(ep)
    # ELIMIT weighs 0.3 and ELAMEDUCK nothing
    calm = parse_endpoint("9.9.9.9:98")
    for _ in range(20):
        m.on_call(calm, int(Errno.ELAMEDUCK), 1000)
    assert not m.isolated(calm)


class EchoWho(Service):
    def __init__(self, who):
        self.who = who

    def Who(self, cntl, request):
        return self.who.encode()


class JEchoWho(EchoWho, JService):
    pass


def _start_server(who, package="port"):
    srv = Server() if package == "port" else JServer()
    svc = EchoWho(who) if package == "port" else JEchoWho(who)
    assert srv.add_service(svc, name="W") == 0
    assert srv.start("127.0.0.1:0") == 0
    return srv


def _who(ch, timeout_ms=2000, cntl_cls=Controller):
    cntl = cntl_cls()
    cntl.timeout_ms = timeout_ms
    return ch.call_method("W.Who", b"", cntl=cntl)


def test_cluster_channel_rr_spread_and_failover():
    s1 = _start_server("a")
    s2 = _start_server("b")
    ch = Channel()
    try:
        url = f"list://{s1.listen_endpoint},{s2.listen_endpoint}"
        assert ch.init(url, "rr") == 0
        seen = set()
        for _ in range(8):
            c = ch.call_method("W.Who", b"")
            assert not c.failed, c.error_text
            seen.add(c.response)
        assert seen == {b"a", b"b"}

        # kill one server: calls keep succeeding via retry+exclusion
        s2.stop()
        ok = 0
        for _ in range(12):
            c = _who(ch)
            if not c.failed:
                ok += 1
                assert c.response == b"a"
                assert c.remote_side == s1.listen_endpoint
        assert ok >= 10
    finally:
        ch.close()
        s1.stop()
        s2.stop()


# -- tests/test_cluster_hardening.py's balancer cases ------------------------

def test_cluster_recover_probes_isolated_servers():
    lb = RoundRobinLB()
    lb.use_circuit_breaker = True
    lb.min_working_instances = 2
    nodes = [_node(9001), _node(9002), _node(9003)]
    lb.reset_servers(nodes)
    breakers = global_circuit_breaker_map()
    for n in nodes[:2]:
        for _ in range(200):
            breakers.on_call(n.endpoint, 1014, 100_000)
    broken = [n for n in nodes if breakers.isolated(n.endpoint)]
    assert len(broken) == 2

    class C:
        excluded_servers = set()
        remote_side = None

    picked = {lb.select_server(C()) for _ in range(60)}
    assert lb.recovering
    assert any(n.endpoint in picked for n in broken)
    for n in nodes:
        nb = breakers._nodes.get(n.endpoint)
        if nb is not None:
            nb.isolated_until = 0.0
    lb.select_server(C())
    assert not lb.recovering


def test_weight_tree_pick_distribution():
    t = WeightTree(4)
    for i, w in enumerate([1.0, 0.0, 3.0, 6.0]):
        t.update(i, w)
    assert t.total() == pytest.approx(10.0)
    counts = [0] * 4
    steps = 1000
    for k in range(steps):
        counts[t.pick((k + 0.5) / steps * 10.0)] += 1
    assert counts[1] == 0
    assert counts[0] == pytest.approx(100, abs=5)
    assert counts[2] == pytest.approx(300, abs=5)
    assert counts[3] == pytest.approx(600, abs=5)
    t.update(3, 0.0)
    assert t.total() == pytest.approx(4.0)
    assert t.pick(3.9) == 2


def test_weight_tree_picks_equal_jax():
    weights = [0.5, 2.0, 0.0, 7.25, 1.0, 3.0, 0.125]
    mine, theirs = WeightTree(len(weights)), jlbs.WeightTree(len(weights))
    for i, w in enumerate(weights):
        mine.update(i, w)
        theirs.update(i, w)
    total = sum(weights)
    rs = [(k + 0.5) / 400 * total for k in range(400)]
    assert [mine.pick(r) for r in rs] == [theirs.pick(r) for r in rs]
    mine.update(3, 1.0)
    theirs.update(3, 1.0)
    assert mine.total() == theirs.total()
    assert [mine.pick(r) for r in rs[:100]] == \
        [theirs.pick(r) for r in rs[:100]]


def test_la_lb_prefers_fast_server():
    lb = LocalityAwareLB()
    nodes = [_node(9101), _node(9102)]
    lb.reset_servers(nodes)

    class C:
        excluded_servers = set()
        remote_side = None
        error_code = 0
        latency_us = 0
        attempt_remotes = {}

    for _ in range(60):
        for n, lat in ((nodes[0], 1_000), (nodes[1], 10_000)):
            lb.select(nodes, C())
            c = C()
            c.remote_side = n.endpoint
            c.latency_us = lat
            c.attempt_remotes = {0: n.endpoint}
            lb.feedback(c)
    picks = [lb.select(nodes, C()).endpoint.port for _ in range(300)]
    assert picks.count(9101) > 200


def test_la_lb_respects_exclusions():
    lb = LocalityAwareLB()
    nodes = [_node(9201), _node(9202)]
    lb.reset_servers(nodes)

    class C:
        excluded_servers = {nodes[0].endpoint}
        remote_side = None

    for _ in range(10):
        assert lb.select_server(C()) == nodes[1].endpoint


def test_dynamic_partition_scheme_weighting():
    from brpc_tpu_torch.client.partition_channel import \
        DynamicPartitionChannel
    dpc = DynamicPartitionChannel()
    dpc._lb_name = "rr"
    nodes = ([_node(9300 + i, tag=f"{i % 2}/2") for i in range(4)]
             + [_node(9400 + i, tag=f"{i}/3") for i in range(3)])
    dpc._on_servers(nodes)
    assert dpc.scheme_weights == {2: 4, 3: 3}
    nodes2 = [_node(9500, tag="0/2")] + [_node(9600 + i, tag=f"{i}/3")
                                         for i in range(3)]
    dpc._on_servers(nodes2)
    assert dpc.scheme_weights == {3: 3}


class Part(Service):
    def __init__(self, label):
        self.label = label

    def Get(self, cntl, request):
        return self.label


def test_dynamic_partition_live_migration():
    """Real servers: start with a 2-partition scheme, migrate to 3."""
    from brpc_tpu_torch.client.partition_channel import \
        DynamicPartitionChannel
    servers = []

    def spawn(label):
        s = Server()
        s.add_service(Part(label), name="P")
        assert s.start("127.0.0.1:0") == 0
        servers.append(s)
        return s

    try:
        two = [spawn(b"2p-%d" % i) for i in range(2)]
        co = ChannelOptions()
        co.timeout_ms = 3000
        dpc = DynamicPartitionChannel(options=co)
        url = "list://" + ",".join(
            f"{s.listen_endpoint} {i}/2" for i, s in enumerate(two))
        assert dpc.init(url, "rr") == 0
        c = dpc.call_method("P.Get", b"")
        assert not c.failed, c.error_text
        assert sorted(c.response) == [b"2p-0", b"2p-1"]
        assert dpc.scheme_weights == {2: 2}
        three = [spawn(b"3p-%d" % i) for i in range(3)]
        nodes = ([ServerNode(endpoint=s.listen_endpoint, tag=f"{i}/2")
                  for i, s in enumerate(two)]
                 + [ServerNode(endpoint=s.listen_endpoint, tag=f"{i}/3")
                    for i, s in enumerate(three)])
        dpc._on_servers(nodes)
        assert dpc.scheme_weights == {2: 2, 3: 3}
        widths = set()
        for _ in range(20):
            c = dpc.call_method("P.Get", b"")
            assert not c.failed, c.error_text
            widths.add(len(c.response))
        assert widths <= {2, 3}
        dpc._on_servers([ServerNode(endpoint=s.listen_endpoint,
                                    tag=f"{i}/3")
                         for i, s in enumerate(three)])
        assert dpc.scheme_weights == {3: 3}
        c = dpc.call_method("P.Get", b"")
        assert not c.failed
        assert sorted(c.response) == [b"3p-0", b"3p-1", b"3p-2"]
        dpc.stop()
    finally:
        for s in servers:
            s.stop()


# -- the same picks as the JAX package -------------------------------------

_PICK_NODES = ("10.0.0.1:7001 w=2", "10.0.0.2:7002", "10.0.0.3:7003 w=3",
               "10.0.0.4:7004 1/4", "[::1]:7005")


@pytest.mark.parametrize("name", ["rr", "wrr", "c_murmurhash", "c_md5"])
def test_pick_sequences_equal_jax(name):
    """The deterministic balancers pick the same servers for the same
    node lists, request codes and exclusions, through a membership
    change."""
    mine, theirs = create_load_balancer(name), jcreate_lb(name)
    seq_m, seq_j = [], []
    for specs in (_PICK_NODES, _PICK_NODES[1:], _PICK_NODES[::-1]):
        mine.reset_servers([parse_server_line(s) for s in specs])
        theirs.reset_servers([jparse(s) for s in specs])
        for code in list(range(40)) + [2 ** 40 + 3, 2 ** 63 - 1]:
            excl = {specs[code % len(specs)].split()[0]} \
                if code % 5 == 4 else set()
            cm, cj = _Cntl(), _Cntl()
            cm.request_code = cj.request_code = code
            cm.excluded_servers = {parse_endpoint(e) for e in excl}
            cj.excluded_servers = {jparse(e).endpoint for e in excl}
            seq_m.append(str(mine.select_server(cm)))
            seq_j.append(str(theirs.select_server(cj)))
    assert seq_m == seq_j
    assert len(set(seq_m)) >= 3


def test_consistent_hash_equal_jax_on_many_codes():
    nodes = [f"10.1.{i // 256}.{i % 256}:{9000 + i}" for i in range(16)]
    for name in ("c_murmurhash", "c_md5"):
        mine, theirs = create_load_balancer(name), jcreate_lb(name)
        mine.reset_servers([parse_server_line(s) for s in nodes])
        theirs.reset_servers([jparse(s) for s in nodes])
        for code in range(0, 5000, 7):
            cm, cj = _Cntl(), _Cntl()
            cm.request_code = cj.request_code = code
            assert str(mine.select_server(cm)) == \
                str(theirs.select_server(cj)), (name, code)


# -- cross-wire ----------------------------------------------------------

def test_port_cluster_channel_over_jax_servers():
    servers = [_start_server(w, "jax") for w in "ab"]
    ch = Channel()
    try:
        assert ch.init("list://" + ",".join(
            str(s.listen_endpoint) for s in servers), "rr") == 0
        got = [_who(ch).response for _ in range(6)]
        assert got == [b"a", b"b"] * 3
        servers[1].stop()
        for _ in range(4):
            c = _who(ch)
            assert not c.failed, c.error_text
            assert c.response == b"a"
    finally:
        ch.close()
        for s in servers:
            s.stop()


def test_jax_cluster_channel_over_port_servers():
    servers = [_start_server(w) for w in "ab"]
    try:
        ch = JChannel()
        assert ch.init("list://" + ",".join(
            str(s.listen_endpoint) for s in servers), "rr") == 0
        got = [bytes(_who(ch, cntl_cls=JController).response)
               for _ in range(6)]
        assert got == [b"a", b"b"] * 3
        # the same request codes land on the same replica through both
        # packages' c_murmurhash channels
        jch, tch = JChannel(), Channel()
        url = "list://" + ",".join(str(s.listen_endpoint) for s in servers)
        assert jch.init(url, "c_murmurhash") == 0
        assert tch.init(url, "c_murmurhash") == 0
        for code in range(12):
            jc, tc = JController(), Controller()
            jc.request_code = tc.request_code = code
            jc.timeout_ms = tc.timeout_ms = 2000
            a = jch.call_method("W.Who", b"", cntl=jc)
            b = tch.call_method("W.Who", b"", cntl=tc)
            assert not a.failed and not b.failed
            assert bytes(a.response) == b.response
        tch.close()
    finally:
        for s in servers:
            s.stop()


# -- fail-fast codes on another replica ------------------------------------

class Refuse(Service):
    """Answers every call with one fail-fast code."""

    def __init__(self, code):
        self.code = code
        self.calls = 0

    def Who(self, cntl, request):
        self.calls += 1
        cntl.set_failed(self.code, "refused")
        return b""


class JRefuse(Refuse, JService):
    pass


@pytest.mark.parametrize("client", ["port", "jax"])
@pytest.mark.parametrize("code", [int(Errno.ELIMIT), int(Errno.ELAMEDUCK)])
def test_fail_fast_retried_on_the_other_replica(client, code):
    """With a balancer an ``ELIMIT`` or ``ELAMEDUCK`` answer is retried
    at once (no backoff) on the other replica, from the port's client as
    from the JAX package's, against port servers."""
    refuse = Refuse(code)
    bad = Server()
    assert bad.add_service(refuse, name="W") == 0
    assert bad.start("127.0.0.1:0") == 0
    good = _start_server("good")
    if client == "port":
        opts, ch, cntl_cls = ChannelOptions(), None, Controller
    else:
        opts, ch, cntl_cls = JChannelOptions(), None, JController
    opts.retry_backoff_ms = 2000        # the fail-fast codes skip it
    ch = Channel(opts) if client == "port" else JChannel(opts)
    try:
        assert ch.init(f"list://{bad.listen_endpoint},"
                       f"{good.listen_endpoint}", "rr") == 0
        for _ in range(4):
            t0 = time.monotonic()
            c = _who(ch, 5000, cntl_cls)
            assert not c.failed, c.error_text
            assert bytes(c.response) == b"good"
            assert time.monotonic() - t0 < 1.0
        assert refuse.calls >= 1
    finally:
        if client == "port":
            ch.close()
        bad.stop()
        good.stop()


def test_fail_fast_not_retried_on_a_single_server():
    refuse = Refuse(int(Errno.ELIMIT))
    srv = Server()
    assert srv.add_service(refuse, name="W") == 0
    assert srv.start("127.0.0.1:0") == 0
    ch = Channel()
    try:
        assert ch.init(str(srv.listen_endpoint)) == 0
        c = _who(ch)
        assert c.error_code == int(Errno.ELIMIT)
        assert c.retried_count == 0 and refuse.calls == 1
    finally:
        ch.close()
        srv.stop()


# -- the port's divergences ------------------------------------------------

class Slow(Service):
    def __init__(self, who, delay_s):
        self.who, self.delay_s = who, delay_s

    def Who(self, cntl, request):
        time.sleep(self.delay_s)
        return self.who.encode()


def _code_for(url_nodes, name, want_port):
    lb = create_load_balancer(name)
    lb.reset_servers([parse_server_line(s) for s in url_nodes])
    for code in range(1000):
        c = _Cntl()
        c.request_code = code
        if lb.select_server(c).port == want_port:
            return code
    raise AssertionError("no request code hashes there")


def test_backup_goes_to_another_replica():
    """A backup request excludes its primary's server: through
    ``c_murmurhash`` a call pinned to a slow replica is answered by the
    other one."""
    slow, fast = Server(), Server()
    assert slow.add_service(Slow("slow", 2.0), name="W") == 0
    assert fast.add_service(Slow("fast", 0.0), name="W") == 0
    assert slow.start("127.0.0.1:0") == 0 and fast.start("127.0.0.1:0") == 0
    nodes = [str(slow.listen_endpoint), str(fast.listen_endpoint)]
    opts = ChannelOptions()
    opts.connection_type = "pooled"
    opts.backup_request_ms = 50
    ch = Channel(opts)
    try:
        assert ch.init("list://" + ",".join(nodes), "c_murmurhash") == 0
        code = _code_for(nodes, "c_murmurhash", slow.listen_endpoint.port)
        cntl = Controller()
        cntl.request_code = code
        cntl.timeout_ms = 5000
        t0 = time.monotonic()
        c = ch.call_method("W.Who", b"", cntl=cntl)
        ms = (time.monotonic() - t0) * 1e3
        assert not c.failed, c.error_text
        assert c.response == b"fast" and c.has_backup_request
        assert c.attempt_remotes[0] == slow.listen_endpoint
        assert c.attempt_remotes[1] == fast.listen_endpoint
        assert c.remote_side == fast.listen_endpoint
        assert ms < 1500            # not the primary's 2 s
    finally:
        ch.close()
        slow.stop()
        fast.stop()


def test_superseded_attempts_feed_the_breaker():
    """``list://A,<dead port>`` with the breaker on: every call succeeds
    through retry and exclusion, the dead port's refused attempts trip
    its breaker (one ``fleet_breaker_trip``), and while it is isolated no
    attempt dials it."""
    srv = _start_server("a")
    dead = "127.0.0.1:1"
    opts = ChannelOptions()
    opts.enable_circuit_breaker = True
    ch = Channel(opts)
    trips = fleet.event_counters()["fleet_breaker_trip"]
    try:
        assert ch.init(f"list://{srv.listen_endpoint},{dead}", "rr") == 0
        dead_ep = parse_endpoint(dead)
        breakers = global_circuit_breaker_map()
        n = 0
        while not breakers.isolated(dead_ep):
            c = _who(ch)
            assert not c.failed, c.error_text
            n += 1
            assert n < 40, "the dead port never tripped"
        assert fleet.event_counters()["fleet_breaker_trip"] == trips + 1
        dialed = 0
        while breakers.isolated(dead_ep):
            c = _who(ch)
            assert not c.failed
            if dead_ep in c.attempt_remotes.values():
                dialed += breakers.isolated(dead_ep)
        assert dialed == 0
    finally:
        ch.close()
        srv.stop()


def test_lame_duck_answer_marks_and_clean_answer_clears():
    """A draining replica's answer carries the lame-duck TLV: the
    registry marks it and the balancer skips it, with no breaker
    penalty."""
    a, b = _start_server("a"), _start_server("b")
    ch = Channel()
    try:
        assert ch.init(f"list://{a.listen_endpoint},{b.listen_endpoint}",
                       "rr") == 0
        # the lame-duck signal reaches connected clients: a draining
        # server accepts no new connection (it waits in the backlog)
        assert sorted(_who(ch).response for _ in range(2)) == [b"a", b"b"]
        ducks = global_lame_ducks()
        drained = threading.Thread(target=a.drain, args=(3000,))
        drained.start()
        deadline = time.monotonic() + 5
        while not a.draining and time.monotonic() < deadline:
            time.sleep(0.01)
        for _ in range(6):
            c = _who(ch)
            assert not c.failed, c.error_text
            assert c.response == b"b" or c.retried_count == 1
        assert ducks.is_lame(a.listen_endpoint)
        assert not global_circuit_breaker_map().isolated(a.listen_endpoint)
        drained.join(10)
        ducks.clear(a.listen_endpoint)
        assert not ducks.is_lame(a.listen_endpoint)
    finally:
        ch.close()
        a.stop()
        b.stop()


def test_no_server_available(tmp_path):
    p = tmp_path / "empty"
    p.write_text("")
    ch = Channel()
    assert ch.init(f"file://{p}", "rr") == 0
    c = _who(ch)
    assert c.error_code == int(Errno.EINTERNAL)
    assert c.error_text == "no server available"
    ch.close()
    assert Channel().init("list://1.1.1.1:1", "no_such_lb") == -1
    assert Channel().init("nope://x", "rr") == -1
