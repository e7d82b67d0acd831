"""Trace context across the two packages, and the stitcher, on the CPU.

- cross-wire, both ways: a traced call from the JAX package's Channel into
  the port's Server gives a port server span under the JAX client span's
  trace id, parented to that span's id; a traced call from the port's
  Channel into the JAX package's Server does the same the other way;
- a chain that crosses twice (port client -> JAX server whose handler
  calls the port) keeps one trace id on every hop;
- ``rpcz_stitch``: ``build_tree``, ``annotate_skew``, ``to_chrome_trace``
  and ``render_tree_text`` give the JAX package's answers over the same
  ``describe()`` dicts, and over the dicts of both packages' spans they
  make one tree;
- divergence: the port has no builtin portal yet, so ``collect_trace``
  follows a client span's remote side through its ``fetch=`` hook (here
  the peer's own span store), and a dead peer only truncates the stitch.
"""

import copy

import pytest

from brpc_tpu import rpcz as jrpcz
from brpc_tpu import rpcz_stitch as jstitch
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import Controller as JController
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu_torch import rpcz as trpcz
from brpc_tpu_torch import rpcz_stitch as tstitch
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.server import Server, Service


class PortEcho(Service):
    def Echo(self, cntl, request):
        cntl.annotate("port-handler")
        return bytes(request)


class JaxEcho(JService):
    def Echo(self, cntl, request):
        cntl.annotate("jax-handler")
        return bytes(request)


@pytest.fixture()
def stores():
    trpcz.global_span_store().clear()
    jrpcz.global_span_store().clear()
    yield trpcz.global_span_store(), jrpcz.global_span_store()
    trpcz.global_span_store().clear()
    jrpcz.global_span_store().clear()


def _port_server(service, name="T"):
    srv = Server()
    assert srv.add_service(service, name=name) == 0
    assert srv.start("127.0.0.1:0") == 0
    return srv


def _jax_server(service, name="T"):
    srv = JServer()
    srv.add_service(service, name=name)
    assert srv.start("127.0.0.1:0") == 0
    return srv


def _one(spans, server):
    (s,) = [s for s in spans if s.is_server == server]
    return s


def test_jax_client_to_port_server(stores):
    tstore, jstore = stores
    srv = _port_server(PortEcho())
    try:
        ch = JChannel()
        ch.init(str(srv.listen_endpoint))
        cntl = JController()
        cntl.timeout_ms = 10_000
        cntl.trace_id = 0x1A2B3C
        c = ch.call_method("T.Echo", b"ping", cntl=cntl)
        assert not c.failed, c.error_text
    finally:
        srv.stop()
    client = _one(jstore.by_trace(0x1A2B3C), server=False)
    server = _one(tstore.by_trace(0x1A2B3C), server=True)
    assert server.trace_id == client.trace_id == 0x1A2B3C
    assert server.parent_span_id == client.span_id
    assert server.full_method == client.full_method == "T.Echo"
    assert [t for _, t in server.annotations] == ["port-handler"]
    assert tstore.by_trace(0x1A2B3C) == [server]     # no port client span


def test_port_client_to_jax_server(stores):
    tstore, jstore = stores
    srv = _jax_server(JaxEcho())
    try:
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        cntl = Controller()
        cntl.timeout_ms = 10_000
        cntl.trace_id = 0x4D5E6F
        c = ch.call_method("T.Echo", b"ping", cntl=cntl)
        assert not c.failed, c.error_text
        ch.close()
    finally:
        srv.stop()
    client = _one(tstore.by_trace(0x4D5E6F), server=False)
    server = _one(jstore.by_trace(0x4D5E6F), server=True)
    assert server.trace_id == client.trace_id == 0x4D5E6F
    assert server.parent_span_id == client.span_id == cntl.span_id
    assert [t for _, t in server.annotations] == ["jax-handler"]
    assert client.remote_side == str(srv.listen_endpoint)


class JaxRelay(JService):
    """A JAX handler that calls on into the port under its own span."""

    def __init__(self, port_ep):
        self.port_ep = port_ep

    def Echo(self, cntl, request):
        ch = JChannel()
        ch.init(str(self.port_ep))
        sub = JController()
        sub.timeout_ms = 10_000
        sub.trace_id, sub.span_id = cntl.span.trace_id, cntl.span.span_id
        c = ch.call_method("T.Echo", bytes(request), cntl=sub)
        if c.failed:
            cntl.set_failed(c.error_code, c.error_text)
            return None
        return c.response


def _chain(trace_id):
    """port client -> JAX server -> port server; the describe() dicts of
    every span of the trace, with their source."""
    leaf = _port_server(PortEcho())
    mid = _jax_server(JaxRelay(leaf.listen_endpoint))
    try:
        ch = Channel()
        ch.init(str(mid.listen_endpoint))
        cntl = Controller()
        cntl.timeout_ms = 20_000
        cntl.trace_id = trace_id
        c = ch.call_method("T.Echo", b"relay", cntl=cntl)
        assert not c.failed, c.error_text
        assert c.response == b"relay"
        ch.close()
    finally:
        mid.stop()
        leaf.stop()
    port = [dict(s.describe(), source="port")
            for s in trpcz.global_span_store().by_trace(trace_id)]
    jax = [dict(s.describe(), source="jax")
           for s in jrpcz.global_span_store().by_trace(trace_id)]
    return port, jax


def test_chain_across_both_packages_is_one_tree(stores):
    port, jax = _chain(0x7E57)
    assert sorted(s["side"] for s in port) == ["client", "server"]
    assert sorted(s["side"] for s in jax) == ["client", "server"]
    spans = port + jax
    assert {s["trace_id"] for s in spans} == {"7e57"}
    roots = tstitch.build_tree(copy.deepcopy(spans))
    assert roots == jstitch.build_tree(copy.deepcopy(spans))
    (root,) = roots
    by_id = {s["span_id"]: s for s in spans}

    def walk(node, depth=0):
        s = by_id[node["span_id"]]
        out = [(depth, s["side"], s["source"])]
        for kid in node["children"]:
            out += walk(kid, depth + 1)
        return out

    assert walk(root) == [(0, "client", "port"), (1, "server", "jax"),
                          (2, "client", "jax"), (3, "server", "port")]


def _render_inputs(spans):
    return copy.deepcopy(spans), copy.deepcopy(spans)


def test_stitch_views_match_jax(stores):
    port, jax = _chain(0x7E58)
    spans = sorted(port + jax, key=lambda s: s["received_us"])
    a, b = _render_inputs(spans)
    tstitch.annotate_skew(a)
    jstitch.annotate_skew(b)
    assert a == b
    assert tstitch.to_chrome_trace(a) == jstitch.to_chrome_trace(b)
    assert tstitch.render_tree_text(a) == jstitch.render_tree_text(b)
    text = tstitch.render_tree_text(a)
    assert text.startswith("4 span(s)\n") and "[jax]" in text \
        and "[port]" in text


def test_clock_skew_annotation_matches_jax():
    spans = [
        {"span_id": 1, "parent_span_id": 0, "received_us": 1000,
         "side": "client"},
        {"span_id": 2, "parent_span_id": 1, "received_us": 400,
         "side": "server"},
        {"span_id": 3, "parent_span_id": 1, "received_us": 1500,
         "side": "server"},
    ]
    a, b = _render_inputs(spans)
    tstitch.annotate_skew(a)
    jstitch.annotate_skew(b)
    assert a == b and a[1]["clock_skew_us"] == 600
    assert "clock_skew_us" not in a[2]
    roots = tstitch.build_tree(a)
    assert len(roots) == 1 and len(roots[0]["children"]) == 2


def test_collect_trace_follows_the_fetch_hook(stores):
    """Divergence: ``fetch_remote_spans`` GETs a peer portal's /rpcz, and
    the port serves no portal yet, so a stitch between processes waits
    for it.  Through ``fetch=`` the walk is the JAX package's: the local
    client span's remote side is fetched once, and its spans join the
    tree under the client span."""
    tstore, jstore = stores
    srv = _jax_server(JaxEcho())
    try:
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        cntl = Controller()
        cntl.timeout_ms = 10_000
        cntl.trace_id = 0x5717C4
        assert not ch.call_method("T.Echo", b"x", cntl=cntl).failed
        ch.close()
    finally:
        srv.stop()
    asked = []

    def fetch(remote, trace_id, timeout_s, limit):
        asked.append((remote, trace_id))
        return [s.describe() for s in jstore.by_trace(trace_id, limit)]

    out = tstitch.collect_trace(0x5717C4, fetch=fetch)
    assert asked == [(str(srv.listen_endpoint), 0x5717C4)]
    assert out["remotes"] == {str(srv.listen_endpoint): "ok"}
    assert not out["truncated"]
    assert [(s["side"], s["source"]) for s in out["spans"]] == \
        [("client", "local"), ("server", str(srv.listen_endpoint))]
    (root,) = tstitch.build_tree(out["spans"])
    assert len(root["children"]) == 1


def test_collect_trace_dead_peer_truncates(stores):
    tstore, _ = stores
    for i in range(4):
        s = trpcz.start_client_span("T.Echo", 0xB0D6E7)
        s.remote_side = f"10.255.0.{i}:1"
        s.finish()

    def dead(remote, trace_id, timeout_s, limit):
        assert timeout_s <= 0.25 + 1e-6
        raise ConnectionError("blackholed")

    out = tstitch.collect_trace(0xB0D6E7, timeout_s=2.0, budget_s=0.25,
                                fetch=dead)
    assert len(out["spans"]) == 4
    assert all(v.startswith("ConnectionError") for v in
               out["remotes"].values())
