"""The port's overload plane held against the JAX package's, on the CPU
(after ``tests/test_overload_plane.py``'s classic-lane cases): each
admission verdict (server cap, method cap, CoDel, tenant quota) on the
port's server, seen from the port's client and a JAX client, answered
``ELIMIT`` before the handler runs; ``overload_admission_total`` equal
between the packages for the same request sequence; the counters' closed
enum, the tenant table's bound, the server-wide limiter spec and the
``"*"`` method spec."""

import pytest

from brpc_tpu.butil import flags as jflags
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import ChannelOptions as JChannelOptions
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import ServerOptions as JServerOptions
from brpc_tpu.server import Service as JService
from brpc_tpu.server import admission as jadm
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, ChannelOptions
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.server import admission as tadm
from brpc_tpu_torch.server.server import ServerOptions

from torch_overload_cases import HoldSvc, connect, frame, read_frames, \
    wait_for

ELIMIT = int(Errno.ELIMIT)


class JHoldSvc(HoldSvc, JService):
    pass


def _server(package="port", **opt_kv):
    if package == "port":
        opts, srv_cls, svc = ServerOptions(), Server, HoldSvc()
    else:
        opts, srv_cls, svc = JServerOptions(), JServer, JHoldSvc()
    for k, v in opt_kv.items():
        setattr(opts, k, v)
    srv = srv_cls(opts)
    assert srv.add_service(svc, name="OV") == 0
    assert srv.start("127.0.0.1:0") == 0
    return srv, svc


def _hold(srv, svc, n=1, tenant=b""):
    """Occupy ``n`` admission slots with ``Hold`` calls, each on a raw
    connection of its own (the port answers a connection in order);
    returns the sockets (keep them open)."""
    base = svc.holding
    socks = []
    for i in range(n):
        c = connect(srv.listen_endpoint)
        c.sendall(frame(b"OV", 900 + i, b"Hold", tenant=tenant))
        socks.append(c)
    wait_for(lambda: svc.holding >= base + n, what="the held calls")
    return socks


def _unhold(svc, socks):
    svc.release.set()
    for i, c in enumerate(socks):
        read_frames(c, 1)
        c.close()
    wait_for(lambda: svc.holding == 0, what="the held calls' end")
    svc.release.clear()


def _call(client, srv, payload=b"probe", tenant=""):
    """One Echo from ``client`` ("port" or "jax"): (error code, text)."""
    if client == "port":
        co, ch_cls = ChannelOptions(), Channel
    else:
        co, ch_cls = JChannelOptions(), JChannel
    co.tenant = tenant
    co.max_retry = 0
    ch = ch_cls(co)
    assert ch.init(str(srv.listen_endpoint)) == 0
    c = ch.call_method("OV.Echo", payload)
    out = (c.error_code, c.error_text)
    if client == "port":
        ch.close()
    return out


def _delta(mod, before, tenant, verdict):
    after = mod.admission_counters()
    return after.get((tenant, verdict), 0) - before.get((tenant, verdict), 0)


@pytest.fixture()
def codel_flags():
    saved = [(f, [f.get_flag(n) for n in _CODEL]) for f in (tflags, jflags)]
    for f, _ in saved:
        f.set_flag("enable_codel_shed", True)
        f.set_flag("overload_codel_target_ms", 0)
        f.set_flag("overload_codel_interval_ms", 0)
    yield
    for f, vals in saved:
        for n, v in zip(_CODEL, vals):
            f.set_flag(n, v)


_CODEL = ("enable_codel_shed", "overload_codel_target_ms",
          "overload_codel_interval_ms")


# -- each verdict, from both clients --------------------------------------------

def test_server_cap_seen_from_both_clients():
    srv, svc = _server(max_concurrency=1)
    try:
        before = tadm.admission_counters()
        socks = _hold(srv, svc)
        for client in ("port", "jax"):
            code, text = _call(client, srv)
            assert (code, text) == (ELIMIT, "server max_concurrency")
        assert svc.echo_calls == []
        assert _delta(tadm, before, "-", tadm.SERVER_CAP) == 2
        _unhold(svc, socks)
        assert _call("port", srv) == (0, "")
        assert srv.inflight == 0
    finally:
        srv.stop()


def test_method_cap_seen_from_both_clients():
    srv, svc = _server(method_max_concurrency={"OV.Echo": 1})
    try:
        st = srv.find_method("OV", "Echo").status
        st._inflight = 1                    # saturated, as the JAX test does
        before = tadm.admission_counters()
        for client in ("port", "jax"):
            code, text = _call(client, srv)
            assert code == ELIMIT
            assert text == "method max_concurrency (OV.Echo at 1)"
        assert svc.echo_calls == []
        assert _delta(tadm, before, "-", tadm.METHOD_CAP) == 2
        st._inflight = 0
        assert _call("jax", srv) == (0, "")
        assert srv.inflight == 0 and st.inflight == 0
    finally:
        srv.stop()


def test_codel_seen_from_both_clients(codel_flags):
    """Degenerate target and interval of 0: the first above-target request
    arms the interval, the next ones head-drop (the control law spaces
    them by interval/sqrt(n) = 0)."""
    srv, svc = _server()
    try:
        before = tadm.admission_counters()
        with connect(srv.listen_endpoint) as c:
            c.sendall(frame(b"OV", 70, b"Echo", b"one"))
            read_frames(c, 1)
        for client in ("port", "jax"):
            code, text = _call(client, srv, b"two")
            assert code == ELIMIT
            assert "codel queue delay over target" in text
        assert b"two" not in svc.echo_calls
        assert _delta(tadm, before, "-", tadm.CODEL) == 2
        assert srv.admission.codel_state()["OV.Echo"]["drops"] == 2
    finally:
        srv.stop()
    tflags.set_flag("enable_codel_shed", False)
    srv, svc = _server()
    try:
        assert _call("port", srv) == (0, "")
    finally:
        srv.stop()


def test_tenant_quota_seen_from_both_clients():
    srv, svc = _server(tenant_fair_capacity=2)
    try:
        before = tadm.admission_counters()
        socks = _hold(srv, svc, n=2, tenant=b"hot")
        assert tadm.tenant_inflight_snapshot().get("hot") == 2
        # hot holds the whole capacity and the pool is contended
        for client in ("port", "jax"):
            code, text = _call(client, srv, tenant="hot")
            assert (code, text) == (ELIMIT, "tenant hot quota exceeded")
        assert _delta(tadm, before, "hot", tadm.TENANT_QUOTA) == 2
        # the victim's guaranteed share still admits
        for client in ("port", "jax"):
            assert _call(client, srv, tenant="victim") == (0, "")
        assert _delta(tadm, before, "victim", tadm.ADMITTED) == 2
        _unhold(svc, socks)
        wait_for(lambda: not tadm.tenant_inflight_snapshot().get("hot"),
                 what="the tenant slots' release")
    finally:
        srv.stop()


def test_tenant_quota_respects_fair_admission_flag():
    srv, svc = _server(tenant_fair_capacity=2)
    prev = tflags.get_flag("enable_fair_admission")
    tflags.set_flag("enable_fair_admission", False)
    try:
        socks = _hold(srv, svc, n=2, tenant=b"hot")
        assert _call("jax", srv, tenant="hot") == (0, "")
        _unhold(svc, socks)
    finally:
        tflags.set_flag("enable_fair_admission", prev)
        srv.stop()


# -- the counters: equal between the packages ------------------------------------

def _sequence(package):
    """One request sequence against ``package``'s server, from the
    port's client: held hot calls, quota and cap rejections, admitted
    victims.  Returns the admission counters' deltas."""
    srv, svc = _server(package, tenant_fair_capacity=2,
                       method_max_concurrency={"OV.Sleep": 1})
    mod = tadm if package == "port" else jadm
    try:
        before = mod.admission_counters()
        socks = _hold(srv, svc, n=2, tenant=b"hot")
        _call("port", srv, tenant="hot")
        _call("port", srv, tenant="victim")
        _call("jax", srv, tenant="hot")
        _call("jax", srv)
        _unhold(svc, socks)
        st = srv.find_method("OV", "Sleep").status
        st._inflight = 1
        for tenant in ("", "victim", "hot"):
            co = ChannelOptions()
            co.tenant, co.max_retry = tenant, 0
            ch = Channel(co)
            ch.init(str(srv.listen_endpoint))
            assert ch.call_method("OV.Sleep", b"0").error_code == ELIMIT
            ch.close()
        st._inflight = 0
        after = mod.admission_counters()
        return {k: after.get(k, 0) - before.get(k, 0) for k in after
                if after.get(k, 0) != before.get(k, 0)}
    finally:
        srv.stop()


def test_admission_counters_equal_between_packages():
    mine, theirs = _sequence("port"), _sequence("jax")
    assert mine == theirs
    assert mine[("hot", "tenant_quota")] == 2
    assert mine[("hot", "method_cap")] == 1
    for _, verdict in tadm.admission_counters():
        assert verdict in tadm.VERDICTS


def test_counters_closed_enum_and_inflight_drain():
    srv, svc = _server(tenant_fair_capacity=2)
    try:
        socks = _hold(srv, svc, n=2, tenant=b"hot")
        assert _call("port", srv, tenant="hot")[0] == ELIMIT
        assert tadm.tenant_inflight_snapshot().get("hot") == 2
        _unhold(svc, socks)
        wait_for(lambda: not tadm.tenant_inflight_snapshot().get("hot"),
                 what="the tenant slots' release")
        assert srv.inflight == 0
    finally:
        srv.stop()
    assert tadm.VERDICTS == jadm.VERDICTS
    for (_, verdict) in tadm.admission_counters():
        assert verdict in tadm.VERDICTS


def test_tenant_cardinality_bounded():
    srv, svc = _server()
    try:
        ctl = srv.admission
        entry = srv.find_method("OV", "Echo")
        for i in range(tadm._MAX_TENANTS + 64):
            t = f"rnd-{i}"
            assert ctl.admit(entry, "tpu_std", t, None) is None
            srv.on_request_out(tenant=t)
            entry.status.on_responded(0, 1)
        assert len(ctl._tenant_inflight) <= tadm._MAX_TENANTS + 1
        assert ctl._tenant_inflight[tadm.TENANT_OVERFLOW] == 0
        assert srv.inflight == 0
        before_rows = len(tadm.admission_counters())
        srv.options.max_concurrency = 1
        with srv._inflight_lock:
            srv._inflight = 1
        try:
            for i in range(128):
                rej = ctl.admit(entry, "tpu_std", f"flood-{i}", None)
                assert rej is not None and rej.reason == tadm.SERVER_CAP
        finally:
            with srv._inflight_lock:
                srv._inflight = 0
            srv.options.max_concurrency = 0
        assert len(tadm.admission_counters()) - before_rows <= 1
    finally:
        srv.stop()


def test_normalize_tenant_and_trivial_shape_match_jax(codel_flags):
    for raw in (None, b"", "  ", b"team-a", "team-a", memoryview(b"k"),
                "x" * 100, b"\xff\xfe"):
        assert tadm.normalize_tenant(raw) == jadm.normalize_tenant(raw)
    shapes = []
    for package, mod, flags in (("port", tadm, tflags),
                                ("jax", jadm, jflags)):
        srv, svc = _server(package)
        try:
            st = srv.find_method("OV", "Echo").status
            row = [mod.trivial_shape(srv, st)]      # CoDel on
            flags.set_flag("enable_codel_shed", False)
            row.append(mod.trivial_shape(srv, st))
            st.max_concurrency = 3
            row.append(mod.trivial_shape(srv, st))
            st.max_concurrency = 0
            srv.options.tenant_fair_capacity = 2
            row.append(mod.trivial_shape(srv, st))
            shapes.append(row)
        finally:
            srv.stop()
    assert shapes[0] == shapes[1] == [False, True, False, False]


def test_server_wide_adaptive_limiter_spec():
    srv, svc = _server(max_concurrency="timeout:50")
    try:
        lim = srv.server_limiter()
        assert lim is not None and lim.kind == "timeout"
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        for _ in range(30):
            assert ch.call("OV.Echo", b"x") == b"ok:x"
        assert lim.max_concurrency() >= 1 and lim._lat_ema is not None
        ch.close()
    finally:
        srv.stop()


def test_default_method_spec_star():
    srv, svc = _server(method_max_concurrency={"*": "auto", "OV.Hold": 7})
    try:
        assert srv.find_method("OV", "Echo").status.limiter_kind() == "auto"
        hold = srv.find_method("OV", "Hold").status
        assert hold.limiter_kind() == "constant"
        assert hold.live_max_concurrency() == 7
    finally:
        srv.stop()
    from brpc_tpu_torch.policy import AutoLimiter
    bad = Server(ServerOptions())
    bad.options.method_max_concurrency = {"*": AutoLimiter()}
    assert bad.add_service(HoldSvc(), name="OV") == -1


def test_rejection_runs_no_user_code_and_keeps_the_connection():
    """A rejected request leaves its connection serving: the next request
    on it is admitted once the cap clears (raw frames, one connection)."""
    srv, svc = _server(method_max_concurrency={"OV.Echo": 1})
    try:
        st = srv.find_method("OV", "Echo").status
        with connect(srv.listen_endpoint) as c:
            st._inflight = 1
            c.sendall(frame(b"OV", 1, b"Echo", b"no"))
            assert read_frames(c, 1)[1].error_code == ELIMIT
            st._inflight = 0
            c.sendall(frame(b"OV", 2, b"Echo", b"yes"))
            assert read_frames(c, 1)[2].error_code == 0
        assert svc.echo_calls == [b"yes"]
        # a rejection is answered before a span or a status settle exists
        assert srv.method_status("OV.Echo").errors.get_value() == 0
    finally:
        srv.stop()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_elimit_not_retried_without_a_load_balancer(client):
    """The fail-fast codes are retried only where a load balancer can
    pick another replica: on a single-server channel, ``ELIMIT`` ends the
    call at once in both packages (``default_retry_policy``)."""
    from brpc_tpu.client.controller import \
        default_retry_policy as jpolicy
    from brpc_tpu_torch.client.controller import \
        default_retry_policy as tpolicy
    srv, svc = _server(method_max_concurrency={"OV.Echo": 1})
    try:
        srv.find_method("OV", "Echo").status._inflight = 1
        co, ch_cls = (ChannelOptions(), Channel) if client == "port" \
            else (JChannelOptions(), JChannel)
        co.max_retry = 3
        ch = ch_cls(co)
        ch.init(str(srv.listen_endpoint))
        c = ch.call_method("OV.Echo", b"x")
        assert (c.error_code, c.retried_count) == (ELIMIT, 0)
        for code in (ELIMIT, int(Errno.ELAMEDUCK), int(Errno.EFAILEDSOCKET),
                     int(Errno.EEOF), int(Errno.ELOGOFF),
                     int(Errno.ERPCTIMEDOUT)):
            assert tpolicy(c, code) == jpolicy(c, code)
        srv.find_method("OV", "Echo").status._inflight = 0
    finally:
        srv.stop()
