"""Sanitizer stress driver for the port's native engine, the stress of
``tests/asan_driver.py`` against ``brpc_tpu_torch`` — runs inside a
subprocess with the ASAN/UBSAN-instrumented engine
(``BRPC_TPU_TORCH_NATIVE_ASAN=1`` + libasan LD_PRELOADed; see
tests/test_torch_sanitized_native.py, which owns the build and the
report scraping).  The port's controllers hold attachments as bytes
(ROADMAP C9), so the echo handler assigns where the JAX one appends.

Drives every native memory-discipline surface the sanitizers can see:

1. **burst dispatch** — pipelined tpu_std frames blasted down one raw
   socket so the engine batches them into multi-item flush_py_batch
   bursts (kind-3 slim shims, native response coalescing, writev);
2. **HTTP slim bursts** — pipelined keep-alive HTTP/1.1 on the same
   port (kind-4 parse + native serialization), plus ineligible shapes
   (bad header framing) for the fallback paths;
3. **client demux** — a lane-attached "single" connection completing
   plain successes natively, interleaved with error responses and
   attachments that fall back byte-identically;
4. **scatter** — ParallelChannel fan-out over native sub-servers
   (thread-pinned scatter_call path);
5. **shm slot lifecycle** — ≥256KB same-host attachments cycling ring
   slots (describe → echo re-describe → finalizer settle → sweep),
   skipped where the host has no mmap-able shm;
6. **multi-core engine** — a 4-loop server (SO_REUSEPORT sharded
   accept where available) driven CONCURRENTLY by pipelined slim
   bursts on per-loop connections, ParallelChannel scatter fan-out and
   shm slot cycles, so the lock-free cross-loop handoff, the sharded
   slot allocator and the per-loop telemetry all run under ASan/UBSan
   with real thread interleaving;
7. **drain under load** — a fresh native server drained
   MID-BURST: set_lame_duck flips while pipelined slim frames are in
   flight (listener epoll disarm, lame-duck TLV append on natively
   built responses, kind-4 declines), then stop() tears the engine
   down with the late rejections still settling.

Prints ``ASAN_DRIVER_OK`` and exits 0 on success; any sanitizer report
goes to stderr and (for UBSAN, built no-recover) aborts the process.
"""

import struct
import sys
import threading
import time


def wire_tlv(tag, data):
    return bytes([tag]) + struct.pack("<I", len(data)) + data


def frame(cid, payload, svc=b"A", mth=b"Echo"):
    meta = (wire_tlv(1, struct.pack("<Q", cid)) + wire_tlv(4, svc)
            + wire_tlv(5, mth))
    return (b"TRPC" + struct.pack("<II", len(meta) + len(payload),
                                  len(meta)) + meta + payload)


def main():
    from brpc_tpu_torch.butil.iobuf import IOBuf
    from brpc_tpu_torch.client import (Channel, ChannelOptions,
                                       Controller, ParallelChannel)
    from brpc_tpu_torch.server import Server, ServerOptions, Service
    from brpc_tpu_torch.native import available

    assert available(), "sanitized native engine failed to build/load"

    class Svc(Service):
        def Echo(self, cntl, request):
            cntl.response_attachment = bytes(cntl.request_attachment)
            return request

        def Err(self, cntl, request):
            cntl.set_failed(1234, "boom")
            return b""

    def mk_server():
        opts = ServerOptions()
        opts.native = True
        opts.usercode_inline = True
        srv = Server(opts)
        srv.add_service(Svc(), name="A")
        assert srv.start("127.0.0.1:0") == 0
        return srv

    servers = [mk_server() for _ in range(3)]
    srv = servers[0]
    port = srv.listen_endpoint.port

    # ---- 1. pipelined burst dispatch (kind-3 slim lane) ----
    import socket as pysock
    for _round in range(4):
        s = pysock.create_connection(("127.0.0.1", port), timeout=10)
        blast = b"".join(frame(i + 1, b"x" * (17 * (i % 53)))
                         for i in range(200))
        s.sendall(blast)
        got = bytearray()
        want = 200
        seen = 0
        while seen < want:
            chunk = s.recv(65536)
            if not chunk:
                break
            got += chunk
            # count complete response frames
            seen = 0
            off = 0
            while off + 12 <= len(got):
                if got[off:off + 4] != b"TRPC":
                    raise AssertionError("bad magic in response burst")
                (blen,) = struct.unpack_from("<I", got, off + 4)
                if off + 12 + blen > len(got):
                    break
                off += 12 + blen
                seen += 1
        assert seen == want, f"burst round: {seen}/{want} responses"
        s.close()

    # ---- 2. pipelined HTTP slim bursts + ineligible shapes ----
    s = pysock.create_connection(("127.0.0.1", port), timeout=10)
    req = (b"POST /A/Echo HTTP/1.1\r\nHost: x\r\nContent-Length: 3\r\n"
           b"Connection: keep-alive\r\n\r\nabc")
    s.sendall(req * 64)
    deadline = time.time() + 10
    body = bytearray()
    while body.count(b"HTTP/1.1 200") < 64 and time.time() < deadline:
        chunk = s.recv(65536)
        if not chunk:
            break
        body += chunk
    assert body.count(b"HTTP/1.1 200") == 64, "http slim burst"
    s.close()
    # ineligible: LF-only header endings fall back to the classic lane
    # (the answer — or a parse-reject close, or silence — is the
    # classic path's business; the probe only drives the fallback scan)
    s = pysock.create_connection(("127.0.0.1", port), timeout=2)
    s.sendall(b"POST /A/Echo HTTP/1.1\nHost: x\nContent-Length: 1\n\nz")
    try:
        s.recv(65536)
    except OSError:
        pass
    s.close()

    # ---- 3. client demux lane: plain successes + fallback shapes ----
    co = ChannelOptions()
    co.connection_type = "single"
    co.timeout_ms = 10_000
    ch = Channel(co)
    ch.init(f"127.0.0.1:{port}")
    done_evt = threading.Event()
    pending = [0]
    lock = threading.Lock()

    def done(cntl):
        with lock:
            pending[0] -= 1
            if pending[0] == 0:
                done_evt.set()

    for i in range(300):
        cntl = Controller()
        cntl.timeout_ms = 10_000
        if i % 7 == 0:
            cntl.request_attachment = IOBuf(b"a" * 1000)
        with lock:
            pending[0] += 1
        ch.call_method("A.Err" if i % 11 == 0 else "A.Echo",
                       b"p" * (i % 97), cntl=cntl, done=done)
    assert done_evt.wait(30), "async demux burst did not drain"

    # ---- 4. ParallelChannel scatter over native sub-servers ----
    pc = ParallelChannel()
    for sub in servers:
        c2 = ChannelOptions()
        c2.timeout_ms = 10_000
        sch = Channel(c2)
        sch.init(f"127.0.0.1:{sub.listen_endpoint.port}")
        pc.add_channel(sch)
    for i in range(50):
        cntl = Controller()
        cntl.timeout_ms = 10_000
        r = pc.call_method("A.Echo", b"scatter", cntl=cntl)
        assert not r.failed, (r.error_code, r.error_text)

    # ---- 5. shm slot lifecycle (≥256KB same-host attachments) ----
    from brpc_tpu_torch.transport import shm_ring
    if shm_ring.shm_supported():
        big = bytes(300 * 1024)
        co2 = ChannelOptions()
        co2.connection_type = "pooled"
        co2.timeout_ms = 10_000
        ch2 = Channel(co2)
        ch2.init(f"127.0.0.1:{port}")
        for i in range(40):
            cntl = Controller()
            cntl.timeout_ms = 10_000
            cntl.request_attachment = IOBuf(big)
            r = ch2.call_method("A.Echo", b"shm", cntl=cntl)
            assert not r.failed, (r.error_code, r.error_text)
            att = bytes(r.response_attachment)
            assert att == big, "shm echo corrupted"
            del r, att, cntl       # drop views: slot credits settle
    else:
        print("shm unsupported on this host; lane skipped",
              file=sys.stderr)

    # ---- 6. 4-loop engine: slim bursts + scatter + shm, concurrently ----
    opts4 = ServerOptions()
    opts4.native = True
    opts4.usercode_inline = True
    opts4.native_loops = 4
    srv4 = Server(opts4)
    srv4.add_service(Svc(), name="A")
    assert srv4.start("127.0.0.1:0") == 0
    port4 = srv4.listen_endpoint.port
    errors = []

    def _pipelined_conn(rounds):
        try:
            for _ in range(rounds):
                s = pysock.create_connection(("127.0.0.1", port4),
                                             timeout=10)
                blast = b"".join(frame(i + 1, b"q" * (13 * (i % 31)))
                                 for i in range(120))
                s.sendall(blast)
                got = bytearray()
                seen = 0
                while seen < 120:
                    chunk = s.recv(65536)
                    if not chunk:
                        raise AssertionError("peer closed mid-burst")
                    got += chunk
                    seen = 0
                    off = 0
                    while off + 12 <= len(got):
                        (blen,) = struct.unpack_from("<I", got, off + 4)
                        if off + 12 + blen > len(got):
                            break
                        off += 12 + blen
                        seen += 1
                s.close()
        except Exception as e:          # surfaced after join
            errors.append(f"pipelined: {type(e).__name__}: {e}")

    def _scatter4(rounds):
        try:
            pc4 = ParallelChannel()
            for sub in servers:
                c3 = ChannelOptions()
                c3.timeout_ms = 10_000
                sch = Channel(c3)
                sch.init(f"127.0.0.1:{sub.listen_endpoint.port}")
                pc4.add_channel(sch)
            for _ in range(rounds):
                cntl = Controller()
                cntl.timeout_ms = 10_000
                r = pc4.call_method("A.Echo", b"mc-scatter", cntl=cntl)
                assert not r.failed, (r.error_code, r.error_text)
        except Exception as e:
            errors.append(f"scatter: {type(e).__name__}: {e}")

    def _shm4(rounds):
        try:
            from brpc_tpu_torch.transport import shm_ring as _shm
            if not _shm.shm_supported():
                return
            data = bytes(280 * 1024)
            c5 = ChannelOptions()
            c5.connection_type = "pooled"
            c5.timeout_ms = 10_000
            ch5 = Channel(c5)
            ch5.init(f"127.0.0.1:{port4}")
            for _ in range(rounds):
                cntl = Controller()
                cntl.timeout_ms = 10_000
                cntl.request_attachment = IOBuf(data)
                r = ch5.call_method("A.Echo", b"shm4", cntl=cntl)
                assert not r.failed, (r.error_code, r.error_text)
                assert bytes(r.response_attachment) == data
                del r, cntl
        except Exception as e:
            errors.append(f"shm4: {type(e).__name__}: {e}")

    workers = ([threading.Thread(target=_pipelined_conn, args=(3,))
                for _ in range(4)]
               + [threading.Thread(target=_scatter4, args=(15,)),
                  threading.Thread(target=_shm4, args=(12,))])
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=120)
    assert not errors, errors
    tel = srv4._native_bridge.engine.telemetry()
    assert sum(lo["frames"] for lo in tel["loops"]) > 0
    srv4.stop()

    # ---- 7. drain under load (graceful lame-duck mid-burst) ----
    optsd = ServerOptions()
    optsd.native = True
    optsd.usercode_inline = True
    optsd.native_loops = 2
    srvd = Server(optsd)
    srvd.add_service(Svc(), name="A")
    assert srvd.start("127.0.0.1:0") == 0
    portd = srvd.listen_endpoint.port
    conns = [pysock.create_connection(("127.0.0.1", portd), timeout=10)
             for _ in range(3)]
    stop_blast = threading.Event()
    derrors = []

    def _blaster(s):
        # keep pipelined frames flowing while the drain flips the
        # engine into lame-duck: pre-drain frames answer 0, post-drain
        # ones answer ELAMEDUCK with the native duck TLV appended —
        # both shapes must be sanitizer-clean
        i = 0
        try:
            s.settimeout(5)
            while not stop_blast.is_set():
                i += 1
                s.sendall(frame(i, b"d" * (11 * (i % 23))))
                try:
                    s.recv(65536)
                except OSError:
                    return
        except OSError:
            pass
        except Exception as e:
            derrors.append(f"drain blaster: {type(e).__name__}: {e}")

    blasters = [threading.Thread(target=_blaster, args=(c,))
                for c in conns]
    for t in blasters:
        t.start()
    time.sleep(0.3)
    rc = srvd.drain(grace_ms=2000)
    assert rc == 0, f"drain under load rc={rc}"
    stop_blast.set()
    for t in blasters:
        t.join(timeout=10)
    for c in conns:
        c.close()
    assert not derrors, derrors
    srvd.stop()
    srvd.join(timeout=5)

    # ---- 8. kind-5 streaming lane: pipelined streams + session churn ----
    # A 2-loop engine serving streaming echo: concurrent sessions open
    # (kind-5 stream-open shim + native registration), pump chunks both
    # ways (burst-batched delivery, C++ credit accounting, coalesced
    # writes), then close and CHURN — the register/unregister/
    # conn-destroy sweep paths all run under ASan/UBSan with real
    # thread interleaving.
    from brpc_tpu_torch.streaming import StreamOptions, stream_accept, \
        stream_create

    class StreamSvc(Service):
        def Start(self, cntl, request):
            def on_received(stream, msgs):
                for m in msgs:
                    stream.write(bytes(m)[::-1])
            s = stream_accept(cntl,
                              StreamOptions(on_received=on_received))
            assert s is not None
            return b"ok"

    optss = ServerOptions()
    optss.native = True
    optss.usercode_inline = True
    optss.native_loops = 2
    srvs = Server(optss)
    srvs.add_service(StreamSvc(), name="ST")
    assert srvs.start("127.0.0.1:0") == 0
    serrors = []

    def _stream_churn(rounds):
        try:
            chs = Channel()
            chs.init(f"127.0.0.1:{srvs.listen_endpoint.port}")
            for r in range(rounds):
                got = []
                cntl = Controller()
                cntl.timeout_ms = 10_000
                stream = stream_create(cntl, StreamOptions(
                    on_received=lambda st, msgs: got.extend(msgs)))
                c = chs.call_method("ST.Start", b"", cntl=cntl)
                assert not c.failed, (c.error_code, c.error_text)
                assert stream.wait_established(10)
                n = 24
                for i in range(n):
                    assert stream.write(b"chunk-%03d" % i) == 0
                deadline = time.time() + 20
                while len(got) < n and time.time() < deadline:
                    time.sleep(0.005)
                assert len(got) == n, f"stream churn {len(got)}/{n}"
                stream.close()
        except Exception as e:
            serrors.append(f"stream churn: {type(e).__name__}: {e}")

    churners = [threading.Thread(target=_stream_churn, args=(4,))
                for _ in range(3)]
    for t in churners:
        t.start()
    for t in churners:
        t.join(timeout=120)
    assert not serrors, serrors
    tels = srvs._native_bridge.engine.telemetry()
    assert tels["streams"]["chunks_in"] > 0
    assert tels["streams"]["chunks_out"] > 0
    # close delivery is async (F_CLOSE rides the deliver queue):
    # bounded wait for the last unregister before asserting clean
    deadline = time.time() + 10
    while time.time() < deadline:
        tels = srvs._native_bridge.engine.telemetry()
        if tels["streams"]["open"] == 0:
            break
        time.sleep(0.05)
    assert tels["streams"]["open"] == 0      # churned clean
    srvs.stop()

    for sub in servers:
        sub.stop()
    print("ASAN_DRIVER_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
