"""Raw latency lane — the fastest supported path for echo-class RPCs.

The port of ``examples/raw_echo.py``.  A ``@raw_method`` handler
receives zero-copy views into the transport frame and returns bytes;
``Channel.call_raw`` completes the round trip with no Controller in the
path on either side (≈ the discipline of the reference's
example/echo_c++ benchmark handler).  Shows: raw round trips with
latency percentiles, a pipelined raw batch, and that per-method stats
survive the slim dispatch.  The p50/p99 and qps lines are timings of the
host's loopback; nothing here runs on the card.

Run: ``python -m brpc_tpu_torch.examples.raw_echo --device cpu``
"""

from __future__ import annotations

import time

from ..client import Channel
from ..server import Server, ServerOptions, Service, raw_method
from . import parse_args


class EchoService(Service):
    @raw_method
    def Echo(self, payload, attachment):
        # payload/attachment are memoryviews into the received frame;
        # returning the attachment view echoes it without a copy
        return b"ok", attachment


def main(argv=None) -> int:
    parse_args(__doc__, argv)
    opts = ServerOptions()
    opts.native = True              # C++ epoll data plane
    opts.native_loops = 1
    opts.usercode_inline = True     # raw handlers never block
    server = Server(opts)
    assert server.add_service(EchoService()) == 0
    assert server.start("127.0.0.1:0") == 0
    addr = str(server.listen_endpoint)
    print(f"server at {addr}")

    ch = Channel()
    try:
        assert ch.init(addr) == 0

        att = bytes(1024)
        resp, echoed = ch.call_raw("EchoService.Echo", b"hello", att)
        assert bytes(resp) == b"ok" and bytes(echoed) == att
        print("raw echo ok: 1KB attachment round-tripped zero-copy")

        for _ in range(300):            # warm the pinned connection
            ch.call_raw("EchoService.Echo", b"", att)
        lats = []
        for _ in range(2000):
            t0 = time.perf_counter()
            ch.call_raw("EchoService.Echo", b"", att)
            lats.append((time.perf_counter() - t0) * 1e6)
        lats.sort()
        print(f"2000 raw 1KB echos: p50 {lats[len(lats) // 2]:.0f}us  "
              f"p99 {lats[int(len(lats) * 0.99)]:.0f}us")

        reqs = [b"x" * 64] * 256
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < 2.0:
            ch.call_batch("EchoService.Echo", reqs)
            n += len(reqs)
        print(f"pipelined raw 64B: {n / (time.perf_counter() - t0):,.0f} "
              f"qps")

        entry = server.find_method("EchoService", "Echo")
        print(f"method stats survive the slim path: "
              f"{entry.status.latency.count()} calls recorded, "
              f"qps window {entry.status.latency.qps():.0f}")
    finally:
        ch.close()
        server.stop()
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
