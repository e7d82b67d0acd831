"""Echo — the hello-world of the framework (≈ reference example/echo_c++).

The port of ``examples/echo.py``: starts a server with the native C++ IO
engine, makes sync, async and attachment-carrying calls, then a
pipelined batch.  The one idiom change: the port's controllers hold
attachments as ``bytes``, so the handler assigns the request's
attachment to the response's (brpc_tpu appends one ``IOBuf`` to the
other) and the client sets and prints ``bytes``.  The async ``done``
runs on the call's own thread, so the event wait stays.

Run: ``python -m brpc_tpu_torch.examples.echo --device cpu``
"""

from __future__ import annotations

import threading

from ..client import Channel, ChannelOptions, Controller
from ..server import Server, ServerOptions, Service
from . import parse_args


class EchoService(Service):
    def Echo(self, cntl, request):
        # the attachment rides back outside the payload
        cntl.response_attachment = cntl.request_attachment
        return request


def main(argv=None) -> int:
    parse_args(__doc__, argv)
    opts = ServerOptions()
    opts.native = True              # C++ epoll data plane
    opts.usercode_inline = True     # echo never blocks: run on the IO loop
    server = Server(opts)
    assert server.add_service(EchoService()) == 0
    assert server.start("127.0.0.1:0") == 0
    addr = str(server.listen_endpoint)
    print(f"server at {addr}")

    copts = ChannelOptions()
    copts.connection_type = "pooled"    # the latency fast lane
    copts.timeout_ms = 2000
    channel = Channel(copts)
    try:
        assert channel.init(addr) == 0

        # sync
        print("sync:", channel.call("EchoService.Echo", b"hello tpu-rpc"))

        # with attachment
        cntl = Controller()
        cntl.request_attachment = b"bulk-bytes " * 3
        c = channel.call_method("EchoService.Echo", b"with attachment",
                                cntl=cntl)
        print("attachment back:", c.response_attachment)

        # async with a done callback
        done_evt = threading.Event()

        def on_done(cntl):
            print("async:", cntl.response, f"({cntl.latency_us}us)")
            done_evt.set()

        channel.call_method("EchoService.Echo", b"fire-and-wait",
                            done=on_done)
        done_evt.wait(5)

        # pipelined batch (the high-QPS lane)
        outs = channel.call_batch("EchoService.Echo",
                                  [b"m%d" % i for i in range(8)])
        print("batch:", outs)
    finally:
        channel.close()
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
