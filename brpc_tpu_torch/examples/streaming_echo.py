"""Streaming RPC (≈ reference example/streaming_echo_c++).

The port of ``examples/streaming_echo.py``: establish a stream on an
RPC, push chunks with credit-based flow control, observe them on the
server.  The server's ``on_received`` gets each message as ``bytes``
(brpc_tpu hands out ``IOBuf``s), so ``len`` reads the same.

Run: ``python -m brpc_tpu_torch.examples.streaming_echo --device cpu``
"""

from __future__ import annotations

import threading

from ..client import Channel, Controller
from ..server import Server, Service
from ..streaming import StreamOptions, stream_accept, stream_create
from . import parse_args


class StreamSink(Service):
    def __init__(self):
        self.total = 0
        self.done = threading.Event()

    def Start(self, cntl, request):
        def on_received(stream, msgs):
            self.total += sum(len(m) for m in msgs)

        def on_closed(stream):
            self.done.set()

        stream_accept(cntl, StreamOptions(on_received=on_received,
                                          on_closed=on_closed))
        return b"stream accepted"


def main(argv=None) -> int:
    parse_args(__doc__, argv)
    svc = StreamSink()
    server = Server()
    server.add_service(svc, name="Sink")
    assert server.start("127.0.0.1:0") == 0

    channel = Channel()
    try:
        channel.init(str(server.listen_endpoint))
        cntl = Controller()
        cntl.timeout_ms = 5000
        stream = stream_create(cntl, StreamOptions(max_buf_size=1 << 20))
        c = channel.call_method("Sink.Start", b"", cntl=cntl)
        assert not c.failed, c.error_text
        print("server said:", c.response)

        chunk = b"x" * 65536
        for _ in range(64):                  # 4MB through the stream
            assert stream.write(chunk) == 0
        stream.close()
        svc.done.wait(10)
        print(f"server received {svc.total} bytes over the stream")
    finally:
        channel.close()
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
