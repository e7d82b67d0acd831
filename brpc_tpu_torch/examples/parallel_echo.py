"""ParallelChannel fan-out (≈ reference example/parallel_echo_c++).

The port of ``examples/parallel_echo.py``: one call fans to 3 servers,
the responses merge in sub-channel order; one dead sub-channel would be
tolerated with ``fail_limit``.

Run: ``python -m brpc_tpu_torch.examples.parallel_echo --device cpu``
"""

from __future__ import annotations

from ..client import Channel, ChannelOptions, ParallelChannel
from ..server import Server, Service
from . import parse_args


class Shard(Service):
    def __init__(self, label: bytes):
        self.label = label

    def Get(self, cntl, request):
        return self.label + b":" + request


def main(argv=None) -> int:
    parse_args(__doc__, argv)
    servers = []
    try:
        for i in range(3):
            s = Server()
            servers.append(s)
            s.add_service(Shard(b"shard%d" % i), name="Shard")
            assert s.start("127.0.0.1:0") == 0

        pc = ParallelChannel(fail_limit=1)
        for s in servers:
            sub = Channel(ChannelOptions())
            sub.init(str(s.listen_endpoint))
            pc.add_channel(sub)

        c = pc.call_method("Shard.Get", b"key42")
        assert not c.failed, c.error_text
        print("merged response:", c.response)
    finally:
        for s in servers:
            s.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
