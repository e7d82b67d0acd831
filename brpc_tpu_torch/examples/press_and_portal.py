"""Load + observability tour.

The port of ``examples/press_and_portal.py``: drive a server with
``tools.rpc_press`` while reading live stats, the messenger's vars and a
CPU flame profile (the port's ``profiling`` sampler) from the builtin
portal.

Run: ``python -m brpc_tpu_torch.examples.press_and_portal --device cpu``
"""

from __future__ import annotations

import time

from ..server import Server, Service
from ..tools.rpc_press import Press, PressOptions
from ..tools.rpc_view import fetch
from . import parse_args


class Work(Service):
    def Do(self, cntl, request):
        return request[::-1]


def main(argv=None) -> int:
    parse_args(__doc__, argv)
    server = Server()
    server.add_service(Work(), name="W")
    assert server.start("127.0.0.1:0") == 0
    addr = str(server.listen_endpoint)

    popts = PressOptions()
    popts.server = addr
    popts.method = "W.Do"
    popts.qps = 500
    popts.duration_s = 3.0
    popts.input = b"payload"
    press = Press(popts)
    try:
        press.start()
        time.sleep(1.0)
        print("== /status ==")
        print(fetch(addr, "status"))
        print("== /vars (rpc related) ==")
        print(fetch(addr, "vars?filter=input_messenger"))
        print("== /hotspots/cpu (1s flame, flat view) ==")
        print(fetch(addr, "hotspots/cpu?seconds=1&view=flat"))
    finally:
        press.stop()
        print("press summary:", press.summary())
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
