"""One native listener, every protocol.

The port of ``examples/multi_protocol_port.py``.  The C++ engine cuts
tpu_std frames and HTTP/1.x natively; everything else (gRPC-over-h2,
redis RESP, thrift) rides the passthrough lane into the protocol
registry.  This example starts ONE server and talks to it with four
different clients.  grpcio is optional, as in brpc_tpu: where it is not
installed the gRPC line says ``skipped: grpcio absent``.

Run: ``python -m brpc_tpu_torch.examples.multi_protocol_port --device cpu``
"""

from __future__ import annotations

import http.client
import json

from ..client import Channel
from ..client.redis_client import RedisClient
from ..protocol.resp import RedisError
from ..server import Server, ServerOptions, Service, raw_method
from . import parse_args


class Calc(Service):
    def Add(self, cntl, request):
        data = json.loads(request or b"{}")
        return {"sum": int(data.get("a", 0)) + int(data.get("b", 0))}

    def Echo(self, cntl, request):
        return request

    @raw_method(native="echo")
    def EchoRaw(self, payload, attachment):
        # answered inside the C++ engine — zero Python per request
        return payload, attachment


class MiniRedis:
    def __init__(self):
        self.store = {}

    def on_command(self, args):
        cmd = args[0].upper()
        if cmd == b"PING":
            return "PONG"
        if cmd == b"SET":
            self.store[args[1]] = args[2]
            return "OK"
        if cmd == b"GET":
            return self.store.get(args[1])
        raise RedisError(f"unknown command {cmd.decode()}")


def grpc_echo(host: str, port: int) -> None:
    try:
        import grpc
    except ImportError:
        print("grpc     -> skipped: grpcio absent")
        return
    with grpc.insecure_channel(f"{host}:{port}") as gch:
        fn = gch.unary_unary("/Calc/Echo", request_serializer=lambda b: b,
                             response_deserializer=lambda b: b)
        print("grpc     ->", fn(b"unary over h2", timeout=10))


def main(argv=None) -> int:
    parse_args(__doc__, argv)
    opts = ServerOptions()
    opts.native = True             # the C++ engine owns the listener
    opts.usercode_inline = True    # echo-class handlers never block
    srv = Server(opts)
    srv.add_service(Calc(), name="Calc")
    srv.add_service(MiniRedis(), name="redis")
    assert srv.start("127.0.0.1:0") == 0
    ep = srv.listen_endpoint
    print(f"one native listener at {ep}\n")

    ch = Channel()
    try:
        # 1. tpu_std raw lane (C++-answered echo)
        ch.init(str(ep))
        resp, _ = ch.call_raw("Calc.EchoRaw", b"tpu_std bytes")
        print("tpu_std  ->", bytes(resp))

        # 2. HTTP/1.1 (C++-cut, Python-dispatched; also serves the portal)
        hc = http.client.HTTPConnection(ep.host, ep.port, timeout=10)
        hc.request("POST", "/Calc/Add", body=json.dumps({"a": 20, "b": 22}),
                   headers={"Content-Type": "application/json"})
        print("http     ->", hc.getresponse().read().decode().strip())
        hc.close()

        # 3. gRPC over h2 (passthrough lane), with a real grpcio client
        grpc_echo(ep.host, ep.port)

        # 4. redis RESP (passthrough lane)
        r = RedisClient(str(ep))
        r.set("greeting", b"hello from RESP")
        print("redis    ->", r.get("greeting"))
        r.close()
    finally:
        ch.close()
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
