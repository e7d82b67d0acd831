"""gRPC interop (≈ reference example/grpc_c++).

The port of ``examples/grpc_interop.py``: a real grpcio client calls
this framework's h2 server — unary and bidi streaming — then this
framework's own h2 client (``client.grpc_client.GrpcConnection``) calls
back.  grpcio is imported inside :func:`main` (brpc_tpu imports it at
the top); where it is not installed the grpcio half prints
``skipped: grpcio absent`` and the port's own client half still runs.

Run: ``python -m brpc_tpu_torch.examples.grpc_interop --device cpu``
"""

from __future__ import annotations

from ..butil.endpoint import parse_endpoint
from ..client.grpc_client import GrpcConnection
from ..server import Server, Service, grpc_streaming
from . import parse_args


def ident(b):
    return b


class EchoSvc(Service):
    def Echo(self, cntl, request):
        return request

    @grpc_streaming
    def Chat(self, cntl, msgs):
        for m in msgs:
            cntl.grpc_stream.write(m.upper())
        return None


def grpcio_calls(host: str, port: int) -> None:
    """The grpcio client's unary and bidi calls, or the skip line."""
    try:
        import grpc
    except ImportError:
        print("grpcio unary: skipped: grpcio absent")
        print("grpcio bidi: skipped: grpcio absent")
        return
    with grpc.insecure_channel(f"{host}:{port}") as ch:
        unary = ch.unary_unary("/EchoSvc/Echo", request_serializer=ident,
                               response_deserializer=ident)
        print("grpcio unary:", unary(b"ping-from-grpcio", timeout=10))

        bidi = ch.stream_stream("/EchoSvc/Chat", request_serializer=ident,
                                response_deserializer=ident)
        print("grpcio bidi:", list(bidi(iter([b"alpha", b"beta"]),
                                        timeout=10)))


def main(argv=None) -> int:
    parse_args(__doc__, argv)
    server = Server()
    server.add_service(EchoSvc(), name="EchoSvc")
    assert server.start("127.0.0.1:0") == 0
    ep = server.listen_endpoint
    try:
        grpcio_calls(ep.host, ep.port)

        # our h2 client against our own server, full circle
        conn = GrpcConnection(parse_endpoint(f"{ep.host}:{ep.port}"))
        status, msg, body = conn.unary_call("/EchoSvc/Echo", b"full-circle",
                                            10)
        print("our h2 client:", status, body)
        call = conn.streaming_call("/EchoSvc/Chat", 10.0)
        call.write(b"stream me")
        print("our streaming client:", call.read())
        call.done_writing()
        conn.close()
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
