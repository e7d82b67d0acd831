"""Service definition layer (a copy of ``brpc_tpu/server/service.py``'s
core).

A Service is any object whose public methods take ``(controller,
request)`` and return the response, or return None after
``controller.begin_async()`` and answer later through
``controller.finish(resp)``.  Requests arrive as raw ``bytes`` and
responses are bytes-like.  :func:`method` declares per-method options
(``request_type``, recorded for json2pb on the HTTP lane, and
``response_compress``, the default of the controller's
``response_compress_type``); :func:`grpc_streaming` marks a streaming
gRPC method and :func:`raw_method` a bytes-in/bytes-out method of the
native engine's raw lanes, as in the JAX package.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict


class Service:
    """Optional base class; any duck-typed object works via
    :func:`extract_methods`."""

    @classmethod
    def service_name(cls) -> str:
        return cls.__name__


def method(request_type: Any = None, response_compress: int = 0):
    """Decorator declaring per-method options:

        class Search(Service):
            @method(response_compress=CompressType.GZIP)
            def Query(self, cntl, request): ...
    """
    def mark(fn: Callable) -> Callable:
        fn._rpc_request_type = request_type
        fn._rpc_response_compress = response_compress
        return fn
    return mark


def raw_method(fn: Callable = None, *, native: str = None) -> Callable:
    """Declare a RAW method — the latency lane's server half.

    Signature: ``(payload, attachment) -> response`` where payload and
    attachment are zero-copy buffers (a memoryview into the frame;
    attachment is None when the request carried none) and the return is
    ``bytes`` or ``(response_bytes, attachment_bytes)``.

    On the native engine (``ServerOptions.native`` with
    ``usercode_inline``) a raw method dispatches without a controller or
    span: frame parse, handler, flat-TLV response (kind 2, or the bridge's
    raw lane when the engine hands the frame to Python).  Per-method
    stats and concurrency admission still apply.  Everywhere else — the
    Python transport, a request carrying controller-tier features
    (compression, device descriptors, streams, tracing, auth,
    interceptors) — the classic lane calls the handler with the same
    ``(payload, attachment)`` shape.  The request's deadline TLV is
    accepted but not enforced on the raw path: handlers that need it
    belong on a ``(cntl, request)`` method.

    ``native=``: name a C++ built-in semantic and the engine answers the
    method with no Python per request (kinds 0 and 1).  The Python ``fn``
    is the behavioral spec and the live fallback, and must implement
    exactly the declared semantic:

      - ``"echo"``: respond with the request payload and attachment
        unchanged
      - ``"const"``: respond with the fixed bytes the handler returns
        when called with (b"", None) — captured once at server start

        class Echo(Service):
            @raw_method(native="echo")
            def Echo(self, payload, attachment):
                return payload, attachment
    """
    def mark(f: Callable) -> Callable:
        f._rpc_raw = True
        f._rpc_native = native
        return f
    return mark(fn) if fn is not None else mark


def extract_methods(service: Any) -> Dict[str, Callable]:
    """Public callables of the service object = its RPC methods."""
    out: Dict[str, Callable] = {}
    for name in dir(service):
        if name.startswith("_"):
            continue
        fn = getattr(service, name)
        if not callable(fn):
            continue
        if name in ("service_name",):
            continue
        # only functions defined by the service class (not inherited
        # object/Service plumbing)
        if inspect.ismethod(fn) or inspect.isfunction(fn):
            out[name] = fn
    return out


def service_name_of(service: Any) -> str:
    if hasattr(service, "service_name"):
        return service.service_name()
    return type(service).__name__


def grpc_streaming(fn: Callable) -> Callable:
    """Declare a gRPC STREAMING method (server/client/bidi — the wire
    doesn't distinguish; the handler shape does):

        class Chat(Service):
            @grpc_streaming
            def Talk(self, cntl, msgs):       # msgs: iterator of requests
                for m in msgs:                # client/bidi streaming
                    cntl.grpc_stream.write(m) # server pushes
                return None                   # or a final response message

    The handler runs as soon as request HEADERS arrive; request messages
    stream in through ``msgs`` (ends when the client half-closes); every
    ``cntl.grpc_stream.write(bytes)`` pushes one response message; a
    non-None return value is sent as a final message before trailers.
    ≈ the reference's full-duplex h2 streams
    (brpc's src/brpc/policy/http2_rpc_protocol.cpp + grpc.h).
    """
    fn._grpc_streaming = True
    return fn
