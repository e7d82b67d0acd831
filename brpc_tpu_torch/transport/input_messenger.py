"""InputMessenger — protocol-agnostic message ingestion.

Capability parity with brpc's src/brpc/input_messenger.cpp:329-410:
read a gulp into the connection's portal, then repeatedly cut messages by
trying the connection's last-successful protocol first and falling back
to every registered handler (the PARSE_ERROR_TRY_OTHERS loop).  Each cut
message is processed in its own fiber task except the last, which runs
inline on the reading thread — the reference's batching trick that
saves one context switch per gulp.

A copy of ``brpc_tpu/transport/input_messenger.py`` for the port's
blocking sockets: :meth:`InputMessenger.serve` is a connection's reader
(one ``recv`` into the portal per gulp, until EOF or a message nobody
can cut), where the JAX package runs ``on_new_messages`` on a fiber woken
by its event dispatcher.  The port's server hands a connection to it
when the connection's first bytes are not tpu_std's (HTTP/1.x and h2);
tpu_std connections keep their ``read_frame`` reader.  On the native
engine the loop reads the bytes and :meth:`process_buffered` cuts them.
"""

from __future__ import annotations

from typing import Any, List

from ..butil.iobuf import IOPortal
from ..butil.logging_util import LOG
from ..butil.status import Errno
from ..bvar.reducer import Adder
from ..fiber import runtime as fiber_runtime
from ..protocol.base import ParseError, ParseResult, Protocol
from .socket import Socket

_messages_in = Adder("input_messenger_messages")
_parse_failures = Adder("input_messenger_parse_error")

# one recv per gulp: the reference's adaptive read size settles near this
# for RPC-sized messages
GULP_BYTES = 256 * 1024


class InputMessenger:
    """One per Server; holds the ordered list of protocol handlers tried
    during detection (the port reads its client connections itself)."""

    def __init__(self, handlers: List[Protocol], server: Any):
        self._handlers: List[Protocol] = list(handlers)
        self._arg = server      # every handler's parse and process arg

    def serve(self, sock: Socket) -> None:
        """The connection's reader (≈ OnNewMessages,
        input_messenger.cpp:329): read a gulp, cut and dispatch what it
        completes, until the peer closes, the socket fails or the bytes
        belong to no handler (the socket is then failed)."""
        if sock.read_portal is None:
            sock.read_portal = IOPortal()
        while not sock.failed:
            try:
                nread = sock.read_portal.append_from_socket(sock.conn,
                                                            GULP_BYTES)
            except OSError:
                return
            if nread == 0:
                sock.set_failed(Errno.EEOF, "remote closed connection")
                return
            self._cut_and_process(sock)

    def process_buffered(self, sock: Socket) -> None:
        """Cut and dispatch what is already in ``sock.read_portal``: the
        native engine's passthrough lane, whose loop read the bytes
        (``transport/native_bridge.py``)."""
        self._cut_and_process(sock)

    def _cut_and_process(self, sock: Socket) -> None:
        source = sock.read_portal
        pending = []
        while not source.empty():
            result, proto = self._cut_one(sock)
            if result is None:
                break                       # not enough data
            if not result.ok:
                _parse_failures << 1
                sock.set_failed(
                    Errno.EREQUEST,
                    f"unparsable message (first bytes {source.fetch(16)!r})")
                return
            _messages_in << 1
            pending.append((proto, result.message))
        if not pending:
            return
        # Ordered protocols process inline on the reading thread in
        # arrival order.  Non-inline messages get their own task —
        # except the final message of the gulp, which runs inline to save
        # a context switch (input_messenger.cpp:377-394 batching).  A
        # non-inline message is NEVER run inline when messages follow it:
        # a blocking RPC handler must not delay its own stream's frames.
        for i, (proto, msg) in enumerate(pending):
            if proto.process_inline or i == len(pending) - 1:
                self._process(proto, msg, sock)
            else:
                fiber_runtime.spawn(self._process, proto, msg, sock,
                                    name=f"process_{proto.name}")

    def _cut_one(self, sock: Socket):
        """Try last-used protocol, then all handlers. Returns
        (ParseResult|None, Protocol|None); None result = need more data."""
        source = sock.read_portal
        tried_last = None
        if sock.last_protocol is not None:
            tried_last = sock.last_protocol
            r = tried_last.parse(source, sock, False, self._arg)
            if r.error == ParseError.OK:
                return r, tried_last
            if r.error == ParseError.NOT_ENOUGH_DATA:
                return None, None
            if r.error in (ParseError.ABSOLUTELY_WRONG,
                           ParseError.TOO_BIG_DATA):
                return r, tried_last
            # TRY_OTHERS falls through to the detection loop
        for proto in self._handlers:
            if proto is tried_last:
                continue
            r = proto.parse(source, sock, False, self._arg)
            if r.error == ParseError.OK:
                sock.last_protocol = proto
                return r, proto
            if r.error == ParseError.NOT_ENOUGH_DATA:
                sock.last_protocol = proto
                return None, None
            if r.error in (ParseError.ABSOLUTELY_WRONG,
                           ParseError.TOO_BIG_DATA):
                return r, proto
        # nobody claims these bytes
        return ParseResult.absolutely_wrong(), None

    def _process(self, proto: Protocol, msg: Any, sock: Socket) -> None:
        try:
            proto.process_request(msg, sock, self._arg)
        except Exception:
            LOG.exception("processing %s message failed", proto.name)
