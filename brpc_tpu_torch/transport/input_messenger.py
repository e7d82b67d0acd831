"""InputMessenger -- protocol-agnostic message ingestion.

The port of ``brpc_tpu/transport/input_messenger.py`` (brpc's
``input_messenger.cpp:329-410``): :meth:`InputMessenger.on_new_messages`
is a dispatcher-driven socket's ``on_edge_triggered_events``; on the
consumer fiber it reads a gulp into the socket's portal (the adaptive
size of ``Socket.read_into_portal``), then cuts messages by trying the
connection's last protocol first and every registered handler after it
(the PARSE_ERROR_TRY_OTHERS loop), until the socket reads EAGAIN.  Each
message is detected on its own, so one connection may carry tpu_std,
HTTP and RESP one after another.

Inline and spawned (``input_messenger.cpp:377-394``): an ordered
protocol (``process_inline``: streams, ICI acks, RESP) always runs on
the reading fiber in arrival order; any other message runs on a fiber of
its own when messages follow it in the gulp, and the gulp's last runs
inline, saving a context switch -- so a slow handler holds back the
frames that arrive on its connection while it runs, as in JAX, and the
consumer reads them (to EAGAIN, a TLS socket's decrypted bytes
included) when it returns.  :func:`messenger_counters` counts both.

A server's messenger holds the server-side handlers (``arg`` is the
server); :func:`client_messenger` is the process's one messenger for
client connections read by the dispatcher, holding tpu_std, the streams
and the ICI acks.  On the native engine the loop reads the bytes and
:meth:`InputMessenger.process_buffered` cuts them (its passthrough
lane).  Divergence: the client messenger takes its handlers when it is
first built, where each JAX protocol module adds itself on import.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ..butil.logging_util import LOG
from ..butil.status import Errno
from ..bvar.reducer import Adder
from ..fiber import runtime as fiber_runtime
from ..protocol.base import ParseError, ParseResult, Protocol
from .socket import Socket

_messages_in = Adder("input_messenger_messages")
_parse_failures = Adder("input_messenger_parse_error")
_counts = {"inline": 0, "spawned": 0}
_counts_lock = threading.Lock()


def messenger_counters() -> Dict[str, int]:
    """Messages processed on the reading fiber and on fibers of their
    own, since the process started."""
    with _counts_lock:
        return dict(_counts)


def _count(inline: int, spawned: int) -> None:
    with _counts_lock:
        _counts["inline"] += inline
        _counts["spawned"] += spawned


class InputMessenger:
    """One per Server (and one for client connections); holds the
    ordered list of protocol handlers tried during detection."""

    def __init__(self, handlers: Optional[List[Protocol]] = None,
                 arg: Any = None):
        self._handlers: List[Protocol] = list(handlers or [])
        self._arg = arg      # the Server on the server side; None else

    def add_handler(self, proto: Protocol) -> None:
        """≈ InputMessenger::AddHandler (input_messenger.cpp:410)."""
        if proto not in self._handlers:
            self._handlers.append(proto)

    @property
    def handlers(self) -> List[Protocol]:
        return self._handlers

    def on_new_messages(self, sock: Socket) -> None:
        """≈ OnNewMessages (input_messenger.cpp:329), on the consumer
        fiber: read and cut until the socket reads EAGAIN, fails, or
        closes (EOF fails it)."""
        while not sock.failed:
            nread = sock.read_into_portal()
            if nread < 0:
                return                      # EAGAIN: wait for the next event
            if nread == 0:
                sock.set_failed(int(Errno.EEOF), "remote closed connection")
                return
            self._cut_and_process(sock)

    def process_buffered(self, sock: Socket) -> None:
        """Cut and dispatch what is already in ``sock.read_portal``: the
        native engine's passthrough lane, whose loop read the bytes
        (``transport/native_bridge.py``), and a client connection the
        client lane handed back with bytes already read."""
        self._cut_and_process(sock)

    def _cut_and_process(self, sock: Socket) -> None:
        source = sock.read_portal
        pending = []
        while not source.empty():
            before = len(source)
            result, proto = self._cut_one(sock)
            if result is None:
                break                       # not enough data
            if not result.ok:
                _parse_failures << 1
                sock.set_failed(
                    int(Errno.EREQUEST),
                    f"unparsable message (first bytes {source.fetch(16)!r})")
                return
            sock.note_msg_size(before - len(source))
            _messages_in << 1
            pending.append((proto, result.message))
        if not pending:
            return
        # a non-inline message is never run inline when messages follow
        # it: a blocking handler must not delay its own stream's frames
        last = len(pending) - 1
        inline = [proto.process_inline or i == last
                  for i, (proto, _) in enumerate(pending)]
        _count(sum(inline), len(pending) - sum(inline))
        for (proto, msg), here in zip(pending, inline):
            if here:
                self._process(proto, msg, sock)
            else:
                fiber_runtime.spawn(self._process, proto, msg, sock,
                                    name=f"process_{proto.name}")

    def _cut_one(self, sock: Socket):
        """Try the last protocol, then every handler: ``(ParseResult,
        Protocol)``, or ``(None, None)`` when more bytes are needed."""
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
        return ParseResult.absolutely_wrong(), None   # no one claims them

    def _process(self, proto: Protocol, msg: Any, sock: Socket) -> None:
        try:
            if self._arg is not None and proto.process_request is not None:
                proto.process_request(msg, sock, self._arg)
            elif proto.process_response is not None:
                proto.process_response(msg, sock)
            else:
                LOG.error("protocol %s has no processor for this side",
                          proto.name)
        except Exception:
            LOG.exception("processing %s message failed", proto.name)


_client_messenger: Optional[InputMessenger] = None
_client_lock = threading.Lock()


def client_messenger() -> InputMessenger:
    """The process's messenger for client connections the dispatcher
    reads: tpu_std responses, stream frames and ICI acks."""
    global _client_messenger
    with _client_lock:
        if _client_messenger is None:
            from ..ici.endpoint import ICI_ACK
            from ..protocol.streaming import STREAMING
            from ..protocol.tpu_std import TPU_STD
            _client_messenger = InputMessenger([TPU_STD, STREAMING,
                                                ICI_ACK])
        return _client_messenger
