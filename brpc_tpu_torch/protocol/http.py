"""HTTP/1.x protocol — served on the same port as every other protocol.

≈ brpc's src/brpc/policy/http_rpc_protocol.cpp +
details/http_message.* (capability, fresh parser): requests route either
to RPC methods (``/Service/Method``, body = payload, JSON or raw) or to
the builtin observability portal; the client side packs RPC calls as
HTTP for interop. HTTP/1.1 keep-alive, content-length and chunked
bodies, case-insensitive headers.

A copy of ``brpc_tpu/protocol/http.py``.  The server half registers as
the JAX one does; the client half is the port's ``Channel`` with
``options.protocol = "http"``, which writes :func:`build_request` and
cuts its response with :func:`parse` on the calling thread, then hands
it to ``client.controller.process_http_response`` (the JAX client's
messenger registration has no port counterpart: the port's client reads
its connections itself).
"""

from __future__ import annotations

from time import monotonic_ns as _monotonic_ns
from typing import Dict, List, Optional, Tuple

from ..butil.iobuf import IOBuf
from .base import (ParseResult, Protocol,
                   ProtocolType, max_body_size, register_protocol)

_METHODS = (b"GET ", b"POST", b"PUT ", b"DELE", b"HEAD", b"OPTI", b"PATC")
_MAX_HEADER = 16 * 1024

STATUS_REASONS = {
    200: "OK", 204: "No Content", 301: "Moved Permanently",
    302: "Found", 400: "Bad Request", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed",
    500: "Internal Server Error", 501: "Not Implemented",
    503: "Service Unavailable",
}


class HttpHeaders:
    """Case-ignored header map (≈ case_ignored_flat_map for HTTP headers,
    SURVEY.md §2.1). Preserves insertion order for serialization."""

    def __init__(self):
        self._items: List[Tuple[str, str]] = []
        self._index: Dict[str, int] = {}

    def set(self, key: str, value: str) -> None:
        k = key.lower()
        if k in self._index:
            self._items[self._index[k]] = (key, value)
        else:
            self._index[k] = len(self._items)
            self._items.append((key, value))

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        idx = self._index.get(key.lower())
        return self._items[idx][1] if idx is not None else default

    def items(self):
        return list(self._items)

    def __contains__(self, key: str) -> bool:
        return key.lower() in self._index


class HttpMessage:
    __slots__ = ("is_request", "method", "path", "query_string",
                 "version", "status_code", "reason", "headers", "body",
                 "socket_id", "recv_us")

    def __init__(self):
        self.is_request = True
        self.method = ""
        self.path = "/"
        self.query_string = ""
        self.version = "HTTP/1.1"
        self.status_code = 200
        self.reason = "OK"
        self.headers = HttpHeaders()
        self.body = b""
        self.socket_id = 0
        # arrival anchor for the deadline plane (x-deadline-ms):
        # construction ≈ parse time on every ingest path
        self.recv_us = _monotonic_ns() // 1000

    @property
    def keep_alive(self) -> bool:
        conn = (self.headers.get("connection") or "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"

    def query(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for pair in self.query_string.split("&"):
            if not pair:
                continue
            k, _, v = pair.partition("=")
            out[_unquote(k)] = _unquote(v)
        return out


def _unquote(s: str) -> str:
    from urllib.parse import unquote_plus
    return unquote_plus(s)


def _parse_headers(block: bytes) -> Optional[HttpHeaders]:
    headers = HttpHeaders()
    for line in block.split(b"\r\n"):
        if not line:
            continue
        k, sep, v = line.partition(b":")
        if not sep:
            return None
        try:
            headers.set(k.decode("latin1").strip(),
                        v.decode("latin1").strip())
        except UnicodeDecodeError:
            return None
    return headers


def _decode_chunked(data: bytes) -> Optional[Tuple[bytes, int]]:
    """Returns (body, consumed) or None if incomplete/invalid."""
    body = bytearray()
    off = 0
    while True:
        end = data.find(b"\r\n", off)
        if end < 0:
            return None
        try:
            size = int(data[off:end].split(b";")[0], 16)
        except ValueError:
            return None
        off = end + 2
        if size == 0:
            trailer_end = data.find(b"\r\n", off)
            if trailer_end < 0:
                return None
            # skip trailers until blank line
            while data[off:off + 2] != b"\r\n":
                nxt = data.find(b"\r\n", off)
                if nxt < 0:
                    return None
                off = nxt + 2
            return bytes(body), off + 2
        if len(data) < off + size + 2:
            return None
        body += data[off:off + size]
        off += size + 2


def parse(source: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    avail = len(source)
    if avail < 4:
        return ParseResult.not_enough_data() if _maybe_http(
            source.fetch(avail)) else ParseResult.try_others()
    head4 = source.fetch(4)
    if not _maybe_http(head4):
        return ParseResult.try_others()
    # peek only the header region first — copying the whole buffered body
    # on every nibble would make large uploads O(n^2)
    window = source.fetch(min(avail, _MAX_HEADER))
    header_end = window.find(b"\r\n\r\n")
    if header_end < 0:
        # Commitment check (mirrors the native engine's sniff rule): a
        # 4-byte method-token prefix is not proof of HTTP — a complete
        # first line without the version marker (redis "GET k\r\n", any
        # colliding protocol) must yield to the other handlers instead
        # of holding the connection against a CRLFCRLF that never comes.
        nl = window.find(b"\n")
        if nl >= 0 and b" HTTP/1." not in window[:nl] \
                and not window.startswith(b"HTTP/1."):
            return ParseResult.try_others()
        if avail > _MAX_HEADER:
            return ParseResult.absolutely_wrong()
        return ParseResult.not_enough_data()
    start_line, _, rest = window[:header_end].partition(b"\r\n")
    headers = _parse_headers(rest)
    if headers is None:
        return ParseResult.absolutely_wrong()

    msg = HttpMessage()
    msg.socket_id = getattr(sock, "id", 0)
    parts = start_line.split(None, 2)
    if start_line.startswith(b"HTTP/"):
        msg.is_request = False
        if len(parts) < 2:
            return ParseResult.absolutely_wrong()
        msg.version = parts[0].decode("latin1")
        try:
            msg.status_code = int(parts[1])
        except ValueError:
            return ParseResult.absolutely_wrong()
        msg.reason = parts[2].decode("latin1") if len(parts) > 2 else ""
    else:
        if len(parts) < 3:
            return ParseResult.absolutely_wrong()
        msg.method = parts[0].decode("latin1").upper()
        target = parts[1].decode("latin1")
        msg.version = parts[2].decode("latin1")
        msg.path, _, msg.query_string = target.partition("?")
    msg.headers = headers

    body_start = header_end + 4
    te = (headers.get("transfer-encoding") or "").lower()
    if "chunked" in te:
        # chunked needs the raw stream; copy past the header only here
        tail = source.fetch(min(avail, body_start + max_body_size()))
        decoded = _decode_chunked(tail[body_start:])
        if decoded is None:
            if avail >= body_start + max_body_size():
                return ParseResult.too_big()
            return ParseResult.not_enough_data()
        msg.body, consumed = decoded
        total = body_start + consumed
    else:
        try:
            clen = int(headers.get("content-length") or "0")
        except ValueError:
            return ParseResult.absolutely_wrong()
        if clen < 0:
            return ParseResult.absolutely_wrong()
        if clen > max_body_size():
            return ParseResult.too_big()
        total = body_start + clen
        if avail < total:
            return ParseResult.not_enough_data()   # no body copy yet
        if total <= len(window):
            msg.body = window[body_start:total]
        else:
            msg.body = source.fetch(total)[body_start:]
    source.pop_front(total)
    return ParseResult.make_message(msg)


def _maybe_http(prefix: bytes) -> bool:
    if not prefix:
        return False
    for m in _METHODS + (b"HTTP",):
        n = min(len(prefix), len(m))
        if prefix[:n] == m[:n]:
            return True
    return False


def build_response(status: int = 200, body: bytes = b"",
                   content_type: str = "text/plain",
                   headers: Optional[List[Tuple[str, str]]] = None,
                   keep_alive: bool = True) -> IOBuf:
    reason = STATUS_REASONS.get(status, "Unknown")
    lines = [f"HTTP/1.1 {status} {reason}",
             f"Content-Length: {len(body)}",
             f"Content-Type: {content_type}"]
    if not keep_alive:
        lines.append("Connection: close")
    for k, v in headers or []:
        lines.append(f"{k}: {v}")
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin1")
    out = IOBuf(head)
    if body:
        out.append(body)
    return out


def build_request(method: str, path: str, body: bytes = b"",
                  host: str = "", content_type: str =
                  "application/octet-stream",
                  headers: Optional[List[Tuple[str, str]]] = None) -> IOBuf:
    lines = [f"{method} {path} HTTP/1.1",
             f"Host: {host or 'localhost'}",
             f"Content-Length: {len(body)}",
             f"Content-Type: {content_type}"]
    for k, v in headers or []:
        lines.append(f"{k}: {v}")
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin1")
    out = IOBuf(head)
    if body:
        out.append(body)
    return out


def _process_request(msg: HttpMessage, sock, server) -> None:
    from ..server.http_dispatch import handle_http_request
    handle_http_request(msg, sock, server)


HTTP = Protocol(
    ProtocolType.HTTP, "http", parse,
    process_request=_process_request,
)
register_protocol(HTTP)
