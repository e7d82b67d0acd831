"""Fast unary call lane -- the client's latency path on the native engine.

The port of ``brpc_tpu/client/fast_call.py``.  A unary call on an
exclusive (``"pooled"`` or ``"short"``) connection needs no reader
thread and no waiter table: the frame is built as flat bytes from cached
method TLVs, the round trip runs inside the engine's ``sync_call``
(``native/src/engine.cpp``: a vectored write and a read of one frame,
with the GIL released), and the response is decoded on the calling
thread.  :func:`eligible` screens a call (tpu_std, no TLS, no
compression, no stream, no backup request; ``Channel.call_method``
without ``done``); :func:`run` completes it with the retry policy, the
excluded servers, the inherited deadline (``cap_timeout_ms``), the
balancer and breaker feedback, the lame-duck marks, the device
attachment (``prepare_send``, ``split_device_attachment``, TICI acks)
and the shm lane, as the Channel's Python path does.  Without the engine
(no toolchain) :func:`_py_sync_call` carries the same frames, and
:func:`lane_counters` counts which route each round trip took.

The other lanes:

- :func:`run_raw` -- ``Channel.call_raw``, the client half of
  ``@raw_method``: one attempt, the whole frame built, written, read and
  scanned in C by the engine's ``raw_call`` on a pooled connection pinned
  to the calling thread (``_PinnedSocks``: a dead thread's pins go back
  to the pool through a finalizer and a periodic drain);
- :func:`run_batch` -- ``Channel.call_batch``, pipelined on one pooled
  connection through ``call_batch``, matched by correlation id (the
  port's Python server answers a connection in order, the engine's fiber
  lane out of order), TICI acks collected;
- :func:`run_scatter` -- the ``ParallelChannel``'s synchronous fan-out:
  every branch's request on the wire before the first response is read,
  through ``scatter_call`` on the pinned connections
  (:func:`_scatter_native`), else per branch on this thread; each
  ineligible shape is counted under its name
  (:func:`scatter_fallback_counters`).

A response attachment keeps the Channel's shape on every lane: bytes
when it rode the frame, a ``memoryview`` whose release settles its ring
slot when it rode the shm lane (the raw lane's view settles at the
thread's next call on the pinned connection, as in the JAX lane).

Correlation ids come from one process-wide counter (:func:`reserve_cids`)
that the Channel's Python path draws from too, so connections shared by
several channels never see a cid twice.

Cut: JAX's pinned ``raw_call`` sub-path of :func:`run` (a controller call
on the raw lane's pinned connection); every pooled and short call here
takes ``sync_call``.
"""

from __future__ import annotations

import os
import select as _select
import struct
import threading
import weakref
from collections import deque
from time import monotonic_ns as _mono_ns
from time import sleep as _sleep
from typing import Any, Optional, Tuple

from ..butil.status import Errno
from ..bvar.multi_dimension import PassiveDimension
from ..deadline import backoff_ms as _backoff_ms
from ..deadline import cap_timeout_ms as _cap_timeout_ms
from ..ici.endpoint import (ack_unused, conn_nonce_of, ici_enabled,
                            prepare_send, process_ack,
                            split_device_attachment)
from ..ici.fabric import local_domain_id
from ..protocol import compress as compress_mod
from ..protocol.meta import (TAG_AUTH, TAG_ICI_CONN, TAG_ICI_DESC,
                             TAG_ICI_DOMAIN, TAG_METHOD, TAG_SERVICE,
                             TAG_TENANT, TLV_ATTACHMENT, TLV_CORRELATION,
                             TLV_SPAN, TLV_TIMEOUT, TLV_TRACE, RpcMeta,
                             encode_tlv)
from ..protocol.tpu_std import max_body_size, parse_payload
from ..transport import shm_ring
from ..transport.socket import Socket
from ..transport.socket_map import (NO_DEADLINE_S, conn_key, pooled_socket,
                                    return_pooled_socket, short_socket)

_MAGIC = b"TRPC"
_MAX_BODY = 512 * 1024 * 1024   # the engine's kMaxBody
_MAX_PARTS = 56                 # sync_call takes at most 62 iovecs

_native_mod: Optional[object] = None
_native_tried = False


def _native():
    global _native_mod, _native_tried
    if not _native_tried:
        _native_tried = True
        try:
            from ..native import load
            _native_mod = load()
        except Exception:
            _native_mod = None
    return _native_mod


# -- which route each round trip took ---------------------------------------

LANE_ROUTES = ("sync_call", "py_sync_call", "raw_call", "call_batch",
               "scatter_call", "slow_path")
_routes = {r: 0 for r in LANE_ROUTES}
_routes_lock = threading.Lock()


def _count(route: str, n: int = 1) -> None:
    with _routes_lock:
        _routes[route] += n


def lane_counters() -> dict:
    """Round trips per route since the process started: the engine's
    ``sync_call``, ``raw_call``, ``call_batch`` and ``scatter_call``,
    the Python ``py_sync_call``, and ``slow_path`` (a call the lane
    handed to the Channel's Python path)."""
    with _routes_lock:
        return dict(_routes)


_routes_var = PassiveDimension(("route",), lane_counters,
                               name="native_fast_call_total")

# -- named scatter fallbacks -------------------------------------------------

_scatter_fallbacks: dict = {}
_scatter_lock = threading.Lock()
_scatter_var = PassiveDimension(
    ("reason",), lambda: scatter_fallback_counters(),
    name="native_scatter_fallback_total")


def _scatter_fallback(reason: str) -> bool:
    """Count one named scatter ineligibility; False, so a screening site
    reads ``return _scatter_fallback("...")``."""
    with _scatter_lock:
        _scatter_fallbacks[reason] = _scatter_fallbacks.get(reason, 0) + 1
    return False


def scatter_fallback_counters() -> dict:
    with _scatter_lock:
        return dict(_scatter_fallbacks)


# -- correlation ids ----------------------------------------------------------

_cid_lock = threading.Lock()
_next = [1]


def reserve_cids(n: int) -> int:
    """Reserve ``n`` consecutive correlation ids; returns the first."""
    with _cid_lock:
        base = _next[0]
        _next[0] += n
    return base


def _next_cid() -> int:
    return reserve_cids(1)


_domain_tlv_cache: Tuple[Optional[bytes], bytes] = (None, b"")


def _domain_tlv(domain: bytes) -> bytes:
    global _domain_tlv_cache
    cached_domain, cached = _domain_tlv_cache
    if cached_domain != domain:
        cached = encode_tlv(TAG_ICI_DOMAIN, domain)
        _domain_tlv_cache = (domain, cached)
    return cached


def method_tlv(method_full: str, tenant: str = "") -> bytes:
    """Pre-encoded service and method (and tenant, TLV 22) bytes, cached
    on the Channel."""
    svc, _, mth = method_full.rpartition(".")
    out = (encode_tlv(TAG_SERVICE, svc.encode())
           + encode_tlv(TAG_METHOD, mth.encode()))
    if tenant:
        out += encode_tlv(TAG_TENANT, str(tenant).encode())
    return out


def channel_method_tlv(channel, method_full: str) -> bytes:
    tlv = channel._method_tlvs.get(method_full)
    if tlv is None:
        tlv = channel._method_tlvs[method_full] = \
            method_tlv(method_full, channel.options.tenant)
    return tlv


def eligible(channel, cntl) -> bool:
    """The static screen of a blocking call; runtime conditions are
    checked again in :func:`run`."""
    opts = channel.options
    ctype = cntl.connection_type or opts.connection_type
    return (opts.protocol == "tpu_std"
            and not opts.ssl and opts.ssl_context is None
            and ctype in ("pooled", "short")
            and not cntl.request_compress_type
            and not opts.request_compress_type
            and cntl._stream_to_create is None
            and (cntl.backup_request_ms is None
                 or cntl.backup_request_ms <= 0)
            and (opts.backup_request_ms is None
                 or opts.backup_request_ms <= 0))


# -- the Python round trip (no engine) ----------------------------------------

def _cut_tici_frames(buf, off: int = 0) -> Tuple[list, int]:
    """Complete TICI frames of ``buf[off:]``: ``(ack ids, offset past
    them)``; stops at the first partial frame or other bytes."""
    acks: list = []
    while len(buf) - off >= 8 and bytes(buf[off:off + 4]) == b"TICI":
        (cnt,) = struct.unpack_from("<I", buf, off + 4)
        if cnt > 1 << 20:
            raise ValueError("oversized ack frame")
        total = 8 + 8 * cnt
        if len(buf) - off < total:
            break
        acks.extend(struct.unpack_from(f"<{cnt}Q", buf, off + 8))
        off += total
    return acks, off


def _wait(fd, write: bool, deadline: Optional[float]) -> None:
    import time as _time
    left = None if deadline is None else deadline - _time.monotonic()
    if left is not None and left <= 0:
        raise TimeoutError("rpc deadline exceeded")
    r, w, _ = _select.select([] if write else [fd], [fd] if write else [],
                             [], left)
    if not r and not w:
        raise TimeoutError("rpc deadline exceeded")


def _recv(fd, n: int) -> Optional[bytes]:
    """Bytes the kernel holds now (None when it holds none)."""
    try:
        return os.read(fd.fileno(), n)
    except (BlockingIOError, InterruptedError):
        return None


def _py_sync_call(sock, frame: bytes,
                  timeout_s: float) -> Tuple[memoryview, int, tuple]:
    """``sync_call`` in Python: write ``frame``, read one response frame;
    TICI acks around it are consumed and returned third."""
    import time as _time
    _count("py_sync_call")
    deadline = _time.monotonic() + timeout_s if timeout_s >= 0 else None
    fd = sock.fd
    view = memoryview(frame)
    while view:
        try:
            view = view[os.write(fd.fileno(), view):]
        except (BlockingIOError, InterruptedError):
            _wait(fd, True, deadline)
    buf = bytearray()
    acks: list = []
    while True:
        if len(buf) >= 8 and bytes(buf[:4]) == b"TICI":
            got, off = _cut_tici_frames(buf)
            if off:
                acks.extend(got)
                del buf[:off]
                continue
        elif len(buf) >= 12:
            if bytes(buf[:4]) != _MAGIC:
                raise ValueError("unexpected magic on fast-path read")
            body, meta = struct.unpack_from("<II", buf, 4)
            if meta > body or body > _MAX_BODY:
                raise ValueError("bad frame sizes")
            end = 12 + body
            if len(buf) >= end:
                # trailing TICI frames the read pulled in (a lazy redeem's
                # acks): consumed whole, with a grace for those in flight
                tdl = None if deadline is None \
                    else max(deadline, _time.monotonic() + 2.0)
                while len(buf) > end:
                    if len(buf) - end >= 4 \
                            and bytes(buf[end:end + 4]) != b"TICI":
                        raise ValueError(
                            "unexpected trailing bytes after response")
                    got, noff = _cut_tici_frames(buf, end)
                    if noff > end:
                        acks.extend(got)
                        del buf[end:noff]
                        continue
                    _wait(fd, False, tdl)
                    chunk = _recv(fd, 65536)
                    if chunk == b"":
                        raise ConnectionError("connection closed mid-ack")
                    buf += chunk or b""
                return memoryview(buf)[12:end], meta, tuple(acks)
        chunk = _recv(fd, 1 << 20)
        if chunk is None:
            _wait(fd, False, deadline)
            continue
        if not chunk:
            raise ConnectionError("connection closed by peer")
        buf += chunk


def _drain_acks_nonblocking(sock, deadline_us: Optional[int] = None) -> None:
    """Consume the TICI frames already in the kernel for this exclusively
    owned connection (between calls only acks may arrive); a partial one
    is finished with a short wait inside the call's deadline.  EOF or
    other bytes fail the socket: the caller checks ``sock.failed``."""
    import time as _time
    fd = sock.fd
    if fd is None:
        return
    buf = bytearray()
    deadline = None
    while True:
        try:
            chunk = _recv(fd, 65536)
        except OSError as e:
            sock.set_failed(int(Errno.EFAILEDSOCKET), f"drain: {e}")
            return
        if chunk == b"":
            sock.set_failed(int(Errno.EFAILEDSOCKET), "closed while draining")
            return
        buf += chunk or b""
        try:
            acks, off = _cut_tici_frames(buf)
        except ValueError:
            sock.set_failed(int(Errno.ERESPONSE), "oversized ack frame")
            return
        if acks:
            process_ack(acks, sock)
        del buf[:off]
        if not buf:
            if chunk is None:
                return
            continue
        if bytes(buf[:4]) != b"TICI"[:len(buf[:4])]:
            sock.set_failed(int(Errno.ERESPONSE),
                            "unexpected bytes while idle")
            return
        if deadline is None:
            deadline = _time.monotonic() + 2.0
            if deadline_us is not None:
                deadline = min(deadline, _time.monotonic() + max(
                    0.001, (deadline_us - _mono_ns() // 1000) / 1e6))
        try:
            _wait(fd, False, deadline)
        except TimeoutError:
            sock.set_failed(int(Errno.ERESPONSE), "truncated ack frame")
            return


def _own(sock) -> None:
    """The descriptor stays non-blocking for the engine."""
    conn = sock.conn
    if conn.gettimeout() is None:
        conn.settimeout(NO_DEADLINE_S)


def _round_trip(nat, sock, parts: tuple, timeout_s: float):
    """``(buf, meta_size, acks)`` of one request on an owned connection:
    the engine's ``sync_call``, or :func:`_py_sync_call` without it.
    The write lock is held, so no ack flush interleaves with the frame;
    acks queued meanwhile ride in front."""
    _own(sock)
    with sock._write_lock:
        ack0 = sock._take_ack_frame()
        if ack0 is not None:
            parts = (ack0,) + parts
        if nat is not None:
            _count("sync_call")
            res = nat.sync_call(sock.fd.fileno(), parts, timeout_s)
            return res[0], res[1], res[2] if len(res) > 2 else ()
        return _py_sync_call(sock, b"".join(parts), timeout_s)


# -- the unary lane -----------------------------------------------------------

def run(channel, cntl, method_full: str, payload: bytes,
        response_type: Any, method_tlvs: bytes) -> None:
    """Complete the call on the calling thread, filling ``cntl`` as the
    Channel's Python path does (response, attachments, error, latency,
    balancer or breaker feedback, the retry budget)."""
    opts = channel.options
    cntl._channel = channel
    begin = _mono_ns() // 1000
    if cntl.timeout_ms is None:
        cntl.timeout_ms = opts.timeout_ms
    # inside a deadline'd handler the call is capped by the upstream's
    # budget, and fails fast once it is gone
    cntl.timeout_ms, expired = _cap_timeout_ms(cntl.timeout_ms)
    if expired:
        _finish(channel, cntl, Errno.ERPCTIMEDOUT,
                "inherited deadline already expired (doomed downstream "
                "call failed fast)", begin)
        return
    if cntl.max_retry is None:
        cntl.max_retry = opts.max_retry
    if cntl.connection_type is None:
        cntl.connection_type = opts.connection_type
    timeout_ms = cntl.timeout_ms
    deadline_us = begin + timeout_ms * 1000 \
        if timeout_ms and timeout_ms > 0 else None
    att = bytes(cntl.request_attachment or b"")
    att_len = len(att)
    domain = local_domain_id() if ici_enabled() else b""
    auth = opts.auth_data or b""
    if isinstance(auth, str):
        auth = auth.encode()
    if len(payload) + att_len + 96 > min(_MAX_BODY, max_body_size()):
        _finish(channel, cntl, Errno.EREQUEST,
                "payload + attachment exceeds max body", begin)
        return
    nat = _native()
    pooled = cntl.connection_type == "pooled"
    connect_s = opts.connect_timeout_ms / 1e3
    nretry = 0
    remote = None

    def retry_or_finish(code: int, text: str) -> bool:
        """True: retry; False: the call is finished.  The retry draws a
        budget token and backs off as the Python path does; a superseded
        attempt's server is excluded and feeds the breaker."""
        nonlocal nretry
        if cntl.retry_policy(cntl, code) and nretry < cntl.max_retry:
            if deadline_us is not None \
                    and _mono_ns() // 1000 >= deadline_us:
                _finish(channel, cntl, Errno.ERPCTIMEDOUT,
                        f"deadline {timeout_ms}ms exceeded", begin)
                return False
            if not channel.acquire_retry_token():
                cntl.excluded_servers.add(remote)
                _finish(channel, cntl, code, text, begin)
                return False
            channel._on_attempt_superseded(cntl, nretry, code)
            nretry += 1
            cntl.retried_count = nretry
            delay_ms = 0.0 if code in (int(Errno.ELIMIT),
                                       int(Errno.ELAMEDUCK)) else \
                _backoff_ms(opts.retry_backoff_ms, nretry,
                            opts.retry_backoff_max_ms)
            if delay_ms > 0:
                if deadline_us is not None:
                    delay_ms = min(delay_ms, max(
                        0.0, (deadline_us - _mono_ns() // 1000) / 1000.0))
                _sleep(delay_ms / 1e3)
            return True
        cntl.excluded_servers.add(remote)
        _finish(channel, cntl, code, text, begin)
        return False

    while True:
        if channel.load_balancer is not None:
            remote = channel.load_balancer.select_server(cntl)
        else:
            remote = channel.server
        if remote is None:
            _finish(channel, cntl, Errno.EINTERNAL, "no server available",
                    begin)
            return
        cntl.remote_side = remote
        cntl.attempt_remotes[nretry] = remote
        sid, rc = pooled_socket(remote, None, connect_s, auth) if pooled \
            else short_socket(remote, None, connect_s)
        sock = Socket.address(sid) if rc == 0 else None
        if sock is None or sock.fd is None:
            if retry_or_finish(int(Errno.EFAILEDSOCKET),
                               f"connect to {remote} failed"):
                continue
            return
        if not sock.write_path_idle():
            # an ack flush still owns the writes: this lane cannot own
            # the connection, the Python path serves the call
            _put_back(sock, pooled)
            _slow_path(channel, cntl, method_full, payload, response_type,
                       deadline_us, timeout_ms, begin)
            return
        code, text = 0, ""
        shm_slot = None
        shm_offered = False
        a_parts: tuple = (att,) if att_len else ()
        a_len = att_len
        shm_extra = b""
        if att_len or sock.shm is not None:
            # the shm data plane; a retry stays off it (the failed
            # attempt's descriptor may still be unread)
            shm_extra, wire, shm_slot, shm_offered = shm_ring.client_prepare(
                sock, att if att_len else None,
                device=cntl.request_device_attachment is not None,
                multi_attempt=nretry > 0)
            if att_len and wire is None:
                a_parts, a_len = (), 0
        dev_desc = b""
        if domain:
            conn_nonce_of(sock)     # before any descriptor binds to it
        if cntl.request_device_attachment is not None:
            # credit returns may sit unread in this connection's buffer
            # (lazy redeems after the last response): take them first
            _drain_acks_nonblocking(sock, deadline_us)
            if sock.failed:
                shm_ring.client_complete(shm_slot)
                sock.release()
                if retry_or_finish(int(Errno.EFAILEDSOCKET),
                                   "connection failed while idle"):
                    continue
                return
            post_s = 2.0 if deadline_us is None else max(
                0.001, min(2.0, (deadline_us - _mono_ns() // 1000) / 1e6))
            m = RpcMeta()
            try:
                tail = prepare_send(sock, m, cntl.request_device_attachment,
                                    timeout_s=post_s)
            except RuntimeError as e:
                shm_ring.client_complete(shm_slot)
                _put_back(sock, pooled)
                _finish(channel, cntl, Errno.EOVERCROWDED, str(e), begin)
                return
            dev_desc = m.ici_desc or b""
            if tail is not None:
                a_parts = a_parts + (bytes(tail),)
                a_len += len(tail)
        if len(a_parts) > _MAX_PARTS:
            a_parts = (b"".join(a_parts),)
        cid = _next_cid()
        mb = bytearray(TLV_CORRELATION)
        mb += struct.pack("<Q", cid)
        if a_len:
            mb += TLV_ATTACHMENT + struct.pack("<I", a_len)
        mb += method_tlvs
        mb += shm_extra
        if dev_desc:
            mb += encode_tlv(TAG_ICI_DESC, dev_desc)
        sent_auth = bool(auth) and sock.app_data is None
        if sent_auth:
            # credentials ride the connection's messages until the server
            # has accepted them (_handle_response marks that)
            mb += encode_tlv(TAG_AUTH, auth)
        if deadline_us is not None:
            left_ms = max(1, (deadline_us - _mono_ns() // 1000) // 1000)
            mb += TLV_TIMEOUT + struct.pack("<I", left_ms)
        if domain:
            mb += _domain_tlv(domain)
            mb += encode_tlv(TAG_ICI_CONN, conn_nonce_of(sock))
        if cntl.trace_id:
            mb += TLV_TRACE + struct.pack("<Q", cntl.trace_id)
        if cntl.span_id:
            mb += TLV_SPAN + struct.pack("<Q", cntl.span_id)
        header = _MAGIC + struct.pack(
            "<II", len(mb) + len(payload) + a_len, len(mb))
        timeout_s = -1.0 if deadline_us is None \
            else max(0.001, (deadline_us - _mono_ns() // 1000) / 1e6)
        try:
            buf, meta_size, acks = _round_trip(
                nat, sock, (header, bytes(mb), payload) + a_parts,
                timeout_s)
            if acks:
                process_ack(acks, sock)
        except TimeoutError:
            # a posted descriptor is not released: the server may still
            # redeem it; the settle and the TTL sweep own it
            shm_ring.client_complete(shm_slot)
            sock.set_failed(int(Errno.ERPCTIMEDOUT), "rpc timeout")
            sock.release()
            _finish(channel, cntl, Errno.ERPCTIMEDOUT,
                    f"deadline {timeout_ms}ms exceeded", begin)
            return
        except (ConnectionError, ValueError, OSError) as e:
            shm_ring.client_complete(shm_slot)
            sock.set_failed(int(Errno.EFAILEDSOCKET), str(e))
            sock.release()
            code, text = int(Errno.EFAILEDSOCKET), str(e)
        if code == 0:
            done, code, text = _handle_response(
                channel, cntl, sock, pooled, buf, meta_size, cid,
                response_type, begin, shm_slot=shm_slot,
                shm_offered=shm_offered, sent_auth=sent_auth)
            if done:
                return
        if retry_or_finish(code, text):
            continue
        return


def _put_back(sock, pooled: bool) -> None:
    if pooled:
        return_pooled_socket(sock.id)
    else:
        sock.release()


def _handle_response(channel, cntl, sock, pooled: bool, buf,
                     meta_size: int, cid: int, response_type: Any,
                     begin: int, put_back=None, shm_slot=None,
                     shm_offered: bool = False,
                     sent_auth: bool = False) -> Tuple[bool, int, str]:
    """Decode one response frame: ``(done, code, text)``, done False for
    a failure the caller may retry.  ``put_back`` overrides how a healthy
    connection is handed back (the pinned lane keeps it).  ``sent_auth``:
    the request carried the credentials; a success marks the connection
    authenticated, and a refusal (ERPCAUTH) closes it."""
    def _back():
        if put_back is not None:
            put_back()
        else:
            _put_back(sock, pooled)

    def _complete(raw: bytes, attachment) -> Tuple[bool, int, str]:
        try:
            cntl.response = parse_payload(raw, response_type)
        except Exception as e:
            _back()
            _finish(channel, cntl, Errno.ERESPONSE,
                    f"response parse failed: {e}", begin)
            return True, 0, ""
        cntl.response_attachment = attachment
        _back()
        _finish(channel, cntl, 0, "", begin)
        return True, 0, ""

    mv = memoryview(buf)
    scan = _scan_raw_resp(mv[:meta_size])
    if scan is not None:
        # a plain success: no RpcMeta object
        if shm_slot is not None or shm_offered:
            shm_ring.client_complete(shm_slot)
            if shm_offered:
                shm_ring.client_saw_plain_response(sock)
        rcid, natt, dom = scan
        if rcid != cid:
            sock.set_failed(int(Errno.ERESPONSE), "response cid mismatch")
            sock.release()
            return False, int(Errno.EFAILEDSOCKET), "cid mismatch"
        if dom:
            sock.ici_peer_domain = dom
        if sent_auth:
            sock.app_data = "authed"
        body = mv[meta_size:]
        if natt > len(body):
            sock.set_failed(int(Errno.ERESPONSE),
                            "attachment size exceeds body")
            sock.release()
            return False, int(Errno.ERESPONSE), "malformed response"
        split = len(body) - natt
        return _complete(bytes(body[:split]), bytes(body[split:]))
    meta = RpcMeta.decode(bytes(mv[:meta_size]))
    if meta is None or meta.correlation_id != cid:
        shm_ring.client_complete(shm_slot)
        sock.set_failed(int(Errno.ERESPONSE), "undecodable response meta")
        sock.release()
        return False, int(Errno.EFAILEDSOCKET), "undecodable response"
    view = settle = None
    if meta.shm_offer or meta.shm_accept or meta.shm_desc \
            or shm_offered or shm_slot is not None:
        try:
            view, settle = shm_ring.client_on_response_meta(
                sock, meta, offered_now=shm_offered and not meta.error_code,
                staged_slot=shm_slot)
        except shm_ring.ShmDescriptorError as e:
            sock.set_failed(int(Errno.ERESPONSE), str(e))
            sock.release()
            return False, int(Errno.ERESPONSE), str(e)
    if meta.ici_domain:
        sock.ici_peer_domain = meta.ici_domain
    _mark_lame(meta, cntl.remote_side)
    if meta.error_code:
        ack_unused(meta, sock.id)
        if meta.error_code == int(Errno.ERPCAUTH):
            # refused credentials: the connection serves no one else
            _fail(sock, meta.error_code, meta.error_text)
        else:
            _back()              # the frame was read whole: healthy
        return False, meta.error_code, meta.error_text
    if sent_auth:
        sock.app_data = "authed"
    body = mv[meta_size:]
    if meta.attachment_size > len(body):
        ack_unused(meta, sock.id)
        sock.set_failed(int(Errno.ERESPONSE), "attachment size exceeds body")
        sock.release()
        return False, int(Errno.ERESPONSE), "malformed response"
    split = len(body) - meta.attachment_size
    attachment = bytes(body[split:])
    if meta.ici_desc:
        attachment, cntl.response_device_attachment = \
            split_device_attachment(meta, attachment, sock.id)
    if view is not None:
        # the attachment rode the ring: its slot recycles when the
        # caller drops the view
        attachment = shm_ring.settled_view(view, settle)
    raw = bytes(body[:split])
    if meta.compress_type:
        raw = compress_mod.decompress(raw, meta.compress_type)
        if raw is None:
            _back()
            _finish(channel, cntl, Errno.ERESPONSE,
                    "undecompressable response", begin)
            return True, 0, ""
    return _complete(raw, attachment)


def _mark_lame(meta, remote) -> None:
    """A draining server's lame-duck TLV (or its ELAMEDUCK) marks it; a
    clean decoded answer clears a restarted successor's mark."""
    from .naming_service import global_lame_ducks
    if meta.lame_duck or meta.error_code == int(Errno.ELAMEDUCK):
        global_lame_ducks().mark(remote)
    elif not meta.error_code and remote is not None:
        global_lame_ducks().clear(remote)


def _breaker_feed(channel, remote, code: int, latency_us: int = 0) -> None:
    """The pinned lanes have no balancer in the path: their outcome goes
    to the process-wide breaker map, as the balancer's would."""
    if remote is None or not channel.options.enable_circuit_breaker:
        return
    from .circuit_breaker import global_circuit_breaker_map
    global_circuit_breaker_map().on_call(remote, int(code), latency_us)


def _finish(channel, cntl, code, text: str, begin: int) -> None:
    if code:
        cntl.set_failed(code, text)
    cntl.latency_us = _mono_ns() // 1000 - begin
    channel._feedback(cntl)
    if not code:
        channel.on_call_success()      # refill the retry budget


def _slow_path(channel, cntl, method_full, payload, response_type,
               deadline_us, timeout_ms, begin) -> None:
    """The Channel's Python path serves the call, within what is left of
    the deadline this lane already spent from."""
    _count("slow_path")
    if deadline_us is not None:
        left_ms = (deadline_us - _mono_ns() // 1000) // 1000
        if left_ms <= 0:
            _finish(channel, cntl, Errno.ERPCTIMEDOUT,
                    f"deadline {timeout_ms}ms exceeded", begin)
            return
        cntl.timeout_ms = max(1, int(left_ms))
    channel._launch(cntl, method_full, payload, None, response_type)


def _scan_raw_resp(data):
    """A TLV walk of a success meta: ``(cid, att_size, ici_domain)``, or
    None when any tag beyond those three is present."""
    cid = att = 0
    dom = None
    off, end = 0, len(data)
    try:
        while off < end:
            tag = data[off]
            (ln,) = struct.unpack_from("<I", data, off + 1)
            off += 5
            if off + ln > end:
                return None
            if tag == 1:
                (cid,) = struct.unpack_from("<Q", data, off)
            elif tag == 3:
                (att,) = struct.unpack_from("<I", data, off)
            elif tag == 15:
                dom = bytes(data[off:off + ln])
            else:
                return None
            off += ln
    except (struct.error, IndexError):
        return None
    return cid, att, dom


# -- the pinned connections (raw lane, native scatter) ------------------------

_tls_raw = threading.local()
_unpin_pending: deque = deque()


def _unpin_all(sids_map: dict) -> None:
    """A dead thread's pins, parked for the next drain (a finalizer must
    not call into the pool: it may run mid-GC under the pool's lock)."""
    _unpin_pending.extend(sids_map.values())
    sids_map.clear()


def _unpin(pin: tuple, sid: int) -> None:
    """Dissolve this thread's pin ``pin`` (a ``conn_key``) on ``sid`` and
    give the socket back to its pool."""
    cache = getattr(_tls_raw, "socks", None)
    if cache is not None and cache.get(pin) == sid:
        del cache[pin]
    return_pooled_socket(sid)


def _drain_unpinned() -> None:
    while True:
        try:
            sid = _unpin_pending.popleft()
        except IndexError:
            return
        s = Socket.address(sid)
        if s is not None and not s.failed:
            return_pooled_socket(sid)


_drain_task = None
_drain_task_lock = threading.Lock()


def _ensure_drain_task() -> None:
    global _drain_task
    if _drain_task is None:
        with _drain_task_lock:
            if _drain_task is None:
                from ..butil.periodic_task import PeriodicTask
                _drain_task = PeriodicTask(5.0, _drain_unpinned)


class _PinnedSocks(dict):
    """A thread's {conn_key: sid} pins; when the thread dies, a finalizer
    over a plain mirror parks its sockets for the pool."""

    def __init__(self):
        super().__init__()
        self._mirror: dict = {}
        self._finalizer = weakref.finalize(self, _unpin_all, self._mirror)
        _ensure_drain_task()

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self._mirror[k] = v

    def __delitem__(self, k):
        super().__delitem__(k)
        self._mirror.pop(k, None)

    def pop(self, k, *default):
        self._mirror.pop(k, None)
        return super().pop(k, *default)


def _raw_socket(pin: tuple):
    """This thread's pinned pooled connection under ``pin`` (a
    ``conn_key``, no TLS): ``(sid, sock)``, sock None when the connect
    failed."""
    if _unpin_pending:
        _drain_unpinned()
    cache = getattr(_tls_raw, "socks", None)
    if cache is None:
        cache = _tls_raw.socks = _PinnedSocks()
    sid = cache.get(pin)
    if sid is not None:
        s = Socket.address(sid)
        if s is not None and s.fd is not None:
            return sid, s
        cache.pop(pin, None)
    remote, _ssl, connect_s, auth = pin
    sid, rc = pooled_socket(remote, None, connect_s, auth)
    s = Socket.address(sid) if rc == 0 else None
    if s is None or s.fd is None:
        return sid, None
    cache[pin] = sid
    return sid, s


def _fail(sock, code: int, text: str) -> None:
    sock.set_failed(code, text)
    sock.release()


def run_raw(channel, method_full: str, payload, attachment=b"",
            timeout_ms: Optional[int] = None):
    """The raw lane: ``(response_view, attachment_view)``, or raises
    RpcError.  One attempt, no retry and no balancer: a single-server
    tpu_std channel without TLS, else the Channel's full path."""
    from .channel import RpcError
    na0 = len(attachment) if attachment is not None else 0
    if len(payload) + na0 + 96 > min(_MAX_BODY, max_body_size()):
        raise RpcError(int(Errno.EREQUEST),
                       "payload + attachment exceeds max body")
    opts = channel.options
    if timeout_ms is None:
        timeout_ms = opts.timeout_ms
    timeout_ms, expired = _cap_timeout_ms(timeout_ms)
    if expired:
        raise RpcError(int(Errno.ERPCTIMEDOUT),
                       "inherited deadline already expired (doomed "
                       "downstream call failed fast)")
    remote = channel.server

    def full_path():
        from .controller import Controller
        cntl = Controller()
        cntl.timeout_ms = timeout_ms
        if na0:
            cntl.request_attachment = bytes(attachment)
        c = channel.call_method(method_full, bytes(payload), cntl=cntl)
        if c.failed:
            raise RpcError(c.error_code, c.error_text)
        return memoryview(c.response), memoryview(
            bytes(c.response_attachment or b""))

    if remote is None or opts.protocol != "tpu_std" or opts.ssl \
            or opts.ssl_context is not None:
        _count("slow_path")
        return full_path()
    tlv = channel_method_tlv(channel, method_full)
    pin = conn_key(remote, None, opts.connect_timeout_ms / 1e3,
                   opts.auth_data or b"")
    sid, sock = _raw_socket(pin)
    if sock is None:
        _breaker_feed(channel, remote, int(Errno.EFAILEDSOCKET))
        raise RpcError(int(Errno.EFAILEDSOCKET),
                       f"connect to {remote} failed")
    if not sock.write_path_idle():
        _unpin(pin, sid)
        _count("slow_path")
        return full_path()
    try:
        out = _raw_pinned(opts, payload, attachment, timeout_ms, sock, tlv)
    except RpcError as e:
        _breaker_feed(channel, remote, e.code)
        raise
    _breaker_feed(channel, remote, 0)
    return out


def _raw_pinned(opts, payload, attachment, timeout_ms, sock, tlv):
    """One raw round trip on the pinned connection: the engine's
    ``raw_call`` (the frame built, written, read and scanned in C), or
    the frame built here and carried by :func:`_round_trip`."""
    from .channel import RpcError
    nat = _native()
    cid = _next_cid()
    auth = opts.auth_data or b""
    if isinstance(auth, str):
        auth = auth.encode()
    wire_att = attachment if attachment is not None and len(attachment) \
        else None
    shm_slot = None
    shm_offered = False
    extra = b""
    if wire_att is not None or sock.shm is not None:
        extra, wire_att, shm_slot, shm_offered = shm_ring.client_prepare(
            sock, wire_att)
    tmo = int(timeout_ms) if timeout_ms and timeout_ms > 0 else 0
    try:
        if nat is not None and not (auth and sock.app_data is None):
            _own(sock)
            with sock._write_lock:
                ack0 = sock._take_ack_frame()
                _count("raw_call")
                ok, buf, nval, dom, acks = nat.raw_call(
                    sock.fd.fileno(), tlv + extra, payload, wire_att, tmo,
                    cid, ack0)
        else:
            na = len(wire_att) if wire_att is not None else 0
            mb = TLV_CORRELATION + struct.pack("<Q", cid)
            if na:
                mb += TLV_ATTACHMENT + struct.pack("<I", na)
            mb += tlv + extra
            sent_auth = bool(auth) and sock.app_data is None
            if sent_auth:
                mb += encode_tlv(TAG_AUTH, auth)
            if tmo:
                mb += TLV_TIMEOUT + struct.pack("<I", tmo)
            head = _MAGIC + struct.pack("<II", len(mb) + len(payload) + na,
                                        len(mb))
            parts = (head, mb, payload) + ((wire_att,) if na else ())
            buf, nval, acks = _round_trip(nat, sock, parts,
                                          tmo / 1e3 if tmo else -1.0)
            scan = _scan_raw_resp(memoryview(buf)[:nval])
            ok = scan is not None and scan[0] == cid
            dom = scan[2] if ok else None
            if ok:
                if sent_auth:
                    sock.app_data = "authed"
                body = memoryview(buf)[nval:]
                buf, nval = bytes(body), scan[1]
    except TimeoutError:
        shm_ring.client_complete(shm_slot)
        _fail(sock, int(Errno.ERPCTIMEDOUT), "rpc timeout")
        raise RpcError(int(Errno.ERPCTIMEDOUT),
                       f"deadline {timeout_ms}ms exceeded") from None
    except (ConnectionError, ValueError, OSError) as e:
        shm_ring.client_complete(shm_slot)
        _fail(sock, int(Errno.EFAILEDSOCKET), str(e))
        raise RpcError(int(Errno.EFAILEDSOCKET), str(e)) from None
    if acks:
        process_ack(acks, sock)
    if ok:
        if shm_slot is not None or shm_offered:
            shm_ring.client_complete(shm_slot)
            if shm_offered:
                shm_ring.client_saw_plain_response(sock)
        if dom:
            sock.ici_peer_domain = dom
        body = memoryview(buf)
        if nval:
            return body[:len(body) - nval], body[len(body) - nval:]
        return body, memoryview(b"")
    # an unusual response: errors, shm negotiation and descriptors
    mv = memoryview(buf)
    meta = RpcMeta.decode(bytes(mv[:nval]))
    if meta is None or meta.correlation_id != cid:
        shm_ring.client_complete(shm_slot)
        _fail(sock, int(Errno.ERESPONSE), "undecodable response meta")
        raise RpcError(int(Errno.ERESPONSE), "undecodable response")
    view = settle = None
    if meta.shm_offer or meta.shm_accept or meta.shm_desc \
            or shm_offered or shm_slot is not None:
        try:
            view, settle = shm_ring.client_on_response_meta(
                sock, meta, offered_now=shm_offered and not meta.error_code,
                staged_slot=shm_slot)
        except shm_ring.ShmDescriptorError as e:
            _fail(sock, int(Errno.ERESPONSE), str(e))
            raise RpcError(int(Errno.ERESPONSE), str(e)) from None
    _mark_lame(meta, sock.remote_side)
    if meta.error_code:
        ack_unused(meta, sock.id)
        if meta.error_code == int(Errno.ERPCAUTH):
            _fail(sock, meta.error_code, meta.error_text)
        raise RpcError(meta.error_code, meta.error_text)
    if auth and sock.app_data is None:
        sock.app_data = "authed"    # a success: the credentials passed
    if meta.ici_domain:
        sock.ici_peer_domain = meta.ici_domain
    body = mv[nval:]
    ratt = memoryview(b"")
    if view is not None:
        # the view aliases a ring slot recycled at this thread's next
        # call on the pinned connection: consume or copy it before then
        shm_ring.defer_settle(sock, settle)
        ratt = view
    natt = meta.attachment_size
    if natt:
        if natt > len(body):
            _fail(sock, int(Errno.ERESPONSE), "attachment size exceeds body")
            raise RpcError(int(Errno.ERESPONSE),
                           "attachment size exceeds body")
        ratt = body[len(body) - natt:]
        body = body[:len(body) - natt]
    return body, ratt


# -- the pipelined batch ------------------------------------------------------

def run_batch(channel, method_full: str, requests, response_type: Any,
              timeout_ms: Optional[int], method_tlvs: bytes) -> list:
    """Pipelined unary calls on one pooled connection, matched by
    correlation id; raises RpcError on the first failed call or on a
    transport failure."""
    from ..protocol.tpu_std import serialize_payload
    from .channel import RpcError
    if not requests:
        return []
    if timeout_ms is None:
        timeout_ms = channel.options.timeout_ms
    timeout_ms, expired = _cap_timeout_ms(timeout_ms)
    if expired:
        raise RpcError(int(Errno.ERPCTIMEDOUT),
                       "inherited deadline already expired (doomed "
                       "downstream batch failed fast)")
    remote = channel.server
    if remote is None:
        # a cluster channel: one call per request
        return [channel.call(method_full, r, timeout_ms=timeout_ms,
                             response_type=response_type)
                for r in requests]
    pls = [serialize_payload(r) for r in requests]
    auth = channel.options.auth_data or b""
    if isinstance(auth, str):
        auth = auth.encode()
    sid, rc = pooled_socket(remote, None,
                            channel.options.connect_timeout_ms / 1e3, auth)
    sock = Socket.address(sid) if rc == 0 else None
    if sock is None or sock.fd is None:
        raise RpcError(int(Errno.EFAILEDSOCKET),
                       f"connect to {remote} failed")
    if not sock.write_path_idle():
        return_pooled_socket(sid)
        return [channel.call(method_full, r, timeout_ms=timeout_ms,
                             response_type=response_type)
                for r in requests]
    tmo_tlv = TLV_TIMEOUT + struct.pack("<I", max(1, timeout_ms)) \
        if timeout_ms and timeout_ms > 0 else b""
    auth_tlv = b""
    if auth and sock.app_data is None:
        # on the first frame; marked once the server accepted it
        auth_tlv = encode_tlv(TAG_AUTH, auth)
    timeout_s = timeout_ms / 1e3 if timeout_ms and timeout_ms > 0 else -1.0
    nat = _native()
    base = reserve_cids(len(pls))
    _own(sock)
    try:
        with sock._write_lock:
            ack0 = sock._take_ack_frame() or b""
            if nat is not None:
                _count("call_batch")
                results, acks = nat.call_batch(
                    sock.fd.fileno(), method_tlvs + tmo_tlv, pls, timeout_s,
                    base, auth_tlv, ack0)
                frames = [(r, None) if type(r) is not tuple else r
                          for r in results]
            else:
                frames, acks = [], []
                for i, pb in enumerate(pls):
                    mb = TLV_CORRELATION + struct.pack("<Q", base + i) \
                        + method_tlvs + (auth_tlv if i == 0 else b"") \
                        + tmo_tlv
                    head = _MAGIC + struct.pack("<II", len(mb) + len(pb),
                                                len(mb))
                    view, msize, got = _py_sync_call(
                        sock, (ack0 if i == 0 else b"") + head + mb + pb,
                        timeout_s)
                    acks.extend(got)
                    frames.append((view, msize))
    except (TimeoutError, ConnectionError, ValueError, OSError) as e:
        _fail(sock, int(Errno.EFAILEDSOCKET), str(e))
        code = Errno.ERPCTIMEDOUT if isinstance(e, TimeoutError) \
            else Errno.EFAILEDSOCKET
        raise RpcError(int(code), str(e)) from None
    if acks:
        process_ack(acks, sock)
    by_cid = {}
    first_error = None
    for i, (buf, msize) in enumerate(frames):
        if msize is None:
            # the engine's plain success, in request order
            by_cid[base + i] = bytes(buf)
            continue
        mv = memoryview(buf)
        meta = RpcMeta.decode(bytes(mv[:msize]))
        if meta is None:
            _fail(sock, int(Errno.ERESPONSE), "undecodable batch response")
            raise RpcError(int(Errno.ERESPONSE),
                           "undecodable batch response")
        ack_unused(meta, sid)    # the batch lane redeems no descriptor
        _mark_lame(meta, sock.remote_side)
        if meta.error_code:
            if first_error is None:
                first_error = (meta.error_code, meta.error_text)
            by_cid[meta.correlation_id] = None
            continue
        body = mv[msize:]
        if meta.attachment_size > len(body):
            _fail(sock, int(Errno.ERESPONSE), "attachment size exceeds body")
            raise RpcError(int(Errno.ERESPONSE),
                           "attachment size exceeds body")
        by_cid[meta.correlation_id] = bytes(
            body[:len(body) - meta.attachment_size])
    if first_error is not None and first_error[0] == int(Errno.ERPCAUTH):
        _fail(sock, first_error[0], first_error[1])     # refused credentials
    else:
        if auth_tlv and by_cid.get(base) is not None:
            sock.app_data = "authed"
        return_pooled_socket(sid)
    if first_error is not None:
        raise RpcError(first_error[0], first_error[1])
    out = []
    for i in range(len(pls)):
        if base + i not in by_cid:
            raise RpcError(int(Errno.ERESPONSE),
                           "batch response missing a correlation id")
        out.append(parse_payload(by_cid[base + i], response_type))
    return out


# -- the scatter fan-out ------------------------------------------------------

def run_scatter(branches, timeout_ms: Optional[int]) -> bool:
    """The ``ParallelChannel``'s fan-out: every branch's request written
    before the first response is read, from this thread.  ``branches``:
    ``(channel, cntl, method_full, request, response_type)``.  False
    (nothing sent, the reason counted) when a branch is ineligible: the
    caller falls back to a thread per branch.  True: every branch's cntl
    is complete (no retries: the fail limit is the recovery)."""
    for channel, cntl, _m, request, _r in branches:
        if not eligible(channel, cntl):
            return _scatter_fallback("ineligible_cntl")
        if channel.load_balancer is not None:
            return _scatter_fallback("load_balancer")
        if cntl.request_device_attachment is not None:
            return _scatter_fallback("device_attachment")
        if not isinstance(request, (bytes, bytearray, memoryview)):
            return _scatter_fallback("nonbytes_request")
    for channel, cntl, method_full, _req, _r in branches:
        if cntl.trace_id:
            # each branch opens its own client span under the root, and
            # its own span id rides the wire
            cntl._begin_trace_span(method_full)
    nat = _native()
    if nat is not None and _scatter_native(branches, timeout_ms, nat):
        return True
    inflight = []
    for channel, cntl, method_full, request, rtype in branches:
        opts = channel.options
        if cntl.timeout_ms is None:
            cntl.timeout_ms = timeout_ms or opts.timeout_ms
        cntl.connection_type = cntl.connection_type or opts.connection_type
        begin = _mono_ns() // 1000
        remote = channel.server
        cntl.remote_side = remote
        cntl._channel = channel
        pooled = cntl.connection_type == "pooled"
        connect_s = opts.connect_timeout_ms / 1e3
        auth = opts.auth_data or b""
        if isinstance(auth, str):
            auth = auth.encode()
        sid, rc = pooled_socket(remote, None, connect_s, auth) if pooled \
            else short_socket(remote, None, connect_s)
        sock = Socket.address(sid) if rc == 0 else None
        if sock is None or sock.fd is None or not sock.write_path_idle():
            if sock is not None:
                sock.release()
            _finish(channel, cntl, Errno.EFAILEDSOCKET,
                    f"connect to {remote} failed", begin)
            continue
        cid = _next_cid()
        mb = TLV_CORRELATION + struct.pack("<Q", cid) \
            + channel_method_tlv(channel, method_full)
        sent_auth = bool(auth) and sock.app_data is None
        if sent_auth:
            mb += encode_tlv(TAG_AUTH, auth)
        if cntl.timeout_ms and cntl.timeout_ms > 0:
            mb += TLV_TIMEOUT + struct.pack("<I", int(cntl.timeout_ms))
        if cntl.trace_id:
            mb += TLV_TRACE + struct.pack("<Q", cntl.trace_id)
            if cntl.span_id:
                mb += TLV_SPAN + struct.pack("<Q", cntl.span_id)
        frame = (_MAGIC + struct.pack("<II", len(mb) + len(request), len(mb))
                 + mb + bytes(request))
        _own(sock)
        try:
            with sock._write_lock:
                ack0 = sock._take_ack_frame()
                sock.conn.settimeout((cntl.timeout_ms or 1000) / 1e3)
                sock.conn.sendall((ack0 or b"") + frame)
        except OSError as e:
            _fail(sock, int(Errno.EFAILEDSOCKET), str(e))
            _finish(channel, cntl, Errno.EFAILEDSOCKET, f"send: {e}", begin)
            continue
        inflight.append((channel, cntl, sock, pooled, cid, rtype, begin,
                         sent_auth))
    for channel, cntl, sock, pooled, cid, rtype, begin, sent_auth \
            in inflight:
        timeout_s = max(0.001, (cntl.timeout_ms or 1000) / 1e3
                        - (_mono_ns() // 1000 - begin) / 1e6)
        try:
            buf, meta_size, acks = _round_trip(nat, sock, (), timeout_s)
            if acks:
                process_ack(acks, sock)
        except TimeoutError:
            _fail(sock, int(Errno.ERPCTIMEDOUT), "rpc timeout")
            _finish(channel, cntl, Errno.ERPCTIMEDOUT,
                    f"deadline {cntl.timeout_ms}ms exceeded", begin)
            continue
        except (ConnectionError, ValueError, OSError) as e:
            _fail(sock, int(Errno.EFAILEDSOCKET), str(e))
            _finish(channel, cntl, Errno.EFAILEDSOCKET, str(e), begin)
            continue
        done, code, text = _handle_response(channel, cntl, sock, pooled,
                                            buf, meta_size, cid, rtype,
                                            begin, sent_auth=sent_auth)
        if not done:
            _finish(channel, cntl, code, text, begin)
    return True


_SC_ERRNO = {1: Errno.ERPCTIMEDOUT, 2: Errno.EFAILEDSOCKET,
             3: Errno.ERESPONSE}


def _scatter_native(branches, timeout_ms: Optional[int], nat) -> bool:
    """The fan-out in one engine call (``scatter_call``) on the pinned
    connections.  False (nothing written) when this call's shape needs
    the per-branch path: first-call auth, mixed deadlines, a repeated
    remote, a busy or failed connection."""
    screened = []
    seen = set()
    deadlines = set()
    for channel, cntl, method_full, request, rtype in branches:
        opts = channel.options
        if opts.auth_data:
            return _scatter_fallback("auth_on_first")
        if len(request) + 96 > min(_MAX_BODY, max_body_size()):
            return _scatter_fallback("oversized_request")
        if cntl.timeout_ms is None:
            cntl.timeout_ms = timeout_ms or opts.timeout_ms
        # one deadline covers the read loop: branches with different
        # deadlines keep the per-branch path
        deadlines.add(cntl.timeout_ms)
        if len(deadlines) > 1:
            return _scatter_fallback("mixed_deadlines")
        cntl.connection_type = cntl.connection_type or opts.connection_type
        remote = channel.server
        if remote is None:
            return _scatter_fallback("no_single_server")
        if remote in seen:
            return _scatter_fallback("repeated_remote")
        seen.add(remote)
        cntl.remote_side = remote
        cntl._channel = channel
        pin = conn_key(remote, None, opts.connect_timeout_ms / 1e3)
        sid, sock = _raw_socket(pin)
        if sock is None:
            return _scatter_fallback("connect_failed")
        if not sock.write_path_idle():
            _unpin(pin, sid)
            return _scatter_fallback("socket_busy")
        screened.append((channel, cntl, sock, method_full, request, rtype))
    domain = local_domain_id() if ici_enabled() else b""
    prep = []
    items = []
    timeout_s = 0.001
    begin = _mono_ns() // 1000
    for channel, cntl, sock, method_full, request, rtype in screened:
        # the per-socket tail cache keys on (method, tenant): a socket is
        # shared by channels whose tenants differ
        key = (method_full, channel.options.tenant)
        tails = sock._cntl_tails
        if tails is None:
            tails = sock._cntl_tails = {}
        tail = tails.get(key)
        if tail is None:
            tail = channel_method_tlv(channel, method_full)
            if domain:
                tail = (tail + _domain_tlv(domain)
                        + encode_tlv(TAG_ICI_CONN, conn_nonce_of(sock)))
            tails[key] = tail
        if cntl.trace_id:
            tail = tail + TLV_TRACE + struct.pack("<Q", cntl.trace_id)
            if cntl.span_id:
                tail += TLV_SPAN + struct.pack("<Q", cntl.span_id)
        cid = _next_cid()
        _own(sock)
        sock._write_lock.acquire()
        items.append((sock.fd.fileno(), tail, request, None, cid,
                      sock._take_ack_frame()))
        prep.append((channel, cntl, sock, cid, rtype))
        timeout_s = max(timeout_s, (cntl.timeout_ms or 1000) / 1e3)
    try:
        _count("scatter_call")
        results = nat.scatter_call(items, timeout_s)
    except Exception as e:
        # frames may be partly written: no pinned connection is trusted
        for channel, cntl, sock, cid, rtype in prep:
            sock._write_lock.release()
            _fail(sock, int(Errno.EFAILEDSOCKET), str(e))
            _finish(channel, cntl, Errno.EFAILEDSOCKET, str(e), begin)
        return True
    for channel, cntl, sock, cid, rtype in prep:
        sock._write_lock.release()
    for (channel, cntl, sock, cid, rtype), res in zip(prep, results):
        ok = res[0]
        if ok is None:
            errkind, text = res[1], res[2]
            code = _SC_ERRNO.get(errkind, Errno.EFAILEDSOCKET)
            _fail(sock, int(code), text)
            if errkind == 1:
                _finish(channel, cntl, Errno.ERPCTIMEDOUT,
                        f"deadline {cntl.timeout_ms}ms exceeded", begin)
            else:
                _finish(channel, cntl, code, text, begin)
            continue
        if res[4]:
            process_ack(res[4], sock)
        if ok:
            buf, natt, dom = res[1], res[2], res[3]
            if dom:
                sock.ici_peer_domain = dom
            body = memoryview(buf)
            split = len(body) - natt
            try:
                cntl.response = parse_payload(bytes(body[:split]), rtype)
            except Exception as e:
                _finish(channel, cntl, Errno.ERESPONSE,
                        f"response parse failed: {e}", begin)
                continue
            cntl.response_attachment = bytes(body[split:])
            _finish(channel, cntl, 0, "", begin)
            continue
        # an unusual response: full decode; a healthy frame leaves the
        # connection pinned
        done, code, text = _handle_response(channel, cntl, sock, True,
                                            res[1], res[2], cid, rtype,
                                            begin, put_back=lambda: None)
        if not done:
            _finish(channel, cntl, code, text, begin)
    return True
