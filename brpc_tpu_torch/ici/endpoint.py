"""IciEndpoint -- per-connection device data plane with window + ack flow
control.  The port of ``brpc_tpu/ici/endpoint.py``.

- Posting a tensor counts its bytes against ``ici_window_bytes`` on the
  connection; the receiver's redemption sends a "TICI" ack frame on the
  same connection; the ack returns the credit and releases the tensor.
- Send path: when the peer's domain (learned from RpcMeta on the first
  exchange) is reachable by the in-process fabric, the tensor goes as a
  ``KIND_INPROC`` descriptor and stays where it is; when it names this
  card from another process and this process's transfer fabric is up
  (``ici_transfer_enabled``), the tensor goes as a ``KIND_TRANSFER``
  descriptor carrying its CUDA IPC export; otherwise its bytes ride the
  regular attachment (the fallback, also taken when ``ici_enabled`` is
  off).
- Receive path: ``KIND_TRANSFER`` is pulled into a fresh tensor through
  the transfer fabric, and acked once the copy is done and the mapping
  closed.  An ``extra`` that is not the port's export blob raises.
- Acks release on the in-process fabric first, then on the transfer
  fabric; the dead-connection and TTL sweeps run on both (the JAX package
  sweeps only its in-process fabric).
- TICI frames are packed and read by ``protocol/tpu_std.py``; the
  connection's ack queue is ``transport/socket.py``'s.  :data:`ICI_ACK`
  registers them with the ``InputMessenger`` (inline) for the
  connections the dispatcher reads, as the JAX module does.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import weakref
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..butil.flags import define_flag, get_flag
from ..ops.device_ops import bytes_to_tensor, dtype_name, tensor_bytes
from ..protocol.base import (ParseResult, Protocol, ProtocolType,
                             register_protocol)
from ..protocol.tpu_std import ACK_HEADER_SIZE, ACK_MAGIC, max_body_size
from ..transport.socket import Socket
from .attachment import (KIND_INLINE, KIND_INPROC, KIND_TRANSFER,
                         DeviceAttachment, decode_descriptor,
                         encode_descriptor)
from .fabric import (decode_export_blob, in_process_fabric,
                     installed_transfer_fabric, peer_transfer_addr,
                     transfer_fabric)

LOG = logging.getLogger(__name__)

define_flag("ici_enabled", True,
            "exchange ICI domains and send device attachments "
            "device-resident when peers share a fabric",
            validator=lambda v: True)       # reloadable on/off switch
define_flag("ici_window_bytes", 256 * 1024 * 1024,
            "max posted-but-unacked device payload bytes per connection",
            validator=lambda v: int(v) > 0)
define_flag("ici_desc_ttl_s", 120,
            "reclaim posted descriptors never redeemed after this many "
            "seconds", validator=lambda v: int(v) > 0)


def ici_enabled() -> bool:
    return bool(get_flag("ici_enabled", True))


class IciEndpoint:
    """Sender-side window accounting for one connection, created on its
    first device-attachment send."""

    __slots__ = ("socket_id", "_lock", "_cond", "outstanding_bytes",
                 "posted_count", "acked_count", "__weakref__")

    def __init__(self, socket_id: int):
        self.socket_id = socket_id
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.outstanding_bytes = 0
        self.posted_count = 0
        self.acked_count = 0

    def post(self, tensor: Any, nbytes: int, timeout_s: float = 30.0,
             conn_key=None, fabric=None) -> Optional[int]:
        """Reserve window credit and post to ``fabric`` (default: the
        in-process one).  Returns the descriptor id, or None if the window
        stayed full for ``timeout_s`` (the EOVERCROWDED case).  A payload
        larger than the whole window is admitted when nothing else is in
        flight."""
        _ensure_sweeper()
        window = int(get_flag("ici_window_bytes", 256 * 1024 * 1024))
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self.outstanding_bytes + nbytes <= window
                or self.outstanding_bytes == 0, timeout=timeout_s)
            if not ok:
                return None
            self.outstanding_bytes += nbytes
            self.posted_count += 1
        try:
            return (fabric or in_process_fabric()).post(
                tensor, nbytes, self._on_release, socket_id=self.socket_id,
                conn_key=conn_key)
        except BaseException:
            self._on_release(nbytes)        # a failed export takes no credit
            raise

    def _on_release(self, nbytes: int) -> None:
        with self._cond:
            self.outstanding_bytes -= nbytes
            self.acked_count += 1
            self._cond.notify_all()


_endpoints: "weakref.WeakSet[IciEndpoint]" = weakref.WeakSet()


def endpoint_of(sock: Socket) -> IciEndpoint:
    ep = sock.ici_endpoint
    if ep is None:
        ep = sock.ici_endpoint = IciEndpoint(sock.id)
        _endpoints.add(ep)
    return ep


def live_endpoints() -> List[IciEndpoint]:
    """All endpoints that ever posted and are still referenced."""
    return list(_endpoints)


# -- send path -------------------------------------------------------------

_LOOPBACK_HOSTS = ("127.0.0.1", "::1", "localhost")
_nonce_init_lock = threading.Lock()


def _is_local_peer(sock) -> bool:
    """In-process reach also needs a loopback peer address: a remote peer
    replaying our domain token must not steer us onto descriptors it can
    never redeem."""
    ep = sock.remote_side
    return ep is not None and str(getattr(ep, "host", "")) in _LOOPBACK_HOSTS


def conn_nonce_of(sock) -> bytes:
    """The initiator's connection nonce: made on the client socket at its
    first use, carried in every ici-enabled request meta, and pinned by
    the server from the first frame that carries it."""
    tok = sock.ici_conn_token
    if tok is None:
        with _nonce_init_lock:
            tok = sock.ici_conn_token
            if tok is None:
                tok = sock.ici_conn_token = os.urandom(8)
    return tok


def conn_key_of(sock):
    """Connection identity both ends compute alike: the connection nonce
    once exchanged, else the unordered (local, remote) address pair.  A
    descriptor binds to the connection it was posted for."""
    tok = sock.ici_conn_token
    if tok is not None:
        return tok
    local, remote = sock.local_side, sock.remote_side
    if local is None or remote is None:
        return None

    def norm(h: str) -> str:
        return "127.0.0.1" if h in ("0.0.0.0", "::", "localhost") else h

    a = (norm(str(local.host)), int(local.port))
    b = (norm(str(remote.host)), int(remote.port))
    return (a, b) if a <= b else (b, a)


def _tensor_meta(t: torch.Tensor) -> Tuple[int, str, Tuple[int, ...]]:
    return (t.numel() * t.element_size(), dtype_name(t.dtype),
            tuple(int(s) for s in t.shape))


def prepare_send(sock, meta, tensor, timeout_s: float = 30.0):
    """Route a device attachment for sending: a descriptor (the tensor
    stays put) or its bytes (the fallback).  Sets ``meta.ici_desc`` and
    returns the bytes to append to the frame's attachment (None for a
    descriptor).  Raises RuntimeError when the window stays full past
    ``timeout_s``, and before any credit or staging is spent for a payload
    that no frame can carry: 4 GiB and up (the descriptor's size field is
    u32), or, inline, the frame cap."""
    if not isinstance(tensor, torch.Tensor):
        tensor = torch.from_numpy(np.array(tensor))
    nbytes, dtype, shape = _tensor_meta(tensor)
    if nbytes >= 1 << 32:
        raise RuntimeError(
            f"device attachment of {nbytes} bytes exceeds the 4GiB "
            "frame limit -- shard it or use streaming")
    peer = sock.ici_peer_domain
    conn_key = conn_key_of(sock)
    if ici_enabled() and peer is not None \
            and in_process_fabric().can_reach(peer) \
            and _is_local_peer(sock) and conn_key is not None:
        desc_id = endpoint_of(sock).post(tensor, nbytes,
                                         timeout_s=timeout_s,
                                         conn_key=conn_key)
        if desc_id is None:
            raise RuntimeError(
                "ICI window full: posted device payloads awaiting ack "
                f"exceed ici_window_bytes on socket {sock.id}")
        meta.ici_desc = encode_descriptor(KIND_INPROC, desc_id, nbytes,
                                          dtype, shape)
        return None
    # another process on this card: the payload moves device to device
    # over CUDA IPC; descriptors and acks ride the connection as usual
    xfab = transfer_fabric() if ici_enabled() and nbytes \
        and peer_transfer_addr(peer) is not None else None
    if xfab is not None and xfab.can_reach(peer):
        desc_id = endpoint_of(sock).post(tensor, nbytes,
                                         timeout_s=timeout_s, fabric=xfab)
        if desc_id is None:
            raise RuntimeError(
                "ICI window full: posted device payloads awaiting ack "
                f"exceed ici_window_bytes on socket {sock.id}")
        meta.ici_desc = encode_descriptor(KIND_TRANSFER, desc_id, nbytes,
                                          dtype, shape,
                                          extra=xfab.export_blob(desc_id))
        return None
    limit = max_body_size()
    if nbytes >= limit:
        raise RuntimeError(
            f"device attachment of {nbytes} bytes cannot ride inline: "
            f"frames carry at most {limit} bytes, and the peer is "
            "not reachable device-resident")
    # fallback: one D2H copy, bytes ride the regular attachment
    data, dtype, shape = tensor_bytes(tensor)
    meta.ici_desc = encode_descriptor(KIND_INLINE, 0, nbytes, dtype, shape)
    return data


def split_device_attachment(meta, attachment: bytes, socket_id: int
                            ) -> Tuple[bytes, Optional[DeviceAttachment]]:
    """Receiver side: if the frame carries a device attachment, split its
    bytes (inline fallback) off the end of ``attachment``.  Returns
    ``(user_attachment, device_attachment_or_None)``; a malformed or
    unknown descriptor is dropped."""
    if not meta.ici_desc:
        return attachment, None
    try:
        kind, desc_id, nbytes, dtype, shape, extra = \
            decode_descriptor(meta.ici_desc)
    except (struct.error, IndexError, UnicodeDecodeError):
        return attachment, None          # malformed wire field: drop
    if kind not in (KIND_INLINE, KIND_INPROC, KIND_TRANSFER):
        return attachment, None          # unknown kind: drop
    host_bytes = None
    if kind == KIND_INLINE:
        if nbytes > len(attachment):
            return attachment, None      # malformed; drop the handle
        keep = len(attachment) - nbytes
        host_bytes = memoryview(attachment)[keep:]
        attachment = attachment[:keep]
    return attachment, DeviceAttachment(
        kind, desc_id, nbytes, dtype, shape, socket_id=socket_id,
        host_bytes=host_bytes, extra=extra)


# -- redeem path -----------------------------------------------------------

def redeem_attachment(att: DeviceAttachment, device=None):
    """Land the attachment as a tensor (``device`` None: a descriptor's
    tensor where it was posted, inline bytes on the CPU); acks the poster
    for a descriptor."""
    if att.kind == KIND_INPROC:
        sock = Socket.address(att._socket_id)
        key = conn_key_of(sock) if sock is not None else None
        t = in_process_fabric().redeem(att.desc_id, device, conn_key=key)
        if t is None:
            raise RuntimeError(
                f"ICI descriptor {att.desc_id} expired, already redeemed, "
                "or bound to a different connection")
        _send_ack(att._socket_id, (att.desc_id,))
        return t
    if att.kind == KIND_TRANSFER:
        blob = decode_export_blob(att._extra)
        if (blob.dtype, blob.shape) != (att.dtype, tuple(att.shape)):
            raise RuntimeError(
                f"transfer descriptor {att.desc_id}: its export is a "
                f"{blob.dtype} {blob.shape}, the descriptor says "
                f"{att.dtype} {tuple(att.shape)}")
        fab = transfer_fabric()
        if fab is None:
            raise RuntimeError(
                "the peer sent a transfer descriptor but this process has "
                "no transfer fabric (set ici_transfer_enabled)")
        t = fab.redeem(blob, att.desc_id, device)
        _send_ack(att._socket_id, (att.desc_id,))
        return t
    return bytes_to_tensor(att._host_bytes, att.dtype, att.shape,
                           device=device if device is not None else "cpu")


# -- acks ------------------------------------------------------------------

def _send_ack(socket_id: int, desc_ids) -> None:
    """Queue the credit return on the connection (transport/socket.py)."""
    sock = Socket.address(socket_id)
    if sock is None or sock.failed:
        return                      # the poster's TTL sweep reclaims
    sock.queue_ack(desc_ids)


def ack_unused(meta, socket_id: int) -> None:
    """Return window credit for a descriptor the receiver discards
    without redeeming (an error response, a stale response)."""
    if not meta.ici_desc:
        return
    try:
        kind, desc_id = decode_descriptor(meta.ici_desc)[:2]
    except (struct.error, IndexError, UnicodeDecodeError):
        return
    if kind in (KIND_INPROC, KIND_TRANSFER):
        _send_ack(socket_id, (desc_id,))


def process_ack(desc_ids, sock) -> None:
    """An inbound TICI frame: release each descriptor on the in-process
    fabric, else on the transfer fabric, only if it was posted on this
    connection (forged acks are dropped)."""
    fabric = in_process_fabric()
    xfab = installed_transfer_fabric()
    sid = getattr(sock, "id", None)
    for desc_id in desc_ids:
        if not fabric.release(desc_id, only_socket=sid) \
                and xfab is not None:
            xfab.release(desc_id, only_socket=sid)


def _parse_ack(source, sock, read_eof: bool, arg) -> ParseResult:
    """One TICI frame off an ``InputMessenger``'s portal: its ids."""
    avail = len(source)
    if avail < ACK_HEADER_SIZE:
        if ACK_MAGIC.startswith(source.fetch(min(4, avail))):
            return ParseResult.not_enough_data()
        return ParseResult.try_others()
    head = source.fetch(ACK_HEADER_SIZE)
    if head[:4] != ACK_MAGIC:
        return ParseResult.try_others()
    (count,) = struct.unpack_from("<I", head, 4)
    if count > 1 << 20:
        return ParseResult.absolutely_wrong()
    if avail < ACK_HEADER_SIZE + 8 * count:
        return ParseResult.not_enough_data()
    source.pop_front(ACK_HEADER_SIZE)
    ids = struct.unpack(f"<{count}Q", source.fetch(8 * count))
    source.pop_front(8 * count)
    return ParseResult.make_message(ids)


# the dispatcher-read connections' TICI frames, on both sides, inline on
# the reading fiber (a few dict operations; never blocks)
ICI_ACK = Protocol(
    ProtocolType.ICI_ACK, "ici_ack", _parse_ack,
    process_request=lambda ids, sock, server: process_ack(ids, sock),
    process_response=process_ack,
    process_inline=True)
register_protocol(ICI_ACK)


# -- descriptor TTL sweep --------------------------------------------------

_sweeper: Optional[threading.Thread] = None
_sweep_lock = threading.Lock()


def _ensure_sweeper() -> None:
    """Start the TTL sweep (a daemon thread) on the first post."""
    global _sweeper
    with _sweep_lock:
        if _sweeper is not None:
            return
        _sweeper = threading.Thread(target=_sweep_loop, name="ici-ttl-sweep",
                                    daemon=True)
    _sweeper.start()


def _sweep_loop() -> None:
    wake = threading.Event()
    while True:
        ttl = float(get_flag("ici_desc_ttl_s", 120))
        wake.wait(max(ttl / 4, 5.0))
        n = in_process_fabric().sweep_expired(ttl)
        xfab = installed_transfer_fabric()
        if xfab is not None:
            n += xfab.sweep_expired(ttl)
        if n:
            LOG.warning("ICI ttl sweep reclaimed %d descriptors", n)
