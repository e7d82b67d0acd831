"""Transfer fabrics -- how a posted device tensor reaches its redeemer.

The port of ``brpc_tpu/ici/fabric.py``.  The fabric owns the payload; the
endpoint (``endpoint.py``) owns per-connection descriptors and flow
control.  Two fabrics share one registry (:class:`_Registry`: post,
release, the dead-connection and TTL sweeps):

- :class:`InProcessFabric` serves peers in one process: ``post`` parks
  the tensor and ``redeem`` hands the same tensor back (moved to another
  device only when asked).
- :class:`CudaIpcFabric` serves peers in other processes on the same
  card, behind ``KIND_TRANSFER`` (the JAX package's ``JaxTransferFabric``
  over the PJRT transfer server): ``post`` exports the tensor's memory
  over CUDA IPC (``cuda_ipc.py``) and keeps the tensor alive until the
  ack; the export blob rides the descriptor's ``extra``; ``redeem`` maps
  the export in the peer process, copies it into a fresh tensor (the
  receiver owns a new array, as after the JAX pull), finishes the copy
  and unmaps before the ack goes out.  It runs only where
  ``ici_transfer_enabled`` is on (default off, as in the JAX package).

A *domain id* names the reach of a fabric: peers exchange domain ids in
RpcMeta and go device-resident only when an installed fabric can bridge
the two.  A domain is ``token@address`` when this process's transfer
fabric is up, else the token alone.  The port's address names the host
and the card (``cuda-ipc/<host>/<GPU UUID>``), so reach is decidable: a
peer whose address does not parse as one (a JAX PJRT address) or names
another host or card is not reachable, and attachments to it go inline.

The trust model is the JAX package's: the exchange is cooperative;
redemption is bound to the connection the descriptor was posted for,
acks from other connections are rejected, a dead connection's
descriptors are reclaimed, the in-process path also needs a loopback
peer, and the TTL sweep is the backstop.  Unlike the JAX transfer
fabric, :class:`CudaIpcFabric` is swept too (a dead or silent peer would
otherwise pin the posted tensor's HBM for the life of the process), and a
peer's blob is parsed field by field, never unpickled.
"""

from __future__ import annotations

import logging
import math
import os
import socket as _socket_mod
import struct
import threading
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

from ..butil.flags import define_flag, get_flag

LOG = logging.getLogger(__name__)

define_flag("ici_transfer_enabled", False,
            "advertise a CUDA IPC transfer address so peers in OTHER "
            "processes on this card pull device attachments directly",
            validator=lambda v: True)

# Process token: the same token on both ends of a connection means both
# ends share this process, so the in-process fabric bridges them.  The
# JAX token is 16 random bytes, which can hold the "@" a domain is split
# at; the port's token is 16 hex digits, which cannot.  On the wire the
# token stays opaque bytes.
_LOCAL_DOMAIN = os.urandom(8).hex().encode()

_domain_cache: Optional[bytes] = None
_domain_cache_addr: Optional[bytes] = None


def local_domain_id() -> bytes:
    """Domain advertised in RpcMeta: the process token, plus this
    process's transfer address (``token@address``) when the cross-process
    fabric is up.  Probing the fabric here starts it on the first RPC
    after ``ici_transfer_enabled`` is set."""
    global _domain_cache, _domain_cache_addr
    if not get_flag("ici_transfer_enabled", False) and _xfer is None:
        addr = None
    else:
        addr = transfer_ready()
    if _domain_cache is None or addr != _domain_cache_addr:
        _domain_cache_addr = addr
        _domain_cache = _LOCAL_DOMAIN + b"@" + addr if addr \
            else _LOCAL_DOMAIN
    return _domain_cache


def domain_token(domain: bytes) -> bytes:
    return domain.split(b"@", 1)[0]


def peer_transfer_addr(domain: Optional[bytes]) -> Optional[bytes]:
    """The transfer address inside a peer's domain id (None when the peer
    has no cross-process fabric)."""
    if not domain or b"@" not in domain:
        return None
    return domain.split(b"@", 1)[1] or None


# -- the port's transfer address and export blob ----------------------------

_ADDR_PREFIX = b"cuda-ipc/"


def _host_token() -> bytes:
    return _socket_mod.gethostname().encode()[:64]


def ipc_address(host: bytes, gpu_uuid: bytes) -> bytes:
    return _ADDR_PREFIX + host + b"/" + gpu_uuid


def parse_ipc_address(addr: Optional[bytes]) -> Optional[Tuple[bytes, bytes]]:
    """``(host, GPU UUID)`` of a port transfer address, else None."""
    if not addr or not addr.startswith(_ADDR_PREFIX):
        return None
    host, sep, uuid = addr[len(_ADDR_PREFIX):].partition(b"/")
    return (host, uuid) if sep and host and uuid else None


_BLOB_MAGIC = b"CIPC"
_BLOB_VER = 1
_HANDLE = 64                   # cudaIpcMemHandle_t, cudaIpcEventHandle_t


class ExportBlob(NamedTuple):
    """A ``KIND_TRANSFER`` descriptor's ``extra``: where the tensor lives
    (the poster's address, the block's IPC handle and the offset in it),
    the event to wait on, and the tensor's dtype and shape."""
    address: bytes
    mem_handle: bytes
    offset: int
    event_handle: bytes
    dtype: str
    shape: Tuple[int, ...]


def encode_export_blob(b: ExportBlob) -> bytes:
    d = b.dtype.encode()
    return b"".join((
        _BLOB_MAGIC, bytes([_BLOB_VER]),
        struct.pack("<H", len(b.address)), b.address,
        b.mem_handle, struct.pack("<Q", b.offset), b.event_handle,
        bytes([len(d)]), d, bytes([len(b.shape)]),
        b"".join(struct.pack("<Q", n) for n in b.shape)))


def decode_export_blob(data: bytes) -> ExportBlob:
    """Parse a peer's blob, field by field; RuntimeError, naming what
    arrived, when it is not the port's (a JAX transfer address, say)."""
    try:
        if data[:4] != _BLOB_MAGIC or data[4] != _BLOB_VER:
            raise ValueError("bad magic")
        (alen,) = struct.unpack_from("<H", data, 5)
        off = 7
        address = bytes(data[off:off + alen])
        off += alen
        mem_handle = bytes(data[off:off + _HANDLE])
        off += _HANDLE
        (offset,) = struct.unpack_from("<Q", data, off)
        off += 8
        event_handle = bytes(data[off:off + _HANDLE])
        off += _HANDLE
        dlen = data[off]
        dtype = bytes(data[off + 1:off + 1 + dlen]).decode()
        off += 1 + dlen
        ndim = data[off]
        shape = struct.unpack_from(f"<{ndim}Q", data, off + 1)
        off += 1 + 8 * ndim
        if off != len(data) or len(event_handle) != _HANDLE \
                or parse_ipc_address(address) is None:
            raise ValueError("bad layout")
    except (ValueError, IndexError, struct.error, UnicodeDecodeError):
        raise RuntimeError(
            f"KIND_TRANSFER descriptor whose extra {bytes(data[:48])!r} is "
            "not a CUDA IPC export blob of this package; refused") from None
    return ExportBlob(address, mem_handle, offset, event_handle, dtype,
                      tuple(shape))


class PostedEntry:
    __slots__ = ("tensor", "nbytes", "posted_at", "on_release", "socket_id",
                 "conn_key", "export")

    def __init__(self, tensor: Any, nbytes: int, on_release=None,
                 socket_id: int = 0, conn_key=None):
        self.tensor = tensor
        self.nbytes = nbytes
        self.posted_at = time.monotonic()
        self.on_release = on_release
        self.socket_id = socket_id      # poster-local: binds acks
        self.conn_key = conn_key        # connection pair: binds redemption
        self.export = None              # CudaIpcFabric: the IPC export


class _Registry:
    """Posted descriptors: a posted tensor is kept alive and counted
    against its connection's window until the peer acks redemption, its
    connection dies, or the TTL sweep reclaims it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._posted: Dict[int, PostedEntry] = {}
        self._next_id = int.from_bytes(os.urandom(4), "little") | 1
        self.posted_bytes = 0          # live accounting (all connections)

    def _register(self, tensor: Any, nbytes: int, on_release, socket_id: int,
                  conn_key, export=None) -> int:
        with self._lock:
            desc_id = self._next_id
            self._next_id += 1
            entry = self._posted[desc_id] = PostedEntry(
                tensor, nbytes, on_release, socket_id, conn_key)
            entry.export = export
            self.posted_bytes += nbytes
        return desc_id

    def release(self, desc_id: int,
                only_socket: Optional[int] = None) -> bool:
        """Drop the posted ref (descriptor acked or expired).
        ``only_socket`` binds the release to the connection the
        descriptor was posted on: forged acks naming another connection's
        descriptors are refused."""
        with self._lock:
            entry = self._posted.get(desc_id)
            if entry is None:
                return False
            if only_socket is not None and entry.socket_id != only_socket:
                return False
            del self._posted[desc_id]
            self.posted_bytes -= entry.nbytes
        self._on_release(entry)
        return True

    def release_socket(self, socket_id: int) -> int:
        """Reclaim every descriptor posted on a dead connection."""
        with self._lock:
            stale = [i for i, e in self._posted.items()
                     if e.socket_id == socket_id]
        return sum(1 for desc_id in stale if self.release(desc_id))

    def sweep_expired(self, ttl_s: float) -> int:
        """Reclaim descriptors never redeemed within ``ttl_s`` seconds
        (the peer died before acking)."""
        now = time.monotonic()
        with self._lock:
            stale = [i for i, e in self._posted.items()
                     if now - e.posted_at > ttl_s]
        return sum(1 for desc_id in stale if self.release(desc_id))

    @property
    def live_descriptors(self) -> int:
        with self._lock:
            return len(self._posted)

    def _on_release(self, entry: PostedEntry) -> None:
        if entry.on_release is not None:
            try:
                entry.on_release(entry.nbytes)
            except Exception:
                LOG.exception("ici on_release callback raised")


class InProcessFabric(_Registry):
    """Descriptor registry for peers in this process."""

    def can_reach(self, peer_domain: bytes) -> bool:
        return domain_token(peer_domain) == _LOCAL_DOMAIN

    def post(self, tensor: Any, nbytes: int, on_release=None,
             socket_id: int = 0, conn_key=None) -> int:
        return self._register(tensor, nbytes, on_release, socket_id,
                              conn_key)

    def redeem(self, desc_id: int, device: Any = None,
               conn_key=None) -> Optional[Any]:
        """The posted tensor, moved to ``device`` (None: where it was
        posted; on its own device it is the very same object).  An entry
        posted with a connection key needs the same key: a peer forging
        ids from another connection gets None."""
        with self._lock:
            entry = self._posted.get(desc_id)
        if entry is None:
            return None
        if entry.conn_key is not None and conn_key != entry.conn_key:
            LOG.warning("ICI redeem rejected: descriptor %d bound to a "
                        "different connection", desc_id)
            return None
        t = entry.tensor
        return t.to(device) if device is not None else t

    def take(self, desc_id: int, conn_key=None) -> Optional[Any]:
        """Redeem and consume in one step: the caller owns the tensor from
        here on, and a second take of the same descriptor gets None."""
        with self._lock:
            entry = self._posted.get(desc_id)
            if entry is None:
                return None
            if entry.conn_key is not None and conn_key != entry.conn_key:
                LOG.warning("ICI take rejected: descriptor %d bound to "
                            "a different connection", desc_id)
                return None
            del self._posted[desc_id]
            self.posted_bytes -= entry.nbytes
        self._on_release(entry)
        return entry.tensor


class CudaIpcFabric(_Registry):
    """Cross-process fabric over CUDA IPC, for peers on this card: the
    surface of the JAX package's ``JaxTransferFabric`` (``supported``,
    ``start``, ``address``, ``post``, ``redeem``, ``release``,
    ``live_descriptors``) plus the registry's sweeps."""

    def __init__(self):
        super().__init__()
        self._device: Optional[int] = None
        self._addr = b""

    @staticmethod
    def supported() -> bool:
        import torch
        return torch.cuda.is_available()

    def start(self) -> bool:
        """Bind to the current card and build the IPC interface (raises
        without CUDA, or when the build fails)."""
        if self._addr:
            return True
        import torch
        from . import cuda_ipc
        cuda_ipc._ipc()
        dev = torch.cuda.current_device()
        uuid = str(torch.cuda.get_device_properties(dev).uuid).encode()
        self._device = dev
        self._addr = ipc_address(_host_token(), uuid)
        return True

    @property
    def address(self) -> bytes:
        return self._addr

    def can_reach(self, peer_domain: bytes) -> bool:
        """A peer in another process whose address names this host and
        card; anything else (a JAX PJRT address) is out of reach."""
        addr = peer_transfer_addr(peer_domain)
        return bool(self._addr) and addr == self._addr \
            and domain_token(peer_domain) != _LOCAL_DOMAIN

    def post(self, tensor: Any, nbytes: int, on_release=None,
             socket_id: int = 0, conn_key=None) -> int:
        """Export ``tensor`` and register it; returns the descriptor uuid.
        A tensor that is not a contiguous one on this card is copied there
        first (and the copy is what stays posted).  The export blob for
        the descriptor is :meth:`export_blob`."""
        import torch
        from ..ops.device_ops import dtype_name
        from . import cuda_ipc
        cuda_ipc._ipc()                     # raises without CUDA
        t = tensor.detach().to(torch.device("cuda", self._device))
        t = t.contiguous()
        exp = cuda_ipc.export(t)
        blob = encode_export_blob(ExportBlob(
            self._addr, exp.mem_handle, exp.offset, exp.event_handle,
            dtype_name(t.dtype), tuple(int(n) for n in t.shape)))
        return self._register(t, nbytes, on_release, socket_id, conn_key,
                              export=(exp, blob))

    def export_blob(self, uuid: int) -> bytes:
        with self._lock:
            return self._posted[uuid].export[1]

    def redeem(self, blob: ExportBlob, uuid: int, device: Any = None):
        """Pull a peer's posted tensor into a fresh tensor on ``device``
        (None: this card).  The copy is finished and the mapping closed
        when this returns, before the caller acks."""
        if blob.address != self._addr:
            raise RuntimeError(
                f"transfer descriptor {uuid} names {blob.address!r}, which "
                f"this process ({self._addr!r}) cannot map")
        import torch
        from ..ops.device_ops import torch_dtype
        from . import cuda_ipc
        td = torch_dtype(blob.dtype)
        nbytes = math.prod(blob.shape) * torch.empty(
            (), dtype=td).element_size()
        out_device = device if device is not None \
            else torch.device("cuda", self._device)
        return cuda_ipc.pull(self._device, blob.mem_handle, blob.offset,
                             blob.event_handle, nbytes, td, blob.shape,
                             out_device)

    def _on_release(self, entry: PostedEntry) -> None:
        if entry.export is not None:
            from . import cuda_ipc
            try:
                cuda_ipc.destroy_event(entry.export[0])
            except RuntimeError:
                LOG.exception("CUDA IPC event of a released descriptor")
        super()._on_release(entry)


_fabric_lock = threading.Lock()
_in_process: Optional[InProcessFabric] = None
_xfer = None
_xfer_tried = False
_xfer_error: Optional[str] = None


def in_process_fabric() -> InProcessFabric:
    global _in_process
    with _fabric_lock:
        if _in_process is None:
            _in_process = InProcessFabric()
        return _in_process


def transfer_fabric():
    """The process's cross-process fabric, started on first use; None when
    ``ici_transfer_enabled`` is off or CUDA is absent.  An explicitly
    installed fabric (``set_transfer_fabric``) counts whatever the flag.
    A fabric that fails to start on a card raises, every time."""
    global _xfer, _xfer_tried, _xfer_error
    if not get_flag("ici_transfer_enabled", False):
        return _xfer
    with _fabric_lock:
        if _xfer_error is not None:
            raise RuntimeError(_xfer_error)
        if _xfer is not None or _xfer_tried:
            return _xfer
        _xfer_tried = True
    if not CudaIpcFabric.supported():
        LOG.warning("ici_transfer_enabled but CUDA is not available; device "
                    "attachments to other processes go inline")
        return None
    f = CudaIpcFabric()
    try:
        f.start()
    except Exception as e:
        with _fabric_lock:
            _xfer_error = f"CUDA IPC transfer fabric failed to start: {e}"
        raise RuntimeError(_xfer_error) from e
    with _fabric_lock:
        _xfer = f
    return _xfer


def installed_transfer_fabric():
    """The transfer fabric if one is up, never starting one (the sweeps
    and the ack path)."""
    return _xfer


def set_transfer_fabric(f) -> None:
    """Install a transfer fabric explicitly (None uninstalls; the next
    ``transfer_fabric()`` may start one again)."""
    global _xfer, _xfer_tried, _xfer_error
    with _fabric_lock:
        _xfer = f
        _xfer_tried = f is not None
        _xfer_error = None


def transfer_ready() -> Optional[bytes]:
    """This process's transfer address, when the fabric is live."""
    f = transfer_fabric()
    return f.address if f is not None and f.address else None
