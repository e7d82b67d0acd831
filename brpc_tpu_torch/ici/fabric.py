"""Transfer fabric -- how a posted device tensor reaches its redeemer.

The port of ``brpc_tpu/ici/fabric.py``'s in-process half.  The fabric
owns the payload; the endpoint (``endpoint.py``) owns per-connection
descriptors and flow control.

:class:`InProcessFabric` serves peers in one process: ``post`` parks the
tensor in a registry and ``redeem`` hands the same tensor back (moved to
another device only when asked).  The JAX package's cross-process pull
fabric (``JaxTransferFabric``, ``KIND_TRANSFER``) is not ported: the port
never advertises a transfer address, so peers in other processes use the
inline lane.

A *domain id* names the reach of a fabric: peers exchange domain ids in
RpcMeta and go device-resident only when an installed fabric can bridge
the two.  The trust model is the JAX package's: the exchange is
cooperative; redemption is bound to the connection the descriptor was
posted for, acks from other connections are rejected, a dead
connection's descriptors are reclaimed, the in-process path also needs a
loopback peer, and the TTL sweep is the backstop.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, Optional

LOG = logging.getLogger(__name__)

# Process token: the same token on both ends of a connection means both
# ends share this process, so the in-process fabric bridges them.  The
# JAX token is 16 random bytes and a domain is ``token@transfer-address``
# split at the first "@"; a random token can hold an "@" itself.  The
# port's token is 16 hex digits, which cannot, and it never appends an
# address.  On the wire the token stays opaque bytes.
_LOCAL_DOMAIN = os.urandom(8).hex().encode()


def local_domain_id() -> bytes:
    """Domain advertised in RpcMeta: the process token alone."""
    return _LOCAL_DOMAIN


def domain_token(domain: bytes) -> bytes:
    return domain.split(b"@", 1)[0]


def peer_transfer_addr(domain: Optional[bytes]) -> Optional[bytes]:
    """The transfer-server address inside a peer's domain id (None when
    the peer has no cross-process fabric)."""
    if not domain or b"@" not in domain:
        return None
    return domain.split(b"@", 1)[1] or None


class PostedEntry:
    __slots__ = ("tensor", "nbytes", "posted_at", "on_release", "socket_id",
                 "conn_key")

    def __init__(self, tensor: Any, nbytes: int, on_release=None,
                 socket_id: int = 0, conn_key=None):
        self.tensor = tensor
        self.nbytes = nbytes
        self.posted_at = time.monotonic()
        self.on_release = on_release
        self.socket_id = socket_id      # poster-local: binds acks
        self.conn_key = conn_key        # connection pair: binds redemption


class InProcessFabric:
    """Descriptor registry for peers in this process: a posted tensor is
    kept alive and counted against its connection's window until the peer
    acks redemption or the TTL sweep reclaims it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._posted: Dict[int, PostedEntry] = {}
        self._next_id = int.from_bytes(os.urandom(4), "little") | 1
        self.posted_bytes = 0          # live accounting (all connections)

    def can_reach(self, peer_domain: bytes) -> bool:
        return domain_token(peer_domain) == _LOCAL_DOMAIN

    def post(self, tensor: Any, nbytes: int, on_release=None,
             socket_id: int = 0, conn_key=None) -> int:
        with self._lock:
            desc_id = self._next_id
            self._next_id += 1
            self._posted[desc_id] = PostedEntry(tensor, nbytes, on_release,
                                                socket_id, conn_key)
            self.posted_bytes += nbytes
        return desc_id

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
        for desc_id in stale:
            self.release(desc_id)
        return len(stale)

    @property
    def live_descriptors(self) -> int:
        with self._lock:
            return len(self._posted)

    @staticmethod
    def _on_release(entry: PostedEntry) -> None:
        if entry.on_release is not None:
            try:
                entry.on_release(entry.nbytes)
            except Exception:
                LOG.exception("ici on_release callback raised")


_fabric_lock = threading.Lock()
_in_process: Optional[InProcessFabric] = None


def in_process_fabric() -> InProcessFabric:
    global _in_process
    with _fabric_lock:
        if _in_process is None:
            _in_process = InProcessFabric()
        return _in_process
