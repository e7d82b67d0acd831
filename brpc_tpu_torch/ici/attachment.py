"""DeviceAttachment -- a tensor riding an RPC without leaving the device.

The port of ``brpc_tpu/ici/attachment.py``.  The user-facing object on
both ends:

- sender: ``cntl.request_device_attachment = tensor`` (client) or
  ``cntl.response_device_attachment = tensor`` (server);
- receiver: ``cntl.request_device_attachment.tensor(device=...)``.

On the wire it is either a *descriptor* -- ``KIND_INPROC`` when the peer
shares this process (the payload stays where it is), ``KIND_TRANSFER``
when it shares the card from another process (the receiver pulls a copy
over CUDA IPC) -- or raw bytes in the regular attachment (the
fallback).  The descriptor codec here is the JAX
package's byte for byte; the transfer and flow control live in
``endpoint.py``.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

# descriptor kinds
KIND_INLINE = 0          # payload rides the byte attachment (fallback)
KIND_INPROC = 1          # redeem from this process's registry
KIND_TRANSFER = 2        # pull from the peer over CUDA IPC (the JAX
#                          package's: from its PJRT transfer server)


def encode_descriptor(kind: int, desc_id: int, nbytes: int, dtype: str,
                      shape: Tuple[int, ...], extra: bytes = b"") -> bytes:
    d = dtype.encode()
    out = struct.pack("<BQI", kind, desc_id, nbytes)
    out += bytes([len(d)]) + d
    out += bytes([len(shape)]) + b"".join(
        struct.pack("<Q", s) for s in shape)
    out += struct.pack("<H", len(extra)) + extra
    return out


def decode_descriptor(data: bytes):
    kind, desc_id, nbytes = struct.unpack_from("<BQI", data)
    off = 13
    dlen = data[off]; off += 1
    dtype = data[off:off + dlen].decode(); off += dlen
    ndim = data[off]; off += 1
    shape = tuple(struct.unpack_from("<Q", data, off + 8 * i)[0]
                  for i in range(ndim))
    off += 8 * ndim
    (elen,) = struct.unpack_from("<H", data, off); off += 2
    extra = data[off:off + elen]
    return kind, desc_id, nbytes, dtype, shape, extra


class DeviceAttachment:
    """Received tensor handle: redeems lazily, at most once, and acks the
    sender on redemption (the ack returns window credit, endpoint.py)."""

    __slots__ = ("kind", "desc_id", "nbytes", "dtype", "shape",
                 "_tensor", "_host_bytes", "_socket_id", "_redeemed",
                 "_extra")

    def __init__(self, kind: int, desc_id: int, nbytes: int, dtype: str,
                 shape: Tuple[int, ...], socket_id: int = 0,
                 host_bytes: Optional[bytes] = None, extra: bytes = b""):
        self.kind = kind
        self.desc_id = desc_id
        self.nbytes = nbytes
        self.dtype = dtype
        self.shape = shape
        self._tensor = None
        self._host_bytes = host_bytes
        self._socket_id = socket_id
        self._redeemed = False
        self._extra = extra

    def __len__(self) -> int:
        return self.nbytes

    @property
    def device_resident(self) -> bool:
        return self.kind != KIND_INLINE

    def tensor(self, device="cuda"):
        """The attached tensor on ``device``.  An in-process descriptor
        redeems the posted tensor itself (the same object when it already
        lies on ``device``: zero copies); a transfer descriptor lands one
        device-to-device copy in a fresh tensor; inline bytes land with
        one H2D copy.  ``device=None`` leaves an in-process tensor where
        it was posted, lands a transfer on this process's card and inline
        bytes on the CPU.  Raises without CUDA unless a CPU device (or
        None) is asked for."""
        from ..utils.device import resolve_device
        dev = resolve_device(device) if device is not None else None
        if self._tensor is None:
            from .endpoint import redeem_attachment
            self._tensor = redeem_attachment(self, dev)
            self._redeemed = True
        if dev is not None:
            return self._tensor.to(dev)
        return self._tensor

    def numpy(self):
        """Host copy (an explicit D2H: debugging, host consumers).  bf16
        has no numpy dtype and comes back widened to float32."""
        import torch
        t = self.tensor(device=None).detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def settle(self) -> None:
        """Ack the poster now if the attachment was never redeemed.  The
        server calls this right before writing the response, so the
        credit return always precedes the response on the wire.  Handlers
        redeem (``tensor()``) before finishing the RPC; a handle kept past
        the response is settled here and redeems no more."""
        if self.kind in (KIND_INPROC, KIND_TRANSFER) and not self._redeemed:
            self._redeemed = True
            from .endpoint import _send_ack
            _send_ack(self._socket_id, (self.desc_id,))

    def __del__(self):
        # dropped without redemption (the user ignored the attachment):
        # return the poster's window credit instead of pinning it until
        # the TTL sweep
        if self.kind in (KIND_INPROC, KIND_TRANSFER) and not self._redeemed:
            try:
                from .endpoint import _send_ack
                _send_ack(self._socket_id, (self.desc_id,))
            except Exception:
                pass                     # interpreter teardown etc.
