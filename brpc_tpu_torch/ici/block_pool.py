"""Device block pool — bounded, recycled landing buffers on the card.

The port of ``brpc_tpu/ici/block_pool.py``.  Role parity with brpc's
src/brpc/rdma/block_pool.cpp: RDMA needs payload memory drawn from a
*registered*, bounded region so the NIC can DMA into it without a
registration per transfer.  Here a landing buffer is a flat
``torch.uint8`` tensor on the pool's device; recycling hands the same
tensor (the same device pages, ``data_ptr()`` unchanged) to the next
landing of its size, where the JAX package recycles HBM by buffer
donation.

Lifecycle is explicit, like RDMA registered buffers: the consumer calls
:meth:`DeviceBlockPool.recycle` once a landed tensor's contents are no
longer referenced.  A recycle that would hold more than ``max_bytes`` in
the free lists drops the tensor instead (the caching allocator takes it
back).  :meth:`DeviceBlockPool.land` is one host-to-device copy of
exactly ``len(view)`` bytes; on the card the bytes pass through a pinned
staging buffer of the pool's (grown to the largest landing, reused), so
the copy is one DMA from page-locked memory and a read-only ``bytes``
source is never wrapped as a writable tensor.

A :class:`DeviceBlock` plugs into ``butil.iobuf``'s IOBuf like any
block; its bytes are staged to the host only when a caller reads them.

Entry points take ``device=`` (default ``"cuda"``) and raise where CUDA
is absent unless the caller passed ``device="cpu"``.
"""

from __future__ import annotations

import threading
from collections import defaultdict, deque
from typing import Any, Deque, Dict, Optional

import numpy as np
import torch

from ..butil.iobuf import Block, BlockPool
from ..utils.device import resolve_device

DEFAULT_POOL_BYTES = 256 * 1024 * 1024      # data-plane cap on the card


class DeviceBlock(Block):
    """A Block whose storage is a flat ``torch.uint8`` tensor of
    ``capacity`` bytes on the card.  IOBuf can chain refs to it like any
    block; byte access (``view``) stages to the host, lazily — the data
    plane never calls it."""

    __slots__ = ("array",)

    def __init__(self, array: torch.Tensor, nbytes: int,
                 pool: Optional["DeviceBlockPool"] = None):
        # Block.data must be len()-able; the host mirror is created only
        # if someone byte-reads the block
        self.array = array
        super().__init__(_LazyHostMirror(self, nbytes), nbytes, pool)

    def view(self, offset: int, length: int):
        return memoryview(self.data.materialize())[offset:offset + length]


class _LazyHostMirror:
    """len()-able placeholder that stages the device bytes to the host on
    the first real access (an explicit device-to-host copy, never an
    implicit one)."""

    __slots__ = ("_block", "_host", "_nbytes")

    def __init__(self, block: DeviceBlock, nbytes: int):
        self._block = block
        self._host = None
        self._nbytes = nbytes

    def __len__(self) -> int:
        return self._nbytes

    def materialize(self) -> bytes:
        if self._host is None:
            self._host = self._block.array.cpu().numpy().tobytes()
        return self._host


class DeviceBlockPool(BlockPool):
    """Free-listed device byte-buffer pool.

    ``land(host_view)`` -> a ``torch.uint8`` tensor of exactly
    ``len(view)`` bytes on the pool's device, drawn from (and returned
    to) per-size free lists.  Repeated same-size landings reuse the same
    device pages: ``data_ptr()`` stays put across a recycle, the tests'
    proof of recycling."""

    def __init__(self, max_bytes: int = DEFAULT_POOL_BYTES,
                 device: Any = "cuda"):
        self.device = resolve_device(device)
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._free: Dict[int, Deque[torch.Tensor]] = defaultdict(deque)
        self._stage: Optional[torch.Tensor] = None   # pinned, on the card
        self._stage_lock = threading.Lock()
        self.pooled_bytes = 0          # held in free lists
        self.landed = 0                # stats
        self.recycled = 0

    # -- BlockPool interface ----------------------------------------------

    def allocate(self, capacity: int = 0) -> DeviceBlock:
        """A fresh zeroed device block (the IOBuf interface; the data
        plane uses :meth:`land`)."""
        capacity = capacity or 8192
        arr = self._take(capacity)
        if arr is None:
            arr = torch.zeros(capacity, dtype=torch.uint8,
                              device=self.device)
        else:
            arr.zero_()
        return DeviceBlock(arr, capacity, self)

    # -- data plane --------------------------------------------------------

    def land(self, host_view) -> torch.Tensor:
        """One host-to-device copy of ``host_view`` into a pooled buffer;
        returns a flat ``torch.uint8`` tensor owning recycled pages."""
        src = np.frombuffer(host_view, dtype=np.uint8)
        n = src.nbytes
        self.landed += 1
        dst = self._take(n)
        if dst is None:
            dst = torch.empty(n, dtype=torch.uint8, device=self.device)
        else:
            self.recycled += 1
        if n == 0:
            return dst
        if self.device.type == "cpu":
            dst.numpy()[:] = src
            return dst
        with self._stage_lock:
            stage = self._stage
            if stage is None or stage.numel() < n:
                stage = self._stage = torch.empty(n, dtype=torch.uint8,
                                                  pin_memory=True)
            stage.numpy()[:n] = src
            # a blocking copy: the staging buffer is free again on return
            dst.copy_(stage[:n])
        return dst

    def recycle(self, array: torch.Tensor) -> None:
        """Return a landed tensor for reuse (the caller guarantees that
        nothing reads it any more).  Over the cap it is dropped."""
        n = int(array.numel())
        with self._lock:
            if self.pooled_bytes + n > self.max_bytes:
                return                    # over cap: the allocator frees it
            self._free[n].append(array)
            self.pooled_bytes += n

    def _take(self, nbytes: int) -> Optional[torch.Tensor]:
        with self._lock:
            lst = self._free.get(nbytes)
            if lst:
                self.pooled_bytes -= nbytes
                return lst.popleft()
        return None


_default_lock = threading.Lock()
_default_pools: Dict[torch.device, DeviceBlockPool] = {}


def default_device_pool(device: Any = "cuda") -> DeviceBlockPool:
    """The process's pool for ``device`` (one per device, made at the
    first call)."""
    dev = resolve_device(device)
    with _default_lock:
        pool = _default_pools.get(dev)
        if pool is None:
            pool = _default_pools[dev] = DeviceBlockPool(device=dev)
        return pool
