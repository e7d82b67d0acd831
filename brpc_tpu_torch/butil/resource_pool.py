"""Versioned-id slot pools.

Capability parity with the reference's ResourcePool/ObjectPool
(brpc's src/butil/resource_pool.h:22): objects addressable by a
compact integer id where the id embeds a *version*, so a stale id held by a
racing party safely resolves to "gone" instead of use-after-free.  This is
the mechanism behind SocketId and call correlation ids (see fiber.versioned_id).

Fresh design: a growable slot table + LIFO free list guarded by a lock (the
GIL makes fine-grained TLS free lists pointless in Python; the native C++
engine provides the contended-path fast pool).  Ids are 64-bit:
``(version << 32) | slot_index``.  Versions bump on every release, so each
slot survives 2^32 reuses before wrapping.

A copy of ``brpc_tpu/butil/resource_pool.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")

_SLOT_BITS = 32
_SLOT_MASK = (1 << _SLOT_BITS) - 1

INVALID_ID = 0xFFFFFFFFFFFFFFFF


def id_slot(rid: int) -> int:
    return rid & _SLOT_MASK


def id_version(rid: int) -> int:
    return rid >> _SLOT_BITS


def make_id(version: int, slot: int) -> int:
    return (version << _SLOT_BITS) | slot


class ResourcePool(Generic[T]):
    """Slot pool with versioned ids.

    - :meth:`acquire` -> (id, obj): takes a free slot (or grows), constructs
      via the factory, returns the versioned id.
    - :meth:`address` -> obj | None: resolves an id iff the version matches
      the slot's live version (stale ids resolve to None).
    - :meth:`release`: invalidates the id (bumps version) and recycles the
      slot. Safe against double-release of a stale id.
    """

    def __init__(self, factory: Optional[Callable[[], T]] = None):
        self._factory = factory
        self._lock = threading.Lock()
        self._objs: List[Optional[T]] = []
        self._versions: List[int] = []
        self._free: List[int] = []
        self.live_count = 0

    def acquire(self, obj: Optional[T] = None) -> Tuple[int, T]:
        if obj is None:
            if self._factory is None:
                raise ValueError("no object given and no factory configured")
            obj = self._factory()
        with self._lock:
            if self._free:
                slot = self._free.pop()
                self._objs[slot] = obj
            else:
                slot = len(self._objs)
                self._objs.append(obj)
                # version starts at 1 so id 0 is never live with version 0
                self._versions.append(1)
            self.live_count += 1
            return make_id(self._versions[slot], slot), obj

    def address(self, rid: int) -> Optional[T]:
        slot = rid & _SLOT_MASK
        version = rid >> _SLOT_BITS
        # Reads tolerate racing release: worst case we return an object that
        # is being released concurrently — same contract as the reference
        # (address_resource returns the slot; Socket layers re-check health).
        try:
            if self._versions[slot] == version:
                return self._objs[slot]
        except IndexError:
            pass
        return None

    def release(self, rid: int) -> bool:
        slot = rid & _SLOT_MASK
        version = rid >> _SLOT_BITS
        with self._lock:
            try:
                if self._versions[slot] != version:
                    return False
            except IndexError:
                return False
            self._versions[slot] += 1
            self._objs[slot] = None
            self._free.append(slot)
            self.live_count -= 1
            return True

    def __len__(self) -> int:
        return self.live_count

    def live_items(self) -> List[Tuple[int, T]]:
        """Snapshot of (id, obj) for live slots (introspection pages)."""
        out: List[Tuple[int, T]] = []
        with self._lock:
            for slot, obj in enumerate(self._objs):
                if obj is not None:
                    out.append((make_id(self._versions[slot], slot), obj))
        return out


class ObjectPool(Generic[T]):
    """Simple recycling pool without ids (≈ butil::ObjectPool,
    brpc's src/butil/object_pool_inl.h). ``get``/``put`` reuse
    instances; the factory constructs on miss, ``reset`` (if provided)
    scrubs recycled instances."""

    def __init__(
        self,
        factory: Callable[[], T],
        reset: Optional[Callable[[T], None]] = None,
        max_cached: int = 1024,
    ):
        self._factory = factory
        self._reset = reset
        self._free: List[T] = []
        self._lock = threading.Lock()
        self._max_cached = max_cached
        self.hits = 0
        self.misses = 0

    def get(self) -> T:
        with self._lock:
            if self._free:
                self.hits += 1
                return self._free.pop()
        self.misses += 1
        return self._factory()

    def put(self, obj: T) -> None:
        if self._reset is not None:
            self._reset(obj)
        with self._lock:
            if len(self._free) < self._max_cached:
                self._free.append(obj)
