"""The paged batcher's KV allocator planes: host-side bookkeeping for the
device page pool, the cross-session prefix cache and the host tier.

Counterpart of the allocator half of ``brpc_tpu/kv/pages.py``, which is
pure Python; the port keeps its own copy, with the same closed enums,
the same page ids, generations and eviction order, and the same chained
blake2b prefix digests (so a digest names the same tokens in both
packages):

- :class:`PageAllocator` — a refcounted free list over the pool's pages
  (``models/transformer_lm.empty_paged_cache``).  Page 0 is the reserved
  garbage page; a page returns to the free list when its last holder
  releases, and its generation moves on;
- :class:`PrefixCache` — a radix tree over page-sized token chunks: a
  re-sent context ALIASES the pages a session already prefilled (one
  ref each, no bytes moved) and skips prefill for the covered prefix;
- :class:`HostPagePool` — the eviction tier: a cold session's private
  pages land in fixed host slots (one copy per page, generation-checked
  handles, loud double free) and go back to the card on resume.  Its
  buffer is a ``torch.uint8`` tensor, pinned where CUDA is available, so
  a page moves between card and slot in one copy.  A staged
  page holds the f32 bytes of ``(2 * depth, page, heads, hd)``, the JAX
  package's layout.

The export half, for the disaggregated handoff (``kv/transport.py``,
``kv/disagg.py``):

- :class:`KvPageStore` — the process's fixed page export table.  A
  prefill tier *exports* each page of a session's cache (the live tensor
  is posted on the in-process fabric, ``ici/fabric.py``, and pinned under
  a fresh generation), *describes* it in 16 bytes (page id, generation,
  size), and the decode tier *imports* it once, consuming the fabric
  entry; the exporter *releases* it after the handoff's response.  A
  double free, a stale generation, a size mismatch and a second import
  all raise :class:`KvPageError`.  Pages carry an owner key (the client
  connection) so a dying socket sweeps them (:func:`on_socket_closed`);
  :func:`drain_settle` waits, deadline-bound, for every exported page
  and every host-tier spill in flight to settle.

Not here: ``count_evict``'s fleet event (the port has no ``fleet``).
"""

from __future__ import annotations

import hashlib
import logging
import struct
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..butil.flags import define_flag, get_flag

LOG = logging.getLogger(__name__)

define_flag("kv_pages", 256,
            "size of the KV page export table (exported-but-unsettled "
            "pages; bounded so leaks surface as exhaustion)",
            validator=lambda v: isinstance(v, int) and 0 < v <= 65535)

# stream close reasons the allocator can emit: every session the paged
# batcher refuses or abandons closes under exactly one of these
KV_EVICT_REASONS = (
    "kv_pool_exhausted",       # no device pages free for a new session
    "kv_host_tier_full",       # spill refused: the host tier is full too
    "kv_spill_drain_aborted",  # drain grace expired on a mid-evict spill
)

# prefix-cache outcome events (counters, closed set)
PREFIX_CACHE_EVENTS = (
    "prefix_hit",              # every full page of the context aliased
    "prefix_partial_hit",      # a proper prefix aliased, the remainder
    #                            caught up by chunk slices
    "prefix_miss",             # nothing aliased: full bucketed prefill
    "prefix_insert",           # a new prefix entered the radix tree
    "prefix_evict",            # an LRU entry released its page refs
)

_evict_lock = threading.Lock()
_evicts: Dict[str, int] = {r: 0 for r in KV_EVICT_REASONS}
_prefix_events: Dict[str, int] = {e: 0 for e in PREFIX_CACHE_EVENTS}


def count_evict(reason: str) -> None:
    if reason not in _evicts:
        raise ValueError(f"unnamed kv evict reason {reason!r}")
    with _evict_lock:
        _evicts[reason] += 1
    from .. import fleet
    fleet.record_event("fleet_kv_evict", reason)


def count_prefix(event: str) -> None:
    if event not in _prefix_events:
        raise ValueError(f"unnamed prefix event {event!r}")
    with _evict_lock:
        _prefix_events[event] += 1


def kv_evict_counters() -> Dict[str, int]:
    with _evict_lock:
        return dict(_evicts)


def prefix_event_counters() -> Dict[str, int]:
    with _evict_lock:
        return dict(_prefix_events)


class KvPageError(Exception):
    """A page operation this process cannot honour: a double or stale
    free, an alias of a dead page, a stale host handle, or an export
    descriptor that is stale, imported twice or of the wrong size.  A bug
    by construction, so it raises instead of freeing the page's next
    tenant (the handoff service answers ERESPONSE: a decode tier never
    seats a session on an empty cache)."""


def _reset_for_tests() -> None:
    global _store
    with _evict_lock:
        for k in _evicts:
            _evicts[k] = 0
        for k in _prefix_events:
            _prefix_events[k] = 0
    with _reg_lock:
        _store = None


class PageAllocator:
    """Refcounted free list over the device page pool's row blocks.

    Page 0 is reserved as the garbage page: unallocated block-table
    entries and inactive slots write there, and the attention mask never
    admits it, so the allocator hands out pages ``1..num_pages-1`` only.
    Refcounts exist for the prefix cache (a cached page is held by the
    tree and by every session that aliases it); each return to the free
    list bumps the page's generation, so a stale alias fails loudly."""

    def __init__(self, num_pages: int, page_tokens: int,
                 page_bytes: int = 0):
        if num_pages < 2:
            raise ValueError("PageAllocator needs >= 2 pages "
                             "(page 0 is the reserved garbage page)")
        self.num_pages = int(num_pages)
        self.page_tokens = int(page_tokens)
        self.page_bytes = int(page_bytes)   # device bytes per page (stats)
        self._lock = threading.Lock()
        self._ref = [0] * self.num_pages
        self._gen = [0] * self.num_pages
        # LIFO free list, page 0 never enters it
        self._free = list(range(self.num_pages - 1, 0, -1))
        self.peak_in_use = 0
        self.alloc_failures = 0

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages (refcount 1 each), or None when the pool
        cannot cover the request: never a partial grant."""
        with self._lock:
            if n > len(self._free):
                self.alloc_failures += 1
                return None
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._ref[p] = 1
            used = self.num_pages - 1 - len(self._free)
            self.peak_in_use = max(self.peak_in_use, used)
            return pages

    def ref(self, page_id: int) -> None:
        """Alias a live page; a free page cannot be aliased."""
        with self._lock:
            if not (0 < page_id < self.num_pages) \
                    or self._ref[page_id] <= 0:
                raise KvPageError(
                    f"alias of dead kv device page {page_id}")
            self._ref[page_id] += 1

    def release(self, page_id: int) -> None:
        """Drop one hold; the last one frees the page (generation
        bumped).  A double release raises."""
        with self._lock:
            if not (0 < page_id < self.num_pages) \
                    or self._ref[page_id] <= 0:
                raise KvPageError(
                    f"double/stale kv device page free (page "
                    f"{page_id})")
            self._ref[page_id] -= 1
            if self._ref[page_id] == 0:
                self._gen[page_id] += 1
                self._free.append(page_id)

    def release_all(self, pages) -> None:
        for p in pages:
            self.release(p)

    def gen_of(self, page_id: int) -> int:
        with self._lock:
            return self._gen[page_id]

    def refcount(self, page_id: int) -> int:
        with self._lock:
            return self._ref[page_id]

    def in_use(self) -> int:
        with self._lock:
            return self.num_pages - 1 - len(self._free)

    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            used = self.num_pages - 1 - len(self._free)
            return {"pages": self.num_pages,
                    "page_tokens": self.page_tokens,
                    "in_use": used,
                    "free": len(self._free),
                    "peak_in_use": self.peak_in_use,
                    "alloc_failures": self.alloc_failures,
                    "bytes_in_use": used * self.page_bytes}


class _PrefixNode:
    __slots__ = ("digest", "page", "gen", "children", "parent", "tick")

    def __init__(self, digest: bytes, page: int, gen: int,
                 parent: Optional["_PrefixNode"], tick: int):
        self.digest = digest
        self.page = page
        self.gen = gen
        self.children: Dict[bytes, "_PrefixNode"] = {}
        self.parent = parent
        self.tick = tick


class PrefixCache:
    """Radix tree over page-granular token-chunk fingerprints.

    Only FULL pages of a context are cached: its session never writes
    them again (decode writes land at positions >= ctx_len), so an alias
    needs no copy on write and a hit moves no bytes.  Each node holds one
    page, the allocator's generation of it, and its own ref on it.
    Eviction is leaf-first LRU, so the tree stays a prefix set under any
    budget."""

    def __init__(self, alloc: PageAllocator,
                 budget_pages: Optional[int] = None):
        self._alloc = alloc
        self._page = alloc.page_tokens
        self._budget = budget_pages
        self._lock = threading.Lock()
        self._root: Dict[bytes, _PrefixNode] = {}
        self._nodes = 0
        self._tick = 0
        self.hits = 0
        self.partial_hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0

    def _digests(self, tokens) -> List[bytes]:
        """Chained per-page digests of the full pages of ``tokens``."""
        n_full = len(tokens) // self._page
        out: List[bytes] = []
        prev = b""
        for i in range(n_full):
            chunk = tokens[i * self._page:(i + 1) * self._page]
            payload = struct.pack(f"<{self._page}q",
                                  *(int(t) for t in chunk))
            prev = hashlib.blake2b(prev + payload,
                                   digest_size=16).digest()
            out.append(prev)
        return out

    def lookup(self, ctx_tokens) -> Tuple[List[int], int]:
        """Longest cached prefix of ``ctx_tokens``: ``(pages,
        covered_tokens)`` with one ref taken per page, which the caller
        releases with the rest of the session's pages.  Counts one of
        prefix_hit / prefix_partial_hit / prefix_miss."""
        digs = self._digests(ctx_tokens)
        with self._lock:
            self._tick += 1
            matched: List[_PrefixNode] = []
            level = self._root
            for d in digs:
                node = level.get(d)
                if node is None:
                    break
                if self._alloc.gen_of(node.page) != node.gen:
                    # the cache holds a ref, so the generation cannot
                    # have moved: a double release elsewhere
                    raise KvPageError(
                        f"prefix cache generation skew on page "
                        f"{node.page}")
                node.tick = self._tick
                matched.append(node)
                level = node.children
            pages = [n.page for n in matched]
            for p in pages:
                self._alloc.ref(p)
        if digs and len(matched) == len(digs):
            self.hits += 1
            count_prefix("prefix_hit")
        elif matched:
            self.partial_hits += 1
            count_prefix("prefix_partial_hit")
        else:
            self.misses += 1
            count_prefix("prefix_miss")
        return pages, len(pages) * self._page

    def insert(self, ctx_tokens, page_ids) -> int:
        """Cache the full pages of a freshly prefilled context
        (``page_ids[i]`` holds chunk ``i``'s rows): one cache-owned ref
        per new node.  Returns how many were new."""
        digs = self._digests(ctx_tokens)
        new = 0
        with self._lock:
            self._tick += 1
            level = self._root
            parent: Optional[_PrefixNode] = None
            for i, d in enumerate(digs):
                node = level.get(d)
                if node is None:
                    page = page_ids[i]
                    self._alloc.ref(page)
                    node = _PrefixNode(d, page, self._alloc.gen_of(page),
                                       parent, self._tick)
                    level[d] = node
                    self._nodes += 1
                    new += 1
                node.tick = self._tick
                parent = node
                level = node.children
        if new:
            self.inserts += new
            count_prefix("prefix_insert")
            self.evict_to_budget()
        return new

    def _leaves_locked(self) -> List[_PrefixNode]:
        leaves: List[_PrefixNode] = []
        stack = list(self._root.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                leaves.append(n)
        return leaves

    def evict_lru(self) -> bool:
        """Drop the least recently touched leaf."""
        with self._lock:
            leaves = self._leaves_locked()
            if not leaves:
                return False
            victim = min(leaves, key=lambda n: n.tick)
            siblings = victim.parent.children if victim.parent \
                else self._root
            del siblings[victim.digest]
            self._nodes -= 1
            page = victim.page
        self._alloc.release(page)
        self.evictions += 1
        count_prefix("prefix_evict")
        return True

    def evict_to_budget(self) -> int:
        if self._budget is None:
            return 0
        n = 0
        while self.held_pages() > self._budget and self.evict_lru():
            n += 1
        return n

    def evict_all(self) -> int:
        n = 0
        while self.evict_lru():
            n += 1
        return n

    def held_pages(self) -> int:
        with self._lock:
            return self._nodes

    def stats(self) -> Dict[str, int]:
        return {"nodes": self.held_pages(),
                "hits": self.hits,
                "partial_hits": self.partial_hits,
                "misses": self.misses,
                "inserts": self.inserts,
                "evictions": self.evictions}


# every live HostPagePool, so a drain can count the spills in flight
_host_pools: "weakref.WeakSet" = weakref.WeakSet()


class HostHandle:
    """One staged page in the host tier: slot, generation, size."""

    __slots__ = ("slot", "gen", "nbytes")

    def __init__(self, slot: int, gen: int, nbytes: int):
        self.slot = slot
        self.gen = gen
        self.nbytes = nbytes


def _as_bytes(src) -> torch.Tensor:
    """``src`` (a numpy array or a tensor on any device) as a flat
    ``torch.uint8`` view of its bytes."""
    if isinstance(src, np.ndarray):
        src = torch.from_numpy(np.ascontiguousarray(src))
    return src.contiguous().reshape(-1).view(torch.uint8)


class HostPagePool:
    """Fixed-slot host pool for evicted KV pages: a preallocated
    ``(slots, slot_bytes)`` uint8 buffer (pinned where CUDA is available),
    one copy per staged page,
    generation-checked handles and a loud double free.
    ``begin_spill``/``end_spill`` bracket one session's spill so a drain
    can count spills in flight; ``drain_abort`` refuses new ones."""

    def __init__(self, slots: int, slot_bytes: int):
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self._buf = torch.zeros((self.slots, self.slot_bytes),
                                dtype=torch.uint8,
                                pin_memory=torch.cuda.is_available())
        self._lock = threading.Lock()
        self._free = list(range(self.slots))
        self._gen = [0] * self.slots
        self._live = [False] * self.slots
        self._inflight = 0
        self._abort_reason: Optional[str] = None
        self.staged = 0
        self.fetched = 0
        self.peak_slots_used = 0
        _host_pools.add(self)

    def begin_spill(self) -> bool:
        """Open one spill bracket; False once the pool is aborted."""
        with self._lock:
            if self._abort_reason is not None:
                return False
            self._inflight += 1
            return True

    def end_spill(self) -> None:
        with self._lock:
            self._inflight -= 1
            if self._inflight < 0:
                raise KvPageError("unbalanced kv spill bracket")

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def drain_abort(self, reason: str) -> None:
        if reason not in KV_EVICT_REASONS:
            raise ValueError(f"unnamed kv evict reason {reason!r}")
        with self._lock:
            self._abort_reason = reason

    def abort_reason(self) -> Optional[str]:
        with self._lock:
            return self._abort_reason

    def stage(self, src) -> Optional[HostHandle]:
        """Land one page's bytes in a slot, in one copy (from the card
        when ``src`` lies there).  None when the tier is full."""
        view = _as_bytes(src)
        nb = view.numel()
        if nb > self.slot_bytes:
            raise KvPageError(
                f"kv spill page of {nb} bytes exceeds host slot "
                f"({self.slot_bytes})")
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._gen[slot] += 1
            gen = self._gen[slot]
            self._live[slot] = True
            self.peak_slots_used = max(self.peak_slots_used,
                                       self.slots - len(self._free))
        self._buf[slot, :nb].copy_(view)
        from ..butil import copy_audit
        if copy_audit.enabled and nb >= copy_audit.AUDIT_FLOOR:
            copy_audit.record("spill_host", nb)
        with self._lock:
            self.staged += 1
        return HostHandle(slot, gen, nb)

    def _check(self, h: HostHandle, what: str) -> None:
        if not (0 <= h.slot < self.slots) or not self._live[h.slot] \
                or self._gen[h.slot] != h.gen:
            raise KvPageError(
                f"{what} (slot {h.slot} gen {h.gen})")

    def fetch(self, h: HostHandle) -> torch.Tensor:
        """A staged page's bytes, as a uint8 view of its slot (valid
        until the handle is freed)."""
        with self._lock:
            self._check(h, "stale kv host fetch")
            self.fetched += 1
        return self._buf[h.slot, :h.nbytes]

    def free(self, h: HostHandle) -> None:
        with self._lock:
            self._check(h, "double/stale kv host free")
            self._live[h.slot] = False
            self._free.append(h.slot)

    def slots_free(self) -> int:
        with self._lock:
            return len(self._free)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"slots": self.slots,
                    "slot_bytes": self.slot_bytes,
                    "free": len(self._free),
                    "inflight": self._inflight,
                    "staged": self.staged,
                    "fetched": self.fetched,
                    "peak_slots_used": self.peak_slots_used}


def host_inflight_spills() -> int:
    """Host-tier spills in flight across every live pool (0 when no host
    tier exists)."""
    return sum(pool.inflight() for pool in list(_host_pools))


# -- the export registry (the disaggregated handoff) -------------------------

_DESC_FMT = "<IIQ"          # page_id, generation, nbytes
DESC_BYTES = struct.calcsize(_DESC_FMT)


class KvPageHandle:
    """Sender-side lease of one exported page (settled exactly once)."""

    __slots__ = ("page_id", "gen", "nbytes")

    def __init__(self, page_id: int, gen: int, nbytes: int):
        self.page_id = page_id
        self.gen = gen
        self.nbytes = nbytes

    def describe(self) -> bytes:
        return struct.pack(_DESC_FMT, self.page_id, self.gen, self.nbytes)


def decode_desc(data: bytes) -> Tuple[int, int, int]:
    if len(data) != DESC_BYTES:
        raise KvPageError(f"malformed kv page descriptor "
                          f"({len(data)} bytes)")
    return struct.unpack(_DESC_FMT, data)


class _Rec:
    __slots__ = ("desc_id", "nbytes", "owner", "imported")

    def __init__(self, desc_id: int, nbytes: int, owner):
        self.desc_id = desc_id
        self.nbytes = nbytes
        self.owner = owner
        self.imported = False


class KvPageStore:
    """The process's page export table: fixed size, generation-checked
    (the host tier's slot model applied to live tensors)."""

    def __init__(self, npages: int):
        self.npages = int(npages)
        self._lock = threading.Lock()
        self._recs: List[Optional[_Rec]] = [None] * self.npages
        self._gen = [0] * self.npages
        self._free = list(range(self.npages))
        self.exported = 0            # lifetime counters (stats)
        self.imported = 0
        self.swept = 0

    def export_array(self, array, nbytes: int,
                     owner=None) -> Optional[KvPageHandle]:
        """Register one page (a live tensor) for transfer: it is posted on
        the in-process fabric, kept alive and addressable until imported,
        released or swept.  None when the table is full (the caller falls
        back under a named reason: exhaustion is backpressure)."""
        from ..ici.fabric import in_process_fabric
        with self._lock:
            if not self._free:
                return None
            page_id = self._free.pop()
            self._gen[page_id] += 1
            gen = self._gen[page_id]
        desc_id = in_process_fabric().post(array, nbytes)
        with self._lock:
            self._recs[page_id] = _Rec(desc_id, nbytes, owner)
            self.exported += 1
        return KvPageHandle(page_id, gen, nbytes)

    def import_page(self, page_id: int, gen: int, nbytes: int):
        """Resolve a descriptor into its tensor, consuming the fabric
        entry: the importer owns the tensor from here on.  A stale
        generation, an unknown page, a size mismatch or a second import
        raises :class:`KvPageError`."""
        from ..ici.fabric import in_process_fabric
        with self._lock:
            rec = self._recs[page_id] \
                if 0 <= page_id < self.npages else None
            if rec is None or self._gen[page_id] != gen:
                raise KvPageError(
                    f"stale kv page import (page {page_id} gen {gen})")
            if rec.imported:
                raise KvPageError(f"kv page {page_id} already imported")
            if rec.nbytes != nbytes:
                raise KvPageError(f"kv page {page_id} size mismatch "
                                  f"({nbytes} != {rec.nbytes})")
            desc_id = rec.desc_id
            rec.imported = True
        arr = in_process_fabric().take(desc_id)
        if arr is None:
            # released or swept between the record check and the take
            raise KvPageError(f"kv page {page_id} no longer registered")
        with self._lock:
            self.imported += 1
        return arr

    def release(self, page_id: int, gen: int) -> None:
        """Settle one exported page (the sender's end of a handoff).  A
        double free or a stale generation raises: a silent no-op would one
        day free the table slot's next tenant."""
        from ..ici.fabric import in_process_fabric
        with self._lock:
            rec = self._recs[page_id] \
                if 0 <= page_id < self.npages else None
            if rec is None or self._gen[page_id] != gen:
                raise KvPageError(f"double/stale kv page free (page "
                                  f"{page_id} gen {gen})")
            self._recs[page_id] = None
            self._free.append(page_id)
            desc_id, imported = rec.desc_id, rec.imported
        if not imported:
            # never imported: drop the fabric registration here
            in_process_fabric().release(desc_id)

    def settle_handles(self, handles) -> None:
        """Release a handoff's whole page set, each page once."""
        for h in handles:
            self.release(h.page_id, h.gen)

    def release_owner(self, owner) -> int:
        """Reclaim every page tagged with ``owner`` (its connection died
        before the handoff settled).  Soft: the sweep races legitimate
        settles and throws at neither."""
        from ..ici.fabric import in_process_fabric
        stale = []
        with self._lock:
            for page_id, rec in enumerate(self._recs):
                if rec is not None and rec.owner == owner:
                    self._recs[page_id] = None
                    self._free.append(page_id)
                    if not rec.imported:
                        stale.append(rec.desc_id)
                    self.swept += 1
        for desc_id in stale:
            in_process_fabric().release(desc_id)
        return len(stale)

    def outstanding(self) -> int:
        with self._lock:
            return self.npages - len(self._free)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"pages": self.npages,
                    "outstanding": self.npages - len(self._free),
                    "exported": self.exported,
                    "imported": self.imported,
                    "swept": self.swept}


_reg_lock = threading.Lock()
_store: Optional[KvPageStore] = None


def process_kv_store() -> KvPageStore:
    """The process's export table, built at first use at ``kv_pages``
    pages."""
    global _store
    with _reg_lock:
        if _store is None:
            _store = KvPageStore(int(get_flag("kv_pages")))
        return _store


def on_socket_closed(owner) -> None:
    """Sweep the pages exported for a dead connection (its handoff will
    never settle); ``Socket.close`` calls it."""
    with _reg_lock:
        store = _store
    if store is not None:
        n = store.release_owner(owner)
        if n:
            LOG.info("kv page sweep: %d page(s) of dead owner %r", n, owner)


def outstanding_pages() -> int:
    """Exported pages not yet settled (0 when no page was ever
    exported)."""
    with _reg_lock:
        store = _store
    return store.outstanding() if store is not None else 0


def drain_settle(deadline_mono_s: float) -> int:
    """Wait, until ``deadline_mono_s`` (``time.monotonic()``), for every
    exported page to settle and every host-tier spill in flight to land.
    At the deadline each pool still mid-spill is aborted, so its batcher
    closes the parked sessions under ``kv_spill_drain_aborted``.  Returns
    the pages plus spills still outstanding then (0: settled)."""
    import time as _time
    ev = threading.Event()
    while True:
        n = outstanding_pages() + host_inflight_spills()
        if n == 0:
            return 0
        if _time.monotonic() >= deadline_mono_s:
            for pool in list(_host_pools):
                if pool.inflight():
                    pool.drain_abort("kv_spill_drain_aborted")
            return n
        ev.wait(0.005)     # timed: the drain stays deadline-bound
