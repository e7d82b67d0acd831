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

Not here yet: the export registry (``KvPageStore``, the descriptors,
``drain_settle``) of the disaggregated handoff, and ``count_evict``'s
fleet event (the port has no ``fleet``).
"""

from __future__ import annotations

import hashlib
import struct
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

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
    free, an alias of a dead page, a stale host handle.  A bug by
    construction, so it raises instead of freeing the page's next
    tenant."""


def _reset_for_tests() -> None:
    with _evict_lock:
        for k in _evicts:
            _evicts[k] = 0
        for k in _prefix_events:
            _prefix_events[k] = 0


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
