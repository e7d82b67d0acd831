"""The port's KV allocator planes (``brpc_tpu_torch/kv/pages.py``) against
the JAX package's ``brpc_tpu/kv/pages.py``, on the CPU:

- the closed enums are the same;
- one seeded sequence of alloc, ref, release, lookup, insert and evict
  drives ``PageAllocator`` and ``PrefixCache`` in both packages, with the
  same page ids, generations, refcounts, ``(pages, covered)``, eviction
  order, errors and ``stats()`` after every operation;
- the chained prefix digests are equal;
- ``HostPagePool``: stage, fetch and free round-trip bytes exactly (from
  numpy and from an f32 tensor), a double free and a stale handle raise,
  a full tier returns None, ``drain_abort`` refuses new spills, and the
  stats follow the JAX pool's.

The planes are pure bookkeeping, so everything is held to equality.
"""

import numpy as np
import pytest
import torch

from brpc_tpu.kv import pages as jpages
from brpc_tpu_torch import kv as tkv
from brpc_tpu_torch.kv import pages as tpages

PAGE = 4


def test_enums_match_jax():
    assert tpages.KV_EVICT_REASONS == jpages.KV_EVICT_REASONS
    assert tpages.PREFIX_CACHE_EVENTS == jpages.PREFIX_CACHE_EVENTS
    assert set(tpages.kv_evict_counters()) == set(jpages.KV_EVICT_REASONS)
    assert set(tpages.prefix_event_counters()) \
        == set(jpages.PREFIX_CACHE_EVENTS)
    for bad in (lambda: tpages.count_evict("kv_something_else"),
                lambda: tpages.count_prefix("prefix_something_else")):
        with pytest.raises(ValueError):
            bad()
    assert tkv.PageAllocator is tpages.PageAllocator
    # the package exports the handoff's registry too, as the JAX one does
    assert tkv.KvPageStore is tpages.KvPageStore
    assert {"KvPageStore", "process_kv_store", "drain_settle",
            "KvTransport", "PrefillService", "DecodeTierService"} \
        <= set(tkv.__all__)


def test_counters_count_and_reset():
    before = tpages.kv_evict_counters()["kv_host_tier_full"]
    tpages.count_evict("kv_host_tier_full")
    assert tpages.kv_evict_counters()["kv_host_tier_full"] == before + 1
    tpages.count_prefix("prefix_miss")
    tpages._reset_for_tests()
    assert not any(tpages.kv_evict_counters().values())
    assert not any(tpages.prefix_event_counters().values())


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:           # the error's class name is held
        return ("raised", type(e).__name__)


class _Twin:
    """One allocator and prefix cache per package, driven in step."""

    def __init__(self, num_pages, budget):
        self.planes = []
        for mod in (jpages, tpages):
            alloc = mod.PageAllocator(num_pages, PAGE, page_bytes=64)
            self.planes.append((alloc, mod.PrefixCache(alloc, budget)))
        self.num_pages = num_pages

    def both(self, fn):
        """``fn(alloc, cache)`` on both packages; the common outcome."""
        got = [_outcome(lambda: fn(a, c)) for a, c in self.planes]
        assert got[0] == got[1]
        return got[0]

    def check_state(self):
        (ja, jc), (ta, tc) = self.planes
        assert ta.stats() == ja.stats()
        assert tc.stats() == jc.stats()
        assert tc.held_pages() == jc.held_pages()
        for p in range(1, self.num_pages):
            assert ta.gen_of(p) == ja.gen_of(p)
            assert ta.refcount(p) == ja.refcount(p)


def _contexts(rng):
    """Contexts that share prefixes: two bases, each with tails of
    several lengths."""
    bases = [rng.integers(0, 50, 12) for _ in range(2)]
    out = []
    for b in bases:
        for n in (4, 9, 12):
            out.append(np.concatenate([b[:n], rng.integers(0, 50, 5)]))
        out.append(b.copy())
    return out


@pytest.mark.parametrize("seed,num_pages,budget", [
    (0, 24, None), (1, 12, None), (2, 24, 5), (3, 9, 3)])
def test_allocator_and_prefix_cache_follow_jax(seed, num_pages, budget):
    rng = np.random.default_rng(seed)
    twin = _Twin(num_pages, budget)
    ctxs = _contexts(rng)
    holds = []                       # page ids the "sessions" hold
    for _ in range(300):
        op = rng.integers(0, 7)
        if op == 0:
            n = int(rng.integers(1, 5))
            kind, pages = twin.both(lambda a, c: a.alloc(n))
            if pages:
                holds.extend(pages)
        elif op == 1 and holds:
            p = holds[int(rng.integers(len(holds)))]
            twin.both(lambda a, c: a.ref(p))
            holds.append(p)
        elif op == 2 and holds:
            p = holds.pop(int(rng.integers(len(holds))))
            twin.both(lambda a, c: a.release(p))
        elif op == 3:
            ctx = ctxs[int(rng.integers(len(ctxs)))]
            kind, res = twin.both(lambda a, c: c.lookup(ctx))
            pages, covered = res
            assert covered == len(pages) * PAGE
            holds.extend(pages)
        elif op == 4:
            ctx = ctxs[int(rng.integers(len(ctxs)))]
            need = len(ctx) // PAGE
            kind, pages = twin.both(lambda a, c: a.alloc(need))
            if pages:
                twin.both(lambda a, c: c.insert(ctx, pages))
                holds.extend(pages)
        elif op == 5:
            twin.both(lambda a, c: c.evict_lru())
        else:
            # misuse raises alike: a free page, page 0, out of range
            bad = int(rng.choice([0, num_pages, num_pages + 3]))
            assert twin.both(lambda a, c: a.release(bad))[0] == "raised"
            assert twin.both(lambda a, c: a.ref(bad))[0] == "raised"
        twin.check_state()
    twin.both(lambda a, c: c.evict_all())
    for p in holds:
        twin.both(lambda a, c: a.release(p))
    twin.check_state()
    assert twin.planes[1][0].in_use() == 0


def test_allocator_contract():
    with pytest.raises(ValueError):
        tpages.PageAllocator(1, PAGE)
    a = tpages.PageAllocator(5, PAGE, page_bytes=10)
    assert a.alloc(5) is None and a.stats()["alloc_failures"] == 1
    pages = a.alloc(4)
    assert pages == jpages.PageAllocator(5, PAGE).alloc(4) == [1, 2, 3, 4]
    assert a.stats()["bytes_in_use"] == 40
    a.release(1)
    with pytest.raises(tpages.KvPageError):
        a.release(1)                             # double free
    with pytest.raises(tpages.KvPageError):
        a.ref(1)                                 # alias of a dead page
    assert a.gen_of(1) == 1 and a.free_pages() == 1


@pytest.mark.parametrize("page", [1, 4, 16])
def test_prefix_digests_equal_jax(page):
    rng = np.random.default_rng(page)
    toks = rng.integers(0, 2**31 - 1, 3 * page + 2).astype(np.int32)
    got = tpages.PrefixCache(tpages.PageAllocator(4, page))._digests(toks)
    want = jpages.PrefixCache(jpages.PageAllocator(4, page))._digests(toks)
    assert got == want and len(got) == len(toks) // page
    # a digest commits to the whole prefix, not only its own chunk
    other = toks.copy()
    other[0] += 1
    again = tpages.PrefixCache(tpages.PageAllocator(4, page))._digests(
        other)
    assert all(a != b for a, b in zip(again, got))


def test_prefix_cache_generation_skew_raises():
    a = tpages.PageAllocator(6, PAGE)
    c = tpages.PrefixCache(a)
    ctx = np.arange(8)
    pages = a.alloc(2)
    assert c.insert(ctx, pages) == 2
    a.release_all(pages)                 # the cache's refs keep them live
    node = next(iter(c._root.values()))
    a.release(node.page)                 # a double release elsewhere
    with pytest.raises(tpages.KvPageError, match="skew"):
        c.lookup(ctx)


def _pools(slots, slot_bytes):
    return (jpages.HostPagePool(slots, slot_bytes),
            tpages.HostPagePool(slots, slot_bytes))


def _bytes(x):
    return bytes(np.asarray(x.numpy() if torch.is_tensor(x) else x))


def test_host_pool_round_trip_and_errors():
    jp, tp = _pools(3, 64)
    rng = np.random.default_rng(5)
    srcs = [rng.integers(0, 256, n).astype(np.uint8) for n in (64, 17, 40)]
    handles = [(jp.stage(s), tp.stage(s)) for s in srcs]
    for (jh, th), src in zip(handles, srcs):
        assert (th.slot, th.gen, th.nbytes) == (jh.slot, jh.gen, jh.nbytes)
        assert _bytes(tp.fetch(th)) == _bytes(jp.fetch(jh)) == src.tobytes()
    # a full tier returns None
    assert jp.stage(srcs[0]) is None and tp.stage(srcs[0]) is None
    assert tp.stats() == jp.stats()
    jh, th = handles[1]
    jp.free(jh)
    tp.free(th)
    for mod, pool, h in ((jpages, jp, jh), (tpages, tp, th)):
        with pytest.raises(mod.KvPageError):
            pool.free(h)                         # double free
        with pytest.raises(mod.KvPageError):
            pool.fetch(h)                        # stale handle
    # the slot is taken again under a new generation; the old handle
    # stays stale
    jh2, th2 = jp.stage(srcs[2]), tp.stage(srcs[2])
    assert (th2.slot, th2.gen) == (jh2.slot, jh2.gen) == (th.slot, 2)
    with pytest.raises(tpages.KvPageError):
        tp.fetch(th)
    with pytest.raises(tpages.KvPageError):
        tp.stage(np.zeros(65, np.uint8))         # larger than a slot
    assert tp.stats() == jp.stats()
    assert tp.slots_free() == jp.slots_free() == 0


def test_host_pool_stages_tensor_pages_exactly():
    """A page of f32 k/v (the batcher spills card tensors) lands and
    comes back as the same bytes."""
    page = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 4, 2, 8)).astype(np.float32))
    pool = tpages.HostPagePool(2, page.numel() * 4)
    h = pool.stage(page)
    back = pool.fetch(h).view(torch.float32).reshape(page.shape)
    assert torch.equal(back, page)
    want = jpages.HostPagePool(2, page.numel() * 4)
    jh = want.stage(page.numpy().reshape(-1).view(np.uint8))
    assert _bytes(pool.fetch(h)) == _bytes(want.fetch(jh))


def test_host_pool_spill_brackets_and_drain_abort():
    jp, tp = _pools(2, 8)
    base = tpages.host_inflight_spills()
    for pool in (jp, tp):
        assert pool.begin_spill() and pool.begin_spill()
    assert tpages.host_inflight_spills() == base + 2
    assert tp.inflight() == jp.inflight() == 2
    for pool in (jp, tp):
        pool.end_spill()
        pool.drain_abort("kv_spill_drain_aborted")
        assert not pool.begin_spill()            # refused from now on
        assert pool.abort_reason() == "kv_spill_drain_aborted"
        pool.end_spill()
    assert tp.stats() == jp.stats()
    with pytest.raises(ValueError):
        tp.drain_abort("not_a_reason")
    with pytest.raises(tpages.KvPageError):
        tp.end_spill()                           # unbalanced bracket
