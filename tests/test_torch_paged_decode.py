"""The port's paged programs against the JAX package's, on the CPU:
``make_paged_batch_decode``'s step (slots at different positions, some
inactive), ``make_paged_io``'s gather, scatter, insert and chunk slice,
``make_paged_spec_verify`` with a draft the target confirms and one it
refutes, ``empty_paged_cache`` and ``paged_page_bytes``; inside the port,
the paged step against the contiguous step on the same context (equal
logits), the verify's rows against plain steps, and aliased prefix pages
left bit-unchanged by every program.

Params: the JAX ``init_params(PRNGKey(0))`` tree through numpy into
``params_from_numpy``; pools, block tables and inputs from numpy seeds.
Tolerances as in test_torch_batch_decode.py: logits 2e-2 absolute (2e-3
relative), KV rows 1e-2; data motion (gather, scatter, insert) is
bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.utils.convert import params_from_numpy

LOGIT_ATOL, LOGIT_RTOL = 2e-2, 2e-3
CACHE_ATOL = 1e-2
KW = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)
PAGE = 4
PPS = KW["max_seq"] // PAGE
HD = KW["dim"] // KW["heads"]
NUM_PAGES = 40


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jlm.LMConfig(**KW), tlm.LMConfig(**KW)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, tcfg, jp, tp


def _pool(lens, seed=0):
    """A random page pool (numpy) with the given per-slot lens."""
    rng = np.random.default_rng(seed)
    pool = {"len": np.asarray(lens, np.int32)}
    for i in range(KW["depth"]):
        for kind in ("pk", "pv"):
            pool[f"{kind}{i}"] = (rng.standard_normal(
                (NUM_PAGES, PAGE, KW["heads"], HD)) * 0.5).astype(np.float32)
    return pool


def _bt(rows):
    """A (slots, pps) block table with each slot's pages, zero-padded."""
    bt = np.zeros((len(rows), PPS), np.int32)
    for s, pages in enumerate(rows):
        bt[s, :len(pages)] = pages
    return bt


def _to_jax(pool):
    return {k: jnp.asarray(v) for k, v in pool.items()}


def _to_torch(pool):
    return {k: torch.from_numpy(v.copy()) for k, v in pool.items()}


def _assert_pools_close(tcache, jcache, pages=None):
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))
    for key in tcache:
        if key == "len":
            continue
        got, want = tcache[key].numpy(), np.asarray(jcache[key])
        if pages is not None:
            got, want = got[pages], want[pages]
        np.testing.assert_allclose(got, want, atol=CACHE_ATOL, err_msg=key)


# slot 0 at len 5 (pages 3, 4), slot 1 inactive (a zero row), slot 2 at
# len 17 (five pages), slot 3 at len 30 (eight pages, the last one full)
LENS = [5, 0, 17, 30]
ROWS = [[3, 4], [], [10, 11, 12, 13, 14], list(range(20, 28))]
ACTIVE = np.asarray([True, False, True, True])
TOKENS = np.asarray([3, 9, 42, 7], np.int32)


def test_paged_step_matches_jax(pair):
    jcfg, tcfg, jp, tp = pair
    pool, bt = _pool(LENS), _bt(ROWS)
    _, jstep = jlm.make_paged_batch_decode(jcfg, PAGE)
    _, tstep = tlm.make_paged_batch_decode(tcfg, PAGE, device="cpu")
    jcache, jlog = jax.jit(jstep)(jp, _to_jax(pool), jnp.asarray(bt),
                                  jnp.asarray(TOKENS), jnp.asarray(ACTIVE))
    tcache = _to_torch(pool)
    out, tlog = tstep(tp, tcache, torch.from_numpy(bt),
                      torch.from_numpy(TOKENS), torch.from_numpy(ACTIVE))
    assert out["pk0"] is tcache["pk0"]           # updated in place
    np.testing.assert_allclose(tlog.numpy()[ACTIVE],
                               np.asarray(jlog)[ACTIVE], atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    assert out["len"].dtype == torch.int32
    assert out["len"].tolist() == [6, 0, 18, 31]
    # page 0 takes the inactive slot's garbage row, in either framework
    _assert_pools_close(out, jcache, pages=slice(1, None))


def _contiguous_from_pages(pool, bt):
    """The contiguous pool holding the same context: slot b's stripe is
    its pages, in block-table order."""
    slots = bt.shape[0]
    out = {"len": pool["len"].copy()}
    for i in range(KW["depth"]):
        for kind in "kv":
            out[f"{kind}{i}"] = pool[f"p{kind}{i}"][bt].reshape(
                slots, KW["max_seq"], KW["heads"], HD).copy()
    return out


def test_paged_step_equals_contiguous_step(pair):
    """On the same context the paged step gives the contiguous step's
    logits exactly, and writes the same rows."""
    _, tcfg, _, tp = pair
    bt = _bt([[3, 4, 5, 6, 7, 8, 9, 1], [2] * PPS,
              [10, 11, 12, 13, 14, 15, 16, 17], list(range(20, 28))])
    pool = _pool(LENS, seed=3)
    contig = _contiguous_from_pages(pool, bt)
    _, pstep = tlm.make_paged_batch_decode(tcfg, PAGE, device="cpu")
    _, cstep = tlm.make_batch_decode(tcfg, device="cpu")
    active = np.ones(4, bool)
    pcache, plog = pstep(tp, _to_torch(pool), torch.from_numpy(bt),
                         torch.from_numpy(TOKENS), torch.from_numpy(active))
    ccache, clog = cstep(tp, _to_torch(contig), torch.from_numpy(TOKENS),
                         torch.from_numpy(active))
    # slot 1's row aliases one page eight times: its stripe is not a
    # context, so only the other slots are held
    keep = [0, 2, 3]
    assert torch.equal(plog[keep], clog[keep])
    assert pcache["len"].tolist() == ccache["len"].tolist()
    for s in keep:
        pos = LENS[s]
        page, row = bt[s, pos // PAGE], pos % PAGE
        for i in range(KW["depth"]):
            for kind in "kv":
                assert torch.equal(pcache[f"p{kind}{i}"][page, row],
                                   ccache[f"{kind}{i}"][s, pos])


def test_paged_step_clamps_and_page0_only_takes_garbage(pair):
    """An inactive slot at len max_seq and an active one at max_seq-1:
    the active one advances to max_seq, the inactive one stays, and no
    page outside page 0 and the active slot's last page changes."""
    jcfg, tcfg, jp, tp = pair
    ms = KW["max_seq"]
    pool = _pool([ms, ms - 1], seed=1)
    bt = _bt([[], list(range(30, 38))])
    active = np.asarray([False, True])
    _, tstep = tlm.make_paged_batch_decode(tcfg, PAGE, device="cpu")
    _, jstep = jlm.make_paged_batch_decode(jcfg, PAGE)
    jcache, _ = jax.jit(jstep)(jp, _to_jax(pool), jnp.asarray(bt),
                               jnp.asarray(TOKENS[:2]), jnp.asarray(active))
    tcache, _ = tstep(tp, _to_torch(pool), torch.from_numpy(bt),
                      torch.from_numpy(TOKENS[:2]), torch.from_numpy(active))
    assert tcache["len"].tolist() == [ms, ms]
    _assert_pools_close(tcache, jcache, pages=slice(1, None))
    changed = [p for p in range(NUM_PAGES)
               if not np.array_equal(tcache["pk0"].numpy()[p],
                                     pool["pk0"][p])]
    assert set(changed) <= {0, 37}


def test_gather_scatter_insert_match_jax_bit_exact(pair):
    jcfg, tcfg, jp, tp = pair
    pool = _pool(LENS, seed=2)
    ids = np.asarray([5, 9, 2, 0, 0, 0, 0, 0], np.int32)
    jg, js, ji = jlm.make_paged_io(jcfg, PAGE)
    tg, ts, ti = tlm.make_paged_io(tcfg, PAGE, device="cpu")
    want = np.asarray(jax.jit(jg)(_to_jax(pool), jnp.asarray(ids)))
    got = tg(_to_torch(pool), torch.from_numpy(ids))
    assert got.shape == (PPS, 2 * KW["depth"], PAGE, KW["heads"], HD)
    np.testing.assert_array_equal(got.numpy(), want)
    # scatter a new block into other pages (padding entries: page 0)
    blk = np.random.default_rng(7).standard_normal(want.shape).astype(
        np.float32)
    dst = np.asarray([11, 12, 13, 0, 0, 0, 0, 0], np.int32)
    jout = jax.jit(js)(_to_jax(pool), jnp.asarray(dst), jnp.asarray(blk))
    tout = ts(_to_torch(pool), torch.from_numpy(dst), torch.from_numpy(blk))
    for key in tout:
        if key != "len":
            np.testing.assert_array_equal(tout[key].numpy()[1:],
                                          np.asarray(jout[key])[1:])
    np.testing.assert_array_equal(tout["pv1"].numpy()[12], blk[1, 3])
    # a round trip lands the same bytes
    back = tg(tout, torch.from_numpy(dst)).numpy()
    np.testing.assert_array_equal(back[:3], blk[:3])
    # insert a batch-1 contiguous cache into a session's pages
    rng = np.random.default_rng(8)
    src = {f"{kind}{i}": rng.standard_normal(
        (1, KW["max_seq"], KW["heads"], HD)).astype(np.float32)
        for i in range(KW["depth"]) for kind in "kv"}
    row = np.asarray([21, 22, 23, 24, 25, 0, 0, 0], np.int32)
    jout = jax.jit(ji)(_to_jax(pool), jnp.asarray(row),
                       {k: jnp.asarray(v) for k, v in src.items()})
    tout = ti(_to_torch(pool), torch.from_numpy(row),
              {k: torch.from_numpy(v) for k, v in src.items()})
    for key in tout:
        if key != "len":
            np.testing.assert_array_equal(tout[key].numpy()[1:],
                                          np.asarray(jout[key])[1:])
    np.testing.assert_array_equal(tout["pk1"].numpy()[23],
                                  src["k1"][0, 2 * PAGE:3 * PAGE])


def test_chunk_prefill_matches_jax(pair):
    """A 13-token context chunk-filled into slot 1 in slices of 6 (the
    last padded, its padding on page 0), then a step; against JAX."""
    jcfg, tcfg, jp, tp = pair
    cw = 6
    ctx = np.random.default_rng(6).integers(0, 64, 13, dtype=np.int32)
    pool = _pool([3, 0, 9, 0], seed=4)
    rows = [[1, 2], list(range(5, 13)), [14, 15, 16], []]
    bt = _bt(rows)
    _, _, _, jchunk = jlm.make_paged_io(jcfg, PAGE, chunk=cw)
    _, _, _, tchunk = tlm.make_paged_io(tcfg, PAGE, chunk=cw, device="cpu")
    jcache, tcache = _to_jax(pool), _to_torch(pool)
    for start in range(0, len(ctx), cw):
        n = min(cw, len(ctx) - start)
        ids = np.zeros((cw,), np.int32)
        ids[:n] = ctx[start:start + n]
        jcache = jax.jit(jchunk)(jp, jcache, jnp.asarray(bt[1]),
                                 jnp.int32(1), jnp.int32(start),
                                 jnp.int32(n), jnp.asarray(ids))
        tcache = tchunk(tp, tcache, torch.from_numpy(bt[1]), 1, start, n,
                        torch.from_numpy(ids))
    assert tcache["len"].tolist() == [3, 13, 9, 0]
    # the context's rows (pages 5..8, the fourth holds row 12 only)
    for key in tcache:
        if key == "len":
            continue
        got = tcache[key].numpy()[5:12].reshape(-1, KW["heads"], HD)[:13]
        want = np.asarray(jcache[key])[5:12].reshape(
            -1, KW["heads"], HD)[:13]
        np.testing.assert_allclose(got, want, atol=CACHE_ATOL, err_msg=key)
        # pages outside slot 1's context and page 0 are untouched
        for p in [1, 2, 3, 4, 14, 15, 16] + list(range(13, NUM_PAGES)):
            if p not in (5, 6, 7, 8):
                np.testing.assert_array_equal(tcache[key].numpy()[p],
                                              pool[key][p])
    _, jstep = jlm.make_paged_batch_decode(jcfg, PAGE)
    _, tstep = tlm.make_paged_batch_decode(tcfg, PAGE, device="cpu")
    active = np.asarray([True, True, True, False])
    _, jlog = jax.jit(jstep)(jp, jcache, jnp.asarray(bt),
                             jnp.asarray(TOKENS), jnp.asarray(active))
    _, tlog = tstep(tp, tcache, torch.from_numpy(bt),
                    torch.from_numpy(TOKENS), torch.from_numpy(active))
    np.testing.assert_allclose(tlog.numpy()[1], np.asarray(jlog)[1],
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def _verify_both(pair, pool, bt, toks, active, width):
    jcfg, tcfg, jp, tp = pair
    jv = jlm.make_paged_spec_verify(jcfg, PAGE, width)
    tv = tlm.make_paged_spec_verify(tcfg, PAGE, width, device="cpu")
    jcache, jout, jm = jax.jit(jv)(jp, _to_jax(pool), jnp.asarray(bt),
                                   jnp.asarray(toks), jnp.asarray(active))
    tcache, tout, tm = tv(tp, _to_torch(pool), torch.from_numpy(bt),
                          torch.from_numpy(toks), torch.from_numpy(active))
    return (jcache, np.asarray(jout), np.asarray(jm)), (tcache, tout, tm)


@pytest.mark.parametrize("draft", ["confirmed", "refuted"])
def test_spec_verify_matches_jax(pair, draft):
    """Width 4 (k = 3): ``out``, ``m``, ``len`` and the pools against
    JAX; a confirmed draft is accepted to the cap k - 1, a refuted one
    at 0, and len advances by m + 1 on active slots only."""
    lens = [5, 0, 17, 9]
    rows = [[3, 4], [], [10, 11, 12, 13, 14], [20, 21, 22, 23]]
    pool, bt = _pool(lens, seed=5), _bt(rows)
    active = np.asarray([True, False, True, True])
    x0 = TOKENS[:, None]
    toks = np.concatenate([x0, np.full((4, 3), 1, np.int32)], axis=1)
    # three passes feeding JAX's own rows back make a draft it confirms
    for _ in range(3):
        (_, jout, _), _ = _verify_both(pair, pool, bt, toks, active, 4)
        toks = np.concatenate([x0, jout[:, :3]], axis=1).astype(np.int32)
    if draft == "refuted":
        toks[:, 1] = (toks[:, 1] + 1) % 64
    (jcache, jout, jm), (tcache, tout, tm) = _verify_both(
        pair, pool, bt, toks, active, 4)
    assert tout.dtype == tm.dtype == torch.int32
    np.testing.assert_array_equal(tout.numpy()[active], jout[active])
    np.testing.assert_array_equal(tm.numpy()[active], jm[active])
    want_m = 2 if draft == "confirmed" else 0
    assert tm.numpy()[active].tolist() == [want_m] * 3
    assert tcache["len"].tolist() == [
        n + (want_m + 1) * a for n, a in zip(lens, active)]
    _assert_pools_close(tcache, jcache, pages=slice(1, None))


def test_spec_verify_rows_equal_plain_steps(pair):
    """Row j of the verify's ``out`` is the token plain paged steps emit
    after feeding ``tokens[:, :j+1]``; its logits rows and written k/v
    rows follow the same arithmetic at width 4."""
    _, tcfg, _, tp = pair
    lens = [5, 17]
    pool, bt = _pool(lens, seed=6), _bt([[3, 4, 5], [10, 11, 12, 13, 14]])
    active = np.ones(2, bool)
    toks = np.asarray([[3, 8, 1, 60], [42, 5, 5, 7]], np.int32)
    tv = tlm.make_paged_spec_verify(tcfg, PAGE, 4, device="cpu")
    _, out, m = tv(tp, _to_torch(pool), torch.from_numpy(bt),
                   torch.from_numpy(toks), torch.from_numpy(active))
    _, step = tlm.make_paged_batch_decode(tcfg, PAGE, device="cpu")
    cache = _to_torch(pool)
    plain = []
    for j in range(4):
        cache, logits = step(tp, cache, torch.from_numpy(bt),
                             torch.from_numpy(toks[:, j].copy()),
                             torch.from_numpy(active))
        plain.append(torch.argmax(logits, -1))
    assert out.tolist() == torch.stack(plain, 1).tolist()
    match = (toks[:, 1:] == out.numpy()[:, :3]).astype(int)
    assert m.tolist() == np.minimum(np.cumprod(match, 1).sum(1), 2).tolist()


def _aliased_setup():
    """Slots 0 and 1 alias prefix pages 3 and 4 (8 tokens) and hold
    private pages after them; slot 0 sits at len 9, slot 1 at len 8."""
    pool = _pool([9, 8], seed=9)
    bt = _bt([[3, 4, 6, 7], [3, 4, 8, 9]])
    return pool, bt


def _assert_alias_untouched(cache, pool):
    for key in cache:
        if key != "len":
            for p in (3, 4):
                assert np.array_equal(cache[key].numpy()[p], pool[key][p]), \
                    (key, p)


def test_aliased_pages_unchanged_by_every_program(pair):
    """A plain round, a spec round and a catch-up slice past a
    page-aligned prefix never write the aliased pages."""
    _, tcfg, _, tp = pair
    pool, bt = _aliased_setup()
    active = np.ones(2, bool)
    _, step = tlm.make_paged_batch_decode(tcfg, PAGE, device="cpu")
    cache, _ = step(tp, _to_torch(pool), torch.from_numpy(bt),
                    torch.from_numpy(TOKENS[:2]), torch.from_numpy(active))
    _assert_alias_untouched(cache, pool)
    verify = tlm.make_paged_spec_verify(tcfg, PAGE, 4, device="cpu")
    toks = np.asarray([[3, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    cache, _, _ = verify(tp, _to_torch(pool), torch.from_numpy(bt),
                         torch.from_numpy(toks), torch.from_numpy(active))
    _assert_alias_untouched(cache, pool)
    *_, chunk = tlm.make_paged_io(tcfg, PAGE, chunk=6, device="cpu")
    cache = _to_torch(pool)
    ids = np.arange(6, dtype=np.int32)
    for start, n in ((8, 6), (14, 3)):       # covered = 8, page-aligned
        cache = chunk(tp, cache, torch.from_numpy(bt[1]), 1, start, n,
                      torch.from_numpy(ids))
    _assert_alias_untouched(cache, pool)
    assert cache["len"].tolist() == [9, 17]


def test_empty_paged_cache_and_page_bytes_match_jax():
    jcfg, tcfg = jlm.LMConfig(**KW), tlm.LMConfig(**KW)
    want = jlm.empty_paged_cache(jcfg, 9, 3, PAGE)
    got = tlm.empty_paged_cache(tcfg, 9, 3, PAGE, device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert not got[key].any()
    for page in (4, 16):
        assert tlm.paged_page_bytes(tcfg, page) \
            == jlm.paged_page_bytes(jcfg, page)
    big = dict(vocab=8192, dim=2048, heads=16, depth=8, max_seq=2048)
    assert tlm.paged_page_bytes(tlm.LMConfig(**big), 16) \
        == jlm.paged_page_bytes(jlm.LMConfig(**big), 16) == 2 * 2**20


def test_paged_programs_refuse_what_jax_refuses():
    cfg = tlm.LMConfig(**KW)
    for call in (lambda: tlm.make_paged_batch_decode(cfg, 5, device="cpu"),
                 lambda: tlm.empty_paged_cache(cfg, 4, 2, 5, device="cpu"),
                 lambda: tlm.make_paged_io(cfg, 5, device="cpu"),
                 lambda: tlm.make_paged_spec_verify(cfg, 5, 4,
                                                    device="cpu"),
                 lambda: tlm.make_paged_spec_verify(cfg, PAGE, 1,
                                                    device="cpu")):
        with pytest.raises(ValueError):
            call()
    scan = tlm.LMConfig(**KW, scan_layers=True)
    for call in (lambda: tlm.make_paged_batch_decode(scan, PAGE,
                                                     device="cpu"),
                 lambda: tlm.make_paged_spec_verify(scan, PAGE, 4,
                                                    device="cpu")):
        with pytest.raises(NotImplementedError):
            call()
