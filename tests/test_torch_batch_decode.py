"""The port's continuous-batching programs against the JAX package's, on
the CPU: the per-slot rope helpers, one batch ``step`` with slots at
different positions and some inactive, the chunked-prefill slice, the
inactive-slot clamp, a slot against a solo decode, ``make_decode_loop``;
and flash attention at a head dim past the kernels' 128 (the plain path)
against the JAX kernel in interpret mode.

Params: the JAX ``init_params(PRNGKey(0))`` tree through numpy into
``params_from_numpy``; pools and inputs from numpy seeds.  Tolerances as
in test_torch_transformer_lm.py: every weight product is bf16 in both
frameworks and the CPU backends may sum in another order, so logits are
held to 2e-2 absolute (2e-3 relative) and KV rows, one such product
away, to 1e-2; the rope helpers, f32 elementwise, to 1e-6.  Flash
attention at d = 256: the forward to 2e-5 and the gradients to 2e-4 /
2e-5, the tolerances of test_flash_attention.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.ops import flash_attention as jfa
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.ops import flash_attention as tfa
from brpc_tpu_torch.utils.convert import params_from_numpy

LOGIT_ATOL, LOGIT_RTOL = 2e-2, 2e-3
CACHE_ATOL = 1e-2
ROPE_TOL = 1e-6
KW = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)
SLOTS = 4


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jlm.LMConfig(**KW), tlm.LMConfig(**KW)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, tcfg, jp, tp


def _pool(lens, seed=0):
    """A random pool (as numpy) with the given per-slot lens."""
    rng = np.random.default_rng(seed)
    hd = KW["dim"] // KW["heads"]
    pool = {"len": np.asarray(lens, np.int32)}
    for i in range(KW["depth"]):
        for kind in "kv":
            pool[f"{kind}{i}"] = (rng.standard_normal(
                (len(lens), KW["max_seq"], KW["heads"], hd)) * 0.5
                                  ).astype(np.float32)
    return pool


def _to_jax(pool):
    return {k: jnp.asarray(v) for k, v in pool.items()}


def _to_torch(pool):
    return {k: torch.from_numpy(v.copy()) for k, v in pool.items()}


def _assert_pools_close(tcache, jcache, rows=None):
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))
    for key in tcache:
        if key == "len":
            continue
        got, want = tcache[key].numpy(), np.asarray(jcache[key])
        if rows is not None:
            got, want = got[rows], want[rows]
        np.testing.assert_allclose(got, want, atol=CACHE_ATOL, err_msg=key)


@pytest.mark.parametrize("fn", ["_rope_at_vec", "_rope_span_vec"])
def test_rope_helpers_match_jax(fn):
    rng = np.random.default_rng(4)
    hd = 16
    if fn == "_rope_at_vec":
        x = rng.standard_normal((5, 1, 3, hd)).astype(np.float32)
        pos = np.asarray([0, 3, 17, 255, 2047], np.int32)
    else:
        x = rng.standard_normal((2, 6, 3, hd)).astype(np.float32)
        pos = 1000 + np.arange(6, dtype=np.int32)
    want = np.asarray(getattr(jlm, fn)(jnp.asarray(x), jnp.asarray(pos), hd))
    got = getattr(tlm, fn)(torch.from_numpy(x), torch.from_numpy(pos), hd)
    np.testing.assert_allclose(got.numpy(), want, atol=ROPE_TOL,
                               rtol=ROPE_TOL)


def test_rope_span_equals_whole_prompt_tables():
    """A span at start..start+n rotates as rows start.. of the whole
    prompt's tables."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 4, 2, 8)).astype(np.float32))
    sin, cos = tlm._rope_tables(12, 8)
    whole = tlm._rope(x, sin[:, 8:12], cos[:, 8:12])
    torch.testing.assert_close(tlm._rope_span_vec(x, torch.arange(8, 12), 8),
                               whole)


def test_step_matches_jax(pair):
    """Slots at different positions, one inactive: logits of the active
    slots, the written rows and the advanced lens match the JAX step."""
    jcfg, tcfg, jp, tp = pair
    pool = _pool([5, 0, 17, 30])
    tokens = np.asarray([3, 9, 42, 7], np.int32)
    active = np.asarray([True, False, True, True])
    _, jstep = jlm.make_batch_decode(jcfg)
    _, tstep = tlm.make_batch_decode(tcfg, device="cpu")
    tcache = _to_torch(pool)
    jcache, jlog = jax.jit(jstep)(jp, _to_jax(pool), jnp.asarray(tokens),
                                  jnp.asarray(active))
    out, tlog = tstep(tp, tcache, torch.from_numpy(tokens),
                      torch.from_numpy(active))
    assert out[f"k0"] is tcache["k0"]            # updated in place
    np.testing.assert_allclose(tlog.numpy()[active],
                               np.asarray(jlog)[active], atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    assert out["len"].dtype == torch.int32
    assert out["len"].tolist() == [6, 0, 18, 31]
    _assert_pools_close(out, jcache)


def test_step_clamps_inactive_slots(pair):
    """An inactive slot at len max_seq writes its garbage row at max_seq-1
    and does not advance; an active one at max_seq-1 advances to
    max_seq."""
    jcfg, tcfg, jp, tp = pair
    ms = KW["max_seq"]
    pool = _pool([ms, ms - 1, 4, ms], seed=1)
    tokens = np.asarray([1, 2, 3, 4], np.int32)
    active = np.asarray([False, True, True, False])
    _, jstep = jlm.make_batch_decode(jcfg)
    _, tstep = tlm.make_batch_decode(tcfg, device="cpu")
    jcache, _ = jax.jit(jstep)(jp, _to_jax(pool), jnp.asarray(tokens),
                               jnp.asarray(active))
    tcache, _ = tstep(tp, _to_torch(pool), torch.from_numpy(tokens),
                      torch.from_numpy(active))
    assert tcache["len"].tolist() == [ms, ms, 5, ms]
    _assert_pools_close(tcache, jcache)
    # the rows below the clamp are untouched
    np.testing.assert_array_equal(tcache["k1"].numpy()[0, :ms - 1],
                                  pool["k1"][0, :ms - 1])


def _chunk_fill(chunk_step, params, cache, slot, ctx, cw, to_ids):
    for start in range(0, len(ctx), cw):
        n = min(cw, len(ctx) - start)
        ids = np.zeros((cw,), np.int32)
        ids[:n] = ctx[start:start + n]
        cache = chunk_step(params, cache, slot, start, n, to_ids(ids))
    return cache


def test_chunk_step_matches_jax_and_whole_prefill(pair):
    """A context chunk-filled into slot 1 (13 tokens in slices of 4, the
    last one padded) matches the JAX chunk_step, and a whole-prompt
    insert of the same context in the port; the next step's logits match
    too."""
    jcfg, tcfg, jp, tp = pair
    cw = 4
    ctx = np.random.default_rng(6).integers(0, 64, 13, dtype=np.int32)
    pool = _pool([3, 0, 9, 0], seed=2)
    pool["len"][1] = 0
    tpre, tstep, tchunk = tlm.make_batch_decode(tcfg, chunk=cw,
                                                device="cpu")
    _, jstep, jchunk = jlm.make_batch_decode(jcfg, chunk=cw)
    jcache = _chunk_fill(jchunk, jp, _to_jax(pool), jnp.int32(1), ctx, cw,
                         jnp.asarray)
    tcache = _chunk_fill(tchunk, tp, _to_torch(pool), 1, ctx, cw,
                         torch.from_numpy)
    assert tcache["len"].tolist() == [3, 13, 9, 0]
    # rows 0..12 of slot 1 are the context; row max_seq-1 took the
    # padding's garbage, the others are untouched
    _assert_pools_close(tcache, jcache, rows=(1, slice(0, 13)))
    np.testing.assert_array_equal(tcache["v0"].numpy()[1, 13:-1],
                                  pool["v0"][1, 13:-1])
    # whole-prompt insert of the same context into slot 1
    cache1, _ = tpre(tp, torch.from_numpy(ctx[None]))
    for key in cache1:
        if key != "len":
            np.testing.assert_allclose(tcache[key].numpy()[1, :13],
                                       cache1[key].numpy()[0, :13],
                                       atol=CACHE_ATOL, err_msg=key)
    tokens = np.asarray([5, 11, 6, 0], np.int32)
    active = np.asarray([True, True, True, False])
    jcache, jlog = jstep(jp, jcache, jnp.asarray(tokens),
                         jnp.asarray(active))
    tcache, tlog = tstep(tp, tcache, torch.from_numpy(tokens),
                         torch.from_numpy(active))
    np.testing.assert_allclose(tlog.numpy()[1], np.asarray(jlog)[1],
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def test_batch_slot_matches_solo_decode(pair):
    """Counterpart of test_lm_decode.py's
    test_batch_decode_matches_solo_decode: a session inserted into slot 2
    of an otherwise idle pool produces the tokens of a solo generation."""
    _, tcfg, _, tp = pair
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (1, 8), dtype=np.int32))
    prefill, step = tlm.make_batch_decode(tcfg, device="cpu")
    cache = tlm.empty_batch_cache(tcfg, SLOTS, device="cpu")
    assert cache["len"].dtype == torch.int32 and cache["len"].shape == (4,)
    c1, logits = prefill(tp, prompt)
    for i in range(tcfg.depth):
        cache[f"k{i}"][2] = c1[f"k{i}"][0]
        cache[f"v{i}"][2] = c1[f"v{i}"][0]
    cache["len"][2] = prompt.shape[1]
    active = torch.zeros(SLOTS, dtype=torch.bool)
    active[2] = True
    toks = [int(torch.argmax(logits[0]))]
    tokens = torch.zeros(SLOTS, dtype=torch.int32)
    tokens[2] = toks[0]
    for _ in range(5):
        cache, lg = step(tp, cache, tokens, active)
        toks.append(int(torch.argmax(lg[2])))
        tokens[2] = toks[-1]
    want = tlm.generate(tp, tcfg, prompt, 6, device="cpu")[0].tolist()
    assert toks == want


def test_decode_loop_matches_jax(pair):
    """make_decode_loop: greedy tokens of a prefilled cache, as the JAX
    scan gives them (a prompt whose picks clear the logit tolerance)."""
    jcfg, tcfg, jp, tp = pair
    steps = 4
    tpre, tloop = tlm.make_decode_loop(tcfg, steps, device="cpu")
    jpre, jloop = jlm.make_decode_loop(jcfg, steps)
    for seed in range(40):
        ids = np.random.default_rng(300 + seed).integers(0, 64, (2, 6),
                                                         dtype=np.int32)
        tcache, tlog = tpre(tp, torch.from_numpy(ids))
        if _margins(tcfg, tp, tcache, tlog, steps) > 0.08:
            break
    else:
        pytest.fail("no prompt with clear top-1 margins among 40 seeds")
    tcache, tlog = tpre(tp, torch.from_numpy(ids))
    tok = torch.argmax(tlog, -1)
    tcache, ttoks = tloop(tp, tcache, tok)
    jcache, jlog = jax.jit(jpre)(jp, jnp.asarray(ids))
    jcache, jtoks = jax.jit(jloop)(jp, jcache,
                                   jnp.argmax(jlog, -1).astype(jnp.int32))
    assert ttoks.shape == (steps, 2) and ttoks.dtype == torch.int32
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert tcache["len"] == int(jcache["len"]) == 6 + steps


def _margins(cfg, params, cache, logits, steps):
    """The smallest top-1 minus top-2 logit over ``steps`` greedy steps."""
    cache = {k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in cache.items()}
    _, step = tlm.make_decode(cfg, device="cpu")
    worst = float("inf")
    for _ in range(steps + 1):
        top2 = torch.topk(logits, 2, dim=-1).values
        worst = min(worst, float((top2[:, 0] - top2[:, 1]).min()))
        cache, logits = step(params, cache, torch.argmax(logits, -1))
    return worst


def test_moe_and_scan_layers_raise():
    """MoE blocks build the batch programs and pool; scan_layers raises
    in make_batch_decode with the JAX text, and its pool is stacked, as
    the JAX package's empty_batch_cache gives it."""
    moe = tlm.LMConfig(**KW, moe_experts=2)
    assert len(tlm.make_batch_decode(moe, chunk=4, device="cpu")) == 3
    assert set(tlm.empty_batch_cache(moe, 2, device="cpu")) \
        == set(jlm.empty_batch_cache(jlm.LMConfig(**KW, moe_experts=2), 2))
    scan = tlm.LMConfig(**KW, scan_layers=True)
    with pytest.raises(NotImplementedError) as ours:
        tlm.make_batch_decode(scan, device="cpu")
    with pytest.raises(NotImplementedError) as theirs:
        jlm.make_batch_decode(jlm.LMConfig(**KW, scan_layers=True))
    assert str(ours.value) == str(theirs.value)
    pool = tlm.empty_batch_cache(scan, 2, device="cpu")
    assert set(pool) == {"len", "k", "v"}
    assert tuple(pool["k"].shape) == (KW["depth"], 2, KW["max_seq"],
                                      KW["heads"], KW["dim"] // KW["heads"])


def _wide_head_qkvg():
    rng = np.random.default_rng(256)
    return [(rng.standard_normal((1, 40, 2, 256)) * 0.5).astype(np.float32)
            for _ in range(4)]


def test_flash_head_dim_256_forward_matches_jax():
    """Queue C1: the plain flash path takes d = 256 (the kernels stop at
    128), as the JAX kernel does by padding d."""
    q, k, v, _ = _wide_head_qkvg()
    want, wlse = jfa._pallas_forward(*(jnp.asarray(x) for x in (q, k, v)),
                                     True, None, None, True)
    got, lse = tfa.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(wlse)[:, :, :40, 0],
                               rtol=2e-5, atol=2e-5)
    out = tfa.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                        causal=True, impl="flash")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_head_dim_256_gradients_match_jax():
    q, k, v, g = _wide_head_qkvg()

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, True) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (tfa.attention(*ts, causal=True, impl="flash")
     * torch.from_numpy(g)).sum().backward()
    for name, t, w in zip("qkv", ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5, err_msg=f"d{name}")
