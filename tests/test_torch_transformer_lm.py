"""The port's TransformerLM serving path against the JAX package's, on the
CPU: the JAX ``init_params(PRNGKey(0))`` tree goes through numpy into
``params_from_numpy``; prefill logits and KV caches, decode-step logits,
int8 quantization and greedy tokens are compared.

Tolerances: every weight product is bf16 x bf16 with a bf16 result in
both frameworks, and the two CPU backends may sum in another order, so a
product element can differ by one bf16 rounding (2**-8 relative); logits
are held to 2e-2 absolute (2e-3 relative) at this size, KV caches, which
pass through one such product, to 1e-2.  quantize_int8 is bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.ops import quant as jquant
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.ops import quant as tquant
from brpc_tpu_torch.utils.convert import params_from_numpy

LOGIT_ATOL, LOGIT_RTOL = 2e-2, 2e-3
CACHE_ATOL = 1e-2


def _cfgs():
    kw = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, use_flash=True)
    return jlm.LMConfig(**kw), tlm.LMConfig(**kw)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, tcfg, jp, tp


def _prompt(b=2, s=9, seed=1, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def test_prefill_logits_and_caches(pair):
    jcfg, tcfg, jp, tp = pair
    ids = _prompt()
    jpre, _ = jlm.make_decode(jcfg)
    tpre, _ = tlm.make_decode(tcfg, device="cpu")
    jcache, jlog = jax.jit(jpre)(jp, jnp.asarray(ids))
    tcache, tlog = tpre(tp, torch.from_numpy(ids))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    assert tcache["len"] == int(jcache["len"]) == ids.shape[1]
    for i in range(jcfg.depth):
        for kind in ("k", "v"):
            got = tcache[f"{kind}{i}"]
            assert got.dtype == torch.float32
            assert tuple(got.shape) == (2, 32, 4, 8)
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(jcache[f"{kind}{i}"]),
                                       atol=CACHE_ATOL)


@pytest.mark.parametrize("quantize", [False, True])
def test_decode_steps(pair, quantize):
    jcfg, tcfg, jp, tp = pair
    if quantize:
        jp = jquant.quantize_lm_params(jp)
        tp = tquant.quantize_lm_params(tp)
    ids = _prompt(b=1, s=5, seed=2)
    jpre, jstep = (jax.jit(f) for f in jlm.make_decode(jcfg))
    tpre, tstep = tlm.make_decode(tcfg, device="cpu")
    jcache, _ = jpre(jp, jnp.asarray(ids))
    tcache, _ = tpre(tp, torch.from_numpy(ids))
    for tok in (3, 17, 42, 8):
        jcache, jlog = jstep(jp, jcache, jnp.asarray([tok], jnp.int32))
        tcache, tlog = tstep(tp, tcache, torch.tensor([tok]))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    assert tcache["len"] == 5 + 4


def test_quantize_int8_bit_identical():
    w = np.random.default_rng(3).standard_normal((48, 40)).astype(np.float32)
    w[0, 0] = 0.0
    for axis in (0, 1):
        jq = jquant.quantize_int8(jnp.asarray(w), contract_axis=axis)
        tq = tquant.quantize_int8(torch.from_numpy(w), contract_axis=axis)
        assert tq.q.dtype == torch.int8
        np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
        np.testing.assert_array_equal(tq.s.numpy(), np.asarray(jq.s))


@pytest.mark.parametrize("quantize", [False, True])
def test_qmatmul(quantize):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) / 7).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if quantize:
        jw, tw = jquant.quantize_int8(jw), tquant.quantize_int8(tw)
    got = tquant.qmatmul(torch.from_numpy(x), tw)
    want = jquant.qmatmul(jnp.asarray(x), jw)
    assert got.dtype == torch.float32
    # one bf16 rounding of the product apart at most
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(tquant.dequantize(tw).numpy(),
                               np.asarray(jquant.dequantize(jw)))
    assert tquant.quantized_nbytes({"w": tw}) == \
        jquant.quantized_nbytes({"w": jw})


def _margins_ok(tcfg, tp, ids, max_new):
    """Every greedy pick's top-1 margin exceeds the logit tolerance, so
    the framework difference cannot flip an argmax."""
    pre, step = tlm.make_decode(tcfg, device="cpu")
    cache, logits = pre(tp, torch.from_numpy(ids))
    for i in range(max_new):
        top2 = torch.topk(logits, 2, dim=-1).values
        if (top2[:, 0] - top2[:, 1]).min() <= 4 * LOGIT_ATOL:
            return False
        tok = torch.argmax(logits, dim=-1)
        if i < max_new - 1:
            cache, logits = step(tp, cache, tok)
    return True


def test_greedy_tokens_match(pair):
    jcfg, tcfg, jp, tp = pair
    max_new = 6
    for seed in range(40):
        ids = _prompt(b=1, s=7, seed=100 + seed)
        if _margins_ok(tcfg, tp, ids, max_new):
            break
    else:
        pytest.fail("no prompt with clear top-1 margins among 40 seeds")
    want = np.asarray(jlm.make_scan_generator(jcfg, jp)(
        jnp.asarray(ids), max_new))
    got = tlm.make_scan_generator(tcfg, tp, device="cpu")(
        torch.from_numpy(ids), max_new)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, max_new)
    np.testing.assert_array_equal(got.numpy(), want)
    again = tlm.make_generator(tcfg, tp, device="cpu")(
        torch.from_numpy(ids), max_new)
    np.testing.assert_array_equal(again.numpy(), want)


def test_sampling_reproducible_and_validated(pair):
    _, tcfg, _, tp = pair
    gen = tlm.make_scan_generator(tcfg, tp, device="cpu")
    ids = torch.from_numpy(_prompt(b=2, s=4, seed=5))
    a = gen(ids, 5, 0.8, torch.Generator().manual_seed(7))
    b = gen(ids, 5, 0.8, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and a.shape == (2, 5)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab
    with pytest.raises(ValueError, match="Generator"):
        gen(ids, 5, 0.8)
    with pytest.raises(ValueError, match="max_seq"):
        gen(ids, 40)


def test_unported_configs_raise():
    """MoE and scan_layers configs build make_decode and init_params; only
    their combination raises in make_decode, with the JAX package's
    text."""
    for kw in (dict(moe_experts=2), dict(scan_layers=True)):
        assert len(tlm.make_decode(tlm.LMConfig(**kw), device="cpu")) == 2
    moe = tlm.init_params(torch.Generator(), tlm.LMConfig(moe_experts=2),
                          device="cpu")
    assert set(moe["blk0"]) == {"wqkv", "wo", "ln1", "ln2", "moe"}
    scan = tlm.init_params(torch.Generator(), tlm.LMConfig(scan_layers=True),
                           device="cpu")
    assert set(scan) == {"embed", "unembed", "blocks"}
    both = dict(moe_experts=2, scan_layers=True)
    with pytest.raises(NotImplementedError, match="MoE") as ours:
        tlm.make_decode(tlm.LMConfig(**both), device="cpu")
    with pytest.raises(NotImplementedError) as theirs:
        jlm.make_decode(jlm.LMConfig(**both))
    assert str(ours.value) == str(theirs.value)


def test_init_params_layout():
    cfg = tlm.LMConfig(vocab=64, dim=32, heads=4, depth=2, max_seq=32)
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(
        vocab=64, dim=32, heads=4, depth=2, max_seq=32))
    tp = tlm.init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    assert set(tp) == set(jp)
    for k in jp["blk0"]:
        assert tuple(tp["blk0"][k].shape) == jp["blk0"][k].shape
    # the same scale as the JAX init: std 1/sqrt(dim)
    assert abs(float(tp["embed"].std()) * np.sqrt(32) - 1.0) < 0.1
