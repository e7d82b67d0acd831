"""Stacked ``scan_layers`` params in the port against the JAX package's, on
the CPU: the stacked init layout, ``quantize_lm_params`` on a stacked
tree (per-(layer, out-channel) scales), the numpy carry-over and a
checkpoint round trip, ``make_decode`` over stacked caches (f32 and
int8, against JAX's scan and against the port's own unrolled twin),
``make_forward`` and the train step with scan + MoE + flash,
``LMService`` Generate (int8) over RPC and its ``Decode`` refusal, and
every refusal the JAX package keeps for ``scan_layers``, with its words.

Params come from the JAX ``init_params(PRNGKey(0))`` through numpy.  The
port runs a stacked tree as a Python loop over per-layer views, so its
tokens, logits and caches equal its unrolled twin's bit for bit.
Against JAX: int8 values and scales exactly; logits within 2e-2 absolute
(2e-3 relative), as in test_torch_transformer_lm.py, and KV rows within
2e-2 (three layers of bf16 products, up to 1.2e-2 apart under int8 on
the CPU, where two layers stay inside that file's 1e-2); the train step
with MoE as in test_torch_moe_lm.py (loss 1e-4 relative, gradients
``‖Δg‖ / ‖g‖ <= 1e-2``, inputs kept only where the port's router
margins clear 2e-3).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import Controller as JController
from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.ops import quant as jquant
from brpc_tpu.server import Server as JServer
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.ops import quant as tquant
from brpc_tpu_torch.streaming import StreamOptions, stream_create
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.utils.checkpoint import TrainCheckpointer, abstract_like
from brpc_tpu_torch.utils.convert import params_from_numpy, params_to_numpy

from test_torch_moe_lm import RouterMargins

LOGIT_ATOL, LOGIT_RTOL = 2e-2, 2e-3
CACHE_ATOL = 2e-2
ROUTE_MARGIN = 2e-3
LOSS_RTOL = 1e-4
GRAD_REL_NORM = 1e-2
KW = dict(vocab=64, dim=32, heads=4, depth=3, max_seq=32, remat=False)
SCAN = dict(KW, scan_layers=True)
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity=1.0)
TIMEOUT_MS = 120_000


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    """JAX stacked params and the port's, plus both unrolled twins (the
    same weights, one ``blk{i}`` per layer)."""
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**SCAN))
    tp = params_from_numpy(_np(jp), device="cpu")
    tp_unrolled = {"embed": tp["embed"], "unembed": tp["unembed"]}
    for i in range(KW["depth"]):
        tp_unrolled[f"blk{i}"] = {k: v[i].clone()
                                  for k, v in tp["blocks"].items()}
    return jp, tp, tp_unrolled


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_stacked_init_layout_matches_jax(moe):
    kw = dict(SCAN, **(MOE if moe else {}))
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**kw))
    tp = tlm.init_params(torch.Generator().manual_seed(0),
                         tlm.LMConfig(**kw), device="cpu")
    assert list(tp) == list(jp) == ["embed", "unembed", "blocks"]
    assert _shapes(tp) == _shapes(jp)
    if moe:
        assert tp["blocks"]["moe"]["w1"].shape == (3, 4, 32, 128)
    # each layer is its own draw, not one layer repeated
    assert not torch.equal(tp["blocks"]["wqkv"][0], tp["blocks"]["wqkv"][1])


def test_stacked_quantize_matches_jax(params):
    jp, tp, _ = params
    jq = jquant.quantize_lm_params(jp)
    tq = tquant.quantize_lm_params(tp)
    for key in ("wqkv", "wo", "w1", "w2"):
        got, want = tq["blocks"][key], jq["blocks"][key]
        assert isinstance(got, tquant.QuantTensor)
        assert got.q.shape == want.q.shape and got.s.shape == want.s.shape
        assert got.s.shape == (KW["depth"], want.q.shape[-1])
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    assert isinstance(tq["unembed"], tquant.QuantTensor)
    assert tq["blocks"]["ln1"] is tp["blocks"]["ln1"]
    assert tquant.quantized_nbytes(tq) == jquant.quantized_nbytes(jq)
    # an MoE subtree stays f32 in a stacked tree, as in JAX
    jm = jlm.init_params(jax.random.PRNGKey(1),
                         jlm.LMConfig(**SCAN, **MOE))
    tm = tquant.quantize_lm_params(params_from_numpy(_np(jm), "cpu"))
    assert tm["blocks"]["moe"]["w1"].dtype == torch.float32
    assert tquant.quantized_nbytes(tm) == jquant.quantized_nbytes(
        jquant.quantize_lm_params(jm))


def test_numpy_and_checkpoint_round_trips(params, tmp_path):
    jp, tp, _ = params
    jm = jlm.init_params(jax.random.PRNGKey(1), jlm.LMConfig(**SCAN, **MOE))
    for tree in (_np(jp), _np(jquant.quantize_lm_params(jp)), _np(jm)):
        back = params_to_numpy(params_from_numpy(tree, "cpu"))
        flat_a = jax.tree_util.tree_leaves(tree)
        flat_b = jax.tree_util.tree_leaves(back)
        assert len(flat_a) == len(flat_b)
        for a, b in zip(flat_a, flat_b):
            np.testing.assert_array_equal(a, b)
    tm = params_from_numpy(_np(jm), "cpu")
    for i, state in enumerate(({"params": tp, "step": 3},
                               {"params": tm, "step": 4})):
        ckpt = TrainCheckpointer(str(tmp_path / f"run{i}"))
        ckpt.save(state["step"], state)
        got = ckpt.restore(like=abstract_like(state))
        ckpt.close()
        assert got["step"] == state["step"]
        want = tlm.tree_leaves(state["params"])
        back = tlm.tree_leaves(got["params"])
        assert len(back) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(back, want))


def _prompt(b=2, s=7, seed=3):
    return np.random.default_rng(seed).integers(0, KW["vocab"], (b, s),
                                                dtype=np.int32)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_scanned_decode_matches_jax_and_unrolled(params, quantize):
    jp, tp, tpu = params
    if quantize:
        jp = jquant.quantize_lm_params(jp)
        tp, tpu = tquant.quantize_lm_params(tp), \
            tquant.quantize_lm_params(tpu)
    ids = _prompt()
    scan, unrolled = tlm.LMConfig(**SCAN), tlm.LMConfig(**KW)
    spre, sstep = tlm.make_decode(scan, device="cpu")
    upre, ustep = tlm.make_decode(unrolled, device="cpu")
    jpre, jstep = (jax.jit(f) for f in jlm.make_decode(jlm.LMConfig(**SCAN)))
    scache, slog = spre(tp, torch.from_numpy(ids))
    ucache, ulog = upre(tpu, torch.from_numpy(ids))
    jcache, jlog = jpre(jp, jnp.asarray(ids))
    assert scache["k"].shape == (KW["depth"], 2, KW["max_seq"], 4, 8)
    assert torch.equal(slog, ulog)
    np.testing.assert_allclose(slog.numpy(), np.asarray(jlog),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    for step in range(4):
        tok = torch.argmax(slog, -1)
        scache, slog = sstep(tp, scache, tok)
        ucache, ulog = ustep(tpu, ucache, tok)
        jcache, jlog = jstep(jp, jcache, jnp.asarray(tok.numpy(), jnp.int32))
        assert torch.equal(slog, ulog), step
        np.testing.assert_allclose(slog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    for i in range(KW["depth"]):
        assert torch.equal(scache["k"][i], ucache[f"k{i}"])
        assert torch.equal(scache["v"][i], ucache[f"v{i}"])
    np.testing.assert_allclose(scache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=CACHE_ATOL)
    assert scache["len"] == int(jcache["len"]) == 11
    empty = tlm.empty_cache(scan, 2, device="cpu")
    jempty = jlm.empty_cache(jlm.LMConfig(**SCAN), 2)
    assert set(empty) == set(jempty) == {"len", "k", "v"}
    assert tuple(empty["k"].shape) == jempty["k"].shape
    assert empty["k"].data_ptr() != empty["v"].data_ptr()
    # the generators take the stacked config through make_decode
    gen = tlm.make_scan_generator(scan, tp, device="cpu")
    np.testing.assert_array_equal(
        gen(torch.from_numpy(ids), 5).numpy(),
        tlm.make_scan_generator(unrolled, tpu, "cpu")(
            torch.from_numpy(ids), 5).numpy())
    _, loop = tlm.make_decode_loop(scan, 3, device="cpu")
    cache, logits = spre(tp, torch.from_numpy(ids))
    _, toks = loop(tp, cache, torch.argmax(logits, -1))
    assert toks.shape == (3, 2)


def test_scan_moe_flash_train_step_matches_jax():
    """make_forward and one train step with scan + MoE + flash (remat on):
    JAX scans the stacked blocks, the port loops over their views."""
    kw = dict(SCAN, **MOE, use_flash=True, remat=True)
    jcfg, tcfg = jlm.LMConfig(**kw), tlm.LMConfig(**kw)
    jp = jlm.init_params(jax.random.PRNGKey(2), jcfg)
    tp = params_from_numpy(_np(jp), "cpu")
    fwd = tlm.make_forward(tcfg, device="cpu")
    for seed in range(200):
        ids = np.random.default_rng(seed).integers(0, 64, (2, 16),
                                                   dtype=np.int32)
        with RouterMargins() as m:
            fwd(tp, torch.from_numpy(ids))
        if m.worst >= ROUTE_MARGIN:
            break
    else:
        pytest.fail("no batch clears the router margin")
    labels = np.roll(ids, -1, axis=-1)
    tl, ta = fwd(tp, torch.from_numpy(ids), with_aux=True)
    jl, ja = jax.jit(functools.partial(jlm.make_forward(jcfg),
                                       with_aux=True))(jp, jnp.asarray(ids))
    err = np.abs(tl.detach().numpy() - np.asarray(jl)).max()
    assert err <= 2e-2 * np.abs(np.asarray(jl)).max()
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-4)
    lr = 0.5
    jnew, jloss = jax.jit(jlm.make_train_step(jcfg))(
        jp, jnp.asarray(ids), jnp.asarray(labels), lr)
    tnew, tloss = tlm.make_train_step(tcfg, device="cpu")(
        tp, torch.from_numpy(ids), torch.from_numpy(labels), lr)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    old = jax.tree_util.tree_leaves_with_path(_np(jp))
    new_j = jax.tree_util.tree_leaves(_np(jnew))
    new_t = jax.tree_util.tree_leaves(params_to_numpy(tnew))
    assert len(old) == len(new_j) == len(new_t)
    for (path, o), a, b in zip(old, new_j, new_t):
        gj, gt = (o - a) / lr, (o - b) / lr
        rel = np.linalg.norm(gt - gj) / max(np.linalg.norm(gj), 1e-30)
        assert rel <= GRAD_REL_NORM, (path, rel)


@pytest.fixture(scope="module")
def servers(params):
    """Port and JAX LMServices of the stacked config, int8, and a port
    service of the unrolled twin."""
    jp, tp, tpu = params
    tsrv, jsrv = Server(), JServer()
    port = tsvc.LMService(cfg=tlm.LMConfig(**SCAN), params=tp,
                          device="cpu", quantize=True)
    twin = tsvc.LMService(cfg=tlm.LMConfig(**KW), params=tpu, device="cpu",
                          quantize=True)
    assert tsrv.add_service(port, name="LM") == 0
    assert tsrv.add_service(twin, name="LMUnrolled") == 0
    assert jsrv.add_service(jsvc.LMService(cfg=jlm.LMConfig(**SCAN),
                                           params=jp, quantize=True),
                            name="LM") == 0
    assert tsrv.start("127.0.0.1:0") == 0 and jsrv.start("127.0.0.1:0") == 0
    yield tsrv, jsrv, port
    tsrv.stop()
    jsrv.stop()


def _call(ch, method, req, cntl):
    cntl.timeout_ms = TIMEOUT_MS
    return ch.call_method(method, req, cntl=cntl)


def _clear_prompt(tp):
    """A prompt whose greedy picks on the stacked int8 service all have a
    top-1 margin above 0.08."""
    cfg = tlm.LMConfig(**SCAN)
    q = tquant.quantize_lm_params(tp)
    pre, step = tlm.make_decode(cfg, device="cpu")
    for seed in range(60):
        ids = _prompt(b=2, s=6, seed=200 + seed)
        cache, logits = pre(q, torch.from_numpy(ids))
        for i in range(4):
            top2 = torch.topk(logits, 2, dim=-1).values
            if (top2[:, 0] - top2[:, 1]).min() <= 0.08:
                break
            cache, logits = step(q, cache, torch.argmax(logits, -1))
        else:
            return ids
    pytest.fail("no prompt with clear top-1 margins among 60 seeds")


def test_scan_int8_generate_matches_jax(servers, params):
    tsrv, jsrv, port = servers
    ids = _clear_prompt(params[1])
    req = tsvc.pack_generate_request(ids, 4)
    ch, jch = Channel(), JChannel()
    ch.init(str(tsrv.listen_endpoint))
    jch.init(str(jsrv.listen_endpoint))
    ours = _call(ch, "LM.Generate", req, Controller())
    twin = _call(ch, "LMUnrolled.Generate", req, Controller())
    theirs = _call(jch, "LM.Generate", req, JController())
    info = json.loads(ch.call("LM.Info", b"", timeout_ms=TIMEOUT_MS))
    ch.close()
    assert not ours.failed and not twin.failed and not theirs.failed
    got = tsvc.unpack_generated(ours.response)
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got, tsvc.unpack_generated(twin.response))
    np.testing.assert_array_equal(got, jsvc.unpack_generated(theirs.response))
    assert info["quantized"] is True and info["depth"] == KW["depth"]
    assert info["param_bytes"] == port._param_bytes == \
        jquant.quantized_nbytes(jquant.quantize_lm_params(params[0]))


@pytest.mark.parametrize("client", ["port", "jax"])
def test_scan_decode_answers_erequest_as_jax(servers, client):
    """Decode refuses a stacked config with the JAX text and errno, before
    it accepts the stream."""
    tsrv, jsrv, _ = servers
    req = tsvc.pack_generate_request(np.zeros((1, 4), np.int32), 2)
    answers = []
    for ep in (tsrv.listen_endpoint, jsrv.listen_endpoint):
        if client == "port":
            ch, cntl = Channel(), Controller()
            stream_create(cntl, StreamOptions())
        else:
            from brpc_tpu import streaming as jstreaming
            ch, cntl = JChannel(), JController()
            jstreaming.stream_create(cntl, jstreaming.StreamOptions())
        ch.init(str(ep))
        c = _call(ch, "LM.Decode", req, cntl)
        answers.append((c.failed, c.error_code, c.error_text))
        if client == "port":
            ch.close()
    assert answers[0] == answers[1] == (
        True, int(Errno.EREQUEST), "Decode serves unrolled configs only")


def _raised(fn):
    with pytest.raises(NotImplementedError) as e:
        fn()
    return str(e.value)


REFUSALS = {
    "make_decode_scan_moe": lambda m, c: m.make_decode(
        m.LMConfig(**SCAN, **MOE), **c),
    "make_batch_decode": lambda m, c: m.make_batch_decode(
        m.LMConfig(**SCAN), **c),
    "make_paged_batch_decode": lambda m, c: m.make_paged_batch_decode(
        m.LMConfig(**SCAN), 8, **c),
    "make_paged_spec_verify": lambda m, c: m.make_paged_spec_verify(
        m.LMConfig(**SCAN), 8, 4, **c),
    "kv_page_specs": lambda m, c: m.kv_page_specs(m.LMConfig(**SCAN)),
    "export_decode_cache": lambda m, c: m.export_decode_cache(
        m.LMConfig(**SCAN), {}),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_jax(name):
    call = REFUSALS[name]
    ours = _raised(lambda: call(tlm, {"device": "cpu"}))
    theirs = _raised(lambda: call(jlm, {}))
    assert ours == theirs


def test_what_jax_builds_for_scan_the_port_builds():
    """The JAX package builds these for a stacked config; so does the
    port: the stacked batch pool, the per-layer page pools and the page
    I/O programs."""
    cfg, jcfg = tlm.LMConfig(**SCAN), jlm.LMConfig(**SCAN)
    pool = tlm.empty_batch_cache(cfg, 2, device="cpu")
    jpool = jlm.empty_batch_cache(jcfg, 2)
    assert set(pool) == set(jpool)
    assert tuple(pool["k"].shape) == jpool["k"].shape
    assert tuple(pool["len"].shape) == jpool["len"].shape
    paged = tlm.empty_paged_cache(cfg, 5, 2, 8, device="cpu")
    assert set(paged) == set(jlm.empty_paged_cache(jcfg, 5, 2, 8))
    assert len(tlm.make_paged_io(cfg, 8, chunk=4, device="cpu")) == 4
