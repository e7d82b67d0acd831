"""The port's MoE TransformerLM (``moe_experts > 0``) against the JAX
package's, on the CPU, through every program: ``make_decode`` (prefill
and steps), the batch ``step`` and ``chunk_step`` (padding rows routed
with the slice), the paged step, ``make_paged_io``'s ``chunk_prefill``,
``make_paged_spec_verify``, ``make_forward`` (logits, aux, gradients,
remat on and off), and ``LMService`` Generate and Decode over RPC.

Config: vocab 64, dim 32, heads 4, depth 2, max_seq 64, 4 experts, top-2,
capacity 1.0 (slots drop) and 2.0.  Params come from the JAX
``init_params(PRNGKey(0))`` through numpy; pools and inputs from numpy
seeds.

Each MoE block routes each row of its program's activations on its own,
so a routing flip between the frameworks would move whole expert
outputs.  Every input is therefore first run through the port with
:class:`RouterMargins` recording each routed token's smallest gap between
its sorted router probabilities down to the (K+1)-th; an input is used
only where that gap clears ``ROUTE_MARGIN`` everywhere, and the tests
assert it, so a near-tie fails loudly instead of flaking.

Tolerances: the JAX side runs under ``jax.jit``, where XLA keeps some
bf16 expert intermediates in f32 on the CPU (test_torch_moe.py); logits
are held to 2e-2 of their largest |value| (chip_smoke.py's flash-vs-dense
rule), KV rows to 2e-2 absolute, aux to 1e-4 relative, the train step's
loss to 1e-4 relative and each gradient in norm to ``‖Δg‖ / ‖g‖ <= 1e-2``
(1.4e-3 measured).  Tokens must be equal: prompts are kept only where
every greedy pick's top-1 margin also clears 0.08.
"""

import functools
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu import streaming as jstreaming
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import Controller as JController
from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.server import Server as JServer
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.models import moe as tmoe
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.streaming import StreamOptions, stream_create
from brpc_tpu_torch.utils.convert import params_from_numpy

ROUTE_MARGIN = 2e-3
TOKEN_MARGIN = 0.08
LOGIT_SCALE_TOL = 2e-2
CACHE_ATOL = 2e-2
AUX_RTOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_REL_NORM = 1e-2
KW = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=64, remat=False,
          moe_experts=4, moe_top_k=2)
HD = KW["dim"] // KW["heads"]
CAPS = [1.0, 2.0]
SLOTS = 4
PAGE = 8
PPS = KW["max_seq"] // PAGE
NUM_PAGES = 40
TIMEOUT = 120.0


class RouterMargins:
    """While active, records the smallest top-k router margin of every
    ``moe.route`` call of the port, and the slots it dropped."""

    def __init__(self):
        self.worst, self.dropped = math.inf, 0

    def __enter__(self):
        self._route = tmoe.route

        def route(params, x, cfg):
            out = self._route(params, x, cfg)
            top = torch.sort(out[0].detach(), dim=-1, descending=True).values
            top = top[..., :min(cfg.top_k + 1, cfg.num_experts)]
            self.worst = min(self.worst,
                             float((top[..., :-1] - top[..., 1:]).min()))
            self.dropped += int((~out[4]).sum())
            return out

        tmoe.route = route
        return self

    def __exit__(self, *exc):
        tmoe.route = self._route


def _cfg(mod, cap, **kw):
    return mod.LMConfig(**{**KW, "moe_capacity": cap, **kw})


@pytest.fixture(scope="module")
def params():
    jp = jlm.init_params(jax.random.PRNGKey(0), _cfg(jlm, 2.0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jp, tp


def _clear(run, seeds):
    """The first seed whose port run ``run(seed)`` clears ROUTE_MARGIN."""
    for seed in seeds:
        with RouterMargins() as m:
            run(seed)
        if m.worst >= ROUTE_MARGIN:
            return seed, m
    pytest.fail("no input clears the router margin")


def _assert_logits_close(got, want):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= LOGIT_SCALE_TOL * np.abs(want).max(), err


def _to_jax(pool):
    return {k: jnp.asarray(v) for k, v in pool.items()}


def _to_torch(pool):
    return {k: torch.from_numpy(v.copy()) for k, v in pool.items()}


def _assert_pools_close(tcache, jcache, keys):
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))
    for key in keys:
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=CACHE_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("cap", CAPS)
def test_decode_prefill_and_steps_match_jax(params, cap):
    jp, tp = params
    tcfg, jcfg = _cfg(tlm, cap), _cfg(jlm, cap)
    tpre, tstep = tlm.make_decode(tcfg, device="cpu")

    def run(seed):
        ids = np.random.default_rng(seed).integers(0, 64, (2, 9),
                                                   dtype=np.int32)
        cache, logits = tpre(tp, torch.from_numpy(ids))
        toks = []
        for _ in range(4):
            toks.append(torch.argmax(logits, -1).to(torch.int32))
            cache, logits = tstep(tp, cache, toks[-1])
        return ids, toks

    seed, m = _clear(run, range(100, 200))
    ids, toks = run(seed)
    jpre, jstep = jax.jit(jlm.make_decode(jcfg)[0]), \
        jax.jit(jlm.make_decode(jcfg)[1])
    jcache, jlog = jpre(jp, jnp.asarray(ids))
    tcache, tlog = tpre(tp, torch.from_numpy(ids))
    _assert_logits_close(tlog, jlog)
    for i in range(KW["depth"]):
        np.testing.assert_allclose(tcache[f"k{i}"].numpy(),
                                   np.asarray(jcache[f"k{i}"]),
                                   atol=CACHE_ATOL)
    for tok in toks:
        jcache, jlog = jstep(jp, jcache, jnp.asarray(tok.numpy()))
        tcache, tlog = tstep(tp, tcache, tok)
        _assert_logits_close(tlog, jlog)
    assert tcache["len"] == int(jcache["len"]) == 13
    assert m.worst >= ROUTE_MARGIN


def _pool(lens, seed):
    rng = np.random.default_rng(seed)
    pool = {"len": np.asarray(lens, np.int32)}
    for i in range(KW["depth"]):
        for kind in "kv":
            pool[f"{kind}{i}"] = (rng.standard_normal(
                (len(lens), KW["max_seq"], KW["heads"], HD)) * 0.5
                                  ).astype(np.float32)
    return pool


LENS = [5, 0, 17, 50]
ACTIVE = np.asarray([True, False, True, True])


@pytest.mark.parametrize("cap", CAPS)
def test_batch_step_matches_jax(params, cap):
    jp, tp = params
    _, tstep = tlm.make_batch_decode(_cfg(tlm, cap), device="cpu")
    tokens = np.asarray([3, 9, 42, 7], np.int32)

    def run(seed):
        return tstep(tp, _to_torch(_pool(LENS, seed)),
                     torch.from_numpy(tokens), torch.from_numpy(ACTIVE))

    seed, m = _clear(run, range(20))
    pool = _pool(LENS, seed)
    _, jstep = jlm.make_batch_decode(_cfg(jlm, cap))
    jcache, jlog = jax.jit(jstep)(jp, _to_jax(pool), jnp.asarray(tokens),
                                  jnp.asarray(ACTIVE))
    tcache, tlog = run(seed)
    _assert_logits_close(tlog.numpy()[ACTIVE], np.asarray(jlog)[ACTIVE])
    _assert_pools_close(tcache, jcache, [f"k{i}" for i in range(2)])
    assert tcache["len"].tolist() == [6, 0, 18, 51]
    assert m.worst >= ROUTE_MARGIN


@pytest.mark.parametrize("cap", CAPS)
def test_chunk_step_routes_padding_rows_as_jax(params, cap):
    """A 16-wide slice with 11 valid rows: the 5 padding rows are routed
    with the slice and take capacity, in both frameworks."""
    jp, tp = params
    cw, slot, start, n = 16, 2, 16, 11
    _, _, tchunk = tlm.make_batch_decode(_cfg(tlm, cap), chunk=cw,
                                         device="cpu")
    lens = [5, 0, 16, 40]

    def ids_for(seed):
        return np.random.default_rng(seed).integers(0, 64, cw,
                                                    dtype=np.int32)

    def run(seed):
        return tchunk(tp, _to_torch(_pool(lens, seed)), slot, start, n,
                      torch.from_numpy(ids_for(seed)))

    seed, m = _clear(run, range(40))
    if cap == 1.0:
        assert m.dropped > 0, "capacity 1.0 drops slots of this slice"
    _, _, jchunk = jlm.make_batch_decode(_cfg(jlm, cap), chunk=cw)
    jcache = jax.jit(jchunk)(jp, _to_jax(_pool(lens, seed)), slot, start, n,
                             jnp.asarray(ids_for(seed)))
    tcache = run(seed)
    _assert_pools_close(tcache, jcache, [f"{k}{i}" for i in range(2)
                                         for k in "kv"])
    assert tcache["len"].tolist() == [5, 0, 27, 40]
    assert m.worst >= ROUTE_MARGIN


def _paged_pool(lens, seed):
    rng = np.random.default_rng(seed)
    pool = {"len": np.asarray(lens, np.int32)}
    for i in range(KW["depth"]):
        for kind in ("pk", "pv"):
            pool[f"{kind}{i}"] = (rng.standard_normal(
                (NUM_PAGES, PAGE, KW["heads"], HD)) * 0.5).astype(np.float32)
    return pool


def _bt(rows):
    bt = np.zeros((len(rows), PPS), np.int32)
    for s, pages in enumerate(rows):
        bt[s, :len(pages)] = pages
    return bt


# slot 0 at len 5 (page 3), slot 1 inactive, slot 2 at 17 (three pages),
# slot 3 at 50 (seven pages)
PLENS = [5, 0, 17, 50]
PROWS = [[3], [], [10, 11, 12], list(range(20, 27))]
PAGED_KEYS = [f"{k}{i}" for i in range(2) for k in ("pk", "pv")]


@pytest.mark.parametrize("cap", CAPS)
def test_paged_step_matches_jax(params, cap):
    jp, tp = params
    _, tstep = tlm.make_paged_batch_decode(_cfg(tlm, cap), PAGE,
                                           device="cpu")
    tokens, bt = np.asarray([3, 9, 42, 7], np.int32), _bt(PROWS)

    def run(seed):
        return tstep(tp, _to_torch(_paged_pool(PLENS, seed)),
                     torch.from_numpy(bt), torch.from_numpy(tokens),
                     torch.from_numpy(ACTIVE))

    seed, m = _clear(run, range(20))
    _, jstep = jlm.make_paged_batch_decode(_cfg(jlm, cap), PAGE)
    jcache, jlog = jax.jit(jstep)(jp, _to_jax(_paged_pool(PLENS, seed)),
                                  jnp.asarray(bt), jnp.asarray(tokens),
                                  jnp.asarray(ACTIVE))
    tcache, tlog = run(seed)
    _assert_logits_close(tlog.numpy()[ACTIVE], np.asarray(jlog)[ACTIVE])
    # page 0 takes the inactive slot's garbage row
    for key in PAGED_KEYS:
        np.testing.assert_allclose(tcache[key].numpy()[1:],
                                   np.asarray(jcache[key])[1:],
                                   atol=CACHE_ATOL, err_msg=key)
    assert tcache["len"].tolist() == [6, 0, 18, 51]
    assert m.worst >= ROUTE_MARGIN


@pytest.mark.parametrize("cap", CAPS)
def test_paged_chunk_prefill_matches_jax(params, cap):
    jp, tp = params
    cw, slot, start, n = 16, 2, 16, 11
    *_, tchunk = tlm.make_paged_io(_cfg(tlm, cap), PAGE, chunk=cw,
                                   device="cpu")
    bt_row = _bt([list(range(10, 14))])[0]
    lens = [5, 0, 16, 50]

    def ids_for(seed):
        return np.random.default_rng(seed).integers(0, 64, cw,
                                                    dtype=np.int32)

    def run(seed):
        return tchunk(tp, _to_torch(_paged_pool(lens, seed)),
                      torch.from_numpy(bt_row), slot, start, n,
                      torch.from_numpy(ids_for(seed)))

    seed, m = _clear(run, range(40))
    *_, jchunk = jlm.make_paged_io(_cfg(jlm, cap), PAGE, chunk=cw)
    jcache = jax.jit(jchunk)(jp, _to_jax(_paged_pool(lens, seed)),
                             jnp.asarray(bt_row), slot, start, n,
                             jnp.asarray(ids_for(seed)))
    tcache = run(seed)
    for key in PAGED_KEYS:     # page 0 takes the padding rows' garbage
        np.testing.assert_allclose(tcache[key].numpy()[1:],
                                   np.asarray(jcache[key])[1:],
                                   atol=CACHE_ATOL, err_msg=key)
    assert tcache["len"].tolist() == [5, 0, 27, 50]
    assert m.worst >= ROUTE_MARGIN


@pytest.mark.parametrize("cap", CAPS)
def test_spec_verify_matches_jax(params, cap):
    """Width 4: each slot's 4 candidates route as one row, with capacity
    ceil(4 * 2 / 4 * cap)."""
    jp, tp = params
    w = 4
    tver = tlm.make_paged_spec_verify(_cfg(tlm, cap), PAGE, w, device="cpu")
    bt = _bt(PROWS)

    def cands(seed):
        return np.random.default_rng(seed).integers(0, 64, (SLOTS, w),
                                                    dtype=np.int32)

    def run(seed):
        return tver(tp, _to_torch(_paged_pool(PLENS, seed)),
                    torch.from_numpy(bt), torch.from_numpy(cands(seed)),
                    torch.from_numpy(ACTIVE))

    seed, m = _clear(run, range(60))
    jver = jlm.make_paged_spec_verify(_cfg(jlm, cap), PAGE, w)
    jcache, jout, jm = jax.jit(jver)(
        jp, _to_jax(_paged_pool(PLENS, seed)), jnp.asarray(bt),
        jnp.asarray(cands(seed)), jnp.asarray(ACTIVE))
    tcache, tout, tm = run(seed)
    np.testing.assert_array_equal(tout.numpy()[ACTIVE],
                                  np.asarray(jout)[ACTIVE])
    np.testing.assert_array_equal(tm.numpy()[ACTIVE], np.asarray(jm)[ACTIVE])
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))
    assert m.worst >= ROUTE_MARGIN


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v.detach() if torch.is_tensor(v)
                                              else v)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_forward_aux_and_train_step_match_jax(params, remat):
    """make_forward's logits and aux (the sum of the blocks' aux losses)
    and one train step's loss (with aux) and gradients, attention through
    the flash path (the JAX kernels in interpret mode)."""
    jp, tp = params
    kw = dict(remat=remat, use_flash=True)
    tcfg, jcfg = _cfg(tlm, 1.0, **kw), _cfg(jlm, 1.0, **kw)
    fwd = tlm.make_forward(tcfg, device="cpu")

    def batch(seed):
        ids = np.random.default_rng(seed).integers(0, 64, (3, 16),
                                                   dtype=np.int32)
        return ids, np.roll(ids, -1, axis=-1)

    seed, m = _clear(lambda s: fwd(tp, torch.from_numpy(batch(s)[0])),
                     range(200))
    assert m.dropped > 0
    ids, labels = batch(seed)
    tl, ta = fwd(tp, torch.from_numpy(ids), with_aux=True)
    jl, ja = jax.jit(functools.partial(jlm.make_forward(jcfg),
                                       with_aux=True))(jp, jnp.asarray(ids))
    _assert_logits_close(tl.detach(), jl)
    assert float(ta) > 0
    np.testing.assert_allclose(float(ta), float(ja), rtol=AUX_RTOL)
    lr = 0.5
    jnew, jloss = jax.jit(jlm.make_train_step(jcfg))(
        jp, jnp.asarray(ids), jnp.asarray(labels), lr)
    tnew, tloss = tlm.make_train_step(tcfg, device="cpu")(
        tp, torch.from_numpy(ids), torch.from_numpy(labels), lr)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    old, jn, tn = dict(_flat(jp)), dict(_flat(jnew)), dict(_flat(tnew))
    assert set(tn) == set(jn) and "blk0/moe/w1" in tn
    for k in old:
        gj, gt = (old[k] - jn[k]) / lr, (old[k] - tn[k]) / lr
        rel = np.linalg.norm(gt - gj) / max(np.linalg.norm(gj), 1e-30)
        assert rel <= GRAD_REL_NORM, (k, rel)
    assert m.worst >= ROUTE_MARGIN


def _greedy_margin(logits):
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


def _generate_path(tp, cfg, ids, max_new):
    """The service's Generate arithmetic: tokens and the smallest top-1
    margin."""
    pre, step = tlm.make_decode(cfg, device="cpu")
    cache, logits = pre(tp, torch.from_numpy(ids))
    worst, toks = math.inf, []
    for _ in range(max_new):
        worst = min(worst, _greedy_margin(logits))
        toks.append(torch.argmax(logits, -1))
        cache, logits = step(tp, cache, toks[-1])
    return torch.stack(toks, 1).numpy(), worst


def _decode_path(tp, cfg, prompt, max_new):
    """The batcher's arithmetic for one session: the bucketed prefill of
    the context, then one batch step per token (the prompt's last token
    first)."""
    prefill, step = tlm.make_batch_decode(cfg, device="cpu")
    cache = tlm.empty_batch_cache(cfg, SLOTS, device="cpu")
    cache1, ctx = tsvc.bucketed_prefill(functools.partial(prefill, tp), cfg,
                                        prompt)
    for i in range(cfg.depth):
        cache[f"k{i}"][0] = cache1[f"k{i}"][0]
        cache[f"v{i}"][0] = cache1[f"v{i}"][0]
    cache["len"][0] = ctx
    tok, active = int(prompt[-1]), torch.tensor([True] + [False] * 3)
    worst, toks = math.inf, []
    for _ in range(max_new):
        cache, logits = step(tp, cache, torch.tensor([tok, 0, 0, 0]),
                             active)
        worst = min(worst, _greedy_margin(logits[0]))
        tok = int(torch.argmax(logits[0]))
        toks.append(tok)
    return toks, worst


def _clear_prompts(tp, cfg, max_new):
    """A Generate batch and a Decode prompt whose routing and greedy picks
    clear their margins on the port."""
    found = {}
    for seed in range(300, 600):
        rng = np.random.default_rng(seed)
        if "gen" not in found:
            ids = rng.integers(0, 64, (2, 7), dtype=np.int32)
            with RouterMargins() as m:
                toks, worst = _generate_path(tp, cfg, ids, max_new)
            if m.worst >= ROUTE_MARGIN and worst > TOKEN_MARGIN:
                found["gen"] = (ids, toks)
        if "dec" not in found:
            prompt = rng.integers(0, 64, 11, dtype=np.int32)
            with RouterMargins() as m:
                toks, worst = _decode_path(tp, cfg, prompt, max_new)
            if m.worst >= ROUTE_MARGIN and worst > TOKEN_MARGIN:
                found["dec"] = (prompt, toks)
        if len(found) == 2:
            return found["gen"], found["dec"]
    pytest.fail("no prompts clear the router and token margins")


def _stream_decode(ep, prompt, max_new, client):
    toks, closed = [], []
    req = tsvc.pack_generate_request(np.asarray(prompt)[None], max_new)
    if client == "port":
        ch, cntl = Channel(), Controller()
        create, opts = stream_create, StreamOptions
    else:
        ch, cntl = JChannel(), JController()
        create, opts = jstreaming.stream_create, jstreaming.StreamOptions
    ch.init(str(ep))
    cntl.timeout_ms = int(TIMEOUT * 1000)
    create(cntl, opts(
        on_received=lambda st, msgs: toks.extend(
            tsvc.unpack_token(bytes(m)) for m in msgs),
        on_closed=lambda st: closed.append(st.close_reason)))
    c = ch.call_method("LM.Decode", req, cntl=cntl)
    assert not c.failed, (c.error_code, c.error_text)
    deadline = time.monotonic() + TIMEOUT
    while not closed and time.monotonic() < deadline:
        time.sleep(0.005)
    if client == "port":
        ch.close()
    assert closed == ["finished"]
    return toks


def test_service_generate_and_decode_match_jax(params):
    """Port LMService on a port Server and the JAX LMService on a JAX
    Server, same MoE weights: Generate and Decode tokens equal, the
    fingerprints equal."""
    jp, tp = params
    tcfg, jcfg = _cfg(tlm, 2.0), _cfg(jlm, 2.0)
    max_new = 5
    (gen_ids, gen_toks), (dec_prompt, dec_toks) = _clear_prompts(
        tp, tcfg, max_new)
    tsrv, jsrv = Server(), JServer()
    tlms = tsvc.LMService(cfg=tcfg, params=tp, device="cpu",
                          decode_slots=SLOTS)
    jlms = jsvc.LMService(cfg=jcfg, params=jp, decode_slots=SLOTS)
    assert tsrv.add_service(tlms, name="LM") == 0
    assert jsrv.add_service(jlms, name="LM") == 0
    assert tsrv.start("127.0.0.1:0") == 0 and jsrv.start("127.0.0.1:0") == 0
    try:
        req = tsvc.pack_generate_request(gen_ids, max_new)
        ch, jch = Channel(), JChannel()
        ch.init(str(tsrv.listen_endpoint))
        jch.init(str(jsrv.listen_endpoint))
        got = ch.call_method("LM.Generate", req, cntl=_timeout(Controller()))
        want = jch.call_method("LM.Generate", req,
                               cntl=_timeout(JController()))
        ch.close()
        assert not got.failed and not want.failed
        np.testing.assert_array_equal(tsvc.unpack_generated(got.response),
                                      gen_toks)
        np.testing.assert_array_equal(jsvc.unpack_generated(want.response),
                                      gen_toks)
        port = _stream_decode(tsrv.listen_endpoint, dec_prompt, max_new,
                              "port")
        theirs = _stream_decode(jsrv.listen_endpoint, dec_prompt, max_new,
                                "jax")
        assert port == theirs == dec_toks
        assert tlms.model_fingerprint() == jlms.model_fingerprint()
    finally:
        tsrv.stop()
        jsrv.stop()
        if tlms._batcher is not None:
            assert tlms._batcher.shutdown()


def _timeout(cntl):
    cntl.timeout_ms = int(TIMEOUT * 1000)
    return cntl


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_fingerprint_and_param_bytes_match_jax(params, quantize):
    """The MoE subtree counts in param_bytes (and stays f32 under int8)."""
    jp, tp = params
    ours = tsvc.LMService(cfg=_cfg(tlm, 2.0), params=tp, device="cpu",
                          quantize=quantize)
    theirs = jsvc.LMService(cfg=_cfg(jlm, 2.0), params=jp,
                            quantize=quantize)
    assert ours.model_fingerprint() == theirs.model_fingerprint()
    assert ours._param_bytes == theirs._param_bytes
    moe_bytes = sum(4 * v.numel() for v in tp["blk0"]["moe"].values())
    assert ours._param_bytes > 2 * moe_bytes
    if quantize:
        assert ours.params["blk0"]["moe"]["w1"] is tp["blk0"]["moe"]["w1"]
