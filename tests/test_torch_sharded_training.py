"""The port's sharded training against the JAX package's, on the CPU.

The port runs one process per rank in a gloo group of 4 (one pool for
the module): ``make_train_step`` / ``make_forward`` with ``mesh=`` (dp x
tp, +ep for MoE) and with ``sp_axis=`` (ring attention), MoE expert
parallelism (``moe.forward(ep=...)``) and the sharded parameter server.
Every rank gets the whole JAX ``init_params(PRNGKey)`` tree as numpy and
cuts its shard with ``utils.convert.shard_from_numpy``; the shards come
back together through ``params_from_shards``.  The JAX reference runs on
a mesh of 4 virtual CPU devices, its params placed by its
``param_specs``, as ``tests/test_transformer_lm.py`` runs it.

Tolerances.  A tensor-parallel step rounds each row-cut product's
partial sums to bf16 before they are summed, in JAX's GSPMD program as
in the port, so neither is the unsharded step to the bit: on these
configs (seeds 0-2) JAX's own dp x tp step differs from its unsharded
step by up to 2.6e-4 in the loss and 1.16e-2 in a gradient's norm
(‖Δg‖ / ‖g‖), and the port's from JAX's sharded step by up to 1.5e-4
and 8.5e-3.  So a tp step is held to JAX's sharded step at 1e-3 in the loss
(chip_smoke.py's bf16-rounding rule) and 2e-2 in each gradient's norm,
and tp logits to 2e-2 of their largest |value| (test_torch_moe_lm.py's
rule).  Sequence parallelism adds no partial sum: an sp step is held to
JAX's (one-device) step at test_torch_moe_lm.py's 1e-4 in the loss and
1e-2 in norm (2.4e-3 measured; the ring's f32 attention rounds some
bf16 products the other way), sp logits at test_transformer_lm.py's
ring tolerance (3e-2 / 8e-3).  MoE expert parallelism sums f32 shares:
its outputs are held at tests/test_moe.py's EP tolerance (2e-2).  MoE
inputs are held to clear a router margin of 2e-3 (a near-tie would flip
a choice between the frameworks), asserted, as in test_torch_moe_lm.py.
"""

import math

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from brpc_tpu.models import embedding_ps as jps
from brpc_tpu.models import moe as jmoe
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu_torch.models import moe as tmoe
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.parallel.spmd import SpmdPool
from brpc_tpu_torch.utils.convert import (params_from_numpy,
                                          params_from_shards,
                                          shard_from_numpy)

import torch_spmd_cases as cases

WORLD = 4
TP_LOSS_RTOL, TP_GRAD_REL_NORM = 1e-3, 2e-2
SP_LOSS_RTOL, SP_GRAD_REL_NORM = 1e-4, 1e-2
LOGIT_SCALE_TOL = 2e-2
LOGIT_RTOL, LOGIT_ATOL = 3e-2, 8e-3
ROUTE_MARGIN = 2e-3
LR = 0.5
DENSE = dict(vocab=64, dim=32, heads=4, depth=2)
MOE = dict(vocab=64, dim=32, heads=4, depth=1, moe_experts=4)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with SpmdPool(WORLD, "cpu", str(tmp_path_factory.mktemp("pg")),
                  timeout_s=60) as p:
        yield p


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(b, s, seed=1, vocab=64):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, s),
                                               dtype=np.int32)
    return ids, np.roll(ids, -1, axis=-1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, dtype=np.float64)
    return out


def _assert_grads_close(got, want, tol):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        rel = (np.linalg.norm(got[k] - want[k])
               / max(np.linalg.norm(want[k]), 1e-30))
        assert rel <= tol, (k, rel)


def _jax_step(kw, params, ids, labels, shape=None, accum=1):
    """The JAX train step, on a ("dp", "tp") mesh of ``shape`` or on one
    device: (loss, gradient as (old - new) / lr)."""
    cfg = jlm.LMConfig(**kw)
    step = jax.jit(jlm.make_train_step(cfg, accum=accum))
    if shape is None:
        new, loss = step(params, ids, labels, LR)
    else:
        mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(shape),
                    ("dp", "tp"))
        placed = jax.tree_util.tree_map(
            lambda p, s: jax.device_put(p, NamedSharding(mesh, s)),
            params, jlm.param_specs(cfg))
        ids_spec, lbl_spec = jlm.batch_specs()
        with mesh:
            new, loss = step(placed,
                             jax.device_put(ids, NamedSharding(mesh,
                                                               ids_spec)),
                             jax.device_put(labels, NamedSharding(mesh,
                                                                  lbl_spec)),
                             LR)
    grads = jax.tree_util.tree_map(
        lambda o, n: (np.asarray(o, np.float64) - np.asarray(n, np.float64))
        / LR, params, new)
    return float(loss), grads


def _router_margin(kw, whole, ids):
    """The smallest top-k router margin of the port's unsharded forward on
    ``ids`` (the sharded ranks route the same rows alike)."""
    cfg = tlm.LMConfig(**kw)
    worst = [math.inf]
    route = tmoe.route

    def logged(params, x, mcfg):
        out = route(params, x, mcfg)
        top = torch.sort(out[0], dim=-1, descending=True).values
        top = top[..., :min(mcfg.top_k + 1, mcfg.num_experts)]
        worst[0] = min(worst[0], float((top[..., :-1] - top[..., 1:]).min()))
        return out

    tmoe.route = logged
    try:
        with torch.no_grad():
            tlm.make_forward(cfg, device="cpu")(
                params_from_numpy(whole, device="cpu"), torch.from_numpy(ids))
    finally:
        tmoe.route = route
    return worst[0]


def _port_step(pool, kw, whole, ids, labels, shape, names, sp_axis=None,
               accum=1):
    """The port's step on the ranks: (loss, gradient as (old - new) / lr,
    as for JAX, from the gathered new params)."""
    got = pool.run(cases.lm_step, kw, whole, ids, labels, shape, names,
                   sp_axis, accum, LR)
    specs = tlm.param_specs(tlm.LMConfig(**kw))
    losses = {loss for _, loss, _ in got}
    assert len(losses) == 1, losses           # the whole batch's, everywhere
    new = params_from_shards([(co, n) for co, _, n in got], specs)
    grads = jax.tree_util.tree_map(
        lambda o, n: (np.asarray(o, np.float64) - np.asarray(n, np.float64))
        / LR, whole, new)
    return losses.pop(), grads


@pytest.mark.parametrize("kind,shape", [("dense", (2, 2)), ("dense", (1, 4)),
                                        ("moe", (2, 2))],
                         ids=["dense-dp2tp2", "dense-tp4", "moe-dp2tp2"])
def test_dp_tp_step_matches_jax(pool, kind, shape):
    """One dp x tp (+ep) step: the loss and the gathered update equal the
    JAX package's sharded step's."""
    kw = DENSE if kind == "dense" else MOE
    whole = _np(jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**kw)))
    ids, labels = _batch(4, 16)
    if kind == "moe":
        assert _router_margin(kw, whole, ids) > ROUTE_MARGIN
    want_loss, want_grads = _jax_step(kw, whole, ids, labels, shape)
    loss, grads = _port_step(pool, kw, whole, ids, labels, shape,
                             ("dp", "tp"))
    np.testing.assert_allclose(loss, want_loss, rtol=TP_LOSS_RTOL)
    _assert_grads_close(grads, want_grads, TP_GRAD_REL_NORM)


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_dp_tp_accum2_matches_jax(pool, kind):
    """Gradient accumulation composes with dp x tp (+ep): accum=2."""
    kw = DENSE if kind == "dense" else MOE
    whole = _np(jlm.init_params(jax.random.PRNGKey(7), jlm.LMConfig(**kw)))
    ids, labels = _batch(8, 16, seed=8)
    if kind == "moe":
        assert _router_margin(kw, whole, ids) > ROUTE_MARGIN
    want_loss, want_grads = _jax_step(kw, whole, ids, labels, (2, 2),
                                      accum=2)
    loss, grads = _port_step(pool, kw, whole, ids, labels, (2, 2),
                             ("dp", "tp"), accum=2)
    np.testing.assert_allclose(loss, want_loss, rtol=TP_LOSS_RTOL)
    _assert_grads_close(grads, want_grads, TP_GRAD_REL_NORM)


def test_scan_layers_sharded_step_matches_jax(pool):
    """Stacked ``blocks`` params shard under the depth-led spec."""
    kw = dict(vocab=64, dim=32, heads=4, depth=3, scan_layers=True)
    whole = _np(jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**kw)))
    ids, labels = _batch(4, 16)
    want_loss, want_grads = _jax_step(kw, whole, ids, labels, (2, 2))
    loss, grads = _port_step(pool, kw, whole, ids, labels, (2, 2),
                             ("dp", "tp"))
    np.testing.assert_allclose(loss, want_loss, rtol=TP_LOSS_RTOL)
    _assert_grads_close(grads, want_grads, TP_GRAD_REL_NORM)


def test_wqkv_cut_by_head_group():
    """A rank's ``wqkv`` is q, k and v each cut by head group, not a
    contiguous third of the columns, and the gather undoes that cut."""
    cfg = tlm.LMConfig(**DENSE)
    whole = _np(jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**DENSE)))
    specs = tlm.param_specs(cfg)
    d, tp = cfg.dim, 2
    w = whole["blk0"]["wqkv"]
    shards = []
    for t in range(tp):
        co = {"dp": (0, 1), "tp": (t, tp)}
        shard = shard_from_numpy(whole, specs, co, "cpu")
        cols = slice(t * d // tp, (t + 1) * d // tp)
        want = np.concatenate([w[:, :d][:, cols], w[:, d:2 * d][:, cols],
                               w[:, 2 * d:][:, cols]], axis=1)
        got = shard["blk0"]["wqkv"].numpy()
        np.testing.assert_array_equal(got, want)
        contiguous = np.split(w, tp, axis=1)[t]
        assert not np.array_equal(got, contiguous)
        shards.append((co, shard))
    back = params_from_shards(shards, specs)
    for k, v in _flat(whole).items():
        np.testing.assert_array_equal(_flat(back)[k], v)


def test_dp_tp_forward_matches_jax(pool):
    """make_forward(mesh=) logits (heads, vocab and MLP cut over tp)
    against the JAX package's sharded forward, to 2e-2 of the largest
    |logit|."""
    whole = _np(jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**DENSE)))
    ids, _ = _batch(4, 16)
    cfg = jlm.LMConfig(**DENSE)
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2), ("dp", "tp"))
    placed = jax.tree_util.tree_map(
        lambda p, s: jax.device_put(p, NamedSharding(mesh, s)),
        whole, jlm.param_specs(cfg))
    with mesh:
        want = np.asarray(jax.jit(jlm.make_forward(cfg))(
            placed, jax.device_put(ids, NamedSharding(
                mesh, jlm.batch_specs()[0]))))
    for co, logits in pool.run(cases.lm_forward, DENSE, whole, ids, (2, 2),
                               ("dp", "tp")):
        i = co["dp"][0]
        err = np.abs(logits - want[2 * i:2 * i + 2]).max()
        assert err <= LOGIT_SCALE_TOL * np.abs(want).max(), err


def test_ring_forward_matches_jax(pool):
    """Sequence-parallel forward: rank r's logits are block r of the JAX
    ring forward's (test_transformer_lm.py's case and tolerance)."""
    cfg = jlm.LMConfig(vocab=64, dim=32, heads=4, depth=2, causal=True)
    whole = _np(jlm.init_params(jax.random.PRNGKey(0), cfg))
    ids, _ = _batch(2, 8 * WORLD)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sp",))
    ring = jlm.make_forward(cfg, mesh=mesh, sp_axis="sp")(
        whole, jax.device_put(ids, NamedSharding(mesh, P(None, "sp"))))
    dense = jax.jit(jlm.make_forward(cfg))(whole, ids)
    kw = dict(vocab=64, dim=32, heads=4, depth=2, causal=True)
    for co, logits in pool.run(cases.lm_forward, kw, whole, ids, (WORLD,),
                               ("sp",), "sp"):
        blk = slice(co["sp"][0] * 8, co["sp"][0] * 8 + 8)
        np.testing.assert_allclose(logits, np.asarray(ring)[:, blk],
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        np.testing.assert_allclose(logits, np.asarray(dense)[:, blk],
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_sp_rope_takes_global_positions(pool):
    """Under sp each rank's rope tables start at rank * s/n: the tables
    are slices of the whole sequence's, and the sharded logits equal the
    port's own unsharded forward block by block (local positions would
    rotate every block but the first as if it began at 0)."""
    sin, cos = tlm._rope_tables(32, 8)
    for r in range(WORLD):
        s_r, c_r = tlm._rope_tables(8, 8, offset=8 * r)
        np.testing.assert_array_equal(s_r.numpy(),
                                      sin[:, 8 * r:8 * r + 8].numpy())
        np.testing.assert_array_equal(c_r.numpy(),
                                      cos[:, 8 * r:8 * r + 8].numpy())
    kw = dict(DENSE, remat=False)
    whole = _np(jlm.init_params(jax.random.PRNGKey(3), jlm.LMConfig(**kw)))
    ids, _ = _batch(2, 8 * WORLD, seed=4)
    with torch.no_grad():
        want = tlm.make_forward(tlm.LMConfig(**kw), device="cpu")(
            params_from_numpy(whole, device="cpu"),
            torch.from_numpy(ids)).numpy()
    for co, logits in pool.run(cases.lm_forward, kw, whole, ids, (WORLD,),
                               ("sp",), "sp"):
        blk = slice(co["sp"][0] * 8, co["sp"][0] * 8 + 8)
        np.testing.assert_allclose(logits, want[:, blk], rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)


@pytest.mark.parametrize("kind,shape,names", [
    ("dense", (WORLD,), ("sp",)), ("dense", (2, 2), ("dp", "sp")),
    ("moe", (2, 2), ("dp", "sp"))], ids=["dense-sp4", "dense-dp2sp2",
                                         "moe-dp2sp2"])
def test_sp_train_step_matches_jax(pool, kind, shape, names):
    """A sequence-parallel step (ring attention; MoE rows gathered over
    sp) against the JAX step on one device: the same function, so the
    same loss and gradients."""
    kw = DENSE if kind == "dense" else MOE
    whole = _np(jlm.init_params(jax.random.PRNGKey(1), jlm.LMConfig(**kw)))
    ids, labels = _batch(4, 16, seed=2)
    if kind == "moe":
        assert _router_margin(kw, whole, ids) > ROUTE_MARGIN
    want_loss, want_grads = _jax_step(kw, whole, ids, labels)
    loss, grads = _port_step(pool, kw, whole, ids, labels, shape, names,
                             sp_axis="sp")
    np.testing.assert_allclose(loss, want_loss, rtol=SP_LOSS_RTOL)
    _assert_grads_close(grads, want_grads, SP_GRAD_REL_NORM)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ep_forward_matches_jax(pool, top_k):
    """test_moe.py's EP cases: E = 4 experts over an ("ep",) mesh of 4,
    tokens replicated, against the JAX package's ep-sharded forward."""
    cfg_kw = dict(dim=16, hidden=32, num_experts=WORLD, capacity_factor=2.0,
                  top_k=top_k)
    cfg = jmoe.MoEConfig(**cfg_kw)
    whole = _np(jmoe.init_params(jax.random.PRNGKey(0), cfg))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (8 * WORLD, cfg.dim)), np.float32)
    probs = np.sort(np.asarray(jax.nn.softmax(x @ whole["wg"], axis=-1)),
                    axis=-1)[:, ::-1][:, :top_k + 1]
    assert float((probs[:, :-1] - probs[:, 1:]).min()) > ROUTE_MARGIN
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("ep",))
    sharded = jax.tree_util.tree_map(
        lambda p, s: jax.device_put(p, NamedSharding(mesh, s)),
        whole, jmoe.param_specs(cfg))
    with mesh:
        want, want_aux = jax.jit(lambda p, a: jmoe.forward(p, a, cfg))(
            sharded, x)
    for out, aux, w1_shape in pool.run(cases.moe_ep_forward, cfg_kw, whole,
                                       x):
        assert w1_shape == (1, cfg.dim, cfg.hidden)   # one expert a rank
        np.testing.assert_allclose(out, np.asarray(want), rtol=2e-2,
                                   atol=2e-2)
        np.testing.assert_allclose(aux, float(want_aux), rtol=1e-4)


def test_moe_param_specs_match_jax():
    cfg = tmoe.MoEConfig(dim=8, hidden=16, num_experts=4)
    jspecs = jmoe.param_specs(jmoe.MoEConfig(dim=8, hidden=16,
                                             num_experts=4), ep_axis="tp")
    assert {k: tuple(v) for k, v in jspecs.items()} == \
        tmoe.param_specs(cfg, ep_axis="tp")


def test_sharded_ps_step_matches_jax(pool):
    """The dp x tp parameter server (vocab rows and the tower cut over tp,
    the batch over dp): one step's loss and new params against the JAX
    package's sharded step; ``EmbeddingPS(mesh=)`` takes the same step,
    and ``PS.Stat`` reads ``sharded``."""
    cfg_kw = dict(vocab=128, dim=16, slots=4, hidden=32, classes=4, lr=0.1)
    cfg = jps.PSConfig(**cfg_kw)
    whole = _np(jps.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(5)
    ids = rng.integers(0, cfg.vocab, (8, cfg.slots), dtype=np.int32)
    labels = rng.integers(0, cfg.classes, (8,), dtype=np.int32)
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2), ("dp", "tp"))
    shard = {k: NamedSharding(mesh, s)
             for k, s in jps.param_specs(cfg).items()}
    ids_spec, lbl_spec = jps.batch_specs()
    with mesh:
        want_new, want_loss = jax.jit(jps.sgd_train_step,
                                      static_argnames=("lr",))(
            {k: jax.device_put(v, shard[k]) for k, v in whole.items()},
            jax.device_put(ids, NamedSharding(mesh, ids_spec)),
            jax.device_put(labels, NamedSharding(mesh, lbl_spec)),
            lr=cfg.lr)
    want_grads = {k: (whole[k] - np.asarray(want_new[k])) / cfg.lr
                  for k in whole}
    got = pool.run(cases.ps_step, cfg_kw, whole, ids, labels, (2, 2),
                   cfg.lr)
    tspecs = {k: tuple(v) for k, v in jps.param_specs(cfg).items()}
    new = params_from_shards([(co, n) for co, _, n, _, _, _ in got], tspecs)
    model_new = params_from_shards([(co, m) for co, _, _, _, m, _ in got],
                                   tspecs)
    for co, loss, _, m_loss, _, sharded in got:
        np.testing.assert_allclose(loss, float(want_loss),
                                   rtol=TP_LOSS_RTOL)
        np.testing.assert_allclose(m_loss, float(want_loss),
                                   rtol=TP_LOSS_RTOL)
        assert sharded is True
    for tree in (new, model_new):
        _assert_grads_close({k: (whole[k] - tree[k]) / cfg.lr
                             for k in whole}, want_grads, TP_GRAD_REL_NORM)


def test_sharded_ps_lookup_matches_jax(pool):
    """The vocab-cut table pools what the JAX package's ``embedding_bag``
    pools, negative ids (from the end) and out-of-range ones (a NaN bag)
    included."""
    from brpc_tpu.ops.device_ops import embedding_bag
    cfg_kw = dict(vocab=128, dim=16, slots=4, hidden=32, classes=4)
    whole = _np(jps.init_params(jax.random.PRNGKey(2),
                                jps.PSConfig(**cfg_kw)))
    ids = np.random.default_rng(6).integers(0, 128, (6, 4), dtype=np.int32)
    ids[1, 2], ids[3, 0], ids[4, 1] = -1, -128, 128
    want = np.asarray(embedding_bag(whole["emb"], ids))
    assert np.isnan(want[4]).all() and np.isfinite(want[[0, 1, 2, 3, 5]]).all()
    for got in pool.run(cases.ps_lookup, cfg_kw, whole, ids, (2, 2)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
