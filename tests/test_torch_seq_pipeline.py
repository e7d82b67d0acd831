"""The port's sequence and pipeline parallelism
(``brpc_tpu_torch/parallel/ring_attention.py``, ``pipeline.py``) against
the JAX package's, on the CPU: ``tests/test_seq_pipeline_parallel.py``'s
cases, the port in a gloo group of 4 ranks (one pool for the module), the
JAX reference on a mesh of 4 virtual CPU devices, the same numpy inputs.
Rank r's output is held to block r of JAX's along the sequence (or the
whole, where JAX replicates), at the JAX tests' tolerances: attention
2e-4 / 2e-5, the pipeline 1e-5 / 1e-6, pipeline gradients 1e-4 / 1e-6.
Ring attention's gradients under autograd are held against ``jax.grad``
of the JAX ring at the same 2e-4 / 2e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from brpc_tpu.parallel.pipeline import make_pipeline, make_pipeline_train
from brpc_tpu.parallel.ring_attention import (make_ring_attention,
                                              make_ulysses_attention,
                                              reference_attention)
from brpc_tpu_torch.parallel.spmd import SpmdPool

import torch_spmd_cases as cases

WORLD = 4
ATT = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with SpmdPool(WORLD, "cpu", str(tmp_path_factory.mktemp("pg")),
                  timeout_s=60) as p:
        yield p


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("sp",))


def _qkv(b=2, s=64, h=8, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=(b, s, h, d)) * 0.5).astype(np.float32)
                 for _ in range(3))


def _shard(mesh, *arrays):
    sh = NamedSharding(mesh, P(None, "sp", None, None))
    return tuple(jax.device_put(a, sh) for a in arrays)


def _seq_blocks(a):
    return np.split(np.asarray(a), WORLD, axis=1)


def _check_blocks(got, want, **tol):
    for r, out in enumerate(got):
        np.testing.assert_allclose(out, _seq_blocks(want)[r], **tol)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(pool, mesh, causal):
    q, k, v = _qkv()
    want = make_ring_attention(mesh, "sp", causal=causal)(*_shard(mesh, q, k,
                                                                  v))
    np.testing.assert_allclose(np.asarray(want), np.asarray(
        reference_attention(q, k, v, causal=causal)), **ATT)
    _check_blocks(pool.run(cases.seq_attention, "ring", q, k, v, causal),
                  want, **ATT)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_jax(pool, mesh, causal):
    q, k, v = _qkv(h=8)
    want = make_ulysses_attention(mesh, "sp", causal=causal)(
        *_shard(mesh, q, k, v))
    _check_blocks(pool.run(cases.seq_attention, "ulysses", q, k, v, causal),
                  want, **ATT)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_flash_matches_jax(pool, mesh, causal):
    """Ulysses with the flash path as the local attention: the JAX Pallas
    kernel (interpret mode) against the port's plain flash version."""
    q, k, v = _qkv(h=8)
    want = make_ulysses_attention(mesh, "sp", causal=causal,
                                  use_flash=True)(*_shard(mesh, q, k, v))
    _check_blocks(pool.run(cases.seq_attention, "ulysses", q, k, v, causal,
                           True), want, **ATT)
    _check_blocks(pool.run(cases.seq_attention, "ulysses", q, k, v, causal,
                           True),
                  reference_attention(q, k, v, causal=causal), **ATT)


def test_ulysses_heads_must_divide(pool):
    q, _, _ = _qkv(h=6)
    msgs = pool.run(cases.ulysses_heads_refused, q)
    assert all(m and "divisible" in m for m in msgs), msgs


def test_ring_attention_long_sequence(pool, mesh):
    q, k, v = _qkv(b=1, s=512, h=4, d=8, seed=3)
    want = make_ring_attention(mesh, "sp", causal=True)(*_shard(mesh, q, k,
                                                                v))
    _check_blocks(pool.run(cases.seq_attention, "ring", q, k, v, True),
                  want, **ATT)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_seq_attention_grads_match_jax(pool, mesh, kind):
    """Autograd through the ring shifts (or the all_to_alls) against
    ``jax.grad`` of the JAX program."""
    q, k, v = _qkv(b=1, s=32, h=4, d=8, seed=5)
    cot = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    make = make_ring_attention if kind == "ring" else make_ulysses_attention
    fn = make(mesh, "sp", causal=True)
    want = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * cot),
                    argnums=(0, 1, 2))(*_shard(mesh, q, k, v))
    got = pool.run(cases.seq_attention, kind, q, k, v, True, False, cot)
    for r, (_, grads) in enumerate(got):
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g, _seq_blocks(w)[r], **ATT)


def _stage_params(seed, n_stages, width=16):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(n_stages, width, width)) * 0.3
                  ).astype(np.float32),
            "b": (rng.normal(size=(n_stages, width)) * 0.1
                  ).astype(np.float32)}


def _stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _loss_fn(outputs, ys):
    return jnp.mean((outputs - ys) ** 2)


def test_pipeline_matches_jax(pool):
    pp_mesh = Mesh(np.array(jax.devices()[:WORLD]), ("pp",))
    params = _stage_params(0, WORLD)
    xs = np.random.default_rng(7).normal(size=(6, 4, 16)).astype(np.float32)
    want = make_pipeline(pp_mesh, _stage_fn, "pp")(
        {k: jax.device_put(v, NamedSharding(pp_mesh, P("pp")))
         for k, v in params.items()}, xs)
    seq = xs
    for i in range(WORLD):
        seq = np.tanh(seq @ params["w"][i] + params["b"][i])
    np.testing.assert_allclose(np.asarray(want), seq, rtol=1e-5, atol=1e-6)
    for out in pool.run(cases.pipeline_forward, params, xs):
        np.testing.assert_allclose(out, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def _pipeline_train_check(pool, names, shape, n_stages, n_micro, mb, seed):
    devs = np.array(jax.devices()[:WORLD]).reshape(shape)
    jmesh = Mesh(devs, names)
    dp_axis = "dp" if "dp" in names else None
    params = _stage_params(seed, n_stages)
    rng = np.random.default_rng(seed + 10)
    xs = rng.normal(size=(n_micro, mb, 16)).astype(np.float32)
    ys = rng.normal(size=(n_micro, mb, 16)).astype(np.float32)
    step = make_pipeline_train(jmesh, _stage_fn, _loss_fn, "pp",
                               dp_axis=dp_axis)
    data = NamedSharding(jmesh, P(None, dp_axis) if dp_axis else P())
    want_loss, want_grads = step(
        {k: jax.device_put(v, NamedSharding(jmesh, P("pp")))
         for k, v in params.items()},
        jax.device_put(xs, data), jax.device_put(ys, data))
    got = pool.run(cases.pipeline_train, params, xs, ys, shape, names)
    for co, loss, grads in got:
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5,
                                   atol=1e-6)
        i = co["pp"][0]
        for k in params:
            np.testing.assert_allclose(
                grads[k], np.asarray(want_grads[k])[i:i + 1], rtol=1e-4,
                atol=1e-6, err_msg=f"grad mismatch for {k}")


def test_pipeline_train_grads_match_jax(pool):
    """GPipe training: loss and stage gradients from autograd through the
    conveyor against JAX's differentiated scan."""
    _pipeline_train_check(pool, ("pp",), (WORLD,), WORLD, 6, 4, 1)


def test_pipeline_train_composes_with_data_parallel(pool):
    """dp x pp: each dp group runs the conveyor on its share, gradients
    averaged over dp."""
    _pipeline_train_check(pool, ("dp", "pp"), (2, WORLD // 2), WORLD // 2,
                          4, 8, 2)
