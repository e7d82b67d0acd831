"""The port's EmbeddingPS against the JAX package's, on the CPU.

The JAX ``init_params(PRNGKey(0), cfg)`` parameters are carried over
through numpy (``utils.convert.params_from_numpy``), then the same ids
and labels go through both at a small config.

Tolerances: both frameworks feed the tower's two products bf16 operands
and round the products to bf16, but may sum in another order, so one
bf16 rounding (2**-8 relative) can land the other way and the next
product carries it on.  Logits and the loss are held to 1e-2 of the
largest |logit| and 1e-3 relative; the SGD step's update
``(new - old) / lr`` (the gradient) to a relative norm error of 2e-2 per
parameter.
"""

import jax
import numpy as np
import pytest
import torch

from brpc_tpu.models import embedding_ps as jps
from brpc_tpu.ops.device_ops import embedding_bag as jax_embedding_bag
from brpc_tpu_torch.models import embedding_ps as tps
from brpc_tpu_torch.utils.convert import params_from_numpy

CFG = dict(vocab=64, dim=16, slots=4, hidden=32, classes=4)
LOGIT_TOL = 1e-2
LOSS_RTOL = 1e-3
GRAD_REL_NORM = 2e-2


@pytest.fixture(scope="module")
def params():
    jp = jps.init_params(jax.random.PRNGKey(0), jps.PSConfig(**CFG))
    npp = {k: np.asarray(v) for k, v in jp.items()}
    return jp, params_from_numpy(npp, device="cpu")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG["vocab"], (16, CFG["slots"])).astype(np.int32)
    labels = rng.integers(0, CFG["classes"], 16).astype(np.int32)
    return ids, labels


def test_params_carry_over(params):
    jp, tp = params
    assert set(tp) == {"emb", "w1", "b1", "w2", "b2"}
    for k in jp:
        assert tp[k].dtype == torch.float32 and tp[k].device.type == "cpu"
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_forward_matches_jax(params, batch):
    jp, tp = params
    ids, _ = batch
    want = np.asarray(jps.forward(jp, ids))
    got = tps.forward(tp, torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (16, CFG["classes"])
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


def test_loss_matches_jax(params, batch):
    jp, tp = params
    ids, labels = batch
    want = float(jps.loss_fn(jp, ids, labels))
    got = float(tps.loss_fn(tp, torch.from_numpy(ids),
                            torch.from_numpy(labels)))
    assert abs(got - want) <= LOSS_RTOL * abs(want)


def test_sgd_train_step_matches_jax(params, batch):
    jp, tp = params
    ids, labels = batch
    lr = 0.1
    jnew, jloss = jps.sgd_train_step(jp, ids, labels, lr)
    before = {k: v.clone() for k, v in tp.items()}
    tnew, tloss = tps.sgd_train_step(tp, torch.from_numpy(ids),
                                     torch.from_numpy(labels), lr)
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    for k in jp:
        assert torch.equal(tp[k], before[k])          # the step is pure
        want = (np.asarray(jnew[k]) - np.asarray(jp[k])) / lr
        got = ((tnew[k] - tp[k]) / lr).numpy()
        norm = np.linalg.norm(want)
        assert np.linalg.norm(got - want) <= GRAD_REL_NORM * norm, k


def test_train_step_updates_in_place(params, batch):
    _, tp = params
    ids, labels = batch
    model = tps.EmbeddingPS(tps.PSConfig(**CFG, lr=0.1), device="cpu",
                            params={k: v.clone() for k, v in tp.items()})
    emb = model.params["emb"]
    want, _ = tps.sgd_train_step(model.params, torch.from_numpy(ids),
                                 torch.from_numpy(labels), 0.1)
    model.train_step(ids, labels)
    assert model.params["emb"] is emb                 # same storage
    for k in want:
        torch.testing.assert_close(model.params[k], want[k], rtol=0,
                                   atol=1e-7)


def test_lookup_and_predict(params, batch):
    jp, tp = params
    ids, _ = batch
    model = tps.EmbeddingPS(tps.PSConfig(**CFG), device="cpu", params=tp)
    want = np.asarray(jax_embedding_bag(jp["emb"], ids))
    np.testing.assert_allclose(model.lookup(ids).numpy(), want, rtol=1e-6,
                               atol=1e-7)
    logits = model.predict(ids)
    assert logits.shape == (16, CFG["classes"])
    torch.testing.assert_close(logits, tps.forward(tp, torch.from_numpy(ids)))


def test_embedding_ps_learns():
    cfg = tps.PSConfig(**CFG, lr=0.5)
    model = tps.EmbeddingPS(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab, (64, cfg.slots)).astype(np.int32)
    labels = (ids[:, 0] % cfg.classes).astype(np.int32)
    first = model.train_step(ids, labels)
    for _ in range(150):
        last = model.train_step(ids, labels)
    assert last < first * 0.3, (first, last)


def test_mesh_and_sharding_raise(tmp_path, params, batch):
    """The specs are the JAX package's; a mesh runs (multi-rank parity is
    in test_torch_sharded_training.py): at world size one the sharded
    model takes the unsharded step to the bit.  What raises: a mesh of
    another device than the model's, a batch dp does not divide."""
    from brpc_tpu_torch.parallel import make_mesh
    from brpc_tpu_torch.parallel.spmd import init_world
    cfg = tps.PSConfig(**CFG)
    assert tps.param_specs(cfg) == {
        k: tuple(v) for k, v in jps.param_specs(jps.PSConfig(**CFG)).items()}
    assert tps.batch_specs() == tuple(tuple(s) for s in jps.batch_specs())
    tp = {k: v.clone() for k, v in params[1].items()}
    ids, labels = batch
    plain = tps.EmbeddingPS(cfg, device="cpu",
                            params={k: v.clone() for k, v in tp.items()})
    assert plain.shard_batch(ids, labels)[0].shape == ids.shape
    init_world(0, 1, "cpu", str(tmp_path / "rendezvous"))
    try:
        mesh = make_mesh((1, 1), ("dp", "tp"), "cpu")
        model = tps.EmbeddingPS(cfg, device="cpu", params=tp, mesh=mesh)
        assert model.mesh is mesh
        assert model.train_step(*model.shard_batch(ids, labels)) == \
            plain.train_step(ids, labels)
        for k in tp:
            assert torch.equal(model.params[k], plain.params[k]), k
        with pytest.raises(ValueError, match="does not split"):
            model._dp.size = 3
            model.shard_batch(ids[:4], labels[:4])
        cuda_mesh = type("M", (), {"device_type": "cuda",
                                   "mesh_dim_names": ()})()
        with pytest.raises(ValueError, match="cuda mesh for a cpu model"):
            tps.EmbeddingPS(cfg, device="cpu", mesh=cuda_mesh)
    finally:
        torch.distributed.destroy_process_group()
