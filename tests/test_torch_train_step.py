"""The port's TransformerLM training path against the JAX package's, on
the CPU: the JAX ``init_params(PRNGKey(0))`` tree goes through numpy into
``params_from_numpy``; ``make_forward`` logits and one ``make_train_step``
(loss, and the gradient as ``(old - new) / lr``) are compared with remat
on and off and with gradient accumulation, attention through the flash
path (the JAX Pallas kernels in interpret mode, the port's plain
versions).

Tolerances: the loss within 1e-4 relative.  Both frameworks round every
weight product's inputs and result to bf16, forward and backward, and sum
in another order, so single elements of a gradient can differ by a bf16
rounding; each parameter's gradient is held in norm, ``‖Δg‖ / ‖g‖ <=
1e-3``.  Logits are held to 2e-2 absolute / 2e-3 relative, as in
tests/test_torch_transformer_lm.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.utils.convert import params_from_numpy, params_to_numpy

LOSS_RTOL = 1e-4
GRAD_REL_NORM = 1e-3
LOGIT_ATOL, LOGIT_RTOL = 2e-2, 2e-3
KW = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, use_flash=True)


def _batch(b=4, s=16, seed=1, vocab=64):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, s),
                                               dtype=np.int32)
    return ids, np.roll(ids, -1, axis=-1)


@pytest.fixture(scope="module")
def jparams():
    return jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**KW))


def _port_params(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")


def _flat(tree):
    return {path: leaf for path, leaf in _walk(tree, "")}


def _walk(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _grads(old, new, lr):
    o, n = _flat(old), _flat(new)
    return {k: (o[k] - n[k]) / lr for k in o}


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for k in want:
        rel = (np.linalg.norm(got[k] - want[k])
               / max(np.linalg.norm(want[k]), 1e-30))
        assert rel <= GRAD_REL_NORM, (k, rel)


@pytest.mark.parametrize("remat,accum", [(True, 1), (False, 1), (True, 2)],
                         ids=["remat", "no_remat", "remat_accum2"])
def test_train_step_matches_jax(jparams, remat, accum):
    ids, labels = _batch()
    lr = 0.5
    jstep = jax.jit(jlm.make_train_step(jlm.LMConfig(**KW, remat=remat),
                                        accum=accum))
    jnew, jloss = jstep(jparams, jnp.asarray(ids), jnp.asarray(labels), lr)
    tp = _port_params(jparams)
    tstep = tlm.make_train_step(tlm.LMConfig(**KW, remat=remat),
                                accum=accum, device="cpu")
    tnew, tloss = tstep(tp, torch.from_numpy(ids), torch.from_numpy(labels),
                        lr)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads_close(_grads(params_to_numpy(tp), params_to_numpy(tnew),
                               lr),
                        _grads(jparams, jnew, lr))
    # pure: the input params are untouched
    np.testing.assert_array_equal(tp["blk0"]["wqkv"].numpy(),
                                  np.asarray(jparams["blk0"]["wqkv"]))


def test_forward_logits_match_jax(jparams):
    ids, _ = _batch(b=2, s=24, seed=5)
    jfwd = jax.jit(jlm.make_forward(jlm.LMConfig(**KW)))
    want = np.asarray(jfwd(jparams, jnp.asarray(ids)))
    tfwd = tlm.make_forward(tlm.LMConfig(**KW), device="cpu")
    got, aux = tfwd(_port_params(jparams), torch.from_numpy(ids),
                    with_aux=True)
    assert got.shape == (2, 24, 64) and got.dtype == torch.float32
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), want, atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)


def test_grad_accumulation_matches_full_batch():
    """accum=K over K microbatches gives the same update as one full-batch
    step (same tokens, mean of means); the config of the JAX package's
    own test."""
    cfg = tlm.LMConfig(vocab=64, dim=32, heads=2, depth=2, max_seq=16,
                       mlp_mult=2, remat=False, attn_impl="dense")
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    ids, labels = (torch.from_numpy(x) for x in _batch(b=8, s=16, seed=1))
    p1, l1 = tlm.make_train_step(cfg, device="cpu")(params, ids, labels)
    p2, l2 = tlm.make_train_step(cfg, accum=4, device="cpu")(params, ids,
                                                             labels)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for a, b in zip(tlm.tree_leaves(p1), tlm.tree_leaves(p2)):
        # f32 summation order only
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


def test_remat_matches_no_remat(jparams):
    """Recomputing each block in the backward pass changes nothing."""
    ids, labels = (torch.from_numpy(x) for x in _batch(seed=3))
    tp = _port_params(jparams)
    out = [tlm.make_value_and_grad(tlm.LMConfig(**KW, remat=remat),
                                   device="cpu")(tp, ids, labels)
           for remat in (True, False)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tlm.tree_leaves(out[0][1]), tlm.tree_leaves(out[1][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_loss_descends():
    cfg = tlm.LMConfig(**KW, lr=0.3)
    params = tlm.init_params(torch.Generator().manual_seed(2), cfg,
                             device="cpu")
    ids = torch.arange(16).repeat(4, 2) % cfg.vocab
    step = tlm.make_train_step(cfg, accum=2, device="cpu")
    losses = []
    for _ in range(10):
        params, loss = step(params, ids, ids.roll(-1, -1))
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.8 * losses[0], losses


def test_indivisible_batch_raises():
    cfg = tlm.LMConfig(**KW)
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    ids = torch.zeros((6, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="not divisible by accum=4"):
        tlm.make_train_step(cfg, accum=4, device="cpu")(params, ids, ids)


def test_seq_longer_than_max_seq_raises():
    cfg = tlm.LMConfig(**KW)
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tlm.make_forward(cfg, device="cpu")(params,
                                            torch.zeros((1, 33), dtype=int))


@pytest.fixture
def world_one(tmp_path):
    """A gloo process group of this process alone (world size one)."""
    from brpc_tpu_torch.parallel.spmd import init_world
    init_world(0, 1, "cpu", str(tmp_path / "rendezvous"))
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_mesh_and_unported_configs_raise(world_one):
    """A mesh runs (multi-rank parity is in test_torch_sharded_training.py);
    what raises is a mesh the LM cannot use: an axis other than dp, tp and
    the sp axis, an sp axis the mesh lacks, heads that tp does not
    divide.  ``sp_axis`` without a mesh is ignored, as in the JAX
    package."""
    from brpc_tpu_torch.parallel import make_mesh
    cfg = tlm.LMConfig(**KW)
    for fn in (tlm.make_forward, tlm.make_train_step):
        with pytest.raises(ValueError, match="not \\['pp'\\]"):
            fn(cfg, mesh=make_mesh((1, 1), ("dp", "pp"), "cpu"),
               device="cpu")
        with pytest.raises(ValueError, match="no axis 'sp'"):
            fn(cfg, mesh=make_mesh((1, 1), ("dp", "tp"), "cpu"),
               sp_axis="sp", device="cpu")
        assert fn(cfg, sp_axis="sp", device="cpu") is not None
    # MoE and scan_layers configs train (their parity with the JAX package
    # is in test_torch_moe_lm.py and test_torch_scan_layers.py): one step
    # each, finite loss, every parameter moved
    ids = torch.from_numpy(_batch(b=2, s=8)[0]).long()
    for kw in (dict(moe_experts=4, moe_top_k=2), dict(scan_layers=True)):
        mcfg = tlm.LMConfig(**KW, **kw)
        params = tlm.init_params(torch.Generator().manual_seed(0), mcfg,
                                 device="cpu")
        new, loss = tlm.make_train_step(mcfg, device="cpu")(params, ids,
                                                            ids.roll(-1, 1))
        assert torch.isfinite(loss)
        assert all(not torch.equal(a, b) for a, b in zip(
            tlm.tree_leaves(new), tlm.tree_leaves(params)))


@pytest.mark.parametrize("names,sp_axis", [(("dp", "tp"), None),
                                           (("dp", "sp"), "sp")],
                         ids=["dp_tp", "sp"])
def test_world_one_mesh_step_equals_unsharded(world_one, jparams, names,
                                              sp_axis):
    """At world size one the sharded step is the unsharded one: the same
    loss and new params to the bit (chip_smoke.py phase 11 (b) runs this
    at full width on the card)."""
    from brpc_tpu_torch.parallel import make_mesh
    mesh = make_mesh((1, 1), names, "cpu")
    ids, labels = (torch.from_numpy(x) for x in _batch())
    cfg = tlm.LMConfig(**KW)
    tp = _port_params(jparams)
    want_new, want_loss = tlm.make_train_step(cfg, accum=2, device="cpu")(
        tp, ids, labels)
    new, loss = tlm.make_train_step(cfg, mesh=mesh, sp_axis=sp_axis,
                                    accum=2, device="cpu")(tp, ids, labels)
    assert torch.equal(loss, want_loss)
    for a, b in zip(tlm.tree_leaves(new), tlm.tree_leaves(want_new)):
        assert torch.equal(a, b)
