"""The port's model-bearing examples against brpc_tpu's, on the CPU.

Each port example runs in this process (its multi-rank work in gloo
rank processes), fed with the JAX example's own draws converted through
numpy, and its results are held to the JAX example's computation on the
same inputs:

- ``lm_serving``: the three completions equal, token for token, those of
  brpc_tpu's ``LMService()`` (its ``init_params(PRNGKey(0))`` weights)
  over a JAX server and channel;
- ``train_transformer_lm`` at world 4 (dp 2 x tp 2 gloo ranks): the
  loss of each of the 20 steps against JAX's dp x tp step on a 4-device
  mesh from the same weights (the ones the port's step began from) at
  tests/test_torch_sharded_training.py's tensor-parallel rtol, 1e-3 on
  the loss (each tp product's partial sums round to bf16, in both, before
  they are summed), with an atol of 2e-3: as the loss falls to 0.045 the
  rounding stays near 1e-3 in absolute terms, and JAX's own 1 x 4 step
  from the same weights differs from its dp 2 x tp 2 step by up to
  1.41e-3 (3.2e-3 relative); the port's by up to 1.43e-3.  The two
  free-running 20-step trajectories are not compared: those roundings
  compound at lr 0.3, and JAX's own dp 2 x tp 2 trajectory differs from
  its dp 4, tp 4 and one-device ones by up to 8.9e-3 in a step's loss
  (the port's from JAX's dp 2 x tp 2 one: 8.1e-3).  The sequence-parallel logits of the
  port's trained weights against JAX's ring forward of the same weights
  at test_transformer_lm.py's ring tolerance (rtol 3e-2, atol 8e-3);
- ``checkpoint_resume``: the port's resume bit-identical (``torch.equal``
  on every leaf), its replayed losses equal to the uninterrupted ones,
  its first loss (from the initial weights) against JAX's at
  test_torch_train_step.py's rtol 1e-4, and each of its eight losses
  against JAX's step from the same weights at chip_smoke.py's
  bf16-rounding rule, rtol 1e-3: both round every weight product to
  bf16 and sum in another order, and on trained weights that reaches
  3.1e-4 in the loss (step 7).  Free-running, the two trajectories part
  by 1.5e-2 at step 8 (the roundings compound at lr 0.2), so they are
  not compared;
- ``pipeline_train`` at 4 stages: the losses of the 10 steps against
  JAX's ``make_pipeline_train`` at test_torch_seq_pipeline.py's loss
  tolerance (rtol 1e-5, atol 1e-6).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import Controller as JController
from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.parallel.pipeline import make_pipeline_train as jpipeline
from brpc_tpu.server import Server as JServer
from brpc_tpu_torch.examples import (checkpoint_resume, lm_serving,
                                     pipeline_train, train_transformer_lm)
from brpc_tpu_torch.utils.convert import params_from_numpy

CPU = torch.device("cpu")
WORLD = 4
TP_LOSS_RTOL, TP_LOSS_ATOL = 1e-3, 2e-3
RING_RTOL, RING_ATOL = 3e-2, 8e-3
STEP_LOSS_RTOL, TRAINED_LOSS_RTOL = 1e-4, 1e-3
PIPE_RTOL, PIPE_ATOL = 1e-5, 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_generate(svc) -> list:
    """brpc_tpu's example's three Generate calls on ``svc``."""
    srv = JServer()
    srv.add_service(svc, name="LM")
    assert srv.start("127.0.0.1:0") == 0
    ch = JChannel()
    try:
        ch.init(str(srv.listen_endpoint))
        prompt = np.arange(12, dtype=np.int32).reshape(1, 12)
        outs = []
        for _ in range(3):
            cntl = JController()
            cntl.timeout_ms = 120_000
            c = ch.call_method("LM.Generate",
                               jsvc.pack_generate_request(prompt, 16),
                               cntl=cntl)
            assert not c.failed, c.error_text
            outs.append(np.array(jsvc.unpack_generated(c.response)))
        return outs
    finally:
        srv.stop()


def test_lm_serving_tokens_equal_jax():
    jax_svc = jsvc.LMService()
    want = _jax_generate(jax_svc)
    got = lm_serving.serve(CPU, params=params_from_numpy(
        _np(jax_svc.params), CPU))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_train_transformer_lm_matches_jax():
    kw = train_transformer_lm.config(WORLD)
    dp, tp = train_transformer_lm.mesh_shape(WORLD)
    assert (dp, tp) == (2, 2)
    cfg = jlm.LMConfig(**kw)
    whole = _np(jlm.init_params(jax.random.PRNGKey(0), cfg))

    got = train_transformer_lm.train(CPU, WORLD, params=whole)

    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(dp, tp),
                ("dp", "tp"))
    ids, labels = train_transformer_lm.batch(dp)
    ids_spec, lbl_spec = jlm.batch_specs()
    ids = jax.device_put(ids, NamedSharding(mesh, ids_spec))
    labels = jax.device_put(labels, NamedSharding(mesh, lbl_spec))
    step = jax.jit(jlm.make_train_step(cfg))
    assert len(got["trajectory"]) == train_transformer_lm.STEPS
    for leaf, want_leaf in zip(jax.tree_util.tree_leaves(
            got["trajectory"][0]), jax.tree_util.tree_leaves(whole)):
        np.testing.assert_array_equal(leaf, want_leaf)
    want = []
    with mesh:
        for before in got["trajectory"]:
            params = jax.tree_util.tree_map(
                lambda p, s: jax.device_put(p, NamedSharding(mesh, s)),
                before, jlm.param_specs(cfg))
            want.append(float(step(params, ids, labels)[1]))
    np.testing.assert_allclose(got["losses"], want, rtol=TP_LOSS_RTOL,
                               atol=TP_LOSS_ATOL)
    np.testing.assert_allclose(got["losses"][0], want[0], rtol=TP_LOSS_RTOL)
    assert got["losses"][-1] < got["losses"][0]

    sp_mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sp",))
    long_ids = jax.device_put(train_transformer_lm.long_ids(WORLD),
                              NamedSharding(sp_mesh, P(None, "sp")))
    ring = jlm.make_forward(cfg, mesh=sp_mesh, sp_axis="sp")(
        got["params"], long_ids)
    assert got["sp_logits"].shape == (2, 16 * WORLD, kw["vocab"])
    np.testing.assert_allclose(got["sp_logits"], np.asarray(ring),
                               rtol=RING_RTOL, atol=RING_ATOL)


def test_train_transformer_lm_one_rank_has_no_sp_forward():
    """At one rank, as brpc_tpu at one device, the mesh is dp=1 tp=1 and
    the sequence-parallel forward is skipped."""
    kw = train_transformer_lm.config(1)
    whole = _np(jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**kw)))
    got = train_transformer_lm.train(CPU, 1, params=whole)
    assert got["sp_logits"] is None
    assert len(got["losses"]) == train_transformer_lm.STEPS
    assert np.isfinite(got["losses"]).all()
    assert got["losses"][-1] < got["losses"][0]


def test_checkpoint_resume_matches_jax():
    cfg = jlm.LMConfig(**checkpoint_resume.CFG)
    whole = _np(jlm.init_params(jax.random.PRNGKey(0), cfg))
    got = checkpoint_resume.train_and_resume(
        CPU, params=params_from_numpy(whole, CPU))
    assert got["bit_identical"]
    assert got["resumed_losses"] == got["losses"][-2:]

    ids = np.tile(np.arange(32, dtype=np.int32), (4, 2))
    labels = np.roll(ids, -1, axis=-1)
    step = jax.jit(jlm.make_train_step(cfg))
    assert len(got["trajectory"]) == 8
    want = [float(step(before, ids, labels)[1])
            for before in got["trajectory"]]
    np.testing.assert_allclose(got["losses"][0], want[0],
                               rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], want, rtol=TRAINED_LOSS_RTOL)


def test_pipeline_train_matches_jax():
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    width, n_micro, mb = (pipeline_train.WIDTH, pipeline_train.N_MICRO,
                          pipeline_train.MB)
    w = np.asarray(jax.random.normal(ks[0], (WORLD, width, width)) * 0.3)
    b = np.asarray(jax.random.normal(ks[1], (WORLD, width)) * 0.1)
    xs = np.asarray(jax.random.normal(ks[2], (n_micro, mb, width)))
    ys = np.asarray(jax.random.normal(ks[3], (n_micro, mb, width)))

    got = pipeline_train.train(CPU, WORLD, params={"w": w, "b": b},
                               xs=xs, ys=ys)

    import jax.numpy as jnp
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("pp",))
    params = {k: jax.device_put(v, NamedSharding(mesh, P("pp")))
              for k, v in (("w", w), ("b", b))}
    step = jpipeline(mesh, lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
                     lambda out, y: jnp.mean((out - y) ** 2), "pp")
    want = []
    for _ in range(pipeline_train.STEPS):
        loss, grads = step(params, xs, ys)
        params = jax.tree_util.tree_map(
            lambda p, g: p - pipeline_train.LR * g, params, grads)
        want.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=PIPE_RTOL, atol=PIPE_ATOL)


@pytest.mark.parametrize("module", [lm_serving, train_transformer_lm,
                                    checkpoint_resume, pipeline_train],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_model_example_main_runs_on_the_cpu(module, capsys):
    """``main(["--device", "cpu"])`` runs the example end to end at its
    default world (one rank on the CPU) and exits 0."""
    assert module.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip()
