"""What each rank runs in the port's multi-process tests.

The test files (``test_torch_mesh_transport.py``,
``test_torch_seq_pipeline.py``, ``test_torch_sharded_training.py``) hand
these functions to a ``brpc_tpu_torch.parallel.spmd.SpmdPool`` of gloo
ranks on the CPU.  The workers import this module and the port only,
never JAX: every argument and result is numpy or plain Python.  Each
function takes the *whole* inputs, as the JAX reference sees them, and
cuts this rank's block itself.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from brpc_tpu_torch.models import embedding_ps as tps
from brpc_tpu_torch.models import moe as tmoe
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.parallel import mesh_transport as mt
from brpc_tpu_torch.parallel.pipeline import make_pipeline, make_pipeline_train
from brpc_tpu_torch.parallel.ring_attention import (make_ring_attention,
                                                    make_ulysses_attention)
from brpc_tpu_torch.utils.convert import params_to_numpy, shard_from_numpy


def _mesh(shape, names):
    return mt.make_mesh(tuple(shape), tuple(names), "cpu")


def _coords(mesh) -> dict:
    return {n: (mesh.get_local_rank(n), mesh.size(i))
            for i, n in enumerate(mesh.mesh_dim_names)}


def _block(a, coords, axis_name, dim):
    """This rank's block of ``a`` along ``dim``, cut over ``axis_name``."""
    i, n = coords.get(axis_name, (0, 1))
    return np.split(np.asarray(a), n, axis=dim)[i]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# -- mesh transport ----------------------------------------------------------

def transport_ops(x, a2a):
    """Every MeshTransport method on this rank's block of ``x`` (rows)."""
    tr = mt.MeshTransport(mt.default_mesh("ici", "cpu"), "ici",
                          device="cpu")
    xs = tr.scatter(x, axis=0)
    return {"n_peers": tr.n_peers, "endpoint": str(tr.endpoint(tr.rank)),
            "scatter": xs.numpy(), "gather": tr.gather(xs),
            "shift1": tr.ring_shift(xs, 1).numpy(),
            "shift3": tr.ring_shift(xs, 3).numpy(),
            "psum": tr.psum(xs).numpy(),
            "all_gather": tr.all_gather(xs).numpy(),
            "reduce_scatter": tr.reduce_scatter(xs).numpy(),
            "all_to_all": tr.all_to_all(tr.scatter(a2a, 0), 1, 0).numpy(),
            "replicate": tr.replicate(x).numpy()}


def collective_grad(name, x, c, kw):
    """The gradient of ``sum(op(x_block) * c_block)`` for one collective
    of MeshTransport; ``c`` is the whole cotangent, cut as the op's output
    is (whole for a replicated output)."""
    tr = mt.MeshTransport(mt.default_mesh("ici", "cpu"), "ici",
                          device="cpu")
    n, r = tr.n_peers, tr.rank
    xs = tr.scatter(x, 0).requires_grad_(True)
    y = getattr(tr, name)(xs, **kw)
    if name in ("psum", "all_gather"):
        cb = c
    else:
        cb = np.split(c, n, axis=0)[r]
    (y * _t(cb)).sum().backward()
    return xs.grad.numpy()


def transpose_pair(x, c):
    """pvary's and all_gather_sum_grad's gradients on this rank's block:
    each is the transpose of psum and of all_gather respectively (the
    cotangents differ by rank)."""
    ax = mt.Axis(mt.default_mesh("ici", "cpu"), "ici")
    xs = _t(np.split(x, ax.size, 0)[ax.rank]).requires_grad_(True)
    cb = _t(np.split(c, ax.size, 0)[ax.rank])
    (mt.pvary(xs, ax) * cb[:1]).sum().backward()
    g_pvary = xs.grad.numpy().copy()
    xs.grad = None
    (mt.all_gather_sum_grad(xs, ax, 0) * _t(c) * (ax.rank + 1)
     ).sum().backward()
    return g_pvary, xs.grad.numpy()


def cuda_tensor_refused():
    """A gloo axis refuses a tensor of another device type (no staging)."""
    ax = mt.Axis(mt.default_mesh("ici", "cpu"), "ici")
    try:
        ax.device_type = "cuda"          # as a cuda mesh would say
        mt.psum(torch.ones(2), ax)
    except ValueError as e:
        return str(e)
    return None


# -- sequence and pipeline parallelism --------------------------------------

def seq_attention(kind, q, k, v, causal, use_flash=False, cot=None):
    """Ring or Ulysses attention over an ``("sp",)`` mesh on this rank's
    sequence block; with ``cot`` also the gradients of ``sum(out * cot)``
    for this rank's q, k, v blocks."""
    mesh = _mesh((dist.get_world_size(),), ("sp",))
    co = _coords(mesh)
    blocks = [_t(_block(a, co, "sp", 1)) for a in (q, k, v)]
    if cot is not None:
        for b in blocks:
            b.requires_grad_(True)
    if kind == "ring":
        attend = make_ring_attention(mesh, "sp", causal=causal)
    else:
        attend = make_ulysses_attention(mesh, "sp", causal=causal,
                                        use_flash=use_flash)
    out = attend(*blocks)
    if cot is None:
        return out.detach().numpy()
    (out * _t(_block(cot, co, "sp", 1))).sum().backward()
    return out.detach().numpy(), [b.grad.numpy() for b in blocks]


def ulysses_heads_refused(q):
    mesh = _mesh((dist.get_world_size(),), ("sp",))
    qb = _t(_block(q, _coords(mesh), "sp", 1))
    try:
        make_ulysses_attention(mesh, "sp")(qb, qb, qb)
    except ValueError as e:
        return str(e)
    return None


def _stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _mse(outputs, ys):
    return torch.mean((outputs - ys) ** 2)


def pipeline_forward(params, xs):
    mesh = _mesh((dist.get_world_size(),), ("pp",))
    co = _coords(mesh)
    mine = {k: _t(_block(v, co, "pp", 0)) for k, v in params.items()}
    return make_pipeline(mesh, _stage, "pp")(mine, _t(xs)).numpy()


def pipeline_train(params, xs, ys, shape, names):
    """One GPipe step on mesh ``names`` (``("pp",)`` or ``("dp",
    "pp")``): this rank's loss and stage gradients."""
    mesh = _mesh(shape, names)
    co = _coords(mesh)
    dp = "dp" if "dp" in names else None
    mine = {k: _t(_block(v, co, "pp", 0)) for k, v in params.items()}
    xb, yb = (_t(_block(a, co, "dp", 1)) for a in (xs, ys))
    loss, grads = make_pipeline_train(mesh, _stage, _mse, "pp",
                                      dp_axis=dp)(mine, xb, yb)
    return co, float(loss), {k: g.numpy() for k, g in grads.items()}


# -- sharded training --------------------------------------------------------

def lm_step(kw, whole, ids, labels, shape, names, sp_axis=None, accum=1,
            lr=0.5):
    """One ``make_train_step(mesh=...)`` on this rank's shard and batch
    block: ``(coords, loss, new shard)``."""
    cfg = tlm.LMConfig(**kw)
    mesh = _mesh(shape, names)
    co = _coords(mesh)
    params = shard_from_numpy(whole, tlm.param_specs(cfg), co, "cpu")
    ids_b = _block(_block(ids, co, "dp", 0), co, sp_axis, 1)
    lbl_b = _block(_block(labels, co, "dp", 0), co, sp_axis, 1)
    new, loss = tlm.make_train_step(cfg, mesh=mesh, sp_axis=sp_axis,
                                    accum=accum, device="cpu")(
        params, _t(ids_b), _t(lbl_b), lr)
    return co, float(loss), params_to_numpy(new)


def lm_forward(kw, whole, ids, shape, names, sp_axis=None):
    """``make_forward(mesh=...)`` logits of this rank's block."""
    cfg = tlm.LMConfig(**kw)
    mesh = _mesh(shape, names)
    co = _coords(mesh)
    params = shard_from_numpy(whole, tlm.param_specs(cfg), co, "cpu")
    ids_b = _block(_block(ids, co, "dp", 0), co, sp_axis, 1)
    with torch.no_grad():
        logits = tlm.make_forward(cfg, mesh=mesh, sp_axis=sp_axis,
                                  device="cpu")(params, _t(ids_b))
    return co, logits.numpy()


def moe_ep_forward(cfg_kw, whole, x):
    """``moe.forward`` with the experts cut over an ``("ep",)`` mesh."""
    cfg = tmoe.MoEConfig(**cfg_kw)
    mesh = _mesh((dist.get_world_size(),), ("ep",))
    params = shard_from_numpy(whole, tmoe.param_specs(cfg), _coords(mesh),
                              "cpu")
    with torch.no_grad():
        out, aux = tmoe.forward(params, _t(x), cfg,
                                ep=mt.Axis(mesh, "ep"))
    return out.numpy(), float(aux), tuple(params["w1"].shape)


def ps_step(cfg_kw, whole, ids, labels, shape, lr):
    """The sharded PS: one ``sgd_train_step`` and one
    ``EmbeddingPS(mesh=)`` step from the same whole params."""
    cfg = tps.PSConfig(**cfg_kw)
    mesh = _mesh(shape, ("dp", "tp"))
    co = _coords(mesh)
    params = shard_from_numpy(whole, tps.param_specs(cfg), co, "cpu")
    ids_b, lbl_b = (_t(_block(a, co, "dp", 0)) for a in (ids, labels))
    new, loss = tps.sgd_train_step(params, ids_b, lbl_b, lr, mesh=mesh)
    model = tps.EmbeddingPS(cfg, device="cpu", mesh=mesh,
                            params={k: _t(v) for k, v in whole.items()})
    m_ids, m_lbl = model.shard_batch(ids, labels)
    m_loss = model.train_step(m_ids, m_lbl)
    from brpc_tpu_torch.models.ps_service import PSService
    import json
    stat = json.loads(PSService(model).Stat(None, b""))
    return (co, float(loss), params_to_numpy(new), m_loss,
            params_to_numpy(model.params), stat["sharded"])


def ps_lookup(cfg_kw, whole, ids, shape):
    """``EmbeddingPS(mesh=).lookup``: the pooled rows, whole, on every
    rank."""
    cfg = tps.PSConfig(**cfg_kw)
    mesh = _mesh(shape, ("dp", "tp"))
    model = tps.EmbeddingPS(cfg, device="cpu", mesh=mesh,
                            params={k: _t(v) for k, v in whole.items()})
    return model.lookup(ids).numpy()
