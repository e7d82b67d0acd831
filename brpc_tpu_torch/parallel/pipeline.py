"""Pipeline parallelism over a mesh axis (GPipe).

Counterpart of ``brpc_tpu/parallel/pipeline.py``, one program per stage.
Rank i of the ``pp`` axis holds stage i's parameters, its block of the
stacked ``(n_stages, ...)`` leaves (leading dim 1, as a JAX device sees
its shard).  The conveyor runs ``n_micro + n_stages - 1`` ticks: stage 0
takes microbatch t, every other stage the activation that just arrived
from the stage before it (a :func:`~.mesh_transport.ring_shift`), and the
last stage emits microbatch ``t - (n - 1)``.  The outputs are replicated
by a masked ``psum``.

Training: JAX differentiates its ``lax.scan`` conveyor and gets the
backward conveyor from AD.  The port gets it from autograd through the
differentiable ``ring_shift`` (the cotangent shifts back one stage a
tick) and ``psum`` (the cotangent passes through).  Every stage keeps the
other branch of each selection in the graph with a zero cotangent, as
``jnp.where`` does, so that every rank runs the same ring shifts in its
backward pass.  With ``dp_axis`` the loss is a ``pmean`` over dp and the
stage gradients are summed over dp, as JAX's transpose of a replicated
input sums them: the gradient of the mean loss.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .mesh_transport import Axis, _all_reduce, pmean, psum, ring_shift


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree) -> list:
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _rebuild(tree, leaves):
    return {k: _rebuild(v, leaves) if isinstance(v, dict) else next(leaves)
            for k, v in tree.items()}


def _conveyor(ax: Axis, stage_fn: Callable, my_params, xs):
    """The forward conveyor; the emitted microbatches, replicated."""
    n = ax.size
    n_micro = xs.shape[0]
    first = torch.tensor(ax.rank == 0, device=xs.device)
    last = torch.tensor(ax.rank == n - 1, device=xs.device)
    state = torch.zeros_like(xs[0])
    outputs = [torch.zeros_like(xs[0]) for _ in range(n_micro)]
    for t in range(n_micro + n - 1):
        inp = torch.where(first, xs[min(t, n_micro - 1)], state)
        out = stage_fn(my_params, inp)
        state = ring_shift(out, ax, 1)
        if t >= n - 1:
            outputs[t - (n - 1)] = out
    outputs = torch.stack(outputs)
    return psum(torch.where(last, outputs, torch.zeros_like(outputs)), ax)


def make_pipeline(mesh, stage_fn: Callable, axis: str = "pp"):
    """``run(stage_params, microbatches) -> outputs``: ``stage_params``
    this rank's block (leaves with leading dim 1), ``microbatches``
    ``(n_micro, mb, ...)`` replicated; the outputs, replicated."""
    ax = Axis(mesh, axis)

    def run(params, xs):
        with torch.no_grad():
            return _conveyor(ax, stage_fn, _map(params, lambda p: p[0]), xs)

    return run


def make_pipeline_train(mesh, stage_fn: Callable, loss_fn: Callable,
                        axis: str = "pp", dp_axis: Optional[str] = None):
    """``step(stage_params, xs, ys) -> (loss, grads)``: a GPipe training
    step.  ``grads`` has ``stage_params``' layout (this stage's block).
    ``xs``/``ys`` are ``(n_micro, mb, ...)`` replicated, or with
    ``dp_axis`` this rank's share of the microbatch dim.  ``loss_fn(
    outputs, ys)`` gives the scalar of the unpipelined model."""
    ax = Axis(mesh, axis)
    dp = Axis(mesh, dp_axis) if dp_axis is not None else None

    def step(params, xs, ys):
        leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
        live = _rebuild(params, iter(leaves))
        with torch.enable_grad():
            outputs = _conveyor(ax, stage_fn, _map(live, lambda p: p[0]), xs)
            loss = loss_fn(outputs, ys)
            if dp is not None:
                loss = pmean(loss, dp)
            grads = torch.autograd.grad(loss, leaves)
        if dp is not None:
            grads = [_all_reduce(dp, g) for g in grads]
        return loss.detach(), _rebuild(params, iter(grads))

    return step
