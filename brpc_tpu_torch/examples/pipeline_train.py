"""GPipe pipeline-parallel training.

The port of ``examples/pipeline_train.py``.  brpc_tpu writes the
microbatch conveyor as a ``lax.scan`` inside ``shard_map`` and lets
reverse-mode AD derive the backward conveyor; the port's
``parallel.pipeline.make_pipeline_train`` runs the conveyor on one
process per stage (ring shifts between the ranks) and autograd through it
gives each stage its gradient, accumulated over the microbatches.  Loss
and stage gradients match the unpipelined model.

One stage per rank: ``--world`` ranks (default one per card on cuda, one
on the CPU, where brpc_tpu takes every device JAX sees).  On one card the
pipeline has one stage.  :func:`train` takes optional ``params``, ``xs``
and ``ys`` as numpy (the tests pass brpc_tpu's ``jax.random.normal``
draws); without them it draws its own from ``torch.Generator`` seed 0.

Run: ``python -m brpc_tpu_torch.examples.pipeline_train --device cpu
--world 4``
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import make_mesh
from ..parallel.pipeline import make_pipeline_train
from . import Ranks, default_world, parse_args, rank_device

WIDTH, N_MICRO, MB = 32, 8, 4
LR = 0.05
STEPS = 10


def stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def loss_fn(outputs, ys):
    return torch.mean((outputs - ys) ** 2)


def draw(world: int, seed: int = 0) -> tuple:
    """Stage params (``w`` ``(world, 32, 32)`` * 0.3, ``b`` ``(world,
    32)`` * 0.1) and the microbatches ``xs``, ``ys`` ``(8, 4, 32)``, all
    standard normal draws scaled as brpc_tpu's, as numpy."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen).numpy()

    params = {"w": normal(world, WIDTH, WIDTH) * 0.3,
              "b": normal(world, WIDTH) * 0.1}
    return (params, normal(N_MICRO, MB, WIDTH),
            normal(N_MICRO, MB, WIDTH))


def rank_train(params, xs, ys, device_type: str) -> list:
    """On each rank: ``STEPS`` SGD steps of this stage over a ``("pp",)``
    mesh of every rank; the loss of each step."""
    dev = rank_device(device_type)
    world = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    mesh = make_mesh((world,), ("pp",), dev)
    mine = {k: torch.from_numpy(np.array(v[rank:rank + 1])).to(dev)
            for k, v in params.items()}
    xs_t, ys_t = (torch.from_numpy(np.array(a)).to(dev) for a in (xs, ys))
    step = make_pipeline_train(mesh, stage_fn, loss_fn, "pp")
    losses = []
    for _ in range(STEPS):
        loss, grads = step(mine, xs_t, ys_t)
        mine = {k: p - LR * grads[k] for k, p in mine.items()}
        losses.append(float(loss))
    return losses


def train(device, world=None, params=None, xs=None, ys=None) -> list:
    """The pipelined training run; the loss of each step."""
    world = world or default_world(device)
    if params is None:
        params, xs, ys = draw(world)
    print(f"{world} devices on {device.type}")
    with Ranks(world, device) as ranks:
        per_rank = ranks.run(rank_train, params, xs, ys, device.type)
    losses = per_rank[0]
    for i, loss in enumerate(losses):
        print(f"step {i}: loss {loss:.5f}  "
              f"(grads spread over {len(per_rank)} devices)")
    return losses


def main(argv=None) -> int:
    args = parse_args(__doc__, argv, lambda p: p.add_argument(
        "--world", type=int, default=None,
        help="pipeline stages, one rank each (default: one per card on "
             "cuda, 1 on cpu)"))
    train(args.device, args.world)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
