"""TransformerLM — train the long-context flagship on a device mesh.

The port of ``examples/train_transformer_lm.py``.  Demonstrates the
dense-compute model family end to end:

- dp×tp sharded SGD training (tensor-parallel projections, data-parallel
  batch).  brpc_tpu lets XLA insert the collectives from its
  NamedSharding specs; the port runs one process per rank, cuts each
  rank's shard with ``utils.convert.shard_from_numpy`` under
  ``param_specs`` and calls the collectives itself
  (``make_train_step(mesh=...)``);
- sequence-parallel ring attention for long context (the same forward
  spread over an ``sp`` axis so context length scales with ranks);
- remat on.  The 128-token training sequence is the flash crossover
  (``ops.flash_attention.DENSE_FLASH_CROSSOVER``), so on the card every
  step runs the hand kernels ``flash_fwd``, ``flash_dq`` and
  ``flash_dkdv``.

brpc_tpu builds its mesh from ``jax.devices()``; the port takes
``--world`` ranks (default one per card on cuda, one on the CPU).  On one
card the mesh is dp=1 tp=1 and, as brpc_tpu does at one device, the
sequence-parallel forward is skipped.  :func:`train` takes optional
``params`` as brpc_tpu's numpy tree (the tests pass its
``init_params(PRNGKey(0))`` draws); without them it draws its own from
``torch.Generator`` seed 0.

Run: ``python -m brpc_tpu_torch.examples.train_transformer_lm --device cpu
--world 4``
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import LMConfig, init_params, make_forward, make_train_step
from ..models.transformer_lm import param_specs
from ..parallel import make_mesh
from ..utils.convert import (params_from_shards, params_to_numpy,
                             shard_from_numpy)
from . import Ranks, default_world, parse_args, rank_device

STEPS = 20


def config(world: int) -> dict:
    return dict(vocab=256, dim=64, heads=4, depth=2,
                max_seq=max(128, 16 * world), lr=0.3)


def mesh_shape(world: int) -> tuple:
    tp = 2 if world % 2 == 0 else 1
    return world // tp, tp


def batch(dp: int) -> tuple:
    """The toy task: predict the next token of a repeating pattern."""
    ids = np.tile(np.arange(64, dtype=np.int32), (4 * dp, 2))
    return ids, np.roll(ids, -1, axis=-1)


def long_ids(world: int) -> np.ndarray:
    return np.tile(np.arange(64, dtype=np.int32),
                   (2, (16 * world) // 64 + 1))[:, :16 * world]


def _coords(mesh) -> dict:
    return {n: (mesh.get_local_rank(n), mesh.size(i))
            for i, n in enumerate(mesh.mesh_dim_names)}


def _block(a: np.ndarray, coords: dict, axis: str, dim: int) -> np.ndarray:
    i, n = coords.get(axis, (0, 1))
    return np.split(a, n, axis=dim)[i]


def rank_train(kw, whole, ids, labels, device_type: str) -> tuple:
    """On each rank: ``STEPS`` steps on a ``("dp", "tp")`` mesh of every
    rank; ``(coords, losses, [the shard each step began from, then the
    last step's result], as numpy)``."""
    dev = rank_device(device_type)
    cfg = LMConfig(**kw)
    mesh = make_mesh(mesh_shape(torch.distributed.get_world_size()),
                     ("dp", "tp"), dev)
    co = _coords(mesh)
    params = shard_from_numpy(whole, param_specs(cfg), co, dev)
    ids_b, lbl_b = (torch.from_numpy(np.array(_block(a, co, "dp", 0))).to(dev)
                    for a in (ids, labels))
    step = make_train_step(cfg, mesh=mesh, device=dev)
    losses, shards = [], [params_to_numpy(params)]
    for _ in range(STEPS):
        params, loss = step(params, ids_b, lbl_b)
        losses.append(float(loss))
        shards.append(params_to_numpy(params))
    return co, losses, shards


def rank_sp_forward(kw, whole, ids, device_type: str) -> np.ndarray:
    """On each rank: the logits of this rank's sequence block under an
    ``("sp",)`` mesh of every rank (ring attention)."""
    dev = rank_device(device_type)
    cfg = LMConfig(**kw)
    mesh = make_mesh((torch.distributed.get_world_size(),), ("sp",), dev)
    co = _coords(mesh)
    params = shard_from_numpy(whole, param_specs(cfg), co, dev)
    ids_b = torch.from_numpy(np.array(_block(ids, co, "sp", 1))).to(dev)
    with torch.no_grad():
        logits = make_forward(cfg, mesh=mesh, sp_axis="sp", device=dev)(
            params, ids_b)
    return logits.cpu().numpy()


def train(device, world=None, params=None) -> dict:
    """The sharded run: ``{"losses": [STEPS floats], "trajectory": the
    whole tree (numpy) each step began from, "params": the trained tree,
    "sp_logits": (2, 16 * world, vocab) or None at one rank}``."""
    world = world or default_world(device)
    dp, tp = mesh_shape(world)
    print(f"mesh: dp={dp} tp={tp} on {device.type}")
    kw = config(world)
    cfg = LMConfig(**kw)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = params_to_numpy(init_params(gen, cfg, device))
    ids, labels = batch(dp)
    logits = None
    with Ranks(world, device) as ranks:
        got = ranks.run(rank_train, kw, params, ids, labels, device.type)
        losses = got[0][1]
        for i, loss in enumerate(losses):
            if i % 5 == 0 or i == STEPS - 1:
                print(f"step {i:3d}  loss {loss:.4f}")
        specs = param_specs(cfg)
        trajectory = [params_from_shards([(co, shards[i])
                                          for co, _, shards in got], specs)
                      for i in range(STEPS + 1)]
        trained = trajectory.pop()

        # long context via sequence parallelism: same params, attention
        # over an sp axis — each rank holds 1/n of the sequence
        if world >= 2:
            logits = np.concatenate(ranks.run(
                rank_sp_forward, kw, trained, long_ids(world), device.type),
                axis=1)
            print(f"sequence-parallel forward over {world} chips: "
                  f"logits {tuple(logits.shape)} finite="
                  f"{bool(np.isfinite(logits).all())}")
    return {"losses": losses, "trajectory": trajectory, "params": trained,
            "sp_logits": logits}


def main(argv=None) -> int:
    args = parse_args(__doc__, argv, lambda p: p.add_argument(
        "--world", type=int, default=None,
        help="ranks of the dp x tp mesh (default: one per card on cuda, "
             "1 on cpu)"))
    train(args.device, args.world)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
