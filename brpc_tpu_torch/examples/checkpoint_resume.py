"""Checkpoint/resume — training state surviving preemption.

The port of ``examples/checkpoint_resume.py``: trains the TransformerLM
(vocab 128, dim 64, depth 2, lr 0.2, a (4, 64) batch: dense attention,
under the flash crossover), checkpoints every other step with
``utils.TrainCheckpointer``, then simulates a preemption: a fresh state
resumes from the older kept step, placed on its device through
``abstract_like``, and continues bit-identically.  :func:`train_and_resume`
takes optional ``params`` (the tests pass brpc_tpu's
``init_params(PRNGKey(0))`` draws); without them it draws its own from
``torch.Generator`` seed 0.  The checkpoint directory is a fresh
temporary one, removed at the end.

Run: ``python -m brpc_tpu_torch.examples.checkpoint_resume --device cpu``
"""

from __future__ import annotations

import shutil
import tempfile

import torch

from ..models import LMConfig, init_params, make_train_step
from ..models.transformer_lm import tree_leaves
from ..utils import TrainCheckpointer, abstract_like
from ..utils.convert import params_to_numpy
from . import parse_args

CFG = dict(vocab=128, dim=64, heads=4, depth=2, lr=0.2)


def train_and_resume(device, params=None) -> dict:
    """Eight steps with a checkpoint every other step, then steps 7-8
    again from step 6's checkpoint: ``{"losses": [8 floats],
    "trajectory": [the params (numpy) each of the 8 steps began from],
    "resumed_losses": [2 floats], "bit_identical": bool}``."""
    cfg = LMConfig(**CFG)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(gen, cfg, device)
    ids = torch.arange(32, dtype=torch.int32, device=device).tile((4, 2))
    labels = torch.roll(ids, -1, dims=-1)
    step = make_train_step(cfg, device=device)

    workdir = tempfile.mkdtemp(prefix="ckpt_demo_")
    ckpt = TrainCheckpointer(workdir, max_to_keep=2)
    print(f"checkpoints -> {workdir}")
    losses, resumed, trajectory = [], [], []
    try:
        state = {"params": params, "step": torch.tensor(0, dtype=torch.int32)}
        for i in range(1, 9):
            trajectory.append(params_to_numpy(state["params"]))
            p, loss = step(state["params"], ids, labels)
            state = {"params": p, "step": torch.tensor(i, dtype=torch.int32)}
            if i % 2 == 0:
                ckpt.save(i, state)
            losses.append(float(loss))
            print(f"step {i}  loss {losses[-1]:.4f}")
        final_before = state

        print(f"\n-- simulated preemption; kept steps: {ckpt.all_steps()} "
              f"--\n")

        # resume from the OLDER kept step so the replayed tail is real
        # work (tensors land straight on their device via the target)
        oldest = min(ckpt.all_steps())
        state = ckpt.restore(step=oldest, like=abstract_like(final_before))
        for i in range(int(state["step"]) + 1, 9):
            p, loss = step(state["params"], ids, labels)
            state = {"params": p, "step": torch.tensor(i, dtype=torch.int32)}
            resumed.append(float(loss))
            print(f"resumed step {i}  loss {resumed[-1]:.4f}")

        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(state["params"]),
            tree_leaves(final_before["params"])))
        print(f"\nresumed trajectory bit-identical to uninterrupted: {same}")
        assert same
    finally:
        ckpt.close()
        shutil.rmtree(workdir, ignore_errors=True)
    return {"losses": losses, "trajectory": trajectory,
            "resumed_losses": resumed, "bit_identical": same}


def main(argv=None) -> int:
    train_and_resume(parse_args(__doc__, argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
