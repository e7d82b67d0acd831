"""The port's TrainCheckpointer on the CPU: save/restore against an
abstract target, latest-step and retention, the empty case, and a
mid-training resume that continues bit-identically — the port's version
of tests/test_checkpoint.py.  Values are compared exactly."""

import os

import pytest
import torch

from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.utils.checkpoint import (TensorSpec, TrainCheckpointer,
                                             abstract_like)


def _state(step=0):
    return {"params": {"w": torch.arange(64, dtype=torch.float32)
                       .reshape(8, 8),
                       "b": torch.ones(8, dtype=torch.bfloat16)},
            "moments": [torch.zeros(3), torch.full((2,), 0.5)],
            "step": step}


def test_save_restore_preserves_values_and_placement(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path), max_to_keep=2)
    state = _state()
    ckpt.save(1, state)
    like = abstract_like(state)
    assert like["params"]["w"] == TensorSpec((8, 8), torch.float32, "cpu")
    got = ckpt.restore(like=like)
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    assert got["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["b"], state["params"]["b"])
    assert isinstance(got["moments"], list)
    assert torch.equal(got["moments"][1], state["moments"][1])
    assert got["step"] == 0
    # without a target the tensors come back on the CPU, values intact
    plain = ckpt.restore()
    assert torch.equal(plain["params"]["w"], state["params"]["w"])
    ckpt.close()


def test_saved_state_is_a_snapshot(tmp_path):
    """The state is copied at save time: changing it afterwards, even
    while an async write is in flight, does not reach the checkpoint."""
    ckpt = TrainCheckpointer(str(tmp_path))
    state = _state()
    ckpt.save(1, state, wait=False)
    state["params"]["w"].add_(1.0)
    ckpt.wait()
    got = ckpt.restore(like=abstract_like(state))
    assert torch.equal(got["params"]["w"], state["params"]["w"] - 1.0)
    ckpt.close()


def test_latest_step_and_retention(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, _state(step=s))
    assert ckpt.latest_step() == 4
    assert ckpt.all_steps() == [3, 4]           # max_to_keep pruned 1, 2
    assert int(ckpt.restore()["step"]) == 4
    assert int(ckpt.restore(step=3)["step"]) == 3
    # a write that never finished (its temp file) is never visible
    (tmp_path / "step_9.pt.123.tmp").write_bytes(b"partial")
    assert ckpt.latest_step() == 4
    ckpt.close()


def test_restore_without_checkpoint_raises(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    ckpt.close()


def test_restore_checks_the_target(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path))
    state = _state()
    ckpt.save(1, state)
    like = abstract_like(state)
    like["params"]["w"] = TensorSpec((4, 16), torch.float32, "cpu")
    with pytest.raises(ValueError, match=r"\['w'\]"):
        ckpt.restore(like=like)
    with pytest.raises(ValueError, match="keys differ"):
        ckpt.restore(like={"params": abstract_like(state["params"])})
    ckpt.close()


def test_mid_training_resume_is_bit_identical(tmp_path):
    """Train 4 steps, checkpoint at 2; resume from the checkpoint and
    re-run steps 3-4: the final params match the uninterrupted run
    exactly."""
    cfg = tlm.LMConfig(vocab=32, dim=16, heads=2, depth=1, lr=0.3)
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    ids = torch.arange(8).repeat(2, 2)
    labels = ids.roll(-1, -1)
    step = tlm.make_train_step(cfg, device="cpu")

    ckpt = TrainCheckpointer(str(tmp_path))
    for i in range(1, 5):
        params, _ = step(params, ids, labels)
        if i == 2:
            ckpt.save(i, params)
    want = params

    resumed = ckpt.restore(like=abstract_like(want))
    for _ in range(3, 5):
        resumed, _ = step(resumed, ids, labels)
    for a, b in zip(tlm.tree_leaves(resumed), tlm.tree_leaves(want)):
        assert torch.equal(a, b)
    assert sorted(os.listdir(tmp_path)) == ["step_2.pt"]
    ckpt.close()
