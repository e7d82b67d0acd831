"""The port's dry runs across processes
(``brpc_tpu_torch/parallel/multiproc_dryrun.py``) on the CPU: two worker
processes in one gloo group take a dp x tp EmbeddingPS step, meet at a
psum barrier and echo a tensor (inline on the CPU) checksummed on both
ends; and ``dryrun_multichip`` runs ``__graft_entry__.dryrun_multichip``'s
sequence at worlds 2 and 4, each stage held to its own oracle there."""

import pytest

from brpc_tpu_torch.parallel import multiproc_dryrun


def test_two_processes_step_barrier_and_echo():
    lines = multiproc_dryrun.run(world=2, processes=2, timeout_s=240,
                                 echo_device="cpu")
    for pid in (0, 1):
        assert f"[p{pid}] cross-process SPMD train step ok" in "\n".join(
            lines)
        assert any(line.startswith(f"[p{pid}] 2-proc step ok")
                   for line in lines)
    assert any("[p1] cross-process device echo ok" in line
               and "on cpu, the last kind 0" in line for line in lines)
    # both processes took the same step: the whole batch's loss
    losses = {line.split("loss=")[1].split()[0] for line in lines
              if "train step ok" in line}
    assert len(losses) == 1, losses


def test_run_checks_its_arguments():
    with pytest.raises(ValueError, match="one rank per process"):
        multiproc_dryrun.run(world=4, processes=2, echo_device="cpu")
    with pytest.raises(ValueError, match="2 or more"):
        multiproc_dryrun.run(world=1, processes=1, echo_device="cpu")


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_multichip(world):
    lines = multiproc_dryrun.dryrun_multichip(world, "cpu", timeout_s=120)
    want = ["dryrun_multichip ok", "mesh transport collectives ok",
            "(accum=1)", "(accum=2)", "ring attention (sp) ok",
            "pipeline (pp) ok", "pipeline train step ok"]
    if world >= 4:
        want.append("dp x pp pipeline train step ok")
    for i, w in enumerate(want):
        assert w in lines[i], (w, lines)
    assert len(lines) == len(want)
