"""The port's RPC examples against brpc_tpu's, on the CPU.

Each port example runs as ``python -m brpc_tpu_torch.examples.<name>
--device cpu`` and its brpc_tpu twin as ``python examples/<name>.py``
(under the tests' ``JAX_PLATFORMS=cpu``), side by side, each in a
subprocess of its own with a timeout (``ici_tensor_echo`` runs alone:
see its case).  The lines that carry results are compared after
addresses and times are taken out: they must be equal (there is no
tolerance; no number here is a float of a model).  Timings (latencies,
qps, GB/s) are printed by both and compared by neither.

Also: every script of ``examples/`` has its twin under
``brpc_tpu_torch/examples/``, and each twin's ``main`` raises on the
default device (cuda) where CUDA is absent.
"""

import ast
import importlib
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(ROOT, "examples")
PORT_DIR = os.path.join(ROOT, "brpc_tpu_torch", "examples")
TIMEOUT_S = 120

_ADDR = re.compile(r"\d+\.\d+\.\d+\.\d+:\d+")


def _run_both(name: str) -> tuple:
    """Both examples' stdout, run at the same time."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for cmd in ([sys.executable, "-m",
                          f"brpc_tpu_torch.examples.{name}", "--device",
                          "cpu"],
                         [sys.executable, os.path.join(JAX_DIR,
                                                       f"{name}.py")])]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, (proc.args, err[-4000:])
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return tuple(outs)


def _lines(out: str, *prefixes) -> list:
    return [line.strip() for line in out.splitlines()
            if line.strip().startswith(prefixes)]


def _echo(out):
    return [re.sub(r" \(\d+us\)$", "", line) for line in
            _lines(out, "sync:", "attachment back:", "async:", "batch:")]


def _raw_echo(out):
    return _lines(out, "raw echo ok", "done")


def _parallel_echo(out):
    return _lines(out, "merged response:")


def _streaming_echo(out):
    return _lines(out, "server said:", "server received")


def _grpc_interop(out):
    return _lines(out, "grpcio unary:", "grpcio bidi:", "our h2 client:",
                  "our streaming client:")


def _press_and_portal(out):
    """The portal's three page headings and the press's summary keys,
    with zero errors and calls sent."""
    heads = _lines(out, "== /")
    summary = ast.literal_eval(_lines(out, "press summary:")[0].split(
        ":", 1)[1].strip())
    assert summary["sent"] > 0 and summary["errors"] == 0, summary
    return heads + [sorted(summary), summary["errors"]]


def _fleet_serving(out):
    """Addresses become rank numbers (from the ``ranks:`` line); the
    flipped membership, the traffic line, the persisted span and the
    final OK."""
    ranks = ast.literal_eval(_lines(out, "ranks:")[0].split(":", 1)[1])
    flipped = ast.literal_eval(_lines(out, "membership flipped")[0].split(
        "->", 1)[1].strip())
    spans = re.findall(r"traced span persisted = (\[.*\])", out)
    return ([sorted(ranks.index(a) for a in flipped)]
            + _lines(out, "traffic flowing:", "fleet demo OK")
            + [ast.literal_eval(s) for s in spans])


def _multi_protocol_port(out):
    return _lines(out, "tpu_std  ->", "http     ->", "grpc     ->",
                  "redis    ->")


_RESULTS = {
    "echo": (_echo, 4),
    "raw_echo": (_raw_echo, 2),
    "parallel_echo": (_parallel_echo, 1),
    "streaming_echo": (_streaming_echo, 2),
    "grpc_interop": (_grpc_interop, 4),
    "press_and_portal": (_press_and_portal, 5),
    "fleet_serving": (_fleet_serving, 4),
    "multi_protocol_port": (_multi_protocol_port, 4),
}


@pytest.mark.parametrize("name", sorted(_RESULTS))
def test_example_results_equal_jax(name):
    extract, n = _RESULTS[name]
    port_out, jax_out = _run_both(name)
    got, want = extract(_ADDR.sub("ADDR", port_out)), \
        extract(_ADDR.sub("ADDR", jax_out))
    assert len(want) == n, jax_out
    assert got == want, (port_out, jax_out)


def test_ici_tensor_echo_is_zero_copy():
    """The device echo alone: brpc_tpu's twin asserts ``out is x`` too,
    but under a loaded host its descriptor lane sometimes lands a fresh
    array and the assert fails (1 of 12 concurrent runs), so it is not run
    beside the port's here.  The port's example exits 0 only if every
    echo handed back the posted tensor (``out is x``) with equal
    checksums on both ends, and prints brpc_tpu's lines."""
    proc = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.examples.ici_tensor_echo",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert _lines(proc.stdout, "backend=") == [
        "backend=cpu tensor=1048576 bytes"]
    assert re.search(r"^100 echoes of 1048576 bytes: [\d.]+ GB/s "
                     r"device-resident$", proc.stdout, re.M), proc.stdout


def test_grpcio_parts_print_skipped_without_grpcio():
    """Without grpcio the grpcio halves print ``skipped: grpcio absent``
    (never a result) and the port's own h2 client still answers."""
    code = (
        "import sys; sys.modules['grpc'] = None\n"
        "from brpc_tpu_torch.examples import grpc_interop, "
        "multi_protocol_port\n"
        "grpc_interop.main(['--device', 'cpu'])\n"
        "multi_protocol_port.main(['--device', 'cpu'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    assert _lines(out, "grpcio unary:", "grpcio bidi:", "grpc     ->") == [
        "grpcio unary: skipped: grpcio absent",
        "grpcio bidi: skipped: grpcio absent",
        "grpc     -> skipped: grpcio absent"]
    assert _lines(out, "our h2 client:", "our streaming client:") == [
        "our h2 client: 0 b'full-circle'",
        "our streaming client: b'STREAM ME'"]
    assert "redis    -> b'hello from RESP'" in out


def test_every_example_has_a_twin():
    jax_names = sorted(f for f in os.listdir(JAX_DIR) if f.endswith(".py"))
    port_names = sorted(f for f in os.listdir(PORT_DIR)
                        if f.endswith(".py") and f != "__init__.py")
    assert len(jax_names) == 13
    assert port_names == jax_names


_EXAMPLES = sorted(f[:-3] for f in os.listdir(JAX_DIR) if f.endswith(".py"))


@pytest.mark.parametrize("name", _EXAMPLES)
def test_main_raises_on_cuda_without_cuda(name):
    """The default device is cuda and nothing falls back: without CUDA
    ``main()`` and ``main(["--device", "cuda"])`` raise before any
    work."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device runs")
    mod = importlib.import_module(f"brpc_tpu_torch.examples.{name}")
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(argv)
