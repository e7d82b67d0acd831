"""The port's native engine under the sanitizers: the case of
``tests/test_sanitized_native.py`` against ``brpc_tpu_torch``.

The port's loader builds the identical translation unit under
``-fsanitize=address,undefined -fno-omit-frame-pointer`` (``make asan``)
into ``native/_build/`` and loads it when ``BRPC_TPU_TORCH_NATIVE_ASAN=1``
is set; a subprocess with libasan LD_PRELOADed runs
``tests/torch_asan_driver.py`` (burst dispatch, the HTTP slim lane,
client demux, scatter, the shm slot lifecycle, the multi-core engine and
a drain under load).  The test fails on ANY sanitizer report.

slow-marked, as the JAX file: the instrumented build + run costs ~1-2
minutes, so it rides the stress tier (``-m slow``), not tier-1.
"""

import os
import subprocess
import sys

import pytest

_DIR = os.path.dirname(os.path.abspath(__file__))

pytestmark = pytest.mark.slow


def _lib(name: str) -> str:
    out = subprocess.run(["g++", f"-print-file-name={name}"],
                         capture_output=True, text=True, timeout=30)
    path = out.stdout.strip()
    return path if os.path.isabs(path) else ""


def test_asan_build_and_stress():
    from brpc_tpu_torch import native

    asan = _lib("libasan.so")
    if not asan:
        pytest.skip("no libasan in this toolchain")
    # the sanitizer build, into native/_build/ under its own hashed name
    so = native.build(asan=True)
    assert os.path.isfile(so), so

    env = dict(os.environ)
    env[native.ASAN_ENV] = "1"
    # libasan must initialize before CPython; leak detection off (the
    # interpreter's arena behavior floods it with false positives) —
    # use-after-free / overflow / UB detection is the point here
    preload = asan
    ubsan = _lib("libubsan.so")
    if ubsan:
        preload += ":" + ubsan
    env["LD_PRELOAD"] = preload
    env["ASAN_OPTIONS"] = ("detect_leaks=0:abort_on_error=1:"
                           "disable_coredump=1")
    env["UBSAN_OPTIONS"] = "print_stacktrace=1:halt_on_error=1"
    env["PYTHONPATH"] = os.path.abspath(os.path.join(_DIR, "..")) \
        + os.pathsep + env.get("PYTHONPATH", "")

    r = subprocess.run(
        [sys.executable, os.path.join(_DIR, "torch_asan_driver.py")],
        capture_output=True, text=True, timeout=420, env=env)
    out = r.stdout + r.stderr
    assert "AddressSanitizer" not in out, out[-8000:]
    assert "runtime error:" not in out, out[-8000:]
    assert r.returncode == 0, out[-8000:]
    assert "ASAN_DRIVER_OK" in r.stdout, out[-8000:]
