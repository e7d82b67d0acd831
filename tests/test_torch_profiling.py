"""The port's profilers (``brpc_tpu_torch/profiling.py``) on the CPU: the
sampler, the renderers, the contention, growth and heap windows, driven
as ``tests/test_hotspots.py`` drives the JAX package's (a deterministic
busy loop on a thread), each held beside the JAX package's output on the
same kind of run; and the device trace, which on the CPU holds the CPU
activity of ``torch.profiler`` as a Chrome trace in a tarball."""

import io
import json
import tarfile
import threading
import time

import pytest
import torch

from brpc_tpu import profiling as jprof
from brpc_tpu_torch import profiling as prof


def _busy(stop):
    while not stop[0]:
        sum(range(500))


@pytest.mark.parametrize("mod", [prof, jprof], ids=["port", "jax"])
def test_sampler_direct(mod):
    stop = [False]
    t = threading.Thread(target=_busy, args=(stop,), daemon=True)
    t.start()
    try:
        got = mod.sample_cpu(seconds=0.4, hz=200)
    finally:
        stop[0] = True
        t.join(timeout=10)
    assert not t.is_alive()
    assert got.samples > 10
    flat = mod.render_flat(got.folded)
    assert "_busy" in flat
    folded = mod.render_folded(got.folded)
    assert any(line.endswith(tuple("0123456789")) and "_busy" in line
               for line in folded.splitlines())
    html = mod.render_flame_html(got.folded, title="t")
    assert html.startswith("<!doctype html>") and "_busy" in html


def test_renderers_match_jax():
    folded = {("a.py:main", "b.py:f"): 3, ("a.py:main", "c.py:g"): 1}
    assert prof.render_flat(folded) == jprof.render_flat(folded)
    assert prof.render_folded(folded) == jprof.render_folded(folded)
    assert prof.render_flame_html(folded) == jprof.render_flame_html(folded)


def test_contention_window_records_waits():
    ev = threading.Event()

    def waiter():
        while not ev.is_set():
            prof.timed_wait("lock", lambda: ev.wait(0.02))

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    try:
        report = prof.collect_contention(seconds=0.3)
    finally:
        ev.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert "contention over 0.3s window" in report
    assert "waiter" in report
    assert not prof.contention_active()


def test_growth_and_heap_windows():
    keep = []

    def grow():
        for _ in range(50):
            keep.append(bytearray(10_000))
            time.sleep(0.002)

    t = threading.Thread(target=grow, daemon=True)
    t.start()
    report = prof.collect_growth(seconds=0.3)
    t.join(timeout=10)
    assert "heap growth over 0.3s window" in report
    assert "test_torch_profiling.py" in report
    assert "tracemalloc is not tracing" in prof.collect_heap()


def test_device_trace_tarball():
    stop = [False]

    def work():
        x = torch.ones(64, 64)
        while not stop[0]:
            x = (x @ x).clamp(max=1.0)

    t = threading.Thread(target=work, daemon=True)
    t.start()
    try:
        data, name = prof.collect_device_trace(seconds=0.2)
    finally:
        stop[0] = True
        t.join(timeout=10)
    assert name.startswith("device_trace_") and name.endswith(".tar.gz")
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        members = [m for m in tar.getmembers() if m.isfile()]
        assert [m.name for m in members] == ["device_trace/trace.json"]
        trace = json.load(tar.extractfile(members[0]))
    assert "traceEvents" in trace
