"""The port's ``bvar`` held against the JAX package's in one process.

Each case of ``tests/test_bvar.py`` becomes a scenario: a function of one
package's ``bvar`` that feeds seeded numpy sequences into its variables,
advances the sampler with ``tick_once_for_tests`` and returns what a
reader sees.  Both packages run the same scenario and must read the same
values: reducer values, windows, per-second rates, percentiles (under the
reservoir capacity, where no sample is dropped at random), composite
latency recorders, labeled families, the Prometheus text and the dump.
The scenarios also hold the plain meaning (a window's sum is the numpy
sum of its seconds).

Each test runs on empty registries with manual sampling in both packages
and leaves both as it found them.  The port's dump ticks on its own
thread (the JAX package uses its fiber timer thread); its test names that
divergence.
"""

import os
import threading
import time

import numpy as np
import pytest

import brpc_tpu.bvar as jb
import brpc_tpu_torch.bvar as tb
from brpc_tpu.butil import flags as jflags
from brpc_tpu.bvar import dump as jdump
from brpc_tpu.bvar import sampler as jsampler
from brpc_tpu.bvar import trend as jtrend
from brpc_tpu.bvar import variable as jvariable
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.bvar import dump as tdump
from brpc_tpu_torch.bvar import percentile as tpercentile
from brpc_tpu_torch.bvar import sampler as tsampler
from brpc_tpu_torch.bvar import trend as ttrend
from brpc_tpu_torch.bvar import variable as tvariable

PKGS = ((jvariable, jsampler), (tvariable, tsampler))


@pytest.fixture(autouse=True)
def _isolated():
    saved = []
    for var_mod, smp in PKGS:
        with var_mod._registry_lock:
            saved.append((dict(var_mod._registry),
                          smp._sampler_thread._manual))
            var_mod._registry.clear()
        smp._sampler_thread._manual = True
    yield
    for (reg, manual), (var_mod, smp) in zip(saved, PKGS):
        with var_mod._registry_lock:
            var_mod._registry.clear()
            var_mod._registry.update(reg)
        smp._sampler_thread._manual = manual


def _ints(seed, n, lo=-1000, hi=1000):
    return [int(v) for v in np.random.default_rng(seed).integers(lo, hi, n)]


def _floats(seed, n):
    return [float(v) for v in
            np.random.default_rng(seed).lognormal(6.0, 1.0, n).round(3)]


# -- scenarios: b is one package's bvar module -------------------------------

def adder(b):
    seq = _ints(1, 300)
    a = b.Adder()
    for v in seq:
        a << v
    assert a.get_value() == sum(seq)
    return a.get_value()


def maxer_miner(b):
    seq = _ints(2, 300)
    m, n = b.Maxer(), b.Miner()
    for v in seq:
        m << v
        n << v
    assert (m.get_value(), n.get_value()) == (max(seq), min(seq))
    return m.get_value(), n.get_value()


def int_recorder(b):
    seq = _ints(3, 300, 0, 10_000)
    r = b.IntRecorder()
    for v in seq:
        r << v
    assert r.sum == sum(seq) and r.num == len(seq)
    return r.average(), r.sum, r.num


def multithreaded_merge(b):
    seqs = [_ints(10 + k, 500) for k in range(8)]
    a = b.Adder()

    def w(seq):
        for v in seq:
            a << v

    ts = [threading.Thread(target=w, args=(s,)) for s in seqs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
        assert not t.is_alive()
    assert a.get_value() == sum(map(sum, seqs))
    return a.get_value()


def dead_thread_folds(b):
    a = b.Adder()
    t = threading.Thread(target=lambda: a.update(42))
    t.start()
    t.join(30)
    return a.get_value(), a.get_value()


def window_of_adder(b):
    seconds = [_ints(20 + k, 50) for k in range(6)]
    a = b.Adder()
    w = b.Window(a, window_size=3)
    out = []
    for i, sec in enumerate(seconds):
        for v in sec:
            a << v
        b.tick_once_for_tests()
        assert w.get_value() == sum(map(sum, seconds[max(0, i - 2):i + 1]))
        out.append(w.get_value())
    assert a.get_value() == sum(map(sum, seconds))   # never reset
    return out


def window_of_maxer(b):
    seconds = [_ints(30 + k, 40) for k in range(5)]
    m = b.Maxer()
    w1, w2 = b.Window(m, 2), b.Window(m, 2)   # one shared sampler
    out = []
    for i, sec in enumerate(seconds):
        for v in sec:
            m << v
        b.tick_once_for_tests()
        assert w1.get_value() == w2.get_value() \
            == max(max(s) for s in seconds[max(0, i - 1):i + 1])
        out.append(w1.get_value())
    return out, m.get_value()


def per_second(b):
    seconds = [_ints(40 + k, 30, 0, 100) for k in range(7)]
    a = b.Adder()
    q = b.PerSecond(a, window_size=5)
    out = []
    for sec in seconds:
        for v in sec:
            a << v
        b.tick_once_for_tests()
        out.append(q.get_value())
    return out


def percentile(b):
    seq = _floats(50, 200)            # one thread, under 254: all kept
    p = b.Percentile()
    for v in seq:
        p << v
    b.tick_once_for_tests()
    fr = (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)
    srt = sorted(seq)
    got = [p.get_number(f) for f in fr]
    assert got == [srt[min(len(srt) - 1, int(f * len(srt)))] for f in fr]
    return got


def latency_recorder(b):
    rounds = [_floats(60 + k, 40) for k in range(5)]
    lr = b.LatencyRecorder(window_size=5)
    for r in rounds:
        for v in r:
            lr << v
        b.tick_once_for_tests()
    flat = sum(rounds, [])
    assert lr.count() == len(flat)
    assert lr.max_latency() == max(flat)
    assert lr.latency() == pytest.approx(sum(flat) / len(flat))
    return (lr.count(), lr.latency(), lr.max_latency(), lr.qps(), lr.p50(),
            lr.p90(), lr.p99(), lr.p999(), lr.describe())


def latency_dead_thread(b):
    lr = b.LatencyRecorder(window_size=5)

    def worker():
        for _ in range(1000):
            lr << 5.0
        lr << 9999.0

    t = threading.Thread(target=worker)
    t.start()
    t.join(30)
    first = lr.count()            # the dead-agent fold, before any drain
    b.tick_once_for_tests()
    return first, lr.max_latency(), lr.latency_percentile(0.5), lr.count()


def multi_dimension(b):
    rng = np.random.default_rng(70)
    md = b.MultiDimension(["method", "code"], b.Adder, "tbvar_rpc_errors")
    for m, c, v in zip(rng.integers(0, 3, 200), rng.integers(0, 2, 200),
                       rng.integers(1, 10, 200)):
        md.get_stats([f"m{m}", ("0", "1008")[c]]).update(int(v))
    with pytest.raises(ValueError):
        md.get_stats(["only-one"])
    return md.count_stats(), sorted(md.get_value().items())


def passive_and_status(b):
    x = [1]
    p = b.PassiveStatus(lambda: x[0], "tbvar_passive_x")
    s = b.StatusVar("hello", "tbvar_status_s")
    first = p.get_value()
    x[0] = 5
    s.set_value("world")
    return first, p.get_value(), b.find_exposed("tbvar_status_s").get_value()


def registry(b):
    a, c = b.Adder(), b.Adder()
    out = [a.expose("tbvar my counter!"), c.expose("tbvar_my_counter_")]
    a << 3
    out += [b.find_exposed("tbvar_my_counter_") is a,
            b.dump_exposed()["tbvar_my_counter_"], a.hide(),
            b.find_exposed("tbvar_my_counter_") is None,
            b.sanitize_name("A.B-c d")]
    lr = b.LatencyRecorder(window_size=5)
    lr.expose("tbvar_echo_service")
    out.append(b.list_exposed())
    return out


def collector(b):
    sunk = []
    c = b.Collector(sink=sunk.extend, max_per_second=10)

    class S(b.Collected):
        pass

    ok = sum(1 for _ in range(50) if c.submit(S()))
    drained = c.drain()
    return ok, c.dropped, len(drained), len(sunk)


def exposition(b):
    """The same variables, exposed in the same order, render the same
    Prometheus text and the same dump."""
    a = b.Adder("tbvar_requests_total")
    for v in _ints(80, 100, 0, 50):
        a << v
    m = b.Maxer("tbvar_peak")
    for v in _ints(81, 100):
        m << v
    r = b.IntRecorder("tbvar_sizes")
    for v in _ints(82, 100, 0, 4096):
        r << v
    lr = b.LatencyRecorder("tbvar_rpc_server_echo_echo", window_size=5)
    for v in _floats(83, 120):
        lr << v
    md = b.MultiDimension(["method"], b.Adder, "tbvar_per_method")
    for k, v in zip(_ints(84, 60, 0, 3), _ints(85, 60, 1, 9)):
        md.get_stats([f"m{k}"]).update(v)
    b.PassiveStatus(lambda: 7, "tbvar_passive")
    b.StatusVar("text", "tbvar_text")
    b.tick_once_for_tests()
    text = b.render_prometheus()
    assert "tbvar_requests_total " in text
    assert 'tbvar_rpc_server_echo_echo_latency{quantile="0.99"}' in text
    return text, b.dump_exposed()


def trend(b, trend_mod):
    a = b.Adder("tbvar_trended")
    t = trend_mod.track("tbvar_trended")
    vals = []
    for v in _ints(90, 4, 0, 100):
        a << v
        b.tick_once_for_tests()
        vals.append(t.ring[-1][1])
    assert trend_mod.track("tbvar_absent") is None
    return vals


SCENARIOS = [adder, maxer_miner, int_recorder, multithreaded_merge,
             dead_thread_folds, window_of_adder, window_of_maxer, per_second,
             percentile, latency_recorder, latency_dead_thread,
             multi_dimension, passive_and_status, registry, collector,
             exposition]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_reads_what_jax_reads(scenario):
    want = scenario(jb)
    got = scenario(tb)
    assert got == want


def test_trend_samples_alike():
    assert trend(tb, ttrend) == trend(jb, jtrend)


def test_reservoir_capacity_matches():
    """The cases above stay under one thread's reservoir, the same in
    both packages; past it the kept samples are chosen at random."""
    from brpc_tpu.bvar import percentile as jpercentile
    assert tpercentile.SAMPLES_PER_THREAD == jpercentile.SAMPLES_PER_THREAD
    assert tpercentile.SAMPLES_PER_SECOND == jpercentile.SAMPLES_PER_SECOND
    assert max(len(_floats(60, 40)) * 5, 200) < \
        tpercentile.SAMPLES_PER_THREAD


def test_default_variables_survive_registry_reset():
    for b, (var_mod, _) in zip((jb, tb), PKGS):
        b.expose_default_variables()
        assert b.find_exposed("process_pid").get_value() == os.getpid()
        var_mod.clear_registry_for_tests()
        b.expose_default_variables()
        assert b.find_exposed("process_pid") is not None
    assert sorted(jb.list_exposed()) == sorted(tb.list_exposed())


@pytest.fixture()
def dump_flags():
    yield
    for fl in (jflags, tflags):
        fl.set_flag("bvar_dump", False)
        fl.set_flag("bvar_dump_prefix", "")
        fl.set_flag("bvar_dump_interval", 10)


def test_dump_once_writes_the_same_file(tmp_path, dump_flags):
    for b, fl, name in ((jb, jflags, "jax"), (tb, tflags, "port")):
        b.Adder("tbvar_svc_a_count") << 41
        b.Adder("tbvar_other_count") << 2
        fl.set_flag("bvar_dump_prefix", "tbvar_svc_a")
        path = str(tmp_path / name / "monitor" / "bvar.data")
        assert (jdump if b is jb else tdump).dump_once(path) == path
    jtext = open(tmp_path / "jax" / "monitor" / "bvar.data").read()
    ttext = open(tmp_path / "port" / "monitor" / "bvar.data").read()
    assert ttext == jtext == "tbvar_svc_a_count : 41\n"
    assert not [f for f in os.listdir(tmp_path / "port" / "monitor")
                if f.startswith("bvar.data.tmp")]


def test_dump_ticks_on_its_own_thread(tmp_path, dump_flags):
    """The port's periodic dump ticks as the JAX package's does: each
    tick is a task on the process's ``fiber.timer_thread`` (the thread
    of its own that every periodic task shares), which schedules the
    next; no ``bvar-dump`` thread is started.  The flags and the file
    are the JAX package's."""
    from brpc_tpu_torch.fiber.timer_thread import global_timer_thread
    timer = global_timer_thread()
    path = str(tmp_path / "bvar.data")
    tb.Adder("tbvar_ticked") << 5
    tflags.set_flag("bvar_dump_file", path)
    tflags.set_flag("bvar_dump_interval", 1)
    tflags.set_flag("bvar_dump_prefix", "tbvar_ticked")
    before = timer.scheduled_count
    tdump.ensure_dumper()           # off: starts nothing
    assert timer.scheduled_count == before
    tflags.set_flag("bvar_dump", True)
    try:
        tdump.ensure_dumper()
        tdump.ensure_dumper()       # idempotent
        started = timer.scheduled_count
        assert started - before in (0, 1)   # one tick, or none when an
        #                                     earlier test started it
        deadline = time.monotonic() + 10
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert open(path).read() == "tbvar_ticked : 5\n"
        # the tick re-armed itself on the timer
        deadline = time.monotonic() + 10
        while timer.scheduled_count <= started \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert timer.scheduled_count > started
    finally:
        tflags.set_flag("bvar_dump", False)
        tflags.set_flag("bvar_dump_file", "monitor/bvar.data")
    assert not [t for t in threading.enumerate() if t.name == "bvar-dump"]
