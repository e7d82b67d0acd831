"""The port's concurrency limiters held against the JAX package's, on the
CPU (after ``tests/test_cluster_hardening.py:22-48``): each limiter fed
the same latency and error sequence in both packages gives the same
``max_concurrency()`` after every sample, and ``make_limiter`` parses the
same specs into the same kinds.  ``AutoLimiter``'s sampling windows run
on a clock the test moves by hand in both modules."""

import numpy as np
import pytest

from brpc_tpu.policy import concurrency_limiter as jcl
from brpc_tpu_torch.policy import concurrency_limiter as tcl

MODS = (jcl, tcl)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    c = _Clock()
    for mod in MODS:
        monkeypatch.setattr(mod, "time", c)
    return c


def _samples(seed, n, lat_us, err_rate=0.0):
    """``n`` (error code, latency µs) pairs: lognormal latencies around
    ``lat_us``, a share ``err_rate`` of them ERPCTIMEDOUT."""
    rng = np.random.default_rng(seed)
    lat = rng.lognormal(np.log(lat_us), 0.3, n)
    err = rng.random(n) < err_rate
    return [(1008 if e else 0, float(v)) for e, v in zip(err, lat)]


def _trace(lim, samples, clock=None, dt=0.0):
    out = []
    for code, lat in samples:
        if clock is not None:
            clock.t += dt
        lim.on_responded(code, lat)
        out.append(lim.max_concurrency())
    return out


@pytest.mark.parametrize("kw, phases", [
    (dict(timeout_ms=100, min_limit=2, max_limit=1000),
     [(10_000, 0.0, 50), (50_000, 0.0, 80)]),
    (dict(timeout_ms=100, min_limit=1), [(1_000, 1.0, 60)]),
    (dict(timeout_ms=250, alpha=0.5), [(3_000, 0.2, 100), (900, 0.0, 100)]),
], ids=["tracks-budget", "failures-at-timeout", "mixed"])
def test_timeout_limiter_sequences_match(kw, phases):
    lims = [mod.TimeoutLimiter(**kw) for mod in MODS]
    seq = []
    for i, (lat, err, n) in enumerate(phases):
        seq += _samples(i, n, lat, err)
    mine, theirs = _trace(lims[1], seq), _trace(lims[0], seq)
    assert mine == theirs
    assert lims[1].kind == lims[0].kind == "timeout"


def test_timeout_limiter_bounds_like_the_reference():
    """``test_cluster_hardening``'s two cases, on the port."""
    lim = tcl.TimeoutLimiter(timeout_ms=100, min_limit=2, max_limit=1000)
    for _ in range(50):
        lim.on_responded(0, 10_000)
    assert 8 <= lim.max_concurrency() <= 12
    for _ in range(80):
        lim.on_responded(0, 50_000)
    assert lim.max_concurrency() <= 3
    lim = tcl.TimeoutLimiter(timeout_ms=100, min_limit=1)
    for _ in range(60):
        lim.on_responded(1008, 0)
    assert lim.max_concurrency() <= 2


@pytest.mark.parametrize("phases", [
    # a quiet baseline, then latency inflating under load: the limit
    # grows, then shrinks
    [(2_000, 0.0, 400, 0.0005), (9_000, 0.0, 400, 0.0005)],
    # errors in the windows and a faster phase after
    [(5_000, 0.3, 300, 0.001), (1_000, 0.0, 500, 0.0002)],
], ids=["inflate", "errors-then-fast"])
def test_auto_limiter_sequences_match(clock, phases):
    lims = []
    for mod in MODS:
        lims.append(mod.AutoLimiter(min_limit=4, max_limit=512,
                                    sample_window_s=0.05,
                                    min_sample_count=20))
    outs = []
    for lim in lims:
        clock.t = 1000.0
        lim._win_start = clock.t
        seq_out = []
        for i, (lat, err, n, dt) in enumerate(phases):
            seq_out += _trace(lim, _samples(10 + i, n, lat, err), clock, dt)
        outs.append(seq_out)
    assert outs[1] == outs[0]
    assert len(set(outs[1])) > 2           # the limit moved
    assert lims[1].kind == "auto"


def test_constant_limiter_and_make_limiter_specs():
    for spec in (None, 0, "", "unlimited", "0"):
        assert tcl.make_limiter(spec) is None
        assert jcl.make_limiter(spec) is None
    for spec, kind, limit in ((7, "constant", 7), ("constant:3", "constant",
                                                   3),
                              ("12", "constant", 12), ("auto", "auto", 32),
                              ("timeout", "timeout", 4096),
                              ("timeout:250", "timeout", 4096)):
        mine, theirs = tcl.make_limiter(spec), jcl.make_limiter(spec)
        assert (mine.kind, mine.max_concurrency()) \
            == (theirs.kind, theirs.max_concurrency()) == (kind, limit)
    assert tcl.make_limiter("timeout:250")._timeout_us == 250_000
    for bad in ("fast", "constant:x"):
        with pytest.raises(ValueError):
            tcl.make_limiter(bad)
        with pytest.raises(ValueError):
            jcl.make_limiter(bad)
