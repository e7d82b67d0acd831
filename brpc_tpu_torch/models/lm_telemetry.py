"""Serving-plane observability of the continuous batcher: the port's copy of
``brpc_tpu/models/lm_telemetry.py``.

Three planes, all fed by the one batcher thread and read passively:

- **Step profiler:** per-phase monotonic-ns log2 histograms (40 buckets,
  bucket 0 for zeros, bucket i for [2^(i-1), 2^i) ns), sample counts and
  totals around the batcher's step loop (``LM_STEP_PHASES``, indexed by
  the ``PH_*`` constants).  Written by the batcher thread only, with no
  lock and no allocation: plain list increments, read racily but
  monotonically.
- **Session timelines:** one :class:`SessionTimeline` per decode session
  (tier, tenant, prompt length, TTFT, the inter-token gaps' histogram and
  largest gap, close reason; its source, ``fresh`` or ``imported`` from a
  prefill tier, which a paged admit of a fresh session refines to its
  prefix outcome; peak pages, spills, resumes and preemptions), opened at
  join, fed per step by :func:`on_emit` (which also annotates
  ``lm_first_token`` on the session's rpcz span), judged at close against
  the tier's targets into the closed ``LM_SLO_VERDICTS`` counters, and
  kept in a bounded ring.  The first tokens and the gaps also feed per-tier
  TTFT and ITL histograms, read as p50/p95/p99 rows.
- **Snapshot cache:** :class:`LmTelemetryCache` builds one snapshot per
  interval and keeps the previous one, so the windowed ratios
  (``windowed_spec_accept_rate``, ``windowed_prefix_hit_ratio``,
  ``windowed_slo_deltas``) describe the last interval and the lifetime
  ones stay beside them.

The ``lm_telemetry`` flag switches the planes off live (the step loop
reads a cached copy, resynced by a flag watcher).  The families of
``_LM_VARS`` are exposed as bvar variables (``render_prometheus()``,
``dump_exposed()``).

Divergence: an unregistered phase, tier or verdict raises ``ValueError``
where the JAX package asserts.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from time import monotonic as _mono_s
from time import monotonic_ns as _mono_ns
from typing import Optional

from ..butil.flags import define_flag, get_flag, watch_flag
from ..bvar.multi_dimension import PassiveDimension

define_flag("lm_telemetry", True,
            "serving-plane observability master switch: step-phase "
            "histograms, per-session token timelines, SLO attainment "
            "(flippable live; the step loop reads a flag-cache, not "
            "the flags table)",
            validator=lambda v: isinstance(v, bool))
define_flag("lm_timeline_ring", 256,
            "bounded ring of closed per-session token timelines kept "
            "for the /lm portal's recent-sessions table",
            validator=lambda v: isinstance(v, int) and 0 < v <= 65536)

# ---------------------------------------------------------------------------
# Step profiler: per-phase log2 ns histograms (batcher-thread writes)
# ---------------------------------------------------------------------------

# CLOSED enum (every member is pinned in the tests): the step loop's
# named phases.  Indexes are the write-side API — the
# batcher binds the PH_* constants as locals, so the hot path is two
# list increments and an int add per phase sample.
LM_STEP_PHASES = (
    "decode_round",      # one decode round (plain step or spec round)
    "chunk_slice",       # one bounded prefill slice (fresh prompt)
    "catchup_slice",     # slice replaying past a partial prefix hit
    "spec_draft",        # the k draft-model steps of a spec round
    "spec_verify",       # the width-(k+1) target verification
    "prefix_lookup",     # prefix-cache probe at admit
    "page_alloc",        # page allocation incl. the reclaim walk
    "host_spill",        # one session's D2H park
    "host_resume",       # one session's H2D un-park
    "stream_emit",       # one step's token writes across all sessions
)

PH_DECODE_ROUND = 0
PH_CHUNK_SLICE = 1
PH_CATCHUP_SLICE = 2
PH_SPEC_DRAFT = 3
PH_SPEC_VERIFY = 4
PH_PREFIX_LOOKUP = 5
PH_PAGE_ALLOC = 6
PH_HOST_SPILL = 7
PH_HOST_RESUME = 8
PH_STREAM_EMIT = 9

_NPHASES = len(LM_STEP_PHASES)

# engine Hist layout: bucket 0 holds zeros, bucket i covers
# [2^(i-1), 2^i) ns; 40 buckets reach ~9 minutes — beyond any phase
NBUCKETS = 40

_phase_buckets = [[0] * NBUCKETS for _ in LM_STEP_PHASES]
_phase_count = [0] * _NPHASES
_phase_total_ns = [0] * _NPHASES

# flag-cached enable gate (the rpcz _rpcz_live idiom): one list read on
# the hot path instead of a flags-table lookup per phase sample
_live = [bool(get_flag("lm_telemetry", True))]
watch_flag("lm_telemetry", lambda v: _live.__setitem__(0, bool(v)))


def telemetry_enabled() -> bool:
    return _live[0]


def phase_index(name: str) -> int:
    if name not in LM_STEP_PHASES:
        raise ValueError(f"unregistered step phase: {name}")
    return LM_STEP_PHASES.index(name)


def record_phase(idx: int, ns: int) -> None:
    """One phase sample (batcher thread only).  Lock-free and
    allocation-free by construction: preallocated per-phase lists, an
    int bit_length for the log2 bucket — the whole per-sample cost the
    observer-effect bench measures."""
    if not _live[0]:
        return
    b = ns.bit_length() if ns > 0 else 0
    if b >= NBUCKETS:
        b = NBUCKETS - 1
    _phase_buckets[idx][b] += 1
    _phase_count[idx] += 1
    _phase_total_ns[idx] += ns if ns > 0 else 0


def bucket_label(i: int, nbuckets: int = NBUCKETS) -> str:
    """Exclusive upper-bound label for log2 bucket i (the engine Hist
    convention — deliberately ``bin``, not Prometheus's cumulative
    ``le``; see transport.native_bridge.bucket_label)."""
    return "+Inf" if i >= nbuckets - 1 else str(1 << i)


def phase_counters() -> dict:
    return {p: _phase_count[i] for i, p in enumerate(LM_STEP_PHASES)}


def phase_total_ns() -> dict:
    return {p: _phase_total_ns[i]
            for i, p in enumerate(LM_STEP_PHASES)}


def phase_histogram(name: str) -> list:
    return list(_phase_buckets[phase_index(name)])


# ---------------------------------------------------------------------------
# SLO attainment: closed verdicts judged at session close
# ---------------------------------------------------------------------------

# CLOSED enum: one verdict per finished session, judged against the
# session's tier targets (TierRegistry.slo_of).  No "unknown" bucket —
# an unregistered verdict raises at the first count.
LM_SLO_VERDICTS = (
    "slo_ok",            # every configured target met
    "slo_ttft_miss",     # first token later than the tier's TTFT target
    "slo_itl_miss",      # an inter-token gap beyond the tier's ITL target
    "slo_untargeted",    # the session's tier configures no targets
)

_slo: dict = {}          # (tier, verdict) -> count, preseeded lazily


def _slo_table() -> dict:
    if not _slo:
        from .lm_service import SLO_TIERS
        for t in SLO_TIERS:
            for v in LM_SLO_VERDICTS:
                _slo[(t, v)] = 0
    return _slo


def count_slo(tier: str, verdict: str) -> None:
    tab = _slo_table()
    if (tier, verdict) not in tab:
        raise ValueError(f"unregistered SLO verdict: {tier}/{verdict}")
    tab[(tier, verdict)] += 1


def slo_counters() -> dict:
    return dict(_slo_table())


# ---------------------------------------------------------------------------
# Session timelines: bounded ring + per-tier latency histograms
# ---------------------------------------------------------------------------

_tl_seq = itertools.count(1)


class SessionTimeline:
    """One decode session's observable life, written by the batcher
    thread (plus the join-side open stamp), finalized into the ring at
    close.  Slotted: the per-token path touches preallocated fields
    only."""

    __slots__ = ("seq", "tier", "tenant", "prompt_len", "max_new",
                 "join_ns", "first_ns", "last_ns", "tokens",
                 "itl_buckets", "itl_max_ns", "prefix", "pages_peak",
                 "spills", "resumes", "preempts", "close_reason",
                 "verdict")

    def __init__(self, tier: str, tenant: str, prompt_len: int,
                 max_new: int, source: str):
        self.seq = next(_tl_seq)
        self.tier = tier
        self.tenant = tenant
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.join_ns = _mono_ns()
        self.first_ns = 0
        self.last_ns = 0
        self.tokens = 0
        self.itl_buckets = [0] * NBUCKETS
        self.itl_max_ns = 0
        self.prefix = source          # fresh|imported, refined at admit
        self.pages_peak = 0
        self.spills = 0
        self.resumes = 0
        self.preempts = 0
        self.close_reason = None
        self.verdict = None

    def ttft_ms(self) -> Optional[float]:
        if not self.first_ns:
            return None
        return (self.first_ns - self.join_ns) / 1e6

    def describe(self) -> dict:
        return {"seq": self.seq, "tier": self.tier,
                "tenant": self.tenant, "prompt_len": self.prompt_len,
                "max_new": self.max_new, "tokens": self.tokens,
                "ttft_ms": self.ttft_ms(),
                "itl_max_ms": self.itl_max_ns / 1e6,
                "prefix": self.prefix, "pages_peak": self.pages_peak,
                "spills": self.spills, "resumes": self.resumes,
                "preempts": self.preempts,
                "close_reason": self.close_reason,
                "verdict": self.verdict}


# live registry (open → close) + the bounded finished-session ring.
# deque(maxlen) eviction is lock-free; the live dict is mutated by the
# join thread (open) and the batcher thread (close) — both single
# bytecode dict ops, GIL-atomic like the admission counters.
_live_sessions: dict = {}
_ring_max = int(get_flag("lm_timeline_ring", 256))
_ring: deque = deque(maxlen=_ring_max)

# per-tier latency histograms (batcher-thread writes): TTFT observed at
# the first emitted token, ITL per subsequent token
_tier_ttft: dict = {}
_tier_itl: dict = {}


def open_timeline(tier: str, tenant, prompt_len: int, max_new: int,
                  source: str) -> Optional[SessionTimeline]:
    """Called at join (not in the step loop): allocates the session's
    record and preseeds its tier's histograms.  Its ``prefix`` field
    starts at ``source``, ``fresh`` (a prompt) or ``imported`` (a cache
    from a prefill tier); a paged admit refines a fresh one to
    ``prefix_hit``, ``prefix_partial`` or ``prefix_miss``."""
    if not _live[0]:
        return None
    from .lm_service import SLO_TIERS
    if tier not in SLO_TIERS:
        raise ValueError(f"unregistered SLO tier: {tier}")
    if tier not in _tier_ttft:
        _tier_ttft[tier] = [0] * NBUCKETS
        _tier_itl[tier] = [0] * NBUCKETS
    if isinstance(tenant, (bytes, bytearray, memoryview)):
        tenant = bytes(tenant).decode("utf-8", "replace")
    tl = SessionTimeline(tier, str(tenant or "-"), int(prompt_len),
                         int(max_new), source)
    _live_sessions[tl.seq] = tl
    return tl


def on_emit(pairs) -> None:
    """Per-step token timing (batcher thread only): ONE monotonic read
    for the whole step, then plain list increments per token — the
    first token closes the session's TTFT, later ones feed its ITL
    histogram and the tier aggregate.  Lock-free, allocation-free."""
    if not _live[0] or not pairs:
        return
    now = _mono_ns()
    for sess, _tok in pairs:
        tl = sess.tl
        if tl is None:
            continue
        if tl.tokens == 0:
            tl.first_ns = now
            d = now - tl.join_ns
            b = d.bit_length() if d > 0 else 0
            if b >= NBUCKETS:
                b = NBUCKETS - 1
            _tier_ttft[tl.tier][b] += 1
            if sess.span is not None:
                sess.span.annotate("lm_first_token")
        else:
            d = now - tl.last_ns
            if d > tl.itl_max_ns:
                tl.itl_max_ns = d
            b = d.bit_length() if d > 0 else 0
            if b >= NBUCKETS:
                b = NBUCKETS - 1
            tl.itl_buckets[b] += 1
            _tier_itl[tl.tier][b] += 1
        tl.last_ns = now
        tl.tokens += 1


def close_timeline(tl: Optional[SessionTimeline], reason: str,
                   ttft_target_ms=None, itl_target_ms=None) -> None:
    """Finalize a session record (batcher thread): judge the SLO
    verdict against the tier's targets, count it, move the record from
    the live table into the bounded ring."""
    if tl is None:
        return
    _live_sessions.pop(tl.seq, None)
    tl.close_reason = reason or "finished"
    if ttft_target_ms is None and itl_target_ms is None:
        v = "slo_untargeted"
    else:
        ttft = tl.ttft_ms()
        if ttft_target_ms is not None \
                and (ttft is None or ttft > ttft_target_ms):
            v = "slo_ttft_miss"
        elif itl_target_ms is not None \
                and tl.itl_max_ns / 1e6 > itl_target_ms:
            v = "slo_itl_miss"
        else:
            v = "slo_ok"
    tl.verdict = v
    count_slo(tl.tier, v)
    _ring.append(tl)


def live_sessions() -> list:
    """Snapshot of in-flight sessions (the /lm live table)."""
    return [tl.describe() for tl in list(_live_sessions.values())]


def timeline_records(limit: int = 0) -> list:
    recs = list(_ring)
    if limit:
        recs = recs[-limit:]
    return [tl.describe() for tl in recs]


def ring_len() -> int:
    return len(_ring)


def ring_maxlen() -> int:
    return _ring.maxlen or 0


# ---------------------------------------------------------------------------
# Percentiles from the log2 histograms
# ---------------------------------------------------------------------------

_QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


def _hist_quantile_ms(buckets, q: float) -> float:
    """Approximate quantile from a log2 ns histogram: the upper bound
    of the bucket where the cumulative count crosses q (conservative —
    never under-reports a latency)."""
    n = 0
    for c in buckets:
        n += c
    if n == 0:
        return 0.0
    target = q * n
    acc = 0.0
    for i, c in enumerate(buckets):
        acc += c
        if acc >= target:
            return 0.0 if i == 0 else (1 << i) / 1e6
    return (1 << (len(buckets) - 1)) / 1e6


def _ttft_rows() -> dict:
    out = {}
    for tier, h in _tier_ttft.items():
        for name, q in _QUANTILES:
            out[(tier, name)] = round(_hist_quantile_ms(h, q), 3)
    return out


def _itl_rows() -> dict:
    out = {}
    for tier, h in _tier_itl.items():
        for name, q in _QUANTILES:
            out[(tier, name)] = round(_hist_quantile_ms(h, q), 3)
    return out


# ---------------------------------------------------------------------------
# Snapshot cache (the _TelemetryCache pattern): one build per interval
# ---------------------------------------------------------------------------

class LmTelemetryCache:
    """Short-TTL cache over the full serving-plane snapshot.  ``get()``
    refreshes at most once per TTL; ``window()`` returns
    ``(prev, cur, dt)`` under ONE lock hold so windowed ratios never
    pair a snapshot with the wrong interval.  ``builds`` counts actual
    snapshot constructions — the one-snapshot-per-interval test pin."""

    def __init__(self, ttl_s: float = 0.25):
        self._ttl = ttl_s
        self._lock = threading.Lock()
        self._snap = None
        self._t = 0.0
        self._prev = None
        self._prev_t = 0.0
        self.builds = 0

    def _build(self) -> dict:
        self.builds += 1
        from .lm_service import sched_counters, spec_counters
        try:
            from ..kv.pages import prefix_event_counters
            prefix = prefix_event_counters()
        except Exception:
            prefix = {}
        return {
            "phases": phase_counters(),
            "phase_ns": phase_total_ns(),
            "phase_hists": {p: list(_phase_buckets[i])
                            for i, p in enumerate(LM_STEP_PHASES)},
            "sched": sched_counters(),
            "spec": spec_counters(),
            "prefix_events": prefix,
            "slo": slo_counters(),
            "ttft_ms": _ttft_rows(),
            "itl_ms": _itl_rows(),
            "live": live_sessions(),
            "ring": timeline_records(),
        }

    def _refresh_locked(self) -> None:
        now = _mono_s()
        if self._snap is None or now - self._t >= self._ttl:
            snap = self._build()
            self._prev, self._prev_t = self._snap, self._t
            self._snap, self._t = snap, now

    def get(self) -> dict:
        with self._lock:
            self._refresh_locked()
            return self._snap

    def window(self):
        with self._lock:
            self._refresh_locked()
            return (self._prev, self._snap,
                    max(self._t - self._prev_t, 1e-9))


_cache: Optional[LmTelemetryCache] = None
_cache_lock = threading.Lock()


def telemetry_cache() -> LmTelemetryCache:
    global _cache
    with _cache_lock:
        if _cache is None:
            _cache = LmTelemetryCache()
        return _cache


def _delta(cur: dict, prev, key: str) -> int:
    c = cur.get(key, 0)
    return c - prev.get(key, 0) if prev is not None else c


def windowed_spec_accept_rate(cache=None) -> float:
    """Accepted/proposed draft tokens over the LAST snapshot window —
    the /vars answer to 'how is acceptance NOW', vs the lifetime
    cumulative ``spec_accept_rate`` the bench/perf_guard keep."""
    prev, cur, _dt = (cache or telemetry_cache()).window()
    p = prev["spec"] if prev is not None else None
    acc = _delta(cur["spec"], p, "spec_accept")
    rej = _delta(cur["spec"], p, "spec_reject")
    denom = acc + rej
    return acc / denom if denom > 0 else 0.0


def windowed_prefix_hit_ratio(cache=None) -> float:
    """(hit + partial) / lookups over the LAST snapshot window."""
    prev, cur, _dt = (cache or telemetry_cache()).window()
    p = prev["prefix_events"] if prev is not None else None
    hit = _delta(cur["prefix_events"], p, "prefix_hit")
    part = _delta(cur["prefix_events"], p, "prefix_partial_hit")
    miss = _delta(cur["prefix_events"], p, "prefix_miss")
    denom = hit + part + miss
    return (hit + part) / denom if denom > 0 else 0.0


def windowed_slo_deltas(cache=None) -> dict:
    """Per-tier SLO attainment DELTAS over the last snapshot window,
    as ``{tier: {verdict: count}}`` — the fleet load report's answer
    to 'how is this node attaining NOW' (lifetime counters drift
    toward their historical mean and stop moving under incidents)."""
    prev, cur, _dt = (cache or telemetry_cache()).window()
    p = prev["slo"] if prev is not None else None
    out: dict = {}
    for (tier, verdict), n in cur["slo"].items():
        d = n - p.get((tier, verdict), 0) if p is not None else n
        if d:
            out.setdefault(tier, {})[verdict] = d
    return out


def lifetime_spec_accept_rate() -> float:
    """The cumulative ratio (perf_guard continuity — the windowed
    variant above is what /vars shows)."""
    from .lm_service import spec_counters
    c = spec_counters()
    denom = c["spec_accept"] + c["spec_reject"]
    return c["spec_accept"] / denom if denom > 0 else 0.0


def lifetime_prefix_hit_ratio() -> float:
    try:
        from ..kv.pages import prefix_event_counters
        c = prefix_event_counters()
    except Exception:
        return 0.0
    denom = c.get("prefix_hit", 0) + c.get("prefix_partial_hit", 0) \
        + c.get("prefix_miss", 0)
    return (c.get("prefix_hit", 0) + c.get("prefix_partial_hit", 0)) \
        / denom if denom > 0 else 0.0


# ---------------------------------------------------------------------------
# /vars + /metrics exposure (PassiveDimension rows share the module's
# plain counters; the portal page additionally reads the cache)
# ---------------------------------------------------------------------------

_phase_var = PassiveDimension(("phase",), phase_counters,
                              name="lm_step_phase_total")
_phase_ns_var = PassiveDimension(("phase",), phase_total_ns,
                                 name="lm_step_phase_ns_total")


def _phase_bucket_rows() -> dict:
    out = {}
    for i, p in enumerate(LM_STEP_PHASES):
        for b, c in enumerate(_phase_buckets[i]):
            if c:
                out[(p, bucket_label(b))] = c
    return out


_phase_hist_var = PassiveDimension(("phase", "bin"), _phase_bucket_rows,
                                   name="lm_step_phase_ns")
_slo_var = PassiveDimension(("tier", "verdict"), slo_counters,
                            name="lm_slo_attained_total")
_ttft_var = PassiveDimension(("tier", "quantile"), _ttft_rows,
                             name="lm_ttft_ms")
_itl_var = PassiveDimension(("tier", "quantile"), _itl_rows,
                            name="lm_itl_ms")
_windowed_var = PassiveDimension(
    ("ratio",),
    lambda: {"spec_accept_rate": round(windowed_spec_accept_rate(), 4),
             "prefix_cache_hit_ratio":
                 round(windowed_prefix_hit_ratio(), 4)},
    name="lm_windowed")

_LM_VARS = (
    (_phase_var, "lm_step_phase_total"),
    (_phase_ns_var, "lm_step_phase_ns_total"),
    (_phase_hist_var, "lm_step_phase_ns"),
    (_slo_var, "lm_slo_attained_total"),
    (_ttft_var, "lm_ttft_ms"),
    (_itl_var, "lm_itl_ms"),
    (_windowed_var, "lm_windowed"),
)


def expose_lm_variables() -> None:
    """(Re-)expose the serving-plane families — the
    ``expose_default_variables`` discipline: a test registry reset
    must not silently drop the /metrics rows for the rest of the
    process lifetime (``Variable.expose`` is a no-op while the name
    is still registered)."""
    for var, name in _LM_VARS:
        var.expose(name)


def _reset_for_tests(ring: Optional[int] = None) -> None:
    global _ring, _cache
    for i in range(_NPHASES):
        _phase_count[i] = 0
        _phase_total_ns[i] = 0
        for b in range(NBUCKETS):
            _phase_buckets[i][b] = 0
    _slo_table()
    for k in _slo:
        _slo[k] = 0
    _tier_ttft.clear()
    _tier_itl.clear()
    _live_sessions.clear()
    _ring = deque(maxlen=int(ring) if ring else _ring_max)
    _cache = None
    expose_lm_variables()
