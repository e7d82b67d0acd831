"""Serving-plane observability of the continuous batcher: the slim part of
``brpc_tpu/models/lm_telemetry.py`` that the batcher calls.

- **Step profiler:** per-phase sample counts and total monotonic ns
  around the batcher's step loop (``LM_STEP_PHASES``, indexed by the
  ``PH_*`` constants), written by the batcher thread only, with no lock:
  plain list increments, read racily but monotonically.
- **Session timelines:** one :class:`SessionTimeline` per decode session
  (tier, tenant, prompt length, TTFT, the largest inter-token gap, close
  reason; its source, ``fresh`` or ``imported`` from a prefill tier, which
  a paged admit of a fresh session refines to its prefix outcome; peak
  pages, spills, resumes and preemptions), opened at join, fed per step
  by :func:`on_emit` and judged at close against the tier's targets into
  the closed ``LM_SLO_VERDICTS`` counters.

The log2 histograms, the flags, the /vars and /metrics exposure, the
session rings and the windowed snapshot cache wait for a later slice of
the port.
"""

from __future__ import annotations

from time import monotonic_ns as _mono_ns
from typing import Optional

# closed enum: the step loop's named phases; the index is the write API
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

_phase_count = [0] * len(LM_STEP_PHASES)
_phase_total_ns = [0] * len(LM_STEP_PHASES)


def record_phase(idx: int, ns: int) -> None:
    """One phase sample (batcher thread only): lock-free, allocation-free."""
    _phase_count[idx] += 1
    _phase_total_ns[idx] += max(ns, 0)


def phase_counters() -> dict:
    return {p: _phase_count[i] for i, p in enumerate(LM_STEP_PHASES)}


def phase_total_ns() -> dict:
    return {p: _phase_total_ns[i] for i, p in enumerate(LM_STEP_PHASES)}


# closed enum: one verdict per closed session, judged against its tier's
# targets (TierRegistry.slo_of)
LM_SLO_VERDICTS = (
    "slo_ok",            # every configured target met
    "slo_ttft_miss",     # first token later than the tier's TTFT target
    "slo_itl_miss",      # an inter-token gap beyond the tier's ITL target
    "slo_untargeted",    # the session's tier configures no targets
)

_slo: dict = {}          # (tier, verdict) -> count, seeded on first use


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


class SessionTimeline:
    """One decode session's observable life: opened at join, fed by the
    batcher thread, judged at close."""

    __slots__ = ("tier", "tenant", "prompt_len", "max_new", "join_ns",
                 "first_ns", "last_ns", "tokens", "itl_max_ns", "prefix",
                 "pages_peak", "spills", "resumes", "preempts",
                 "close_reason", "verdict")

    def __init__(self, tier: str, tenant: str, prompt_len: int,
                 max_new: int, source: str):
        self.tier = tier
        self.tenant = tenant
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.join_ns = _mono_ns()
        self.first_ns = 0
        self.last_ns = 0
        self.tokens = 0
        self.itl_max_ns = 0
        self.prefix = source      # fresh|imported, refined at admit
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


def open_timeline(tier: str, tenant, prompt_len: int, max_new: int,
                  source: str) -> SessionTimeline:
    """At join (not in the step loop): the session's record.  Its
    ``prefix`` field starts at ``source``, ``fresh`` (a prompt) or
    ``imported`` (a cache from a prefill tier); a paged admit refines a
    fresh one to ``prefix_hit``, ``prefix_partial`` or
    ``prefix_miss``."""
    from .lm_service import SLO_TIERS
    if tier not in SLO_TIERS:
        raise ValueError(f"unregistered SLO tier: {tier}")
    if isinstance(tenant, (bytes, bytearray, memoryview)):
        tenant = bytes(tenant).decode("utf-8", "replace")
    return SessionTimeline(tier, str(tenant or "-"), int(prompt_len),
                           int(max_new), source)


def on_emit(pairs) -> None:
    """One step's token timing (batcher thread only): one clock read for
    the step; the first token stamps the session's TTFT, later ones its
    inter-token gaps."""
    if not pairs:
        return
    now = _mono_ns()
    for sess, _tok in pairs:
        tl = sess.tl
        if tl is None:
            continue
        if tl.tokens == 0:
            tl.first_ns = now
        else:
            tl.itl_max_ns = max(tl.itl_max_ns, now - tl.last_ns)
        tl.last_ns = now
        tl.tokens += 1


def close_timeline(tl: Optional[SessionTimeline], reason: str,
                   ttft_target_ms=None, itl_target_ms=None) -> None:
    """At close (batcher thread): judge and count the SLO verdict."""
    if tl is None:
        return
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
