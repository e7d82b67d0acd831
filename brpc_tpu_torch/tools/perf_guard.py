"""perf_guard — mechanical bench-regression gate.

The port of ``brpc_tpu/tools/perf_guard.py``.  Compares a bench result
(a one-line JSON ``{"metric": ..., "value": ..., "extra": {...}}`` as a
bench prints it, or a capture of it) against one or more
recorded baselines with a tolerance band, and exits non-zero on
regression, so a collapse or a sign flip is caught by the pipeline
instead of by eye.

Usage (the post-bench step)::

    python -m brpc_tpu_torch.tools.perf_guard /tmp/bench.out \
        --baseline base.json --tolerance 0.5 --check

``--check`` additionally runs the port's static-analysis suite
(``brpc_tpu_torch.tools.check``: contract drift, lane invariants,
closed enums/flags, loop-thread blocking calls), so the one post-bench
invocation gates both perf and contracts.

Direction is inferred from the key name (``*_qps``/``*_gbps``/... are
higher-is-better; ``*_us``/``*_ms`` are lower-is-better; ratio keys on
the WATCHED list are higher-is-better).  Keys with no inferable
direction are ignored unless explicitly ``--watch``\\ ed.  The default
tolerance is deliberately wide (50%): the guard exists to catch
collapses and sign flips, not noise.  Keys absent from either side are
reported but never fail the gate (benches grow keys over time).

Cut: the JAX module's ``RECORDED_BASELINE`` values.  They were measured
for the JAX package on its own machine, so they are not the port's;
the port's table starts empty and its benchmark records its own.  The
comparator, the key directions, the watched ratios and the keys pinned
at zero are the JAX module's, and its verdicts on the same lines and
baselines are the JAX module's.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict, Optional, Tuple

# keys the guard always watches when present on both sides, including
# the ratio keys whose drift history motivated the tool (ratios are
# phase-immune, so their band can be meaningfully tighter than raw
# throughput keys — see --ratio-tolerance)
WATCHED_RATIOS = (
    "http_slim_vs_classic",
    "goodput_under_overload",
    "zero_copy_vs_copy_gbps",
    "grpc_vs_grpcio_oracle",
    "fanout_cntl_vs_raw_gap",
    "cntl_vs_raw_gap",
    # multi-core engine: qps(N)/(N*qps(1)) medians over
    # paired interleaved rounds — phase-immune like the other ratios;
    # on one core the ceiling is ~1/N, so the recorded baseline, not an
    # absolute bar, is the gate
    "loop_scaling_efficiency",
    "loop_scaling_efficiency_4loop",
    # kind-5 streaming lane: paired interleaved A/B of the
    # native stream transport vs the forced-Python lane at c=64
    "stream_native_vs_py",
    # SLO-tiered scheduler: all three are paired interleaved
    # A/B medians.  itl_gain = chunked-OFF loaded p99 / idle p99 (the
    # head-of-line stall a monolithic prefill inflicts — chunking keeps
    # the loaded p99 within noise of idle, so the gain is the whole
    # stall); victim_goodput = untiered/tiered interactive finish time
    # under batch contention; accept_rate = accepted draft tokens /
    # proposed (self-draft on the bench cfg is deterministic at 1.0 —
    # the verify pass is the identity ground truth either way)
    "slo_chunked_itl_gain",
    "slo_tier_victim_goodput",
    "spec_accept_rate",
    # inference-plane observability: 1.0 when the serving
    # telemetry's A/B overhead sits within the same-methodology
    # control noise (the raw lm_telemetry_*_pct keys are recorded
    # unscored — a pct next to an unknown noise floor gates nothing)
    "lm_telemetry_within_noise",
    # fleet observability: same shape as the serving-
    # telemetry gate one line up — the serving path pays a flag read
    # and a deque append, so the bar is "A/B median inside the
    # zero-effect control envelope", not an absolute pct
    "fleet_obs_within_noise",
)

# recorded baselines for keys that no --baseline file carries yet,
# applied only to keys absent from every --baseline file (a capture's
# value replaces the recorded one outright); empty until the port's
# benchmark records its first values
RECORDED_BASELINE: Dict[str, float] = {}

# keys pinned at EXACTLY zero: any non-zero value fails the gate
# regardless of tolerance (a failed request during a rolling restart is
# a correctness bug, not a perf regression) — the zero-base rule that
# exempts ratio denominators must not exempt these
PINNED_ZERO = ("rolling_restart_failed_rpcs",
               # a same-host KV handoff moving payload bytes through
               # the message path is a data-plane regression, not noise
               "disagg_handoff_copies",
               # a prefix-cache hit ALIASES the cached context pages
               # (refcounts move, bytes do not) — any copy during the
               # hit sessions means the cache degenerated to memcpy
               "prefix_alias_copies")

_HIGHER = ("_qps", "_gbps", "gbps", "_rps", "_tok_s", "tokens_per_s",
           "_tflops", "_speedup", "_frac", "_factor_inverse",
           "_sessions", "_sessions_per_box")
_LOWER = ("_us", "_ms", "_p50", "_p99", "_rss_mb",
          "_bytes_per_session")
# gap keys measure raw/cntl — LOWER is better (a shrinking gap is the
# win); amplification likewise
_LOWER_RATIOS = ("cntl_vs_raw_gap", "fanout_cntl_vs_raw_gap",
                 "retry_amplification_factor",
                 # paired two-tier/monolithic TTFT: the handoff's cost,
                 # shrinking is the win
                 "disagg_vs_mono_ttft")


def direction_of(key: str) -> Optional[int]:
    """+1 = higher is better, -1 = lower is better, None = unscored."""
    if key in _LOWER_RATIOS:
        return -1
    if key in WATCHED_RATIOS:
        return +1
    for suf in _LOWER:
        if key.endswith(suf):
            return -1
    for suf in _HIGHER:
        if key.endswith(suf):
            return +1
    return None


def _extract_record(text: str) -> Dict[str, float]:
    """Pull the flat metric dict out of bench output or a capture of it
    (JSON).  Tolerates truncated captures (a capture may keep only a
    bounded tail): the ``extra`` object is recovered by brace matching."""
    # 1. capture file: {"n":..., "tail": "...", "parsed": {...}}
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict):
        if isinstance(doc.get("parsed"), dict):
            rec = doc["parsed"]
            out = {k: v for k, v in rec.get("extra", {}).items()
                   if isinstance(v, (int, float))}
            if isinstance(rec.get("value"), (int, float)):
                out[rec.get("metric", "headline")] = rec["value"]
            return out
        if isinstance(doc.get("extra"), dict):
            out = {k: v for k, v in doc["extra"].items()
                   if isinstance(v, (int, float))}
            if isinstance(doc.get("value"), (int, float)):
                out[doc.get("metric", "headline")] = doc["value"]
            return out
        text = doc.get("tail", "") or ""
    # 2. a bench stdout line somewhere in the text
    for line in reversed(text.splitlines()):
        line = line.strip()
        if line.startswith('{"metric"'):
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            out = {k: v for k, v in rec.get("extra", {}).items()
                   if isinstance(v, (int, float))}
            if isinstance(rec.get("value"), (int, float)):
                out[rec.get("metric", "headline")] = rec["value"]
            return out
    # 3. truncated head: recover the extra dict by
    # brace-matching from '"extra": {'
    m = re.search(r'"extra":\s*\{', text)
    if m:
        depth = 0
        start = m.end() - 1
        for i in range(start, len(text)):
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
                if depth == 0:
                    try:
                        extra = json.loads(text[start:i + 1])
                    except ValueError:
                        break
                    return {k: v for k, v in extra.items()
                            if isinstance(v, (int, float))}
    return {}


def load_metrics(path: str) -> Dict[str, float]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return _extract_record(f.read())


def compare(new: Dict[str, float], base: Dict[str, float],
            tolerance: float, ratio_tolerance: float,
            watch: Tuple[str, ...] = ()) -> Tuple[list, list]:
    """Returns (failures, rows).  A key fails when it moved past its
    band in the worse direction; unscored/missing keys only report."""
    failures = []
    rows = []
    keys = sorted(set(new) | set(base))
    for k in keys:
        if k in PINNED_ZERO:
            nv = new.get(k)
            if nv is None:
                rows.append((k, 0, nv, "missing", False))
            else:
                bad = nv != 0
                rows.append((k, 0, nv,
                             "REGRESSED" if bad else "ok", bad))
                if bad:
                    failures.append(k)
            continue
        d = direction_of(k)
        if d is None and k not in watch:
            continue
        if d is None:
            d = +1
        nv, bv = new.get(k), base.get(k)
        if nv is None or bv is None:
            rows.append((k, bv, nv, "missing", False))
            continue
        if bv == 0:
            rows.append((k, bv, nv, "zero-base", False))
            continue
        tol = ratio_tolerance if k in WATCHED_RATIOS \
            or k in _LOWER_RATIOS else tolerance
        if d > 0:
            bad = nv < bv * (1.0 - tol)
        else:
            bad = nv > bv * (1.0 + tol)
        verdict = "REGRESSED" if bad else "ok"
        rows.append((k, bv, nv, verdict, bad))
        if bad:
            failures.append(k)
    return failures, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="perf_guard",
        description="fail when a bench run regressed past the band")
    ap.add_argument("new", help="bench output or capture of the run")
    ap.add_argument("--baseline", "-b", action="append", required=True,
                    help="recorded bench capture (repeatable: the best "
                         "recorded value per key is the bar)")
    ap.add_argument("--tolerance", type=float, default=0.5,
                    help="allowed fractional drop for throughput keys "
                         "(default 0.5)")
    ap.add_argument("--ratio-tolerance", type=float, default=0.25,
                    help="band for paired-A/B ratio keys, which are "
                         "phase-immune (default 0.25)")
    ap.add_argument("--watch", action="append", default=[],
                    help="extra key to score (higher-is-better)")
    ap.add_argument("--check", action="store_true",
                    help="also run the static-analysis suite "
                         "(python -m brpc_tpu_torch.tools.check): the "
                         "post-bench step then gates perf AND "
                         "contracts in one invocation")
    args = ap.parse_args(argv)

    check_rc = 0
    if args.check:
        # a suite ERROR must not masquerade as findings nor skip the
        # perf comparison below — same 0/1/2 contract as the check CLI
        try:
            from .check import run_all
            findings = run_all()
        except Exception as e:
            print(f"perf_guard --check: suite error: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            findings = None
            check_rc = 2
        if findings:
            for f in findings:
                print(f"{f.path}:{f.line}: [{f.analyzer}] {f.message}")
            print(f"perf_guard --check: {len(findings)} static "
                  "finding(s)", file=sys.stderr)
            check_rc = 1
        elif findings is not None:
            print("perf_guard --check: static suite clean")

    new = load_metrics(args.new)
    if not new:
        print(f"perf_guard: no metrics found in {args.new}",
              file=sys.stderr)
        return 2
    base: Dict[str, float] = {}
    for bp in args.baseline:
        for k, v in load_metrics(bp).items():
            d = direction_of(k)
            if k not in base:
                base[k] = v
            elif d == -1:
                base[k] = min(base[k], v)
            else:
                base[k] = max(base[k], v)
    # recorded day-one values only for keys no --baseline file carries
    # yet (see RECORDED_BASELINE comment: captures override outright)
    for k, v in RECORDED_BASELINE.items():
        base.setdefault(k, v)
    failures, rows = compare(new, base, args.tolerance,
                             args.ratio_tolerance, tuple(args.watch))
    w = max((len(r[0]) for r in rows), default=10)
    for k, bv, nv, verdict, _bad in rows:
        print(f"{k:<{w}}  base={bv!s:>12}  new={nv!s:>12}  {verdict}")
    if failures:
        print(f"perf_guard: {len(failures)} regression(s): "
              f"{', '.join(failures)}", file=sys.stderr)
        return 1
    print(f"perf_guard: {sum(1 for r in rows if r[3] == 'ok')} keys "
          "within band")
    return check_rc


if __name__ == "__main__":
    sys.exit(main())
