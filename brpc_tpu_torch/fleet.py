"""Fleet observability plane: live load reports, a fleet registry any
server can host, metric federation, and a per-node event flight
recorder.

Every other observability layer (rpcz, bvar, the LM serving telemetry)
is per-process.  This module grows the stack one level of hierarchy:

- **load report** — a versioned snapshot of THIS node's live capacity:
  decode-slot availability, ``PageAllocator``/``HostPagePool``
  occupancy, per-tier SLO attainment deltas over the telemetry window,
  drain/lame-duck state, recent flight-recorder events and recent rpcz
  trace roots.  Built by :func:`build_load_report` (no sleeps, no
  untimed waits, no sockets), cached by :class:`FleetReportCache` so the
  KV.Probe tail and the cadence push share ONE build per interval
  (``builds`` is the test pin);
- **fleet registry** — :class:`FleetRegistry` +
  :class:`FleetRegistryService` (``Fleet.Register`` / ``Fleet.Report``
  / ``Fleet.Deregister`` / ``Fleet.List``): members push reports on a
  cadence (:class:`FleetReporter`), membership can be seeded from the
  ``file://`` naming lists, and a member whose report ages past TTL
  flips LOUDLY to ``stale`` (and records a ``fleet_member_stale`` event)
  instead of vanishing.  A draining member deregisters explicitly, so
  the registry shows ``draining`` within one report interval;
- **metric federation** — one registry-side scrape merges the members'
  Prometheus families under an ``instance`` label
  (:meth:`FleetRegistry.federate`), with fleet-level SLO rollups and
  top-k outlier nodes; plus a fleet **trace index** (trace root →
  owning instance);
- **flight recorder** — a bounded ring of structured operational
  events under the CLOSED :data:`FLEET_EVENTS` enum (drain, lame-duck,
  breaker trip, ``kv_handoff_failed``, evict/spill, restart, ...).
  :func:`record_event` is the lock-free write path (GIL-atomic deque
  append).

A copy of ``brpc_tpu/fleet.py``: pure-Python bookkeeping, whose HTTP
reads (:func:`fetch_member_metrics`, :func:`fetch_member_report`, and
:meth:`FleetRegistry.federate`'s default scrape) GET a member's builtin
portal (``/metrics``, ``/fleet?self=1``) on its serving port.  The port
has no native engine, so a report's
``busy_ratio`` is None, as the JAX package's is without one.  Two
divergences: :class:`FleetReportCache` keeps a report per server, so
replicas in one process each report themselves; and a report reads a
Decode batcher only once it is built (the JAX report calls
``batcher()``, which builds it, KV pool and all, on a decode tier's
first probe).
"""

from __future__ import annotations

import itertools
import json
import threading
import weakref
from collections import deque
from time import monotonic as _mono_s
from time import time as _wall_s
from typing import Any, Dict, List, Optional, Tuple

from .butil.flags import define_flag, get_flag, watch_flag
from .butil.logging_util import LOG
from .bvar.multi_dimension import PassiveDimension
from .bvar.passive_status import PassiveStatus

define_flag("fleet_obs", True,
            "fleet observability master switch: flight recorder writes "
            "and load-report cadence pushes (flippable live; hot paths "
            "read a flag-cache, not the flags table)",
            validator=lambda v: isinstance(v, bool))
define_flag("fleet_report_interval_s", 1.0,
            "cadence of a member's load-report pushes to its fleet "
            "registry (also the /fleet 'within one interval' promise "
            "for drain visibility)",
            validator=lambda v: isinstance(v, (int, float)) and
            0.01 <= float(v) <= 3600.0)
define_flag("fleet_member_ttl_s", 5.0,
            "registry: a member whose newest report is older than this "
            "flips LOUDLY to 'stale' (kept on /fleet, never dropped)",
            validator=lambda v: isinstance(v, (int, float)) and
            0.1 <= float(v) <= 86400.0)
define_flag("fleet_events_ring", 256,
            "bounded ring of flight-recorder events kept per node",
            validator=lambda v: isinstance(v, int) and 0 < v <= 65536)

LOAD_REPORT_VERSION = 1

# ---------------------------------------------------------------------------
# Flight recorder: CLOSED operational-event enum + bounded ring
# ---------------------------------------------------------------------------

# CLOSED enum (tools/check/enums.py pins every member to a test): one
# name per operational event class worth a postmortem timeline row.
# No "unknown" bucket — an unregistered event fails the assert at the
# first record_event call.
FLEET_EVENTS = (
    "fleet_restart",            # a Server began serving (fresh or hot restart)
    "fleet_drain",              # Server.drain() entered on this node
    "fleet_lame_duck",          # lame-duck signaling raised (drain grace)
    "fleet_stop",               # Server.stop() — node left the fleet
    "fleet_register",           # this node registered with a fleet registry
    "fleet_deregister",         # this node deregistered (drain-time, explicit)
    "fleet_member_stale",       # registry: a member's report aged past TTL
    "fleet_breaker_trip",       # client circuit breaker isolated a peer
    "fleet_kv_handoff_failed",  # strict at-most-once KV handoff closed a stream
    "fleet_kv_evict",           # paged-KV allocator evicted/refused under pressure
    "fleet_host_spill",         # a session's KV pages spilled to the host tier
)

_live = [bool(get_flag("fleet_obs"))]
watch_flag("fleet_obs", lambda v: _live.__setitem__(0, bool(v)))

_ev_seq = itertools.count(1)
_ev_counts: Dict[str, int] = {e: 0 for e in FLEET_EVENTS}
_events: deque = deque(maxlen=int(get_flag("fleet_events_ring")))


def record_event(event: str, detail: str = "") -> None:
    """Append one structured operational event to the bounded ring.

    The write path is lock-free — a GIL-atomic ``deque.append`` plus a
    plain counter bump (racy-but-monotonic for readers, the engine-
    telemetry discipline) — because callers include ``Server.drain``
    and the KV eviction path.
    """
    assert event in _ev_counts, f"unnamed fleet event {event!r}"
    if not _live[0]:
        return
    _ev_counts[event] += 1
    _events.append((next(_ev_seq), _wall_s(), event, str(detail)[:200]))


def event_counters() -> Dict[str, int]:
    return dict(_ev_counts)


def recent_events(limit: int = 64) -> List[dict]:
    """Newest-last slice of the flight recorder as portable dicts."""
    rows = list(_events)
    if limit and len(rows) > limit:
        rows = rows[-limit:]
    return [{"seq": s, "wall_s": round(w, 3), "event": e, "detail": d}
            for (s, w, e, d) in rows]


# ---------------------------------------------------------------------------
# Load report: one node's live capacity, versioned and portable
# ---------------------------------------------------------------------------

_report_seq = itertools.count(1)
_proc_start_s = _wall_s()


def _instance_of(server) -> str:
    ep = getattr(server, "listen_endpoint", None) if server is not None \
        else None
    return str(ep) if ep is not None else ""


def _decode_service(server):
    """The service behind this server's ``Decode`` method that has a
    batcher (an ``LMService``), or None."""
    if server is None:
        return None
    for (_svc, mth), entry in sorted(
            getattr(server, "methods", {}).items()):
        if mth == "Decode" and hasattr(entry.service, "batcher"):
            return entry.service
    return None


def _slots_of(server) -> Optional[dict]:
    """Decode-slot availability from an LM service's batcher, if this
    server hosts one (the /lm scan, minus the portal).  Before the
    batcher is built the service's slot count stands in for it (the
    values a fresh batcher reports): a report never builds one, which
    would allocate its KV pool."""
    svc = _decode_service(server)
    if svc is None:
        return None
    bat = getattr(svc, "_batcher", None)
    if bat is None:
        total = int(getattr(svc, "decode_slots", 0) or 0)
        return {"live": 0, "total": total, "free": total, "steps": 0}
    total = int(getattr(bat, "slots", 0) or 0)
    live = int(bat.live_slots())
    return {"live": live, "total": total,
            "free": max(total - live, 0),
            "steps": int(bat.steps_run())}


def _kv_occupancy(server) -> Optional[dict]:
    """PageAllocator / HostPagePool occupancy via the batcher's
    kv_stats() — absent keys mean that tier isn't configured, None that
    no batcher is built yet."""
    svc = _decode_service(server)
    bat = getattr(svc, "_batcher", None) if svc is not None else None
    if bat is None:
        return None
    stats = bat.kv_stats()
    if not stats:
        return None
    out: Dict[str, Any] = {}
    for tier in ("alloc", "host", "prefix"):
        if tier in stats:
            out[tier] = stats[tier]
    for k in ("spills", "resumes", "parked"):
        if k in stats:
            out[k] = stats[k]
    return out or None


def _slo_deltas() -> dict:
    """Per-tier SLO attainment deltas over the lm_telemetry snapshot
    window — current behavior, not lifetime averages."""
    try:
        from .models.lm_telemetry import windowed_slo_deltas
        return windowed_slo_deltas()
    except Exception:
        return {}


def _busy_ratio(server) -> Optional[float]:
    """The native loops' busy ratio: the port has no native engine, so
    there is none (the JAX package's answer without its bridge)."""
    return None


def _trace_roots(limit: int = 32) -> List[str]:
    """Hex trace ids whose ROOT span (parent_span_id == 0) lives in
    this process — the fleet trace index's raw material."""
    try:
        from .rpcz import global_span_store
        spans = global_span_store().recent(limit * 4)
    except Exception:
        return []
    out: List[str] = []
    seen = set()
    for sp in spans:
        if getattr(sp, "parent_span_id", None) == 0:
            tid = f"{sp.trace_id:x}"
            if tid not in seen:
                seen.add(tid)
                out.append(tid)
                if len(out) >= limit:
                    break
    return out


def build_load_report(server=None) -> dict:
    """One versioned load report for THIS node.

    Pure local bookkeeping — reads passively-maintained counters and
    snapshots only: no sleeps, no untimed waits, no socket work may
    ever grow in here (cadence and transport live in
    :class:`FleetReporter`).
    """
    report = {
        "v": LOAD_REPORT_VERSION,
        "instance": _instance_of(server),
        "seq": next(_report_seq),
        "wall_s": round(_wall_s(), 3),
        "uptime_s": round(_wall_s() - _proc_start_s, 3),
        "drain": getattr(server, "drain_phase", "serving")
        if server is not None else "serving",
        "lame_duck": bool(getattr(server, "lame_duck_signal_on", False))
        if server is not None else False,
        "inflight": int(getattr(server, "inflight", 0) or 0)
        if server is not None else 0,
        "slots": _slots_of(server),
        "kv": _kv_occupancy(server),
        "slo": _slo_deltas(),
        "busy_ratio": _busy_ratio(server),
        "events": recent_events(16),
        "trace_roots": _trace_roots(),
    }
    return report


class FleetReportCache:
    """Short-TTL cache over :func:`build_load_report` so the KV.Probe
    tail and the cadence push share ONE build per interval.  ``builds``
    counts actual constructions — the one-build-per-interval test pin.

    One report is kept per server (by its instance): where the JAX
    package keeps one for the whole process, two servers in one process
    (replicas, or a decode tier beside them) would hand each other's
    report to their registry and their probe answers."""

    def __init__(self, ttl_s: float = 0.25):
        self._ttl = ttl_s
        self._lock = threading.Lock()
        self._snaps: Dict[str, Tuple[dict, float]] = {}
        self.builds = 0

    def get(self, server=None) -> dict:
        key = _instance_of(server)
        with self._lock:
            now = _mono_s()
            snap = self._snaps.get(key)
            if snap is None or now - snap[1] >= self._ttl:
                self.builds += 1
                snap = self._snaps[key] = (build_load_report(server), now)
            return snap[0]


_report_cache: Optional[FleetReportCache] = None
_report_cache_lock = threading.Lock()


def report_cache() -> FleetReportCache:
    global _report_cache
    with _report_cache_lock:
        if _report_cache is None:
            _report_cache = FleetReportCache()
        return _report_cache


# ---------------------------------------------------------------------------
# Fleet registry: TTL'd member table + trace index + federation
# ---------------------------------------------------------------------------

# member states as /fleet shows them (not a counted enum — states are
# DERIVED from report age + drain fields, never counted blindly)
MEMBER_OK = "ok"
MEMBER_DRAINING = "draining"
MEMBER_STALE = "stale"
MEMBER_SEEDED = "seeded"        # expected via file:// seed, no report yet

FLEET_MEMBER_STATES = (MEMBER_OK, MEMBER_DRAINING, MEMBER_STALE,
                       MEMBER_SEEDED)

_FED_TTL_S = 2.0                # federation scrape cache
_TOP_K = 3                      # outlier rows surfaced on /fleet


class _Member:
    __slots__ = ("instance", "report", "last_seen", "deregistered",
                 "stale_announced")

    def __init__(self, instance: str):
        self.instance = instance
        self.report: Optional[dict] = None
        self.last_seen = 0.0            # monotonic; 0 = never reported
        self.deregistered = False
        self.stale_announced = False


class FleetRegistry:
    """Member table any server can host.  Reports arrive via
    :meth:`ingest` (the Fleet.Register / Fleet.Report RPCs), membership
    can be pre-seeded from a ``file://`` naming list, and staleness is
    judged lazily at read time: a member whose newest report is older
    than TTL flips to ``stale`` LOUDLY (one ``fleet_member_stale``
    flight-recorder event per transition) and stays on /fleet."""

    def __init__(self, ttl_s: Optional[float] = None):
        self._lock = threading.Lock()
        self._members: Dict[str, _Member] = {}
        self._ttl = float(ttl_s if ttl_s is not None
                          else get_flag("fleet_member_ttl_s"))
        self._fed_lock = threading.Lock()
        self._fed_body: Optional[str] = None
        self._fed_t = 0.0
        self.fed_builds = 0

    @property
    def ttl_s(self) -> float:
        return self._ttl

    # -- membership --------------------------------------------------------

    def ingest(self, report: dict) -> int:
        """Accept one member load report; returns 0 ok / -1 rejected.
        Unknown future versions are accepted (fields are additive);
        reports without an instance are not addressable and refused."""
        if not isinstance(report, dict):
            return -1
        inst = str(report.get("instance") or "")
        if not inst or int(report.get("v", 0)) < 1:
            return -1
        with self._lock:
            m = self._members.get(inst)
            if m is None:
                m = self._members[inst] = _Member(inst)
            m.report = report
            m.last_seen = _mono_s()
            m.stale_announced = False
            # an explicit deregister wins until the member re-registers
            # with a serving report (restart after drain)
            if m.deregistered and report.get("drain") == "serving":
                m.deregistered = False
        return 0

    def deregister(self, instance: str, detail: str = "") -> int:
        """Mark a member as intentionally leaving (drain-time): /fleet
        flips it to ``draining`` immediately instead of letting the TTL
        age it into ``stale``."""
        with self._lock:
            m = self._members.get(str(instance))
            if m is None:
                return -1
            m.deregistered = True
        return 0

    def seed(self, targets) -> int:
        """Pre-register expected members ("host:port" strings) — they
        show as ``seeded`` until their first report lands."""
        n = 0
        with self._lock:
            for t in targets:
                t = str(t).strip()
                if t and t not in self._members:
                    self._members[t] = _Member(t)
                    n += 1
        return n

    def seed_from_url(self, url: str) -> int:
        """Seed from an existing ``file://`` naming list (one
        ``host:port`` per line, ``#`` comments) — the same files
        ``Server.publish`` maintains."""
        path = url[len("file://"):] if url.startswith("file://") else url
        try:
            with open(path, "r", encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError as e:
            LOG.warning("fleet seed: cannot read %s: %s", path, e)
            return 0
        targets = []
        for ln in lines:
            ln = ln.split("#", 1)[0].strip()
            if ln:
                targets.append(ln.split()[0])
        return self.seed(targets)

    def _state_of(self, m: _Member, now: float) -> str:
        if m.report is None:
            return MEMBER_SEEDED
        if m.deregistered or m.report.get("drain") in ("draining",
                                                       "stopped"):
            return MEMBER_DRAINING
        if now - m.last_seen > self._ttl:
            return MEMBER_STALE
        return MEMBER_OK

    def members(self) -> List[dict]:
        """Member rows with derived state; the stale transition is
        announced (once per transition) on the registry host's own
        flight recorder — TTL-ing out is an EVENT, not silence."""
        now = _mono_s()
        rows = []
        with self._lock:
            for m in sorted(self._members.values(),
                            key=lambda x: x.instance):
                state = self._state_of(m, now)
                if state == MEMBER_STALE and not m.stale_announced:
                    m.stale_announced = True
                    record_event("fleet_member_stale", m.instance)
                age = round(now - m.last_seen, 3) if m.last_seen else None
                rows.append({"instance": m.instance, "state": state,
                             "age_s": age, "report": m.report})
        return rows

    def member_counts(self) -> Dict[str, int]:
        counts = {s: 0 for s in FLEET_MEMBER_STATES}
        for row in self.members():
            counts[row["state"]] += 1
        return counts

    # -- trace index -------------------------------------------------------

    def trace_owners(self, trace_id_hex: str) -> List[str]:
        """Instances whose reports claim the ROOT span of this trace —
        rpcz_stitch starts its BFS there instead of from-root-only."""
        tid = str(trace_id_hex).lower().lstrip("0x") or "0"
        out = []
        with self._lock:
            for m in self._members.values():
                rep = m.report
                if rep and tid in (rep.get("trace_roots") or ()):
                    out.append(m.instance)
        return sorted(out)

    def trace_index(self) -> Dict[str, List[str]]:
        idx: Dict[str, List[str]] = {}
        with self._lock:
            for m in self._members.values():
                rep = m.report
                for tid in (rep.get("trace_roots") or ()) if rep else ():
                    idx.setdefault(tid, []).append(m.instance)
        return {t: sorted(v) for t, v in idx.items()}

    # -- fleet timeline + rollups -----------------------------------------

    def timeline(self, limit: int = 128) -> List[dict]:
        """One merged fleet timeline: every member's reported recent
        events plus the registry host's own ring, ordered by wall
        clock (member clocks — good enough for postmortems; rpcz skew
        annotation is the precise tool)."""
        rows: List[dict] = []
        with self._lock:
            for m in self._members.values():
                rep = m.report
                for ev in (rep.get("events") or ()) if rep else ():
                    row = dict(ev)
                    row["instance"] = m.instance
                    rows.append(row)
        for ev in recent_events(limit):
            row = dict(ev)
            row["instance"] = "(registry)"
            rows.append(row)
        rows.sort(key=lambda r: (r.get("wall_s", 0), r.get("seq", 0)))
        # dedupe rows a member re-reports across consecutive reports
        seen = set()
        out = []
        for r in rows:
            key = (r["instance"], r.get("seq"), r.get("event"))
            if key in seen:
                continue
            seen.add(key)
            out.append(r)
        return out[-limit:]

    def rollups(self) -> dict:
        """Fleet-level SLO rollup (summed per-tier window deltas) and
        top-k outlier nodes by busy ratio and by SLO miss share."""
        slo: Dict[str, Dict[str, int]] = {}
        busy: List[Tuple[float, str]] = []
        miss: List[Tuple[float, str]] = []
        slots_live = slots_total = 0
        for row in self.members():
            rep = row["report"]
            if not rep:
                continue
            for tier, verdicts in (rep.get("slo") or {}).items():
                dst = slo.setdefault(tier, {})
                for v, n in verdicts.items():
                    dst[v] = dst.get(v, 0) + int(n)
            if rep.get("busy_ratio") is not None:
                busy.append((float(rep["busy_ratio"]), row["instance"]))
            tot = ok = 0
            for verdicts in (rep.get("slo") or {}).values():
                for v, n in verdicts.items():
                    tot += int(n)
                    if v == "slo_ok":
                        ok += int(n)
            if tot:
                miss.append((1.0 - ok / tot, row["instance"]))
            sl = rep.get("slots")
            if sl:
                slots_live += int(sl.get("live", 0))
                slots_total += int(sl.get("total", 0))
        busy.sort(reverse=True)
        miss.sort(reverse=True)
        return {
            "slo": slo,
            "slots": {"live": slots_live, "total": slots_total},
            "top_busy": [{"instance": i, "busy_ratio": b}
                         for b, i in busy[:_TOP_K]],
            "top_slo_miss": [{"instance": i,
                              "miss_ratio": round(r, 4)}
                             for r, i in miss[:_TOP_K]],
        }

    # -- metric federation -------------------------------------------------

    def federate(self, fetch=None, timeout_s: float = 1.0) -> str:
        """One collector scrape: every live member's metrics, read by
        ``fetch(instance, timeout_s=)``, merged under an ``instance``
        label, prefixed by the fleet rollups.  Cached (one scrape sweep
        per interval) — a hot dashboard must not multiply into
        per-request fleet-wide scrapes.  The default ``fetch`` GETs each
        member's ``/metrics`` page (:func:`fetch_member_metrics`)."""
        with self._fed_lock:
            now = _mono_s()
            if self._fed_body is not None and \
                    now - self._fed_t < _FED_TTL_S:
                return self._fed_body
            self.fed_builds += 1
            body = self._federate_build(fetch or fetch_member_metrics,
                                        timeout_s)
            self._fed_body, self._fed_t = body, now
            return body

    def _federate_build(self, fetch, timeout_s: float) -> str:
        out: List[str] = []
        counts = self.member_counts()
        out.append("# TYPE fleet_members gauge")
        for state in FLEET_MEMBER_STATES:
            out.append('fleet_members{state="%s"} %d'
                       % (state, counts[state]))
        roll = self.rollups()
        out.append("# TYPE fleet_slo_window_total gauge")
        for tier, verdicts in sorted(roll["slo"].items()):
            for v, n in sorted(verdicts.items()):
                out.append('fleet_slo_window_total{tier="%s",'
                           'verdict="%s"} %d' % (tier, v, n))
        out.append("# TYPE fleet_decode_slots gauge")
        out.append('fleet_decode_slots{kind="live"} %d'
                   % roll["slots"]["live"])
        out.append('fleet_decode_slots{kind="total"} %d'
                   % roll["slots"]["total"])
        for row in self.members():
            if row["state"] in (MEMBER_STALE, MEMBER_SEEDED):
                continue            # loud absence: counted above, not scraped
            inst = row["instance"]
            try:
                body = fetch(inst, timeout_s=timeout_s)
            except Exception as e:
                LOG.info("fleet federate: scrape %s failed: %s", inst, e)
                continue
            out.append(_inject_instance_label(body, inst))
        return "\n".join(out) + "\n"


def _inject_instance_label(body: str, instance: str) -> str:
    """Rewrite one Prometheus exposition body so every sample carries
    ``instance="host:port"`` — the federation merge key.  Comment/TYPE
    lines pass through; malformed lines are dropped rather than
    forwarded corrupt."""
    esc = instance.replace("\\", r"\\").replace('"', r'\"')
    out = []
    for line in body.splitlines():
        s = line.strip()
        if not s:
            continue
        if s.startswith("#"):
            out.append(s)
            continue
        # name{labels} value | name value
        space = s.rfind(" ")
        if space <= 0:
            continue
        series, value = s[:space], s[space + 1:]
        if series.endswith("}") and "{" in series:
            name, labels = series[:-1].split("{", 1)
            merged = f'instance="{esc}"' + ("," + labels if labels
                                            else "")
            out.append(f"{name}{{{merged}}} {value}")
        else:
            out.append(f'{series}{{instance="{esc}"}} {value}')
    return "\n".join(out)


def fetch_member_metrics(instance: str, timeout_s: float = 1.0) -> str:
    """HTTP GET a member's local /metrics (the builtin portal rides
    the shared serving port)."""
    import http.client
    host, _, port = str(instance).rpartition(":")
    conn = http.client.HTTPConnection(host, int(port),
                                      timeout=timeout_s)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"/metrics on {instance}: {resp.status}")
        return data.decode("utf-8", "replace")
    finally:
        conn.close()


def fetch_member_report(instance: str, timeout_s: float = 1.0) -> dict:
    """Pull-on-demand path: HTTP GET a member's own load report from
    its /fleet?self=1 portal page."""
    import http.client
    host, _, port = str(instance).rpartition(":")
    conn = http.client.HTTPConnection(host, int(port),
                                      timeout=timeout_s)
    try:
        conn.request("GET", "/fleet?self=1&format=json")
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"/fleet on {instance}: {resp.status}")
        return json.loads(data.decode("utf-8", "replace"))
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# Fleet RPC service (registry side) + cadence reporter (member side)
# ---------------------------------------------------------------------------

class FleetRegistryService:
    """``Fleet.*`` RPC surface over a :class:`FleetRegistry` — members
    register over RPC, same wire as everything else."""

    def __init__(self, registry: Optional[FleetRegistry] = None):
        self.registry = registry or FleetRegistry()

    @classmethod
    def service_name(cls) -> str:
        return "Fleet"

    def Register(self, cntl, request):
        try:
            report = json.loads(bytes(request).decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            cntl.set_failed(400, "fleet: malformed report json")
            return b""
        if self.registry.ingest(report) != 0:
            cntl.set_failed(400, "fleet: unaddressable report")
            return b""
        return b"ok"

    def Report(self, cntl, request):
        # cadence pushes share the Register path: first report IS the
        # registration (crash-restart re-registers implicitly)
        return self.Register(cntl, request)

    def Deregister(self, cntl, request):
        inst = bytes(request).decode("utf-8", "replace").strip()
        self.registry.deregister(inst)
        return b"ok"

    def List(self, cntl, request):
        return json.dumps({"members": self.registry.members()},
                          default=str).encode("utf-8")


def host_registry(server, seed: Optional[str] = None,
                  ttl_s: Optional[float] = None) -> FleetRegistry:
    """Attach a fleet registry to ``server`` (add the Fleet service;
    :func:`registry_of` finds it through the service table).  Call
    before ``start()``."""
    reg = FleetRegistry(ttl_s=ttl_s)
    if seed:
        reg.seed_from_url(seed)
    if server.add_service(FleetRegistryService(reg)) != 0:
        raise RuntimeError("fleet: could not add Fleet service")
    _note_registry(reg)
    return reg


def registry_of(server) -> Optional[FleetRegistry]:
    svc = getattr(server, "_services", {}).get("Fleet")
    return getattr(svc, "registry", None) if svc is not None else None


# member-side reporters, keyed weakly so a dropped Server reaps its
# reporter without an unpublish protocol
_reporters: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class FleetReporter:
    """Pushes this server's load report to a registry on a cadence.

    The report itself comes from the shared :func:`report_cache` (one
    build per interval no matter how many consumers); only the
    transport lives here.  The loop thread is a daemon and wakes via a
    timed Event wait, so stop() and drain-time final pushes never
    block on a sleeping loop."""

    def __init__(self, server, registry_addr: str,
                 interval_s: Optional[float] = None):
        self._server_ref = weakref.ref(server)
        self.registry_addr = str(registry_addr)
        self.interval_s = float(interval_s if interval_s is not None
                                else get_flag("fleet_report_interval_s"))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._chan = None
        self._chan_lock = threading.Lock()
        self.pushes = 0
        self.push_failures = 0

    def _channel(self):
        with self._chan_lock:
            if self._chan is None:
                from .client import Channel
                ch = Channel()
                if ch.init(self.registry_addr) != 0:
                    raise RuntimeError(
                        f"fleet: bad registry addr {self.registry_addr}")
                self._chan = ch
            return self._chan

    def _call(self, method: str, payload: bytes,
              timeout_ms: int = 1000) -> bool:
        from .client import Controller
        try:
            cntl = Controller()
            cntl.timeout_ms = timeout_ms
            c = self._channel().call_method(method, payload, cntl=cntl)
            ok = not c.failed
        except Exception as e:
            LOG.info("fleet push failed: %s", e)
            ok = False
        self.pushes += 1
        if not ok:
            self.push_failures += 1
        return ok

    def push_now(self, method: str = "Fleet.Report",
                 fresh: bool = False) -> bool:
        """One bounded synchronous push.  ``fresh=True`` bypasses the
        snapshot cache — the drain path must not ship a pre-drain
        'serving' report that raced the state flip."""
        srv = self._server_ref()
        report = build_load_report(srv) if fresh \
            else report_cache().get(srv)
        return self._call(method, json.dumps(report,
                                             default=str).encode("utf-8"))

    def deregister_now(self) -> bool:
        srv = self._server_ref()
        inst = _instance_of(srv)
        if not inst:
            return False
        return self._call("Fleet.Deregister", inst.encode("utf-8"))

    def start(self) -> None:
        if self._thread is not None:
            return
        record_event("fleet_register", self.registry_addr)
        self.push_now("Fleet.Register")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-reporter")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            if not _live[0]:
                continue
            try:
                self.push_now()
            except Exception as e:     # never let the loop die silently
                LOG.warning("fleet reporter: %s", e)

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)


def attach_reporter(server, registry_addr: str,
                    interval_s: Optional[float] = None) -> FleetReporter:
    """Create + start this server's fleet reporter (idempotent per
    server — re-attach replaces)."""
    old = _reporters.get(server)
    if old is not None:
        old.stop()
    rep = FleetReporter(server, registry_addr, interval_s=interval_s)
    _reporters[server] = rep
    rep.start()
    return rep


def reporter_of(server) -> Optional[FleetReporter]:
    return _reporters.get(server)


# ---------------------------------------------------------------------------
# Server lifecycle wiring (server.py calls these, lazily imported)
# ---------------------------------------------------------------------------

def on_server_start(server) -> None:
    record_event("fleet_restart", _instance_of(server))


def on_server_drain(server) -> None:
    """Drain visibility within ONE report interval: record the drain
    (+ lame-duck) events, push a final report that already says
    ``draining``, then deregister — all bounded (1s RPC timeouts), so
    the drain grace budget is not consumed by observability."""
    inst = _instance_of(server)
    record_event("fleet_drain", inst)
    if getattr(server, "lame_duck_signal_on", False):
        record_event("fleet_lame_duck", inst)
    rep = _reporters.get(server)
    if rep is None:
        return
    # the cadence loop dies FIRST — a queued push of a pre-drain
    # 'serving' report after the deregister would flip the registry
    # right back to ok
    rep.stop()
    try:
        rep.push_now(fresh=True)
        rep.deregister_now()
        record_event("fleet_deregister", rep.registry_addr)
    except Exception as e:
        LOG.info("fleet drain dereg: %s", e)


def on_server_stop(server) -> None:
    record_event("fleet_stop", _instance_of(server))
    rep = _reporters.pop(server, None)
    if rep is not None:
        rep.stop()


# ---------------------------------------------------------------------------
# /vars + /metrics exposure
# ---------------------------------------------------------------------------

# the registry a /vars reader should describe: the most recently hosted
# one in this process (tests host several; last wins, weakly held)
_registry_ref = lambda: None            # noqa: E731 — rebound by _note_registry


def _note_registry(reg: FleetRegistry) -> None:
    global _registry_ref
    _registry_ref = weakref.ref(reg)


def _member_state_rows() -> Dict[str, int]:
    reg = _registry_ref()
    return reg.member_counts() if reg is not None \
        else {s: 0 for s in FLEET_MEMBER_STATES}


_events_var = PassiveDimension(("event",), event_counters,
                               name="fleet_events_total")
_members_var = PassiveDimension(("state",), _member_state_rows,
                                name="fleet_members")
_report_builds_var = PassiveStatus(
    lambda: report_cache().builds, name="fleet_report_builds")

_FLEET_VARS = (
    (_events_var, "fleet_events_total"),
    (_members_var, "fleet_members"),
    (_report_builds_var, "fleet_report_builds"),
)


def expose_fleet_variables() -> None:
    """Re-expose after a test registry wipe (``Variable.expose`` is a
    no-op while the name is still registered)."""
    for var, name in _FLEET_VARS:
        var.expose(name)


def _reset_for_tests(ring: Optional[int] = None) -> None:
    global _events, _report_cache, _registry_ref
    for k in _ev_counts:
        _ev_counts[k] = 0
    _events = deque(maxlen=int(ring) if ring
                    else int(get_flag("fleet_events_ring")))
    with _report_cache_lock:
        _report_cache = None
    _registry_ref = lambda: None
    _live[0] = bool(get_flag("fleet_obs"))
    expose_fleet_variables()
