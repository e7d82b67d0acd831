"""Builtin observability portal — HTTP pages on the serving port.

≈ brpc's src/brpc/builtin/ (25 services, server.cpp:464-559):
status, vars, flags (live-set with validator gate), health, connections,
version, prometheus metrics, runtime introspection (sockets/fibers/ids),
and the service index. Handlers return
(status, content_type, body, extra_headers).

A copy of ``brpc_tpu/server/builtin/__init__.py``.  ``/native`` and
``/hotspots/engine`` read the native engine's telemetry when
``ServerOptions.native`` serves the port (the bridge's one cached
snapshot), and answer as a JAX server without the engine otherwise (a
404, no engine loops).  Its ``client_lane`` section is this
process's client completion lane (``transport/client_lane.py``'s
``client_lane_telemetry``: completions, named fallbacks and declines,
bursts) and ``scatter_fallbacks`` the fan-out lane's named fallbacks
(``client/fast_call.py``); both are process-wide.  ``/hotspots/device`` wraps
``profiling.collect_device_trace`` (``torch.profiler``).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Dict, List, Tuple

from ...butil import flags as flags_mod
from ...bvar.prometheus import render_prometheus
from ...bvar.variable import dump_exposed, find_exposed, list_exposed
from ...client.fast_call import scatter_fallback_counters
from ...protocol.http import HttpMessage

Handler = Callable[[object, HttpMessage, List[str]], Tuple]

_routes: Dict[str, Handler] = {}

_START_TIME = time.time()


def register_builtin(prefix: str, handler: Handler) -> None:
    """Register a portal page.  Re-registering a prefix with a
    DIFFERENT handler is almost always an import-order accident (two
    modules claiming one page — the /rpcz JSON contract broke this way
    once): the newest registration wins, loudly, so the shadowed page
    is discoverable instead of silently serving the wrong handler."""
    existing = _routes.get(prefix)
    if existing is not None and existing is not handler:
        from ...butil.logging_util import LOG
        LOG.warning("builtin page %r re-registered: %s replaces %s",
                    prefix or "/", getattr(handler, "__name__", handler),
                    getattr(existing, "__name__", existing))
    _routes[prefix] = handler


def route_builtin(server, msg: HttpMessage):
    parts = [p for p in msg.path.split("/") if p]
    head = parts[0] if parts else ""
    handler = _routes.get(head)
    if handler is None:
        return 404, "text/plain", f"no such page: {msg.path}\n".encode(), []
    out = handler(server, msg, parts[1:])
    if len(out) == 3:
        status, ctype, body = out
        extra: List = []
    else:
        status, ctype, body, extra = out
    if isinstance(body, str):
        body = body.encode()
    return status, ctype, body, extra


# ---- pages ---------------------------------------------------------------

def _index(server, msg, rest):
    lines = ["tpu-rpc server", "=" * 40, "", "services:"]
    for (svc, mth), entry in sorted(server.methods.items()):
        lines.append(f"  /{svc}/{mth}")
    lines += ["", "builtin pages:"]
    for p in sorted(_routes):
        if p:
            lines.append(f"  /{p}")
    return 200, "text/plain", "\n".join(lines) + "\n"


def _health(server, msg, rest):
    # drain-state observability: a load balancer polling /health sees
    # 503 + x-lame-duck the moment drain starts and takes the node out
    # of rotation — kubernetes-readiness-probe shaped (the header rides
    # even with enable_lame_duck off; the health poll IS the poll-based
    # spelling of the signal)
    if getattr(server, "draining", False):
        return 503, "text/plain", "draining\n", [("x-lame-duck", "1")]
    return 200, "text/plain", "OK\n"


def _version(server, msg, rest):
    from ... import __version__
    return 200, "text/plain", f"tpu-rpc/{__version__} {server.version}\n"


def _status(server, msg, rest):
    from ...fiber.runtime import global_runtime

    rt = global_runtime()
    out = {
        "uptime_s": round(time.time() - _START_TIME, 1),
        "listen": str(server.listen_endpoint),
        "connections": server.connection_count(),
        "inflight_requests": server.inflight,
        "fiber_workers": rt.worker_count,
        "fiber_pending": rt.pending_count,
        # operability plane: drain phase + what the drain still waits
        # for (the rolling-restart operator's watch keys)
        "drain_phase": getattr(server, "drain_phase", "serving"),
        "drain_inflight_remaining": server.inflight
        if getattr(server, "draining", False) else 0,
        "drain_force_closed": getattr(server, "drain_force_closed", 0),
        "services": {},
    }
    for (svc, mth), entry in sorted(server.methods.items()):
        st = entry.status
        out["services"][f"{svc}.{mth}"] = {
            "count": st.latency.count(),
            "qps": round(st.latency.qps(), 1),
            "latency_us_p50": round(st.latency.p50(), 1),
            "latency_us_p99": round(st.latency.p99(), 1),
            "errors": st.errors.get_value(),
            "inflight": st.inflight,
            # the limit admission actually enforces: an installed
            # adaptive limiter's LIVE value (a static 0 next to an
            # AutoLimiter used to read as "unlimited")
            "max_concurrency": st.live_max_concurrency(),
            "concurrency_limiter": st.limiter_kind(),
        }
    return 200, "application/json", json.dumps(out, indent=1)


def _vars(server, msg, rest):
    q = msg.query()
    if "expand" in q:
        # live trend graph (≈ the reference portal's flot charts): the
        # first request starts 1Hz recording; refreshes show the curve
        from ...bvar.trend import render_sparkline_svg, track
        name = q["expand"]
        t = track(name)
        if t is None:
            return 404, "text/plain", f"no var {name}\n"
        v = find_exposed(name)
        svg = render_sparkline_svg(list(t.ring))
        return (200, "text/html",
                f"<html><body style='font:13px monospace'>"
                f"<h3>{name} = {v.describe()}</h3>{svg}"
                f"<p><a href=''>refresh</a> · <a href='/vars'>all vars"
                f"</a></p></body></html>")
    if rest:
        v = find_exposed(rest[0])
        if v is None:
            return 404, "text/plain", f"no var {rest[0]}\n"
        return 200, "text/plain", f"{rest[0]} : {v.describe()}\n"
    filt = q.get("filter", "")
    dump = dump_exposed(filt)
    body = "".join(f"{k} : {v}\n" for k, v in sorted(dump.items()))
    return 200, "text/plain", body


def _metrics(server, msg, rest):
    if msg.query().get("fleet") == "1":
        # federation view: every live member's families merged under
        # an instance label (registry hosts only; one scrape sweep per
        # interval — the cache inside federate())
        from ... import fleet as fleet_mod
        reg = fleet_mod.registry_of(server)
        if reg is None:
            return 404, "text/plain", "no fleet registry on this server\n"
        return 200, "text/plain; version=0.0.4", reg.federate()
    return 200, "text/plain; version=0.0.4", render_prometheus()


def _flags(server, msg, rest):
    q = msg.query()
    if rest:
        f = next((x for x in flags_mod.list_flags() if x.name == rest[0]),
                 None)
        if f is None:
            return 404, "text/plain", f"no flag {rest[0]}\n"
        if "setvalue" in q:
            if not flags_mod.set_flag(f.name, q["setvalue"]):
                return 403, "text/plain", \
                    f"flag {f.name} is not settable to {q['setvalue']!r}\n"
            return 200, "text/plain", \
                f"{f.name} set to {f.value!r}\n"
        return 200, "text/plain", _flag_line(f)
    body = "".join(_flag_line(f) for f in flags_mod.list_flags())
    return 200, "text/plain", body


def _flag_line(f) -> str:
    mark = " (R)" if f.reloadable else ""
    return f"{f.name}={f.value!r} default={f.default!r}{mark}  # {f.help}\n"


def _connections(server, msg, rest):
    """/connections — the connections the server's acceptors (and its
    native engine) hold, and the live sockets of the process."""
    from ...transport.socket import socket_pool

    out = {
        "server_connections": server.connection_count(),
        "socket_slots": len(socket_pool()),
    }
    return 200, "application/json", json.dumps(out, indent=1)


def _fibers(server, msg, rest):
    from ...fiber.runtime import global_runtime

    rt = global_runtime()
    return 200, "application/json", json.dumps({
        "workers": rt.worker_count,
        "pending": rt.pending_count,
        "concurrency": rt.concurrency,
    }, indent=1)


def _list_vars(server, msg, rest):
    return 200, "application/json", json.dumps(list_exposed())


def _rpcz(server, msg, rest):
    """/rpcz — span browser + distributed trace queries.

    Query modes:
      (none)                       recent local spans (JSON)
      ?trace_id=HEX&format=json    this process's spans of one trace —
                                   the stitcher's per-hop fetch; always
                                   bounded by &limit (never the full
                                   store in one response)
      ?trace_id=HEX&stitch=1       follow client spans' remote_side
                                   over RPC and merge the sub-process
                                   spans (clock skew annotated); render
                                   as JSON (+ nested tree), as
                                   format=chrome (Perfetto-loadable
                                   Chrome trace events), or as
                                   format=tree (text tree)
      ?start_us=&end_us=&persisted=1   sqlite time-range browse (dead
                                   ranks included), paged by &limit and
                                   the start_us/end_us cursor
    """
    from ...rpcz import (browse_persisted, global_span_store,
                         rpcz_enabled)

    store = global_span_store()
    q = msg.query()
    try:
        limit = max(1, int(q.get("limit", "100")))
    except ValueError:
        return 400, "text/plain", "bad limit (integer)\n"
    fmt = q.get("format", "json")
    tid = 0
    if "trace_id" in q:
        try:
            tid = int(q["trace_id"], 16)
        except ValueError:
            return 400, "text/plain", "bad trace_id (hex)\n"
    if "start_us" in q or "end_us" in q or "persisted" in q:
        # time-range browse over the sqlite mirrors (rpcz_dir) — covers
        # spans of DEAD processes too (≈ the reference's leveldb-backed
        # time browsing, span.cpp:306-319).  ``limit`` + the
        # start_us/end_us cursor page the 200K-row mirror; a stitcher
        # (or any scraper) can never pull the whole db in one response.
        try:
            start_us = int(q.get("start_us", "0"))
            end_us = int(q.get("end_us", "0"))
        except ValueError:
            return 400, "text/plain", "bad start_us/end_us (integer)\n"
        store.flush_now()          # what's pending is browsable now
        return 200, "application/json", json.dumps({
            "enabled": rpcz_enabled(),
            "persisted": True,
            "spans": browse_persisted(start_us, end_us, limit, tid),
        }, indent=1)
    if tid:
        from ...rpcz_stitch import (annotate_skew, build_tree,
                                    render_tree_text, to_chrome_trace)
        if "stitch" in q:
            from ...rpcz_stitch import collect_trace
            try:
                hops = max(1, int(q.get("max_hops", "16")))
                budget_s = float(q.get("budget_s", "8"))
            except ValueError:
                return (400, "text/plain",
                        "bad max_hops (integer) / budget_s (number)\n")
            stitched = collect_trace(
                tid, limit=limit, max_hops=hops, budget_s=budget_s,
                # never RPC ourselves: our spans ARE the local seed
                skip=(str(server.listen_endpoint),))
            spans = stitched["spans"]
            extra = {"stitched": True, "remotes": stitched["remotes"],
                     "truncated": stitched["truncated"]}
        else:
            spans = [s.describe() for s in store.by_trace(tid, limit)]
            for s in spans:
                s["source"] = "local"
            annotate_skew(spans)
            extra = {"stitched": False}
        if fmt == "chrome":
            return (200, "application/json",
                    json.dumps(to_chrome_trace(spans)))
        if fmt == "tree":
            return (200, "text/plain",
                    f"trace {tid:x} — " + render_tree_text(spans))
        out = {"enabled": rpcz_enabled(), "trace_id": f"{tid:x}",
               "spans": spans, "tree": build_tree(spans)}
        out.update(extra)
        return 200, "application/json", json.dumps(out, indent=1)
    spans = store.recent(limit)
    return 200, "application/json", json.dumps({
        "enabled": rpcz_enabled(),
        "spans": [s.describe() for s in reversed(spans)],
    }, indent=1)


def _hist_view(buckets, count, total) -> Dict:
    """Portal rendering of one engine histogram: non-empty buckets
    keyed by exclusive upper bound, plus count/avg."""
    from ...transport.native_bridge import bucket_label
    view = {bucket_label(i, len(buckets)): n
            for i, n in enumerate(buckets) if n}
    return {
        "count": count,
        "avg": round(total / count, 1) if count else 0,
        "buckets": view,
    }


def _client_lane_view() -> Dict:
    """The client lane's section of ``/native`` (empty when no
    connection ever asked for the lane)."""
    from ...transport.client_lane import client_lane_telemetry
    cl = client_lane_telemetry()
    if "completions" not in cl:
        return {"declined": cl["declined"]} if cl else {}
    return {
        "completions": cl.get("completions", 0),
        "fallback_total": cl.get("fallback_total", 0),
        "fallbacks": {k: v for k, v in cl.get("fallbacks", {}).items()
                      if v},
        "declined": {k: v for k, v in cl.get("declined", {}).items() if v},
        "bursts": cl.get("bursts", 0),
        "attached": cl.get("attached", 0),
        "acks": cl.get("acks", 0),
        "demux_loops": cl.get("demux_loops", 1),
        "loops": cl.get("loops", []),
        "completions_per_burst": _hist_view(
            cl["comp_burst"], cl["comp_burst_count"],
            cl["comp_burst_sum"]),
    }


def _native(server, msg, rest):
    """/native — the native engine's always-on telemetry table: per-lane
    stage histograms (queue = frame parse -> batched shim entry, shim =
    dispatch time, resid = parse -> response build), burst/writev
    coalescing distributions, reason-coded fallback counters with the
    top reasons per route/method, loop busy ratios and high-water
    marks.  One engine.telemetry() snapshot renders the whole page."""
    bridge = getattr(server, "_native_bridge", None)
    if bridge is None:
        return (404, "text/plain",
                "this server has no native engine (ServerOptions.native"
                " is off)\n")
    t = bridge.telemetry.get()
    lanes = {}
    for ln, d in t["lanes"].items():
        lanes[ln] = {
            "handled": d["handled"],
            "errors": d["errors"],
            "queue_us": _hist_view(d["queue_us"], d["queue_us_count"],
                                   d["queue_us_sum"]),
            "shim_us": _hist_view(d["shim_us"], d["shim_us_count"],
                                  d["shim_us_sum"]),
            "resid_us": _hist_view(d["resid_us"], d["resid_us_count"],
                                   d["resid_us_sum"]),
        }
    top_fallbacks = sorted(
        ((k, v) for k, v in t["fallbacks"].items() if v),
        key=lambda kv: -kv[1])

    def _per_target(table):
        out = {}
        for name, d in sorted(table.items()):
            fbs = sorted(((k[3:], v) for k, v in d.items()
                          if k.startswith("fb_") and v),
                         key=lambda kv: -kv[1])
            row = {"handled": d["handled"], "errors": d["errors"]}
            if fbs:
                row["top_fallbacks"] = dict(fbs)
            out[name] = row
        return out

    # per-loop view: lifetime busy ratio plus the placement counters
    # (accepts = conns pinned by this loop, frames = messages it parsed,
    # handoffs = cross-loop completion nodes it consumed, spin_polls =
    # busy-poll harvests); the windowed ratios come from the cache
    windowed = bridge.telemetry.per_loop_busy_ratios()
    loops = []
    for i, lo in enumerate(t["loops"]):
        denom = lo["busy_ns"] + lo["idle_ns"]
        loops.append({
            "busy_ratio": round(lo["busy_ns"] / denom, 4) if denom
            else 0.0,
            "busy_ratio_windowed": round(windowed[i], 4)
            if i < len(windowed) else 0.0,
            "busy_ms": round(lo["busy_ns"] / 1e6, 1),
            "idle_ms": round(lo["idle_ns"] / 1e6, 1),
            "polls": lo["polls"],
            "spin_polls": lo.get("spin_polls", 0),
            "accepts": lo.get("accepts", 0),
            "frames": lo.get("frames", 0),
            "handoffs": lo.get("handoffs", 0),
        })
    from ...deadline import shed_counters
    # the kind-5 lane: streams open, chunk flow both directions, the
    # chunks-per-burst distribution and credit stalls, plus the closed
    # per-reason fallback table
    st = t.get("streams", {})
    streaming = {}
    if st:
        streaming = {
            "open": st.get("open", 0),
            "chunks_in": st.get("chunks_in", 0),
            "chunks_out": st.get("chunks_out", 0),
            "chunk_bytes_out": st.get("chunk_bytes_out", 0),
            "feedbacks_in": st.get("feedbacks_in", 0),
            "credit_stalls": st.get("credit_stalls", 0),
            "write_batches": st.get("write_batches", 0),
            "chunks_per_burst": _hist_view(
                st["chunk_burst"], st["chunk_burst_count"],
                st["chunk_burst_sum"]),
            "fallbacks": {k: v for k, v in st.get("fallbacks",
                                                  {}).items() if v},
        }
    out = {
        "lanes": lanes,
        "fallbacks": dict(top_fallbacks),
        "streaming": streaming,
        "client_lane": _client_lane_view(),
        "scatter_fallbacks": scatter_fallback_counters(),
        # deadline plane: per-(lane, method) doomed-work sheds
        "deadline_sheds": {f"{lane}|{method}": v for (lane, method), v
                           in sorted(shed_counters().items())},
        "burst": _hist_view(t["burst"], t["burst_count"],
                            t["burst_sum"]),
        "writev_iov": _hist_view(t["writev_iov"], t["writev_iov_count"],
                                 t["writev_iov_sum"]),
        "wq_hwm": t["wq_hwm"],
        "inbuf_hwm": t["inbuf_hwm"],
        # max−min of the windowed per-loop busy ratios (0 on a one-loop
        # engine) — the native_engine_loop_busy_imbalance bvar
        "loop_busy_imbalance": round(
            bridge.telemetry.loop_busy_imbalance(), 4),
        "loops": loops,
        "methods": _per_target(t["methods"]),
        "routes": _per_target(t["routes"]),
    }
    return 200, "application/json", json.dumps(out, indent=1)


def _lm(server, msg, rest):
    """/lm — the serving-plane telemetry page: live decode
    sessions, recently finished session timelines, per-tier TTFT/ITL
    percentiles and SLO attainment, the batcher step-phase histograms,
    KV pool / prefix cache / host tier occupancy, and the WINDOWED
    spec-accept and prefix-hit ratios (current behavior — the lifetime
    cumulative keys stay on the bench/perf_guard plane).  One
    LmTelemetryCache window renders the whole page, same discipline as
    /native's one engine snapshot."""
    from ...models import lm_telemetry as lmt

    lm = None
    for (svc, mth), entry in sorted(server.methods.items()):
        if mth == "Decode" and hasattr(entry.service, "batcher"):
            lm = entry.service
            break
    cache = lmt.telemetry_cache()
    prev, cur, dt = cache.window()
    phases = {}
    for p, buckets in cur["phase_hists"].items():
        c = cur["phases"][p]
        tot = cur["phase_ns"][p]
        phases[p] = {
            "count": c,
            "avg_us": round(tot / c / 1e3, 1) if c else 0,
            "buckets_ns": {lmt.bucket_label(i): n
                           for i, n in enumerate(buckets) if n},
        }
    # scheduler event RATES over the cache window (the counters
    # themselves are on /vars as lm_slo_sched_total)
    sched_rate = {}
    if prev is not None:
        for k, v in cur["sched"].items():
            sched_rate[k] = round((v - prev["sched"].get(k, 0)) / dt, 2)
    # KV occupancy from the batcher that already exists — never
    # CREATE one from an observability page
    bat = getattr(lm, "_batcher", None) if lm is not None else None
    kv = bat.kv_stats() if bat is not None else {}
    out = {
        "live_sessions": cur["live"],
        "recent_sessions": cur["ring"][-32:],
        "ttft_ms": {f"{t}|{q}": v
                    for (t, q), v in sorted(cur["ttft_ms"].items())},
        "itl_ms": {f"{t}|{q}": v
                   for (t, q), v in sorted(cur["itl_ms"].items())},
        "slo_attained_total": {f"{t}|{v}": n for (t, v), n
                               in sorted(cur["slo"].items())},
        "phases": phases,
        "windowed": {
            "window_s": round(dt, 3),
            "spec_accept_rate":
                round(lmt.windowed_spec_accept_rate(cache), 4),
            "prefix_cache_hit_ratio":
                round(lmt.windowed_prefix_hit_ratio(cache), 4),
            "sched_rate_per_s": sched_rate,
        },
        "lifetime": {
            "spec_accept_rate":
                round(lmt.lifetime_spec_accept_rate(), 4),
            "prefix_cache_hit_ratio":
                round(lmt.lifetime_prefix_hit_ratio(), 4),
        },
        "sched": cur["sched"],
        "spec": cur["spec"],
        "prefix_events": cur["prefix_events"],
        "kv": kv,
        "timeline_ring": {"len": lmt.ring_len(),
                          "max": lmt.ring_maxlen()},
        "enabled": lmt.telemetry_enabled(),
    }
    return 200, "application/json", json.dumps(out, indent=1)


def _overload(server, msg, rest):
    """/overload — the admission plane's live state: per-(tenant,
    verdict) admission counters (closed verdict enum, no "unknown"
    bucket), per-tenant in-flight concurrency, the fair-admission
    configuration, per-method CoDel queue state, and every method's
    LIVE concurrency limit (adaptive limiters report their current
    value, not the static field)."""
    from ...butil.flags import get_flag
    from ..admission import admission_counters, tenant_inflight_snapshot

    ctl = server.admission
    methods = {}
    for (svc, mth), entry in sorted(server.methods.items()):
        st = entry.status
        methods[f"{svc}.{mth}"] = {
            "limiter": st.limiter_kind(),
            "max_concurrency": st.live_max_concurrency(),
            "inflight": st.inflight,
        }
    lim = server.server_limiter()
    mc = server.options.max_concurrency
    out = {
        "admission_total": {f"{t}|{v}": n for (t, v), n
                            in sorted(admission_counters().items())},
        "tenant_inflight": tenant_inflight_snapshot(),
        "fair_admission": {
            "enabled": bool(get_flag("enable_fair_admission", True)),
            "capacity": getattr(server.options, "tenant_fair_capacity",
                                0),
            "weights": dict(getattr(server.options, "tenant_weights",
                                    None) or {}),
        },
        "codel": {
            "enabled": bool(get_flag("enable_codel_shed", False)),
            "target_ms": get_flag("overload_codel_target_ms", 5.0),
            "interval_ms": get_flag("overload_codel_interval_ms", 100.0),
            "methods": ctl.codel_state(),
        },
        "server": {
            "max_concurrency": mc if isinstance(mc, int) else str(mc),
            "limiter": getattr(lim, "kind", None) if lim is not None
            else None,
            "live_limit": lim.max_concurrency() if lim is not None
            else (mc if isinstance(mc, int) else 0),
            "inflight": server.inflight,
        },
        "methods": methods,
    }
    return 200, "application/json", json.dumps(out, indent=1)


def _hotspots(server, msg, rest):
    """/hotspots/{cpu,contention,growth,heap,device,engine} — profilers.
    ≈ hotspots_service.cpp:35-40 (CPU/heap/growth/contention); device
    traces are the accelerator addition (a ``torch.profiler`` capture);
    engine would sample the C++ loops, which the port does not have."""
    from ...fiber.runtime import blocking

    q = msg.query()
    try:
        seconds = min(120.0, max(0.1, float(q.get("seconds", "5"))))
    except ValueError:
        return 400, "text/plain", "bad seconds\n"
    kind = rest[0] if rest else "cpu"
    with blocking():
        return _hotspots_run(server, q, kind, seconds)


def _hotspots_run(server, q, kind, seconds):
    """Profiler window bodies sleep for ``seconds`` — run under the
    fiber runtime's blocking() mark so the pool compensates."""
    from ... import profiling
    if kind == "cpu":
        try:
            hz = min(999, max(1, int(q.get("hz", "99"))))
        except ValueError:
            return 400, "text/plain", "bad hz\n"
        prof = profiling.sample_cpu(seconds=seconds, hz=hz)
        view = q.get("view", "flame")
        if view == "folded":
            return 200, "text/plain", profiling.render_folded(prof.folded)
        if view == "flat":
            return 200, "text/plain", profiling.render_flat(prof.folded)
        return 200, "text/html", profiling.render_flame_html(
            prof.folded,
            title=f"cpu profile — {seconds:.0f}s @ {hz}Hz "
                  f"({prof.samples} samples)")
    if kind == "contention":
        return 200, "text/plain", profiling.collect_contention(seconds)
    if kind == "growth":
        return 200, "text/plain", profiling.collect_growth(seconds)
    if kind == "heap":
        return 200, "text/plain", profiling.collect_heap()
    if kind == "engine":
        # C++ loop busy ratio over a sampled window: the engine loops
        # never appear in the Python-thread samplers above, yet they
        # are the data plane — time in callbacks vs epoll_wait is
        # their whole hotspot story
        bridge = getattr(server, "_native_bridge", None)
        if bridge is None:
            return (200, "text/plain",
                    "no native engine loops on this server\n")
        a = bridge.engine.telemetry()["loops"]
        time.sleep(seconds)
        b = bridge.engine.telemetry()["loops"]
        lines = [f"native engine loops — {seconds:.1f}s window",
                 f"{'loop':>4} {'busy_ratio':>10} {'busy_ms':>9} "
                 f"{'idle_ms':>9} {'polls':>7}"]
        stuck = False
        for i, (la, lb) in enumerate(zip(a, b)):
            busy = lb["busy_ns"] - la["busy_ns"]
            idle = lb["idle_ns"] - la["idle_ns"]
            polls = lb["polls"] - la["polls"]
            denom = busy + idle
            # a loop that never re-entered epoll_wait during the window
            # spent ALL of it inside one callback (on an inline server
            # that includes the callback rendering this very page)
            ratio = busy / denom if denom else 1.0
            if denom == 0:
                stuck = True
            lines.append(
                f"{i:>4} {ratio:>10.4f} "
                f"{busy / 1e6:>9.1f} {idle / 1e6:>9.1f} {polls:>7}")
        if stuck:
            lines.append("(0-poll loop: the whole window ran inside a "
                         "single callback — on usercode_inline servers "
                         "this request itself occupies its loop)")
        return 200, "text/plain", "\n".join(lines) + "\n"
    if kind == "device":
        try:
            data, name = profiling.collect_device_trace(seconds)
        except Exception as e:
            return 500, "text/plain", f"device trace failed: {e}\n"
        return (200, "application/gzip", data,
                [("content-disposition", f"attachment; filename={name}")])
    return (404, "text/plain",
            "hotspots profilers: /hotspots/cpu?seconds=5&hz=99"
            "[&view=flame|flat|folded], /hotspots/contention?seconds=5, "
            "/hotspots/growth?seconds=5, /hotspots/heap, "
            "/hotspots/device?seconds=3, /hotspots/engine?seconds=5 "
            "(C++ loop busy ratio)\n")


def _sockets(server, msg, rest):
    """/sockets — live socket table (≈ builtin/sockets_service.cpp), and
    what the event dispatcher watches and each acceptor holds."""
    from ...transport.socket import socket_pool

    lines = [f"{'id':>20} {'remote':<22} {'state':<8} "
             f"{'direct':<7} {'tag':<10} pending_writes", "-" * 80]
    for sid, s in socket_pool().live_items():
        try:
            state = "failed" if s.failed else "ok"
            remote = str(s.remote_side or "-")
            tag = str(getattr(s, "tag", None) or "-")
            direct = "yes" if getattr(s, "direct_read", False) else "no"
            pending = len(getattr(s, "_write_queue", ()) or ())
            lines.append(f"{sid:>20} {remote:<22} {state:<8} "
                         f"{direct:<7} {tag:<10} {pending}")
        except Exception:
            continue
    lines.append(f"\n{len(socket_pool())} live sockets")
    # the port's footer: what the Python transport reads
    from ...transport.event_dispatcher import global_dispatcher
    accs = getattr(server, "acceptors", [])
    lines.append(f"event dispatcher: {global_dispatcher().watched_fds()} "
                 f"descriptors watched; acceptors: "
                 + (", ".join(f"{a.tag or 'main'} "
                              f"{a.connection_count()} connections"
                              for a in accs) or "none"))
    return 200, "text/plain", "\n".join(lines) + "\n"


def _threads(server, msg, rest):
    """/threads — all thread stacks (≈ builtin pstack via
    threads_service.cpp; here sys._current_frames + traceback)."""
    import threading as _threading
    import traceback as _tb

    names = {t.ident: t.name for t in _threading.enumerate()}
    out = []
    for tid, frame in sorted(sys._current_frames().items()):
        out.append(f"--- thread {tid} ({names.get(tid, '?')}) ---")
        out.extend(line.rstrip() for line in _tb.format_stack(frame))
        out.append("")
    return 200, "text/plain", "\n".join(out) + "\n"


def _protobufs(server, msg, rest):
    """/protobufs — service/method schema listing (the reference lists
    registered pb descriptors; here the method registry + request types)."""
    out = {}
    for (svc, mth), entry in sorted(server.methods.items()):
        rt = entry.request_type
        out[f"{svc}.{mth}"] = {
            "request_type": getattr(rt, "__name__", str(rt))
            if rt is not None else "bytes",
            "grpc_streaming": bool(getattr(entry, "grpc_streaming", False)),
            # live limiter value, not the static field: with an
            # adaptive limiter installed the static max_concurrency is
            # 0 and used to (wrongly) report "unlimited" here
            "max_concurrency": entry.status.live_max_concurrency(),
            "concurrency_limiter": entry.status.limiter_kind(),
        }
    return 200, "application/json", json.dumps(out, indent=1)


def _vlog(server, msg, rest):
    """/vlog — inspect/set the framework log level
    (?setlevel=DEBUG|INFO|WARNING|ERROR)."""
    import logging as _logging

    from ...butil.logging_util import LOG as _LOG
    q = msg.query()
    if "setlevel" in q:
        name = q["setlevel"].upper()
        lvl = getattr(_logging, name, None)
        if not isinstance(lvl, int):
            return 400, "text/plain", f"unknown level {name!r}\n"
        _LOG.setLevel(lvl)
        return 200, "text/plain", f"log level set to {name}\n"
    return 200, "text/plain", \
        f"level={_logging.getLevelName(_LOG.level)}  " \
        f"(set with /vlog?setlevel=DEBUG)\n"


def _dir(server, msg, rest):
    """/dir — browse the server's working directory (read-only;
    ≈ builtin/dir_service.cpp)."""
    base = os.path.realpath(os.getcwd())
    target = os.path.realpath(os.path.join(base, *rest))
    if not target.startswith(base):
        return 403, "text/plain", "outside the working directory\n"
    if os.path.isdir(target):
        entries = sorted(os.listdir(target))
        rel = os.path.relpath(target, base)
        lines = [f"{rel if rel != '.' else '.'}/:"]
        for e in entries:
            full = os.path.join(target, e)
            mark = "/" if os.path.isdir(full) else \
                f"  ({os.path.getsize(full)} bytes)"
            lines.append(f"  {e}{mark}")
        return 200, "text/plain", "\n".join(lines) + "\n"
    if os.path.isfile(target):
        if os.path.getsize(target) > (8 << 20):
            return 403, "text/plain", "file too large\n"
        with open(target, "rb") as f:
            return 200, "application/octet-stream", f.read()
    return 404, "text/plain", "no such path\n"


def _trackme(server, msg, rest):
    """/trackme?ver=X — fleet version check-in (≈ trackme.cpp)."""
    from ...trackme import handle_trackme_query
    ver = msg.query().get("ver", "")
    return (200, "application/json",
            json.dumps(handle_trackme_query(ver)))


def _fleet(server, msg, rest):
    """/fleet — the fleet observability portal.

    Query modes:
      (none) / ?format=json   on a registry host: member table (state =
                              ok/draining/stale/seeded, report age,
                              slots/kv/slo/busy from the newest load
                              report), fleet SLO rollups + top-k
                              outliers, and the merged flight-recorder
                              timeline; on a plain member: this node's
                              own report + local event ring
      ?self=1                 this node's own load report (the
                              pull-on-demand path — same build the
                              KV.Probe tail and the cadence push share)
      ?trace_id=HEX           trace-index lookup: which member(s)
                              report the ROOT span of this trace
                              (rpcz_stitch seeds its BFS there)
    """
    from ... import fleet as fleet_mod
    q = msg.query()
    if q.get("self") == "1":
        report = fleet_mod.report_cache().get(server)
        return (200, "application/json",
                json.dumps(report, default=str, indent=1))
    reg = fleet_mod.registry_of(server)
    if "trace_id" in q:
        if reg is None:
            return 404, "text/plain", "no fleet registry on this server\n"
        tid = q["trace_id"].lower()
        return (200, "application/json",
                json.dumps({"trace_id": tid,
                            "owners": reg.trace_owners(tid)}))
    if reg is None:
        body = {"registry": False,
                "self": fleet_mod.report_cache().get(server),
                "events": fleet_mod.recent_events(64)}
        return (200, "application/json",
                json.dumps(body, default=str, indent=1))
    body = {
        "registry": True,
        "ttl_s": reg.ttl_s,
        "members": reg.members(),
        "rollups": reg.rollups(),
        "timeline": reg.timeline(128),
        "trace_index": reg.trace_index(),
    }
    return (200, "application/json",
            json.dumps(body, default=str, indent=1))


register_builtin("trackme", _trackme)
register_builtin("sockets", _sockets)
register_builtin("threads", _threads)
register_builtin("protobufs", _protobufs)
register_builtin("vlog", _vlog)
register_builtin("dir", _dir)
register_builtin("hotspots", _hotspots)
register_builtin("", _index)
register_builtin("index", _index)
register_builtin("health", _health)
register_builtin("version", _version)
register_builtin("status", _status)
register_builtin("vars", _vars)
register_builtin("list_vars", _list_vars)
register_builtin("brpc_metrics", _metrics)
register_builtin("metrics", _metrics)
register_builtin("flags", _flags)
register_builtin("connections", _connections)
register_builtin("fibers", _fibers)
register_builtin("rpcz", _rpcz)
register_builtin("native", _native)
register_builtin("overload", _overload)
register_builtin("lm", _lm)
register_builtin("fleet", _fleet)
