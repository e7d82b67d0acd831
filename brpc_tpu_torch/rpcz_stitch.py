"""Distributed rpcz — cross-process trace stitching.

A traced multi-chip fan-out leaves its spans scattered across
processes: the caller holds the root and one client span per branch
(each knowing its branch's ``remote_side``), every sub-server holds
the matching server span.  Per-process ``/rpcz`` cannot show that tree
— this module can:

- :func:`collect_trace` starts from the local SpanStore and follows
  client spans' ``remote_side`` over plain HTTP
  (``/rpcz?trace_id=X&format=json``) to pull each sub-process's spans,
  breadth-first with a hop budget, deduplicating by span id (span ids
  are random-seeded per process — see rpcz._span_seq — so cross-rank
  collisions are negligible).
- :func:`annotate_skew` flags wall-clock skew: a child that appears to
  START before its parent's receive time is physically impossible, so
  the child is tagged ``clock_skew_us`` instead of silently
  mis-ordering the tree.  Spans also carry a CLOCK_MONOTONIC anchor
  (``mono_ns``) — comparable across processes of ONE host — for
  external tools that want exact same-host ordering.
- :func:`build_tree` nests span ids under their parents (children
  ordered by receive time).
- :func:`to_chrome_trace` emits Chrome trace-event JSON that loads
  directly in Perfetto / chrome://tracing, one "process" track per
  source process.
- :func:`render_tree_text` draws the tree for the /rpcz portal page.

The collector is deliberately transport-simple (http.client, bounded
timeouts, best-effort per remote): stitching is an operator query, not
a serving-path dependency.

A copy of ``brpc_tpu/rpcz_stitch.py``: ``fetch_remote_spans`` and
``locate_trace_root`` GET ``/rpcz`` and ``/fleet`` from a peer's builtin
portal, which every port server serves on its port;
:func:`collect_trace`'s ``fetch=`` hook takes any other source of a
peer's ``describe()`` dicts.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional

from .butil.logging_util import LOG
from .rpcz import global_span_store

# bounded fan-out: a trace that crossed more processes than this is
# truncated (noted in the result) rather than holding the portal open
DEFAULT_MAX_HOPS = 16
# ... and bounded WALL CLOCK: the worst case is not hop count but dead
# peers (each SYN-blackholed fetch waits out its full timeout), so the
# whole walk shares one budget — max_hops dead remotes must not hold
# the /rpcz handler (and, on an inline native server, its engine loop)
# for max_hops * timeout_s seconds
DEFAULT_BUDGET_S = 8.0


def fetch_remote_spans(remote: str, trace_id: int,
                       timeout_s: float = 2.0,
                       limit: int = 512) -> List[Dict]:
    """One hop of the collector: GET the peer's local span list for
    ``trace_id`` from its builtin portal.  Raises on transport errors —
    the caller decides whether a missing peer kills the stitch."""
    import http.client
    host, _, port = remote.rpartition(":")
    conn = http.client.HTTPConnection(host or "127.0.0.1", int(port),
                                      timeout=timeout_s)
    try:
        conn.request("GET", f"/rpcz?trace_id={trace_id:x}&format=json"
                            f"&limit={int(limit)}")
        resp = conn.getresponse()
        if resp.status != 200:
            raise ConnectionError(f"/rpcz on {remote}: HTTP {resp.status}")
        return json.loads(resp.read()).get("spans", [])
    finally:
        conn.close()


def locate_trace_root(fleet: str, trace_id: int,
                      timeout_s: float = 2.0) -> List[str]:
    """Ask a fleet registry host which member(s) report the ROOT span
    of ``trace_id`` (the /fleet trace index, fed by every member's
    load report).  Before this, a stitch could only BFS from a process
    that already held part of the trace — now any process can start
    from the registry and land on the root holder directly.  Raises on
    transport errors; returns [] when no member claims the root (TTL'd
    out of the members' bounded root lists, or never traced)."""
    import http.client
    host, _, port = str(fleet).rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout_s)
    try:
        conn.request("GET", f"/fleet?trace_id={trace_id:x}")
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"/fleet on {fleet}: HTTP {resp.status}")
        return list(json.loads(data.decode("utf-8",
                                           "replace")).get("owners", []))
    finally:
        conn.close()


def collect_trace_via_fleet(fleet: str, trace_id: int,
                            **kwargs) -> Dict:
    """Fleet-seeded stitch: locate the root-holding member(s) through
    the registry's trace index, then run :func:`collect_trace` with
    those instances pre-seeded on the BFS frontier (the local store
    still contributes whatever it holds).  A dead or index-less
    registry degrades to the plain local-seeded walk."""
    try:
        seeds = locate_trace_root(fleet, trace_id,
                                  timeout_s=kwargs.get("timeout_s", 2.0))
    except Exception as e:
        LOG.warning("rpcz stitch: fleet index %s failed: %s", fleet, e)
        seeds = []
    return collect_trace(trace_id, seed_remotes=seeds, **kwargs)


def collect_trace(trace_id: int, limit: int = 512,
                  max_hops: int = DEFAULT_MAX_HOPS,
                  timeout_s: float = 2.0,
                  budget_s: float = DEFAULT_BUDGET_S,
                  fetch: Callable = fetch_remote_spans,
                  skip=(), seed_remotes=()) -> Dict:
    """Stitch one trace across processes.

    Returns ``{"spans": [describe-dicts + "source"], "remotes":
    {remote: "ok" | error}, "truncated": bool}``.  Local spans seed the
    walk; every client span's ``remote_side`` is fetched once (BFS),
    and spans fetched from a remote can add further remotes (deeper
    call trees).  A dead peer degrades to a partial stitch with the
    failure recorded, never an exception.  ``budget_s`` caps the walk's
    TOTAL wall clock (per-fetch timeouts are clamped to what remains);
    exceeding it truncates like ``max_hops`` does.

    ``skip``: addresses whose spans are ALREADY in the local store —
    the /rpcz handler passes its own listen address so a stitch
    launched from inside a traced process never RPCs itself (on a
    single-loop inline server that self-call would wait out its own
    timeout: the handler occupies the loop the fetch needs).

    ``seed_remotes``: addresses to place on the BFS frontier BEFORE
    any local client span is followed — the fleet trace index's way of
    starting the walk at the root-holding process
    (:func:`collect_trace_via_fleet`)."""
    spans: Dict[int, Dict] = {}

    def _ingest(records, source: str) -> List[str]:
        new_remotes = []
        for rec in records:
            sid = rec.get("span_id")
            if not isinstance(sid, int) or sid in spans:
                continue
            rec = dict(rec)
            rec["source"] = source
            spans[sid] = rec
            if rec.get("side") == "client" and rec.get("remote"):
                new_remotes.append(rec["remote"])
        return new_remotes

    frontier = list(seed_remotes)
    frontier += _ingest(
        [s.describe() for s in
         global_span_store().by_trace(trace_id, limit)], "local")
    visited = set(str(a) for a in skip)
    remotes: Dict[str, str] = {a: "self" for a in visited}
    truncated = False
    hops = 0
    deadline = time.monotonic() + max(0.1, budget_s)
    while frontier:
        remote = frontier.pop(0)
        if remote in visited:
            continue
        visited.add(remote)
        hops += 1
        left = deadline - time.monotonic()
        if hops > max_hops or left <= 0:
            truncated = True
            break
        try:
            fetched = fetch(remote, trace_id,
                            timeout_s=min(timeout_s, left),
                            limit=limit)
        except Exception as e:            # partial stitch beats no stitch
            LOG.warning("rpcz stitch: fetching %s failed: %s", remote, e)
            remotes[remote] = f"{type(e).__name__}: {e}"
            continue
        remotes[remote] = "ok"
        frontier.extend(_ingest(fetched, remote))
    out = sorted(spans.values(), key=lambda r: r.get("received_us", 0))
    annotate_skew(out)
    return {"spans": out, "remotes": remotes, "truncated": truncated}


def annotate_skew(spans: List[Dict]) -> None:
    """Tag children whose receive time precedes their parent's: across
    hosts the wall clocks are not one clock, and a stitched tree that
    silently re-ordered such spans would lie.  Mutates the dicts —
    adds ``clock_skew_us`` (how far into the past the child appears to
    have started relative to its parent)."""
    by_id = {s["span_id"]: s for s in spans if "span_id" in s}
    for s in spans:
        parent = by_id.get(s.get("parent_span_id") or 0)
        if parent is None:
            continue
        skew = parent.get("received_us", 0) - s.get("received_us", 0)
        if skew > 0:
            s["clock_skew_us"] = skew


def build_tree(spans: List[Dict]) -> List[Dict]:
    """Nested ``{"span_id": id, "children": [...]}`` forest: spans
    whose parent is absent (or 0) are roots; children are ordered by
    receive time.  Ids only — the flat span list stays the single copy
    of the data."""
    by_id = {s["span_id"]: s for s in spans if "span_id" in s}
    nodes = {sid: {"span_id": sid, "children": []} for sid in by_id}
    roots = []
    for sid, span in by_id.items():
        parent = span.get("parent_span_id") or 0
        if parent in nodes and parent != sid:
            nodes[parent]["children"].append(nodes[sid])
        else:
            roots.append(nodes[sid])

    def _key(node):
        return by_id[node["span_id"]].get("received_us", 0)

    for node in nodes.values():
        node["children"].sort(key=_key)
    roots.sort(key=_key)
    return roots


def to_chrome_trace(spans: List[Dict]) -> Dict:
    """Chrome trace-event JSON (the ``traceEvents`` object form) —
    loads in Perfetto / chrome://tracing.  One pid per source process,
    one complete ("X") event per span, ids/annotations in ``args``;
    annotations additionally render as instant events on the span's
    track."""
    events = []
    pids: Dict[str, int] = {}
    for s in spans:
        src = str(s.get("source", "local"))
        pid = pids.get(src)
        if pid is None:
            pid = pids[src] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": src}})
        tid = int(s.get("span_id", 0))
        args = {
            "trace_id": s.get("trace_id"),
            "span_id": s.get("span_id"),
            "parent_span_id": s.get("parent_span_id"),
            "error_code": s.get("error_code", 0),
            "request_size": s.get("request_size", 0),
            "response_size": s.get("response_size", 0),
            "remote": s.get("remote", ""),
        }
        if "clock_skew_us" in s:
            args["clock_skew_us"] = s["clock_skew_us"]
        events.append({
            "ph": "X",
            "name": f"{s.get('side', '?')} {s.get('method', '?')}",
            "cat": s.get("side", "span"),
            "ts": s.get("received_us", 0),
            "dur": max(1, int(s.get("latency_us", 1))),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
        for ann in s.get("annotations", ()):
            events.append({
                "ph": "i", "s": "t",
                "name": str(ann.get("text", ""))[:120],
                "ts": ann.get("us", s.get("received_us", 0)),
                "pid": pid, "tid": tid,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def render_tree_text(spans: List[Dict]) -> str:
    """Human-readable tree for the /rpcz portal page."""
    by_id = {s["span_id"]: s for s in spans if "span_id" in s}
    lines = [f"{len(spans)} span(s)"]

    def _fmt(s: Dict) -> str:
        err = f" ERR={s['error_code']}" if s.get("error_code") else ""
        skew = f" SKEW={s['clock_skew_us']}us" \
            if s.get("clock_skew_us") else ""
        remote = f" -> {s['remote']}" if s.get("remote") else ""
        return (f"{s.get('side', '?'):6s} {s.get('method', '?')}"
                f"{remote}  {s.get('latency_us', 0)}us"
                f"  [{s.get('source', 'local')}]{err}{skew}")

    def _walk(node: Dict, prefix: str, last: bool) -> None:
        tee = "`- " if last else "|- "
        lines.append(prefix + tee + _fmt(by_id[node["span_id"]]))
        child_prefix = prefix + ("   " if last else "|  ")
        kids = node["children"]
        for i, kid in enumerate(kids):
            _walk(kid, child_prefix, i == len(kids) - 1)

    roots = build_tree(spans)
    for i, root in enumerate(roots):
        _walk(root, "", i == len(roots) - 1)
    return "\n".join(lines) + "\n"
