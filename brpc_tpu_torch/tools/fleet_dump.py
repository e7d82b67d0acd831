"""fleet_dump — fetch a fleet registry's /fleet page and render the
member table + merged event timeline (the trace_dump sibling for the
fleet observability plane).

A copy of ``brpc_tpu/tools/fleet_dump.py``, nothing cut; it reads the
port's ``/fleet?format=json`` (``brpc_tpu_torch/fleet.py``).

Point it at the registry host (any server that called
``fleet.host_registry``); plain members answer too, with their own
load report instead of a member table.  The operator one-liners:

    python -m brpc_tpu_torch.tools.fleet_dump host:port
    python -m brpc_tpu_torch.tools.fleet_dump host:port --timeline 50
    python -m brpc_tpu_torch.tools.fleet_dump host:port --json
    python -m brpc_tpu_torch.tools.fleet_dump host:port --self
"""

from __future__ import annotations

import http.client
import json
import sys
from typing import List, Optional


def fetch_fleet(server: str, self_only: bool = False,
                timeout: float = 10.0) -> dict:
    """Parsed /fleet?format=json body (raises on non-200)."""
    host, _, port = server.rpartition(":")
    path = "/fleet?format=json" + ("&self=1" if self_only else "")
    conn = http.client.HTTPConnection(host or "127.0.0.1", int(port),
                                      timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {body[:200]!r}")
        return json.loads(body.decode("utf-8", "replace"))
    finally:
        conn.close()


def _fmt_member(row: dict) -> str:
    rep = row.get("report") or {}
    slots = rep.get("slots") or {}
    busy = rep.get("busy_ratio")
    age = row.get("age_s")
    return (f"{row.get('instance', '?'):<22} "
            f"{row.get('state', '?'):<9} "
            f"{('%.1fs' % age) if age is not None else '-':>8} "
            f"{rep.get('drain', '-'):>9} "
            f"{str(slots.get('live', '-')) + '/' + str(slots.get('total', '-')):>9} "
            f"{rep.get('inflight', '-'):>8} "
            f"{('%.2f' % busy) if busy is not None else '-':>5}")


def render(doc: dict, timeline: int = 20) -> str:
    """Human view of one /fleet JSON document."""
    out: List[str] = []
    if not doc.get("registry"):
        rep = doc.get("self", doc)      # --self answers the bare report
        out.append(f"member {rep.get('instance') or '(unnamed)'} "
                   f"drain={rep.get('drain')} seq={rep.get('seq')}")
        out.append(json.dumps(rep, indent=1, default=str))
        return "\n".join(out)
    members = doc.get("members", [])
    out.append(f"fleet: {len(members)} member(s), "
               f"ttl {doc.get('ttl_s')}s")
    out.append(f"{'instance':<22} {'state':<9} {'age':>8} "
               f"{'drain':>9} {'slots':>9} {'inflight':>8} {'busy':>5}")
    for row in members:
        out.append(_fmt_member(row))
    roll = doc.get("rollups") or {}
    if roll.get("top_busy"):
        out.append("top busy: " + ", ".join(
            f"{r['instance']}={r['busy_ratio']}"
            for r in roll["top_busy"]))
    if roll.get("top_slo_miss"):
        out.append("top slo-miss: " + ", ".join(
            f"{r['instance']}={r['miss_ratio']}"
            for r in roll["top_slo_miss"]))
    rows = (doc.get("timeline") or [])[-timeline:]
    if rows:
        out.append(f"timeline (last {len(rows)}):")
        for ev in rows:
            out.append(f"  {ev.get('wall_s', 0):>14.3f} "
                       f"{ev.get('instance', '?'):<22} "
                       f"{ev.get('event', '?'):<26} "
                       f"{ev.get('detail', '')}")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="dump a fleet registry's member table + merged "
                    "event timeline")
    ap.add_argument("server", help="host:port of the registry host "
                                   "(any member answers with its own "
                                   "report)")
    ap.add_argument("--json", action="store_true",
                    help="raw /fleet JSON instead of the table")
    ap.add_argument("--self", dest="self_only", action="store_true",
                    help="this node's own load report only")
    ap.add_argument("--timeline", type=int, default=20,
                    help="timeline rows to show (default 20)")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)
    try:
        doc = fetch_fleet(args.server, self_only=args.self_only,
                          timeout=args.timeout)
    except Exception as e:
        print(f"fetch failed: {e}", file=sys.stderr)
        return 1
    if args.json:
        sys.stdout.write(json.dumps(doc, indent=1, default=str) + "\n")
        return 0
    sys.stdout.write(render(doc, timeline=args.timeline) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
