"""trace_dump — fetch a distributed trace from a live server and emit
Perfetto-loadable Chrome trace JSON.

A copy of ``brpc_tpu/tools/trace_dump.py``, nothing cut; it reads the
port's ``/rpcz`` (``rpcz_stitch.collect_trace`` and its Chrome
rendering, ``brpc_tpu_torch/rpcz_stitch.py``).

The server does the heavy lifting: ``/rpcz?trace_id=X&stitch=1``
follows the trace's client spans to every sub-process they point at
(rpcz_stitch.collect_trace) and ``format=chrome`` renders the merged
span set as Chrome trace events.  Point this tool at the process
holding the trace's ROOT (usually the original caller): stitching
walks client spans' ``remote_side`` downward, so a sub-server can only
show its own branch.  The operator one-liner:

    python -m brpc_tpu_torch.tools.trace_dump host:port TRACE_ID_HEX
    python -m brpc_tpu_torch.tools.trace_dump host:port dead0 -o trace.json
    python -m brpc_tpu_torch.tools.trace_dump host:port dead0 --tree
    python -m brpc_tpu_torch.tools.trace_dump host:port dead0 --no-stitch

Open the JSON at https://ui.perfetto.dev (or chrome://tracing): every
process the call crossed shows as its own track, client and server
spans nest by parent id, clock-skew-flagged spans carry the skew in
their args.
"""

from __future__ import annotations

import http.client
import json
import sys
from typing import List, Optional


def fetch_trace(server: str, trace_id: int, fmt: str = "chrome",
                stitch: bool = True, limit: int = 512,
                timeout: float = 10.0) -> bytes:
    """Raw /rpcz response body for one trace (raises on non-200)."""
    host, _, port = server.rpartition(":")
    path = f"/rpcz?trace_id={trace_id:x}&format={fmt}&limit={int(limit)}"
    if stitch:
        path += "&stitch=1"
    conn = http.client.HTTPConnection(host or "127.0.0.1", int(port),
                                      timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {body[:200]!r}")
        return body
    finally:
        conn.close()


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="dump a distributed rpcz trace as Perfetto-loadable "
                    "Chrome trace JSON")
    ap.add_argument("server", help="host:port of the server holding the "
                                   "trace's root spans (stitching follows "
                                   "client spans downward from there)")
    ap.add_argument("trace_id", help="trace id (hex, as shown on /rpcz)")
    ap.add_argument("-o", "--output", default="-",
                    help="output file (default: stdout)")
    ap.add_argument("--tree", action="store_true",
                    help="print a text tree instead of Chrome JSON")
    ap.add_argument("--no-stitch", action="store_true",
                    help="this process's spans only (no remote fetches)")
    ap.add_argument("--limit", type=int, default=512,
                    help="max spans per process (default 512)")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)
    try:
        tid = int(args.trace_id, 16)
    except ValueError:
        print(f"bad trace id {args.trace_id!r} (hex expected)",
              file=sys.stderr)
        return 2
    fmt = "tree" if args.tree else "chrome"
    try:
        body = fetch_trace(args.server, tid, fmt=fmt,
                           stitch=not args.no_stitch, limit=args.limit,
                           timeout=args.timeout)
    except Exception as e:
        print(f"fetch failed: {e}", file=sys.stderr)
        return 1
    if fmt == "chrome":
        # validate + count before writing: an empty trace is a usage
        # error the operator should see, not a blank file
        doc = json.loads(body)
        n = sum(1 for ev in doc.get("traceEvents", ())
                if ev.get("ph") == "X")
        if n == 0:
            print(f"trace {tid:x} has no spans on {args.server} "
                  "(expired from the store, or wrong server?)",
                  file=sys.stderr)
            return 1
        print(f"{n} span(s)", file=sys.stderr)
    if args.output == "-":
        sys.stdout.write(body.decode("utf-8", "replace"))
    else:
        with open(args.output, "wb") as f:
            f.write(body)
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
