"""parallel_http — fetch one URL path from many servers concurrently.

A copy of ``brpc_tpu/tools/parallel_http.py`` (≈ brpc's
tools/parallel_http/parallel_http.cpp), nothing cut: the fleet
operator's mass probe — pull ``/vars/process_uptime`` (or any portal
page) from every rank at once and see who is slow, stuck, or divergent.

    python -m brpc_tpu_torch.tools.parallel_http /status host1:p1 host2:p2 ...
    python -m brpc_tpu_torch.tools.parallel_http /vars -f ranks.txt -c 64
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .rpc_view import fetch_raw


@dataclass
class FetchResult:
    server: str
    status: int = 0                 # 0 = transport failure
    body: bytes = b""
    latency_s: float = 0.0
    error: str = ""

    @property
    def ok(self) -> bool:
        return self.status == 200


def parallel_fetch(servers: Sequence[str], path: str = "/status",
                   concurrency: int = 32,
                   timeout: float = 10.0) -> Dict[str, FetchResult]:
    """Fetch ``path`` from every server with a bounded thread pool.
    Never raises — per-server failures land in the result's ``error``."""

    def one(server: str) -> FetchResult:
        import http.client as _hc
        t0 = time.monotonic()
        try:
            status, _, body, _loc = fetch_raw(server, path,
                                              timeout=timeout)
            return FetchResult(server, status, body,
                               time.monotonic() - t0)
        except (OSError, _hc.HTTPException, RuntimeError, ValueError) as e:
            # one garbled rank (non-HTTP port, truncated reply) must
            # never abort the fleet scan
            return FetchResult(server, 0, b"", time.monotonic() - t0,
                               f"{type(e).__name__}: {e}")

    results: Dict[str, FetchResult] = {}
    with ThreadPoolExecutor(max_workers=max(1, concurrency)) as pool:
        for r in pool.map(one, servers):
            results[r.server] = r
    return results


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="fetch a portal page from many servers at once")
    ap.add_argument("path", help="page path, e.g. /status")
    ap.add_argument("servers", nargs="*", help="host:port ...")
    ap.add_argument("-f", "--file", help="file with one host:port per line")
    ap.add_argument("-c", "--concurrency", type=int, default=32)
    ap.add_argument("-t", "--timeout", type=float, default=10.0)
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="summary only (no bodies)")
    args = ap.parse_args(argv)
    servers = list(args.servers)
    if args.file:
        with open(args.file) as f:
            stripped = (ln.strip() for ln in f)
            servers += [s for s in stripped
                        if s and not s.startswith("#")]
    if not servers:
        ap.error("no servers given")
    results = parallel_fetch(servers, args.path,
                             concurrency=args.concurrency,
                             timeout=args.timeout)
    ok = 0
    for server in servers:
        r = results[server]
        if r.ok:
            ok += 1
            print(f"== {server} ({r.latency_s * 1e3:.1f}ms)")
            if not args.quiet:
                print(r.body.decode("utf-8", "replace").rstrip())
        else:
            print(f"== {server} FAILED "
                  f"({r.error or f'HTTP {r.status}'})")
    print(f"-- {ok}/{len(servers)} ok")
    return 0 if ok == len(servers) else 1


if __name__ == "__main__":
    raise SystemExit(main())
