"""rpc_replay — re-send dumped traffic at a target server.

A copy of ``brpc_tpu/tools/rpc_replay.py`` (≈ brpc's
tools/rpc_replay/rpc_replay.cpp): read rpc_dump files, replay each
captured request against a server (original service/method preserved,
fresh correlation ids), optionally rate-limited and looped; report
latency/error stats.  It calls through the port's ``Channel``, whose
request attachment is ``bytes``.
"""

from __future__ import annotations

import time
from typing import List, Optional

from ..bvar.latency_recorder import LatencyRecorder
from ..client import Channel, ChannelOptions, Controller
from .rpc_dump import DumpReader


class ReplayOptions:
    def __init__(self):
        self.server = ""
        self.dump_files: List[str] = []
        self.qps = 0                  # 0 = max
        self.loop = 1                 # times through the dump
        self.timeout_ms = 1000
        self.connection_type = "pooled"


class Replayer:
    def __init__(self, options: ReplayOptions):
        self.options = options
        self.latency = LatencyRecorder("rpc_replay")
        self.sent = 0
        self.errors = 0

    def run(self) -> dict:
        opts = self.options
        copts = ChannelOptions()
        copts.connection_type = opts.connection_type
        copts.timeout_ms = opts.timeout_ms
        ch = Channel(copts)
        if ch.init(opts.server) != 0:
            raise RuntimeError(f"cannot init channel to {opts.server}")
        frames = []
        for path in opts.dump_files:
            frames.extend(DumpReader(path))
        interval = 1.0 / opts.qps if opts.qps > 0 else 0.0
        next_at = time.monotonic()
        begin = time.monotonic()
        for _ in range(max(1, opts.loop)):
            for meta, payload in frames:
                if interval:
                    now = time.monotonic()
                    if now < next_at:
                        time.sleep(next_at - now)
                    next_at += interval
                cntl = Controller()
                cntl.timeout_ms = opts.timeout_ms
                body = payload
                if meta.attachment_size and \
                        0 < meta.attachment_size <= len(payload):
                    body = payload[:len(payload) - meta.attachment_size]
                    cntl.request_attachment = \
                        payload[len(payload) - meta.attachment_size:]
                t0 = time.monotonic()
                ch.call_method(f"{meta.service_name}.{meta.method_name}",
                               body, cntl=cntl)
                us = int((time.monotonic() - t0) * 1e6)
                self.sent += 1
                if cntl.failed:
                    self.errors += 1
                else:
                    self.latency << us
        elapsed = max(1e-9, time.monotonic() - begin)
        return {
            "frames": len(frames),
            "sent": self.sent,
            "errors": self.errors,
            "elapsed_s": round(elapsed, 3),
            "qps": round(self.sent / elapsed, 1),
            "latency_us_p50": round(self.latency.p50(), 1),
            "latency_us_p99": round(self.latency.p99(), 1),
        }


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description="replay rpc_dump files")
    ap.add_argument("--server", required=True)
    ap.add_argument("--qps", type=int, default=0)
    ap.add_argument("--loop", type=int, default=1)
    ap.add_argument("--timeout-ms", type=int, default=1000)
    ap.add_argument("dumps", nargs="+")
    args = ap.parse_args(argv)
    opts = ReplayOptions()
    opts.server = args.server
    opts.qps = args.qps
    opts.loop = args.loop
    opts.timeout_ms = args.timeout_ms
    opts.dump_files = args.dumps
    summary = Replayer(opts).run()
    print(json.dumps(summary, indent=1))
    return 0 if summary["errors"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
