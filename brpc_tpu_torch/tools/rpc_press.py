"""rpc_press — generic load generator.

A copy of ``brpc_tpu/tools/rpc_press.py`` (≈ brpc's
tools/rpc_press/rpc_press_impl.h:106, RpcPress): drive any
service/method at a target QPS (or flat out), print live qps/latency
percentiles, report a summary.  Programmatic API first (the tests and
the smoke drive it); ``python -m brpc_tpu_torch.tools.rpc_press`` for the
command line.  Its calls ride the port's ``Channel``: a ``"pooled"`` or
``"short"`` blocking call takes the fast lane (``client/fast_call.py``).
The port's request attachment is ``bytes``.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Callable, List, Optional

from ..bvar.latency_recorder import LatencyRecorder
from ..client import Channel, ChannelOptions, Controller


class PressOptions:
    def __init__(self):
        self.server = ""                 # "ip:port" or naming url
        self.lb_name = ""                # for cluster targets
        self.method = ""                 # "Service.Method"
        self.qps = 0                     # 0 = as fast as possible
        self.duration_s = 0.0            # 0 = until stop()
        self.threads = 1
        self.connection_type = "pooled"
        self.timeout_ms = 1000
        self.input: Any = b""            # payload bytes, or list of payloads
        self.attachment: bytes = b""
        self.report_interval_s = 1.0
        self.report: Optional[Callable[[str], None]] = None  # default: stderr


class Press:
    def __init__(self, options: PressOptions):
        self.options = options
        self.latency = LatencyRecorder("rpc_press")
        self.sent = 0
        self.errors = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()

    # -- control -----------------------------------------------------------

    def run(self) -> dict:
        """Blocking: run for duration_s (or until stop()), return the
        summary dict."""
        self.start()
        try:
            if self.options.duration_s > 0:
                self._stop.wait(self.options.duration_s)
            else:
                while not self._stop.is_set():
                    self._stop.wait(0.5)
        finally:
            self.stop()
        return self.summary()

    def start(self) -> None:
        opts = self.options
        if not opts.server or not opts.method:
            raise ValueError("press needs server and method")
        self._begin = time.monotonic()
        for i in range(max(1, opts.threads)):
            t = threading.Thread(target=self._worker, name=f"press_{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self._reporter = threading.Thread(target=self._report_loop,
                                          daemon=True)
        self._reporter.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)

    def summary(self) -> dict:
        elapsed = max(1e-9, time.monotonic() - self._begin)
        return {
            "sent": self.sent,
            "errors": self.errors,
            "elapsed_s": round(elapsed, 3),
            "qps": round(self.sent / elapsed, 1),
            "latency_us_p50": round(self.latency.p50(), 1),
            "latency_us_p99": round(self.latency.p99(), 1),
            "latency_us_avg": round(self.latency.latency(), 1),
        }

    # -- internals ---------------------------------------------------------

    def _payloads(self):
        inp = self.options.input
        if isinstance(inp, (bytes, bytearray, memoryview)):
            return [bytes(inp)]
        return [bytes(p) for p in inp] or [b""]

    def _worker(self) -> None:
        opts = self.options
        copts = ChannelOptions()
        copts.connection_type = opts.connection_type
        copts.timeout_ms = opts.timeout_ms
        ch = Channel(copts)
        if ch.init(opts.server, opts.lb_name) != 0:
            raise RuntimeError(f"cannot init channel to {opts.server}")
        payloads = self._payloads()
        npay = len(payloads)
        # per-thread pacing slice of the target qps
        per_thread_qps = opts.qps / max(1, opts.threads) if opts.qps else 0
        interval = 1.0 / per_thread_qps if per_thread_qps > 0 else 0.0
        next_at = time.monotonic()
        k = 0
        while not self._stop.is_set():
            if interval:
                now = time.monotonic()
                if now < next_at:
                    time.sleep(min(interval, next_at - now))
                    continue
                next_at += interval
                if now - next_at > 1.0:
                    next_at = now       # fell behind a full second: reset
            cntl = Controller()
            cntl.timeout_ms = opts.timeout_ms
            if opts.attachment:
                cntl.request_attachment = bytes(opts.attachment)
            t0 = time.monotonic()
            ch.call_method(opts.method, payloads[k % npay], cntl=cntl)
            us = int((time.monotonic() - t0) * 1e6)
            k += 1
            with self._lock:
                self.sent += 1
                if cntl.failed:
                    self.errors += 1
                else:
                    self.latency << us

    def _report_loop(self) -> None:
        report = self.options.report
        if report is None:
            report = lambda s: print(s, file=sys.stderr)  # noqa: E731
        last_sent = 0
        while not self._stop.wait(self.options.report_interval_s):
            sent = self.sent
            report(f"[rpc_press] qps={(sent - last_sent) / self.options.report_interval_s:.0f} "
                   f"sent={sent} errors={self.errors} "
                   f"p50={self.latency.p50():.0f}us "
                   f"p99={self.latency.p99():.0f}us")
            last_sent = sent


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="drive a tpu-rpc service at a target QPS")
    ap.add_argument("--server", required=True)
    ap.add_argument("--method", required=True,
                    help='"Service.Method"')
    ap.add_argument("--qps", type=int, default=0, help="0 = max speed")
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--timeout-ms", type=int, default=1000)
    ap.add_argument("--connection-type", default="pooled")
    ap.add_argument("--input", default="",
                    help="payload file (raw bytes); default empty payload")
    ap.add_argument("--lb", default="", help="load balancer for naming urls")
    args = ap.parse_args(argv)
    opts = PressOptions()
    opts.server = args.server
    opts.method = args.method
    opts.qps = args.qps
    opts.duration_s = args.duration
    opts.threads = args.threads
    opts.timeout_ms = args.timeout_ms
    opts.connection_type = args.connection_type
    opts.lb_name = args.lb
    if args.input:
        with open(args.input, "rb") as f:
            opts.input = f.read()
    summary = Press(opts).run()
    import json
    print(json.dumps(summary, indent=1))
    return 0 if summary["errors"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
