#!/usr/bin/env python3
"""``chip_smoke.py`` phase 13 (c)'s method cap, repeated on one CUDA card.

Usage: ``python3 refusal_ab.py [--root DIR] [--rounds N]``.

Imports ``brpc_tpu_torch`` and ``chip_smoke`` from the checkout at
``--root`` (default: this file's directory), builds that checkout's
kernels and serves ``chip_smoke.SLICE_CFG``'s ``LMService`` (seed 0).
Each round starts a port ``Server`` with ``LM.Generate`` capped at
``ADMIT_CAP``, puts that many Generates of ``REQUESTS[0]`` in flight and,
while they run, sends ``ADMIT_CALLS - ADMIT_CAP`` more one after another,
each of which the cap refuses; one warm-up round comes first.  Prints
the card's name and power limit, then one JSON line: every refusal's
host ms and the server's stamps (ms after the call began: the consumer
fiber's start, the request's cut, the write, the caller's end), how many
took 5 ms or more, their median and largest, the largest gap between
two stamps, the capped Generates' ms, and the garbage collector's
collections over the rounds (count and longest ms, by generation: a
collection holds the interpreter lock).  Run it for two checkouts in
one call on one card (parent, change, change, parent) to hold one
against the other.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import threading
import time

HOPS = ("consumer", "cut", "write", "end")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--rounds", type=int, default=12)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("refusal_ab: CUDA is not available", file=sys.stderr)
        return 1
    import numpy as np

    import chip_smoke as cs
    from brpc_tpu_torch.butil.status import Errno
    from brpc_tpu_torch.models.lm_service import LMService
    from brpc_tpu_torch.models.transformer_lm import LMConfig
    from brpc_tpu_torch.ops import cuda_build
    from brpc_tpu_torch.server import ServerOptions

    cuda_build.build_all()
    cfg = LMConfig(**cs.SLICE_CFG)
    svc = LMService(cfg=cfg, device="cuda", seed=0)
    b, s, max_new = cs.REQUESTS[0]
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (b, s),
                                               dtype=np.int32)

    def one_round() -> tuple:
        opts = ServerOptions()
        opts.method_max_concurrency = {"LM.Generate": cs.ADMIT_CAP}
        server = cs.serve_lm({"LM": svc}, opts)
        stamps = cs.ServerStamps()
        try:
            extra = cs.connected_channels(server.listen_endpoint,
                                          cs.ADMIT_CALLS - cs.ADMIT_CAP)
            capped = {}
            t = threading.Thread(target=lambda: capped.__setitem__(
                "res", cs.concurrent_generates(server.listen_endpoint,
                                               cs.ADMIT_CAP, prompt,
                                               max_new)))
            t.start()
            st = server.method_status("LM.Generate")
            cs.wait_until(lambda: st.inflight == cs.ADMIT_CAP, 60,
                          "the capped calls")
            refusals = []
            stamps.install()
            try:
                for c in extra:
                    del stamps.stamps[:]
                    t0 = time.monotonic_ns()
                    code = cs.gen_call(c, prompt, max_new,
                                       600_000).error_code
                    t1 = time.monotonic_ns()
                    refusals.append(dict(ms=(t1 - t0) / 1e6, code=code,
                                         stamps=stamps.call(t0, t1)))
                    c.close()
            finally:
                stamps.remove()
            busy = st.inflight == cs.ADMIT_CAP
            t.join(600)
        finally:
            server.stop()
        if not busy or any(r["code"] != int(Errno.ELIMIT) for r in refusals) \
                or any(code != 0 for code, _, _ in capped["res"]):
            raise AssertionError("a round went wrong: the cap did not hold "
                                 "or the capped calls ended too soon")
        return refusals, [ms for _, ms, _ in capped["res"]]

    one_round()                             # the warm-up round
    refusals, generate_ms = [], []
    collections = {g: [] for g in range(3)}
    began = []

    def on_gc(phase, info):
        if phase == "start":
            began.append(time.monotonic_ns())
        elif began:
            collections[info["generation"]].append(
                (time.monotonic_ns() - began.pop()) / 1e6)

    gc.callbacks.append(on_gc)
    try:
        for _ in range(args.rounds):
            r, g = one_round()
            refusals += r
            generate_ms += g
    finally:
        gc.callbacks.remove(on_gc)
    ms = [r["ms"] for r in refusals]
    gaps = []
    for r in refusals:
        prev = 0.0
        for hop in HOPS:
            at = r["stamps"].get(hop)
            if at is not None:
                gaps.append(at - prev)
                prev = at
    print(f"card: {cs.card_line()}", flush=True)
    print(json.dumps({
        "root": root, "rounds": args.rounds, "request": cs.REQUESTS[0],
        "refusals": refusals, "over_5_ms": sum(m >= 5.0 for m in ms),
        "median_ms": statistics.median(ms), "max_ms": max(ms),
        "max_gap_ms": max(gaps),
        "generate_median_ms": statistics.median(generate_ms),
        "gc_ms": {g: [len(v), max(v, default=0.0)]
                  for g, v in collections.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
