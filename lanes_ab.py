#!/usr/bin/env python3
"""LM.Generate over the port's RPC lanes, timed on one CUDA card.

Usage: ``python3 lanes_ab.py [--root DIR] [--rounds N]``.

Imports ``brpc_tpu_torch`` and ``chip_smoke`` from the checkout at
``--root`` (default: this file's directory), builds that checkout's
kernels, serves ``chip_smoke.SLICE_CFG``'s ``LMService`` (seed 0) on one
port ``Server`` and sends ``chip_smoke.REQUESTS`` after one warm-up
round: over tpu_std, and, where the checkout's ``Channel`` takes a
``protocol``, over ``"http"`` and ``"grpc"`` too, the lanes taking turns
within each round (each round starting at the next lane).  Prints the
card's name and power limit, then one JSON line: each lane's host ms per
request shape and their medians, and the ``flash_fwd`` launches per
request.  Run it for two checkouts in one call on one card (parent,
change, change, parent) to hold one against the other.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("lanes_ab: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from brpc_tpu_torch.client import Channel
    from brpc_tpu_torch.models.lm_service import LMService
    from brpc_tpu_torch.models.transformer_lm import LMConfig
    from brpc_tpu_torch.ops import cuda_build
    from brpc_tpu_torch.ops.flash_attention import FLASH_FWD
    from brpc_tpu_torch.server import Server

    cuda_build.build_all()
    cfg = LMConfig(**cs.SLICE_CFG)
    svc = LMService(cfg=cfg, device="cuda", seed=0)
    srv = Server()
    if srv.add_service(svc, name="LM") != 0 or srv.start("127.0.0.1:0"):
        raise RuntimeError("the server did not start")
    lanes = ["tpu_std"]
    try:
        Channel(protocol="http")
        lanes += ["http", "grpc"]
    except TypeError:
        pass                        # a checkout that speaks tpu_std only
    chans = {}
    for lane in lanes:
        ch = Channel() if lane == "tpu_std" else Channel(protocol=lane)
        ch.init(str(srv.listen_endpoint))
        chans[lane] = ch
    prompts = cs.phase5_prompts(cfg) if hasattr(cs, "phase5_prompts") \
        else _prompts(cs, cfg)
    ms = {lane: [[] for _ in cs.REQUESTS] for lane in lanes}
    launches = {lane: 0 for lane in lanes}
    ids = {}
    try:
        for rnd in range(args.rounds + 1):
            for i, (prompt, (_, _, max_new)) in enumerate(
                    zip(prompts, cs.REQUESTS)):
                # the lanes take turns, each round starting at another
                for lane in lanes[rnd % len(lanes):] \
                        + lanes[:rnd % len(lanes)]:
                    FLASH_FWD.launches = 0
                    t0 = time.perf_counter()
                    out = cs.generate(chans[lane], prompt, max_new)
                    dt = (time.perf_counter() - t0) * 1e3
                    if rnd == 0:
                        continue            # the warm-up round
                    ms[lane][i].append(dt)
                    launches[lane] += FLASH_FWD.launches
                    ids.setdefault(i, out.tolist())
                    if out.tolist() != ids[i]:
                        raise AssertionError(f"{lane} tokens differ")
    finally:
        for ch in chans.values():
            ch.close()
        srv.stop()
    calls = args.rounds * len(cs.REQUESTS)
    print(f"card: {cs.card_line()}", flush=True)
    print(json.dumps({
        "root": root, "lanes": lanes, "rounds": args.rounds,
        "requests": cs.REQUESTS,
        "ms": ms,
        "median_ms": {lane: [statistics.median(v) for v in ms[lane]]
                      for lane in lanes},
        "flash_fwd_per_request": {lane: launches[lane] / calls
                                  for lane in lanes}}), flush=True)
    return 0


def _prompts(cs, cfg):
    """``chip_smoke.phase_serve``'s prompts, for a checkout without
    ``phase5_prompts``."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
            for b, s, _ in cs.REQUESTS]


if __name__ == "__main__":
    sys.exit(main())
