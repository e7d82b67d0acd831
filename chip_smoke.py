#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc`` (``CUDA_HOME`` or /usr/local/cuda),
imports nothing of JAX or ``brpc_tpu``, and fails (non-zero exit, no
result line) when a phase fails or CUDA is absent.  Phases:

1. the card's name and power limit, torch and CUDA versions;
2. build every kernel from ``brpc_tpu_torch/ops/csrc`` (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version on the card;
4. time the kernel, its plain version and the library call at the
   full-width prefill shape, beside the card's bound for the same work;
5. serve ``LM.Info`` and three ``LM.Generate`` requests through the
   port's Server, LMService and Channel at the full width of the repo's
   widest LM, with the kernels' launch counts read around that run;
6. show under ``torch.profiler`` that one request launches the flash
   kernel once per layer, and that the prefill logits through the kernel
   agree with those through dense attention;
7. print the kernels' JSON line, then the result line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from brpc_tpu_torch.client import Channel, Controller  # noqa: E402
from brpc_tpu_torch.models.lm_service import (LMService,  # noqa: E402
                                              pack_generate_request,
                                              unpack_generated)
from brpc_tpu_torch.models.transformer_lm import (LMConfig,  # noqa: E402
                                                  make_decode)
from brpc_tpu_torch.ops import cuda_build  # noqa: E402
from brpc_tpu_torch.ops.flash_attention import (FLASH_FWD,  # noqa: E402
                                                flash_attention_plain)
from brpc_tpu_torch.server import Server  # noqa: E402

# The widest LM the repo runs (bench.py's training section), served with
# the flash kernel on the prefill path.  Head dim 128, ~436 M parameters.
SLICE_CFG = dict(vocab=8192, dim=2048, heads=16, depth=8, max_seq=2048,
                 mlp_mult=4, use_flash=True, remat=False)
MAIN_SHAPE = (1, 1024, 16, 128)          # full-width prefill, one request
CHECK_SHAPES = [MAIN_SHAPE, (2, 1000, 16, 128), (1, 129, 4, 64),
                (1, 40, 2, 16)]
# kernel vs plain: f32 out and lse within 1e-4 abs and rel (both sum in
# f32, in another order); bf16 within 2e-2 (one bf16 rounding of out).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4
# prefill logits, flash kernel vs dense attention: the attention outputs
# agree to ~1e-6, but each of the 33 bf16 weight products after them can
# round an element the other way (2**-8 of its size), and 8 layers carry
# that on: the logits are held to 2e-2 of the largest |logit|
LOGIT_RTOL = 2e-2
REQUESTS = [(1, 1024, 32), (1, 1500, 64), (2, 512, 16)]
TIMING_REPS = 20

# Published dense peaks (NVIDIA data sheets): f32 outside the tensor
# cores, bf16 on the tensor cores, and HBM bandwidth.
PEAKS = {"sxm": {"f32": 67e12, "bf16": 989e12, "bytes": 3.35e12},
         "pcie": {"f32": 51e12, "bf16": 756e12, "bytes": 2.0e12}}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def peaks_for(name: str) -> dict:
    return PEAKS["pcie" if "pcie" in name.lower() else "sxm"]


def qkv(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, s, h, d = shape
    # one projection split three ways: v is a strided view, as in prefill
    x = torch.randn((b, s, h, 3 * d), generator=g, device="cuda")
    q, k, v = x.to(dtype).split(d, dim=-1)
    return q.contiguous(), k.contiguous(), v


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def within(a, b, tol) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


def phase_check() -> float:
    """Kernel vs plain at every shape, dtype and mask; returns the max
    abs error of the f32 output at the main-path shape."""
    main_err = 0.0
    for shape in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q, k, v = qkv(shape, dtype, seed=sum(shape))
                out, lse = FLASH_FWD(q, k, v, causal)
                torch.cuda.synchronize()
                pout, plse = flash_attention_plain(q, k, v, causal)
                e_out, e_lse = max_err(out, pout), max_err(lse, plse)
                ok = (within(out, pout, TOL[dtype])
                      and within(lse, plse, LSE_TOL))
                log(f"  check {shape} {str(dtype)[6:]} causal={causal}: "
                    f"out err {e_out:.3e} lse err {e_lse:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash_fwd disagrees with plain "
                                         f"at {shape} {dtype} {causal}")
                if shape == MAIN_SHAPE and dtype == torch.float32:
                    main_err = max(main_err, e_out)
    return main_err


def attention_flops(b: int, s: int, h: int, d: int, causal: bool) -> float:
    """Operations (2 per FMA) of both products over the live (q, k)
    pairs only: s² pairs, or s(s+1)/2 when causal."""
    pairs = s * (s + 1) / 2 if causal else float(s) * s
    return 4.0 * b * h * d * pairs


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def phase_time(peaks: dict) -> dict:
    """Kernel, plain and SDPA times at the main shape, causal."""
    b, s, h, d = MAIN_SHAPE
    res = {}
    for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q, k, v = qkv(MAIN_SHAPE, dtype, seed=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = time_ms(lambda: FLASH_FWD(q, k, v, True))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, True))
        lib_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True))
        es = q.element_size()
        nbytes = 4 * b * s * h * d * es + b * h * s * 4  # q,k,v,out + lse
        flops = attention_flops(b, s, h, d, causal=True)
        by_bytes = nbytes / peaks["bytes"] * 1e3
        by_ops = flops / peaks[key] * 1e3
        res[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=max(by_bytes, by_ops),
                        bound_by="bytes" if by_bytes > by_ops
                        else "operations", flops=flops, bytes=nbytes)
        log(f"  time {MAIN_SHAPE} {key} causal: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
            f"{res[key]['bound_ms']:.4f} ms ({res[key]['bound_by']}; "
            f"{flops:.4g} FLOP, {nbytes} B)")
    return res


def generate(ch: Channel, prompt: np.ndarray, max_new: int) -> np.ndarray:
    cntl = Controller()
    cntl.timeout_ms = 600_000
    c = ch.call_method("LM.Generate", pack_generate_request(prompt, max_new),
                       cntl=cntl)
    if c.failed:
        raise RuntimeError(f"Generate failed: [{c.error_code}] "
                           f"{c.error_text}")
    return unpack_generated(c.response)


def phase_serve(ch: Channel, cfg: LMConfig) -> list:
    info = json.loads(ch.call("LM.Info", b"", timeout_ms=60_000))
    log(f"  LM.Info: {info}")
    if info["dim"] != cfg.dim or info["depth"] != cfg.depth:
        raise AssertionError(f"Info disagrees with the config: {info}")
    rng = np.random.default_rng(0)
    rows = []
    for i, (b, s, max_new) in enumerate(REQUESTS):
        prompt = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
        t0 = time.perf_counter()
        out = generate(ch, prompt, max_new)
        dt = time.perf_counter() - t0
        if out.shape != (b, max_new) or out.dtype != np.int32:
            raise AssertionError(f"bad Generate shape {out.shape}")
        if out.min() < 0 or out.max() >= cfg.vocab:
            raise AssertionError("Generate ids out of vocab")
        tps = b * max_new / dt
        rows.append(dict(b=b, s=s, max_new=max_new, ms=dt * 1e3,
                         tok_s=tps, warmup=i == 0))
        log(f"  Generate b={b} s={s} max_new={max_new}: {dt * 1e3:.1f} ms "
            f"end to end, {tps:.1f} generated tok/s (prefill included)"
            f"{' [warm-up]' if i == 0 else ''}; first ids "
            f"{out[0, :6].tolist()}")
    return rows


def phase_profile(ch: Channel, cfg: LMConfig) -> int:
    """Flash kernel launches in one Generate request's CUDA trace."""
    from torch.profiler import ProfilerActivity, profile
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (1, 1024),
                                               dtype=np.int32)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(ch, prompt, 4)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    flash = [e for e in events if "flash_fwd_kernel" in e.name]
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    log(f"  profile (b=1 s=1024 max_new=4): {len(events)} CUDA kernel "
        f"events, {len(flash)} of flash_fwd_kernel; device busy "
        f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
        f"({busy_us / wall_us:.3f})")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {us / 1e3:8.3f} ms  {kname[:90]}")
    if len(flash) != cfg.depth:
        raise AssertionError(f"expected {cfg.depth} flash_fwd launches in "
                             f"one request's trace, saw {len(flash)}")
    return len(flash)


def phase_decode_rate(svc: LMService, cfg: LMConfig) -> dict:
    """Prefill alone and a whole completion, timed straight through the
    service's generator at one request shape: the decode steps' rate is
    the difference."""
    b, s, max_new = REQUESTS[1]
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, s))).cuda()
    prefill = make_decode(cfg, "cuda")[0]

    def run_prefill():
        with torch.inference_mode():
            prefill(svc.params, ids)

    def wall_ms(fn) -> float:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    pre_ms = wall_ms(run_prefill)
    gen_ms = wall_ms(lambda: svc._gen(ids, max_new))
    rate = b * (max_new - 1) / ((gen_ms - pre_ms) / 1e3)
    log(f"  b={b} s={s} max_new={max_new}: prefill {pre_ms:.2f} ms, whole "
        f"completion {gen_ms:.2f} ms, decode {rate:.1f} tok/s "
        f"({(gen_ms - pre_ms) / (max_new - 1):.3f} ms per step)")
    return dict(b=b, s=s, max_new=max_new, prefill_ms=pre_ms,
                completion_ms=gen_ms, decode_tok_s=rate)


def phase_logits(svc: LMService, cfg: LMConfig) -> float:
    """Prefill logits through the kernel vs through dense attention."""
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 1024))).cuda()
    dense_cfg = LMConfig(**{**SLICE_CFG, "use_flash": False,
                            "attn_impl": "dense"})
    with torch.inference_mode():
        _, flash_logits = make_decode(cfg, "cuda")[0](svc.params, ids)
        _, dense_logits = make_decode(dense_cfg, "cuda")[0](svc.params, ids)
    err = max_err(flash_logits, dense_logits)
    top = float(dense_logits.abs().max())
    ok = err <= LOGIT_RTOL * top
    same_top = bool((flash_logits.argmax(-1) == dense_logits.argmax(-1)).all())
    log(f"  prefill logits, kernel vs dense attention: max abs err "
        f"{err:.3e}, max |logit| {top:.3f}, ratio {err / top:.3e} "
        f"(tolerance {LOGIT_RTOL}: {'ok' if ok else 'FAIL'}), same argmax "
        f"{same_top}")
    if not ok or not torch.isfinite(flash_logits).all():
        raise AssertionError("prefill logits through the kernel disagree")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    paths = cuda_build.build_all()
    log(f"[2] built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for src, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    log("[3] kernel vs plain")
    main_err = phase_check()
    log("[4] timing")
    times = phase_time(peaks)

    cfg = LMConfig(**SLICE_CFG)
    log(f"[5] serving LM at {SLICE_CFG}")
    t0 = time.perf_counter()
    svc = LMService(cfg=cfg, device="cuda", seed=0)
    log(f"  params: {svc._param_bytes / 1e9:.3f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    srv = Server()
    ch = Channel()
    try:
        if srv.add_service(svc, name="LM") != 0 or srv.start(
                "127.0.0.1:0") != 0:
            raise RuntimeError("server did not start")
        ch.init(str(srv.listen_endpoint))
        FLASH_FWD.launches = 0
        rows = phase_serve(ch, cfg)
        launches = FLASH_FWD.launches
        want = cfg.depth * len(REQUESTS)
        log(f"  flash_fwd launches on the main path: {launches} "
            f"(expected {want})")
        if launches != want:
            raise AssertionError("the main path did not run the kernel "
                                 "once per layer per request")
        log("[6] kernel on the path")
        phase_profile(ch, cfg)
        phase_logits(svc, cfg)
        decode = phase_decode_rate(svc, cfg)
    finally:
        ch.close()
        srv.stop()

    f32 = times["f32"]
    kernels = [{
        "name": FLASH_FWD.name, "route": "cuda",
        "source": "brpc_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "brpc_tpu/ops/flash_attention.py:46",
        "launches": launches, "max_abs_err": main_err,
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"]}]
    log(f"[7] bf16 at {MAIN_SHAPE} causal: {json.dumps(times['bf16'])}")
    log(f"  requests: {json.dumps(rows)}")
    log(f"  decode: {json.dumps(decode)}")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
