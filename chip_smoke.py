#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc`` (``CUDA_HOME`` or /usr/local/cuda),
imports nothing of JAX or ``brpc_tpu``, and fails (non-zero exit, no
result line) when a phase fails or CUDA is absent.  Phases:

1. the card's name and power limit, torch and CUDA versions;
2. build every kernel from ``brpc_tpu_torch/ops/csrc`` (nvcc, sm_90a);
3. hold the forward kernel against its plain PyTorch version on the card;
   3b. hold the backward kernels (``flash_dq``, ``flash_dkdv``) against
   the plain backward, f32 and bf16, causal and not, at the training
   shape and smaller ones;
4. time the forward kernel, its plain version and the library call at
   the full-width prefill shape, beside the card's bound for the same
   work; 4b. the same for each backward kernel at the training shape
   (the library yardstick is SDPA's backward), and the library yardstick
   of the checksum kernel still to port;
5. serve ``LM.Info`` and three ``LM.Generate`` requests through the
   port's Server, LMService and Channel at the full width of the repo's
   widest LM, with the kernels' launch counts read around that run;
6. show under ``torch.profiler`` that one request launches the flash
   kernel once per layer, and that the prefill logits through the kernel
   agree with those through dense attention;
8. train that LM at full width (``make_train_step``, remat, gradient
   accumulation): one step's loss and gradient through the kernels
   against dense attention, then a falling finite loss over 4 steps with
   the kernels' launch counts read around every step, step time, tokens/s
   and model FLOP/s, and one more step under ``torch.profiler`` (the
   kernels in its trace, the device busy share);
9. round-trip the trained parameters through ``TrainCheckpointer``;
7. print the kernels' JSON line, then the result line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from brpc_tpu_torch.client import Channel, Controller  # noqa: E402
from brpc_tpu_torch.models.lm_service import (LMService,  # noqa: E402
                                              pack_generate_request,
                                              unpack_generated)
from brpc_tpu_torch.models.transformer_lm import (  # noqa: E402
    LMConfig, init_params, make_decode, make_train_step, make_value_and_grad,
    tree_leaves)
from brpc_tpu_torch.ops import cuda_build  # noqa: E402
from brpc_tpu_torch.ops.flash_attention import (  # noqa: E402
    FLASH_DKDV, FLASH_DQ, FLASH_FWD, KERNELS, attention_delta,
    flash_attention_bwd_plain, flash_attention_plain)
from brpc_tpu_torch.server import Server  # noqa: E402
from brpc_tpu_torch.utils.checkpoint import (  # noqa: E402
    TrainCheckpointer, abstract_like)

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

# Training: bench.py's train-step config (bench.py:3247-3248) letter for
# letter.  Reduced: the batch, from bench.py's ACC=8 x B=32 x S=2048
# (bench.py:3252) to accum=2 x microbatch 4 x 2048 tokens, because the
# first kernels are simple f32 kernels and a bench-sized step would take
# minutes.  Widths, depth and sequence length are whole.
TRAIN_CFG = dict(SLICE_CFG, remat=True)
TRAIN_ACCUM, TRAIN_MICRO, TRAIN_SEQ = 2, 4, 2048
TRAIN_SHAPE = (TRAIN_MICRO, TRAIN_SEQ, 16, 128)   # attention's (b, s, h, d)
TRAIN_STEPS = 3                                   # timed, after 1 warm-up
# Plain SGD from init_params at this width makes the loss rise over the
# first steps at bench.py's lr (LMConfig's default 0.05) and still at 0.01
# on the H100; at 0.002 it falls at every step, which phase 8 checks.
TRAIN_LR = 0.002
BWD_CHECK_SHAPES = [TRAIN_SHAPE, MAIN_SHAPE, (2, 1000, 16, 128),
                    (1, 129, 4, 64), (1, 40, 2, 16)]
# backward kernels vs the plain backward: |err| <= rtol * |ref| + afrac *
# max|ref|.  f32: both sum in f32 in another order (2e-4, 2e-5); bf16: ds
# and p are rounded to bf16 before their products and one rounding can
# flip with the order of dp's sum (3e-2, 3e-2).
BWD_TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (3e-2, 3e-2)}
# one train step through the kernels vs through dense attention, at the
# initial params: the attention outputs agree to ~1e-6, but every weight
# product after them rounds to bf16 and can round an element the other
# way; the loss is held to 1e-3 relative and the whole gradient to
# ||dg|| / ||g|| <= 1e-2 (2.0e-3 measured on the H100)
DENSE_LOSS_RTOL = 1e-3
DENSE_GRAD_REL_NORM = 1e-2
# payload of the checksum yardstick: one f32 (4, 2048, 2048) activation,
# the size of a block's remat input at the training shape
CHECKSUM_BYTES = TRAIN_MICRO * TRAIN_SEQ * 2048 * 4

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


def bwd_inputs(shape, dtype, causal: bool, seed: int):
    """q, k, v (v strided), out and lse from the forward kernel, a random
    cotangent do, and dd = rowsum(do * out)."""
    q, k, v = qkv(shape, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(shape, generator=g, device="cuda").to(dtype)
    out, lse = FLASH_FWD(q, k, v, causal)
    return q, k, v, out, lse, do, attention_delta(out, do)


def bwd_within(a, ref, dtype) -> bool:
    rtol, afrac = BWD_TOL[dtype]
    a, ref = a.float(), ref.float()
    return bool(((a - ref).abs() <= rtol * ref.abs()
                 + afrac * ref.abs().max()).all())


def phase_check_bwd() -> dict:
    """flash_dq / flash_dkdv vs the plain backward at every shape, dtype
    and mask; returns each kernel's max abs error at the training shape,
    f32."""
    errs = {FLASH_DQ.name: 0.0, FLASH_DKDV.name: 0.0}
    for shape in BWD_CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q, k, v, out, lse, do, dd = bwd_inputs(shape, dtype, causal,
                                                       seed=sum(shape) + 1)
                (dq,) = FLASH_DQ(q, k, v, do, lse, dd, causal)
                dk, dv = FLASH_DKDV(q, k, v, do, lse, dd, causal)
                torch.cuda.synchronize()
                ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
                got = (dq, dk, dv)
                e = [max_err(a, r) for a, r in zip(got, ref)]
                ok = all(bwd_within(a, r, dtype) for a, r in zip(got, ref))
                log(f"  check bwd {shape} {str(dtype)[6:]} causal={causal}: "
                    f"dq err {e[0]:.3e} dk err {e[1]:.3e} dv err {e[2]:.3e} "
                    f"(max |ref| {max(float(r.abs().max()) for r in ref):.3e})"
                    f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash backward disagrees with "
                                         f"plain at {shape} {dtype} {causal}")
                if shape == TRAIN_SHAPE and dtype == torch.float32:
                    errs[FLASH_DQ.name] = max(errs[FLASH_DQ.name], e[0])
                    errs[FLASH_DKDV.name] = max(errs[FLASH_DKDV.name], e[1],
                                                e[2])
    return errs


def phase_time_bwd(peaks: dict) -> dict:
    """flash_dq, flash_dkdv, the plain backward and SDPA's backward at the
    training shape, causal, each beside its bound; then the checksum
    yardstick."""
    b, s, h, d = TRAIN_SHAPE
    pairs = s * (s + 1) / 2
    res = {}
    for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q, k, v, out, lse, do, dd = bwd_inputs(TRAIN_SHAPE, dtype, True,
                                               seed=2)
        dq_ms = time_ms(lambda: FLASH_DQ(q, k, v, do, lse, dd, True))
        dkdv_ms = time_ms(lambda: FLASH_DKDV(q, k, v, do, lse, dd, True))
        plain_ms = time_ms(lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, do, True))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)

        sdpa_fwd_ms = time_ms(sdpa)
        sdpa_all_ms = time_ms(lambda: torch.autograd.grad(
            sdpa(), (qt, kt, vt), dot))
        sdpa_bwd_ms = sdpa_all_ms - sdpa_fwd_ms
        es = q.element_size()
        tensor = b * s * h * d * es
        rows = b * h * s * 4
        res[key] = {}
        for name, ms, flops_per, n_out in (
                (FLASH_DQ.name, dq_ms, 6, 1), (FLASH_DKDV.name, dkdv_ms, 8, 2)):
            flops = flops_per * b * h * d * pairs
            nbytes = 4 * tensor + 2 * rows + n_out * tensor
            by_bytes = nbytes / peaks["bytes"] * 1e3
            by_ops = flops / peaks[key] * 1e3
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_bwd_ms,
                       bound_ms=max(by_bytes, by_ops),
                       bound_by="bytes" if by_bytes > by_ops
                       else "operations", flops=flops, bytes=nbytes)
            res[key][name] = row
            log(f"  time {TRAIN_SHAPE} {key} causal {name}: {ms:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
                f"{flops:.4g} FLOP, {nbytes} B), "
                f"{flops / ms / 1e9:.2f} TFLOP/s")
        log(f"  time {TRAIN_SHAPE} {key} causal: plain backward (dq, dk, dv)"
            f" {plain_ms:.4f} ms; library yardstick, SDPA forward+backward "
            f"minus SDPA forward: {sdpa_all_ms:.4f} - {sdpa_fwd_ms:.4f} = "
            f"{sdpa_bwd_ms:.4f} ms")
    x = torch.randint(-2**31, 2**31 - 1, (CHECKSUM_BYTES // 4,),
                      dtype=torch.int32, device="cuda")
    cs_ms = time_ms(lambda: x.view(torch.int32).sum(dtype=torch.int64))
    cs_bound = CHECKSUM_BYTES / peaks["bytes"] * 1e3
    res["checksum"] = dict(payload_bytes=CHECKSUM_BYTES, library_ms=cs_ms,
                           bound_ms=cs_bound, bound_by="bytes")
    log(f"  checksum yardstick (kernel not ported): "
        f"x.view(torch.int32).sum(dtype=torch.int64) over {CHECKSUM_BYTES} B"
        f" {cs_ms:.4f} ms, bound {cs_bound:.4f} ms (bytes)")
    return res


def reset_launches() -> None:
    for kern in KERNELS:
        kern.launches = 0


def read_launches() -> dict:
    return {kern.name: kern.launches for kern in KERNELS}


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


def train_launches(cfg: LMConfig) -> dict:
    """Kernel launches one train step must make: the forward kernel twice
    per block and microbatch (remat recomputes it), each backward kernel
    once."""
    n = cfg.depth * TRAIN_ACCUM
    return {FLASH_FWD.name: 2 * n if cfg.remat else n,
            FLASH_DQ.name: n, FLASH_DKDV.name: n}


def phase_train(peaks: dict) -> dict:
    """Train the slice's LM at full width: one step's loss and gradient
    at the initial params through the kernels against dense attention;
    then 1 warm-up and TRAIN_STEPS timed steps on one fixed batch, the
    launch counts read around every step; one more step under the
    profiler."""
    cfg = LMConfig(**TRAIN_CFG)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         "cuda")
    nparams = sum(p.numel() for p in tree_leaves(params))
    ids = torch.randint(0, cfg.vocab, (TRAIN_ACCUM * TRAIN_MICRO, TRAIN_SEQ),
                        generator=torch.Generator(device="cuda")
                        .manual_seed(1), device="cuda")
    labels = ids.roll(-1, -1)
    tokens = ids.numel()
    log(f"  {nparams / 1e6:.1f} M params, batch {tuple(ids.shape)} as "
        f"accum={TRAIN_ACCUM} x {TRAIN_MICRO}, lr {TRAIN_LR}")
    res = phase_train_vs_dense(params, ids, labels)
    train_step = make_train_step(cfg, accum=TRAIN_ACCUM)

    def step(params, ids, labels):
        return train_step(params, ids, labels, TRAIN_LR)

    want = train_launches(cfg)
    log(f"  launches per step expected {want}")
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    total = dict.fromkeys(want, 0)
    for i in range(1 + TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        params, loss = step(params, ids, labels)
        loss = float(loss)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = read_launches()
        losses.append(loss)
        log(f"  step {i}{' [warm-up]' if i == 0 else ''}: loss {loss:.6f}, "
            f"{secs[-1] * 1e3:.1f} ms, launches {got}")
        if got != want:
            raise AssertionError(f"train step launched {got}, want {want}")
        for name in total:
            total[name] += got[name]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = statistics.median(secs[1:])
    model_flops = 6.0 * nparams * tokens
    res.update(params_m=nparams / 1e6, tokens_per_step=tokens,
               losses=losses, step_s=secs, step_ms=step_s * 1e3,
               tokens_per_s=tokens / step_s,
               model_tflops=model_flops / step_s / 1e12,
               share_of_bf16_peak=model_flops / step_s / peaks["bf16"],
               peak_mem_gb=peak_gb, launches=total)
    log(f"  step {step_s * 1e3:.1f} ms (median of {TRAIN_STEPS}), "
        f"{res['tokens_per_s']:.0f} tokens/s, 6*N*T/time "
        f"{res['model_tflops']:.2f} TFLOP/s = {res['share_of_bf16_peak']:.4f}"
        f" of the {peaks['bf16'] / 1e12:.0f} TFLOP/s bf16 peak; peak memory "
        f"{peak_gb:.2f} GB")
    res.update(phase_train_profile(step, params, ids, labels, cfg))
    res["params"] = params
    return res


def phase_train_profile(step, params, ids, labels, cfg: LMConfig) -> dict:
    """One step under torch.profiler: the backward kernels in its CUDA
    trace, the device busy share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, loss = step(params, ids, labels)
        float(loss)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    seen = {kern: sum(n for name, (n, _) in by_name.items()
                      if f"{kern}_kernel" in name)
            for kern in (FLASH_FWD.name, FLASH_DQ.name, FLASH_DKDV.name)}
    log(f"  profile of one step: {len(events)} CUDA events, kernels seen "
        f"{seen}; device busy {busy_us / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms wall ({busy_us / wall_us:.4f})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for kname, (n, us) in top:
        log(f"    {us / 1e3:9.3f} ms  {n:5d}x  {kname[:90]}")
    if seen != train_launches(cfg):
        raise AssertionError(f"one step's trace shows {seen}, want "
                             f"{train_launches(cfg)}")
    return dict(profile_busy_ms=busy_us / 1e3, profile_wall_ms=wall_us / 1e3,
                busy_share=busy_us / wall_us,
                top_kernels=[(k[:90], n, us / 1e3) for k, (n, us) in top])


def phase_train_vs_dense(params, ids, labels) -> dict:
    """One step's loss and gradient through the kernels vs through dense
    attention, on the same params and batch."""
    out = {}
    for impl in ("flash", "dense"):
        cfg = LMConfig(**{**TRAIN_CFG, "use_flash": impl == "flash",
                          "attn_impl": impl})
        vg = make_value_and_grad(cfg, accum=TRAIN_ACCUM)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = vg(params, ids, labels)
        loss = float(loss)
        torch.cuda.synchronize()
        out[impl] = (loss, tree_leaves(grads), time.perf_counter() - t0)
    (fl, fg, fs), (dl, dg, ds) = out["flash"], out["dense"]
    diff = sum(float((a - b).double().pow(2).sum()) for a, b in zip(fg, dg))
    norm = sum(float(b.double().pow(2).sum()) for b in dg)
    rel = (diff / norm) ** 0.5
    loss_rel = abs(fl - dl) / abs(dl)
    ok = loss_rel <= DENSE_LOSS_RTOL and rel <= DENSE_GRAD_REL_NORM
    log(f"  one step, kernels vs dense attention: loss {fl:.6f} vs {dl:.6f}"
        f" (rel {loss_rel:.3e}, tolerance {DENSE_LOSS_RTOL}), gradient "
        f"||dg||/||g|| {rel:.3e} (tolerance {DENSE_GRAD_REL_NORM}): "
        f"{'ok' if ok else 'FAIL'}; value_and_grad {fs * 1e3:.1f} ms flash, "
        f"{ds * 1e3:.1f} ms dense (one call each)")
    if not ok:
        raise AssertionError("the step through the kernels disagrees with "
                             "dense attention")
    return dict(dense_loss_rel=loss_rel, dense_grad_rel_norm=rel,
                vg_flash_ms=fs * 1e3, vg_dense_ms=ds * 1e3)


def phase_checkpoint(params: dict) -> float:
    """Save the trained params and restore them onto the card: bit
    identical.  Returns the save + restore wall time in seconds."""
    state = {"params": params, "step": 1 + TRAIN_STEPS}
    with tempfile.TemporaryDirectory() as d:
        ckpt = TrainCheckpointer(d, max_to_keep=2)
        t0 = time.perf_counter()
        ckpt.save(1 + TRAIN_STEPS, state)
        got = ckpt.restore(like=abstract_like(state))
        ckpt.close()
        dt = time.perf_counter() - t0
    want = tree_leaves(params)
    pairs = list(zip(tree_leaves(got["params"]), want))
    ok = (got["step"] == state["step"] and len(pairs) == len(want)
          and all(a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in pairs))
    nbytes = sum(b.numel() * b.element_size() for _, b in pairs)
    log(f"  checkpoint of {nbytes / 1e9:.3f} GB saved and restored onto "
        f"the card in {dt:.1f} s: {'bit-identical' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the restored params differ")
    return dt


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
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
    log("[3b] backward kernels vs plain")
    bwd_err = phase_check_bwd()
    log("[4] timing")
    times = phase_time(peaks)
    log("[4b] backward timing")
    bwd_times = phase_time_bwd(peaks)

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

    log(f"[8] training LM at {TRAIN_CFG}, accum={TRAIN_ACCUM} x microbatch "
        f"{TRAIN_MICRO} x {TRAIN_SEQ} tokens (reduced from bench.py's 8 x "
        f"32 x 2048)")
    train = phase_train(peaks)
    log("[9] checkpoint round trip")
    ckpt_s = phase_checkpoint(train.pop("params"))

    f32 = times["f32"]
    kernels = [{
        "name": FLASH_FWD.name, "route": "cuda",
        "source": "brpc_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "brpc_tpu/ops/flash_attention.py:46",
        "launches": launches + train["launches"][FLASH_FWD.name],
        "launches_by_path": {"generate": launches,
                             "train": train["launches"][FLASH_FWD.name]},
        "max_abs_err": main_err,
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"]}]
    for kern, line in ((FLASH_DQ, 313), (FLASH_DKDV, 361)):
        row = bwd_times["f32"][kern.name]
        kernels.append({
            "name": kern.name, "route": "cuda",
            "source": "brpc_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"brpc_tpu/ops/flash_attention.py:{line}",
            "launches": train["launches"][kern.name],
            "launches_by_path": {"train": train["launches"][kern.name]},
            "max_abs_err": bwd_err[kern.name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    log(f"[7] bf16 at {MAIN_SHAPE} causal: {json.dumps(times['bf16'])}")
    log(f"  backward at {TRAIN_SHAPE} causal: {json.dumps(bwd_times)}")
    log(f"  requests: {json.dumps(rows)}")
    log(f"  decode: {json.dumps(decode)}")
    log(f"  train: {json.dumps(train)}; checkpoint {ckpt_s:.2f} s")
    log(f"  all phases: {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
