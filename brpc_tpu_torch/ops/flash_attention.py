"""Flash attention for the port: hand-written CUDA kernels for the forward
and the backward, their plain PyTorch versions, and the ``attention()``
dispatcher.

Counterpart of ``brpc_tpu/ops/flash_attention.py``.  The Pallas forward
``_fwd_kernel`` becomes ``csrc/flash_fwd.cu``; the backward kernels
``_dq_kernel`` and ``_dkdv_kernel`` become ``flash_dq`` and ``flash_dkdv``
in ``csrc/flash_bwd.cu`` (CUDA C++ for sm_90a, built by
:mod:`.cuda_build`, called through ctypes).  All three run on the tensor
cores (``csrc/flash_mma.cuh``): f32 inputs as 3xTF32, each product as
three tf32 MMAs with f32 sums, which keeps f32's tolerances; bf16 inputs
on bf16 MMA.  On a CUDA tensor
:func:`flash_attention_fwd` and :func:`flash_attention_bwd` launch those
kernels or raise; on a CPU tensor they run :func:`flash_attention_plain`
and :func:`flash_attention_bwd_plain`, the same tile-wise arithmetic in
PyTorch ops.  Nothing catches a build or launch error to run the plain
version instead.

Layouts follow the JAX package: q/k/v/out are ``(b, s, h, d)``; the
log-sum-exp and ``dd = rowsum(do * out)`` are f32 ``(b, h, s)`` (the JAX
ones are padded, ``(b, h, s_pad, 1)``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .cuda_build import CudaKernel

# Key tile of the kernels (csrc/flash_fwd.cu BK, flash_bwd.cu DqCfg::BK up
# to d = 128; dq takes 16 keys at a time above); the plain version walks
# keys in tiles of 32.
BLOCK_K = 32
# The kernels' head-dim limit: their q/k/v tiles are instantiated for
# d = 16, 32, 64, 128 and 256, and a head is zero-padded to the next of
# them.  The plain versions take any head dim, as the JAX kernel does (it
# pads d to a multiple of 128); past 256 the kernels would need the head
# dim split across blocks, which none of them does.
MAX_HEAD_DIM = 256


def _check_kernel_inputs(name: str, *ts) -> None:
    if ts[0].shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{name} kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, not {ts[0].shape[-1]}")
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{name} kernel needs CUDA tensors")
    if ts[0].dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, "
                        f"not {ts[0].dtype}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError(f"{name} needs a contiguous head dim")


class FlashFwdKernel(CudaKernel):
    """``flash_fwd``: ``(q, k, v, causal) -> (out, lse)``."""

    def __init__(self):
        super().__init__(
            "flash_fwd", "flash_fwd.cu",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])

    def __call__(self, q, k, v, causal: bool):
        """Launch on the current stream; returns ``(out, lse)``."""
        _check_inputs(q, k, v)
        _check_kernel_inputs(self.name, q, k, v)
        b, s, h, d = q.shape
        out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        if q.numel() == 0:
            return out, lse
        stream = torch.cuda.current_stream(q.device).cuda_stream
        self._launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), b, s, h, d,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *out.stride()[:3],
                     int(q.dtype == torch.bfloat16), int(causal),
                     1.0 / (d ** 0.5), stream)
        return out, lse


class FlashBwdKernel(CudaKernel):
    """``flash_dq`` (one output, dq) or ``flash_dkdv`` (two, dk and dv):
    ``(q, k, v, do, lse, dd, causal) -> outputs``, each ``(b, s, h, d)``
    contiguous in q's dtype."""

    def __init__(self, name: str, n_out: int):
        super().__init__(
            name, "flash_bwd.cu",
            [ctypes.c_void_p] * (6 + n_out) + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        self.n_out = n_out

    def __call__(self, q, k, v, do, lse, dd, causal: bool):
        """Launch on the current stream; returns the list of outputs."""
        _check_inputs(q, k, v)
        if do.shape != q.shape or do.dtype != q.dtype:
            raise ValueError("do must have q's shape and dtype")
        _check_kernel_inputs(self.name, q, k, v, do)
        b, s, h, d = q.shape
        for name, t in (("lse", lse), ("dd", dd)):
            if (t.shape != (b, h, s) or t.dtype != torch.float32
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError(f"{name} must be contiguous f32 (b, h, s) "
                                 f"on q's device")
        outs = [torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
                for _ in range(self.n_out)]
        if q.numel() == 0:
            return outs
        stream = torch.cuda.current_stream(q.device).cuda_stream
        self._launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
                     *(o.data_ptr() for o in outs), b, s, h, d,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *do.stride()[:3],
                     int(q.dtype == torch.bfloat16), int(causal),
                     1.0 / (d ** 0.5), stream)
        return outs


FLASH_FWD = FlashFwdKernel()
FLASH_DQ = FlashBwdKernel("flash_dq", 1)
FLASH_DKDV = FlashBwdKernel("flash_dkdv", 2)
KERNELS = (FLASH_FWD, FLASH_DQ, FLASH_DKDV)


def _check_inputs(q, k, v) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one (b, s, h, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError("q/k/v must share one dtype")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q/k/v must lie on one device")


def flash_attention_plain(q, k, v, causal: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in PyTorch ops: keys in tiles of
    :data:`BLOCK_K`, running max ``m`` and denominator ``l`` per row, p
    rounded to v's dtype before p·v, f32 accumulation.  Returns ``(out
    (b, s, h, d) in q's dtype, lse f32 (b, h, s))``.  On a card, keep
    ``torch.backends.cuda.matmul.allow_tf32`` False (its default): TF32
    products would miss the f32 tolerance."""
    _check_inputs(q, k, v)
    b, s, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    qf = q.permute(0, 2, 1, 3).float()                 # (b, h, s, d)
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    m = torch.full((b, h, s, 1), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    qpos = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, s, BLOCK_K):
        k1 = min(k0 + BLOCK_K, s)
        sc = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            sc = torch.where(qpos >= kpos, sc, -1e30)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        m = m_new
        acc = acc * corr + p.to(v.dtype).float() @ vf[:, :, k0:k1]
    lc = torch.clamp(l, min=1e-30)
    out = (acc / lc).to(q.dtype).permute(0, 2, 1, 3)
    lse = torch.where(l <= 0, 1e30, m + torch.log(lc))[..., 0]
    return out, lse


def flash_attention_fwd(q, k, v, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.is_cuda:
        return FLASH_FWD(q, k, v, causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, "
                         f"not {q.device}")
    return flash_attention_plain(q, k, v, causal)


def attention_delta(out, do) -> torch.Tensor:
    """``dd = rowsum(do * out)`` in f32, ``(b, h, s)`` contiguous: the
    backward's per-row term, computed outside the kernels as the JAX code
    does."""
    return ((do.float() * out.float()).sum(dim=-1)
            .permute(0, 2, 1).contiguous())


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal: bool = False
                              ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels' arithmetic in PyTorch ops, keys in tiles of
    :data:`BLOCK_K`: ``p = exp(s - lse)`` recomputed (masked scores at
    -1e30, so a dead row with lse 1e30 gives p = 0), ``ds = p * (do·vᵀ -
    dd)``; ``dq = Σ ds·k·scale`` with ds rounded to k's dtype, ``dk =
    Σ dsᵀ·q·scale`` with ds rounded to q's dtype, ``dv = Σ pᵀ·do`` with p
    rounded to do's dtype; f32 sums.  Returns ``(dq, dk, dv)``, each
    ``(b, s, h, d)`` in q's dtype.  As for :func:`flash_attention_plain`,
    keep TF32 off on a card."""
    _check_inputs(q, k, v)
    b, s, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    qf, kf, vf, dof = (x.permute(0, 2, 1, 3).float() for x in (q, k, v, do))
    lse = lse[..., None]
    dd = attention_delta(out, do)[..., None]
    dq = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    qpos = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, s, BLOCK_K):
        k1 = min(k0 + BLOCK_K, s)
        sc = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            sc = torch.where(qpos >= kpos, sc, -1e30)
        p = torch.exp(sc - lse)
        ds = p * (dof @ vf[:, :, k0:k1].transpose(-1, -2) - dd)
        dq += ds.to(k.dtype).float() @ kf[:, :, k0:k1]
        dk[:, :, k0:k1] = (ds.to(q.dtype).float().transpose(-1, -2) @ qf
                           * scale)
        dv[:, :, k0:k1] = p.to(do.dtype).float().transpose(-1, -2) @ dof
    return tuple(g.to(q.dtype).permute(0, 2, 1, 3)
                 for g in (dq * scale, dk, dv))


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False
                        ) -> Tuple[torch.Tensor, ...]:
    """``(dq, dk, dv)``: the CUDA kernels ``flash_dq`` and ``flash_dkdv``
    for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        dd = attention_delta(out, do)
        (dq,) = FLASH_DQ(q, k, v, do, lse, dd, causal)
        dk, dv = FLASH_DKDV(q, k, v, do, lse, dd, causal)
        return dq, dk, dv
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, "
                         f"not {q.device}")
    return flash_attention_bwd_plain(q, k, v, out, lse, do, causal)


class FlashAttention(torch.autograd.Function):
    """Forward through :func:`flash_attention_fwd`, which saves q, k, v,
    out and lse; backward through :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        do = grad_out.to(q.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False):
    """Flash attention: (b, s, h, d) q/k/v -> (b, s, h, d)."""
    return FlashAttention.apply(q, k, v, causal)


# The first prefill length from which the flash kernel stays faster than
# dense attention, causal f32 at (1, s, 16, 128), CUDA-event medians
# (chip_smoke.py phase 11 (i); NVIDIA H100 80GB HBM3, 700.00 W):
#     s      128    256    512    768    1024   1536   2048
#     dense  0.205  0.225  0.247  0.494  0.395  0.877  1.445 ms
#     flash  0.084  0.067  0.089  0.103  0.152  0.343  0.510 ms
# Flash is faster at every length measured, so the crossover is the
# shortest one.  The dispatcher keeps its shape: dense below the
# crossover, the kernel at or above it, and dense on the CPU.
DENSE_FLASH_CROSSOVER = 128


def dense_attention(q, k, v, causal: bool = False):
    """Dense attention that materializes the (s, s) scores — the
    correctness oracle, and the faster choice at short lengths."""
    d = q.shape[-1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / (d ** 0.5)
    if causal:
        n = q.shape[1]
        pos = torch.arange(n, device=q.device)
        sc = torch.where((pos[:, None] >= pos[None, :])[None, None], sc,
                         -1e30)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def attention(q, k, v, causal: bool = False, impl: str = "auto"):
    """Sequence-adaptive attention dispatch: ``impl="auto"`` picks the
    flash kernel on a CUDA tensor at or above
    :data:`DENSE_FLASH_CROSSOVER` tokens and dense attention otherwise;
    ``"dense"``/``"flash"`` force."""
    if impl == "auto":
        impl = "flash" if (q.shape[1] >= DENSE_FLASH_CROSSOVER
                           and q.is_cuda) else "dense"
    if impl == "dense":
        return dense_attention(q, k, v, causal)
    if impl == "flash":
        return flash_attention(q, k, v, causal)
    raise ValueError(f"unknown attention impl {impl!r}")

