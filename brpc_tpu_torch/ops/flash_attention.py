"""Flash attention for the port: a hand-written CUDA forward kernel, its
plain PyTorch version, and the ``attention()`` dispatcher.

Counterpart of ``brpc_tpu/ops/flash_attention.py``.  The Pallas forward
``_fwd_kernel`` becomes ``csrc/flash_fwd.cu`` (CUDA C++ for sm_90a,
built by :mod:`.cuda_build`, called through ctypes).  On a CUDA tensor
:func:`flash_attention_fwd` launches that kernel or raises; on a CPU
tensor it runs :func:`flash_attention_plain`, the same online-softmax
arithmetic in PyTorch ops.  Nothing catches a build or launch error to
run the plain version instead.

Layouts follow the JAX package: q/k/v/out are ``(b, s, h, d)``; the
log-sum-exp is f32 ``(b, h, s)`` (the JAX one is padded,
``(b, h, s_pad, 1)``).  The backward kernels (``_dq_kernel``,
``_dkdv_kernel``) are not ported yet, so ``flash_attention``'s gradient
raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build

# Key tile of the kernel (csrc/flash_fwd.cu BK); the plain version walks
# keys in the same tiles.
BLOCK_K = 32
MAX_HEAD_DIM = 128


class FlashFwdKernel:
    """ctypes binding of ``flash_fwd`` with its launch count."""

    name = "flash_fwd"
    source = "flash_fwd.cu"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            lib = cuda_build.load(self.source)
            fn = lib.flash_fwd
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                           + [ctypes.c_longlong] * 12
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                              ctypes.c_void_p])
            lib.flash_fwd_error_string.restype = ctypes.c_char_p
            lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
            self._err = lib.flash_fwd_error_string
            self._fn = fn
        return self._fn

    def __call__(self, q, k, v, causal: bool):
        """Launch on the current stream; returns ``(out, lse)``."""
        _check_inputs(q, k, v)
        if not (q.is_cuda and k.is_cuda and v.is_cuda):
            raise ValueError("flash_fwd kernel needs CUDA tensors")
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_fwd takes float32 or bfloat16, "
                            f"not {q.dtype}")
        if any(t.stride(-1) != 1 for t in (q, k, v)):
            raise ValueError("flash_fwd needs a contiguous head dim")
        b, s, h, d = q.shape
        out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        if q.numel() == 0:
            return out, lse
        fn = self._bind()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, s, h, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3],
                 int(q.dtype == torch.bfloat16), int(causal),
                 1.0 / (d ** 0.5), stream)
        if err != 0:
            raise RuntimeError(f"flash_fwd launch failed: "
                               f"{self._err(err).decode()} ({err})")
        self.launches += 1
        return out, lse


FLASH_FWD = FlashFwdKernel()


def _check_inputs(q, k, v) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one (b, s, h, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError("q/k/v must share one dtype")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q/k/v must lie on one device")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]} exceeds {MAX_HEAD_DIM}")


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


class FlashAttention(torch.autograd.Function):
    """Forward through :func:`flash_attention_fwd`; no backward yet."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, _ = flash_attention_fwd(q, k, v, causal)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash attention backward (_dq_kernel, _dkdv_kernel) arrives "
            "with the training slice of the port")


def flash_attention(q, k, v, causal: bool = False):
    """Flash attention: (b, s, h, d) q/k/v -> (b, s, h, d)."""
    return FlashAttention.apply(q, k, v, causal)


# Carried over from the JAX package, where it is a TPU measurement (v5e);
# not yet measured on the H100.  The dispatcher keeps its shape: dense
# below the crossover, the kernel at or above it, and dense on the CPU.
DENSE_FLASH_CROSSOVER = 2048


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

