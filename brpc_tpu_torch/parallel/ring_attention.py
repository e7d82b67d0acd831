"""Sequence parallelism for long context: ring attention and Ulysses.

Counterpart of ``brpc_tpu/parallel/ring_attention.py``, one program per
rank of the sequence axis, each holding ``s / n`` positions of q, k and v
as ``(batch, s_local, heads, dim)``:

- **ring attention**: q stays put; the k/v blocks go round the ring, one
  :func:`~.mesh_transport.ring_shift` per step, ``n`` steps, while an
  online softmax (running max, denominator and accumulator, all f32)
  folds each block in.  Causal masking uses global positions: the block
  held at step ``t`` started on rank ``(rank - t) % n``.
- **Ulysses**: an all_to_all re-shards sequence -> heads, each rank runs
  full-sequence attention over ``heads / n`` heads, and a second
  all_to_all shards back.  With ``use_flash`` the local attention is the
  port's :func:`~..ops.flash_attention.flash_attention`: the hand-written
  kernels on the card (forward, and both backward kernels under
  autograd), their plain versions on the CPU.

Every collective is differentiable, so both run under autograd.
"""

from __future__ import annotations

import math

import torch

from ..ops.flash_attention import dense_attention, flash_attention
from .mesh_transport import Axis, all_to_all, ring_shift


def _scores(q, k_blk, scale):
    """(b, sq, h, d) x (b, sk, h, d) -> (b, h, sq, sk) f32."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale


def make_ring_attention(mesh, axis: str = "sp", causal: bool = False):
    """``attend(q, k, v) -> out``, each this rank's ``(b, s/n, h, d)``
    block of the sequence."""
    ax = Axis(mesh, axis)
    n = ax.size

    def attend(q, k, v):
        b, sl, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        dev = q.device
        q_pos = ax.rank * sl + torch.arange(sl, device=dev)
        m = torch.full((b, h, sl), -1e30, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, sl), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, sl, h, d), dtype=torch.float32, device=dev)
        k_blk, v_blk = k, v
        for step in range(n):
            src = (ax.rank - step) % n
            s = _scores(q, k_blk, scale)
            if causal:
                k_pos = src * sl + torch.arange(sl, device=dev)
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask[None, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
            acc = acc * corr.transpose(1, 2)[..., None] + pv
            m = m_new
            k_blk = ring_shift(k_blk, ax, 1)
            v_blk = ring_shift(v_blk, ax, 1)
        out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
        return out.to(q.dtype)

    return attend


def make_ulysses_attention(mesh, axis: str = "sp", causal: bool = False,
                           use_flash: bool = False):
    """``attend(q, k, v) -> out`` on this rank's sequence block: sequence
    <-> head all_to_all, full local attention, exchange back.  The heads
    must divide by the axis size."""
    ax = Axis(mesh, axis)
    n = ax.size

    def attend(q, k, v):
        heads = q.shape[2]
        if heads % n:
            raise ValueError(f"Ulysses needs heads ({heads}) divisible by "
                             f"the {axis!r} axis ({n})")
        qf, kf, vf = (all_to_all(t, ax, 2, 1) for t in (q, k, v))
        if use_flash:
            out = flash_attention(qf, kf, vf, causal)
        else:
            d = qf.shape[-1]
            s_mat = _scores(qf, kf, 1.0 / math.sqrt(d))
            if causal:
                pos = torch.arange(qf.shape[1], device=q.device)
                mask = (pos[:, None] >= pos[None, :])[None, None]
                s_mat = torch.where(mask, s_mat, -1e30)
            p = torch.softmax(s_mat, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", p, vf.float())
        return all_to_all(out.to(q.dtype), ax, 1, 2)

    return attend


def reference_attention(q, k, v, causal: bool = False):
    """Dense single-device attention -- the tests' oracle
    (``ops.flash_attention.dense_attention``)."""
    return dense_attention(q, k, v, causal=causal)
