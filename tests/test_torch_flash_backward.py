"""The port's flash-attention gradient (its plain backward, as it runs on
the CPU) against ``jax.grad`` through the JAX package's Pallas
``flash_attention`` in interpret mode, with the cases of
tests/test_flash_attention.py; and inside the port, the plain backward
against autograd through dense attention.

Tolerances: f32 rtol 2e-4 / atol 2e-5, as the JAX package's own gradient
tests.  In bf16 both sides round ds and p to bf16 before their products,
round the outputs to bf16, and sum in another order, so one rounding of a
ds term can flip; the gradients are held to 3e-2 of the largest
magnitude of each gradient plus 3e-2 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.ops import flash_attention as jfa
from brpc_tpu_torch.ops import flash_attention as tfa

RTOL, ATOL = 2e-4, 2e-5
BF16_TOL = 3e-2


def _inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = ((rng.standard_normal((b, s, h, d)) * 0.5).astype(np.float32)
                  for _ in range(4))
    return q, k, v, g


def _jax_grads(q, k, v, g, causal, blocks, dtype):
    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal, *blocks)
        return jnp.sum(out.astype(jnp.float32) * g)

    args = (jnp.asarray(x, dtype) for x in (q, k, v))
    return [np.asarray(x.astype(jnp.float32))
            for x in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, g, causal, dtype):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True)
          for x in (q, k, v)]
    out = tfa.flash_attention(*ts, causal)
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert all(t.grad.dtype == dtype for t in ts)
    return [t.grad.float().numpy() for t in ts]


# (b, s, h, d, causal, (block_q, block_k) of the JAX kernel)
CASES = [(1, 48, 2, 16, True, (None, None)),
         (2, 40, 2, 16, True, (32, 64)),
         (2, 100, 2, 24, False, (32, 64)),
         (2, 256, 2, 16, True, (32, 64))]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"s{c[1]}d{c[3]}{'c' if c[4] else ''}")
def test_f32_grads_match_jax_pallas(case):
    b, s, h, d, causal, blocks = case
    q, k, v, g = _inputs(b, s, h, d, seed=s + d)
    want = _jax_grads(q, k, v, g, causal, blocks, jnp.float32)
    got = _port_grads(q, k, v, g, causal, torch.float32)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{name}")


# head dims past 128, which the kernels pad to 256
WIDE_CASES = [(1, 72, 2, 136, True, (None, None)),
              (1, 100, 1, 192, False, (None, None)),
              (1, 128, 2, 256, True, (None, None))]


@pytest.mark.parametrize("case", WIDE_CASES,
                         ids=lambda c: f"s{c[1]}d{c[3]}{'c' if c[4] else ''}")
def test_f32_wide_head_grads_match_jax_pallas(case):
    b, s, h, d, causal, blocks = case
    q, k, v, g = _inputs(b, s, h, d, seed=s + d)
    want = _jax_grads(q, k, v, g, causal, blocks, jnp.float32)
    got = _port_grads(q, k, v, g, causal, torch.float32)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_grads_match_jax_pallas(causal):
    q, k, v, g = _inputs(1, 72, 2, 32, seed=3)
    want = _jax_grads(q, k, v, g, causal, (32, 64), jnp.bfloat16)
    got = _port_grads(q, k, v, g, causal, torch.bfloat16)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a, w, rtol=BF16_TOL,
                                   atol=BF16_TOL * np.abs(w).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_bwd_matches_dense_autograd(causal):
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(2, 70, 3, 32, seed=11))
    out, lse = tfa.flash_attention_plain(q, k, v, causal)
    got = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal)
    ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(tfa.dense_attention(*ts, causal), ts, g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=RTOL, atol=ATOL)


def test_dead_rows_give_zero_grads():
    """A row whose lse is 1e30 (no live key) contributes p = 0: its dq is
    zero and it adds nothing to dk or dv."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 8, 1, 16, seed=2))
    out, lse = tfa.flash_attention_plain(q, k, v, True)
    lse[:, :, 3] = 1e30
    dq, dk, dv = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, True)
    assert torch.equal(dq[:, 3], torch.zeros_like(dq[:, 3]))
    g2 = g.clone()
    g2[:, 3] = 0.0
    _, dk2, dv2 = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g2, True)
    torch.testing.assert_close(dv, dv2)
    torch.testing.assert_close(dk, dk2)


def test_non_contiguous_v():
    """q/k/v as strided views of one qkv projection, as the model gives
    them: the same gradients as contiguous copies."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal((2, 45, 2, 48)).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((2, 45, 2, 16))
                         .astype(np.float32))

    def grads(contiguous):
        qkv = torch.from_numpy(base).requires_grad_(True)
        q, k, v = qkv.split(16, dim=-1)
        if contiguous:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        torch.autograd.backward(tfa.flash_attention(q, k, v, True), g)
        return qkv.grad

    assert not torch.from_numpy(base).split(16, dim=-1)[2].is_contiguous()
    torch.testing.assert_close(grads(False), grads(True))


def test_backward_dispatch_and_errors():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 8, seed=1))
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    # on the CPU the dispatcher is the plain version, bit for bit
    got = tfa.flash_attention_bwd(q, k, v, out, lse, g, True)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, True)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    dd = tfa.attention_delta(out, g)
    assert dd.shape == (1, 2, 16) and dd.is_contiguous()
    for kern in (tfa.FLASH_DQ, tfa.FLASH_DKDV):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kern(q, k, v, g, lse, dd, True)
        with pytest.raises(ValueError, match="shape and dtype"):
            kern(q, k, v, g[:, :8], lse, dd, True)
    # the launch counters move only where a kernel launches
    assert tfa.FLASH_DQ.launches == tfa.FLASH_DKDV.launches == 0


def test_backward_kernels_on_card():
    """flash_dq / flash_dkdv against the plain backward (runs where a card
    is): s not a multiple of the tiles, d = 24 (zero-padded to 32), d =
    136 and 256 (the d = 256 schedules), and unaligned q/k/v/do views
    (the per-element loads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; python3 chip_smoke.py runs this "
                    "check and more on the card")
    for shape, offset in (((1, 129, 4, 64), 0), ((1, 100, 3, 24), 0),
                          ((2, 77, 2, 24), 1), ((1, 129, 2, 136), 0),
                          ((1, 100, 2, 256), 1)):
        b, s, h, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                rng = np.random.default_rng(sum(shape))
                x = torch.from_numpy(
                    (rng.standard_normal((b, s, h, 4 * d + offset)) * 0.5)
                    .astype(np.float32)).cuda().to(dtype)
                q, k, v, g = (x[..., offset + i * d: offset + (i + 1) * d]
                              for i in range(4))
                out, lse = tfa.FLASH_FWD(q, k, v, causal)
                dd = tfa.attention_delta(out, g)
                (dq,) = tfa.FLASH_DQ(q, k, v, g, lse, dd, causal)
                dk, dv = tfa.FLASH_DKDV(q, k, v, g, lse, dd, causal)
                want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                                     causal)
                for a, w in zip((dq, dk, dv), want):
                    w = w.float()
                    tol = RTOL if dtype == torch.float32 else BF16_TOL
                    atol = (ATOL if dtype == torch.float32 else BF16_TOL
                            ) * float(w.abs().max())
                    torch.testing.assert_close(a.float(), w, rtol=tol,
                                               atol=atol)
