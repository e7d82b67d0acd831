"""The port's flash attention (its plain version, as it runs on the CPU)
against the JAX package's Pallas forward in interpret mode, as
tests/test_flash_attention.py runs it: out and log-sum-exp, causal and
not, padded shapes.

Tolerances: f32 2e-5 abs/rel, as the JAX package's own flash tests.  In
bf16 both sides round p to bf16 before p·v and the output to bf16, but
sum in another order, so the output may differ by one bf16 rounding:
2e-2 abs/rel on out, 2e-5 on the f32 lse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.ops import flash_attention as jfa
from brpc_tpu_torch.ops import flash_attention as tfa

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _qkv(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, s, h, d)) * 0.5).astype(np.float32)
            for _ in range(3)]


def _jax_fwd(q, k, v, causal, dtype):
    out, lse = jfa._pallas_forward(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), causal, None, None,
        True)
    s = q.shape[1]
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(lse)[:, :, :s, 0])


def _port_fwd(q, k, v, causal, dtype):
    out, lse = tfa.flash_attention_fwd(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)), causal)
    assert out.dtype == dtype and lse.dtype == torch.float32
    return out.float().numpy(), lse.numpy()


CASES = [(2, 64, 2, 16), (1, 40, 2, 16), (1, 100, 2, 24), (1, 129, 2, 8)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", CASES, ids=lambda c: "x".join(map(str, c)))
def test_f32_matches_jax(shape, causal):
    q, k, v = _qkv(*shape, seed=sum(shape))
    jout, jlse = _jax_fwd(q, k, v, causal, jnp.float32)
    tout, tlse = _port_fwd(q, k, v, causal, torch.float32)
    np.testing.assert_allclose(tout, jout, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(tlse, jlse, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", CASES[1:], ids=lambda c: "x".join(map(str, c)))
def test_bf16_matches_jax(shape, causal):
    q, k, v = _qkv(*shape, seed=7 + sum(shape))
    jout, jlse = _jax_fwd(q, k, v, causal, jnp.bfloat16)
    tout, tlse = _port_fwd(q, k, v, causal, torch.bfloat16)
    np.testing.assert_allclose(tout, jout, rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(tlse, jlse, rtol=F32_TOL, atol=F32_TOL)


# head dims past 128, which the kernels pad to 256 (and JAX to 256 too)
WIDE_CASES = [(1, 72, 2, 136), (1, 100, 1, 192), (1, 128, 2, 256)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", WIDE_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_f32_wide_heads_match_jax(shape, causal):
    q, k, v = _qkv(*shape, seed=sum(shape))
    jout, jlse = _jax_fwd(q, k, v, causal, jnp.float32)
    tout, tlse = _port_fwd(q, k, v, causal, torch.float32)
    np.testing.assert_allclose(tout, jout, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(tlse, jlse, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_dense_inside_port(causal):
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 70, 3, 32, seed=11))
    got = tfa.flash_attention(q, k, v, causal)
    want = tfa.dense_attention(q, k, v, causal)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    jwant = jfa.dense_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                causal)
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant),
                               rtol=F32_TOL, atol=F32_TOL)


def test_non_contiguous_inputs():
    """q/k/v as strided views of one qkv projection, as prefill gives
    them: the same answer as contiguous copies."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((1, 33, 2, 48))
                           .astype(np.float32))
    q, k, v = qkv.split(16, dim=-1)
    got, lse = tfa.flash_attention_fwd(q, k, v, True)
    want, wlse = tfa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                         v.contiguous(), True)
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(lse, wlse)


def test_dispatch_and_errors():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 16, 2, 8, seed=1))
    # auto never picks the kernel on the CPU, whatever the length
    torch.testing.assert_close(tfa.attention(q, k, v, True),
                               tfa.dense_attention(q, k, v, True))
    with pytest.raises(ValueError, match="unknown attention impl"):
        tfa.attention(q, k, v, impl="ring")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.FLASH_FWD(q, k, v, True)
    # head dims up to 256 pass the kernels' head-dim check (a CPU tensor
    # then fails the device check); past 256 the kernels refuse them, and
    # the plain version (every CPU path) takes any, as the JAX kernel does
    wide = torch.ones(1, 4, 1, 136)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.FLASH_FWD(wide, wide, wide, True)
    big = torch.ones(1, 4, 1, 264)
    with pytest.raises(ValueError, match="head dims up to 256"):
        tfa.FLASH_FWD(big, big, big, True)
    out, _ = tfa.flash_attention_fwd(big, big, big)
    torch.testing.assert_close(out, big)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.FLASH_DQ(q, k, v, q, torch.zeros(1, 2, 16), torch.zeros(1, 2, 16),
                     True)
    # the gradient runs (plain backward on the CPU); its values are held
    # to the JAX package's in tests/test_torch_flash_backward.py
    qg = q.clone().requires_grad_(True)
    tfa.flash_attention(qg, k, v, True).sum().backward()
    assert qg.grad.shape == q.shape and torch.isfinite(qg.grad).all()


def _card_inputs(shape, dtype, seed, offset):
    """q, k, v on the card; with ``offset`` each is a view into a wider
    projection that starts ``offset`` elements in, so rows are not
    16-byte aligned and the kernel takes its per-element load path."""
    b, s, h, d = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((b, s, h, 3 * d + offset))
                          * 0.5).astype(np.float32)).cuda().to(dtype)
    return [x[..., offset + i * d: offset + (i + 1) * d] for i in range(3)]


def test_kernel_on_card():
    """The CUDA kernel against the plain version (runs where a card is):
    s not a multiple of the q tile or the 32-key k tile, d = 24
    (zero-padded to 32) and d = 136 (to 256), d = 256, unaligned views
    (the per-element loads), and every f32 schedule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; python3 chip_smoke.py runs this "
                    "check and more on the card")
    # the f32 forward picks its schedule by grid size (flash_fwd.cu
    # launch): the (1, 2xxx, 48, 24) grids take Wide, (2, 1000, 16, 24)
    # Narrow, the small ones KSplit
    for shape, offset in (((1, 129, 4, 64), 0), ((1, 100, 3, 24), 0),
                          ((2, 77, 2, 24), 1), ((1, 129, 4, 64), 1),
                          ((1, 2048, 48, 24), 0), ((1, 2000, 48, 24), 1),
                          ((2, 1000, 16, 24), 0), ((2, 1000, 16, 24), 1),
                          ((1, 129, 2, 136), 0), ((1, 100, 2, 256), 1)):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, BF16_TOL)):
            for causal in (False, True):
                q, k, v = _card_inputs(shape, dtype, sum(shape), offset)
                out, lse = tfa.FLASH_FWD(q, k, v, causal)
                pout, plse = tfa.flash_attention_plain(q, k, v, causal)
                torch.testing.assert_close(out.float(), pout.float(),
                                           rtol=tol, atol=tol)
                torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
