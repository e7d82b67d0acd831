"""The numerics of the tensor-core flash kernels, checked on the CPU before
any card runs them: every product done as 3xTF32, as
``csrc/flash_mma.cuh`` does it (``hi = rna_tf32(x)``, ``lo = rna_tf32(x -
hi)``, ``a·b ≈ lo_a·hi_b + hi_a·lo_b + hi_a·hi_b``; in the dkdv kernel the
A operands' lo is truncated instead, ``split_tf32_fast``), in the kernels'
own recurrence (32-key tiles, running max in log2 units, ``exp2``; dkdv
key-major over 16-row q tiles).  The forward, the dq and the dk/dv
recurrences are held against the JAX package's Pallas ``flash_attention``
in interpret mode, as tests/test_torch_flash_attention.py and
tests/test_torch_flash_backward.py run it, with their cases.

Tolerances: out and lse 1e-4 abs/rel, as ``chip_smoke.py`` holds the
forward kernel to its plain version (``TOL``, ``LSE_TOL``); dq, dk and dv
rtol 2e-4 / atol 2e-5, as the JAX package's gradient tests.  ``rna_tf32`` here is the
emulation of ``cvt.rna.tf32.f32``: add 0x1000 to the int32 view and mask
with 0xFFFFE000 (round to nearest, ties away from zero, on the magnitude).
Nothing on the main path uses these helpers.
"""

import jax  # noqa: F401  (JAX on the CPU, as conftest sets it)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.ops import flash_attention as jfa

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
BK = 32            # keys per tile, as the kernels' BK / DQ_BK
TOL = 1e-4
RTOL, ATOL = 2e-4, 2e-5


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep 10 explicit mantissa bits, rounding to
    nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of a tf32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def split_fast(x: torch.Tensor):
    """``split_tf32_fast``: lo = x - hi reaches the MMA unrounded."""
    hi = rna_tf32(x)
    return hi, trunc_tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor, split_a=split) -> torch.Tensor:
    """``a @ b`` as three tf32 products with f32 sums, small terms first."""
    ah, al = split_a(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm3_fast_a(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3xTF32 as the dkdv kernel does it: its A operands (k, v, p, ds)
    take the fast split per step, its B tiles (q, do) the rounded split
    once in shared memory."""
    return mm3(a, b, split_a=split_fast)


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as one tf32 product (what the kernels must not do)."""
    return rna_tf32(a) @ rna_tf32(b)


def _mask(sc, k0, k1, causal):
    if not causal:
        return sc
    s = sc.shape[-2]
    keep = torch.arange(s)[:, None] >= torch.arange(k0, k1)[None, :]
    return torch.where(keep, sc, -1e30)


def fwd_emulated(q, k, v, causal, mm=mm3):
    """The forward kernel's recurrence on f32 (b, s, h, d) inputs."""
    b, s, h, d = q.shape
    sl = LOG2E / d ** 0.5
    qf, kf, vf = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, s, BK):
        k1 = min(k0 + BK, s)
        x = _mask(mm(qf, kf[:, :, k0:k1].transpose(-1, -2)) * sl, k0, k1,
                  causal)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        acc = acc * corr + mm(p, vf[:, :, k0:k1])
    lc = l.clamp(min=1e-30)
    out = (acc / lc).permute(0, 2, 1, 3)
    lse = torch.where(l <= 0, 1e30, m * LN2 + torch.log(lc))[..., 0]
    return out, lse


def dq_emulated(q, k, v, out, lse, do, causal):
    """The dq kernel's recurrence: p from lse in log2 units, dp = do·vᵀ,
    ds = p (dp - dd), dq = Σ ds·k · scale."""
    b, s, h, d = q.shape
    scale = 1.0 / d ** 0.5
    qf, kf, vf, dof = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    dd = (do * out).sum(-1).permute(0, 2, 1)[..., None]
    lse2 = lse[..., None] * LOG2E
    dq = torch.zeros((b, h, s, d))
    for k0 in range(0, s, BK):
        k1 = min(k0 + BK, s)
        x = _mask(mm3(qf, kf[:, :, k0:k1].transpose(-1, -2)) * scale * LOG2E,
                  k0, k1, causal)
        p = torch.exp2(x - lse2)
        ds = p * (mm3(dof, vf[:, :, k0:k1].transpose(-1, -2)) - dd)
        dq += mm3(ds, kf[:, :, k0:k1])
    return (dq * scale).permute(0, 2, 1, 3)


def dkdv_emulated(q, k, v, out, lse, do, causal, bq=16, mm=mm3_fast_a):
    """The dkdv kernel's recurrence, key-major: for all keys at once, q
    tiles of ``bq`` rows in order (from the first key when causal, as for
    the kernel's first key block), sᵀ = k·qᵀ, pᵀ = exp2(sᵀ·scale·log2e -
    lse·log2e), dv += pᵀ·do, dpᵀ = v·doᵀ, dsᵀ = pᵀ (dpᵀ - dd), dk += dsᵀ·q;
    dk times scale at the end.  Returns ``(dk, dv)``."""
    b, s, h, d = q.shape
    scale = 1.0 / d ** 0.5
    qf, kf, vf, dof = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    dd = (do * out).sum(-1).permute(0, 2, 1)[..., None, :]   # (b, h, 1, s)
    lse2 = lse[..., None, :] * LOG2E
    dk = torch.zeros((b, h, s, d))
    dv = torch.zeros((b, h, s, d))
    for q0 in range(0, s, bq):
        q1 = min(q0 + bq, s)
        x = mm(kf, qf[:, :, q0:q1].transpose(-1, -2)) * scale * LOG2E
        if causal:
            keep = torch.arange(q0, q1)[None, :] >= torch.arange(s)[:, None]
            x = torch.where(keep, x, -1e30)
        p = torch.exp2(x - lse2[..., q0:q1])
        dv += mm(p, dof[:, :, q0:q1])
        ds = p * (mm(vf, dof[:, :, q0:q1].transpose(-1, -2))
                  - dd[..., q0:q1])
        dk += mm(ds, qf[:, :, q0:q1])
    return ((dk * scale).permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3))


def _inputs(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for _ in range(n)]


def _jax_fwd(q, k, v, causal):
    out, lse = jfa._pallas_forward(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal, None, None, True)
    return np.asarray(out), np.asarray(lse)[:, :, :q.shape[1], 0]


def test_rna_tf32_rounding():
    one = 1.0
    ulp = 2.0 ** -10          # tf32's last mantissa bit at 1.0
    x = torch.tensor([one, one + ulp / 2, one + ulp / 4, -(one + ulp / 2),
                      one + ulp / 2 - 2.0 ** -23, 3.0e-3, 0.0])
    got = rna_tf32(x).tolist()
    assert got[0] == one
    assert got[1] == one + ulp                # a tie goes away from zero
    assert got[2] == one                      # below half an ulp: down
    assert got[3] == -(one + ulp)             # ties away on the magnitude
    assert got[4] == one
    assert got[6] == 0.0
    # 10 explicit mantissa bits survive, the low 13 are zero
    assert (rna_tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF).eq(0).all()
    # hi + lo keeps about 22 bits: within 2^-21 relative of x
    y = torch.randn(10000)
    hi, lo = split(y)
    assert ((hi + lo - y).abs() <= y.abs() * 2.0 ** -21).all()


def test_fast_split_error_bound():
    """``split_tf32_fast``: hi is ``cvt.rna``'s, and hi plus the lo that
    the tensor cores read is within 2^-21 of x."""
    y = torch.randn(10000) * torch.logspace(-20, 20, 10000)
    hi, lo = split_fast(y)
    assert torch.equal(hi, split(y)[0])
    assert ((hi + lo - y).abs() <= y.abs() * 2.0 ** -21).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()


FWD_CASES = [(2, 64, 2, 16), (1, 40, 2, 16), (1, 100, 2, 24), (1, 129, 2, 8)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", FWD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_fwd_3xtf32_matches_jax(shape, causal):
    q, k, v = _inputs(shape, seed=sum(shape))
    jout, jlse = _jax_fwd(q, k, v, causal)
    out, lse = fwd_emulated(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    np.testing.assert_allclose(out.numpy(), jout, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_single_pass_tf32_is_far_worse(causal):
    """Why three products: one tf32 pass is orders of magnitude further
    from the reference than 3xTF32."""
    q, k, v = _inputs((1, 256, 2, 64), seed=5)
    jout, _ = _jax_fwd(q, k, v, causal)
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    e3 = np.abs(fwd_emulated(*ts, causal)[0].numpy() - jout).max()
    e1 = np.abs(fwd_emulated(*ts, causal, mm=mm1)[0].numpy() - jout).max()
    assert e3 < 1e-5 and e1 > 50 * e3


# (b, s, h, d, causal, (block_q, block_k) of the JAX kernel), as in
# tests/test_torch_flash_backward.py
BWD_CASES = [(1, 48, 2, 16, True, (None, None)),
             (2, 40, 2, 16, True, (32, 64)),
             (2, 100, 2, 24, False, (32, 64)),
             (2, 256, 2, 16, True, (32, 64))]


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: f"s{c[1]}d{c[3]}{'c' if c[4] else ''}")
def test_dq_3xtf32_matches_jax_grad(case):
    b, s, h, d, causal, blocks = case
    q, k, v, g = _inputs((b, s, h, d), seed=s + d, n=4)

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal, *blocks) * g)

    want = np.asarray(jax.grad(loss)(*(jnp.asarray(x) for x in (q, k, v))))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = fwd_emulated(tq, tk, tv, causal)
    got = dq_emulated(tq, tk, tv, out, lse, tg, causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _jax_dkdv(q, k, v, g, causal, blocks):
    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal, *blocks) * g)

    return [np.asarray(x) for x in jax.grad(loss, argnums=(1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))]


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: f"s{c[1]}d{c[3]}{'c' if c[4] else ''}")
def test_dkdv_3xtf32_matches_jax_grad(case):
    b, s, h, d, causal, blocks = case
    q, k, v, g = _inputs((b, s, h, d), seed=s + d, n=4)
    want_dk, want_dv = _jax_dkdv(q, k, v, g, causal, blocks)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = fwd_emulated(tq, tk, tv, causal)
    dk, dv = dkdv_emulated(tq, tk, tv, out, lse, tg, causal)
    np.testing.assert_allclose(dk.numpy(), want_dk, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dv.numpy(), want_dv, rtol=RTOL, atol=ATOL)


def test_dkdv_single_pass_tf32_is_far_worse():
    """dk through one tf32 pass per product is far further from the JAX
    gradient than through 3xTF32."""
    q, k, v, g = _inputs((1, 256, 2, 64), seed=6, n=4)
    want_dk, _ = _jax_dkdv(q, k, v, g, True, (None, None))
    ts = [torch.from_numpy(x) for x in (q, k, v, g)]
    out, lse = fwd_emulated(*ts[:3], True)
    e3 = np.abs(dkdv_emulated(*ts[:3], out, lse, ts[3], True)[0].numpy()
                - want_dk).max()
    e1 = np.abs(dkdv_emulated(*ts[:3], out, lse, ts[3], True, mm=mm1)[0]
                .numpy() - want_dk).max()
    assert e3 < 2e-5 and e1 > 50 * e3
