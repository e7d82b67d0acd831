"""The numerics of the tensor-core flash kernels, checked on the CPU before
any card runs them: every product done as 3xTF32, as
``csrc/flash_mma.cuh`` does it (``hi = rna_tf32(x)``, ``lo = rna_tf32(x -
hi)``, ``a·b ≈ lo_a·hi_b + hi_a·lo_b + hi_a·hi_b``; in the dkdv kernel the
A operands' lo is truncated instead, ``split_tf32_fast``), in the kernels'
own recurrence (32-key tiles, running max in log2 units, ``exp2``; dkdv
key-major over 16-row q tiles).  The forward, the dq and the dk/dv
recurrences are held against the JAX package's Pallas ``flash_attention``
in interpret mode, as tests/test_torch_flash_attention.py and
tests/test_torch_flash_backward.py run it, with their cases.  At head dims
129-256 (padded to 256) the f32 forward and dk/dv kernels run warp pairs
that split the head dim (``pair_sum`` in ``csrc/flash_mma.cuh``): each
score product is the sum of two 3xTF32 partials, over columns 0-127 and
128-255, first half first (``mm3_halves``), and every split of those two
kernels there takes the three-instruction split (``mm3_fast``).

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


def mm3(a: torch.Tensor, b: torch.Tensor, split_a=split,
        split_b=split) -> torch.Tensor:
    """``a @ b`` as three tf32 products with f32 sums, small terms first."""
    ah, al = split_a(a)
    bh, bl = split_b(b)
    return al @ bh + ah @ bl + ah @ bh


def mm3_fast_a(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3xTF32 as the dkdv kernel does it: its A operands (k, v, p, ds)
    take the fast split per step, its B tiles (q, do) the rounded split
    once in shared memory."""
    return mm3(a, b, split_a=split_fast)


def mm3_fast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3xTF32 as the f32 D = 256 forward and dkdv take it: every split,
    of A and of B, the three-instruction one (``split_tf32_fast``)."""
    return mm3(a, b, split_a=split_fast, split_b=split_fast)


def mm3_halves(a: torch.Tensor, b: torch.Tensor, mm=mm3,
               half: int = 128) -> torch.Tensor:
    """A score product as a warp pair takes it: the partial ``mm`` over
    the first ``half`` columns of the contracted dim (a's last, b's second
    to last) plus the partial over the rest, first half first."""
    first = mm(a[..., :half], b[..., :half, :])
    second = mm(a[..., half:], b[..., half:, :])
    return first + second


def mm3_halves_fast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``mm3_halves`` of ``mm3_fast`` partials: the f32 D = 256 kernels'
    score products."""
    return mm3_halves(a, b, mm=mm3_fast)


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as one tf32 product (what the kernels must not do)."""
    return rna_tf32(a) @ rna_tf32(b)


def _mask(sc, k0, k1, causal):
    if not causal:
        return sc
    s = sc.shape[-2]
    keep = torch.arange(s)[:, None] >= torch.arange(k0, k1)[None, :]
    return torch.where(keep, sc, -1e30)


def fwd_emulated(q, k, v, causal, mm=mm3, mm_s=None):
    """The forward kernel's recurrence on f32 (b, s, h, d) inputs; the
    scores through ``mm_s`` (``mm`` unless given), p·v through ``mm``."""
    mm_s = mm_s or mm
    b, s, h, d = q.shape
    sl = LOG2E / d ** 0.5
    qf, kf, vf = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, s, BK):
        k1 = min(k0 + BK, s)
        x = _mask(mm_s(qf, kf[:, :, k0:k1].transpose(-1, -2)) * sl, k0, k1,
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


def dq_emulated(q, k, v, out, lse, do, causal, bk=BK):
    """The dq kernel's recurrence over ``bk``-key tiles: p from lse in
    log2 units, dp = do·vᵀ, ds = p (dp - dd), dq = Σ ds·k · scale."""
    b, s, h, d = q.shape
    scale = 1.0 / d ** 0.5
    qf, kf, vf, dof = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    dd = (do * out).sum(-1).permute(0, 2, 1)[..., None]
    lse2 = lse[..., None] * LOG2E
    dq = torch.zeros((b, h, s, d))
    for k0 in range(0, s, bk):
        k1 = min(k0 + bk, s)
        x = _mask(mm3(qf, kf[:, :, k0:k1].transpose(-1, -2)) * scale * LOG2E,
                  k0, k1, causal)
        p = torch.exp2(x - lse2)
        ds = p * (mm3(dof, vf[:, :, k0:k1].transpose(-1, -2)) - dd)
        dq += mm3(ds, kf[:, :, k0:k1])
    return (dq * scale).permute(0, 2, 1, 3)


def dkdv_emulated(q, k, v, out, lse, do, causal, bq=16, mm=mm3_fast_a,
                  mm_s=None):
    """The dkdv kernel's recurrence, key-major: for all keys at once, q
    tiles of ``bq`` rows in order (from the first key when causal, as for
    the kernel's first key block), sᵀ = k·qᵀ, pᵀ = exp2(sᵀ·scale·log2e -
    lse·log2e), dv += pᵀ·do, dpᵀ = v·doᵀ, dsᵀ = pᵀ (dpᵀ - dd), dk += dsᵀ·q;
    dk times scale at the end.  sᵀ and dpᵀ through ``mm_s`` (``mm`` unless
    given), the dv and dk products through ``mm``.  Returns ``(dk, dv)``."""
    mm_s = mm_s or mm
    b, s, h, d = q.shape
    scale = 1.0 / d ** 0.5
    qf, kf, vf, dof = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    dd = (do * out).sum(-1).permute(0, 2, 1)[..., None, :]   # (b, h, 1, s)
    lse2 = lse[..., None, :] * LOG2E
    dk = torch.zeros((b, h, s, d))
    dv = torch.zeros((b, h, s, d))
    for q0 in range(0, s, bq):
        q1 = min(q0 + bq, s)
        x = mm_s(kf, qf[:, :, q0:q1].transpose(-1, -2)) * scale * LOG2E
        if causal:
            keep = torch.arange(q0, q1)[None, :] >= torch.arange(s)[:, None]
            x = torch.where(keep, x, -1e30)
        p = torch.exp2(x - lse2[..., q0:q1])
        dv += mm(p, dof[:, :, q0:q1])
        ds = p * (mm_s(vf, dof[:, :, q0:q1].transpose(-1, -2))
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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [136, 256])
def test_3xtf32_at_head_dim_256(d, causal):
    """The d = 256 schedules' tiling (d = 136 zero-padded to them): the
    forward over 32-key tiles, dq over 16-key tiles, dk/dv key-major over
    16-row q steps, each product 3xTF32 over the whole head dim, as the dq
    kernel takes its products there, against the Pallas kernel and its
    gradient at the JAX package's tolerances.  The f32 forward and dk/dv
    take their score products in two halves of d (warp pairs); that order
    is held by ``test_split_d_recurrence_at_head_dim_256``."""
    shape = (1, 72, 2, d)
    q, k, v, g = _inputs(shape, seed=d + causal, n=4)
    jout, jlse = _jax_fwd(q, k, v, causal)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = fwd_emulated(tq, tk, tv, causal)
    np.testing.assert_allclose(out.numpy(), jout, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=TOL, atol=TOL)

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal) * g)

    want = [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))]
    dq = dq_emulated(tq, tk, tv, out, lse, tg, causal, bk=16)
    dk, dv = dkdv_emulated(tq, tk, tv, out, lse, tg, causal, bq=16)
    for name, got, w in zip("qkv", (dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [136, 256])
def test_split_d_recurrence_at_head_dim_256(d, causal):
    """The f32 D = 256 forward and dk/dv as the warp pairs compute them:
    every score product (q·kᵀ; kᵀ·q and v·doᵀ key-major) the sum of the
    3xTF32 partials over columns 0-127 and 128-255, first half first, in
    the kernels' tiling (32-key tiles; 16-row q steps), the output products
    per column as before, every split the three-instruction one; against
    the Pallas kernel in interpret mode and its gradient, at out and lse
    1e-4 and dk, dv rtol 2e-4 / atol 2e-5."""
    shape = (1, 72, 2, d)
    q, k, v, g = _inputs(shape, seed=3 * d + causal, n=4)
    jout, jlse = _jax_fwd(q, k, v, causal)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = fwd_emulated(tq, tk, tv, causal, mm=mm3_fast,
                            mm_s=mm3_halves_fast)
    np.testing.assert_allclose(out.numpy(), jout, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=TOL, atol=TOL)
    want_dk, want_dv = _jax_dkdv(q, k, v, g, causal, (None, None))
    dk, dv = dkdv_emulated(tq, tk, tv, out, lse, tg, causal, bq=16,
                           mm=mm3_fast, mm_s=mm3_halves_fast)
    np.testing.assert_allclose(dk.numpy(), want_dk, rtol=RTOL, atol=ATOL,
                               err_msg="dk")
    np.testing.assert_allclose(dv.numpy(), want_dv, rtol=RTOL, atol=ATOL,
                               err_msg="dv")


def test_pair_sum_is_bit_equal_in_both_warps():
    """Each warp of a pair adds its own partial and the other's: the warp
    of columns 0-127 takes first + second, the other second + first.  The
    two sums are bit-equal (IEEE addition commutes), so both warps run
    the same softmax: the forward through either warp's sums gives the
    same out and lse, bit for bit."""
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 64, 2, 256), seed=7))
    a, b = q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)
    first = mm3_fast(a[..., :128], b[..., :128, :])
    second = mm3_fast(a[..., 128:], b[..., 128:, :])
    assert not torch.equal(first, second)
    assert torch.equal(first + second, second + first)
    assert torch.equal(first + second, mm3_halves_fast(a, b))

    def other_warp(x, y):
        return (mm3_fast(x[..., 128:], y[..., 128:, :])
                + mm3_fast(x[..., :128], y[..., :128, :]))

    for causal in (False, True):
        mine = fwd_emulated(q, k, v, causal, mm=mm3_fast,
                            mm_s=mm3_halves_fast)
        theirs = fwd_emulated(q, k, v, causal, mm=mm3_fast, mm_s=other_warp)
        assert all(torch.equal(x, y) for x, y in zip(mine, theirs))
