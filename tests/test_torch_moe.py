"""The port's MoE FFN (``brpc_tpu_torch/models/moe.py``) against the JAX
package's ``brpc_tpu/models/moe.py``, on the CPU.

Params come from the JAX ``init_params(PRNGKey)`` through numpy; inputs
from numpy seeds.  The routing (each slot's expert, choice-major, and
whether it kept its capacity slot) must be exactly equal.  So that a
near-tie fails loudly instead of flaking, every input is first held to a
top-k router margin: the sorted probabilities of each token, down to the
(K+1)-th, are at least ``ROUTE_MARGIN`` apart (the two frameworks'
router probabilities differ by ~1e-7 here).

The JAX side runs under ``jax.jit``, as the package runs it.  On the CPU
XLA then keeps some of the bf16 expert intermediates in f32 (its jitted
output differs from the op-by-op one by up to 4.5e-3 on these inputs;
the port follows the op-by-op bf16 roundings to ~1e-7).  Tolerances: out
within 1e-2 of its largest |value| against the jitted JAX function, and
within 1e-5 absolute against the op-by-op one; aux within 1e-6 relative
(f32 means in another order); gradients in norm, ``‖Δg‖ / ‖g‖ <=
1e-2``; the losses of five SGD steps within 1e-3 relative (1.2e-4
measured).
"""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import moe as jmoe
from brpc_tpu_torch.models import MoEConfig
from brpc_tpu_torch.models import moe as tmoe

ROUTE_MARGIN = 1e-4
OUT_SCALE_TOL = 1e-2
EAGER_ATOL = 1e-5
AUX_RTOL = 1e-6
GRAD_REL_NORM = 1e-2
LOSS_RTOL = 1e-3
DIM, HIDDEN = 16, 32
CASES = [(e, k, cap) for e in (1, 2, 4) for k in (1, 2) if k <= e
         for cap in (0.5, 1.5, 4.0)]


def _cfgs(E, K, cap):
    kw = dict(dim=DIM, hidden=HIDDEN, num_experts=E, top_k=K,
              capacity_factor=cap)
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _params(jcfg, seed=0):
    jp = jmoe.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: torch.from_numpy(np.asarray(v).copy())
                for k, v in jp.items()}


def _jax_route(jp, x, cfg):
    """The JAX forward's routing (moe.py:100-119), per token: experts and
    kept masks in choice-major order, and the sorted probabilities."""

    @jax.jit
    def route(wg, x):
        T = x.shape[0]
        probs = jax.nn.softmax(x @ wg, axis=-1)
        _, tope = jax.lax.top_k(probs, cfg.top_k)
        slot_expert = tope.transpose(1, 0).reshape(cfg.top_k * T)
        onehot = jax.nn.one_hot(slot_expert, cfg.num_experts,
                                dtype=jnp.int32)
        pos = (jnp.cumsum(onehot, axis=0) * onehot - 1).max(axis=1)
        return slot_expert, pos < cfg.capacity(T), probs

    e, kept, probs = route(jp["wg"], jnp.asarray(x))
    return (np.asarray(e), np.asarray(kept),
            -np.sort(-np.asarray(probs), axis=-1))


def _jit(fn, cfg):
    return jax.jit(lambda p, x: fn(p, x, cfg))


def _assert_out_close(got, want):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= OUT_SCALE_TOL * np.abs(want).max(), err


def _margin(sorted_probs, K):
    """Smallest gap between consecutive sorted probabilities down to the
    (K+1)-th (the ones that decide a token's ordered top-k)."""
    top = sorted_probs[..., :min(K + 1, sorted_probs.shape[-1])]
    if top.shape[-1] < 2:
        return math.inf
    return float(np.min(top[..., :-1] - top[..., 1:]))


def _inputs(shape, jp, jcfg, seed):
    """An input of ``shape`` whose every row clears ROUTE_MARGIN."""
    for s in range(seed, seed + 100):
        x = np.random.default_rng(s).standard_normal(shape).astype(
            np.float32)
        _, _, sp = _jax_route(jp, x.reshape(-1, shape[-1]), jcfg)
        if _margin(sp, jcfg.top_k) >= ROUTE_MARGIN:
            return x
    pytest.fail(f"no input of {shape} clears the router margin")


@pytest.mark.parametrize("tokens,E,K,cap", [
    (t, e, k, c) for t, e, k, c in itertools.product(
        (1, 7, 64, 2048), (1, 4, 8), (1, 2), (0.5, 1.0, 1.25, 2.0))
    if k <= e])
def test_capacity_matches_jax(tokens, E, K, cap):
    kw = dict(num_experts=E, top_k=K, capacity_factor=cap)
    assert MoEConfig(**kw).capacity(tokens) \
        == jmoe.MoEConfig(**kw).capacity(tokens)


def test_config_refuses_k_past_e():
    with pytest.raises(ValueError, match="top_k"):
        MoEConfig(num_experts=2, top_k=3)


def test_init_layout_and_scales():
    cfg = MoEConfig(dim=DIM, hidden=HIDDEN, num_experts=4)
    tp = tmoe.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    jp = jmoe.init_params(jax.random.PRNGKey(0), jmoe.MoEConfig(
        dim=DIM, hidden=HIDDEN, num_experts=4))
    assert list(tp) == list(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape
        assert tp[k].dtype == torch.float32
    assert abs(float(tp["w1"].std()) * math.sqrt(DIM) - 1.0) < 0.1
    assert abs(float(tp["w2"].std()) * math.sqrt(DIM) * 2 - 1.0) < 0.1
    # expert parallelism: the JAX package's specs, per dim
    assert tmoe.param_specs(cfg) == {
        k: tuple(v) for k, v in jmoe.param_specs(jmoe.MoEConfig(
            dim=DIM, hidden=HIDDEN, num_experts=4)).items()}


@pytest.mark.parametrize("E,K,cap", CASES)
def test_forward_matches_jax(E, K, cap):
    jcfg, tcfg = _cfgs(E, K, cap)
    jp, tp = _params(jcfg)
    x = _inputs((40, DIM), jp, jcfg, seed=10 * E + K)
    want_e, want_kept, _ = _jax_route(jp, x, jcfg)
    _, _, experts, _, kept = tmoe.route(tp, torch.from_numpy(x)[None], tcfg)
    np.testing.assert_array_equal(experts[0].numpy(), want_e)
    np.testing.assert_array_equal(kept[0].numpy(), want_kept)
    if cap == 0.5 and E > 1:
        assert not want_kept.all(), "capacity 0.5 must drop slots"
    jo, ja = _jit(jmoe.forward, jcfg)(jp, jnp.asarray(x))
    to, ta = tmoe.forward(tp, torch.from_numpy(x), tcfg)
    _assert_out_close(to, jo)
    np.testing.assert_allclose(float(ta), float(ja), rtol=AUX_RTOL)


@pytest.mark.parametrize("K", [1, 2])
def test_router_ties_go_to_the_lowest_index_as_jax(K):
    """Experts 1 and 3 share a router column, so every token's two
    probabilities tie exactly: ``jax.lax.top_k`` takes the lower index
    first, and so must the port."""
    jcfg, tcfg = _cfgs(4, K, 1.5)
    jp, tp = _params(jcfg, seed=4)
    wg = np.asarray(jp["wg"]).copy()
    wg[:, 3] = wg[:, 1]
    jp = dict(jp, wg=jnp.asarray(wg))
    tp = dict(tp, wg=torch.from_numpy(wg))
    x = np.random.default_rng(5).standard_normal((64, DIM)).astype(
        np.float32)
    want_e, want_kept, _ = _jax_route(jp, x, jcfg)
    _, _, experts, _, kept = tmoe.route(tp, torch.from_numpy(x)[None], tcfg)
    assert (want_e == 1).any() and not (want_e[:64] == 3).any()
    np.testing.assert_array_equal(experts[0].numpy(), want_e)
    np.testing.assert_array_equal(kept[0].numpy(), want_kept)


@pytest.mark.parametrize("E,K,cap", [(4, 2, 1.5), (4, 1, 0.5)])
def test_forward_matches_jax_op_by_op(E, K, cap):
    """Against the JAX function run op by op, where every bf16 rounding
    of moe.py happens where it is written: the port rounds at the same
    points."""
    jcfg, tcfg = _cfgs(E, K, cap)
    jp, tp = _params(jcfg)
    x = _inputs((40, DIM), jp, jcfg, seed=10 * E + K)
    with jax.disable_jit():
        jo, ja = jmoe.forward(jp, jnp.asarray(x), jcfg)
    to, ta = tmoe.forward(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=EAGER_ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), rtol=AUX_RTOL)


@pytest.mark.parametrize("E,K,cap", CASES)
def test_forward_grouped_matches_jax(E, K, cap):
    """Three groups, each routed on its own: capacity per group."""
    jcfg, tcfg = _cfgs(E, K, cap)
    jp, tp = _params(jcfg, seed=1)
    x = _inputs((3, 24, DIM), jp, jcfg, seed=100 * E + K)
    probs, gates, experts, pos, kept = tmoe.route(tp, torch.from_numpy(x),
                                                  tcfg)
    assert experts.shape == kept.shape == (3, K * 24)
    for g in range(3):
        want_e, want_kept, _ = _jax_route(jp, x[g], jcfg)
        np.testing.assert_array_equal(experts[g].numpy(), want_e)
        np.testing.assert_array_equal(kept[g].numpy(), want_kept)
    jo, ja = _jit(jmoe.forward_grouped, jcfg)(jp, jnp.asarray(x))
    to, ta = tmoe.forward_grouped(tp, torch.from_numpy(x), tcfg)
    assert to.shape == (3, 24, DIM) and ta.shape == ()
    _assert_out_close(to, jo)
    np.testing.assert_allclose(float(ta), float(ja), rtol=AUX_RTOL)
    # dropped slots contribute nothing: a token with no kept slot is 0
    lost = ~kept.reshape(3, K, 24).any(dim=1)
    assert torch.all(to[lost] == 0)


@pytest.mark.parametrize("E,K,cap", [(4, 2, 1.5), (4, 1, 0.5), (2, 2, 4.0),
                                     (1, 1, 1.5)])
def test_gradients_match_jax(E, K, cap):
    """Gradients of ``sum(out * r) + aux`` w.r.t. x, wg, w1 and w2."""
    jcfg, tcfg = _cfgs(E, K, cap)
    jp, tp = _params(jcfg, seed=2)
    x = _inputs((3, 20, DIM), jp, jcfg, seed=200 * E + K)
    r = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.forward_grouped(p, x, jcfg)
        return jnp.sum(out * r) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    out, aux = tmoe.forward_grouped(live, tx, tcfg)
    (torch.sum(out * torch.from_numpy(r)) + aux).backward()
    pairs = [(tx.grad, jgx)] + [(live[k].grad, jgp[k]) for k in jp]
    for got, want in pairs:
        want = np.asarray(want)
        rel = (np.linalg.norm(got.numpy() - want)
               / max(np.linalg.norm(want), 1e-30))
        assert rel <= GRAD_REL_NORM, rel


@pytest.mark.parametrize("K", [1, 2])
def test_train_step_losses_match_jax(K):
    jcfg, tcfg = _cfgs(4, K, 1.5)
    jp, tp = _params(jcfg, seed=3)
    x = _inputs((32, DIM), jp, jcfg, seed=300 + K)
    target = np.random.default_rng(8).standard_normal(x.shape).astype(
        np.float32)
    jstep = jax.jit(jmoe.make_train_step(jcfg, lr=0.1))
    tstep = tmoe.make_train_step(tcfg, lr=0.1)
    jl, tl = [], []
    for _ in range(5):
        jp, loss = jstep(jp, jnp.asarray(x), jnp.asarray(target))
        jl.append(float(loss))
        tp, loss = tstep(tp, torch.from_numpy(x), torch.from_numpy(target))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0], tl


def test_pinned_routing_reproduces_the_routed_forward(monkeypatch):
    """``moe.pinned_routing`` replays recorded expert choices: an MoE LM's
    loss and gradient (remat on: the forward's routing, then the
    recompute's, in call order) equal the routed run's to the bit.
    chip_smoke.py phase 8m runs its dense-attention arm with the kernel
    arm's choices this way.  Other choices change the output."""
    from brpc_tpu_torch.models import transformer_lm as tlm
    cfg = tlm.LMConfig(vocab=64, dim=DIM, heads=2, depth=2, max_seq=32,
                       moe_experts=4, moe_top_k=2, remat=True)
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, 16)))
    vg = tlm.make_value_and_grad(cfg, device="cpu")
    calls = []
    route = tmoe.route

    def recorded(p, x, c):
        out = route(p, x, c)
        calls.append(out[2].clone())
        return out

    monkeypatch.setattr(tmoe, "route", recorded)
    loss, grads = vg(params, ids, ids.roll(-1, 1))
    monkeypatch.undo()
    assert len(calls) == 2 * cfg.depth          # forward, then recompute
    with tmoe.pinned_routing(calls):
        loss2, grads2 = vg(params, ids, ids.roll(-1, 1))
        with pytest.raises(RuntimeError, match="already pinned"):
            with tmoe.pinned_routing([]):
                pass
    assert torch.equal(loss, loss2)
    for a, b in zip(tlm.tree_leaves(grads), tlm.tree_leaves(grads2)):
        assert torch.equal(a, b)
    # each token's other experts instead: the pin takes effect
    other = [(c + 1) % cfg.moe_experts for c in calls]
    with tmoe.pinned_routing(other):
        loss3, _ = vg(params, ids, ids.roll(-1, 1))
    assert not torch.equal(loss, loss3)
