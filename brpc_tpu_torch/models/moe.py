"""Mixture-of-Experts FFN in eager PyTorch.

Counterpart of ``brpc_tpu/models/moe.py``: capacity-factor top-k routing
(each expert takes ``C = ceil(tokens * k / E * capacity)`` token slots,
overflow slots are dropped and the caller's residual carries the token),
an f32 router, bf16 expert products, an f32 combine, and the Switch
load-balancing aux loss.

The JAX package dispatches and combines through one-hot ``(T, E, C)``
einsums.  Each of those selects exactly one slot or none, so the port
computes the same numbers by index: a token's kept slots are written into
a flat ``(E * C)`` table of expert rows (one indexed write, whose backward
is a gather), the experts run as one batched bf16 product, and each
token gathers its K outputs back and sums them, weighted, in choice
order.  No step sums with atomics, so a recomputed block (remat) gives
the same values.  :func:`forward_grouped` routes every row of a ``(G, N,
d)`` input on its own, vectorised over the rows, on one device or with
the experts cut over a mesh axis (expert parallelism).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh_transport import Axis, psum, pvary
from ..utils.device import resolve_device


class MoEConfig:
    """Same fields, defaults and ``capacity()`` as the JAX package's."""

    def __init__(self, dim: int = 64, hidden: int = 128,
                 num_experts: int = 4, capacity_factor: float = 1.5,
                 aux_loss_weight: float = 0.01, top_k: int = 1):
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k {top_k} must be in [1, num_experts "
                             f"{num_experts}]")
        self.dim = dim
        self.hidden = hidden
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        # top_k=1 is Switch-style routing, top_k=2 GShard/Mixtral's
        self.top_k = top_k

    def capacity(self, tokens: int) -> int:
        c = math.ceil(tokens * self.top_k / self.num_experts
                      * self.capacity_factor)
        return max(1, c)


def init_params(generator: torch.Generator, cfg: MoEConfig,
                device="cuda") -> Dict[str, Any]:
    """Router ``wg`` (d, E) and experts ``w1`` (E, d, hidden), ``w2``
    (E, hidden, d): normal draws times 1/sqrt(dim), ``w2`` halved, as in
    the JAX package (the values differ from its ``PRNGKey`` draws)."""
    dev = resolve_device(device)
    scale = 1.0 / math.sqrt(cfg.dim)

    def normal(*shape, mult=scale):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * mult

    return {"wg": normal(cfg.dim, cfg.num_experts),
            "w1": normal(cfg.num_experts, cfg.dim, cfg.hidden),
            "w2": normal(cfg.num_experts, cfg.hidden, cfg.dim,
                         mult=scale / 2)}


def param_specs(cfg: MoEConfig, ep_axis: str = "ep") -> Dict[str, Any]:
    """Per dim, how an ``ep_axis`` mesh shards each parameter: the router
    whole, the experts cut on their expert dim (expert parallelism)."""
    return {"wg": (None, None), "w1": (ep_axis, None, None),
            "w2": (ep_axis, None, None)}


# pinned_routing's choices while it is active (None otherwise)
_pinned: Optional[Iterator[torch.Tensor]] = None


@contextlib.contextmanager
def pinned_routing(choices: Iterable[torch.Tensor]):
    """Test-only: inside, each :func:`route` call takes its experts from
    ``choices`` (one ``(G, K*N)`` tensor per call, in call order, as
    ``route`` returns them) instead of its router's top k; the gates are
    the router's probabilities of those experts, renormalised as usual.
    A run of the same program replays another run's routing this way
    (its forward, and remat's recompute in the backward, in order)."""
    global _pinned
    if _pinned is not None:
        raise RuntimeError("routing is already pinned")
    _pinned = iter(choices)
    try:
        yield
    finally:
        _pinned = None


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: values and indices, largest
    first, ties to the lowest index (``argmax`` returns the first
    maximum)."""
    vals, idx = [], []
    p = probs.detach()
    for _ in range(k):
        i = torch.argmax(p, dim=-1, keepdim=True)
        idx.append(i)
        vals.append(torch.gather(probs, -1, i))
        p = p.scatter(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idx, dim=-1)


def route(params: Dict[str, Any], x: torch.Tensor, cfg: MoEConfig):
    """The router of every row of ``x`` (G, N, d): ``(probs (G, N, E),
    gates (G, K*N), experts (G, K*N), pos (G, K*N), kept (G, K*N))``,
    the slots in choice-major order (every first choice queues ahead of
    every second choice)."""
    G, N, _ = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = cfg.capacity(N)
    probs = torch.softmax(x @ params["wg"], dim=-1)       # f32 router
    if _pinned is None:
        topv, tope = _top_k(probs, K)                      # (G, N, K)
    else:
        tope = next(_pinned).to(probs.device).reshape(G, K, N).transpose(1, 2)
        topv = torch.gather(probs, -1, tope)
    if K > 1:
        # renormalised over the chosen experts (Mixtral); K = 1 keeps the
        # raw probability as the gate, so the router still gets gradient
        topv = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-9)
    experts = tope.transpose(1, 2).reshape(G, K * N)
    gates = topv.transpose(1, 2).reshape(G, K * N)
    onehot = F.one_hot(experts, E)                         # (G, K*N, E)
    pos = (torch.cumsum(onehot, dim=1) * onehot - 1).amax(dim=-1)
    return probs, gates, experts, pos, pos < C


def forward_grouped(params: Dict[str, Any], x: torch.Tensor, cfg: MoEConfig,
                    ep: Optional[Axis] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped MoE: ``x`` (G, N, d) -> ``(out (G, N, d), aux ())``.  Each
    row routes on its own (capacity per row) and aux is the mean over the
    rows, as the JAX package's ``vmap`` of :func:`forward`.

    With ``ep`` (an expert-parallel mesh axis; ``x`` replicated over it,
    ``w1``/``w2`` this rank's E/n experts under :func:`param_specs`) every
    rank routes alike from the whole router, runs its experts' rows of the
    ``(E * C)`` table and sums its slots' share of each token; the shares
    sum over the axis.  The tokens and gates enter the rank-local part
    through ``pvary``, so their gradients sum over the axis too."""
    G, N, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = cfg.capacity(N)
    probs, gates, experts, pos, kept = route(params, x, cfg)
    El = params["w1"].shape[0]                              # experts here
    e0 = 0
    if ep is not None:
        if El * ep.size != E:
            raise ValueError(f"{El} experts on each of {ep.size} ranks are "
                             f"not {E}")
        e0 = ep.rank * El
        x, gates = pvary(x, ep), pvary(gates, ep)
    mine = kept & (experts >= e0) & (experts < e0 + El)
    # each kept slot's row in this rank's (El * C) expert table; dropped
    # slots (and other ranks' experts) go to the spare row El * C, which
    # is cut off before the experts run
    slot = torch.where(mine, (experts - e0) * C + pos, El * C)  # (G, K*N)
    rows = torch.arange(G, device=x.device)[:, None].expand(G, K * N)
    xb = x.to(torch.bfloat16)
    src = xb.unsqueeze(1).expand(G, K, N, d).reshape(G, K * N, d)
    table = x.new_zeros((G, El * C + 1, d), dtype=torch.bfloat16)
    table = table.index_put((rows, slot), src)
    expert_in = table[:, :El * C].reshape(G, El, C, d).transpose(0, 1)
    expert_in = expert_in.reshape(El, G * C, d)
    h = torch.bmm(expert_in, params["w1"].to(torch.bfloat16))
    h = F.gelu(h.float(), approximate="tanh").to(torch.bfloat16)
    expert_out = torch.bmm(h, params["w2"].to(torch.bfloat16))  # (El, G*C, d)
    expert_out = expert_out.reshape(El, G, C, d).transpose(0, 1).reshape(
        G, El * C, d).float()
    expert_out = torch.cat([expert_out, x.new_zeros((G, 1, d))], dim=1)
    y = expert_out[rows, slot]                               # (G, K*N, d)
    w = (gates * mine).reshape(G, K, N, 1)
    y = y.reshape(G, K, N, d)
    out = y[:, 0] * w[:, 0]
    for k in range(1, K):
        out = out + y[:, k] * w[:, k]
    if ep is not None:
        out = psum(out, ep)
    # load balancing (Switch Transformer): the share of first choices per
    # expert times the mean router probability, times E
    frac = F.one_hot(experts[:, :N], E).float().mean(dim=1)  # (G, E)
    aux = E * (frac * probs.mean(dim=1)).sum(dim=-1) * cfg.aux_loss_weight
    return out, aux.mean()


def forward(params: Dict[str, Any], x: torch.Tensor, cfg: MoEConfig,
            ep: Optional[Axis] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over one group: ``x`` (T, d) -> ``(out (T, d), aux ())``."""
    out, aux = forward_grouped(params, x[None], cfg, ep)
    return out[0], aux


def make_train_step(cfg: MoEConfig, lr: float = 0.1):
    """``(params, x, target) -> (new_params, loss)``: SGD on the mean
    squared error plus aux, the JAX package's toy regression task."""

    def step(params, x, target):
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        out, aux = forward(live, x, cfg)
        loss = torch.mean((out - target) ** 2) + aux
        grads = torch.autograd.grad(loss, list(live.values()))
        with torch.no_grad():
            new = {k: p - lr * g
                   for (k, p), g in zip(params.items(), grads)}
        return new, loss.detach()

    return step
