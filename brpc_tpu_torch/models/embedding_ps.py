"""EmbeddingPS -- the parameter-server model family: an embedding table
pooled by :func:`~brpc_tpu_torch.ops.device_ops.embedding_bag` under a
dense scoring tower.

The port of ``brpc_tpu/models/embedding_ps.py``: the same config, the
same parameter names and shapes, the same forward (bf16 products, f32
master weights), loss and SGD step.  Parameters are a flat dict of
tensors.  :meth:`EmbeddingPS.train_step` updates them in place, standing
in for the JAX step's buffer donation.

On a ``("dp", "tp")`` mesh (one process per rank) the table is
vocab-partitioned over tp, the tower tensor-parallel (``w1``/``b1`` cut
by column, ``w2`` by row, ``b2`` whole) and the batch cut over dp
(:func:`param_specs`, :func:`batch_specs`).  A rank looks up the rows it
holds and the pooled rows sum over tp; the tower's partial logits sum
over tp; the gradients average over dp.  The JAX package gets all of
this from GSPMD and the params' shardings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.device_ops import embedding_bag
from ..parallel.mesh_transport import Axis, _all_reduce, mesh_axis, psum, pvary
from ..utils.convert import shard_from_numpy
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PSConfig:
    vocab: int = 65536
    dim: int = 128
    slots: int = 16           # lookup ids per example
    hidden: int = 512
    classes: int = 16
    lr: float = 0.05


def init_params(gen: torch.Generator, cfg: PSConfig,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Random parameters in the JAX package's scales (other numbers than
    JAX's: carry JAX parameters over with ``utils.convert``)."""
    dev = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    return {
        "emb": normal(cfg.vocab, cfg.dim) * (1.0 / cfg.dim ** 0.5),
        "w1": normal(cfg.dim, cfg.hidden) * (1.0 / cfg.dim ** 0.5),
        "b1": torch.zeros((cfg.hidden,), device=dev),
        "w2": normal(cfg.hidden, cfg.classes) * (1.0 / cfg.hidden ** 0.5),
        "b2": torch.zeros((cfg.classes,), device=dev),
    }


def _bag(params, ids, tp: Optional[Axis]):
    """The pooled embeddings; over tp, each rank's rows (zero for ids it
    does not hold), summed.  Ids follow ``embedding_bag``: negative ones
    count from the end, a bag with an id out of range is NaN."""
    if tp is None:
        return embedding_bag(params["emb"], ids)
    table = params["emb"]
    rows = table.shape[0]
    vocab = rows * tp.size
    ids = torch.as_tensor(ids, device=table.device).long()
    valid = ((ids >= -vocab) & (ids < vocab)).all(dim=1, keepdim=True)
    local = ids.remainder(vocab) - tp.rank * rows
    mine = (local >= 0) & (local < rows)
    emb = table[local.clamp(0, rows - 1)] * mine[..., None]
    pooled = psum(emb.mean(dim=1), tp)
    return torch.where(valid, pooled, float("nan"))


def forward(params: Dict[str, torch.Tensor], ids,
            tp: Optional[Axis] = None) -> torch.Tensor:
    """ids (batch, slots) -> logits (batch, classes), f32.  Both products
    take bf16 operands and give a bf16 result, then add an f32 bias.
    With ``tp`` the params are the rank's shard and the logits whole."""
    x = _bag(params, ids, tp)
    bf = torch.bfloat16
    if tp is not None:
        x = pvary(x, tp)
    h = torch.clamp_min(
        (x.to(bf) @ params["w1"].to(bf)).float() + params["b1"], 0.0)
    y = (h.to(bf) @ params["w2"].to(bf)).float()
    if tp is not None:
        y = psum(y, tp)
    return y + params["b2"]


def loss_fn(params, ids, labels, tp: Optional[Axis] = None) -> torch.Tensor:
    """Mean softmax cross-entropy of the logits against ``labels``."""
    logp = torch.log_softmax(forward(params, ids, tp), dim=-1)
    labels = torch.as_tensor(labels, device=logp.device).long()
    return -logp.gather(1, labels[:, None]).mean()


def _value_and_grad(params, ids, labels, tp: Optional[Axis] = None,
                    dp: Optional[Axis] = None):
    leaves = [p.detach().requires_grad_(True) for p in params.values()]
    with torch.enable_grad():
        loss = loss_fn(dict(zip(params, leaves)), ids, labels, tp)
        grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    if dp is not None:
        loss = _all_reduce(dp, loss) / dp.size
        grads = [_all_reduce(dp, g) / dp.size for g in grads]
    return loss, grads


def sgd_train_step(params, ids, labels, lr: float, mesh=None):
    """One SGD step, pure: ``(new params, loss)``; ``params`` is left as
    it was.  With ``mesh`` the rank's shards and batch block go in and
    the loss is the whole batch's."""
    tp, dp = mesh_axis(mesh, "tp"), mesh_axis(mesh, "dp")
    loss, grads = _value_and_grad(params, ids, labels, tp, dp)
    with torch.no_grad():
        new = {k: p - lr * g for (k, p), g in zip(params.items(), grads)}
    return new, loss


def param_specs(cfg: PSConfig):
    """Per dim, how a ``("dp", "tp")`` mesh shards each parameter."""
    return {
        "emb": ("tp", None),      # vocab-partitioned (ep-style)
        "w1": (None, "tp"),       # tower tensor-parallel
        "b1": ("tp",),
        "w2": ("tp", None),
        "b2": (),
    }


def batch_specs():
    return ("dp", None), ("dp",)


class EmbeddingPS:
    """Config + parameters on one device, or this rank's shard of them on
    a ``("dp", "tp")`` mesh.  ``params`` (a flat dict, e.g. from
    ``utils.convert.params_from_numpy``) replaces the random ones made
    from ``seed``; on a mesh the whole params (the same on every rank,
    from ``seed`` or ``params``) are cut to the rank's shard."""

    def __init__(self, cfg: Optional[PSConfig] = None, device="cuda",
                 seed: int = 0, params: Optional[Dict] = None, mesh=None):
        self.device = resolve_device(device)
        self.cfg = cfg or PSConfig()
        self.mesh = mesh
        self._tp, self._dp = mesh_axis(mesh, "tp"), mesh_axis(mesh, "dp")
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a "
                             f"{self.device.type} model")
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, self.cfg, self.device)
        if mesh is not None:
            coords = {ax.name: (ax.rank, ax.size)
                      for ax in (self._tp, self._dp) if ax is not None}
            params = shard_from_numpy(
                {k: v.detach().cpu().numpy() for k, v in params.items()},
                param_specs(self.cfg), coords, self.device)
        self.params = {k: v.to(self.device) for k, v in params.items()}

    def _ids(self, ids) -> torch.Tensor:
        if not isinstance(ids, torch.Tensor):
            ids = torch.from_numpy(np.array(ids, dtype=np.int64))
        return ids.to(self.device)

    @torch.no_grad()
    def lookup(self, ids) -> torch.Tensor:
        """Serve path: the pooled embeddings alone (the PS read RPC)."""
        return _bag(self.params, self._ids(ids), self._tp)

    @torch.no_grad()
    def predict(self, ids) -> torch.Tensor:
        return forward(self.params, self._ids(ids), self._tp)

    def train_step(self, ids, labels) -> float:
        """One SGD step on the stored parameters, in place; the loss (on
        a mesh, the whole batch's: pass this rank's block)."""
        loss, grads = _value_and_grad(self.params, self._ids(ids),
                                      self._ids(labels), self._tp, self._dp)
        with torch.no_grad():
            for p, g in zip(self.params.values(), grads):
                p.sub_(self.cfg.lr * g)
        return float(loss)

    def shard_batch(self, ids, labels):
        """The whole batch -> this rank's block of it (the batch over
        dp); unchanged without a mesh."""
        ids, labels = self._ids(ids), self._ids(labels)
        if self._dp is None:
            return ids, labels
        n, r = self._dp.size, self._dp.rank
        if ids.shape[0] % n:
            raise ValueError(f"batch {ids.shape[0]} does not split over "
                             f"dp {n}")
        return ids.chunk(n)[r], labels.chunk(n)[r]
