"""EmbeddingPS -- the parameter-server model family: an embedding table
pooled by :func:`~brpc_tpu_torch.ops.device_ops.embedding_bag` under a
dense scoring tower.

The port of ``brpc_tpu/models/embedding_ps.py`` on one device: the same
config, the same parameter names and shapes, the same forward (bf16
products, f32 master weights), loss and SGD step.  Parameters are a flat
dict of tensors.  :meth:`EmbeddingPS.train_step` updates them in place,
standing in for the JAX step's buffer donation.  The JAX package's mesh
(the vocab-sharded table, the tensor-parallel tower: ``param_specs``,
``batch_specs``, ``shard_batch``) waits for the port's parallel slice and
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.device_ops import embedding_bag
from ..utils.device import resolve_device

_PARALLEL = ("sharding the parameter server over a mesh waits for the "
             "port's parallel slice")


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


def forward(params: Dict[str, torch.Tensor], ids) -> torch.Tensor:
    """ids (batch, slots) -> logits (batch, classes), f32.  Both products
    take bf16 operands and give a bf16 result, then add an f32 bias."""
    x = embedding_bag(params["emb"], ids)
    bf = torch.bfloat16
    h = torch.clamp_min(
        (x.to(bf) @ params["w1"].to(bf)).float() + params["b1"], 0.0)
    return (h.to(bf) @ params["w2"].to(bf)).float() + params["b2"]


def loss_fn(params, ids, labels) -> torch.Tensor:
    """Mean softmax cross-entropy of the logits against ``labels``."""
    logp = torch.log_softmax(forward(params, ids), dim=-1)
    labels = torch.as_tensor(labels, device=logp.device).long()
    return -logp.gather(1, labels[:, None]).mean()


def _value_and_grad(params, ids, labels):
    leaves = [p.detach().requires_grad_(True) for p in params.values()]
    with torch.enable_grad():
        loss = loss_fn(dict(zip(params, leaves)), ids, labels)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def sgd_train_step(params, ids, labels, lr: float):
    """One SGD step, pure: ``(new params, loss)``; ``params`` is left as
    it was."""
    loss, grads = _value_and_grad(params, ids, labels)
    with torch.no_grad():
        new = {k: p - lr * g for (k, p), g in zip(params.items(), grads)}
    return new, loss


def param_specs(cfg: PSConfig):
    raise NotImplementedError(_PARALLEL)


def batch_specs():
    raise NotImplementedError(_PARALLEL)


class EmbeddingPS:
    """Config + parameters on one device.  ``params`` (a flat dict, e.g.
    from ``utils.convert.params_from_numpy``) replaces the random ones
    made from ``seed``."""

    def __init__(self, cfg: Optional[PSConfig] = None, device="cuda",
                 seed: int = 0, params: Optional[Dict] = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(_PARALLEL)
        self.device = resolve_device(device)
        self.cfg = cfg or PSConfig()
        self.mesh = None
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, self.cfg, self.device)
        self.params = {k: v.to(self.device) for k, v in params.items()}

    def _ids(self, ids) -> torch.Tensor:
        if not isinstance(ids, torch.Tensor):
            ids = torch.from_numpy(np.array(ids, dtype=np.int64))
        return ids.to(self.device)

    @torch.no_grad()
    def lookup(self, ids) -> torch.Tensor:
        """Serve path: the pooled embeddings alone (the PS read RPC)."""
        return embedding_bag(self.params["emb"], self._ids(ids))

    @torch.no_grad()
    def predict(self, ids) -> torch.Tensor:
        return forward(self.params, self._ids(ids))

    def train_step(self, ids, labels) -> float:
        """One SGD step on the stored parameters, in place; the loss."""
        loss, grads = _value_and_grad(self.params, self._ids(ids),
                                      self._ids(labels))
        with torch.no_grad():
            for p, g in zip(self.params.values(), grads):
                p.sub_(self.cfg.lr * g)
        return float(loss)

    def shard_batch(self, ids, labels):
        raise NotImplementedError(_PARALLEL)
