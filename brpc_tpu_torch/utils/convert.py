"""Parameter carry-over between the JAX package and the port.

A JAX TransformerLM parameter tree, with every leaf turned into a numpy
array (``jax.tree_util.tree_map(np.asarray, params)`` keeps the
``QuantTensor`` nodes), becomes the port's parameter dict on a device;
so does the EmbeddingPS's flat dict (``emb``, ``w1``, ``b1``, ``w2``,
``b2``);
:func:`params_to_numpy` goes back.  The port never imports JAX: a
quantized leaf is recognised by its ``(q, s)`` fields.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quant import QuantTensor
from .device import resolve_device


def _is_quant(leaf) -> bool:
    return getattr(leaf, "_fields", None) == ("q", "s")


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """Nested or flat dict of numpy arrays (the LM's unrolled ``blk{i}``
    or stacked ``blocks`` layout, MoE subtrees included, or the
    EmbeddingPS's flat dict) -> the port's params on ``device``."""
    dev = resolve_device(device)

    def conv(val):
        if isinstance(val, dict):
            return {k: conv(v) for k, v in val.items()}
        if _is_quant(val):
            return QuantTensor(conv(val.q), conv(val.s))
        return torch.from_numpy(np.array(val, copy=True)).to(dev)

    return {k: conv(v) for k, v in tree.items()}


def params_to_numpy(params: dict) -> dict:
    """The port's params -> nested dict of numpy arrays, the inverse of
    :func:`params_from_numpy` (quantized leaves stay ``QuantTensor``s, of
    numpy arrays)."""

    def conv(val):
        if isinstance(val, dict):
            return {k: conv(v) for k, v in val.items()}
        if _is_quant(val):
            return QuantTensor(conv(val.q), conv(val.s))
        return val.detach().cpu().numpy()

    return {k: conv(v) for k, v in params.items()}
