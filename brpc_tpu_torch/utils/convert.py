"""Parameter carry-over between the JAX package and the port.

A JAX TransformerLM parameter tree, with every leaf turned into a numpy
array (``jax.tree_util.tree_map(np.asarray, params)`` keeps the
``QuantTensor`` nodes), becomes the port's parameter dict on a device;
so does the EmbeddingPS's flat dict (``emb``, ``w1``, ``b1``, ``w2``,
``b2``);
:func:`params_to_numpy` goes back.  The port never imports JAX: a
quantized leaf is recognised by its ``(q, s)`` fields.

For a mesh, :func:`shard_from_numpy` carries the whole (numpy) tree onto
one rank's shard under a tree of specs (``param_specs`` of the model:
per dim ``None``, an axis name, or ``(axis, parts)`` for a fused dim of
``parts`` equal pieces, each cut over the axis), and
:func:`params_from_shards` puts the ranks' shards back together.
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


def _dim_index(entry, size: int, coords: dict) -> np.ndarray:
    """The indices of one dim that a rank at ``coords`` holds."""
    if entry is None:
        return np.arange(size)
    axis, parts = (entry, 1) if isinstance(entry, str) else entry
    i, n = coords.get(axis, (0, 1))
    piece = size // parts
    if piece * parts != size or piece % n:
        raise ValueError(f"dim of {size} does not cut into {parts} x {n}")
    width = piece // n
    return np.concatenate([np.arange(p * piece + i * width,
                                     p * piece + (i + 1) * width)
                           for p in range(parts)])


def _block_index(spec, shape, coords: dict):
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return np.ix_(*(_dim_index(e, n, coords) for e, n in zip(spec, shape)))


def shard_from_numpy(tree: dict, specs: dict, coords: dict,
                     device="cuda") -> dict:
    """A whole nested dict of numpy arrays -> the block of every leaf that
    the rank at ``coords`` (``{axis: (index, size)}``; a missing axis has
    size 1) holds under ``specs``, as the port's params on ``device``."""
    dev = resolve_device(device)

    def conv(val, spec):
        if isinstance(val, dict):
            return {k: conv(v, spec[k]) for k, v in val.items()}
        val = np.asarray(val)
        block = val[_block_index(spec, val.shape, coords)]
        return torch.from_numpy(np.array(block, copy=True)).to(dev)

    return {k: conv(v, specs[k]) for k, v in tree.items()}


def params_from_shards(shards: list, specs: dict) -> dict:
    """``[(coords, tree), ...]``, every rank's shard as numpy (or port
    params) -> the whole tree of numpy arrays; where ranks hold the same
    block (a replicated dim), the first one's is taken."""

    def whole(key_path, spec):
        blocks = []
        for coords, tree in shards:
            leaf = tree
            for k in key_path:
                leaf = leaf[k]
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach().cpu().numpy()
            blocks.append((coords, np.asarray(leaf)))
        coords0, first = blocks[0]
        spec_t = tuple(spec) + (None,) * (first.ndim - len(spec))
        shape = []
        for entry, n in zip(spec_t, first.shape):
            if entry is None:
                shape.append(n)
            else:
                axis = entry if isinstance(entry, str) else entry[0]
                shape.append(n * coords0.get(axis, (0, 1))[1])
        out = np.zeros(shape, dtype=first.dtype)
        seen = np.zeros(shape, dtype=bool)
        for coords, block in blocks:
            idx = _block_index(spec, shape, coords)
            fresh = ~seen[idx]
            out[idx] = np.where(fresh, block, out[idx])
            seen[idx] = True
        if not seen.all():
            raise ValueError(f"the shards do not cover {'/'.join(key_path)}")
        return out

    def walk(spec_tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else whole(path + (k,), v) for k, v in spec_tree.items()}

    return walk(specs, ())
