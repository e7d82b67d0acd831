"""Weight-only int8 quantization for the serving path.

Counterpart of ``brpc_tpu/ops/quant.py``: symmetric per-output-channel
int8 (scale = amax/127 over the contraction axis).  ``quantize_int8``
gives the JAX package's int8 values and scales bit for bit
(``torch.round`` and ``jnp.round`` both round half to even).
``qmatmul`` is a plain bf16 product, outside any kernel, as XLA ran it:
bf16 x bf16 with a bf16 result, cast to f32, then scaled.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class QuantTensor(NamedTuple):
    """int8 weights + per-output-channel f32 scales."""
    q: Any          # int8, same shape as the original weight
    s: Any          # float32, shape = (out_channels,)

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return int(self.q.numel()) + int(self.s.numel()) * 4


def quantize_int8(w, contract_axis: int = 0) -> QuantTensor:
    """Symmetric per-channel quantization: scales are taken over
    ``contract_axis`` (0 for a 2-D ``x @ w`` weight, 1 for a stacked
    (depth, in, out) one), one per remaining index.  Idempotent."""
    if isinstance(w, QuantTensor):
        return w
    w = torch.as_tensor(w, dtype=torch.float32)
    amax = torch.amax(torch.abs(w), dim=contract_axis, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QuantTensor(q=q, s=scale.squeeze(contract_axis))


def qmatmul(x, w):
    """``x @ w`` for a QuantTensor or plain weight: bf16 inputs, the
    product rounded to bf16, returned as f32 (scaled per output channel
    for a QuantTensor)."""
    if not isinstance(w, QuantTensor):
        return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()
    y = (x.to(torch.bfloat16) @ w.q.to(torch.bfloat16)).float()
    return y * w.s


def dequantize(w):
    """Materialize the f32 weight (tests / fallback paths)."""
    if not isinstance(w, QuantTensor):
        return w
    return w.q.float() * w.s


_LM_QUANT_KEYS = ("wqkv", "wo", "w1", "w2")


def quantize_lm_params(params: dict) -> dict:
    """Quantize a TransformerLM parameter dict for serving: the block
    matmul weights and the unembedding go int8; embeddings, norm gains and
    MoE subtrees stay.  Returns a new dict; the original is untouched.
    Unrolled ``blk{i}`` trees and stacked ``scan_layers`` trees are both
    served: a stacked (depth, in, out) weight quantizes with the
    contraction on axis 1, so its scales are per (layer, out channel) and
    layer ``i`` is ``QuantTensor(q[i], s[i])``."""
    out: dict = {}
    for key, val in params.items():
        if key == "unembed":
            out[key] = quantize_int8(val)
        elif key == "blocks" and isinstance(val, dict):
            out[key] = {bk: quantize_int8(bv, contract_axis=1)
                        if bk in _LM_QUANT_KEYS else bv
                        for bk, bv in val.items()}
        elif key.startswith("blk") and isinstance(val, dict):
            out[key] = {bk: quantize_int8(bv) if bk in _LM_QUANT_KEYS
                        else bv for bk, bv in val.items()}
        else:
            out[key] = val
    return out


def quantized_nbytes(params: dict) -> int:
    """Total parameter bytes (QuantTensor-aware)."""
    total = 0
    for val in params.values():
        if isinstance(val, dict):
            total += quantized_nbytes(val)
        elif isinstance(val, QuantTensor):
            total += val.nbytes
        else:
            total += val.numel() * val.element_size()
    return total
