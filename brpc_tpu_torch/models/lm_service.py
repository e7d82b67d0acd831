"""LM serving over the port's RPC: ``Generate`` and ``Info``.

Counterpart of ``brpc_tpu/models/lm_service.py``'s ``Generate``/``Info``
with the same wire format: request = ``<u32 batch><u32 prompt_len>
<u32 max_new>`` + int32 prompt ids; response = ``<u32 batch><u32
max_new>`` + int32 generated ids.  Validation, errors (``EREQUEST``) and
the power-of-two bucketing of ``max_new`` follow the JAX service, so a
client of either sees the same answers.  ``Decode`` streaming, the
continuous batcher, paging, tiers and speculative decoding are not
ported yet.
"""

from __future__ import annotations

import json
import struct
import threading
from typing import Optional

import numpy as np
import torch

from ..butil.status import Errno
from ..ops.quant import quantize_lm_params, quantized_nbytes
from ..server.service import Service
from ..utils.device import resolve_device
from .transformer_lm import LMConfig, init_params, make_scan_generator


def pack_generate_request(prompt: np.ndarray, max_new: int) -> bytes:
    prompt = np.ascontiguousarray(prompt, dtype=np.int32)
    b, s = prompt.shape
    return struct.pack("<III", b, s, max_new) + prompt.tobytes()


def unpack_generated(data: bytes) -> np.ndarray:
    b, n = struct.unpack_from("<II", data)
    return np.frombuffer(data, dtype=np.int32, offset=8).reshape(b, n)


class LMService(Service):
    """``Generate`` — greedy completion; ``Info`` — model config JSON.

    ``params`` default to :func:`init_params` drawn from a generator
    seeded with ``seed`` on ``device``.  Device work is serialized: one
    request runs on the card at a time."""

    def __init__(self, cfg: Optional[LMConfig] = None, params=None,
                 max_new_cap: int = 128, quantize: bool = False,
                 device="cuda", seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = cfg or LMConfig(vocab=256, dim=64, heads=4, depth=2,
                                   max_seq=128, remat=False)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, self.cfg, self.device)
        self.params = quantize_lm_params(params) if quantize else params
        self.quantized = quantize
        self.max_new_cap = max_new_cap
        self._param_bytes = quantized_nbytes(self.params)
        self._gen = make_scan_generator(self.cfg, self.params, self.device)
        self._device_lock = threading.Lock()

    def Generate(self, cntl, request):
        try:
            b, s, max_new = struct.unpack_from("<III", request)
            prompt = np.frombuffer(request, dtype=np.int32,
                                   offset=12).reshape(b, s)
        except (struct.error, ValueError) as e:
            cntl.set_failed(Errno.EREQUEST, f"bad generate request: {e}")
            return None
        if b == 0 or s == 0:
            cntl.set_failed(Errno.EREQUEST, "empty prompt")
            return None
        if max_new <= 0 or max_new > self.max_new_cap:
            cntl.set_failed(Errno.EREQUEST,
                            f"max_new must be in [1, {self.max_new_cap}]")
            return None
        if s + max_new > self.cfg.max_seq:
            cntl.set_failed(
                Errno.EREQUEST,
                f"prompt {s} + max_new {max_new} exceeds max_seq "
                f"{self.cfg.max_seq}")
            return None
        if (prompt < 0).any() or (prompt >= self.cfg.vocab).any():
            cntl.set_failed(Errno.EREQUEST, "prompt ids out of vocab")
            return None
        # the JAX service buckets max_new to share compiled programs; the
        # port keeps the same step count so both emit the same tokens
        bucket = 1
        while bucket < max_new:
            bucket <<= 1
        bucket = min(bucket, self.max_new_cap, self.cfg.max_seq - s)
        ids = torch.from_numpy(prompt.astype(np.int64)).to(self.device)
        with self._device_lock:
            toks = self._gen(ids, int(bucket))
        out = np.ascontiguousarray(toks.cpu().numpy()[:, :max_new],
                                   dtype=np.int32)
        return struct.pack("<II", *out.shape) + out.tobytes()

    def Info(self, cntl, request):
        c = self.cfg
        return json.dumps({"vocab": c.vocab, "dim": c.dim,
                           "heads": c.heads, "depth": c.depth,
                           "max_seq": c.max_seq,
                           "quantized": self.quantized,
                           "param_bytes": self._param_bytes,
                           }).encode()
