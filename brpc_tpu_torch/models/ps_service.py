"""Parameter-server RPC service -- the port of
``brpc_tpu/models/ps_service.py``, with the same wire format, JSON and
error codes.

Ids ride the request payload; tensors ride the device-attachment lane
(device-resident to a peer in this process, as bytes otherwise).

Methods:
- ``Lookup``     ids -> pooled embeddings (response device attachment)
- ``Predict``    ids -> logits (response device attachment)
- ``EchoTensor`` the request's device attachment back as the response's
- ``Train``      (ids, labels) -> loss; one SGD step server-side; labels
  ride the device attachment or the byte attachment as int32
- ``Stat``       model and table shape (JSON)
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np
import torch

from ..butil.status import Errno
from ..ops.device_ops import dtype_name
from ..server.service import Service
from .embedding_ps import EmbeddingPS, PSConfig


def pack_ids(ids) -> bytes:
    """(batch, slots) int32 -> wire payload."""
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    return struct.pack("<II", *ids.shape) + ids.tobytes()


def unpack_ids(data: bytes) -> np.ndarray:
    b, s = struct.unpack_from("<II", data)
    return np.frombuffer(data, dtype=np.int32, offset=8).reshape(b, s)


def _describe(t: torch.Tensor) -> bytes:
    return json.dumps({"dtype": dtype_name(t.dtype),
                       "shape": [int(s) for s in t.shape]}).encode()


class PSService(Service):
    def __init__(self, model: Optional[EmbeddingPS] = None, device="cuda"):
        self.model = model or EmbeddingPS(
            PSConfig(vocab=4096, dim=64, hidden=128, classes=8),
            device=device)

    def Lookup(self, cntl, request):
        try:
            ids = unpack_ids(request)
        except (struct.error, ValueError) as e:
            cntl.set_failed(Errno.EREQUEST, f"bad ids payload: {e}")
            return None
        pooled = self.model.lookup(ids)
        cntl.response_device_attachment = pooled
        return _describe(pooled)

    def Predict(self, cntl, request):
        try:
            ids = unpack_ids(request)
        except (struct.error, ValueError) as e:
            cntl.set_failed(Errno.EREQUEST, f"bad ids payload: {e}")
            return None
        logits = self.model.predict(ids)
        cntl.response_device_attachment = logits
        return _describe(logits)

    def EchoTensor(self, cntl, request):
        """Device-tensor echo (the rdma_performance analogue): the
        request's device attachment comes back as the response's; on the
        model's device a descriptor's tensor is never copied."""
        att = cntl.request_device_attachment
        if att is None:
            cntl.set_failed(Errno.EREQUEST, "no device attachment")
            return None
        cntl.response_device_attachment = att.tensor(self.model.device)
        return b"ok"

    def Train(self, cntl, request):
        try:
            ids = unpack_ids(request)
            if cntl.request_device_attachment is not None:
                labels = cntl.request_device_attachment.tensor(
                    self.model.device).to(torch.int32)
            else:
                labels = torch.from_numpy(np.frombuffer(
                    cntl.request_attachment, dtype=np.int32).copy())
        except (struct.error, ValueError) as e:
            cntl.set_failed(Errno.EREQUEST, f"bad train payload: {e}")
            return None
        if labels.shape[:1] != ids.shape[:1]:
            cntl.set_failed(Errno.EREQUEST, "labels/ids batch mismatch")
            return None
        loss = self.model.train_step(ids, labels)
        return json.dumps({"loss": loss}).encode()

    def Stat(self, cntl, request):
        cfg = self.model.cfg
        return json.dumps({
            "vocab": cfg.vocab, "dim": cfg.dim, "hidden": cfg.hidden,
            "classes": cfg.classes,
            "sharded": self.model.mesh is not None,
        }).encode()
