"""Device-side ops for the payload path: the port of
``brpc_tpu/ops/device_ops.py``.

- :func:`checksum_u32` -- the 32-bit wrapping-sum checksum of a payload,
  the device analogue of butil's crc32c on the wire path.  The Pallas
  kernel of ``_checksum_fn`` becomes ``csrc/checksum.cu`` (CUDA C++ for
  sm_90a, built by :mod:`.cuda_build`, called through ctypes).  On a CUDA
  tensor the kernel runs, or the call raises; on a CPU tensor the plain
  version :func:`checksum_u32_plain` runs.  Nothing catches a build or
  launch error to run the plain version instead.
- :func:`embedding_bag` -- the multi-slot lookup + mean of the
  parameter-server model family, in torch ops (XLA fused the JAX one; it
  has no Pallas kernel).
- :func:`tensor_bytes` / :func:`bytes_to_tensor` -- tensor <-> wire bytes
  and a dtype name, for device payloads that ride an RPC attachment.
  Dtype names are numpy's (``"float32"``, ``"bfloat16"``, ``"bool"``...),
  as the JAX package writes them; bf16 rides as its raw 2-byte words.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .cuda_build import CudaKernel

# numpy dtype names on the wire <-> torch dtypes
_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
# signed integer of each width: how a dtype numpy lacks (bf16) is viewed
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a torch dtype (numpy's name for it)."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise TypeError(f"{dtype} has no wire name") from None


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire dtype name."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown wire dtype {name!r}") from None


# -- checksum --------------------------------------------------------------

class ChecksumKernel(CudaKernel):
    """``checksum_u32``: ``(words) -> out``, where ``words`` is a contiguous
    int32 CUDA tensor and ``out`` a one-element int32 tensor on its device
    holding the wrapping sum (read it as uint32).  Launches on the current
    stream and does not synchronise."""

    def __init__(self):
        super().__init__("checksum_u32", "checksum.cu",
                         [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                          ctypes.c_void_p])

    def __call__(self, words: torch.Tensor) -> torch.Tensor:
        if not words.is_cuda:
            raise ValueError("checksum_u32 kernel needs a CUDA tensor")
        if words.dtype != torch.int32 or not words.is_contiguous():
            raise TypeError("checksum_u32 kernel takes contiguous int32 words")
        out = torch.empty((1,), dtype=torch.int32, device=words.device)
        stream = torch.cuda.current_stream(words.device).cuda_stream
        self._launch(words.data_ptr(), words.numel(), out.data_ptr(), stream)
        return out


CHECKSUM = ChecksumKernel()


def checksum_words(x: torch.Tensor) -> torch.Tensor:
    """The flat contiguous int32 words whose sum is ``x``'s checksum, in
    the JAX package's order of canonicalisation: 8-byte dtypes narrow
    first (float64 to float32, int64 and uint64 to their low 32 bits, as
    ``jnp.asarray`` does with x64 off), then every dtype whose itemsize is
    not 4 (bf16, f16, int8, uint8, int16, uint16, bool) is widened to f32
    by value, then the words are bitcast."""
    if x.is_complex():
        raise TypeError("checksum_u32 takes real tensors")
    t = x.reshape(-1)
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    elif t.dtype in (torch.int64, torch.uint64):
        t = t.view(torch.int64).to(torch.int32)
    if t.element_size() != 4:
        t = t.to(torch.float32)
    return t.contiguous().view(torch.int32)


def checksum_words_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: the int64 sum of the int32 words,
    masked to 32 bits (a 0-d int64 tensor, on the words' device)."""
    return words.sum(dtype=torch.int64) & 0xFFFFFFFF


def checksum_u32_plain(x: torch.Tensor) -> int:
    """:func:`checksum_u32` in PyTorch ops, on any device."""
    return int(checksum_words_plain(checksum_words(x)))


def checksum_u32(x, device="cuda") -> int:
    """32-bit wrapping sum of a payload's 32-bit words, as uint32 (the JAX
    docstring calls it an xor-fold; the code, here and there, sums).
    Non-32-bit payloads are summed through their f32 widening: integrity
    of the values, not of one bit layout.  A tensor is checksummed where
    it lies: on a CUDA tensor the kernel runs (the call synchronises to
    read the word back), on a CPU tensor the plain version.  Anything else
    becomes a tensor on ``device`` first."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x)).to(resolve_device(device))
    words = checksum_words(x)
    if words.is_cuda:
        return int(CHECKSUM(words).item()) & 0xFFFFFFFF
    return int(checksum_words_plain(words))


# -- embedding bag ---------------------------------------------------------

def embedding_bag(table: torch.Tensor, ids) -> torch.Tensor:
    """Multi-slot lookup + mean pool: ``(vocab, d)`` float table and
    ``(batch, slots)`` ids -> ``(batch, d)``.  Ids follow ``jnp.take``:
    one in ``[-vocab, 0)`` counts from the end, one outside ``[-vocab,
    vocab)`` reads a NaN row, so its bag's mean is NaN.  No id reaches
    the gather out of range (on CUDA that would be a device-side assert,
    fatal to the process)."""
    if not isinstance(ids, torch.Tensor):
        ids = torch.from_numpy(np.array(ids, dtype=np.int64))
    ids = ids.to(device=table.device, dtype=torch.int64)
    vocab = table.shape[0]
    valid = (ids >= -vocab) & (ids < vocab)
    emb = table[ids.remainder(vocab)]                  # (b, s, d)
    emb = torch.where(valid[..., None], emb, float("nan"))
    return emb.mean(dim=1)


# -- tensor <-> wire bytes -------------------------------------------------

def tensor_bytes(x) -> Tuple[memoryview, str, Tuple[int, ...]]:
    """Tensor (any device) or host array -> ``(raw bytes, dtype name,
    shape)`` for an RPC attachment.  The buffer is a read-only view over
    a host copy (one D2H for a CUDA tensor); for a contiguous CPU tensor
    or numpy array it aliases the caller's storage, which must not change
    until the RPC's write completes."""
    if isinstance(x, torch.Tensor):
        host = x.detach().contiguous().cpu()
        name, shape = dtype_name(host.dtype), tuple(host.shape)
        arr = host.reshape(-1).view(_BITS[host.element_size()]).numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(x))
        name, shape = str(arr.dtype), tuple(arr.shape)
        arr = arr.reshape(-1)
    return memoryview(arr).cast("B").toreadonly(), name, shape


def bytes_to_tensor(data, dtype: str, shape: Tuple[int, ...],
                    device="cuda") -> torch.Tensor:
    """Wire bytes (bytes or any contiguous buffer) -> a tensor on
    ``device``: one host copy, then the H2D copy for a CUDA device."""
    dev = resolve_device(device)
    td = torch_dtype(dtype)
    shape = tuple(int(s) for s in shape)
    itemsize = torch.empty((), dtype=td).element_size()
    nbytes = math.prod(shape) * itemsize
    if len(memoryview(data).cast("B")) != nbytes:
        raise ValueError(f"{len(data)} bytes do not hold a {dtype} "
                         f"tensor of shape {shape}")
    if nbytes == 0:
        return torch.empty(shape, dtype=td, device=dev)
    host = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return host.view(td).reshape(shape).to(dev)
