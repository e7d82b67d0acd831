"""Device ops of the port: quantized matmul, flash attention with its
hand-written CUDA forward and backward kernels, and the payload ops
(``checksum_u32`` with its CUDA kernel, ``embedding_bag``, tensor <-> wire
bytes).  Kernels live in ``csrc/`` and are built by ``cuda_build``."""

from .device_ops import (bytes_to_tensor, checksum_u32, embedding_bag,
                         tensor_bytes)

__all__ = ["bytes_to_tensor", "checksum_u32", "embedding_bag",
           "tensor_bytes"]
