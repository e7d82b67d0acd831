"""Device ops of the port: quantized matmul, and flash attention with its
hand-written CUDA forward kernel (``csrc/``, built by ``cuda_build``)."""
