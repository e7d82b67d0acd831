"""Device ops of the port: quantized matmul, and flash attention with its
hand-written CUDA forward and backward kernels (``csrc/``, built by
``cuda_build``)."""
