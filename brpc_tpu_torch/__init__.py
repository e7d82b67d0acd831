"""brpc_tpu_torch — the PyTorch/CUDA port of ``brpc_tpu``.

Mirrors ``brpc_tpu/``'s layout, so each ported module sits at the same
relative path as its JAX counterpart.  It imports ``torch`` and never
``jax`` nor any module of ``brpc_tpu``: where it needs code of the JAX
package it keeps its own copy.  Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
