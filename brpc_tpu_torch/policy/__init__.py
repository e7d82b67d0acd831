"""Pluggable policies (≈ brpc's src/brpc/policy/): the concurrency
limiters, the load balancers (``load_balancers``) and the naming services
(``naming``, ``remote_naming``), copies of ``brpc_tpu/policy/``'s.  The
balancers and the naming schemes register themselves when their module
is imported (``Channel.init`` with a naming URL imports both)."""

from .concurrency_limiter import (AutoLimiter, ConcurrencyLimiter,
                                  ConstantLimiter, TimeoutLimiter,
                                  make_limiter)

__all__ = ["AutoLimiter", "ConcurrencyLimiter", "ConstantLimiter",
           "TimeoutLimiter", "make_limiter"]
