"""Pluggable policies (≈ brpc's src/brpc/policy/).

The port's copy of ``brpc_tpu/policy/`` holds the concurrency limiters
only; the load balancers and the naming services (``load_balancers``,
``naming``, ``remote_naming``) wait for the fleet and cluster client
slice."""

from .concurrency_limiter import (AutoLimiter, ConcurrencyLimiter,
                                  ConstantLimiter, TimeoutLimiter,
                                  make_limiter)

__all__ = ["AutoLimiter", "ConcurrencyLimiter", "ConstantLimiter",
           "TimeoutLimiter", "make_limiter"]
