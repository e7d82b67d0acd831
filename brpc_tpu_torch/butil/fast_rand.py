"""Per-thread xorshift PRNG (≈ brpc's src/butil/fast_rand.cpp).

Used by load-balancer randomization and backoff jitter; avoids the global
lock inside ``random`` module's shared Random instance.

A copy of ``brpc_tpu/butil/fast_rand.py``.
"""

from __future__ import annotations

import os
import threading

_MASK64 = (1 << 64) - 1


class _State(threading.local):
    def __init__(self):
        seed = int.from_bytes(os.urandom(8), "little") | 1
        self.s = seed


_state = _State()


def fast_rand() -> int:
    """Uniform 64-bit value (xorshift64*)."""
    x = _state.s
    x ^= (x >> 12)
    x ^= (x << 25) & _MASK64
    x ^= (x >> 27)
    _state.s = x
    return (x * 0x2545F4914F6CDD1D) & _MASK64


def fast_rand_less_than(n: int) -> int:
    """Uniform in [0, n)."""
    if n <= 0:
        return 0
    return fast_rand() % n


def fast_rand_in(lo: int, hi: int) -> int:
    """Uniform in [lo, hi] inclusive."""
    if hi < lo:
        lo, hi = hi, lo
    return lo + fast_rand_less_than(hi - lo + 1)


def fast_rand_double() -> float:
    return (fast_rand() >> 11) * (1.0 / (1 << 53))
