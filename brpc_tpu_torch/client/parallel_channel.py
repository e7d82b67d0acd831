"""ParallelChannel & SelectiveChannel — channel combinators.

≈ brpc's src/brpc/parallel_channel.h:94,127,168 and
selective_channel.h:52,69:

- **ParallelChannel** fans one call out to every sub-channel
  concurrently; a ``call_mapper(index, sub_channel, request)`` shapes the
  per-branch request (return ``SKIP`` to drop a branch), a
  ``response_merger(responses)`` folds branch responses; the call fails
  once more than ``fail_limit`` branches fail.
- **SelectiveChannel** load-balances whole calls over heterogeneous
  sub-channels with independent retry: a failed branch moves to another
  sub-channel (the failed one is excluded for that call).

The port of ``brpc_tpu/client/parallel_channel.py``.  Its calls are
synchronous.  The fan-out is the JAX package's
(``brpc_tpu/client/parallel_channel.py:114-148``): every branch rides a
pooled leg, and ``fast_call.run_scatter`` writes every branch's request
before it reads the first response, in one engine ``scatter_call`` on
the pinned connections when the shape allows, from this thread either
way.  Only a shape the scatter lane declines, counted under its name in
``fast_call.scatter_fallback_counters()`` (a cluster branch, a device
attachment, a request that is not bytes, ...), runs each branch as a
blocking ``Channel.call_method`` on a thread of its own.  The rest is the
JAX package's too: the mapper and ``SKIP``, one merger over the ordered
branch responses (``None`` for a failed branch), the fail limit
(``ETOOMANYFAILS`` once ``fail_limit`` branches, or every branch,
failed), one budget shared by every leg, and for a traced call one root
client span that every branch's client span parents to.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

from ..butil.status import Errno
from ..butil.time_utils import monotonic_us
from ..deadline import cap_timeout_ms
from ..rpcz import start_client_span
from . import fast_call
from .controller import Controller


def _leg_budget_ms(begin_us: int, timeout_ms: Optional[int]
                   ) -> Optional[int]:
    """The fan-out shares ONE budget: a leg launched ``elapsed`` after
    the fan-out began gets ``timeout_ms - elapsed``, not a fresh copy of
    the full timeout (a slow first leg must not let later legs run the
    total call past the caller's deadline).  ≤ 0 means the budget is
    spent — the leg fails fast.  None/unset timeouts pass through."""
    if not timeout_ms or timeout_ms <= 0:
        return timeout_ms
    return int(timeout_ms - (monotonic_us() - begin_us) // 1000)


SKIP = object()          # call_mapper return: skip this sub-channel


def default_call_mapper(index: int, sub_channel, request):
    return request


def default_response_merger(responses: List[Any]):
    return responses


def _inherit_budget(c: Controller) -> bool:
    """Cap the call's timeout by an inherited deadline; False (the call
    failed fast) when that budget is already gone."""
    c.timeout_ms, expired = cap_timeout_ms(c.timeout_ms)
    if expired:
        c.set_failed(Errno.ERPCTIMEDOUT, "inherited deadline already "
                     "expired (doomed fan-out failed fast)")
    return not expired


class ParallelChannel:
    def __init__(self, fail_limit: int = -1):
        self._subs: List[tuple] = []
        self.fail_limit = fail_limit

    def add_channel(self, channel,
                    call_mapper: Optional[Callable] = None) -> None:
        """The fan-out merger is per-call (call_method's ``merger=``),
        not per-channel as in the reference — one merger over the ordered
        branch responses covers the same use cases."""
        self._subs.append((channel, call_mapper or default_call_mapper))

    @property
    def channel_count(self) -> int:
        return len(self._subs)

    def call_method(self, method_full: str, request: Any,
                    cntl: Optional[Controller] = None,
                    merger: Optional[Callable] = None) -> Controller:
        c = cntl or Controller()
        if not _inherit_budget(c):
            return c
        begin_us = monotonic_us()        # the ONE fan-out budget anchor
        merger = merger or default_response_merger
        branches: List[tuple] = []       # (index, sub, mapped_request)
        for i, (sub, mapper) in enumerate(self._subs):
            mapped = mapper(i, sub, request)
            if mapped is SKIP:
                continue
            branches.append((i, sub, mapped))
        if not branches:
            c.set_failed(Errno.EPCHANFINISH, "all branches skipped")
            return c
        n = len(branches)
        fail_limit = self.fail_limit if self.fail_limit >= 0 else n
        if c.trace_id:
            # one root client span for the whole scatter-gather; every
            # branch's client span parents to it
            root = start_client_span(f"ParallelChannel.{method_full}",
                                     c.trace_id, c.span_id)
            if root is not None:
                root.annotate(f"fan-out: {n} branches")
                c._client_span = root
                c.span_id = root.span_id
        left = _leg_budget_ms(begin_us, c.timeout_ms)
        if left is not None and c.timeout_ms and left <= 0:
            c.set_failed(Errno.ERPCTIMEDOUT, "fan-out budget exhausted "
                         "before any leg launched")
            c._end_trace_span(None)
            return c
        legs = []
        for _, sub, mapped in branches:
            sc = Controller()
            sc.timeout_ms = left
            sc.max_retry = c.max_retry
            # unary one-shots: exclusive pooled connections let one
            # thread own every read
            sc.connection_type = "pooled"
            sc.trace_id = c.trace_id
            sc.span_id = c.span_id
            legs.append(sc)
        scatter = [(sub, sc, method_full, mapped, None)
                   for (_, sub, mapped), sc in zip(branches, legs)]
        if fast_call.run_scatter(scatter, left):
            for (_, sub, _), sc in zip(branches, legs):
                sc._end_trace_span(sc.remote_side)
        else:
            threads = [threading.Thread(
                target=sub.call_method, args=(method_full, mapped),
                kwargs={"cntl": sc}, name="pchan-branch", daemon=True)
                for (_, sub, mapped), sc in zip(branches, legs)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        failed = [sc for sc in legs if sc.failed]
        if failed and (len(failed) >= fail_limit or len(failed) == n):
            c.set_failed(Errno.ETOOMANYFAILS,
                         f"{len(failed)}/{n} branches failed (codes="
                         f"{[sc.error_code for sc in failed][:4]}, first="
                         f"{[sc.error_text for sc in failed][:1]})")
        else:
            try:
                c.response = merger([None if sc.failed else sc.response
                                     for sc in legs])
            except Exception as e:      # the caller's merger
                c.set_failed(Errno.EINTERNAL, f"merger raised: {e}")
        c._end_trace_span(None)
        return c


class SelectiveChannel:
    """Round-robin over sub-channels; each call picks one, failures move
    the call to another sub-channel (independent retry across channels).
    Sub-channels are typically cluster channels with their own LB, so
    channel-level selection stays simple by design."""

    def __init__(self, max_retry: int = 3):
        self._subs: List[Any] = []
        self.max_retry = max_retry
        self._counter_lock = threading.Lock()
        self._rr = 0

    def add_channel(self, channel) -> int:
        self._subs.append(channel)
        return len(self._subs) - 1

    def _pick(self, excluded: set) -> Optional[int]:
        n = len(self._subs)
        with self._counter_lock:
            for _ in range(n):
                idx = self._rr % n
                self._rr += 1
                if idx not in excluded:
                    return idx
        return None

    def call_method(self, method_full: str, request: Any,
                    cntl: Optional[Controller] = None) -> Controller:
        c = cntl or Controller()
        if not self._subs:
            c.set_failed(Errno.EINTERNAL, "no sub channels")
            return c
        # one shared budget across sub-channel attempts: attempt k+1 gets
        # what attempt k left, not a fresh copy of the full timeout
        if not _inherit_budget(c):
            return c
        begin_us = monotonic_us()
        excluded: set = set()
        last = (int(Errno.ETOOMANYFAILS), "all sub channels failed")
        for _ in range(min(self.max_retry + 1, len(self._subs))):
            idx = self._pick(excluded)
            if idx is None:
                break
            left = _leg_budget_ms(begin_us, c.timeout_ms)
            if left is not None and c.timeout_ms and left <= 0:
                c.set_failed(Errno.ERPCTIMEDOUT, "budget exhausted across "
                             "sub-channel attempts")
                return c
            sc = Controller()
            sc.timeout_ms = left
            self._subs[idx].call_method(method_full, request, cntl=sc)
            if not sc.failed:
                c.response = sc.response
                c.response_attachment = sc.response_attachment
                c.remote_side = sc.remote_side
                return c
            excluded.add(idx)
            last = (sc.error_code, sc.error_text)
        c.set_failed(*last)
        return c
