"""Overload plane — the one admission stage the dispatch path runs.

The port's server (classic tpu_std, one thread per connection) calls
:func:`admit` before anything else touches a request of a known method;
the stage composes four layers, with the drain plane's lame duck as
layer 0:

0. **lame duck** — a draining server admits nothing new: ``ELAMEDUCK``.
1. **server-wide cap** — ``Server.on_request_in``; the cap may be a
   ``make_limiter`` spec ("auto" / "timeout[:ms]" / "constant:N"), so
   the whole server's concurrency adapts to measured latency like a
   per-method limiter (≈ brpc ``-max_concurrency``).
2. **per-method cap** — ``MethodStatus.on_requested``: a static cap or
   an ``AutoLimiter``/``TimeoutLimiter`` fed each request's latency
   from its frame's arrival.
3. **CoDel queue discipline** — per-method sojourn time (the frame's
   arrival → this admission): when sojourn stays above
   ``overload_codel_target_ms`` for a full
   ``overload_codel_interval_ms``, requests are rejected at the head
   before user code, with the classic CoDel control law
   (``interval/sqrt(n)``).  Off by default (``enable_codel_shed``).
4. **per-tenant weighted fair admission** — tenant identity from meta
   TLV 22; each tenant's guaranteed share of ``tenant_fair_capacity``
   is ``weight/active_weight``, and the rest is a shared free pool, so
   an over-quota hot tenant is rejected only while the pool is
   contended.

A rejection is answered with an error frame (``ELIMIT``, or
``ELAMEDUCK`` while draining) on tpu_std, with :func:`http_reject`'s 503
on HTTP/1.1 and with grpc-status 8 on gRPC.  Every verdict is counted in the
module-global ``overload_admission_total{tenant,verdict}`` family (a
closed enum) and live per-tenant concurrency is exported as
``tenant_inflight{tenant}``.

A copy of ``brpc_tpu/server/admission.py``: :func:`trivial_shape` and
:func:`count_admitted_burst` serve the native engine's kind-3 slim lane
(``server/slim_dispatch.py``).
:func:`normalize_tenant` is the one tenant key the port's SLO tiers
(``models/lm_service.TierRegistry``) use too.
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import Dict, Optional, Tuple

from ..butil.flags import define_flag, get_flag, watch_flag
from ..butil.status import Errno
from ..butil.time_utils import monotonic_us
from ..bvar.multi_dimension import PassiveDimension

define_flag("enable_codel_shed", False,
            "CoDel queue discipline: reject requests at the head with "
            "ELIMIT when per-method queue sojourn exceeds the target "
            "for a full interval (opt-in, like brpc -server_fail_fast)",
            validator=lambda v: isinstance(v, bool))
define_flag("overload_codel_target_ms", 5.0,
            "CoDel sojourn target: queue delay above this for a full "
            "interval means a standing queue",
            validator=lambda v: isinstance(v, (int, float)) and v >= 0)
define_flag("overload_codel_interval_ms", 100.0,
            "CoDel interval: how long sojourn must stay above target "
            "before head-rejection starts (shrinks as interval/sqrt(n) "
            "under sustained overload)",
            validator=lambda v: isinstance(v, (int, float)) and v >= 0)
define_flag("enable_fair_admission", True,
            "per-tenant weighted fair admission (engages only when the "
            "server configures tenant_fair_capacity); the fairness "
            "bench's A/B switch",
            validator=lambda v: isinstance(v, bool))

_ELIMIT = int(Errno.ELIMIT)
_ELAMEDUCK = int(Errno.ELAMEDUCK)

# the closed verdict enum — every admission decision lands in exactly
# one of these buckets (acceptance: no "unknown" bucket possible)
ADMITTED = "admitted"
SERVER_CAP = "server_cap"
METHOD_CAP = "method_cap"
CODEL = "codel"
TENANT_QUOTA = "tenant_quota"
LAME_DUCK = "lame_duck"
VERDICTS = (ADMITTED, SERVER_CAP, METHOD_CAP, CODEL, TENANT_QUOTA,
            LAME_DUCK)


def normalize_tenant(raw) -> str:
    """One tenant-key normalization for every lane (TLV bytes, header
    bytes/str, ChannelOptions str).  Anonymous traffic pools under
    '-'; values are length-capped — a tenant id is a label, not a
    payload."""
    if not raw:
        return "-"
    if isinstance(raw, (bytes, memoryview)):
        raw = bytes(raw).decode("utf-8", "replace")
    raw = raw.strip()
    return raw[:64] if raw else "-"


# cardinality bound for the per-tenant tables: a client stamping a
# fresh random tenant per request must not grow server memory without
# bound — once a server has seen this many distinct tenants, NEW names
# pool into one overflow bucket (deterministic: known tenants keep
# their own row forever, so acquire/release of one request always
# resolve to the same key)
_MAX_TENANTS = 256
TENANT_OVERFLOW = "~other"


class Rejection:
    """One admission rejection, protocol-agnostic: the lane serializes
    it (``code``/``text`` for tpu_std error frames and grpc trailers;
    :func:`http_reject` for HTTP)."""

    __slots__ = ("reason", "code", "text", "retry_after_s")

    def __init__(self, reason: str, text: str, retry_after_s: int = 1,
                 code: int = _ELIMIT):
        self.reason = reason
        self.code = code
        self.text = text
        self.retry_after_s = retry_after_s


def http_reject(rej: Rejection):
    """The HTTP spelling of an admission rejection: (status, body,
    extra_headers).  ``Retry-After`` tells well-behaved clients when to
    come back; ``x-overload-reason`` distinguishes server-cap /
    method-cap / codel / tenant-quota."""
    return 503, rej.text.encode(), [
        ("Retry-After", str(rej.retry_after_s)),
        ("x-overload-reason", rej.reason),
        ("x-rpc-error-code", str(rej.code)),
    ]


# ---------------------------------------------------------------------------
# module-global accounting (mirrors deadline.py's shed counters: the
# bvar registry is process-global, so the labeled families aggregate
# across every Server in the process)
# ---------------------------------------------------------------------------

_acct_lock = threading.Lock()
_admission_total: Dict[Tuple[str, str], int] = {}
_controls: "weakref.WeakSet[AdmissionControl]" = weakref.WeakSet()


def _count(tenant: str, verdict: str) -> None:
    with _acct_lock:
        k = (tenant, verdict)
        _admission_total[k] = _admission_total.get(k, 0) + 1


def admission_counters() -> Dict[Tuple[str, str], int]:
    """Snapshot of the per-(tenant, verdict) admission counters."""
    with _acct_lock:
        return dict(_admission_total)


def tenant_inflight_snapshot() -> Dict[str, int]:
    """Live per-tenant in-flight concurrency, aggregated across every
    server in the process (the ``tenant_inflight`` gauge family)."""
    out: Dict[str, int] = {}
    for ctl in list(_controls):
        for t, n in ctl.tenant_inflight().items():
            if n:
                out[t] = out.get(t, 0) + n
    return out


_admission_var = PassiveDimension(
    ("tenant", "verdict"), lambda: admission_counters(),
    name="overload_admission_total")
_inflight_var = PassiveDimension(
    ("tenant",), lambda: tenant_inflight_snapshot(),
    name="tenant_inflight")


# ---------------------------------------------------------------------------
# CoDel state (one per method)
# ---------------------------------------------------------------------------

class _CoDel:
    __slots__ = ("first_above_us", "drop_next_us", "count")

    def __init__(self):
        self.first_above_us = 0     # when sojourn first stayed above
        self.drop_next_us = 0       # next head-drop time while dropping
        self.count = 0              # consecutive drops (control law n)


class AdmissionControl:
    """Per-server admission state: tenant in-flight counters + CoDel
    per-method queue state.  The decision logic lives in
    :meth:`admit`; the verdict counters are module-global."""

    def __init__(self, server):
        self._server = server
        self._lock = threading.Lock()
        self._tenant_inflight: Dict[str, int] = {}
        self._tenant_total = 0
        self._tenant_seen: set = set()     # cardinality registry — ALL
        #                                    observed tenants, admitted
        #                                    OR rejected
        self._codel: Dict[str, _CoDel] = {}
        _controls.add(self)

    # -- introspection (the /overload page) --------------------------------

    def tenant_inflight(self) -> Dict[str, int]:
        with self._lock:
            return {t: n for t, n in self._tenant_inflight.items() if n}

    def _resolve_tenant(self, tenant: str) -> str:
        """Cardinality bound (call under self._lock): known tenants and
        configured weights keep their own row; once _MAX_TENANTS
        distinct names have been OBSERVED — admitted or rejected (a
        flood of rejections with fresh random names is exactly the
        overload case this bound exists for) — new ones pool into
        TENANT_OVERFLOW.  Membership never shrinks, so acquire/release
        and every counter of one request resolve identically."""
        if tenant in self._tenant_seen:
            return tenant
        if len(self._tenant_seen) >= _MAX_TENANTS:
            w = getattr(self._server.options, "tenant_weights", None)
            if not w or tenant not in w:
                return TENANT_OVERFLOW
        self._tenant_seen.add(tenant)
        return tenant

    def codel_state(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {m: {"dropping": int(st.drop_next_us > 0),
                        "drops": st.count}
                    for m, st in self._codel.items()}

    # -- fair admission ----------------------------------------------------

    def _fair_capacity(self) -> int:
        cap = getattr(self._server.options, "tenant_fair_capacity", 0)
        return cap if isinstance(cap, int) and cap > 0 else 0

    def _tenant_weight(self, tenant: str) -> float:
        w = getattr(self._server.options, "tenant_weights", None)
        if not w:
            return 1.0
        return max(0.001, float(w.get(tenant, 1)))

    def _tenant_acquire(self, tenant: str) -> bool:
        """Weighted quota + shared free pool, under one lock.  A tenant
        below its guaranteed share is ALWAYS admitted (the guarantee);
        above it, admission needs free capacity (total < capacity) —
        so an over-quota hot tenant is rejected only while contended."""
        cap = self._fair_capacity()
        with self._lock:
            tenant = self._resolve_tenant(tenant)
            if not cap or not get_flag("enable_fair_admission", True):
                # accounting only (the tenant_inflight gauge stays
                # truthful even with fairness off — the bench A/B
                # relies on it)
                self._tenant_inflight[tenant] = \
                    self._tenant_inflight.get(tenant, 0) + 1
                self._tenant_total += 1
                return True
            mine = self._tenant_inflight.get(tenant, 0)
            if mine > 0:
                active_w = sum(self._tenant_weight(t)
                               for t, n in self._tenant_inflight.items()
                               if n > 0)
            else:
                active_w = self._tenant_weight(tenant) + sum(
                    self._tenant_weight(t)
                    for t, n in self._tenant_inflight.items() if n > 0)
            guarantee = max(1, int(cap * self._tenant_weight(tenant)
                                   / max(active_w, 0.001)))
            if mine >= guarantee and self._tenant_total >= cap:
                return False
            self._tenant_inflight[tenant] = mine + 1
            self._tenant_total += 1
            return True

    def release(self, tenant_raw) -> None:
        """Settle one admitted request's tenant slot (every lane's
        completion path calls this through ``Server.on_request_out``)."""
        tenant = normalize_tenant(tenant_raw)
        with self._lock:
            tenant = self._resolve_tenant(tenant)
            n = self._tenant_inflight.get(tenant, 0)
            if n > 0:
                self._tenant_inflight[tenant] = n - 1
                self._tenant_total -= 1

    # -- CoDel -------------------------------------------------------------

    def _codel_drop(self, method: str, sojourn_us: float,
                    now_us: int) -> bool:
        target_us = float(get_flag("overload_codel_target_ms", 5.0)) * 1000
        interval_us = float(get_flag("overload_codel_interval_ms",
                                     100.0)) * 1000
        with self._lock:
            st = self._codel.get(method)
            if st is None:
                st = self._codel[method] = _CoDel()
            if sojourn_us <= target_us:
                # queue drained below target: leave dropping state
                st.first_above_us = 0
                st.drop_next_us = 0
                st.count = 0
                return False
            if st.first_above_us == 0:
                # first above-target observation: arm the interval
                st.first_above_us = now_us + int(interval_us)
                return False
            if now_us < st.first_above_us:
                return False            # not above-target long enough yet
            # standing queue: head-drop on the CoDel control law —
            # interval/sqrt(n) between drops, accelerating under
            # sustained overload until sojourn falls below target
            if st.drop_next_us and now_us < st.drop_next_us:
                return False
            st.count += 1
            st.drop_next_us = now_us + max(
                1, int(interval_us / math.sqrt(st.count)))
            return True

    # -- the one admission decision ----------------------------------------

    def admit(self, entry, lane: str, tenant_raw,
              arrival_us: Optional[int]) -> Optional[Rejection]:
        """Run the four admission layers for one request.  None =
        admitted (server + method in-flight taken, tenant slot held —
        the lane MUST route its completion through
        ``MethodStatus.on_responded`` + ``Server.on_request_out(tenant=
        ...)``).  A :class:`Rejection` = answer the client NOW, before
        user code; all taken counts are already undone."""
        server = self._server
        status = entry.status
        with self._lock:
            tenant = self._resolve_tenant(normalize_tenant(tenant_raw))
        if getattr(server, "draining", False):
            # operability plane, layer 0: a draining server admits
            # NOTHING new — the in-flight set must reach zero within
            # the grace.  ELAMEDUCK (not ELIMIT): the client removes
            # the node from LB selection with no breaker penalty and
            # fail-fast-retries elsewhere; every lane serializes this
            # through its existing rejection path.
            _count(tenant, LAME_DUCK)
            return Rejection(LAME_DUCK, "server draining (lame duck)",
                             code=_ELAMEDUCK)
        if not server.on_request_in():
            _count(tenant, SERVER_CAP)
            return Rejection(SERVER_CAP, "server max_concurrency")
        if getattr(server, "draining", False):
            # drain-start raced the unlocked check above: our in-flight
            # increment is now VISIBLE to drain's settle wait (it reads
            # under the same lock), so undo and reject — the handler
            # must not start against a server about to tear down
            server.on_request_out()
            _count(tenant, LAME_DUCK)
            return Rejection(LAME_DUCK, "server draining (lame duck)",
                             code=_ELAMEDUCK)
        if not status.on_requested():
            server.on_request_out()
            _count(tenant, METHOD_CAP)
            # the live limit rides along so a fail-fast client's log
            # says WHAT it bounced off, not just that it bounced
            return Rejection(
                METHOD_CAP,
                f"method max_concurrency ({status.full_name} at "
                f"{status.live_max_concurrency()})")
        if arrival_us and get_flag("enable_codel_shed", False):
            now = monotonic_us()
            if self._codel_drop(status.full_name,
                                now - arrival_us, now):
                status.undo_requested()
                server.on_request_out()
                _count(tenant, CODEL)
                return Rejection(
                    CODEL, f"{status.full_name} codel queue delay over "
                           "target (standing queue shed)")
        if not self._tenant_acquire(tenant):
            status.undo_requested()
            server.on_request_out()
            _count(tenant, TENANT_QUOTA)
            return Rejection(TENANT_QUOTA,
                             f"tenant {tenant} quota exceeded")
        _count(tenant, ADMITTED)
        return None


def admit(server, entry, lane: str, tenant_raw,
          arrival_us: Optional[int]) -> Optional[Rejection]:
    """Module-level convenience: every lane calls this one function."""
    return server.admission.admit(entry, lane, tenant_raw, arrival_us)


# ---------------------------------------------------------------------------
# Trivial-shape fast admission (the slim lanes' hot path).  When NO
# admission layer is configured — no server cap/limiter, no method
# cap/limiter, CoDel off, no fair capacity — and the request carries no
# tenant, the full admit() walk is pure overhead: the decision is known
# to be ADMITTED before it starts.  fast_in/fast_out keep every counter
# truthful (server/method in-flight gauges, the '-' tenant gauge, the
# admitted-verdict bucket) while skipping the decision machinery.  The
# CoDel flag is cached through a watcher so the per-call check is one
# list read, not a flags-table lookup.
# ---------------------------------------------------------------------------

_codel_live = [bool(get_flag("enable_codel_shed", False))]
watch_flag("enable_codel_shed",
           lambda v: _codel_live.__setitem__(0, bool(v)))


def trivial_shape(server, status) -> bool:
    """True when admission for an untenanted request on this method is
    decision-free (all four layers unconfigured).  Reads live state, so
    caps installed mid-run are honored on the very next call."""
    if status.limiter is not None or status.max_concurrency:
        return False
    if _codel_live[0]:
        return False
    if server.draining:
        # drain: every request must take the full admit() walk so the
        # lame-duck rejection (and its verdict accounting) fires
        return False
    opts = server.options
    mc = opts.max_concurrency
    if not isinstance(mc, int) or mc > 0:
        return False
    cap = getattr(opts, "tenant_fair_capacity", 0)
    return not (isinstance(cap, int) and cap > 0)


def count_admitted_burst(n: int) -> None:
    """Fold one engine read burst's trivial-shape admitted verdicts into
    the module-global counter family: one lock hold per burst instead of
    one per item (the verdict enum stays closed — every fast item still
    lands in exactly one bucket)."""
    if n <= 0:
        return
    with _acct_lock:
        k = ("-", ADMITTED)
        _admission_total[k] = _admission_total.get(k, 0) + n
