"""LM serving over the port's RPC: ``Generate``, ``Decode`` and ``Info``.

Counterpart of ``brpc_tpu/models/lm_service.py`` with the same wire
format: request = ``<u32 batch><u32 prompt_len><u32 max_new>`` + int32
prompt ids; ``Generate``'s response = ``<u32 batch><u32 max_new>`` +
int32 generated ids; ``Decode`` streams one int32 token per step on the
caller's stream and answers ``<u32 max_new>``.  Validation, errors
(``EREQUEST``), the power-of-two bucketing of ``max_new`` and of
``Decode``'s prefill follow the JAX service, so a client of either sees
the same answers.

``Decode`` rides :class:`ContinuousBatcher`, contiguous or paged (a
block-table page pool with the prefix cache and the host tier of
``kv/pages.py``), with chunked prefill, SLO tiers (:class:`TierRegistry`)
and, in paged mode, speculative decoding.  A decode tier's batcher also
seats sessions prefilled on another tier
(:meth:`ContinuousBatcher.join_imported`, the disaggregated handoff of
``kv/disagg.py``), and :meth:`LMService.model_fingerprint` names what the
two tiers must agree on.  MoE configs serve through every program;
``scan_layers`` configs serve ``Generate`` only, and ``Decode`` answers
them EREQUEST, as the JAX service does.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import struct
import sys
import threading
import time
from collections import deque
from time import monotonic_ns as _mono_ns
from typing import Optional

import numpy as np
import torch

from .. import fleet
from ..butil.status import Errno
from ..bvar.multi_dimension import PassiveDimension
from ..kv.pages import (HostPagePool, PageAllocator, PrefixCache,
                        count_evict)
from ..ops.quant import quantize_lm_params, quantized_nbytes
from ..rpcz import Span
from ..server.admission import _MAX_TENANTS, normalize_tenant
from ..server.service import Service
from ..utils.device import resolve_device
from . import lm_telemetry as _lmt
from .lm_telemetry import (PH_CATCHUP_SLICE, PH_CHUNK_SLICE,
                           PH_DECODE_ROUND, PH_HOST_RESUME, PH_HOST_SPILL,
                           PH_PAGE_ALLOC, PH_PREFIX_LOOKUP, PH_SPEC_DRAFT,
                           PH_SPEC_VERIFY, PH_STREAM_EMIT)
from .lm_telemetry import record_phase as _rec_phase
from .transformer_lm import (LMConfig, empty_batch_cache, empty_paged_cache,
                             init_params, make_batch_decode,
                             make_paged_batch_decode, make_paged_io,
                             make_paged_spec_verify, make_scan_generator,
                             paged_page_bytes)

LOG = logging.getLogger(__name__)

# The port's generator is a Python loop of kernel launches that holds the
# interpreter lock between launches, where the JAX service's one compiled
# scan releases it while the device works.  A thread that waits for the
# lock asks for it only after the switch interval (5 ms by default), so
# beside a running Generate every hand-off on a server's IO path (the
# dispatcher's wake, the consumer fiber, the reply's write, a caller's
# read) could wait that long: a refused call took up to 28 ms.  While a
# generator runs, the interval is cut to this.
_LAUNCH_LOOP_SWITCH_S = 2e-4
_switch_lock = threading.Lock()
_switch_state = {"users": 0, "saved": 0.0, "set": 0.0}


@contextlib.contextmanager
def _short_switch_interval():
    """Run the body with the interpreter's switch interval at most
    ``_LAUNCH_LOOP_SWITCH_S``; the first of overlapping bodies cuts it,
    the last puts the earlier value back (unless someone else changed it
    meanwhile)."""
    st = _switch_state
    with _switch_lock:
        if st["users"] == 0:
            st["saved"] = sys.getswitchinterval()
            sys.setswitchinterval(min(st["saved"], _LAUNCH_LOOP_SWITCH_S))
            st["set"] = sys.getswitchinterval()
        st["users"] += 1
    try:
        yield
    finally:
        with _switch_lock:
            st["users"] -= 1
            if st["users"] == 0 and sys.getswitchinterval() == st["set"]:
                sys.setswitchinterval(st["saved"])


def pack_generate_request(prompt: np.ndarray, max_new: int) -> bytes:
    prompt = np.ascontiguousarray(prompt, dtype=np.int32)
    b, s = prompt.shape
    return struct.pack("<III", b, s, max_new) + prompt.tobytes()


def unpack_generated(data: bytes) -> np.ndarray:
    b, n = struct.unpack_from("<II", data)
    return np.frombuffer(data, dtype=np.int32, offset=8).reshape(b, n)


def unpack_token(chunk) -> int:
    """One streamed decode token (``Decode``'s chunk: one little-endian
    int32 per token per step)."""
    (tok,) = struct.unpack("<i", bytes(chunk))
    return tok


# -- SLO tiers ---------------------------------------------------------------

# Per-tenant latency classes the batcher schedules by.  Rank = index: lower
# ranks win the chunk budget, drain first from pending, and are spilled
# last under pool pressure.
SLO_TIERS = ("interactive", "standard", "batch")
_TIER_RANK = {t: i for i, t in enumerate(SLO_TIERS)}
_RANK_BATCH = _TIER_RANK["batch"]


class TierRegistry:
    """Tenant -> SLO tier, keyed on the normalized TLV-22 identity
    (``normalize_tenant``), bounded at the admission plane's tenant cap.
    Unregistered tenants get the default tier."""

    def __init__(self, default: str = "standard"):
        if default not in SLO_TIERS:
            raise ValueError(f"unknown SLO tier: {default}")
        self._default = default
        self._map: dict = {}
        self._slo: dict = {}       # tier -> (ttft_ms, itl_ms) targets
        self._lock = threading.Lock()

    def set_tier(self, tenant, tier: str) -> None:
        if tier not in SLO_TIERS:
            raise ValueError(f"unknown SLO tier: {tier}")
        key = normalize_tenant(tenant)
        with self._lock:
            if key not in self._map and len(self._map) >= _MAX_TENANTS:
                raise ValueError("tier registry full")
            self._map[key] = tier

    def tier_of(self, tenant) -> str:
        with self._lock:
            return self._map.get(normalize_tenant(tenant), self._default)

    def rank_of(self, tenant) -> int:
        return _TIER_RANK[self.tier_of(tenant)]

    def set_slo(self, tier: str, ttft_ms: Optional[float] = None,
                itl_ms: Optional[float] = None) -> None:
        """Per-tier latency targets the SLO verdicts
        (``lm_telemetry.LM_SLO_VERDICTS``) are judged against at session
        close; a tier with none judges ``slo_untargeted``."""
        if tier not in SLO_TIERS:
            raise ValueError(f"unknown SLO tier: {tier}")
        with self._lock:
            self._slo[tier] = (ttft_ms, itl_ms)

    def slo_of(self, tier: str) -> tuple:
        # lock-free: the batcher reads it inside its loop, and a dict.get
        # of an immutable tuple is atomic under the interpreter lock
        return self._slo.get(tier, (None, None))


# Closed enums: the scheduler's named decisions and the spec-decode round
# outcomes.
SLO_SCHED_EVENTS = (
    "sched_chunk_slice",        # one bounded prefill slice ran
    "sched_catchup_slice",      # slice replaying past a partial prefix hit
    "sched_interactive_first",  # interactive outranked lower tiers for budget
    "sched_preempt_batch",      # batch-tier victim spilled under pressure
)

SPEC_DECODE_EVENTS = (
    "spec_round",               # one draft+verify round ran
    "spec_accept",              # draft token confirmed by the target
    "spec_reject",              # draft token refuted by the target
    "spec_fallback_plain",      # round fell back to one plain step
)

_sched_lock = threading.Lock()
_sched = {r: 0 for r in SLO_SCHED_EVENTS}
_spec = {r: 0 for r in SPEC_DECODE_EVENTS}


def count_sched(event: str, n: int = 1) -> None:
    if event not in _sched:
        raise ValueError(f"unregistered scheduler event: {event}")
    with _sched_lock:
        _sched[event] += n


def count_spec(event: str, n: int = 1) -> None:
    if event not in _spec:
        raise ValueError(f"unregistered spec-decode event: {event}")
    with _sched_lock:
        _spec[event] += n


def sched_counters() -> dict:
    with _sched_lock:
        return dict(_sched)


def spec_counters() -> dict:
    with _sched_lock:
        return dict(_spec)


def _reset_sched_for_tests() -> None:
    with _sched_lock:
        for k in _sched:
            _sched[k] = 0
        for k in _spec:
            _spec[k] = 0


# the sched and spec counters as labeled bvar families, as the JAX
# service exposes them
_sched_var = PassiveDimension(("event",), lambda: sched_counters(),
                              name="lm_slo_sched_total")
_spec_var = PassiveDimension(("event",), lambda: spec_counters(),
                             name="lm_spec_decode_total")


class _Session:
    __slots__ = ("stream", "prompt", "max_new", "sent", "slot",
                 # an imported session (join_imported) has no prompt: its
                 # prefill ran on another tier, whose per-layer caches it
                 # carries in cache1 until the admit inserts them
                 "cache1", "ctx_len", "last_token",
                 # SLO scheduling: the resolved tier and rank, and the
                 # chunked-prefill watermark (context rows written; fill <
                 # ctx_len: the session holds its slot but is not decoding)
                 "tier", "tier_rank", "fill",
                 # paged mode: the pages the session holds (the first
                 # n_alias are prefix-cache aliases, the next n_priv its
                 # own), and its host-tier state while parked
                 "pages", "n_alias", "n_priv", "host_handles", "saved_len",
                 # observability: the session's timeline and its rpcz
                 # decode-session span
                 "tl", "span")

    def __init__(self, stream, prompt: Optional[np.ndarray], max_new: int):
        self.stream = stream
        self.prompt = prompt
        self.max_new = max_new
        self.sent = 0
        self.slot = -1
        self.cache1 = None
        self.ctx_len = 0
        self.last_token = 0
        self.tier = "standard"
        self.tier_rank = _TIER_RANK["standard"]
        self.fill = 0
        self.pages: list = []
        self.n_alias = 0
        self.n_priv = 0
        self.host_handles = None
        self.saved_len = 0
        self.tl = None
        self.span = None


def bucketed_prefill(prefill, cfg: LMConfig, prompt: np.ndarray):
    """Prefill of the prompt's context (all but the last token), padded
    with zeros to a power-of-two bucket: ``(cache1, ctx_len)``.  The
    prompt's last token then rides the first batch step (the step's
    logits at position s-1 equal the whole prefill's), which also
    overwrites the padded rows before the mask admits them."""
    ctx = prompt[:-1]
    bucket = 1
    while bucket < max(len(ctx), 1):
        bucket <<= 1
    bucket = min(bucket, cfg.max_seq)
    padded = np.zeros((bucket,), np.int32)
    padded[:len(ctx)] = ctx
    cache1, _logits = prefill(padded[None, :])
    return cache1, len(ctx)


def _contig_insert(cfg: LMConfig):
    """The slot insert of the contiguous pool: a batch-1 prefill's caches
    copied into one slot's stripes and its len set, in place (the JAX
    package donates the pool for the same effect)."""

    def _insert(cache, cache1, slot: int, ctx_len: int):
        for i in range(cfg.depth):
            cache[f"k{i}"][slot].copy_(cache1[f"k{i}"][0])
            cache[f"v{i}"][slot].copy_(cache1[f"v{i}"][0])
        cache["len"][slot] = ctx_len
        return cache

    return _insert


def _setlen(cache, slot: int, val: int):
    """One slot's ``len``, set in place."""
    cache["len"][slot] = val
    return cache


class ContinuousBatcher:
    """Continuous-batching decode engine: one decode-step loop over a
    fixed pool of session slots.  Per step every live session advances
    one token, and the tokens go back per session (an int32 chunk on each
    session's server stream); new sessions are admitted into free slots
    between steps (bucketed prefill at batch 1, caches copied into the
    slot, the first token emitted by the next step: that write is the
    time to first token); finished or broken sessions evict and free
    their slot, the stream closing with a named reason.

    The loop runs on one daemon thread, started at the first join and
    ended after ``idle_linger_s`` with nothing to serve.  The thread runs
    under ``torch.inference_mode()`` (grad mode is per thread).

    **Paged mode** (``paged=True``): one shared page pool per layer and a
    per-slot block table replace the contiguous stripes, so a session
    holds ``ceil((ctx + max_new) / page)`` pages instead of a ``max_seq``
    stripe, and the slot count no longer sets the KV bytes.  Besides:

    - a :class:`~brpc_tpu_torch.kv.pages.PrefixCache` lets a re-sent
      context alias pages already prefilled (refcounted, no bytes moved)
      and skip prefill for the covered prefix; a partial hit catches the
      rest up through chunk slices, so its tokens equal the uncached
      path's;
    - when the pool runs dry the batcher drops LRU prefix entries and
      spills a live session's private pages to the
      :class:`~brpc_tpu_torch.kv.pages.HostPagePool` (``host_slots``
      pages), parking it; a parked session resumes bit-exact when pages
      free up.  Beyond that the admitting stream closes under a named
      ``KV_EVICT_REASONS`` member.

    **SLO tiers.**  Sessions resolve their tier from the request's
    TLV-22 identity through a :class:`TierRegistry`; pending joins drain
    interactive first, and a spill victim is chosen tier-then-footprint
    (batch before standard before interactive, batch victims even before
    prefix-cache holds when the requester outranks them).  With
    ``prefill_chunk_tokens`` set (Sarathi-style chunked prefill), each
    round runs one decode step plus at most that many tokens of prefill
    slices, interactive sessions first, so a long prompt never holds back
    the live sessions' next token.  A filling session holds its slot but
    stays inactive until its context is written; its first token is then
    teacher-forced as after a whole-prompt prefill, so the stream is the
    same.

    **Speculative decoding** (``spec_decode_k``, paged mode only): a
    draft model (``draft_params``, the target's config) proposes k
    tokens per active slot in k contiguous steps, and the target verifies
    them in one width-(k+1) call; accepted prefixes advance ``len`` and a
    rejection is a ``len`` rewind, so the tokens equal plain decoding's.

    **Imported sessions** (:meth:`join_imported`): a session prefilled on
    another tier joins with that tier's cache and its last prompt token;
    the admit inserts the cache as a local prefill's (into the session's
    pages in paged mode, with no prefix lookup or insert), so its tokens
    equal the monolithic path's.  It has no prompt, so a spec round waits
    while one is active (the draft has no context to prefill).

    The KV pools are f32.  Emission (:meth:`_emit`) writes the streams
    adopted onto the native engine's kind-5 lane in one
    ``stream_write_many`` per engine, and the rest one ``Stream.write``
    at a time.
    ``PH_DECODE_ROUND`` times a whole round, the step and the read-back of
    its tokens (the JAX package's timer stops at dispatch)."""

    # credit wait bound for one token's write: a healthy client holds
    # megabytes of credit per 4-byte token, so a stream that cannot take
    # one within this is stalled, and it must not hold back the batch
    EMIT_TIMEOUT_MS = 200

    def __init__(self, cfg: LMConfig, params, slots: int = 8,
                 idle_linger_s: float = 5.0, paged: bool = False,
                 page: int = 16, pages: Optional[int] = None,
                 host_slots: int = 0, prefix: bool = True,
                 prefix_budget: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 spec_decode_k: int = 0, draft_params=None,
                 tiers: Optional[TierRegistry] = None, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.idle_linger_s = idle_linger_s
        # paged-KV knobs (inert unless paged)
        self.paged = bool(paged)
        self.page = int(page)
        self._pps = cfg.max_seq // self.page if self.paged else 0
        # +1: page 0 is the allocator's reserved garbage page
        self.num_pages = int(pages) if pages is not None \
            else self.slots * self._pps + 1
        self.host_slots = int(host_slots)
        self.prefix_enabled = bool(prefix)
        self.prefix_budget = prefix_budget
        # chunk_budget 0: fresh prompts prefill whole.  The contiguous
        # pool then builds no chunk program; the paged one builds one of
        # min(64, max_seq) all the same, because partial prefix hits
        # always catch up through chunk slices (with no budget bound)
        self.chunk_budget = int(prefill_chunk_tokens) \
            if prefill_chunk_tokens else 0
        self._chunk_w = min(self.chunk_budget, cfg.max_seq) \
            if self.chunk_budget else (min(64, cfg.max_seq)
                                       if self.paged else 0)
        self.spec_k = int(spec_decode_k)
        self.draft_params = draft_params
        if self.spec_k > 0 and not self.paged:
            raise ValueError("spec_decode_k requires paged=True "
                             "(rejection rollback is a block-table "
                             "len rewind)")
        if self.spec_k > 0 and draft_params is None:
            raise ValueError("spec_decode_k requires draft_params")
        self.tiers = tiers
        # the programs and the device KV pool are built on the batcher
        # thread's first iteration, not in a request handler
        self._prefill = None
        self._step = None
        self._chunk = None
        self._insert = _contig_insert(cfg)
        self._cache = None
        self._tokens = np.zeros((self.slots,), np.int32)
        self._active = np.zeros((self.slots,), bool)
        self._sessions = {}                       # slot -> _Session
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._thread = None
        self._stopping = False
        self._steps = 0                           # decode steps run
        # paged-mode engine state (built in _ensure_paged_engine); the
        # block table is host state, copied to the card at every call
        self._alloc = None                        # kv.pages.PageAllocator
        self._prefix = None                       # kv.pages.PrefixCache
        self._host = None                         # kv.pages.HostPagePool
        self._bt = np.zeros((self.slots, max(self._pps, 1)), np.int32)
        self._gather = None
        self._scatter = None
        self._page_insert = None
        # spec-decode engine state (built when spec_k > 0)
        self._d_prefill = None
        self._d_step = None
        self._d_cache = None
        self._verify = None
        self._parked: list = []                   # spilled sessions
        self.prefills_run = 0
        self.spills = 0
        self.resumes = 0

    # -- public -----------------------------------------------------------

    def join(self, stream, prompt: np.ndarray, max_new: int,
             tenant=None, span=None) -> None:
        """Queue a session; it enters the live batch between steps.
        ``tenant`` (the request's TLV-22 identity, bytes or str) resolves
        its SLO tier.  ``span`` (an rpcz Span, optional) is the session's
        decode-session span: the batcher annotates its step events on it
        and finishes it at evict."""
        sess = _Session(stream, np.ascontiguousarray(prompt, np.int32),
                        int(max_new))
        self._assign_tier(sess, tenant)
        sess.span = span
        sess.tl = _lmt.open_timeline(sess.tier, tenant, len(prompt),
                                     int(max_new), "fresh")
        if span is not None:
            span.annotate("lm_join")
        self._enqueue(sess)

    def join_imported(self, stream, last_token: int, ctx_len: int,
                      max_new: int, cache1, tenant=None,
                      span=None) -> None:
        """Queue a session whose prefill ran on another tier (the
        disaggregated handoff).  ``cache1`` is the per-layer batch-1 cache
        (``transformer_lm.decode_cache_from_pages``'s layout) holding
        ``ctx_len`` context rows; it is inserted between steps as a local
        prefill's would be, and ``last_token`` (the prompt's last) rides
        the next step, so the stream carries the monolithic path's
        tokens.  ``span`` as in :meth:`join`."""
        sess = _Session(stream, None, int(max_new))
        sess.cache1 = cache1
        sess.ctx_len = int(ctx_len)
        sess.last_token = int(last_token)
        self._assign_tier(sess, tenant)
        sess.span = span
        sess.tl = _lmt.open_timeline(sess.tier, tenant, int(ctx_len) + 1,
                                     int(max_new), "imported")
        if span is not None:
            span.annotate("lm_join")
        self._enqueue(sess)

    def _assign_tier(self, sess: _Session, tenant) -> None:
        if self.tiers is not None:
            sess.tier = self.tiers.tier_of(tenant)
            sess.tier_rank = _TIER_RANK[sess.tier]

    def _enqueue(self, sess: _Session) -> None:
        with self._lock:
            self._pending.append(sess)
            if self._thread is None:
                self._stopping = False
                self._thread = threading.Thread(
                    target=self._run, name="lm-decode-batcher", daemon=True)
                self._thread.start()
        self._wake.set()

    def live_slots(self) -> int:
        with self._lock:
            return len(self._sessions)

    def steps_run(self) -> int:
        return self._steps

    def kv_stats(self) -> dict:
        """The batcher's counters, and in paged mode the allocator's,
        the prefix cache's and the host tier's."""
        out = {"paged": self.paged, "steps": self._steps,
               "prefills_run": self.prefills_run,
               "spills": self.spills, "resumes": self.resumes,
               "parked": len(self._parked),
               "sched": sched_counters(), "spec": spec_counters(),
               "phases": _lmt.phase_counters()}
        for key, plane in (("alloc", self._alloc), ("prefix", self._prefix),
                           ("host", self._host)):
            if plane is not None:
                out[key] = plane.stats()
        return out

    def shutdown(self, timeout: float = 30.0) -> bool:
        """Let the live, parked and queued sessions finish, end the
        batcher thread, and drop the KV pool with the allocator, the
        prefix cache, the host tier and the draft's pool (a later join
        builds them again).  False when the thread did not end within
        ``timeout``."""
        with self._lock:
            self._stopping = True
            thread = self._thread
        self._wake.set()
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                return False
        self._drop_engine_state()
        return True

    def _drop_engine_state(self) -> None:
        self._cache = None
        self._d_cache = None
        self._bt[:] = 0
        self._alloc = None
        self._prefix = None
        self._host = None

    # -- internals (batcher thread only past the pending handoff) ---------

    def _ensure_engine(self) -> None:
        """Build the step programs and the device KV pool, on the batcher
        thread."""
        if self.paged:
            self._ensure_paged_engine()
            return
        if self._step is None:
            prefill, step, *chunk = make_batch_decode(
                self.cfg, chunk=self._chunk_w or None, device=self.device)
            self._prefill = functools.partial(prefill, self.params)
            self._step = functools.partial(step, self.params)
            if chunk:
                self._chunk = functools.partial(chunk[0], self.params)
        if self._cache is None:
            self._cache = empty_batch_cache(self.cfg, self.slots,
                                            self.device)

    def _ensure_paged_engine(self) -> None:
        """The paged engine: the shared page pools, the paged step, the
        page I/O and chunk programs, the allocator, prefix cache and host
        tier, and in spec mode the draft's contiguous engine and the
        verify program."""
        cfg, dev = self.cfg, self.device
        if self._step is None:
            prefill, step = make_paged_batch_decode(cfg, self.page, dev)
            self._prefill = functools.partial(prefill, self.params)
            self._step = functools.partial(step, self.params)
            self._gather, self._scatter, self._page_insert, chunk = \
                make_paged_io(cfg, self.page, chunk=self._chunk_w,
                              device=dev)
            self._chunk = functools.partial(chunk, self.params)
            if self.spec_k > 0:
                d_prefill, d_step = make_batch_decode(cfg, device=dev)
                self._d_prefill = functools.partial(d_prefill,
                                                    self.draft_params)
                self._d_step = functools.partial(d_step, self.draft_params)
                self._verify = functools.partial(
                    make_paged_spec_verify(cfg, self.page, self.spec_k + 1,
                                           dev), self.params)
        if self._cache is None:
            self._cache = empty_paged_cache(cfg, self.num_pages, self.slots,
                                            self.page, dev)
            self._bt[:] = 0
        if self.spec_k > 0 and self._d_cache is None:
            self._d_cache = empty_batch_cache(cfg, self.slots, dev)
        if self._alloc is None:
            pb = paged_page_bytes(cfg, self.page)
            self._alloc = PageAllocator(self.num_pages, self.page, pb)
            self._prefix = PrefixCache(
                self._alloc, budget_pages=self.prefix_budget) \
                if self.prefix_enabled else None
            if self.host_slots > 0:
                self._host = HostPagePool(self.host_slots, pb)

    def _pages_for(self, ctx_len: int, max_new: int) -> int:
        """Pages a session needs end to end: every position it will ever
        write, rounded up to whole pages."""
        return max(1, -(-(ctx_len + max_new) // self.page))

    def _bt_dev(self, slot: Optional[int] = None) -> torch.Tensor:
        """The block table (or one slot's row) on the card, copied at
        every call: the host changes it between rounds, so no copy is
        kept, and the copy is blocking, so the host may change it
        afterwards."""
        bt = self._bt if slot is None else self._bt[slot]
        return torch.from_numpy(bt).to(self.device)

    def _emit(self, pairs) -> list:
        """Write one round's tokens: native-lane streams in ONE coalesced
        engine call per engine (one writev per connection), Python-lane
        ones one ``Stream.write`` each.  Every credit wait is bounded by
        EMIT_TIMEOUT_MS: a stalled session costs the batch one short
        stall once and is then evicted.  A spec round hands a session
        several tokens; once one of them fails, the rest are skipped, so
        the stall is one wait, not k + 1.  Returns one ``(session,
        reason)`` pair per session to evict (stream gone, or out of
        credit: ``backpressure``)."""
        dead = []
        failed = set()
        by_engine = {}                 # id(engine) -> (engine, items)

        def evict(sess, reason) -> None:
            if id(sess) not in failed:
                failed.add(id(sess))
                dead.append((sess, reason))

        for sess, tok in pairs:
            if id(sess) in failed:
                continue
            s = sess.stream
            if s.closed:
                evict(sess, None)
                continue
            data = struct.pack("<i", tok)
            # a stream of the kind-5 lane names its engine; any other
            # stream (a stub with closed/options/write too) writes itself
            eng = getattr(s, "_native_tx", None)
            if eng is not None:
                # sessions may span servers (several engines): group per
                # engine — a stream id resolves only on its own
                by_engine.setdefault(id(eng), (eng, []))[1].append(
                    (sess, s.id, data))
                continue
            prev = s.options.write_timeout_s
            s.options.write_timeout_s = self.EMIT_TIMEOUT_MS / 1e3
            try:
                rc = s.write(data)
            finally:
                s.options.write_timeout_s = prev
            if rc != 0:
                evict(sess, "backpressure"
                      if rc == int(Errno.EOVERCROWDED) else None)
        for eng, items in by_engine.values():
            sts = eng.stream_write_many(
                [(sid, data) for _sess, sid, data in items],
                self.EMIT_TIMEOUT_MS)
            for (sess, _sid, _data), st in zip(items, sts):
                if st == -1:
                    evict(sess, "backpressure")
                elif st == -2:
                    evict(sess, None)
        return dead

    def _admit(self, sess: _Session) -> None:
        """Take a free slot.  Whole prompt: prefill the context padded to a
        power-of-two bucket, insert it, and let the prompt's last token
        ride the next step (teacher-forced: the step's logits at s-1 are
        the whole prefill's).  Chunked: take the slot now and let
        :meth:`_chunk_round` write the context under the budget.
        Imported: insert the carried cache instead of a prefill.  An
        imported session enters fully filled, so the fill paths
        (:meth:`_chunk_round`, :meth:`_activate`) never see it without a
        prompt."""
        if self.paged:
            self._admit_paged(sess)
            return
        free = next(i for i in range(self.slots) if i not in self._sessions)
        sess.slot = free
        sess.sent = 0
        self._sessions[free] = sess
        if sess.cache1 is None and self.chunk_budget \
                and len(sess.prompt) > 1:
            self._cache = _setlen(self._cache, free, 0)
            sess.ctx_len = len(sess.prompt) - 1
            sess.fill = 0
            return
        if sess.cache1 is not None:
            cache1, ctx_len, last = sess.cache1, sess.ctx_len, \
                sess.last_token
            sess.cache1 = None       # the pool owns the rows after insert
        else:
            cache1, ctx_len = bucketed_prefill(self._prefill, self.cfg,
                                               sess.prompt)
            self.prefills_run += 1
            last = int(sess.prompt[-1])
        self._cache = self._insert(self._cache, cache1, free, ctx_len)
        sess.ctx_len = sess.fill = ctx_len       # fully prefilled: active
        self._tokens[free] = last
        self._active[free] = True

    # -- paged mode: admit, spill, park, resume -----------------------------

    def _alloc_with_reclaim(self, need: int, rank: int = 1):
        """Allocate ``need`` pages, reclaiming in SLO order: when the
        requester outranks the batch tier, spill a batch-tier victim
        first; then drop LRU prefix-cache entries; then spill whatever
        the tier-then-footprint policy picks.  ``(pages, None)``, or
        ``(None, reason)`` with a KV_EVICT_REASONS member."""
        pages = self._alloc.alloc(need)
        while pages is None:
            if rank < _RANK_BATCH \
                    and self._spill_one(min_rank=_RANK_BATCH) is None:
                pages = self._alloc.alloc(need)
                continue
            if self._prefix is not None and self._prefix.evict_lru():
                pages = self._alloc.alloc(need)
                continue
            why = self._spill_one()
            if why is not None:
                return None, why
            pages = self._alloc.alloc(need)
        return pages, None

    def _admit_paged(self, sess: _Session) -> None:
        """Look the context up in the prefix cache, allocate the rest of
        the session's pages, and fill them: nothing on a full hit, a
        bucketed prefill inserted into the pages on a miss with no chunk
        budget, chunk slices otherwise (a fresh prompt under the budget,
        or a partial hit's catch-up from its page-aligned cover).  An
        imported session's carried cache is inserted into its pages; it
        has no tokens to look up, so it neither hits nor enters the
        prefix cache."""
        imported = sess.cache1 is not None
        aliased, covered = [], 0
        if imported:
            ctx_len = sess.ctx_len
        else:
            ctx = sess.prompt[:-1]
            ctx_len = len(ctx)
            if self._prefix is not None:
                t0 = _mono_ns()
                aliased, covered = self._prefix.lookup(ctx)
                _rec_phase(PH_PREFIX_LOOKUP, _mono_ns() - t0)
        n_total = self._pages_for(ctx_len, sess.max_new)
        t0 = _mono_ns()
        priv, why = self._alloc_with_reclaim(n_total - len(aliased),
                                             rank=sess.tier_rank)
        _rec_phase(PH_PAGE_ALLOC, _mono_ns() - t0)
        if priv is None:
            self._alloc.release_all(aliased)
            count_evict(why)
            if not sess.stream.closed:
                sess.stream.close(reason=why)
            self._finalize_obs(sess, why)
            return
        # free = unoccupied, not merely inactive: a filling session holds
        # its slot while _active is still False
        free = next(i for i in range(self.slots) if i not in self._sessions)
        n_alias = len(aliased)
        row = np.zeros((self._pps,), np.int32)
        row[:n_alias] = aliased
        row[n_alias:n_total] = priv
        filling = False
        if imported:
            self._cache = self._page_insert(self._cache,
                                            torch.from_numpy(row),
                                            sess.cache1)
            sess.cache1 = None
            start_len = ctx_len
        elif covered == ctx_len:
            # a full hit (or an empty context): the aliased pages are the
            # context's k/v, as a prefill would write them
            start_len = ctx_len
        elif covered == 0 and not self.chunk_budget:
            cache1, ctx_len = bucketed_prefill(self._prefill, self.cfg,
                                               sess.prompt)
            self.prefills_run += 1
            self._cache = self._page_insert(self._cache,
                                            torch.from_numpy(row), cache1)
            start_len = ctx_len
            if self._prefix is not None:
                # the context's full pages never change again (decode
                # writes land at pos >= ctx_len): cache them
                self._prefix.insert(ctx, priv)
        else:
            filling = True
            sess.fill = covered
            start_len = covered
        self._cache = _setlen(self._cache, free, start_len)
        sess.pages = list(aliased) + list(priv)
        sess.n_alias = n_alias
        sess.n_priv = len(priv)
        sess.ctx_len = ctx_len
        tl = sess.tl
        if tl is not None:
            if not imported:
                tl.prefix = "prefix_hit" if n_alias and covered == ctx_len \
                    else "prefix_partial" if covered > 0 else "prefix_miss"
            tl.pages_peak = max(tl.pages_peak, len(sess.pages))
        self._bt[free] = row
        sess.slot = free
        sess.sent = 0
        self._sessions[free] = sess
        if filling:
            return
        sess.fill = ctx_len
        self._tokens[free] = sess.last_token if imported \
            else int(sess.prompt[-1])
        self._active[free] = True
        if self.spec_k > 0:
            self._draft_admit(sess)

    def _spill_one(self, min_rank: int = 0) -> Optional[str]:
        """Park one live session's private pages in the host tier.  The
        victim is the worst SLO rank (an interactive session is never
        parked while a batch-tier one exists), then the most private
        pages, then the highest slot; ``min_rank`` restricts it to ranks
        >= that.  None on success, else the KV_EVICT_REASONS member
        naming why nothing could spill."""
        if self._host is None:
            return "kv_pool_exhausted"
        ab = self._host.abort_reason()
        if ab is not None:
            return ab
        victims = [s for s in self._sessions.values()
                   if s.n_priv > 0 and s.tier_rank >= min_rank]
        if not victims:
            return "kv_pool_exhausted"
        victim = max(victims,
                     key=lambda s: (s.tier_rank, s.n_priv, -s.slot))
        if victim.tier_rank >= _RANK_BATCH:
            count_sched("sched_preempt_batch")
            if victim.tl is not None:
                victim.tl.preempts += 1
        return self._park(victim)

    def _park(self, sess: _Session) -> Optional[str]:
        """Move a live session's private pages card -> host (one copy per
        page into its host slot) and free its slot.  Everything the step
        depends on (the pages' bytes, len, the last fed token, the fill
        watermark) survives in the session and the host tier, so it
        resumes bit-exact."""
        t0 = _mono_ns()
        if not self._host.begin_spill():
            return self._host.abort_reason() or "kv_host_tier_full"
        handles = []
        try:
            priv = sess.pages[sess.n_alias:]
            blk = self._gather(self._cache, torch.tensor(priv))
            for j in range(len(priv)):
                h = self._host.stage(blk[j])
                if h is None:
                    for hh in handles:
                        self._host.free(hh)
                    return "kv_host_tier_full"
                handles.append(h)
        finally:
            self._host.end_spill()
        sess.host_handles = handles
        sess.saved_len = int(self._cache["len"][sess.slot])
        sess.last_token = int(self._tokens[sess.slot])
        self._alloc.release_all(sess.pages[sess.n_alias:])
        sess.pages = sess.pages[:sess.n_alias]   # the alias holds remain
        self._sessions.pop(sess.slot, None)
        self._active[sess.slot] = False
        self._bt[sess.slot] = 0
        sess.slot = -1
        self._parked.append(sess)
        self.spills += 1
        fleet.record_event("fleet_host_spill",
                           f"tier={getattr(sess, 'tier', '?')}")
        if sess.tl is not None:
            sess.tl.spills += 1
        if sess.span is not None:
            sess.span.annotate("lm_spill")
        _rec_phase(PH_HOST_SPILL, _mono_ns() - t0)
        return None

    def _resume(self, sess: _Session) -> bool:
        """Un-park: allocate private pages again, land the host bytes in
        them (one copy per page to the card, one scatter), rebuild the
        block-table row, restore len and the last fed token.  False: stay
        parked (no slot or no pages yet)."""
        free = next((i for i in range(self.slots)
                     if i not in self._sessions), None)
        if free is None:
            return False
        t0 = _mono_ns()
        priv = self._alloc.alloc(sess.n_priv)
        while priv is None:
            # prefix-cache holds are reclaimable: a parked session must
            # not starve behind redundant cached pages
            if self._prefix is not None and self._prefix.evict_lru():
                priv = self._alloc.alloc(sess.n_priv)
                continue
            return False
        hd = self.cfg.dim // self.cfg.heads
        blk = torch.empty((sess.n_priv, 2 * self.cfg.depth, self.page,
                           self.cfg.heads, hd), dtype=torch.float32,
                          device=self.device)
        for j, h in enumerate(sess.host_handles):
            blk[j].view(-1).view(torch.uint8).copy_(self._host.fetch(h))
            self._host.free(h)
        sess.host_handles = None
        self._cache = self._scatter(self._cache, torch.tensor(priv), blk)
        self._cache = _setlen(self._cache, free, sess.saved_len)
        n_alias = sess.n_alias
        row = np.zeros((self._pps,), np.int32)
        row[:n_alias] = sess.pages
        row[n_alias:n_alias + sess.n_priv] = priv
        sess.pages = list(sess.pages) + list(priv)
        self._bt[free] = row
        self._tokens[free] = sess.last_token
        # a session parked mid-fill resumes inactive and the chunk rounds
        # finish its context; an active one rejoins the decode batch
        self._active[free] = sess.fill >= sess.ctx_len
        sess.slot = free
        self._sessions[free] = sess
        if self._active[free] and self.spec_k > 0 \
                and sess.prompt is not None:
            # the draft's context again; its rows of tokens generated
            # before the spill are not replayed, so acceptance dips until
            # it re-anchors (the verify keeps the tokens right)
            self._draft_admit(sess)
            self._d_cache = _setlen(self._d_cache, free, sess.saved_len)
        self.resumes += 1
        tl = sess.tl
        if tl is not None:
            tl.resumes += 1
            tl.pages_peak = max(tl.pages_peak, len(sess.pages))
        if sess.span is not None:
            sess.span.annotate("lm_resume")
        _rec_phase(PH_HOST_RESUME, _mono_ns() - t0)
        return True

    def _drop_parked(self, sess: _Session, reason: Optional[str]) -> None:
        """A parked session that will never resume (stream gone, or the
        host tier aborted): free its host slots and alias holds, close
        under the named reason."""
        for h in (sess.host_handles or []):
            self._host.free(h)
        sess.host_handles = None
        self._alloc.release_all(sess.pages)
        sess.pages = []
        if reason is not None:
            count_evict(reason)
        if not sess.stream.closed:
            sess.stream.close(reason=reason or "finished")
        self._finalize_obs(sess, reason or "finished")

    def _service_parked(self) -> None:
        """Between rounds: resume what fits (interactive first, in spill
        order within a tier), drop the dead, and after a host-tier abort
        close everything still parked under its reason."""
        if not self._parked:
            return
        ab = self._host.abort_reason() if self._host is not None else None
        still = []
        self._parked.sort(key=lambda s: s.tier_rank)
        for sess in self._parked:
            if sess.stream.closed:
                self._drop_parked(sess, None)
            elif ab is not None:
                self._drop_parked(sess, ab)
            elif not self._resume(sess):
                still.append(sess)
        self._parked = still

    # -- rounds: chunk slices, plain steps, spec rounds ----------------------

    def _draft_admit(self, sess: _Session) -> None:
        """Spec mode: the draft model's bucketed prefill of the context,
        inserted into its contiguous pool at the session's slot, so the
        draft's rows stay position-aligned with the target's.  An imported
        session has no prompt to draft from (and :meth:`_spec_ok` holds
        spec rounds while it is live)."""
        if self._d_cache is None or sess.prompt is None:
            return
        cache1, ctx_len = bucketed_prefill(self._d_prefill, self.cfg,
                                           sess.prompt)
        self._d_cache = self._insert(self._d_cache, cache1, sess.slot,
                                     ctx_len)

    def _activate(self, sess: _Session) -> None:
        """A fully chunk-filled session goes live: the prompt's last token
        rides the next step, as after a whole-prompt prefill.  A fresh
        chunked context counts as one prefill and enters the prefix cache
        as a prefilled one does; a partial hit's catch-up does not."""
        slot = sess.slot
        sess.fill = sess.ctx_len
        self._tokens[slot] = int(sess.prompt[-1])
        self._active[slot] = True
        if sess.n_alias == 0 and sess.ctx_len > 0:
            self.prefills_run += 1
            if self.paged and self._prefix is not None:
                self._prefix.insert(sess.prompt[:-1], sess.pages)
        if self.spec_k > 0:
            self._draft_admit(sess)

    def _chunk_round(self) -> None:
        """Spend this round's chunk budget (unbounded when no budget is
        set: a paged partial hit's catch-up) on bounded prefill slices
        over the filling sessions, interactive tier first.  A filling
        slot's rows past ``fill`` are garbage, but the mask admits a row
        only once ``len`` passes it, and a slice has rewritten it by
        then."""
        filling = [s for s in self._sessions.values()
                   if s.fill < s.ctx_len]
        if not filling:
            return
        filling.sort(key=lambda s: (s.tier_rank, s.slot))
        if filling[0].tier_rank == _TIER_RANK["interactive"] \
                and any(s.tier_rank > filling[0].tier_rank
                        for s in filling):
            count_sched("sched_interactive_first")
        budget = self.chunk_budget if self.chunk_budget else 1 << 30
        for sess in filling:
            if budget <= 0:
                break
            if sess.stream.closed:
                self._evict(sess, None)
                continue
            catchup = sess.n_alias > 0
            while budget > 0 and sess.fill < sess.ctx_len:
                t0 = _mono_ns()
                n = int(min(self._chunk_w, sess.ctx_len - sess.fill, budget))
                ids = np.zeros((self._chunk_w,), np.int32)
                ids[:n] = sess.prompt[sess.fill:sess.fill + n]
                if self.paged:
                    self._cache = self._chunk(
                        self._cache, self._bt_dev(sess.slot), sess.slot,
                        sess.fill, n, ids)
                else:
                    self._cache = self._chunk(self._cache, sess.slot,
                                              sess.fill, n, ids)
                sess.fill += n
                budget -= n
                count_sched("sched_catchup_slice" if catchup
                            else "sched_chunk_slice")
                _rec_phase(PH_CATCHUP_SLICE if catchup else PH_CHUNK_SLICE,
                           _mono_ns() - t0)
                if sess.span is not None:
                    sess.span.annotate("lm_chunk_slice")
            if sess.fill >= sess.ctx_len:
                self._activate(sess)

    def _spec_ok(self) -> bool:
        """A spec round needs k + 1 rows of headroom in every active slot,
        and a prompt to draft from (an imported session has none);
        otherwise the round falls back to one plain step."""
        for slot, sess in self._sessions.items():
            if not self._active[slot]:
                continue
            if sess.prompt is None:
                return False
            if sess.ctx_len + sess.sent + self.spec_k + 1 \
                    > self.cfg.max_seq:
                return False
        return True

    def _plain_round(self):
        """One decode step over the active slots: ``(pairs, finished)``
        for the emit/evict epilogue."""
        t0 = _mono_ns()
        tokens = torch.from_numpy(self._tokens).to(self.device)
        active = torch.from_numpy(self._active).to(self.device)
        if self.paged:
            self._cache, logits = self._step(self._cache, self._bt_dev(),
                                             tokens, active)
        else:
            self._cache, logits = self._step(self._cache, tokens, active)
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        self._steps += 1
        _rec_phase(PH_DECODE_ROUND, _mono_ns() - t0)
        pairs, finished = [], []
        for slot, sess in list(self._sessions.items()):
            if not self._active[slot]:
                continue
            tok = int(toks[slot])
            self._tokens[slot] = tok
            sess.sent += 1
            pairs.append((sess, tok))
            if sess.sent >= sess.max_new:
                finished.append(sess)
        return pairs, finished

    def _spec_round(self):
        """One speculative round: k draft steps (each proposal read back),
        one width-(k+1) verify, then the accepted prefix plus the
        target's own next token emitted per session.  An accepted row
        holds the k/v a plain step would have written, and a rejection
        rewinds ``len`` (the refuted rows sit beyond the mask until a
        later write replaces them), so the tokens equal plain decoding's.
        The draft's ``len`` is rewound in place to the accepted rows."""
        k = self.spec_k
        count_spec("spec_round")
        t_round = _mono_ns()
        active = self._active.copy()
        act_t = torch.from_numpy(active).to(self.device)
        cur = self._tokens.copy()
        drafts = []
        for _ in range(k):
            self._d_cache, dl = self._d_step(
                self._d_cache, torch.from_numpy(cur).to(self.device), act_t)
            cur = torch.argmax(dl, dim=-1).to(torch.int32).cpu().numpy()
            drafts.append(cur)
        t_verify = _mono_ns()
        _rec_phase(PH_SPEC_DRAFT, t_verify - t_round)
        u = np.stack([self._tokens] + drafts, axis=1).astype(np.int32)
        self._cache, out, m = self._verify(
            self._cache, self._bt_dev(), torch.from_numpy(u).to(self.device),
            act_t)
        # after k draft steps the draft's len is L + k; keep L..L+m
        self._d_cache["len"].sub_(torch.where(act_t, k - 1 - m, 0).to(
            self._d_cache["len"].dtype))
        out = out.cpu().numpy()
        m = m.cpu().numpy()
        now = _mono_ns()
        _rec_phase(PH_SPEC_VERIFY, now - t_verify)
        self._steps += 1
        _rec_phase(PH_DECODE_ROUND, now - t_round)
        pairs, finished = [], []
        for slot, sess in list(self._sessions.items()):
            if not active[slot]:
                continue
            acc = int(m[slot])
            count_spec("spec_accept", acc)
            count_spec("spec_reject", k - 1 - acc)
            for j in range(min(acc + 1, sess.max_new - sess.sent)):
                tok = int(out[slot, j])
                self._tokens[slot] = tok
                sess.sent += 1
                pairs.append((sess, tok))
            if sess.sent >= sess.max_new:
                finished.append(sess)
        return pairs, finished

    def _finalize_obs(self, sess: _Session, reason: str) -> None:
        """Session close: judge and count the SLO verdict, move the
        timeline into the ring, and close out the decode-session span."""
        tl = sess.tl
        if tl is not None:
            sess.tl = None
            ttft_t, itl_t = self.tiers.slo_of(sess.tier) \
                if self.tiers is not None else (None, None)
            _lmt.close_timeline(tl, reason, ttft_t, itl_t)
        sp = sess.span
        if sp is not None:
            sess.span = None
            sp.annotate("lm_evict:" + reason)
            sp.finish(0)

    def _evict(self, sess: _Session, reason: Optional[str]) -> None:
        self._sessions.pop(sess.slot, None)
        self._active[sess.slot] = False
        if self.paged and sess.pages:
            self._alloc.release_all(sess.pages)
            sess.pages = []
            self._bt[sess.slot] = 0
        if not sess.stream.closed:
            sess.stream.close(reason=reason or "finished")
        self._finalize_obs(sess, reason or "finished")

    def _next_admits(self):
        """Under the lock: the joins to admit this round (interactive
        first, FIFO within a tier)."""
        if len(self._pending) > 1:
            self._pending = deque(sorted(self._pending,
                                         key=lambda s: s.tier_rank))
        admits = []
        while self._pending and \
                len(self._sessions) + len(admits) < self.slots:
            admits.append(self._pending.popleft())
        return admits

    def _run(self) -> None:
        try:
            with torch.inference_mode():
                self._ensure_engine()
                self._loop()
        except Exception:
            LOG.exception("continuous batcher crashed; closing sessions")
            with self._lock:
                sessions = list(self._sessions.values()) \
                    + list(self._pending) + list(self._parked)
                self._sessions.clear()
                self._pending.clear()
                self._parked = []
                # free every slot, and drop the pools a failed step may
                # have left half written, with the allocator planes whose
                # refcounts describe them; the next join rebuilds them.
                # The state is reset before anything that can fail again
                self._active[:] = False
                self._tokens[:] = 0
                self._drop_engine_state()
                self._thread = None
            for sess in sessions:
                try:
                    sess.stream.close(reason="decode_error")
                except Exception:
                    LOG.exception("closing a session's stream failed")
                self._finalize_obs(sess, "decode_error")

    def _loop(self) -> None:
        while True:
            if self.paged:
                # parked sessions rejoin before new admits (they were
                # serving first), and an aborted host tier closes them
                self._service_parked()
            with self._lock:
                admits = self._next_admits()
                # parked sessions keep the batcher busy: they resume once
                # another session releases pages
                idle = not self._sessions and not admits \
                    and not self._pending and not self._parked
                if idle and self._stopping:
                    self._thread = None
                    return
            if idle:
                self._wake.clear()
                # a join between the idle check and the clear set the
                # event just cleared: look again before sleeping
                with self._lock:
                    if self._pending or self._stopping:
                        continue
                if not self._wake.wait(self.idle_linger_s):
                    with self._lock:
                        if not self._pending and not self._sessions \
                                and not self._parked:
                            self._thread = None
                            return
                continue
            for sess in admits:
                self._admit(sess)
            # the chunk slices before the step: a fill completed now
            # teacher-forces its first token on this round's step
            self._chunk_round()
            if not self._sessions:
                if self._parked:
                    # only parked sessions, none of which could resume:
                    # a timed poll, never a busy spin
                    time.sleep(0.005)
                continue
            if not self._active.any():
                continue            # every occupied slot still filling
            if self.spec_k > 0 and self._spec_ok():
                pairs, finished = self._spec_round()
            else:
                if self.spec_k > 0:
                    count_spec("spec_fallback_plain")
                pairs, finished = self._plain_round()
            t0 = _mono_ns()
            dead = self._emit(pairs)
            _rec_phase(PH_STREAM_EMIT, _mono_ns() - t0)
            _lmt.on_emit(pairs)
            for sess, reason in dead:
                self._evict(sess, reason)
            for sess in finished:
                if self._sessions.get(sess.slot) is sess:
                    self._evict(sess, "finished")


class LMService(Service):
    """``Generate`` — greedy completion; ``Decode`` — streamed completion
    through the continuous batcher (one token chunk per step per
    session); ``Info`` — model config JSON.

    ``params`` default to :func:`init_params` drawn from a generator
    seeded with ``seed`` on ``device``.  ``Generate`` requests run on the
    device one at a time; the batcher (``decode_slots`` sessions; paged
    with ``paged``, ``page``, ``kv_pages``, ``kv_host_slots`` and
    ``prefix``; ``prefill_chunk_tokens``; ``spec_decode_k`` with
    ``draft_params``; ``tiers``) is built on ``device`` at the first
    ``Decode``."""

    def __init__(self, cfg: Optional[LMConfig] = None, params=None,
                 max_new_cap: int = 128, quantize: bool = False,
                 device="cuda", seed: int = 0, decode_slots: int = 8,
                 paged: bool = False, page: int = 16,
                 kv_pages: Optional[int] = None, kv_host_slots: int = 0,
                 prefix: bool = True,
                 prefill_chunk_tokens: Optional[int] = None,
                 spec_decode_k: int = 0, draft_params=None,
                 tiers: Optional[TierRegistry] = None):
        self.device = resolve_device(device)
        self.cfg = cfg or LMConfig(vocab=256, dim=64, heads=4, depth=2,
                                   max_seq=128, remat=False)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, self.cfg, self.device)
        self.params = quantize_lm_params(params) if quantize else params
        self.quantized = quantize
        self.max_new_cap = max_new_cap
        self._param_bytes = quantized_nbytes(self.params)
        self._gen = make_scan_generator(self.cfg, self.params, self.device)
        self._device_lock = threading.Lock()
        self.decode_slots = int(decode_slots)
        self.paged = bool(paged)
        self.page = int(page)
        self.kv_pages = kv_pages
        self.kv_host_slots = int(kv_host_slots)
        self.prefix = bool(prefix)
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.spec_decode_k = int(spec_decode_k)
        self.draft_params = draft_params
        self.tiers = tiers
        self._batcher: Optional[ContinuousBatcher] = None
        self._batcher_lock = threading.Lock()

    def batcher(self) -> ContinuousBatcher:
        with self._batcher_lock:
            if self._batcher is None:
                self._batcher = ContinuousBatcher(
                    self.cfg, self.params, slots=self.decode_slots,
                    paged=self.paged, page=self.page, pages=self.kv_pages,
                    host_slots=self.kv_host_slots, prefix=self.prefix,
                    prefill_chunk_tokens=self.prefill_chunk_tokens,
                    spec_decode_k=self.spec_decode_k,
                    draft_params=self.draft_params, tiers=self.tiers,
                    device=self.device)
            return self._batcher

    @staticmethod
    def _parse_request(cntl, request, what: str):
        """``(prompt[b, s], max_new)`` of a Generate/Decode request, or
        None with the controller failed."""
        try:
            b, s, max_new = struct.unpack_from("<III", request)
            prompt = np.frombuffer(request, dtype=np.int32,
                                   offset=12).reshape(b, s)
        except (struct.error, ValueError) as e:
            cntl.set_failed(Errno.EREQUEST, f"bad {what} request: {e}")
            return None
        return prompt, max_new

    def _limits_error(self, prompt: np.ndarray, max_new: int):
        """The checks Generate and Decode share, in the JAX service's
        order: the error text, or None."""
        s = prompt.shape[1]
        if max_new <= 0 or max_new > self.max_new_cap:
            return f"max_new must be in [1, {self.max_new_cap}]"
        if s + max_new > self.cfg.max_seq:
            return (f"prompt {s} + max_new {max_new} exceeds max_seq "
                    f"{self.cfg.max_seq}")
        if (prompt < 0).any() or (prompt >= self.cfg.vocab).any():
            return "prompt ids out of vocab"
        return None

    def model_fingerprint(self) -> bytes:
        """What the disaggregated handoff's two tiers must agree on before
        pages move: the architecture and the weight image's size (the JAX
        package's string, byte for byte).  ``param_bytes`` stands in for
        a weight hash, so same-shape tiers with different weights match;
        a deployment versions its weights itself."""
        c = self.cfg
        return (f"{c.vocab}:{c.dim}:{c.heads}:{c.depth}:{c.max_seq}:"
                f"{self._param_bytes}:{int(self.quantized)}").encode()

    def Generate(self, cntl, request):
        parsed = self._parse_request(cntl, request, "generate")
        if parsed is None:
            return None
        prompt, max_new = parsed
        b, s = prompt.shape
        err = "empty prompt" if b == 0 or s == 0 \
            else self._limits_error(prompt, max_new)
        if err:
            cntl.set_failed(Errno.EREQUEST, err)
            return None
        # the JAX service buckets max_new to share compiled programs; the
        # port keeps the same step count so both emit the same tokens
        bucket = 1
        while bucket < max_new:
            bucket <<= 1
        bucket = min(bucket, self.max_new_cap, self.cfg.max_seq - s)
        ids = torch.from_numpy(prompt.astype(np.int64)).to(self.device)
        with self._device_lock, _short_switch_interval():
            toks = self._gen(ids, int(bucket))
        out = np.ascontiguousarray(toks.cpu().numpy()[:, :max_new],
                                   dtype=np.int32)
        return struct.pack("<II", *out.shape) + out.tobytes()

    def _check_decode_request(self, cntl, request):
        """``Decode``'s validation and stream accept: ``(prompt[1, s],
        max_new, stream)``, or None with the controller failed."""
        from ..streaming import StreamOptions, stream_accept

        parsed = self._parse_request(cntl, request, "decode")
        if parsed is None:
            return None
        prompt, max_new = parsed
        b, s = prompt.shape
        err = "Decode streams one session per call" if b != 1 or s == 0 \
            else self._limits_error(prompt, max_new)
        if not err and self.cfg.scan_layers:
            err = "Decode serves unrolled configs only"
        if err:
            cntl.set_failed(Errno.EREQUEST, err)
            return None
        stream = stream_accept(cntl, StreamOptions())
        if stream is None:
            cntl.set_failed(Errno.EREQUEST,
                            "Decode requires a client stream "
                            "(stream_create before the call)")
            return None
        return prompt, int(max_new), stream

    def Decode(self, cntl, request):
        """Server-streaming decode: ``Generate``'s request at batch 1, with
        a stream attached (``stream_create`` before the call).  Tokens
        arrive as int32 chunks, one per decode step, while the session
        rides the continuous batch; the stream closes with reason
        ``finished``.  Answers ``<u32 max_new>``, the token count the
        stream will carry."""
        parsed = self._check_decode_request(cntl, request)
        if parsed is None:
            return None
        prompt, max_new, stream = parsed
        # the request's TLV-22 identity picks the session's SLO tier
        self.batcher().join(stream, prompt[0].copy(), max_new,
                            tenant=cntl.request_meta.tenant,
                            span=self._session_span(cntl))
        return struct.pack("<I", max_new)

    @staticmethod
    def _session_span(cntl):
        """The decode-session rpcz span: when the Decode call has a server
        span (forced by a propagated trace id, or passively sampled), the
        session, which outlives the call, gets a forced child span under
        the same trace id, so the batcher's step events (join, chunk
        slices, first token, evict) land in the request's trace; across a
        disaggregated handoff too, since the handoff's controller carries
        the trace on its ordinary TLVs."""
        req_span = cntl.span
        if req_span is None:
            return None
        span = Span("LMService.DecodeSession", trace_id=req_span.trace_id,
                    parent_span_id=req_span.span_id)
        span.remote_side = req_span.remote_side
        return span

    def Info(self, cntl, request):
        c = self.cfg
        return json.dumps({"vocab": c.vocab, "dim": c.dim,
                           "heads": c.heads, "depth": c.depth,
                           "max_seq": c.max_seq,
                           "quantized": self.quantized,
                           "param_bytes": self._param_bytes,
                           }).encode()
