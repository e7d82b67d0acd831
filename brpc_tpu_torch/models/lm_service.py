"""LM serving over the port's RPC: ``Generate``, ``Decode`` and ``Info``.

Counterpart of ``brpc_tpu/models/lm_service.py`` with the same wire
format: request = ``<u32 batch><u32 prompt_len><u32 max_new>`` + int32
prompt ids; ``Generate``'s response = ``<u32 batch><u32 max_new>`` +
int32 generated ids; ``Decode`` streams one int32 token per step on the
caller's stream and answers ``<u32 max_new>``.  Validation, errors
(``EREQUEST``), the power-of-two bucketing of ``max_new`` and of
``Decode``'s prefill follow the JAX service, so a client of either sees
the same answers.

``Decode`` rides :class:`ContinuousBatcher` in contiguous mode, with
chunked prefill and SLO tiers (:class:`TierRegistry`).  Paged KV and
speculative decoding (ROADMAP Queue A2) and the disaggregated handoff
(Queue A3) are not ported yet.
"""

from __future__ import annotations

import functools
import json
import logging
import struct
import threading
from collections import deque
from time import monotonic_ns as _mono_ns
from typing import Optional

import numpy as np
import torch

from ..butil.status import Errno
from ..ops.quant import quantize_lm_params, quantized_nbytes
from ..server.admission import _MAX_TENANTS, normalize_tenant
from ..server.service import Service
from ..utils.device import resolve_device
from . import lm_telemetry as _lmt
from .lm_telemetry import (PH_CHUNK_SLICE, PH_DECODE_ROUND, PH_STREAM_EMIT)
from .lm_telemetry import record_phase as _rec_phase
from .transformer_lm import (LMConfig, empty_batch_cache, init_params,
                             make_batch_decode, make_scan_generator)

LOG = logging.getLogger(__name__)


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
# ranks win the chunk budget and drain first from pending.
SLO_TIERS = ("interactive", "standard", "batch")
_TIER_RANK = {t: i for i, t in enumerate(SLO_TIERS)}


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


# Closed enum: the scheduler's named decisions (only sched_chunk_slice and
# sched_interactive_first are counted until the paged mode is ported).
SLO_SCHED_EVENTS = (
    "sched_chunk_slice",        # one bounded prefill slice ran
    "sched_catchup_slice",      # slice replaying past a partial prefix hit
    "sched_interactive_first",  # interactive outranked lower tiers for budget
    "sched_preempt_batch",      # batch-tier victim spilled under pressure
)

_sched_lock = threading.Lock()
_sched = {r: 0 for r in SLO_SCHED_EVENTS}


def count_sched(event: str, n: int = 1) -> None:
    if event not in _sched:
        raise ValueError(f"unregistered scheduler event: {event}")
    with _sched_lock:
        _sched[event] += n


def sched_counters() -> dict:
    with _sched_lock:
        return dict(_sched)


class _Session:
    __slots__ = ("stream", "prompt", "max_new", "sent", "slot", "ctx_len",
                 # SLO scheduling: the resolved tier and rank, and the
                 # chunked-prefill watermark (context rows written; fill <
                 # ctx_len: the session holds its slot but is not decoding)
                 "tier", "tier_rank", "fill",
                 # observability: the session's timeline
                 "tl")

    def __init__(self, stream, prompt: np.ndarray, max_new: int):
        self.stream = stream
        self.prompt = prompt
        self.max_new = max_new
        self.sent = 0
        self.slot = -1
        self.ctx_len = 0
        self.tier = "standard"
        self.tier_rank = _TIER_RANK["standard"]
        self.fill = 0
        self.tl = None


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

    **SLO tiers.**  Sessions resolve their tier from the request's
    TLV-22 identity through a :class:`TierRegistry`; pending joins drain
    interactive first.  With ``prefill_chunk_tokens`` set (Sarathi-style
    chunked prefill), each round runs one decode step plus at most that
    many tokens of prefill slices, interactive sessions first, so a long
    prompt never holds back the live sessions' next token.  A filling
    session holds its slot but stays inactive until its context is
    written; its first token is then teacher-forced as after a
    whole-prompt prefill, so the stream is the same.

    The KV pool is contiguous: ``slots`` stripes of ``max_seq`` rows per
    layer, in f32 (paged KV and speculative decoding: ROADMAP Queue A2;
    sessions imported from a prefill tier: Queue A3).  Emission writes
    each token on the stream's Python lane (the JAX package's native lane
    is not ported).
    ``PH_DECODE_ROUND`` times a whole round, the step and the read-back of
    its tokens (the JAX package's timer stops at dispatch)."""

    # credit wait bound for one token's write: a healthy client holds
    # megabytes of credit per 4-byte token, so a stream that cannot take
    # one within this is stalled, and it must not hold back the batch
    EMIT_TIMEOUT_MS = 200

    def __init__(self, cfg: LMConfig, params, slots: int = 8,
                 idle_linger_s: float = 5.0,
                 prefill_chunk_tokens: Optional[int] = None,
                 tiers: Optional[TierRegistry] = None, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.idle_linger_s = idle_linger_s
        # chunk_budget 0: whole bucketed prefills, no chunk program
        self.chunk_budget = int(prefill_chunk_tokens) \
            if prefill_chunk_tokens else 0
        self._chunk_w = min(self.chunk_budget, cfg.max_seq)
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
        self.prefills_run = 0

    # -- public -----------------------------------------------------------

    def join(self, stream, prompt: np.ndarray, max_new: int,
             tenant=None) -> None:
        """Queue a session; it enters the live batch between steps.
        ``tenant`` (the request's TLV-22 identity, bytes or str) resolves
        its SLO tier."""
        sess = _Session(stream, np.ascontiguousarray(prompt, np.int32),
                        int(max_new))
        self._assign_tier(sess, tenant)
        sess.tl = _lmt.open_timeline(sess.tier, tenant, len(prompt),
                                     int(max_new))
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
        return {"paged": False, "steps": self._steps,
                "prefills_run": self.prefills_run,
                "sched": sched_counters(),
                "phases": _lmt.phase_counters()}

    def shutdown(self, timeout: float = 30.0) -> bool:
        """Let the live and queued sessions finish, end the batcher
        thread, and drop the KV pool (a later join builds it again).
        False when the thread did not end within ``timeout``."""
        with self._lock:
            self._stopping = True
            thread = self._thread
        self._wake.set()
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                return False
        self._cache = None
        return True

    # -- internals (batcher thread only past the pending handoff) ---------

    def _ensure_engine(self) -> None:
        """Build the step programs and the device KV pool, on the batcher
        thread."""
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

    def _emit(self, pairs) -> list:
        """Write one step's tokens, each credit wait bounded by
        EMIT_TIMEOUT_MS: a stalled session costs the batch one short stall
        once and is then evicted.  Returns ``(session, reason)`` pairs to
        evict (stream gone, or out of credit: ``backpressure``)."""
        dead = []
        for sess, tok in pairs:
            s = sess.stream
            if s.closed:
                dead.append((sess, None))
                continue
            prev = s.options.write_timeout_s
            s.options.write_timeout_s = self.EMIT_TIMEOUT_MS / 1e3
            try:
                rc = s.write(struct.pack("<i", tok))
            finally:
                s.options.write_timeout_s = prev
            if rc != 0:
                dead.append((sess, "backpressure"
                             if rc == int(Errno.EOVERCROWDED) else None))
        return dead

    def _admit(self, sess: _Session) -> None:
        """Take a free slot.  Whole prompt: prefill the context padded to a
        power-of-two bucket, insert it, and let the prompt's last token
        ride the next step (teacher-forced: the step's logits at s-1 are
        the whole prefill's).  Chunked: take the slot now and let
        :meth:`_chunk_round` write the context under the budget."""
        free = next(i for i in range(self.slots) if i not in self._sessions)
        sess.slot = free
        sess.sent = 0
        self._sessions[free] = sess
        if self.chunk_budget and len(sess.prompt) > 1:
            self._cache = _setlen(self._cache, free, 0)
            sess.ctx_len = len(sess.prompt) - 1
            sess.fill = 0
            return
        cache1, ctx_len = bucketed_prefill(self._prefill, self.cfg,
                                           sess.prompt)
        self.prefills_run += 1
        self._cache = self._insert(self._cache, cache1, free, ctx_len)
        sess.ctx_len = sess.fill = ctx_len       # fully prefilled: active
        self._tokens[free] = int(sess.prompt[-1])
        self._active[free] = True

    def _activate(self, sess: _Session) -> None:
        """A fully chunk-filled session goes live: the prompt's last token
        rides the next step, as after a whole-prompt prefill."""
        sess.fill = sess.ctx_len
        self._tokens[sess.slot] = int(sess.prompt[-1])
        self._active[sess.slot] = True
        self.prefills_run += 1

    def _chunk_round(self) -> None:
        """Spend this round's chunk budget on bounded prefill slices over
        the filling sessions, interactive tier first.  A filling slot's
        rows past ``fill`` are garbage, but the mask admits a row only
        once ``len`` passes it, and a slice has rewritten it by then."""
        filling = [s for s in self._sessions.values()
                   if s.fill < s.ctx_len]
        if not filling:
            return
        filling.sort(key=lambda s: (s.tier_rank, s.slot))
        if filling[0].tier_rank == _TIER_RANK["interactive"] \
                and any(s.tier_rank > filling[0].tier_rank
                        for s in filling):
            count_sched("sched_interactive_first")
        budget = self.chunk_budget
        for sess in filling:
            if budget <= 0:
                break
            if sess.stream.closed:
                self._evict(sess, None)
                continue
            while budget > 0 and sess.fill < sess.ctx_len:
                t0 = _mono_ns()
                n = int(min(self._chunk_w, sess.ctx_len - sess.fill, budget))
                ids = np.zeros((self._chunk_w,), np.int32)
                ids[:n] = sess.prompt[sess.fill:sess.fill + n]
                self._cache = self._chunk(self._cache, sess.slot, sess.fill,
                                          n, ids)
                sess.fill += n
                budget -= n
                count_sched("sched_chunk_slice")
                _rec_phase(PH_CHUNK_SLICE, _mono_ns() - t0)
            if sess.fill >= sess.ctx_len:
                self._activate(sess)

    def _plain_round(self):
        """One decode step over the active slots: ``(pairs, finished)``
        for the emit/evict epilogue."""
        t0 = _mono_ns()
        self._cache, logits = self._step(
            self._cache, torch.from_numpy(self._tokens).to(self.device),
            torch.from_numpy(self._active).to(self.device))
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

    def _finalize_obs(self, sess: _Session, reason: str) -> None:
        """Session close: judge and count the SLO verdict."""
        tl = sess.tl
        if tl is not None:
            sess.tl = None
            ttft_t, itl_t = self.tiers.slo_of(sess.tier) \
                if self.tiers is not None else (None, None)
            _lmt.close_timeline(tl, reason, ttft_t, itl_t)

    def _evict(self, sess: _Session, reason: Optional[str]) -> None:
        self._sessions.pop(sess.slot, None)
        self._active[sess.slot] = False
        if not sess.stream.closed:
            sess.stream.close(reason=reason or "finished")
        self._finalize_obs(sess, reason or "finished")

    def _next_admits(self):
        """Under the lock: the joins to admit this round (interactive
        first, FIFO within a tier), or None when the thread should end."""
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
                    + list(self._pending)
                self._sessions.clear()
                self._pending.clear()
                # free every slot, and drop the pool a failed step may have
                # left half written; the next join rebuilds it.  The
                # state is reset before anything that can fail again
                self._active[:] = False
                self._tokens[:] = 0
                self._cache = None
                self._thread = None
            for sess in sessions:
                try:
                    sess.stream.close(reason="decode_error")
                except Exception:
                    LOG.exception("closing a session's stream failed")
                self._finalize_obs(sess, "decode_error")

    def _loop(self) -> None:
        while True:
            with self._lock:
                admits = self._next_admits()
                idle = not self._sessions and not admits \
                    and not self._pending
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
                        if not self._pending and not self._sessions:
                            self._thread = None
                            return
                continue
            for sess in admits:
                self._admit(sess)
            # the chunk slices before the step: a fill completed now
            # teacher-forces its first token on this round's step
            self._chunk_round()
            if not self._active.any():
                continue            # every occupied slot still filling
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
    device one at a time; the batcher (``decode_slots`` sessions,
    ``prefill_chunk_tokens``, ``tiers``) is built on ``device`` at the
    first ``Decode``."""

    def __init__(self, cfg: Optional[LMConfig] = None, params=None,
                 max_new_cap: int = 128, quantize: bool = False,
                 device="cuda", seed: int = 0, decode_slots: int = 8,
                 prefill_chunk_tokens: Optional[int] = None,
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
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.tiers = tiers
        self._batcher: Optional[ContinuousBatcher] = None
        self._batcher_lock = threading.Lock()

    def batcher(self) -> ContinuousBatcher:
        with self._batcher_lock:
            if self._batcher is None:
                self._batcher = ContinuousBatcher(
                    self.cfg, self.params, slots=self.decode_slots,
                    prefill_chunk_tokens=self.prefill_chunk_tokens,
                    tiers=self.tiers, device=self.device)
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
        with self._device_lock:
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
                            tenant=cntl.request_meta.tenant)
        return struct.pack("<I", max_new)

    def Info(self, cntl, request):
        c = self.cfg
        return json.dumps({"vocab": c.vocab, "dim": c.dim,
                           "heads": c.heads, "depth": c.depth,
                           "max_seq": c.max_seq,
                           "quantized": self.quantized,
                           "param_bytes": self._param_bytes,
                           }).encode()
