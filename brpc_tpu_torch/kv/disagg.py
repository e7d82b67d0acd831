"""Disaggregated prefill and decode: the two-tier LM service.

Counterpart of ``brpc_tpu/kv/disagg.py``.  Serving splits prompt
processing (prefill: compute-bound bursts) from token generation (decode:
memory-bound, long-lived sessions) and moves each session's KV cache
between the tiers:

- :class:`PrefillService` answers the same ``LM.Decode`` wire contract as
  the monolithic :class:`~brpc_tpu_torch.models.lm_service.LMService`:
  it accepts the client's stream, runs the bucketed prefill (the flash
  forward kernel on a card), exports the cache as pages and hands the
  live session to a decode tier through
  :class:`~brpc_tpu_torch.kv.transport.KvTransport`.  On a handoff
  failure that proves the decode tier never seated the session it decodes
  locally with the same cache (the client never sees the topology); a
  strict tier (``fallback_local=False``), or any ambiguous failure, closes
  the stream under ``kv_handoff_failed`` and answers EINTERNAL.
- :class:`DecodeTierService` is the decode tier's surface (``KV.Probe``,
  ``KV.ImportSession``): it checks the manifest, lands the pages and
  seats the session in its batcher
  (:meth:`ContinuousBatcher.join_imported`), whose tokens then stream to
  the original client over the stream it already holds.

Both tiers run the one ``bucketed_prefill`` and the one batch step, so a
handed-off session streams the monolithic path's tokens.  Stream adoption
goes through the process's stream registry, so the decode tier must share
the prefill tier's process (a decode tier elsewhere answers
``kv_stream_not_local`` and the prefill tier decodes locally).

A traced ``LM.Decode`` stitches across the handoff under one trace id:
the prefill tier's ``LMService.DecodeSession`` span (``lm_join``,
``lm_chunk_slice``, then ``lm_handoff``, or
``lm_evict:kv_handoff_failed``) hands its ids to the ImportSession call's
trace TLVs, and the decode tier opens ``KV.DecodeTierSession`` under that
call's server span, backdated to the import's arrival, which its batcher
annotates and finishes.

The handoff's RPCs (``KV.Probe``, ``KV.ImportSession``) are issued on the
``Decode`` handler's own call stack, so they inherit the request's
remaining deadline (``deadline.inherit_deadline`` around the handler,
``deadline.cap_timeout_ms`` in the channel): a handoff whose budget is
gone fails fast and ends at the JAX package's reason, ``kv_probe_failed``
before the probe is cached and ``kv_import_rejected`` (ambiguous) after.

Fleet (``brpc_tpu/kv/disagg.py:70-80``, ``:242-243``): ``KV.Probe``
answers with the cached load report as its tail, and a strict tier's
failed handoff records ``fleet_kv_handoff_failed``.
"""

from __future__ import annotations

import functools
import logging
import struct
import threading
from time import monotonic_ns
from typing import Optional

import torch

from ..butil.status import Errno
from ..models.lm_service import LMService, bucketed_prefill
from ..models.transformer_lm import (decode_cache_from_pages,
                                     export_decode_cache, kv_page_specs,
                                     make_decode)
from ..rpcz import Span, backdate_span
from ..server.service import Service
from .pages import KvPageError
from .transport import (KvTransport, decode_manifest, encode_probe_response,
                        import_pages, stream_auth)

LOG = logging.getLogger(__name__)


class DecodeTierService(Service):
    """``KV.Probe``: the lane-capability handshake; ``KV.ImportSession``:
    adopt a prefilled session into the continuous batch.  Wraps the tier's
    :class:`LMService`, which may serve ``LM.Decode`` directly too."""

    def __init__(self, lm: LMService):
        self.lm = lm

    @classmethod
    def service_name(cls) -> str:
        return "KV"

    def Probe(self, cntl, request):
        # capability answer + the fleet load-report tail: the prefill
        # tier reads live slot availability from the handshake it makes
        # before moving a byte
        from .. import fleet
        return encode_probe_response(
            report=fleet.report_cache().get(cntl.server))

    def ImportSession(self, cntl, request):
        """Checks, in the JAX service's order: the manifest, the model
        fingerprint, the session's bounds, the stream-adoption tag, the
        stream, then the pages.  Every refusal before the pages answers
        EREQUEST; a page that cannot be imported answers ERESPONSE.  Each
        error text starts with its ``KV_FALLBACK_REASONS`` name."""
        from ..streaming import find_stream
        recv_ns = monotonic_ns()
        try:
            man = decode_manifest(bytes(request))
        except (KvPageError, struct.error) as e:
            cntl.set_failed(Errno.EREQUEST,
                            f"kv_import_rejected: bad manifest: {e}")
            return None
        fp = self.lm.model_fingerprint()
        if man.model_fp != fp:
            cntl.set_failed(Errno.EREQUEST,
                            f"kv_model_mismatch: this tier serves "
                            f"{fp.decode()!r}")
            return None
        if not (0 < man.max_new <= self.lm.max_new_cap) \
                or man.ctx_len + 1 + man.max_new > self.lm.cfg.max_seq \
                or not (0 <= man.last_token < self.lm.cfg.vocab):
            cntl.set_failed(Errno.EREQUEST,
                            "kv_import_rejected: session bounds")
            return None
        if man.auth != stream_auth(man.stream_id):
            # stream ids are enumerable: adopting one needs the tag only a
            # tier in this process can mint, checked before any page
            cntl.set_failed(Errno.EREQUEST,
                            f"kv_stream_not_local: stream {man.stream_id} "
                            f"is not adoptable here")
            return None
        stream = find_stream(man.stream_id)
        if stream is None or stream.closed:
            cntl.set_failed(Errno.EREQUEST,
                            f"kv_stream_not_local: stream {man.stream_id} "
                            f"is not resolvable here")
            return None
        try:
            pages = import_pages(man, cntl.request_attachment,
                                 kv_page_specs(self.lm.cfg), self.lm.device)
            cache1 = decode_cache_from_pages(self.lm.cfg, pages)
        except KvPageError as e:
            # loud: a stale or double import fails the handoff (the sender
            # keeps the session), never seats a session on an empty cache
            cntl.set_failed(Errno.ERESPONSE, f"kv_import_rejected: {e}")
            return None
        # the decode tier's half of the stitched trace: the handoff call
        # carried the prefill request's trace id, so its server span is
        # forced under that id; the session span is its child, backdated
        # to the import's arrival so that it covers the page import
        span = None
        req_span = cntl.span
        if req_span is not None:
            span = Span("KV.DecodeTierSession", trace_id=req_span.trace_id,
                        parent_span_id=req_span.span_id)
            span.remote_side = req_span.remote_side
            backdate_span(span, recv_ns)
        self.lm.batcher().join_imported(stream, man.last_token, man.ctx_len,
                                        man.max_new, cache1,
                                        tenant=cntl.request_meta.tenant,
                                        span=span)
        return b"ok"


class PrefillService(LMService):
    """The prefill tier: ``LM.Decode``-compatible, but each session's
    decode is handed to the decode tier behind ``decode_channel``.
    ``Generate`` and ``Info`` are the monolithic service's.

    ``fallback_local=True`` (the default) decodes a session locally after
    any named handoff failure that proves the decode tier never seated it
    (``kv_fallback_counters`` then shows what the decode tier declines);
    ``fallback_local=False`` closes the stream under ``kv_handoff_failed``
    and answers EINTERNAL instead."""

    def __init__(self, *args, decode_channel=None,
                 transport: Optional[KvTransport] = None,
                 fallback_local: bool = True, **kw):
        super().__init__(*args, **kw)
        self.decode_channel = decode_channel
        self.transport = transport or KvTransport()
        self.fallback_local = fallback_local
        self._prefill = None
        self._prefill_lock = threading.Lock()

    def _ensure_prefill(self):
        with self._prefill_lock:
            if self._prefill is None:
                prefill, _step = make_decode(self.cfg, self.device)
                self._prefill = functools.partial(prefill, self.params)
            return self._prefill

    def Decode(self, cntl, request):
        """Prefill, export, hand off; answers ``<u32 max_new>`` once the
        decode tier (or, after a fallback, this tier's batcher) holds the
        session."""
        parsed = self._check_decode_request(cntl, request)
        if parsed is None:
            return None
        prompt, max_new, stream = parsed
        # the prefill tier's half of the stitched trace: a sampled or
        # traced Decode gets a forced session span whose chunk-slice event
        # covers the whole-prompt prefill this tier runs
        span = self._session_span(cntl)
        if span is not None:
            span.annotate("lm_join")
        with torch.inference_mode():
            cache1, ctx_len = bucketed_prefill(self._ensure_prefill(),
                                               self.cfg, prompt[0])
        if span is not None:
            span.annotate("lm_chunk_slice")
        last_token = int(prompt[0][-1])
        res = self.transport.handoff(
            self.decode_channel, stream.id, ctx_len, last_token, max_new,
            self.model_fingerprint(), export_decode_cache(self.cfg, cache1),
            owner=("kv", cntl.socket_id),
            trace=(span.trace_id, span.span_id) if span is not None
            else None)
        if res.ok:
            if span is not None:
                span.annotate("lm_handoff")
                span.finish(0)
            return struct.pack("<I", max_new)
        if self.fallback_local and not res.ambiguous:
            # the same cache joins the local batch: token-identical, and
            # the prefill is not run again.  Only after a failure that
            # proves the decode tier never seated the session: two
            # batchers on one client stream would break at-most-once
            LOG.info("kv handoff fell back to local decode (%s)",
                     res.reason)
            self.batcher().join_imported(stream, last_token, ctx_len,
                                         max_new, cache1,
                                         tenant=cntl.request_meta.tenant,
                                         span=span)
            return struct.pack("<I", max_new)
        stream.close(reason="kv_handoff_failed")
        from .. import fleet
        fleet.record_event("fleet_kv_handoff_failed", str(res.reason))
        if span is not None:
            span.annotate("lm_evict:kv_handoff_failed")
            span.finish(int(Errno.EINTERNAL))
        cntl.set_failed(Errno.EINTERNAL, f"kv handoff failed: {res.reason}")
        return None
