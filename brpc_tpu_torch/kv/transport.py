"""KvTransport: move a session's KV pages to a peer tier over the cheapest
lane it can reach.

Counterpart of ``brpc_tpu/kv/transport.py``, with the same wire bytes
(the manifest, the probe answer, the page descriptors) and the same
closed reason enums.  The lanes, probed per peer and chosen per handoff:

    ici    the peer shares this process (its fabric domain token is this
           process's): the pages were posted on the in-process fabric at
           export, the wire carries 16-byte descriptors, and the import
           is an alias of the exporter's tensors (no byte moves).
    shm    same host, another process (``transport/shm_ring.py``): each
           page is copied once from the card into a slot of this
           process's ring, the wire carries the 24-byte slot descriptors,
           and the import lands each page from the ring on the decode
           tier's device before it returns (the slots recycle when the
           handoff settles).  A page larger than a slot demotes the
           handoff to copy under ``kv_page_over_slot``, a full ring under
           ``kv_ring_exhausted``, and no ring at all under
           ``kv_shm_unavailable``.
    copy   the fallback: the page bytes ride the handoff RPC's attachment
           (one device-to-host copy per page to send, one host-to-device
           copy per page to land).  Every arrival here is counted under a
           named reason: there is no "unknown" bucket.

The handoff RPC (``KV.ImportSession``) is an ordinary unary call, so it
passes the decode tier's admission and deadline plane like any other
request, and issued from a handler it inherits that request's remaining
budget (as ``brpc_tpu/kv/transport.py:25`` says of the JAX one).  The
probe answer may carry the fleet load-report tail
(:func:`encode_probe_response`'s ``report``), and
:func:`decode_probe_report` parses one.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import struct
import threading
import time
import warnings
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..butil.flags import define_flag, get_flag
from ..butil.status import Errno
from ..ops.device_ops import torch_dtype
from ..transport import shm_ring
from .pages import KvPageError, decode_desc, process_kv_store

LOG = logging.getLogger(__name__)

define_flag("kv_transfer_enabled", True,
            "move KV-cache pages by fabric descriptor instead of serialized "
            "bytes (off = every handoff rides the copy lane under "
            "kv_disabled)",
            validator=lambda v: isinstance(v, bool))

# -- closed reason enums ------------------------------------------------------

# every handoff that does not ride the cheapest lane, and every session that
# falls back to local decode, counts exactly one of these
KV_FALLBACK_REASONS = (
    "kv_disabled",          # kv_transfer_enabled flag off -> copy lane
    "kv_probe_failed",      # peer never answered the capability probe
    "kv_model_mismatch",    # peer serves a different model fingerprint
    "kv_shm_unavailable",   # same host, but no shm ring
    "kv_page_over_slot",    # a page exceeds the ring slot size
    "kv_ring_exhausted",    # no free ring slots (sender backpressure)
    "kv_pages_exhausted",   # page export table full (backpressure)
    "kv_peer_remote",       # different host, no transfer fabric
    "kv_stream_not_local",  # client stream not adoptable by the peer
    "kv_import_rejected",   # peer refused or failed the import RPC
    "kv_no_decode_tier",    # no decode channel configured or reachable
)

# stream close reasons the kv plane can emit (a strict tier closes the
# client stream under one instead of decoding locally)
KV_CLOSE_REASONS = (
    "kv_handoff_failed",
)

_fb_lock = threading.Lock()
_fallbacks: Dict[str, int] = {r: 0 for r in KV_FALLBACK_REASONS}


def count_fallback(reason: str) -> None:
    if reason not in _fallbacks:
        raise ValueError(f"unnamed kv fallback {reason!r}")
    with _fb_lock:
        _fallbacks[reason] += 1


def kv_fallback_counters() -> Dict[str, int]:
    with _fb_lock:
        return dict(_fallbacks)


_stats_lock = threading.Lock()
_stats = {"sessions": 0, "ici_sessions": 0, "shm_sessions": 0,
          "copy_sessions": 0, "local_fallbacks": 0, "pages_moved": 0,
          "bytes_moved": 0}


def _stat(key: str, n: int = 1) -> None:
    with _stats_lock:
        _stats[key] += n


def kv_stats() -> Dict[str, int]:
    with _stats_lock:
        return dict(_stats)


def _reset_for_tests() -> None:
    with _fb_lock:
        for k in _fallbacks:
            _fallbacks[k] = 0
    with _stats_lock:
        for k in _stats:
            _stats[k] = 0


# -- wire codecs: the manifest and the probe answer ---------------------------

_MAGIC = b"KVH1"
LANE_ICI, LANE_SHM, LANE_COPY = 0, 1, 2
_LANE_NAMES = {LANE_ICI: "ici", LANE_SHM: "shm", LANE_COPY: "copy"}

_PROBE_MAGIC = b"KVP1"

# Stream-adoption tag: stream ids are enumerable enough that naming a live
# one must not suffice to seat a session on another client's stream.  The
# tag is keyed on a process secret, the reach of stream takeover (the
# decode tier must share the prefill tier's stream registry, that is, its
# process): a co-resident tier can mint and check it, a remote forger
# cannot.  Each package keeps its own secret, so a handoff between them
# ends here, under kv_stream_not_local.
_STREAM_SECRET = os.urandom(16)
_AUTH_BYTES = 8


def stream_auth(stream_id: int) -> bytes:
    return hashlib.blake2b(struct.pack("<Q", stream_id), key=_STREAM_SECRET,
                           digest_size=_AUTH_BYTES).digest()


def _host_token() -> bytes:
    """This host's name as the probe carries it: the JAX package's bytes,
    so both packages agree on "same host"."""
    return socket.gethostname().encode()[:64]


class SessionManifest:
    __slots__ = ("lane", "stream_id", "auth", "ctx_len", "last_token",
                 "max_new", "model_fp", "descs")

    def __init__(self, lane: int, stream_id: int, auth: bytes,
                 ctx_len: int, last_token: int, max_new: int,
                 model_fp: bytes, descs: List[bytes]):
        self.lane = lane
        self.stream_id = stream_id
        self.auth = auth
        self.ctx_len = ctx_len
        self.last_token = last_token
        self.max_new = max_new
        self.model_fp = model_fp
        self.descs = descs


def encode_manifest(m: SessionManifest) -> bytes:
    out = [_MAGIC, struct.pack("<BQ", m.lane, m.stream_id), m.auth,
           struct.pack("<IiIH", m.ctx_len, m.last_token, m.max_new,
                       len(m.model_fp)), m.model_fp,
           struct.pack("<H", len(m.descs))]
    for d in m.descs:
        out.append(struct.pack("<H", len(d)))
        out.append(d)
    return b"".join(out)


def decode_manifest(data: bytes) -> SessionManifest:
    if data[:4] != _MAGIC:
        raise KvPageError("bad kv manifest magic")
    lane, sid = struct.unpack_from("<BQ", data, 4)
    off = 4 + struct.calcsize("<BQ")
    auth = bytes(data[off:off + _AUTH_BYTES])
    off += _AUTH_BYTES
    ctx_len, last_tok, max_new, fplen = struct.unpack_from("<IiIH", data,
                                                           off)
    off += struct.calcsize("<IiIH")
    fp = bytes(data[off:off + fplen])
    off += fplen
    (nd,) = struct.unpack_from("<H", data, off)
    off += 2
    descs = []
    for _ in range(nd):
        (dl,) = struct.unpack_from("<H", data, off)
        off += 2
        descs.append(bytes(data[off:off + dl]))
        off += dl
    if off != len(data):
        raise KvPageError("trailing bytes in kv manifest")
    return SessionManifest(lane, sid, auth, ctx_len, last_tok, max_new, fp,
                           descs)


def encode_probe_response(report: Optional[dict] = None) -> bytes:
    """The decode tier's capability answer: its fabric domain token, its
    host token, and whether it offers the shm lane, so the sender picks a
    lane before moving a byte.

    With ``report`` (a ``fleet.build_load_report`` dict) a versioned
    load-report tail follows the capability fields: ``<I len>`` + JSON.
    Decoders that stop at the shm byte never read it, so the tail is
    wire-compatible both ways."""
    from ..ici.fabric import local_domain_id
    dom = local_domain_id()
    host = _host_token()
    out = (_PROBE_MAGIC
           + struct.pack("<H", len(dom)) + dom
           + struct.pack("<H", len(host)) + host
           + struct.pack("<B", 1 if shm_ring.lane_enabled() else 0))
    if report is not None:
        blob = json.dumps(report, default=str).encode("utf-8")
        out += struct.pack("<I", len(blob)) + blob
    return out


def decode_probe_response(data: bytes):
    """``(domain, host, shm_ok)``, or None (not a kv-capable peer).  A
    load-report tail after the shm byte is ignored."""
    try:
        if data[:4] != _PROBE_MAGIC:
            return None
        (dl,) = struct.unpack_from("<H", data, 4)
        off = 6
        dom = bytes(data[off:off + dl])
        off += dl
        (hl,) = struct.unpack_from("<H", data, off)
        off += 2
        host = bytes(data[off:off + hl])
        off += hl
        (shm_ok,) = struct.unpack_from("<B", data, off)
        return dom, host, bool(shm_ok)
    except struct.error:
        return None


def decode_probe_report(data: bytes) -> Optional[dict]:
    """The versioned load-report tail of a probe answer (``<I len>`` +
    JSON), or None when there is none or it is malformed."""
    try:
        if data[:4] != _PROBE_MAGIC:
            return None
        (dl,) = struct.unpack_from("<H", data, 4)
        off = 6 + dl
        (hl,) = struct.unpack_from("<H", data, off)
        off += 2 + hl + 1                      # host + shm byte
        if off + 4 > len(data):
            return None
        (rl,) = struct.unpack_from("<I", data, off)
        off += 4
        if rl == 0 or off + rl > len(data):
            return None
        report = json.loads(data[off:off + rl].decode("utf-8"))
        return report if isinstance(report, dict) else None
    except (struct.error, ValueError, UnicodeDecodeError):
        return None


def _host_view(tensor: torch.Tensor) -> memoryview:
    """A page's bytes on the host, read-only (the copy lane's
    device-to-host staging; the ici lane never calls this)."""
    host = tensor.detach().contiguous().cpu().numpy()
    return memoryview(host).cast("B")


# -- the transport ------------------------------------------------------------

class HandoffResult:
    __slots__ = ("ok", "lane", "reason", "ambiguous")

    def __init__(self, ok: bool, lane: Optional[str],
                 reason: Optional[str], ambiguous: bool = False):
        self.ok = ok            # the peer imported the session
        self.lane = lane        # "ici" / "copy" when ok
        self.reason = reason    # the named fallback reason (a lane
        #                         demotion or the failure), None on a
        #                         clean cheapest-lane handoff
        # the failure does not prove the peer never seated the session (a
        # timeout or a dead connection after the import may have landed):
        # the caller must not decode it too, since two batchers writing
        # one client stream break at-most-once.  False only for failures
        # that provably precede the join (no RPC made, or the import
        # handler's own refusal)
        self.ambiguous = ambiguous


class KvTransport:
    """Per-tier handoff client: probes each peer (cached per channel),
    exports or stages the pages on the cheapest lane it can reach, and
    settles every lease whatever the outcome."""

    # capabilities are near-static, but a failed probe retries soon: a
    # decode tier briefly unreachable at first contact is not written off
    PROBE_OK_TTL_S = 60.0
    PROBE_FAIL_TTL_S = 2.0

    def __init__(self, probe_timeout_ms: int = 5_000,
                 import_timeout_ms: int = 30_000,
                 force_lane: Optional[str] = None):
        self.probe_timeout_ms = probe_timeout_ms
        self.import_timeout_ms = import_timeout_ms
        # pin a lane ("ici", "shm" or "copy") to measure it alone; None
        # takes the cheapest reachable
        self.force_lane = force_lane
        self._peer_lock = threading.Lock()
        # weak keys: a collected channel takes its entry with it
        self._peers: "weakref.WeakKeyDictionary[Any, Tuple[Any, float]]" \
            = weakref.WeakKeyDictionary()

    def peer_info(self, channel):
        """The TTL-cached ``KV.Probe`` answer of ``channel``'s peer (None:
        not kv-capable, or unreachable now)."""
        now = time.monotonic()
        with self._peer_lock:
            hit = self._peers.get(channel)
            if hit is not None and now < hit[1]:
                return hit[0]
        from ..client import Controller
        info = None
        try:
            cntl = Controller()
            cntl.timeout_ms = self.probe_timeout_ms
            c = channel.call_method("KV.Probe", b"", cntl=cntl)
            if not c.failed:
                info = decode_probe_response(bytes(c.response))
        except Exception as e:
            LOG.info("kv probe failed: %s", e)
        ttl = self.PROBE_OK_TTL_S if info is not None \
            else self.PROBE_FAIL_TTL_S
        with self._peer_lock:
            self._peers[channel] = (info, now + ttl)
        return info

    def _pick_lane(self, info) -> Tuple[int, Optional[str]]:
        """``(lane, demotion reason)``: the reason is None on the cheapest
        lane, else it names why the cheaper lanes were out of reach."""
        from ..ici.fabric import in_process_fabric
        dom, host, peer_shm = info
        if not bool(get_flag("kv_transfer_enabled")):
            return LANE_COPY, "kv_disabled"
        if self.force_lane is not None:
            return {"ici": LANE_ICI, "shm": LANE_SHM,
                    "copy": LANE_COPY}[self.force_lane], None
        if in_process_fabric().can_reach(dom):
            return LANE_ICI, None
        if host == _host_token():
            if peer_shm and shm_ring.lane_enabled():
                return LANE_SHM, None
            return LANE_COPY, "kv_shm_unavailable"
        return LANE_COPY, "kv_peer_remote"

    def _prepare_pages(self, lane: int, pages, owner):
        """Export or stage each ``(tensor, nbytes)`` page for ``lane``:
        ``(lane, descs, attachment, leases, reason)``.  The lane demotes to
        copy under a named reason when the pages do not fit it; the caller
        settles the leases."""
        store = process_kv_store()
        descs: List[bytes] = []
        leases: List[Tuple[str, Any]] = []
        if lane == LANE_ICI:
            for tensor, nbytes in pages:
                h = store.export_array(tensor, nbytes, owner=owner)
                if h is None:
                    self._settle(leases)
                    return self._prepare_pages(LANE_COPY, pages, owner)[:4] \
                        + ("kv_pages_exhausted",)
                descs.append(h.describe())
                leases.append(("page", h))
            return lane, descs, None, leases, None
        if lane == LANE_SHM:
            ring = shm_ring.process_tx_ring()
            demote = None if ring is not None else "kv_shm_unavailable"
            for tensor, nbytes in pages:
                if demote is not None:
                    break
                if nbytes > ring.slot_bytes:
                    demote = "kv_page_over_slot"
                    break
                # one copy, from the page's device straight into the slot
                staged = shm_ring.stage_page(tensor, owner=owner)
                if staged is None:
                    demote = "kv_ring_exhausted"
                    break
                descs.append(staged[0])
                leases.append(("slot", staged[1]))
            if demote is not None:
                self._settle(leases)
                return self._prepare_pages(LANE_COPY, pages, owner)[:4] \
                    + (demote,)
            return lane, descs, None, leases, None
        # copy lane: the page bytes ride the attachment back to back; each
        # descriptor is the page's length (the order carries the layout)
        parts = []
        for tensor, nbytes in pages:
            descs.append(struct.pack("<I", nbytes))
            parts.append(_host_view(tensor))
        return LANE_COPY, descs, b"".join(parts), leases, None

    @staticmethod
    def _settle(leases) -> None:
        """Release every lease of a handoff attempt, exported pages and
        ring slots (the response, success or failure, proves the peer is
        done with them)."""
        store = process_kv_store()
        for kind, lease in leases:
            if kind == "slot":
                shm_ring.client_complete(lease)
                continue
            try:
                store.release(lease.page_id, lease.gen)
            except KvPageError:
                pass      # swept by a dead-owner sweep mid-handoff

    def handoff(self, channel, stream_id: int, ctx_len: int,
                last_token: int, max_new: int, model_fp: bytes, pages,
                owner: Any = None, trace: Any = None) -> HandoffResult:
        """Hand one live session to ``channel``'s peer.  ``pages`` is the
        ordered ``(tensor, nbytes)`` list of
        ``transformer_lm.export_decode_cache``.  ``trace`` (optional
        ``(trace_id, span_id)``) rides the ImportSession call's ordinary
        trace TLVs, so the decode tier's spans join the request's trace
        with no new wire format.  Never raises: on a False
        result the caller still owns the session (it decodes locally or
        closes the stream under a named reason), and every lease is
        settled."""
        if channel is None:
            count_fallback("kv_no_decode_tier")
            _stat("local_fallbacks")
            return HandoffResult(False, None, "kv_no_decode_tier")
        info = self.peer_info(channel)
        if info is None:
            count_fallback("kv_probe_failed")
            _stat("local_fallbacks")
            return HandoffResult(False, None, "kv_probe_failed")
        lane, reason = self._pick_lane(info)
        if reason is not None:
            count_fallback(reason)
        lane, descs, att, leases, demote = self._prepare_pages(lane, pages,
                                                               owner)
        if demote is not None:
            count_fallback(demote)
            reason = demote
        m = SessionManifest(lane, stream_id, stream_auth(stream_id),
                            ctx_len, last_token, max_new, model_fp, descs)
        from ..client import Controller
        cntl = Controller()
        cntl.timeout_ms = self.import_timeout_ms
        if trace is not None:
            cntl.trace_id, cntl.span_id = trace
        if att:
            cntl.request_attachment = att
        try:
            c = channel.call_method("KV.ImportSession", encode_manifest(m),
                                    cntl=cntl)
            failed, err, code = c.failed, (c.error_text or ""), c.error_code
        except Exception as e:
            failed, err, code = True, f"{type(e).__name__}: {e}", -1
        finally:
            self._settle(leases)
        if failed:
            why = err.split(":", 1)[0].strip()
            if why not in KV_FALLBACK_REASONS:
                why = "kv_import_rejected"
            count_fallback(why)
            _stat("local_fallbacks")
            # only the import handler's own refusal (EREQUEST, ERESPONSE)
            # proves the session was never seated; a timeout or a dead
            # connection may have landed after the join
            ambiguous = code not in (int(Errno.EREQUEST),
                                     int(Errno.ERESPONSE))
            return HandoffResult(False, None, why, ambiguous=ambiguous)
        _stat("sessions")
        _stat(f"{_LANE_NAMES[lane]}_sessions")
        _stat("pages_moved", len(pages))
        _stat("bytes_moved", sum(p[1] for p in pages))
        return HandoffResult(True, _LANE_NAMES[lane], reason)


# -- the import side (the decode tier's half, called by kv/disagg) ------------

def import_pages(manifest: SessionManifest, attachment, page_specs,
                 device) -> List[torch.Tensor]:
    """The manifest's pages as tensors on ``device``, one per page, by the
    manifest's lane.  ``page_specs`` is the model's ordered ``(shape,
    dtype, nbytes)`` list: the layout comes from the config, never from
    the wire.  Anything stale or malformed raises :class:`KvPageError`
    (the service answers ERESPONSE: a decode tier never seats a session
    on an empty cache).

    The ici lane returns the exporter's tensors themselves (moved only if
    they lie on another device); the shm lane lands each page with one
    copy from its ring slot onto ``device`` before returning (the slot
    recycles once the handoff settles); the copy lane lands each page
    with one host-to-device copy from a private copy of the
    attachment."""
    if len(manifest.descs) != len(page_specs):
        raise KvPageError(f"page count mismatch ({len(manifest.descs)} "
                          f"descriptors for {len(page_specs)} pages)")
    out: List[torch.Tensor] = []
    if manifest.lane == LANE_ICI:
        store = process_kv_store()
        for d, (_shape, _dtype, nbytes) in zip(manifest.descs, page_specs):
            page_id, gen, n = decode_desc(d)
            if n != nbytes:
                raise KvPageError(f"kv page size mismatch ({n} != "
                                  f"{nbytes})")
            out.append(store.import_page(page_id, gen, n).to(device))
        return out
    if manifest.lane == LANE_COPY:
        # writable and private: the landed CPU tensors may alias it
        blob = bytearray(attachment) if attachment is not None \
            else bytearray()
        off = 0
        for d, (shape, dtype, nbytes) in zip(manifest.descs, page_specs):
            (n,) = struct.unpack("<I", d)
            if n != nbytes or off + n > len(blob):
                raise KvPageError("kv copy-lane page bounds mismatch")
            host = np.frombuffer(blob, dtype=dtype, offset=off,
                                 count=nbytes // np.dtype(dtype).itemsize)
            out.append(torch.from_numpy(host).reshape(shape).to(device))
            off += n
        if off != len(blob):
            raise KvPageError("trailing bytes in kv copy-lane blob")
        return out
    if manifest.lane == LANE_SHM:
        for d, (shape, dtype, nbytes) in zip(manifest.descs, page_specs):
            parsed = shm_ring.decode_desc(d)
            if parsed is None:
                raise KvPageError("malformed shm kv page descriptor")
            rid, _slot, off, n = parsed
            if n != nbytes:
                raise KvPageError(f"kv page size mismatch ({n} != {nbytes})")
            view = shm_ring.resolve(rid, off, n)
            if view is None:
                raise KvPageError("unresolvable shm kv page descriptor")
            with warnings.catch_warnings():
                # a peer's ring is mapped read-only; nothing writes through
                # this transient view, which the copy below leaves behind
                warnings.simplefilter("ignore", UserWarning)
                host = torch.frombuffer(view, dtype=torch.uint8)
            page = torch.empty(shape, dtype=torch_dtype(dtype), device=device)
            page.view(-1).view(torch.uint8).copy_(host)
            out.append(page)
        return out
    raise KvPageError(f"unknown kv lane {manifest.lane}")
