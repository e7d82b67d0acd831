"""Same-host shared-memory slot ring: the attachment data plane between
processes on one host.

The port of ``brpc_tpu/transport/shm_ring.py``, slimmed to the port's
blocking Server and Channel, with the same bytes on the wire (the spec,
the 24-byte descriptor, the release list and the four meta TLVs 18-21),
so a port peer and a JAX peer negotiate and resolve each other's rings.

- **The ring.**  Each process owns one file-backed ring of fixed-size
  slots (its tx ring), advertised once per connection in a capability
  TLV that carries the host token and the file's path.  An attachment of
  at least ``rpc_shm_threshold`` bytes is staged into a slot with ONE
  copy and rides as a ``(ring_id, slot, offset, len)`` descriptor; the
  receiver maps the peer's ring read-only and reads the slot in place.
- **Ownership and credit.**  The sender owns its ring.  A request slot
  is freed by the client once the call has an outcome (the unary
  response proves the server is done with it).  A response slot is freed
  by a release TLV on the client's next request over the connection,
  and swept by owner when the connection closes.  An echo handler whose
  response attachment IS the request's view is answered by re-describing
  the request's slot: no byte moves on the server.
- **Named fallbacks.**  Every shape kept off the ring rides the byte lane
  unchanged and counts exactly one named reason; there is no "unknown".
- **A ring that fits, or none.**  Unlike the JAX ring (a sparse
  ``ftruncate``), the port's ring is allocated with
  ``os.posix_fallocate``: on a tmpfs too small for it the first write
  past the free space would be a SIGBUS, so a directory that cannot hold
  the ring is passed over for the next one, and when none can the ring
  is declined (``process_tx_ring()`` is None, the lane counts
  ``shm_unavailable``).

A received view is a ``memoryview`` whose release (the last view of it
dropped) settles its slot, on the Channel's path and on the fast lane
alike.  The IOBuf half of the JAX module is here too:
:meth:`ShmRing.sendfile_spill` (a staged slot over TCP with
``os.sendfile``), :func:`resolve_ex` (a view and the file ref that spill
needs; an attached peer ring keeps no descriptor, so its ref is None),
:func:`wrap_view_iobuf` (a view as an ``IOBuf`` whose block settles the
slot when dropped), :func:`defer_settle` (the raw lane's settle at the
thread's next request on its pinned connection), and the allocator's
:meth:`ShmRing.shard_stats` and :meth:`ShmRing.slot_of`.
"""

from __future__ import annotations

import itertools
import weakref
import logging
import mmap
import os
import socket as _socket_mod
import struct
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..butil.flags import define_flag, get_flag

LOG = logging.getLogger(__name__)

define_flag("rpc_shm_data_plane", True,
            "pass same-host attachments >= rpc_shm_threshold by "
            "shared-memory descriptor instead of bytes",
            validator=lambda v: isinstance(v, bool))
define_flag("rpc_shm_threshold", 256 * 1024,
            "minimum attachment size (bytes) for the shm lane",
            validator=lambda v: isinstance(v, int) and v > 0)
define_flag("rpc_shm_slot_bytes", 2 * 1024 * 1024,
            "shm ring slot size (attachments above it fall back)",
            validator=lambda v: isinstance(v, int) and v >= 4096)
define_flag("rpc_shm_slots", 16, "slots per shm ring",
            validator=lambda v: isinstance(v, int) and 0 < v <= 4096)
define_flag("rpc_shm_shards", 0,
            "slot-allocator shards of the process tx ring (0 = auto: one "
            "per core up to 4); each thread binds to a home shard, and an "
            "empty shard steals from its neighbours",
            validator=lambda v: isinstance(v, int) and 0 <= v <= 64)

_SPEC_MAGIC = b"SHMR"
_SPEC_VER = 1

# -- named fallback counters -------------------------------------------------

FALLBACK_REASONS = (
    "shm_disabled",          # rpc_shm_data_plane flag off
    "shm_unavailable",       # no ring here (no tmpfs/mmap, or none fits)
    "shm_under_threshold",   # attachment below rpc_shm_threshold
    "shm_over_slot",         # attachment larger than a ring slot
    "shm_peer_no_cap",       # peer never accepted the capability TLV
    "shm_handshake",         # offer in flight; this call rides bytes
    "shm_ring_exhausted",    # all slots in use (sender backpressure)
    "shm_multi_attempt",     # a retry while an earlier attempt may be live
    "shm_attach_failed",     # peer ring could not be opened/mapped
    "shm_peer_remote",       # spec came from a different host
    "shm_device_combo",      # frame also carries a device attachment
    "shm_compressed",        # compressed payload: bytes are the shape
)

_fb_lock = threading.Lock()
_fallbacks: Dict[str, int] = {r: 0 for r in FALLBACK_REASONS}


class ShmDescriptorError(Exception):
    """A peer named a descriptor this process cannot resolve: a protocol
    violation, not a fallback shape (the client fails the call with
    ERESPONSE, the server answers EREQUEST)."""


def count_fallback(reason: str) -> None:
    assert reason in _fallbacks, f"unnamed shm fallback {reason!r}"
    with _fb_lock:
        _fallbacks[reason] += 1


def shm_fallback_counters() -> Dict[str, int]:
    with _fb_lock:
        return dict(_fallbacks)


# staged copies are the ONE copy the lane makes (bytes -> slot); resolves
# are views
_stats_lock = threading.Lock()
_stats = {"staged": 0, "staged_bytes": 0, "resolved": 0,
          "resolved_bytes": 0, "desc_reused": 0, "spilled": 0,
          "spilled_bytes": 0}


def _stat(key: str, n: int = 1, nbytes: int = 0) -> None:
    with _stats_lock:
        _stats[key] += n
        if nbytes:
            _stats[key + "_bytes"] += nbytes


def shm_stats() -> Dict[str, int]:
    with _stats_lock:
        return dict(_stats)


# -- where a ring may live ---------------------------------------------------

def _ring_dirs() -> Iterator[str]:
    """Candidate directories in the JAX package's order: the tmpfs, then
    ``$TMPDIR`` (or /tmp)."""
    for d in ("/dev/shm", os.environ.get("TMPDIR") or "/tmp"):
        if d and os.path.isdir(d) and os.access(d, os.W_OK):
            yield d


def _local_ring_dirs() -> Iterator[str]:
    """Where a ring whose users are all in this process goes:
    ``tempfile.gettempdir()`` alone, so that nothing of it is left in
    shared memory when the process is killed before it unlinks the
    file."""
    yield tempfile.gettempdir()


_avail: Optional[bool] = None
_avail_lock = threading.Lock()


def shm_supported() -> bool:
    """True when this host can create and map a file-backed ring (one
    cached one-page probe)."""
    global _avail
    with _avail_lock:
        if _avail is None:
            _avail = False
            for d in _ring_dirs():
                try:
                    fd, path = tempfile.mkstemp(prefix="brpc_tpu_ring_",
                                                dir=d)
                    try:
                        os.posix_fallocate(fd, 0, mmap.PAGESIZE)
                        mm = mmap.mmap(fd, mmap.PAGESIZE)
                        mm[0:4] = b"ok!\n"
                        mm.close()
                    finally:
                        os.close(fd)
                        os.unlink(path)
                    _avail = True
                    break
                except (OSError, ValueError) as e:
                    LOG.info("shm ring probe in %s failed: %s", d, e)
        return _avail


def _host_token() -> bytes:
    return _socket_mod.gethostname().encode()[:64]


# -- descriptor, release and spec codecs -------------------------------------

def encode_desc(ring_id: bytes, slot: int, offset: int, length: int) -> bytes:
    """``(ring_id, slot, offset, len)`` -> the 24-byte descriptor;
    ``offset`` is ring-absolute."""
    return ring_id + struct.pack("<IQI", slot, offset, length)


def decode_desc(data: bytes) -> Optional[Tuple[bytes, int, int, int]]:
    if len(data) != 24:
        return None
    slot, offset, length = struct.unpack_from("<IQI", data, 8)
    return bytes(data[:8]), slot, offset, length


def encode_release(ring_id: bytes, slots: List[int]) -> bytes:
    return ring_id + struct.pack("<H", len(slots)) \
        + b"".join(struct.pack("<I", s) for s in slots)


def decode_release(data: bytes) -> Optional[Tuple[bytes, List[int]]]:
    try:
        (n,) = struct.unpack_from("<H", data, 8)
        if len(data) != 10 + 4 * n:
            return None
        return bytes(data[:8]), [struct.unpack_from("<I", data, 10 + 4 * i)[0]
                                 for i in range(n)]
    except struct.error:
        return None


def decode_spec(data: bytes):
    """Spec bytes -> ``(ring_id, slot_bytes, nslots, host, path)``, or
    None."""
    try:
        if data[:4] != _SPEC_MAGIC or data[4] != _SPEC_VER:
            return None
        ring_id = bytes(data[5:13])
        slot_bytes, nslots, hlen = struct.unpack_from("<IIH", data, 13)
        off = 23
        host = bytes(data[off:off + hlen])
        off += hlen
        (plen,) = struct.unpack_from("<H", data, off)
        off += 2
        path = bytes(data[off:off + plen]).decode()
        if len(data) != off + plen:
            return None
        return ring_id, slot_bytes, nslots, host, path
    except (struct.error, IndexError, UnicodeDecodeError):
        return None


# -- the ring ----------------------------------------------------------------

def _nbytes(data) -> int:
    if hasattr(data, "data_ptr"):                  # a torch tensor
        return data.numel() * data.element_size()
    return memoryview(data).nbytes


class ShmRing:
    """The file-backed slot ring this process owns (its tx data plane).

    ``alloc`` tags each slot with an owner key so a dead consumer
    connection can be swept (``free_owner``), and bumps the slot's
    generation so a stale settle cannot free a later tenant
    (``free(slot, gen)``).  The slot free-lists are split into shards,
    each under its own lock; a thread allocates from its home shard and
    steals from the others when it is empty.  The file stays linked while
    the ring lives (peers attach by path) and is unlinked on close."""

    def __init__(self, slot_bytes: int, nslots: int, shards: int = 1,
                 local_only: bool = False):
        self.slot_bytes = slot_bytes
        self.nslots = nslots
        self.size = slot_bytes * nslots
        self.fd, self.path = self._allocate(self.size, local_only)
        try:
            self.mm = mmap.mmap(self.fd, self.size)
        except BaseException:
            self._unlink()
            raise
        self.ring_id = os.urandom(8)
        self.nshards = max(1, min(int(shards), nslots))
        self._locks = [threading.Lock() for _ in range(self.nshards)]
        self._free: List[List[int]] = [[] for _ in range(self.nshards)]
        for slot in range(nslots):
            self._free[slot % self.nshards].append(slot)
        self._owners: List[Dict[int, Any]] = [{} for _ in range(self.nshards)]
        self._tls = threading.local()
        self._next_home = itertools.count()
        self._gen: List[int] = [0] * nslots
        self._closed = False
        self._closed_lock = threading.Lock()
        # touch every page once, so first-touch faults stay out of the
        # first calls' latency
        mv = memoryview(self.mm)
        for off in range(0, self.size, mmap.PAGESIZE):
            mv[off:off + 1] = b"\0"
        mv.release()

    @staticmethod
    def _allocate(size: int, local_only: bool = False) -> Tuple[int, str]:
        """A file of ``size`` allocated bytes in the first ring directory
        that holds it; OSError when none does."""
        errors = []
        for d in _local_ring_dirs() if local_only else _ring_dirs():
            fd, path = tempfile.mkstemp(prefix="brpc_tpu_ring_", dir=d)
            try:
                os.posix_fallocate(fd, 0, size)
                return fd, path
            except OSError as e:
                os.close(fd)
                os.unlink(path)
                errors.append(f"{d}: {e}")
        raise OSError(f"no ring directory holds {size} bytes "
                      f"({'; '.join(errors) or 'none writable'})")

    def _unlink(self) -> None:
        for fn in (lambda: os.close(self.fd), lambda: os.unlink(self.path)):
            try:
                fn()
            except OSError:
                pass

    # -- slot lifecycle ------------------------------------------------------

    def _home_shard(self) -> int:
        idx = getattr(self._tls, "shard", None)
        if idx is None:
            idx = self._tls.shard = next(self._next_home) % self.nshards
        return idx

    def alloc(self, owner: Any = None) -> Optional[int]:
        home = self._home_shard()
        for i in range(self.nshards):
            sh = (home + i) % self.nshards
            with self._locks[sh]:
                if self._free[sh]:
                    slot = self._free[sh].pop()
                    self._owners[sh][slot] = owner
                    self._gen[slot] += 1
                    return slot
        return None

    def gen_of(self, slot: int) -> int:
        with self._locks[slot % self.nshards]:
            return self._gen[slot]

    def free(self, slot: int, gen: Optional[int] = None) -> None:
        """Return ``slot``; with ``gen`` (from :meth:`gen_of` at alloc) a
        stale settle of a swept and re-allocated slot is a no-op."""
        sh = slot % self.nshards
        with self._locks[sh]:
            if slot in self._owners[sh] and (gen is None
                                             or self._gen[slot] == gen):
                del self._owners[sh][slot]
                self._free[sh].append(slot)

    def free_owner(self, owner: Any) -> int:
        """Reclaim every slot tagged ``owner`` (its connection died)."""
        n = 0
        for sh in range(self.nshards):
            with self._locks[sh]:
                for slot, ow in list(self._owners[sh].items()):
                    if ow == owner:
                        del self._owners[sh][slot]
                        self._free[sh].append(slot)
                        n += 1
        return n

    def free_count(self) -> int:
        n = 0
        for sh in range(self.nshards):
            with self._locks[sh]:
                n += len(self._free[sh])
        return n

    def shard_stats(self) -> Dict[str, int]:
        """The allocator's shards: their count and each one's free
        slots."""
        out: Dict[str, int] = {"shards": self.nshards}
        for sh in range(self.nshards):
            with self._locks[sh]:
                out[f"shard_{sh}_free"] = len(self._free[sh])
        return out

    def slot_of(self, offset: int) -> int:
        return offset // self.slot_bytes

    def sendfile_spill(self, sock_fd: int, offset: int, length: int,
                       headers: bytes = b"") -> int:
        """Ship a staged span over TCP with ``os.sendfile`` (the spill
        when a staged block must ride the byte lane after all: the bytes
        are not read back through user space).  A blocking-socket helper;
        returns the bytes of the span sent."""
        sent = 0
        while sent < len(headers):
            sent += os.write(sock_fd, headers[sent:])
        done = 0
        while done < length:
            n = os.sendfile(sock_fd, self.fd, offset + done, length - done)
            if n == 0:
                raise ConnectionError("sendfile: peer closed")
            done += n
        _stat("spilled", 1, length)
        return done

    # -- data ----------------------------------------------------------------

    def write(self, slot: int, data) -> Tuple[int, int]:
        """Stage ``data`` (a bytes-like, or a torch tensor on any device)
        into ``slot``: the lane's ONE copy, from the card straight into the
        slot for a CUDA tensor.  Returns ``(ring_offset, length)``."""
        n = _nbytes(data)
        base = slot * self.slot_bytes
        dst = memoryview(self.mm)[base:base + n]
        try:
            if hasattr(data, "data_ptr"):
                import torch
                src = data.detach().contiguous().reshape(-1)
                torch.frombuffer(dst, dtype=torch.uint8).copy_(
                    src.view(torch.uint8))
            else:
                dst[:] = memoryview(data).cast("B")
        finally:
            dst.release()
        _stat("staged", 1, n)
        from ..butil import copy_audit as _audit
        if _audit.enabled and n >= _audit.AUDIT_FLOOR:
            _audit.record("stage_shm", n)
        return base, n

    def view(self, offset: int, length: int) -> Optional[memoryview]:
        if length < 0 or offset < 0 or offset + length > self.size:
            return None
        return memoryview(self.mm)[offset:offset + length]

    def spec(self) -> bytes:
        """The capability TLV's payload advertising this ring."""
        host = _host_token()
        path = self.path.encode()
        return (_SPEC_MAGIC + bytes([_SPEC_VER]) + self.ring_id
                + struct.pack("<IIH", self.slot_bytes, self.nslots, len(host))
                + host + struct.pack("<H", len(path)) + path)

    def close(self) -> None:
        with self._closed_lock:
            if self._closed:
                return
            self._closed = True
        try:
            self.mm.close()
        except (BufferError, ValueError):
            pass        # views still alive: the mapping lives until exit
        self._unlink()


class AttachedRing:
    """A read-only mapping of a peer's ring."""

    def __init__(self, ring_id: bytes, path: str, size: int):
        self.ring_id = ring_id
        self.path = path
        self.size = size
        fd = os.open(path, os.O_RDONLY)
        try:
            self.mm = mmap.mmap(fd, size, prot=mmap.PROT_READ)
        finally:
            os.close(fd)

    def view(self, offset: int, length: int) -> Optional[memoryview]:
        if length < 0 or offset < 0 or offset + length > self.size:
            return None
        return memoryview(self.mm)[offset:offset + length]

    def close(self) -> None:
        try:
            self.mm.close()
        except (BufferError, ValueError):
            pass


# -- process-wide registries -------------------------------------------------

_reg_lock = threading.Lock()
_tx_ring: Optional[ShmRing] = None
_tx_failed = False
_tx_local_only = False      # the next tx ring serves this process alone
_attached: Dict[bytes, Optional[AttachedRing]] = {}   # None: declined


def process_tx_ring() -> Optional[ShmRing]:
    """This process's send-side ring, created at first use from the
    flags then (None when no ring can be made here)."""
    global _tx_ring, _tx_failed
    with _reg_lock:
        if _tx_ring is not None or _tx_failed:
            return _tx_ring
        if not shm_supported():
            _tx_failed = True
            return None
        try:
            shards = int(get_flag("rpc_shm_shards")) \
                or max(1, min(4, os.cpu_count() or 1))
            _tx_ring = ShmRing(int(get_flag("rpc_shm_slot_bytes")),
                               int(get_flag("rpc_shm_slots")), shards=shards,
                               local_only=_tx_local_only)
        except (OSError, ValueError) as e:
            LOG.warning("shm tx ring declined: %s", e)
            _tx_failed = True
            return None
        import atexit
        atexit.register(_tx_ring.close)
        return _tx_ring


def reset_tx_ring(local_only: bool = False) -> bool:
    """Close this process's tx ring, so that the next use builds one from
    the flags as they are then; with ``local_only`` for users in this
    process alone (under ``tempfile.gettempdir()``, not the tmpfs).
    Refused (False) while a slot is outstanding.  Connections that
    negotiated the old ring must be reopened: their peers hold
    descriptors of it."""
    global _tx_ring, _tx_failed, _tx_local_only
    with _reg_lock:
        ring = _tx_ring
        if ring is not None and ring.free_count() != ring.nslots:
            return False
        _tx_ring, _tx_failed = None, False
        _tx_local_only = local_only
    if ring is not None:
        ring.close()
    return True


def attach_spec(spec: bytes) -> Optional[bytes]:
    """Map a peer's advertised ring: its ring id, or None on a decline
    (counted under a named reason)."""
    parsed = decode_spec(spec)
    if parsed is None:
        count_fallback("shm_attach_failed")
        return None
    ring_id, slot_bytes, nslots, host, path = parsed
    with _reg_lock:
        if ring_id in _attached:
            return ring_id if _attached[ring_id] is not None else None
        local = _tx_ring
    if local is not None and ring_id == local.ring_id:
        return ring_id                     # our own ring (same process)
    if host != _host_token():
        count_fallback("shm_peer_remote")
        with _reg_lock:
            _attached[ring_id] = None      # deterministic: cached
        return None
    try:
        att = AttachedRing(ring_id, path, slot_bytes * nslots)
    except (OSError, ValueError) as e:
        # transient (EMFILE, an unlink race): not cached, a later offer
        # retries
        LOG.info("shm attach of %s failed: %s", path, e)
        count_fallback("shm_attach_failed")
        return None
    with _reg_lock:
        if _attached.get(ring_id) is None:
            _attached[ring_id] = att
            att = None
    if att is not None:
        att.close()                        # a concurrent offer won
    return ring_id


def resolve(ring_id: bytes, offset: int, length: int
            ) -> Optional[memoryview]:
    """A descriptor as a view into the local tx ring or an attached peer
    ring; None when the ring is unknown or the span out of bounds."""
    r = resolve_ex(ring_id, offset, length)
    return r[0] if r is not None else None


def resolve_ex(ring_id: bytes, offset: int, length: int):
    """Like :func:`resolve`, as ``(view, file_ref)``: ``file_ref`` is
    ``(fd, offset)`` of the local ring, for :meth:`ShmRing.sendfile_spill`
    (None for an attached peer ring)."""
    with _reg_lock:
        local = _tx_ring
        att = _attached.get(ring_id)
    v = ref = None
    if local is not None and ring_id == local.ring_id:
        v = local.view(offset, length)
        ref = (local.fd, offset)
    elif att is not None:
        v = att.view(offset, length)
    if v is None:
        return None
    _stat("resolved", 1, length)
    return v, ref


def local_ring_for(ring_id: bytes) -> Optional[ShmRing]:
    with _reg_lock:
        local = _tx_ring
    return local if local is not None and ring_id == local.ring_id else None


def on_socket_closed(owner: Any) -> None:
    """Sweep the tx-ring slots a dead connection consumed."""
    with _reg_lock:
        ring = _tx_ring
    if ring is not None:
        ring.free_owner(owner)


def outstanding_tx_slots() -> int:
    """Slots of this process's tx ring staged or leased now."""
    with _reg_lock:
        ring = _tx_ring
    if ring is None or ring._closed:
        return 0
    return ring.nslots - ring.free_count()


def drain_settle(deadline_mono_s: float) -> int:
    """Wait, up to ``deadline_mono_s`` (``time.monotonic()``), for every
    tx-ring slot to settle; returns the slots still outstanding then."""
    ev = threading.Event()
    while True:
        n = outstanding_tx_slots()
        if n == 0 or time.monotonic() >= deadline_mono_s:
            return n
        ev.wait(0.005)      # timed: the drain stays deadline-bound


def _reset_for_tests() -> None:
    """Drop the process-wide state (tests negotiate from scratch)."""
    global _tx_ring, _tx_failed, _tx_local_only
    with _reg_lock:
        ring, _tx_ring, _tx_failed = _tx_ring, None, False
        _tx_local_only = False
        _attached.clear()
    if ring is not None:
        ring.close()
    with _fb_lock:
        for k in _fallbacks:
            _fallbacks[k] = 0
    with _stats_lock:
        for k in _stats:
            _stats[k] = 0


# -- per-connection negotiation state and the lane's two halves --------------

# eligible calls to let pass (each under shm_handshake) before an offer
# still unanswered is sent again: the offer's call may have died a
# transport death that proved nothing about the peer
_REOFFER_AFTER = 8


class ShmSockState:
    """Negotiation and credit state of one connection (either end)."""

    __slots__ = ("offered", "tx_ok", "peer_refused", "peer_ring_id",
                 "peer_ring_acked", "pending_release", "resp_desc_ok",
                 "offer_waits", "deferred_settles", "lock")

    def __init__(self):
        self.offered = False          # we advertised our tx ring
        self.tx_ok = False            # the peer confirmed mapping it
        self.peer_refused = False     # the peer answered without accepting
        self.peer_ring_id = None      # the peer's ring we mapped
        self.peer_ring_acked = False  # we told the peer we mapped it
        self.pending_release = []     # [(ring_id, slot)] to send back
        self.resp_desc_ok = False     # (server) the peer mapped OUR ring
        self.offer_waits = 0          # eligible calls since the offer
        # settles run at the next request prepared on this connection
        # (the raw lane's pinned connections: one thread each)
        self.deferred_settles = []
        self.lock = threading.Lock()


def sock_state(sock) -> ShmSockState:
    st = getattr(sock, "shm", None)
    if st is None:
        st = sock.shm = ShmSockState()
    return st


def lane_enabled() -> bool:
    return bool(get_flag("rpc_shm_data_plane")) and shm_supported()


def _tlv(tag: int, data: bytes) -> bytes:
    from ..protocol.meta import encode_tlv
    return encode_tlv(tag, data)


def take_release_tlvs(st: ShmSockState) -> bytes:
    """Pending slot releases as TLV-20s (one per ring), plus the one-shot
    ack of the peer ring's mapping (TLV 19): pre-encoded meta bytes."""
    from ..protocol.meta import TAG_SHM_ACCEPT, TAG_SHM_RELEASE
    out = b""
    with st.lock:
        pending, st.pending_release = st.pending_release, []
        ack_ring = None
        if st.peer_ring_id is not None and not st.peer_ring_acked:
            ack_ring = st.peer_ring_id
            st.peer_ring_acked = True
    if ack_ring is not None:
        out += _tlv(TAG_SHM_ACCEPT, ack_ring)
    by_ring: Dict[bytes, List[int]] = {}
    for rid, slot in pending:
        by_ring.setdefault(rid, []).append(slot)
    for rid, slots in by_ring.items():
        out += _tlv(TAG_SHM_RELEASE, encode_release(rid, slots))
    return out


def client_prepare(sock, att, device: bool = False,
                   multi_attempt: bool = False):
    """Client half, request side.  ``att`` is a bytes-like or None;
    ``device`` flags a frame that also carries a device attachment;
    ``multi_attempt`` a retry while an earlier attempt may be in flight.

    Returns ``(extra_meta_tlvs, wire_att, staged_slot, offered_now)``:
    ``wire_att`` still rides the frame (None when it went to the ring),
    ``staged_slot`` is the slot lease to settle when the call has an
    outcome, and ``offered_now`` flags that this frame carries the
    capability offer."""
    from ..protocol.meta import TAG_SHM_DESC, TAG_SHM_OFFER
    st = sock_state(sock)
    with st.lock:
        deferred, st.deferred_settles = st.deferred_settles, []
    for settle in deferred:
        settle()                  # the previous raw response's slot
    extra = take_release_tlvs(st)
    na = len(att) if att is not None else 0
    if na == 0:
        return extra, att, None, False
    if not bool(get_flag("rpc_shm_data_plane")):
        count_fallback("shm_disabled")
        return extra, att, None, False
    if na < int(get_flag("rpc_shm_threshold")):
        count_fallback("shm_under_threshold")
        return extra, att, None, False
    if device:
        count_fallback("shm_device_combo")
        return extra, att, None, False
    if multi_attempt:
        count_fallback("shm_multi_attempt")
        return extra, att, None, False
    ring = process_tx_ring()
    if ring is None:
        count_fallback("shm_unavailable")
        return extra, att, None, False
    if na > ring.slot_bytes:
        count_fallback("shm_over_slot")
        return extra, att, None, False
    with st.lock:
        offered, tx_ok, refused = st.offered, st.tx_ok, st.peer_refused
        st.offered = True
        if offered and not tx_ok and not refused:
            # offer out, no answer yet: after enough eligible calls, offer
            # again (repeated offers are idempotent at the server)
            st.offer_waits += 1
            if st.offer_waits >= _REOFFER_AFTER:
                st.offered = False
                st.offer_waits = 0
    if refused:
        count_fallback("shm_peer_no_cap")
        return extra, att, None, False
    if not offered:
        # the capability exchange rides this frame; the attachment stays
        # on the byte lane until the peer confirms the mapping
        count_fallback("shm_handshake")
        return extra + _tlv(TAG_SHM_OFFER, ring.spec()), att, None, True
    if not tx_ok:
        count_fallback("shm_handshake")
        return extra, att, None, False
    slot = ring.alloc(owner=("req", getattr(sock, "id", 0)))
    if slot is None:
        count_fallback("shm_ring_exhausted")
        return extra, att, None, False
    off, n = ring.write(slot, att)
    return (extra + _tlv(TAG_SHM_DESC, encode_desc(ring.ring_id, slot, off,
                                                   n)),
            None, (slot, ring.gen_of(slot)), False)


def stage_page(data, owner: Any = None):
    """KV transfer plane: stage one page (a bytes-like, or a tensor on any
    device, copied once into the slot) and return ``(desc_bytes, lease)``,
    the lease to settle with :func:`client_complete` once the handoff has
    an outcome; None when the ring is missing, exhausted or its slots too
    small (the caller names its own reasons)."""
    ring = process_tx_ring()
    if ring is None or _nbytes(data) > ring.slot_bytes:
        return None
    slot = ring.alloc(owner=owner)
    if slot is None:
        return None
    off, n = ring.write(slot, data)
    return encode_desc(ring.ring_id, slot, off, n), (slot, ring.gen_of(slot))


def client_complete(staged_slot) -> None:
    """Settle a slot lease (generation-checked: a lease already swept and
    re-allocated is left alone)."""
    if staged_slot is None:
        return
    ring = process_tx_ring()
    if ring is not None:
        ring.free(*staged_slot)


class _SettledView:
    """Buffer exporter of a resolved view: the settle runs when the last
    view made from it is released (PEP 688), so a slot recycles only once
    the caller has dropped its attachment."""

    __slots__ = ("_view", "_settle")

    def __init__(self, view: memoryview, settle):
        self._view = view
        self._settle = settle

    def __buffer__(self, flags: int) -> memoryview:
        return self._view

    def __release_buffer__(self, view: memoryview) -> None:
        settle, self._settle = self._settle, None
        if settle is not None:
            settle()


def defer_settle(sock, settle) -> None:
    """Run ``settle`` when the next request is prepared on ``sock``.
    Right only on a connection pinned to one thread (the raw lane): the
    next request there comes from the thread that holds the view."""
    if settle is None:
        return
    st = sock_state(sock)
    with st.lock:
        st.deferred_settles.append(settle)


def wrap_view_iobuf(view: memoryview, settle, file_ref=None):
    """A resolved view as an ``IOBuf`` whose block settles the slot when
    the buffer is dropped; raw views taken from it must not outlive
    it."""
    from ..butil.iobuf import IOBuf
    buf = IOBuf()
    buf.append_user_data(view, file_ref=file_ref)
    if settle is not None:
        weakref.finalize(buf._refs[-1][0], settle)
    return buf


def settled_view(view: memoryview, settle) -> memoryview:
    """``view`` as a memoryview whose release runs ``settle``."""
    if settle is None:
        return view
    return memoryview(_SettledView(view, settle))


def client_on_response_meta(sock, meta, offered_now: bool = False,
                            staged_slot=None):
    """Client half, response side: learn accepts and the server's ring,
    resolve a response descriptor, and settle the request's slot lease
    (consumed here: do not also call :func:`client_complete`), except when
    the response re-describes that very slot (echo by reference): then
    the returned view aliases it and its settle frees it.

    Returns ``(view, settle)``; ``view`` is None when the response
    attachment rides the frame.  Raises :class:`ShmDescriptorError` on a
    descriptor that does not resolve (the lease is settled first).
    ``offered_now``: this response answers the offer; a success without
    an accept means the peer has no capability."""
    st = sock_state(sock)
    if meta.shm_offer:
        rid = attach_spec(meta.shm_offer)
        with st.lock:
            st.peer_ring_id = rid
    if meta.shm_accept:
        ring = process_tx_ring()
        if ring is not None and meta.shm_accept == ring.ring_id:
            with st.lock:
                st.tx_ok = True
                st.offer_waits = 0
    elif offered_now:
        client_saw_plain_response(sock)
    view = settle = desc_local_slot = None
    if meta.shm_desc:
        d = decode_desc(meta.shm_desc)
        view = resolve(d[0], d[2], d[3]) if d is not None else None
        if view is None:
            client_complete(staged_slot)
            raise ShmDescriptorError(
                "unresolvable shm response descriptor" if d is not None
                else "malformed shm response descriptor")
        rid, slot = d[0], d[1]
        local = local_ring_for(rid)
        if local is None:
            # a slot of the peer's ring: owe a release on the next request
            def settle():
                with st.lock:
                    st.pending_release.append((rid, slot))
        else:
            desc_local_slot = slot
            gen = local.gen_of(slot)

            def settle():
                local.free(slot, gen)
    if staged_slot is not None and desc_local_slot != staged_slot[0]:
        client_complete(staged_slot)
    return view, settle


def client_saw_plain_response(sock) -> None:
    """An offer went out and the answer carried no accept: the peer has
    no capability; stop offering on this connection."""
    st = sock_state(sock)
    with st.lock:
        if st.offered and not st.tx_ok:
            st.peer_refused = True


# -- server half -------------------------------------------------------------

class DescHandle:
    """A resolved request descriptor, kept so the response can re-describe
    an attachment that is still its view."""

    __slots__ = ("ring_id", "slot", "offset", "length", "view")

    def __init__(self, ring_id, slot, offset, length, view):
        self.ring_id = ring_id
        self.slot = slot
        self.offset = offset
        self.length = length
        self.view = view


def server_on_request_meta(sock, meta):
    """Server half, request side: take the offer, accept and release TLVs
    and resolve a request descriptor.  Returns ``(view, handle,
    accept_tlvs)``: ``view`` is the request attachment in the client's
    ring (None when there is no descriptor or it does not resolve),
    ``accept_tlvs`` the pre-encoded TLVs every answer to this request
    carries (the accept and this process's own ring spec)."""
    from ..protocol.meta import TAG_SHM_ACCEPT, TAG_SHM_OFFER
    st = sock_state(sock)
    accept = b""
    if meta.shm_offer and lane_enabled():
        rid = attach_spec(meta.shm_offer)
        if rid is not None:
            # a repeated offer (the client lost our answer) gets both
            # TLVs again; attach_spec is idempotent
            with st.lock:
                st.peer_ring_id = rid
                st.offered = True
            accept = _tlv(TAG_SHM_ACCEPT, rid)
            ring = process_tx_ring()
            if ring is not None:
                accept += _tlv(TAG_SHM_OFFER, ring.spec())
    if meta.shm_accept:
        ring = process_tx_ring()
        if ring is not None and meta.shm_accept == ring.ring_id:
            with st.lock:
                st.resp_desc_ok = True
    if meta.shm_release:
        rel = decode_release(meta.shm_release)
        ring = local_ring_for(rel[0]) if rel is not None else None
        if ring is not None:
            for slot in rel[1]:
                ring.free(slot)
    handle = view = None
    if meta.shm_desc:
        d = decode_desc(meta.shm_desc)
        if d is not None:
            view = resolve(d[0], d[2], d[3])
            if view is not None:
                handle = DescHandle(*d, view)
    return view, handle, accept


def describe_response_att(sock, att, req_handle):
    """Server half, response side: move the response attachment to the
    ring if it can go.  Returns ``(desc_tlv, wire_att)``; a non-empty
    ``desc_tlv`` means the attachment rides the ring and ``wire_att`` is
    None.  In order: re-describe an attachment that IS the request's view
    (echo, no data motion); stage into this process's ring once the
    client confirmed mapping it; else the byte lane under a named
    reason."""
    from ..protocol.meta import TAG_SHM_DESC
    n = len(att) if att is not None else 0
    if n == 0:
        return b"", att
    if not bool(get_flag("rpc_shm_data_plane")):
        if n >= int(get_flag("rpc_shm_threshold")):
            count_fallback("shm_disabled")
        return b"", att
    if req_handle is not None and att is req_handle.view:
        _stat("desc_reused")
        return _tlv(TAG_SHM_DESC, encode_desc(
            req_handle.ring_id, req_handle.slot, req_handle.offset,
            req_handle.length)), None
    if n < int(get_flag("rpc_shm_threshold")):
        count_fallback("shm_under_threshold")
        return b"", att
    st = sock_state(sock)
    with st.lock:
        ok = st.resp_desc_ok
    if not ok:
        count_fallback("shm_peer_no_cap")
        return b"", att
    ring = process_tx_ring()
    if ring is None:
        count_fallback("shm_unavailable")
        return b"", att
    if n > ring.slot_bytes:
        count_fallback("shm_over_slot")
        return b"", att
    slot = ring.alloc(owner=("resp", getattr(sock, "id", 0)))
    if slot is None:
        count_fallback("shm_ring_exhausted")
        return b"", att
    off, n = ring.write(slot, att)
    return _tlv(TAG_SHM_DESC, encode_desc(ring.ring_id, slot, off, n)), None


def unstage_response(desc_tlv: bytes) -> None:
    """Free the slot a response descriptor staged into this process's ring
    when the response does not go out after all (a frame refused at
    packing); a re-described request slot is not ours and is left."""
    if len(desc_tlv) != 5 + 24:
        return
    d = decode_desc(desc_tlv[5:])
    ring = local_ring_for(d[0]) if d is not None else None
    if ring is not None:
        ring.free(d[1])
