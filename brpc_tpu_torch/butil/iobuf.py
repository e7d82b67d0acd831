"""Zero-copy chained buffer — the data currency of the whole stack.

Capability parity with the reference's ``butil::IOBuf``
(brpc's src/butil/iobuf.h:61): a chain of refcounted block
references supporting O(1) append/cut/share without copying payload bytes.

Fresh design notes (not a port):

- Blocks are refcounted by the Python GC instead of manual atomics; a
  ``BlockRef`` is a ``[block, offset, length]`` triple and IOBufs share the
  underlying storage freely.
- The block allocator is a pluggable :class:`BlockPool`.  The default pool
  hands out 8KB host ``bytearray`` slabs with a free list; the ICI transport
  plugs in a DMA/HBM-backed pool with the same interface — the lesson of the
  reference retrofitting ``rdma/block_pool`` (SURVEY.md §5.8) is baked in
  from day 1.
- Sequential small appends from one thread pack into a thread-local open
  block, mirroring the reference's TLS block cache
  (brpc's src/butil/iobuf.cpp:297-306).

A copy of ``brpc_tpu/butil/iobuf.py``.  Every protocol of the port's
Python transport cuts from a socket's :class:`IOPortal`; tpu_std's
payloads and attachments leave it as ``bytes``.
"""

from __future__ import annotations

import errno as _errno_mod
import sys
import threading
import weakref
from collections import deque

_errno_EAGAIN = _errno_mod.EAGAIN
from typing import List, Optional, Tuple, Union

from . import copy_audit as _audit

DEFAULT_BLOCK_SIZE = 8192

# file-backed blocks (shm-ring slots) at/above this size leave a TCP
# socket via os.sendfile instead of a userspace read of the mapping
SENDFILE_MIN = 64 * 1024


def _is_tls(sock) -> bool:
    try:
        import ssl as _ssl
    except ImportError:             # pragma: no cover
        return False
    return isinstance(sock, _ssl.SSLSocket) or isinstance(
        sock, getattr(_ssl, "SSLObject", ()))


class Block:
    """A refcounted storage slab. ``data`` is writable (bytearray) for pool
    blocks or an arbitrary buffer for user-attached (zero-copy) data.
    ``size`` is the filled prefix; only the filled prefix may be referenced.
    """

    __slots__ = ("data", "size", "capacity", "pool", "file_ref",
                 "__weakref__")

    def __init__(self, data, size: int, pool: Optional["BlockPool"] = None,
                 file_ref: Optional[Tuple[int, int]] = None):
        self.data = data
        self.size = size
        self.capacity = len(data)
        self.pool = pool
        # (fd, base_offset): the block aliases a file-backed mapping
        # (shm-ring slot) — the TCP spill path ships it via os.sendfile
        self.file_ref = file_ref

    @property
    def left_space(self) -> int:
        return self.capacity - self.size

    if sys.version_info >= (3, 12):
        def __buffer__(self, flags: int) -> memoryview:
            # PEP 688: the Block itself is the buffer exporter, so every
            # view handed out keeps the BLOCK (not just its bytearray)
            # alive — the recycling finalizer cannot fire while
            # zero-copy views exist anywhere (write queues, the native
            # engine's pinned Py_buffers).
            return memoryview(self.data)

        def view(self, offset: int, length: int) -> memoryview:
            # no caching: a Block-held memoryview(self) would be a
            # reference cycle, deferring recycling to the cycle
            # collector
            return memoryview(self)[offset : offset + length]
    else:
        def view(self, offset: int, length: int) -> memoryview:
            # pre-PEP-688 interpreters cannot export a buffer from a
            # plain class: views alias the storage directly.  A view's
            # chain then keeps only the bytearray alive, NOT the Block
            # — so storage recycling is disabled on these interpreters
            # (HostBlockPool.allocate) to keep the no-aliasing
            # invariant; only performance degrades.
            return memoryview(self.data)[offset : offset + length]


class BlockPool:
    """Block allocator interface. Subclasses: HostBlockPool (bytearrays),
    and the transport layer's device pools (HBM slabs) share this interface.

    Recycling is tied to object lifetime (GC), never manual: a block's
    storage returns to the pool only when no IOBuf/ref can reach it anymore,
    so recycled slabs can never alias live zero-copy views.
    """

    def allocate(self, capacity: int = DEFAULT_BLOCK_SIZE) -> Block:
        raise NotImplementedError


class HostBlockPool(BlockPool):
    """Free-listed host memory pool. Thread-safe.

    Storage recycling rides a ``weakref.finalize`` on the Block: when the
    last reference (IOBuf ref / TLS open-block slot) drops, the bytearray
    goes back on the free list.  NOTE: memoryviews obtained from
    ``backing_views()`` are only valid while the owning IOBuf is alive.
    """

    def __init__(self, block_size: int = DEFAULT_BLOCK_SIZE, max_cached: int = 64):
        self.block_size = block_size
        self._free: deque = deque()
        # large read slabs (adaptive socket reads) recycle through
        # size-class free lists — a fresh bytearray(512KB) is a 512KB
        # memset per recv otherwise, the top cost in the echo profile
        self._free_large: dict = {}
        self._large_cached = 0
        self._max_large_cached_bytes = 64 << 20
        self._lock = threading.Lock()
        self._max_cached = max_cached
        self.allocated = 0  # stats
        self.reused = 0

    def allocate(self, capacity: int = 0) -> Block:
        capacity = capacity or self.block_size
        data = None
        if capacity == self.block_size:
            with self._lock:
                if self._free:
                    data = self._free.popleft()
                    self.reused += 1
        elif capacity > self.block_size:
            with self._lock:
                lst = self._free_large.get(capacity)
                if lst:
                    data = lst.pop()
                    self._large_cached -= capacity
                    self.reused += 1
        if data is None:
            self.allocated += 1
            data = bytearray(capacity)
        blk = Block(data, 0, self)
        if capacity >= self.block_size and sys.version_info >= (3, 12):
            # recycling is safe only when views export the BLOCK's
            # buffer (PEP 688, Block.view): otherwise a recycled slab
            # could be rewritten while an old view still aliases it
            weakref.finalize(blk, self._recycle, data)
        return blk

    def _recycle(self, data: bytearray) -> None:
        n = len(data)
        with self._lock:
            if n == self.block_size:
                if len(self._free) < self._max_cached:
                    self._free.append(data)
            elif self._large_cached + n <= self._max_large_cached_bytes:
                self._free_large.setdefault(n, []).append(data)
                self._large_cached += n


_default_pool = HostBlockPool()


class _TLS(threading.local):
    def __init__(self):
        self.open_block: Optional[Block] = None


_tls = _TLS()


def _sharable_block(min_space: int = 1) -> Block:
    """Thread-local open block new appends pack into (TLS block cache)."""
    b = _tls.open_block
    if b is None or b.left_space < min_space:
        b = _default_pool.allocate()
        _tls.open_block = b
    return b


def default_block_pool() -> HostBlockPool:
    return _default_pool


BytesLike = Union[bytes, bytearray, memoryview, str]


class IOBuf:
    """Non-contiguous zero-copy buffer: a deque of block references.

    O(1) for append of another IOBuf (ref sharing), cheap cut/pop at either
    end (ref arithmetic only).  Payload bytes are copied only on explicit
    materialization (``bytes(buf)`` / :meth:`copy_to`).
    """

    __slots__ = ("_refs", "_size", "_pool", "_open_block")

    def __init__(self, data: Optional[BytesLike] = None,
                 pool: Optional[BlockPool] = None):
        self._refs: deque = deque()  # of [block, offset, length]
        self._size = 0
        # Optional injected pool (e.g. a DMA/HBM-registered pool from the
        # device transport). None => thread-shared default host pool.
        self._pool = pool
        self._open_block: Optional[Block] = None
        if data is not None:
            self.append(data)

    def _write_block(self, min_space: int = 1) -> Block:
        if self._pool is None:
            return _sharable_block(min_space)
        b = self._open_block
        if b is None or b.left_space < min_space:
            b = self._pool.allocate()
            self._open_block = b
        return b

    # ---- introspection ----

    def __len__(self) -> int:
        return self._size

    @property
    def size(self) -> int:
        return self._size

    def empty(self) -> bool:
        return self._size == 0

    @property
    def backing_block_count(self) -> int:
        return len(self._refs)

    def backing_views(self) -> List[memoryview]:
        """Scatter-gather list for vectored IO (≈ IOBuf::backing_block)."""
        return [blk.view(off, ln) for blk, off, ln in self._refs]

    # ---- building ----

    def clear(self) -> None:
        self._refs.clear()
        self._size = 0

    def append(self, data: Union[BytesLike, "IOBuf"]) -> None:
        if len(data) > DEFAULT_BLOCK_SIZE:
            if isinstance(data, bytes):
                # large immutable payloads attach zero-copy instead of
                # being chopped into pool blocks (bytes never mutate)
                self.append_user_data(data)
                return
            if isinstance(data, memoryview) and data.readonly \
                    and data.c_contiguous \
                    and isinstance(data.obj, bytes):
                # a large view EXPORTED BY bytes is as safe as bytes:
                # no writer exists anywhere (readonly alone is not
                # enough — it blocks writes through the view, not
                # through a bytearray/ndarray owner, and append's
                # contract is copy semantics).  Response serialization
                # of sliced bytes payloads was paying a block-by-block
                # copy here; callers that own a
                # no-mutate contract for OTHER storage attach it
                # explicitly via append_user_data.
                self.append_user_data(
                    data if data.format == "B" else data.cast("B"))
                return
        self._append_copy(data)

    def _append_copy(self, data: Union[BytesLike, "IOBuf"]) -> None:
        if isinstance(data, IOBuf):
            self.append_iobuf(data)
            return
        if isinstance(data, str):
            data = data.encode("utf-8")
        n = len(data)
        if n == 0:
            return
        if _audit.enabled and n >= _audit.AUDIT_FLOOR:
            _audit.record("ingest", n)
        mv = memoryview(data) if not isinstance(data, memoryview) else data
        pos = 0
        while pos < n:
            blk = self._write_block()
            take = min(n - pos, blk.left_space)
            start = blk.size
            blk.data[start : start + take] = mv[pos : pos + take]
            blk.size += take
            self._append_ref(blk, start, take)
            pos += take
        self._size += n

    def append_user_data(self, data, file_ref=None) -> None:
        """Zero-copy attach of an external buffer (≈ append_user_data,
        brpc's src/butil/iobuf.h — user block, not pool-owned).
        The caller must not mutate ``data`` afterwards.  ``file_ref`` =
        (fd, base_offset) marks a file-backed mapping (shm-ring slot)
        eligible for the sendfile spill in :meth:`cut_into_socket`."""
        n = len(data)
        if n == 0:
            return
        blk = Block(data, n, None, file_ref=file_ref)
        self._refs.append([blk, 0, n])
        self._size += n

    def prepend_user_data(self, data) -> None:
        """Zero-copy attach of an external buffer at the FRONT (control
        frames piggybacking ahead of a queued payload frame)."""
        n = len(data)
        if n == 0:
            return
        blk = Block(data, n, None)
        self._refs.appendleft([blk, 0, n])
        self._size += n

    def append_iobuf(self, other: "IOBuf") -> None:
        """Share other's refs — O(#blocks), zero payload copies."""
        for blk, off, ln in other._refs:
            self._append_ref(blk, off, ln)
        self._size += other._size

    def push_back(self, byte: int) -> None:
        blk = self._write_block()
        blk.data[blk.size] = byte
        self._append_ref(blk, blk.size, 1)
        blk.size += 1
        self._size += 1

    def _append_ref(self, blk: Block, off: int, ln: int) -> None:
        if self._refs:
            last = self._refs[-1]
            if last[0] is blk and last[1] + last[2] == off:
                last[2] += ln  # merge contiguous refs in the same block
                return
        self._refs.append([blk, off, ln])

    # ---- consuming ----

    def pop_front(self, n: int) -> int:
        n = min(n, self._size)
        left = n
        while left > 0:
            ref = self._refs[0]
            if ref[2] <= left:
                left -= ref[2]
                self._refs.popleft()
            else:
                ref[1] += left
                ref[2] -= left
                left = 0
        self._size -= n
        return n

    def pop_back(self, n: int) -> int:
        n = min(n, self._size)
        left = n
        while left > 0:
            ref = self._refs[-1]
            if ref[2] <= left:
                left -= ref[2]
                self._refs.pop()
            else:
                ref[2] -= left
                left = 0
        self._size -= n
        return n

    def cutn(self, n: int, out: Optional["IOBuf"] = None) -> "IOBuf":
        """Cut the first n bytes into a new (or provided) IOBuf, sharing
        blocks (zero-copy) — ≈ IOBuf::cutn."""
        if out is None:
            out = IOBuf()
        n = min(n, self._size)
        left = n
        while left > 0:
            ref = self._refs[0]
            if ref[2] <= left:
                out._append_ref(ref[0], ref[1], ref[2])
                left -= ref[2]
                self._refs.popleft()
            else:
                out._append_ref(ref[0], ref[1], left)
                ref[1] += left
                ref[2] -= left
                left = 0
        out._size += n
        self._size -= n
        return out

    def cut_into(self, writer) -> int:
        """Write to a writable with ``write(view)`` semantics; returns bytes
        written and consumes exactly that many.  Handles short writes: stops
        at the first partial/refused write, leaving the tail intact."""
        total = 0
        for v in self.backing_views():
            n = writer.write(v)
            if n is None:          # e.g. io.BufferedWriter contract
                n = len(v)
            total += n
            if n < len(v):
                break
        self.pop_front(total)
        return total

    # ---- reading without consuming ----

    def as_contiguous(self) -> Tuple[memoryview, bool]:
        """The whole buffer as ONE contiguous view: ``(view, copied)``.
        Single-block buffers (the native ingest shape) return a
        zero-copy view into the backing block; chained buffers gather
        once (the audited scatter-gather join) — the receive-side
        landing path (attachment → numpy → device) uses this instead of
        ``to_bytes`` so the common case materializes nothing."""
        if len(self._refs) == 1:
            blk, off, ln = self._refs[0]
            if off == 0 and ln == blk.size \
                    and isinstance(blk.data, memoryview):
                # full-span user block: hand back the ORIGINAL buffer
                # object, not a fresh slice — identity survives handler
                # round trips (the shm echo-by-reference check compares
                # block storage by identity)
                return blk.data, False
            return blk.view(off, ln), False
        if _audit.enabled and self._size >= _audit.AUDIT_FLOOR:
            _audit.record("gather", self._size)
        out = bytearray(self._size)
        pos = 0
        for blk, off, ln in self._refs:
            out[pos:pos + ln] = blk.view(off, ln)
            pos += ln
        return memoryview(out), True

    def fetch(self, n: int) -> bytes:
        """Peek first n bytes (copies n bytes, does not consume)."""
        n = min(n, self._size)
        if _audit.enabled and n >= _audit.AUDIT_FLOOR:
            _audit.record("materialize", n)
        out = bytearray(n)
        pos = 0
        for blk, off, ln in self._refs:
            if pos >= n:
                break
            take = min(ln, n - pos)
            out[pos : pos + take] = blk.view(off, take)
            pos += take
        return bytes(out)

    def fetch1(self) -> Optional[int]:
        if not self._refs:
            return None
        blk, off, _ = self._refs[0]
        return blk.data[off]

    def copy_to(self, n: Optional[int] = None, pos: int = 0) -> bytes:
        if n is None:
            n = self._size - pos
        if pos:
            tmp = bytearray(self.fetch(pos + n))
            return bytes(tmp[pos : pos + n])
        return self.fetch(n)

    def to_bytes(self) -> bytes:
        return self.fetch(self._size)

    def __bytes__(self) -> bytes:
        return self.to_bytes()

    def __eq__(self, other) -> bool:
        if isinstance(other, (bytes, bytearray)):
            return self._size == len(other) and self.to_bytes() == bytes(other)
        if isinstance(other, IOBuf):
            return self._size == other._size and self.to_bytes() == other.to_bytes()
        return NotImplemented

    def __repr__(self) -> str:
        head = self.fetch(32)
        return f"IOBuf(size={self._size}, blocks={len(self._refs)}, head={head!r})"

    # ---- fd / socket integration ----

    def cut_into_socket(self, sock, max_bytes: Optional[int] = None) -> int:
        """Vectored send (≈ cut_into_file_descriptor,
        brpc's src/butil/iobuf.h:160). Consumes what was sent.

        A file-backed block (shm-ring slot spilling onto the TCP lane)
        at the queue head ships via ``os.sendfile`` — the kernel pulls
        straight from the page cache/tmpfs pages, never re-reading the
        mapping through userspace.  Never on a TLS socket: sendfile
        writes beneath the SSL record layer (plaintext on the wire);
        those blocks take the encrypted send path below."""
        if self._refs:
            blk, off, ln = self._refs[0]
            if blk.file_ref is not None and ln >= SENDFILE_MIN \
                    and not _is_tls(sock):
                import os as _os
                fd, base = blk.file_ref
                want = ln if max_bytes is None else min(ln, max_bytes)
                try:
                    sent = _os.sendfile(sock.fileno(), fd, base + off,
                                        want)
                except BlockingIOError:
                    raise
                except OSError:
                    pass        # no sendfile on this fd: fall
                                # through to the sendmsg view path
                else:
                    self.pop_front(sent)
                    return sent
        views = self.backing_views()
        if max_bytes is not None:
            clipped, acc = [], 0
            for v in views:
                if acc + len(v) > max_bytes:
                    v = v[: max_bytes - acc]
                clipped.append(v)
                acc += len(v)
                if acc >= max_bytes:
                    break
            views = clipped
        if not views:
            return 0
        try:
            sent = sock.sendmsg(views)
        except NotImplementedError:
            # TLS sockets have no scatter-gather send; SSLWantWrite maps
            # to the EAGAIN contract the write path already understands
            import ssl as _ssl
            try:
                sent = sock.send(views[0])
            except (_ssl.SSLWantWriteError, _ssl.SSLWantReadError):
                raise BlockingIOError(_errno_EAGAIN, "ssl wants io")
        self.pop_front(sent)
        return sent


class IOPortal(IOBuf):
    """IOBuf that can read from sockets into pool blocks
    (≈ butil::IOPortal)."""

    __slots__ = ()

    def append_from_socket(self, sock, max_bytes: int = 65536) -> int:
        """recv_into a fresh/open tail region. Returns bytes read
        (0 = EOF, raises BlockingIOError if nonblocking and empty).

        Large reads get a dedicated block of ``max_bytes`` so a 512KB
        gulp is ONE recv into one slab, not 64 pool-block nibbles — the
        syscall-amortization the reference gets from readv into an
        IOPortal's block chain (src/butil/iobuf.cpp read path).  The
        current tail block is reused while it still has meaningful room,
        so trickling traffic on a connection with a large avg-msg-size
        EMA doesn't churn a fresh large slab per recv."""
        if max_bytes > DEFAULT_BLOCK_SIZE:
            # Only a DEDICATED large slab (capacity > pool block size) may
            # be reused: a pool-sized tail could be the thread-local shared
            # block, which another thread's appends write into concurrently.
            tail = self._refs[-1][0] if self._refs else None
            if tail is not None and tail.pool is not None \
                    and tail.capacity > DEFAULT_BLOCK_SIZE \
                    and tail.left_space >= max_bytes // 4:
                blk = tail
            else:
                blk = (self._pool or default_block_pool()).allocate(max_bytes)
        else:
            blk = self._write_block(min_space=512)
        space = min(blk.left_space, max_bytes)
        nread = sock.recv_into(blk.view(blk.size, space), space)
        if nread > 0:
            self._append_ref(blk, blk.size, nread)
            blk.size += nread
            self._size += nread
        return nread


class IOBufAppender:
    """Amortized fast appender for many small writes (≈ IOBufAppender)."""

    def __init__(self, buf: Optional[IOBuf] = None):
        self.buf = buf if buf is not None else IOBuf()
        self._pending: List[bytes] = []
        self._pending_size = 0

    def append(self, data: BytesLike) -> None:
        if isinstance(data, str):
            data = data.encode("utf-8")
        self._pending.append(bytes(data))
        self._pending_size += len(data)
        if self._pending_size >= DEFAULT_BLOCK_SIZE:
            self.flush()

    def flush(self) -> IOBuf:
        if self._pending:
            self.buf.append(b"".join(self._pending))
            self._pending.clear()
            self._pending_size = 0
        return self.buf


class IOBufReader:
    """Sequential reader over an IOBuf without consuming it.

    Keeps a (ref_index, offset_in_ref) cursor so reading a buffer in chunks
    is O(total_bytes), not O(n^2).  The underlying IOBuf must not be
    mutated while a reader is in use.
    """

    def __init__(self, buf: IOBuf):
        self._buf = buf
        self._pos = 0
        self._ref_idx = 0
        self._ref_off = 0

    def read(self, n: int) -> bytes:
        n = min(n, self._buf._size - self._pos)
        if n <= 0:
            return b""
        out = bytearray(n)
        got = 0
        refs = self._buf._refs
        while got < n:
            blk, off, ln = refs[self._ref_idx]
            avail = ln - self._ref_off
            take = min(avail, n - got)
            src = blk.view(off + self._ref_off, take)
            out[got : got + take] = src
            got += take
            self._ref_off += take
            if self._ref_off >= ln:
                self._ref_idx += 1
                self._ref_off = 0
        self._pos += n
        return bytes(out)

    def remaining(self) -> int:
        return self._buf.size - self._pos


class LazyAttachmentsMixin:
    """Lazily-constructed request/response attachment IOBufs for the
    client and server controllers.  A sync unary call usually replaces
    both attachments, so eager construction cost ~2 IOBufs/call on the
    echo hot path.  Subclasses declare ``_req_att``/``_resp_att`` in
    their ``__slots__`` and initialize both to None."""

    __slots__ = ()

    @property
    def request_attachment(self) -> "IOBuf":
        a = self._req_att
        if a is None:
            a = self._req_att = IOBuf()
        return a

    @request_attachment.setter
    def request_attachment(self, v: "IOBuf") -> None:
        self._req_att = v

    @property
    def response_attachment(self) -> "IOBuf":
        a = self._resp_att
        if a is None:
            a = self._resp_att = IOBuf()
        return a

    @response_attachment.setter
    def response_attachment(self, v: "IOBuf") -> None:
        self._resp_att = v
