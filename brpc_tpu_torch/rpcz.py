"""rpcz — per-RPC span tracing.

≈ brpc's src/brpc/span.h:47-84 + builtin/rpcz_service.cpp:
spans are rate-limited samples (bvar Collector, collector.h:57-72) so
tracing can stay always-on; trace context (trace_id/span_id/parent)
rides EVERY wire protocol — the tpu_std meta TLVs, a W3C
``traceparent`` header on HTTP/1.1, and the same header over gRPC/h2
(HPACK) — so one trace id explains a whole cross-protocol call tree.
Storage is an in-memory bounded store (trace-id indexed) browsable at
/rpcz (the reference uses leveldb — deliberately simpler here, same
capability surface: recent spans by id/time, annotations); the
cross-process stitcher lives in rpcz_stitch.py.

A copy of ``brpc_tpu/rpcz.py``.  In the port the trace context rides the
tpu_std meta TLVs and, through the traceparent helpers here, the HTTP/1.1
and gRPC lanes; the store is read through :func:`global_span_store` and
:func:`browse_persisted`, and over HTTP on the builtin portal's
``/rpcz`` page (``server/builtin``).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from .butil.fast_rand import fast_rand
from .butil.flags import define_flag, get_flag, any_value
from .bvar.collector import Collected, Collector

define_flag("enable_rpcz", True, "collect per-RPC spans", any_value)
define_flag("rpcz_keep_spans", 2048, "max spans kept in memory",
            lambda v: v > 0)
define_flag("rpcz_max_samples_per_second", 1000,
            "rpcz sampling budget (traced calls always record)",
            lambda v: int(v) >= 0)
define_flag("rpcz_dir", "",
            "also persist spans to sqlite files here (one per process) "
            "— post-mortem time-range browsing survives the process; "
            "'' = in-memory only", any_value)
define_flag("rpcz_db_max_spans", 200_000,
            "per-process cap on persisted spans (oldest trimmed)",
            lambda v: int(v) > 0)

# span ids must stay unique ACROSS processes for stitched traces (a
# child span in another rank links back by parent_span_id alone): seed
# the per-process counter into a random 48-bit window instead of 1, so
# two ranks' sequences virtually never collide while ids stay compact
# enough for sqlite/JSON round trips
_span_seq = itertools.count((fast_rand() & ((1 << 47) - 1)) | (1 << 47))


class Span(Collected):
    __slots__ = ("trace_id", "span_id", "parent_span_id", "full_method",
                 "remote_side", "received_us", "start_us", "end_us",
                 "error_code", "request_size", "response_size",
                 "annotations", "is_server", "forced", "mono_ns")

    def __init__(self, full_method: str, trace_id: int = 0,
                 parent_span_id: int = 0, is_server: bool = True):
        # an explicit trace context means someone is following THIS
        # call: it must never be sampled out, whatever the budget
        self.forced = bool(trace_id)
        self.trace_id = trace_id or fast_rand()
        self.span_id = next(_span_seq)
        self.parent_span_id = parent_span_id
        self.full_method = full_method
        self.remote_side = ""
        self.received_us = int(time.time() * 1e6)
        self.start_us = self.received_us
        self.end_us = 0
        # CLOCK_MONOTONIC anchor: comparable across processes on ONE
        # host (same clock since boot) — the stitcher uses it to flag
        # wall-clock skew instead of silently mis-ordering spans
        self.mono_ns = time.monotonic_ns()
        self.error_code = 0
        self.request_size = 0
        self.response_size = 0
        self.annotations: List[tuple] = []
        self.is_server = is_server

    def annotate(self, text: str) -> None:
        """≈ TRACEPRINTF (src/brpc/traceprintf.h)."""
        self.annotations.append((int(time.time() * 1e6), text))

    def finish(self, error_code: int = 0) -> None:
        self.end_us = int(time.time() * 1e6)
        self.error_code = error_code
        global_span_store().add(self)

    @property
    def latency_us(self) -> int:
        return (self.end_us or int(time.time() * 1e6)) - self.received_us

    def describe(self) -> Dict:
        return {
            "trace_id": f"{self.trace_id:x}",
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "method": self.full_method,
            "remote": self.remote_side,
            "received_us": self.received_us,
            "start_us": self.start_us,
            "end_us": self.end_us,
            "latency_us": self.latency_us,
            "mono_ns": self.mono_ns,
            "error_code": self.error_code,
            "request_size": self.request_size,
            "response_size": self.response_size,
            "side": "server" if self.is_server else "client",
            "annotations": [
                {"us": ts, "text": txt} for ts, txt in self.annotations],
        }


class SpanStore:
    """Bounded recent-span store, indexed by trace id; optionally
    mirrored to a per-process sqlite file for post-mortem browsing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: Deque[Span] = deque()
        # trace_id -> spans, maintained on add/evict: by_trace is the
        # stitcher's hot query and must not scan the whole deque
        self._by_trace: Dict[int, List[Span]] = {}
        # rate limiter: at most ~1000 spans/s retained (collector.h role)
        self._collector = Collector()
        self._pending: List[Span] = []      # awaiting the disk flusher
        self._flusher: Optional[threading.Thread] = None

    def add(self, span: Span) -> None:
        if not span.forced and not self._collector.submit(span):
            return                        # over the rate budget: sampled out
        self._collector.drain()           # used purely as a rate limiter
        keep = get_flag("rpcz_keep_spans", 2048)
        with self._lock:
            self._spans.append(span)
            self._by_trace.setdefault(span.trace_id, []).append(span)
            while len(self._spans) > keep:
                old = self._spans.popleft()
                lst = self._by_trace.get(old.trace_id)
                if lst is not None:
                    # eviction order matches insertion order, so the
                    # evictee is (almost always) the list head
                    if lst and lst[0] is old:
                        lst.pop(0)
                    else:
                        try:
                            lst.remove(old)
                        except ValueError:
                            pass
                    if not lst:
                        del self._by_trace[old.trace_id]
            if get_flag("rpcz_dir", ""):
                self._pending.append(span)
                if self._flusher is None:
                    self._flusher = threading.Thread(
                        target=_flush_loop, args=(self,),
                        name="rpcz-flush", daemon=True)
                    self._flusher.start()

    def take_pending(self) -> List[Span]:
        with self._lock:
            out, self._pending = self._pending, []
            return out

    def recent(self, limit: int = 100) -> List[Span]:
        with self._lock:
            return list(self._spans)[-limit:]

    def by_trace(self, trace_id: int, limit: int = 0) -> List[Span]:
        with self._lock:
            spans = list(self._by_trace.get(trace_id, ()))
        return spans[-limit:] if limit else spans

    def flush_now(self) -> None:
        """Synchronously persist anything pending (tests, shutdown)."""
        _flush_pending(self)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._by_trace.clear()
            self._pending.clear()


# -- persistence (≈ span.cpp:306-319's leveldb pair: the reference keys
# spans by time in one db and by id in another; sqlite gives both
# indexes in one file, and a dead rank's file stays browsable) ---------

_FLUSH_PERIOD_S = 1.0


def _to_i64(v: int) -> int:
    """uint64 ids (fast_rand trace ids) -> sqlite's signed INTEGER.
    Without this, ~half of all random trace ids overflow the bind and
    the whole flush batch rolls back."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _from_i64(v: int) -> int:
    return v + (1 << 64) if v < 0 else v


def _db_path() -> Optional[str]:
    import os
    d = str(get_flag("rpcz_dir", "") or "")
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    return f"{d}/rpcz.{os.getpid()}.db"


def _open_db(path: str):
    import sqlite3
    # check_same_thread=False: the flusher thread owns steady-state
    # writes, but flush_now() (portal requests, shutdown) flushes from
    # other threads — _db_lock serializes all access
    db = sqlite3.connect(path, timeout=5.0, check_same_thread=False)
    db.execute("""CREATE TABLE IF NOT EXISTS spans (
        received_us INTEGER, trace_id INTEGER, span_id INTEGER,
        parent_span_id INTEGER, method TEXT, remote TEXT,
        latency_us INTEGER, error_code INTEGER, request_size INTEGER,
        response_size INTEGER, side TEXT, annotations TEXT)""")
    db.execute("CREATE INDEX IF NOT EXISTS idx_time "
               "ON spans (received_us)")
    db.execute("CREATE INDEX IF NOT EXISTS idx_trace ON spans (trace_id)")
    return db


# cached writer connection: reopening + CREATE + COUNT(*) per 1s flush
# is pure overhead — keep the handle and track the row count
# incrementally (COUNT runs once per open)
_db_lock = threading.Lock()
_db_conn = None
_db_conn_path: Optional[str] = None
_db_rows = 0


def _flush_pending(store: "SpanStore") -> None:
    """Persist pending spans.  Never raises and never kills the caller:
    a broken rpcz_dir drops the batch (logged) instead of growing
    _pending forever."""
    global _db_conn, _db_conn_path, _db_rows
    import json as _json
    try:
        path = _db_path()
    except OSError:
        from .butil.logging_util import LOG
        LOG.exception("rpcz_dir unusable; dropping pending spans")
        store.take_pending()
        return
    if path is None:
        store.take_pending()      # dir cleared while spans were pending
        return
    spans = store.take_pending()
    if not spans:
        return
    try:
        with _db_lock:
            if _db_conn is None or _db_conn_path != path:
                if _db_conn is not None:
                    _db_conn.close()
                _db_conn = _open_db(path)
                _db_conn_path = path
                (_db_rows,) = _db_conn.execute(
                    "SELECT COUNT(*) FROM spans").fetchone()
            db = _db_conn
            with db:
                db.executemany(
                    "INSERT INTO spans VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
                    [(s.received_us, _to_i64(s.trace_id),
                      _to_i64(s.span_id), _to_i64(s.parent_span_id),
                      s.full_method, s.remote_side,
                      s.latency_us, s.error_code, s.request_size,
                      s.response_size,
                      "server" if s.is_server else "client",
                      _json.dumps(s.annotations)) for s in spans])
                _db_rows += len(spans)
                cap = int(get_flag("rpcz_db_max_spans", 200_000))
                if _db_rows > cap:
                    db.execute(
                        "DELETE FROM spans WHERE rowid IN (SELECT rowid "
                        "FROM spans ORDER BY received_us LIMIT ?)",
                        (_db_rows - cap,))
                    _db_rows = cap
    except Exception:                      # persistence must never take
        from .butil.logging_util import LOG  # down the serving path
        LOG.exception("rpcz flush failed")
        with _db_lock:
            if _db_conn is not None:
                try:
                    _db_conn.close()
                except Exception:
                    pass
            _db_conn = None
            _db_conn_path = None


def _flush_loop(store: "SpanStore") -> None:
    while True:
        time.sleep(_FLUSH_PERIOD_S)
        try:
            _flush_pending(store)
        except Exception:          # belt-and-braces: the flusher thread
            pass                   # must survive anything


def browse_persisted(start_us: int = 0, end_us: int = 0,
                     limit: int = 100, trace_id: int = 0,
                     rpcz_dir: str = "") -> List[Dict]:
    """Time-range browse across every rpcz db in the directory —
    including files left by DEAD processes (the post-mortem story the
    in-memory store cannot tell).  Results newest-first."""
    import glob
    import json as _json
    import os
    import sqlite3
    d = str(rpcz_dir or get_flag("rpcz_dir", "") or "")
    if not d or not os.path.isdir(d):
        return []
    where, args = [], []
    if start_us:
        where.append("received_us >= ?")
        args.append(int(start_us))
    if end_us:
        where.append("received_us <= ?")
        args.append(int(end_us))
    if trace_id:
        where.append("trace_id = ?")
        args.append(_to_i64(int(trace_id)))
    q = "SELECT * FROM spans"
    if where:
        q += " WHERE " + " AND ".join(where)
    q += " ORDER BY received_us DESC LIMIT ?"
    out: List[Dict] = []
    for path in sorted(glob.glob(os.path.join(d, "rpcz.*.db"))):
        db = None
        try:
            db = sqlite3.connect(path, timeout=5.0)
            db.row_factory = sqlite3.Row
            for row in db.execute(q, args + [int(limit)]):
                rec = dict(row)
                rec["trace_id"] = f"{_from_i64(rec['trace_id']):x}"
                rec["span_id"] = _from_i64(rec["span_id"])
                rec["parent_span_id"] = _from_i64(rec["parent_span_id"])
                try:
                    rec["annotations"] = [
                        {"us": ts, "text": txt}
                        for ts, txt in _json.loads(rec["annotations"])]
                except (ValueError, TypeError):
                    rec["annotations"] = []
                rec["source_db"] = os.path.basename(path)
                out.append(rec)
        except sqlite3.Error:
            continue                       # unreadable/corrupt db: skip
        finally:
            if db is not None:             # close even when a mid-query
                db.close()                 # error skips to the except
    out.sort(key=lambda r: r["received_us"], reverse=True)
    return out[:limit]


_store: Optional[SpanStore] = None
_store_lock = threading.Lock()


def global_span_store() -> SpanStore:
    global _store
    with _store_lock:
        if _store is None:
            _store = SpanStore()
        return _store


def rpcz_enabled() -> bool:
    return bool(get_flag("enable_rpcz", True))


# flag-cached mirror of rpcz_enabled for the per-request fast paths
# (one list read instead of a flags-table lookup per call); resynced by
# the watcher on every live flip
from .butil.flags import watch_flag as _watch_flag

_rpcz_live = [bool(get_flag("enable_rpcz", True))]
_watch_flag("enable_rpcz",
            lambda v: _rpcz_live.__setitem__(0, bool(v)))


def passive_server_span(full_method: str, remote_side) -> Optional["Span"]:
    """The slim fast template's span gate for UNTRACED requests: same
    budgeted passive sampling as :func:`start_server_span`, with the
    enabled check flag-cached (traced requests never reach this — the
    shim routes them through the full gate, which always records)."""
    if not _rpcz_live[0] or not _passive_sample_gate():
        return None
    span = Span(full_method, trace_id=0, parent_span_id=0,
                is_server=True)
    span.remote_side = str(remote_side or "")
    return span


_sample_window = [0.0, 0, 1000]    # window start (s), taken, budget


def _passive_sample_gate() -> bool:
    """One-per-second-window budget check shared by every passive
    sampling entry point — True takes one slot from this second's
    ``rpcz_max_samples_per_second`` budget."""
    import time as _time
    w = _sample_window
    now = _time.monotonic()
    if now - w[0] >= 1.0:
        w[0] = now
        w[1] = 0
        w[2] = int(get_flag("rpcz_max_samples_per_second", 1000))
    if w[1] >= w[2]:
        return False
    w[1] += 1
    return True


def start_server_span(full_method: str, meta, remote_side) -> Optional[Span]:
    """Called by the dispatch layer per request (None when disabled or
    over the sampling budget).  Like the reference's Collector-budgeted
    rpcz sampling (brpc's src/bvar/collector.cpp), at most
    ``rpcz_max_samples_per_second`` spans are recorded per second so
    tracing never dominates the request path; traced calls (non-zero
    trace_id) always record."""
    if not rpcz_enabled():
        return None
    if not meta.trace_id and not _passive_sample_gate():
        return None
    span = Span(full_method, trace_id=meta.trace_id,
                parent_span_id=meta.span_id, is_server=True)
    span.remote_side = str(remote_side or "")
    return span


def start_client_span(full_method: str, trace_id: int,
                      parent_span_id: int = 0) -> Optional[Span]:
    """Client-side span for an EXPLICITLY traced call (cntl.trace_id
    set): forced spans always record, so the caller's half of the round
    trip shows up next to the server span it parents.  Untraced calls
    return None — passive client sampling would put span churn on the
    latency fast lanes, and the server side already samples those."""
    if not rpcz_enabled() or not trace_id:
        return None
    return Span(full_method, trace_id=trace_id,
                parent_span_id=parent_span_id, is_server=False)


def backdate_span(span: Optional[Span], recv_mono_ns) -> None:
    """Stamp a slim-lane span with the ENGINE's receive timestamp: the
    C++ loop records CLOCK_MONOTONIC ns when it parses the frame — the
    same clock as Python's ``time.monotonic_ns()`` — and passes it
    through the shim call.  ``received_us`` moves back by the elapsed
    monotonic delta, so the span covers the native queueing/batching
    delay instead of starting at shim entry; ``start_us`` keeps the
    shim-entry time, making the queueing visible as received->start.
    The monotonic anchor moves to the engine timestamp with it."""
    if span is None or not recv_mono_ns:
        return
    delta_us = (time.monotonic_ns() - recv_mono_ns) // 1000
    if delta_us > 0:
        span.received_us -= delta_us
        span.mono_ns = recv_mono_ns


# -- W3C trace-context mapping (https://www.w3.org/TR/trace-context/) --
#
# HTTP/1.1 and gRPC/h2 carry the trace context as a ``traceparent``
# header instead of meta TLVs:
#
#     traceparent: 00-<32 hex trace-id>-<16 hex parent-id>-<2 hex flags>
#
# The internal model is 64-bit ids (fast_rand), so the 128-bit wire
# trace-id keeps our id in its LOW 64 bits; a foreign 128-bit id from
# an external W3C peer is truncated to its low 64 bits consistently on
# every hop, which preserves linkage within this system.

def format_traceparent(trace_id: int, span_id: int) -> str:
    """``traceparent`` header value for an outbound call: the caller's
    span id rides as the parent-id field (exactly the tpu_std meta's
    trace_id/span_id pair re-spelled)."""
    return (f"00-{trace_id & ((1 << 128) - 1):032x}"
            f"-{span_id & ((1 << 64) - 1):016x}-01")


def parse_traceparent(value) -> Optional[tuple]:
    """``(trace_id, parent_span_id)`` from a traceparent header value
    (str or bytes), or None when malformed.  Unknown versions are
    accepted if the first four fields parse (per spec: treat like 00)."""
    if value is None:
        return None
    if isinstance(value, (bytes, bytearray, memoryview)):
        try:
            value = bytes(value).decode("ascii")
        except UnicodeDecodeError:
            return None
    parts = value.strip().split("-")
    if len(parts) < 4 or len(parts[0]) != 2 or len(parts[1]) != 32 \
            or len(parts[2]) != 16:
        return None
    try:
        int(parts[0], 16)
        trace = int(parts[1], 16)
        parent = int(parts[2], 16)
    except ValueError:
        return None
    if trace == 0:
        return None                    # all-zero trace-id is invalid
    return trace & ((1 << 64) - 1), parent
