// Native IO engine — the C++ data plane under the Python framework.
//
// Role parity with the reference's C++ core runtime (SURVEY.md §2.4:
// Socket/EventDispatcher/InputMessenger): epoll event loops, connection
// ownership, tpu_std frame cutting and vectored writes all run in C++
// with the GIL released; Python is entered once per complete message
// (service dispatch), receiving zero-copy buffer views.
//
// Capability mapping (fresh design, not a port):
//   - EventDispatcher (event_dispatcher_epoll.cpp:59)  -> Loop (epoll)
//   - Socket read path (socket.cpp:1994 DoRead)        -> Conn::on_readable
//     with direct-into-message-buffer reads for large bodies
//   - InputMessenger cut loop (input_messenger.cpp:329) -> parse_frames
//   - Socket write queue + KeepWrite (socket.cpp:1575) -> Conn write
//     queue drained by the owning loop, EPOLLOUT-armed on EAGAIN
//
// Protocols cut natively: tpu_std ("TRPC") frames and ICI ack ("TICI")
// frames.  Anything else on a native-engine port is handed to Python as
// an UNKNOWN event (the bridge answers/fails it) — the full
// multi-protocol port lives on the Python path.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <unordered_set>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// NativeBuf: a Python object owning a malloc'd region, exposing the
// buffer protocol so Python/IOBuf can view it zero-copy.
// ---------------------------------------------------------------------------

typedef struct {
  PyObject_HEAD char* data;
  Py_ssize_t size;
  Py_ssize_t cap;   // allocation size (power-of-2 bucket)
} NativeBuf;

// Free-list of data blocks, bucketed by power-of-2 size.  All
// nativebuf_new/dealloc call sites hold the GIL, which serializes access
// — no lock needed.  Avoids mmap/munmap page-fault churn on the >128KB
// allocations glibc would otherwise hand straight back to the kernel
// (1MB attachment echoes pay ~256 soft faults per call without this).
constexpr int kBuckets = 24;                    // up to 8MB cached
constexpr int kPerBucket = 4;
static char* g_freelist[kBuckets][kPerBucket];
static int g_freecount[kBuckets];

static int bucket_of(Py_ssize_t size) {
  Py_ssize_t cap = 4096;
  int b = 12;
  while (cap < size && b < 63) { cap <<= 1; b++; }
  return b;
}

static void NativeBuf_dealloc(NativeBuf* self) {
  int b = bucket_of(self->cap);
  if (self->data && (Py_ssize_t(1) << b) == self->cap && b < kBuckets
      && g_freecount[b] < kPerBucket) {
    g_freelist[b][g_freecount[b]++] = self->data;
  } else {
    free(self->data);
  }
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static int NativeBuf_getbuffer(NativeBuf* self, Py_buffer* view, int flags) {
  return PyBuffer_FillInfo(view, (PyObject*)self, self->data, self->size, 0,
                           flags);
}

static Py_ssize_t NativeBuf_length(NativeBuf* self) { return self->size; }

static PyBufferProcs NativeBuf_as_buffer = {
    (getbufferproc)NativeBuf_getbuffer,
    nullptr,
};

static PySequenceMethods NativeBuf_as_sequence = {
    (lenfunc)NativeBuf_length,
};

static PyTypeObject NativeBufType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

static NativeBuf* nativebuf_new(Py_ssize_t size) {
  NativeBuf* b = PyObject_New(NativeBuf, &NativeBufType);
  if (!b) return nullptr;
  int bk = bucket_of(size);
  Py_ssize_t cap;
  if (bk < kBuckets) {
    cap = Py_ssize_t(1) << bk;     // cacheable: power-of-2 bucket
    if (g_freecount[bk] > 0)
      b->data = g_freelist[bk][--g_freecount[bk]];
    else
      b->data = (char*)malloc(cap);
  } else {
    cap = size > 0 ? size : 1;     // beyond cache: exact, no 2x waste
    b->data = (char*)malloc(cap);
  }
  b->size = size;
  b->cap = cap;
  if (!b->data) {
    Py_DECREF(b);
    PyErr_NoMemory();
    return nullptr;
  }
  return b;
}

// ---------------------------------------------------------------------------
// Engine internals
// ---------------------------------------------------------------------------

constexpr uint32_t kHeaderSize = 12;  // "TRPC" + u32 body + u32 meta
constexpr uint32_t kAckHeader = 8;    // "TICI" + u32 count
constexpr size_t kInbufCap = 128 * 1024;
constexpr uint32_t kMaxBody = 512u * 1024u * 1024u;
// slim-lane attachment threshold: requests carrying more attachment
// bytes than this take the classic Python dispatch (the documented
// "attachments over threshold" fallback; large frames already fall
// back via the direct-read path)
constexpr uint32_t kSlimAttCap = 16 * 1024;

// dispatch event codes (Python side mirrors these)
enum : int {
  EV_OPEN = 0,
  EV_MESSAGE = 1,   // tpu_std frame: obj = NativeBuf(meta+payload), extra = meta_size
  EV_ACK = 2,       // TICI frame:    obj = NativeBuf(desc ids),     extra = count
  EV_UNKNOWN = 3,   // obj = NativeBuf(first bytes); conn will be closed
  EV_CLOSE = 4,
  EV_STREAM = 5,    // TSTR frame: obj = NativeBuf(flags+dest+len+payload)
  EV_HTTP = 6,      // one COMPLETE raw HTTP/1.x message (headers+body
                    // as received); Python parses + dispatches
  EV_BYTES = 7,     // passthrough gulp for protocols the engine does
                    // not cut (h2/gRPC, redis, thrift, ...): Python's
                    // InputMessenger registry cuts + dispatches
};

struct WriteItem {
  Py_buffer view;        // holds a ref on the producing Python object,
                         // UNLESS owned_str is set (view.obj is nullptr
                         // then)
  size_t offset = 0;
  std::string* owned_str = nullptr;  // moved-in native burst buffer —
                                     // deleted on completion, no copy
};

// ---------------------------------------------------------------------------
// Native telemetry (always-on): per-lane fixed-bucket histograms,
// reason-coded fallback counters, burst/writev distributions and loop
// busy accounting.  All hot-path captures are PLAIN per-loop-thread
// counters (each Loop owns a LoopTelemetry; only its own thread writes
// it) — no atomics, no locks on the request path.  engine.telemetry()
// reads them racily from a GIL-holding thread and sums across loops:
// a snapshot may be a few increments stale, never torn in a way that
// matters (monotonic uint64 on x86).  This is the "RPC Considered
// Harmful" discipline: per-stage timing of the messaging pipeline, so
// the fastest lanes stay inspectable in production.
// ---------------------------------------------------------------------------

static int64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

// log2 buckets: value v (us, or a count for the size distributions)
// lands in bucket bit_length(v) — bucket 0 holds zeros, bucket i
// covers [2^(i-1), 2^i).  20 buckets span 1us .. ~0.5s and 1 .. 512K
// items, the whole plausible range of both uses.
constexpr int kHistBuckets = 20;

struct Hist {
  uint64_t b[kHistBuckets] = {};
  uint64_t count = 0;
  uint64_t sum = 0;          // us (latency hists) or items (size hists)
  void add(uint64_t v) {
    int i = 0;
    uint64_t x = v;
    while (x > 0 && i < kHistBuckets - 1) { x >>= 1; i++; }
    b[i]++;
    count++;
    sum += v;
  }
};

// server-lane index for the per-stage histograms (LANE_STREAM is the
// kind-5 stream-OPEN path: the unary call that negotiates a stream,
// batched through flush_py_batch exactly like the kind-3 items)
enum Lane : int { LANE_RAW = 0, LANE_SLIM = 1, LANE_HTTP = 2,
                  LANE_STREAM = 3, kLanes = 4 };
static const char* kLaneNames[kLanes] = {"raw", "slim", "http", "stream"};

// Reason-coded fallbacks: every branch that routes a request OFF a
// native lane (kind 2/3 tpu_std, kind 4 HTTP) and onto the classic
// Python path increments exactly one of these.  The Python-side
// scatter_call screening keeps its own named counters
// (client/fast_call.py) — client lanes never reach the engine loops.
// CONTRACT (machine-checked): kFbNames below and the bridge's
// FB_REASON_NAMES mirror must track this enum member-for-member, and
// every name needs a test pin — tests/test_torch_native_engine.py
// (tools/check/contracts.py) gates all three in tier-1.
enum FbReason : int {
  FB_RPC_DISPATCH_OFF = 0,   // native dispatch gated off (rpc_dump live)
  FB_RPC_META_TAG,           // controller-tier TLV / malformed meta
  FB_RPC_NO_METHOD,          // svc.mth not registered with the engine
  FB_RPC_ATT_OVER_CAP,       // kind-3 attachment above kSlimAttCap
  FB_RPC_LARGE_FRAME,        // kind-2/3 frame on the direct-read path
  FB_RPC_TRACE_RAW,          // explicit trace on a kind-0/1/2 method:
                             // only the Python path can record a span
                             // there (the kind-3/4 slim lanes carry
                             // trace context through the shim instead)
  FB_RPC_SHM_LANE,           // frame carries shm data-plane TLVs
                             // (offer/accept/release/descriptor): the
                             // Python dispatch owns ring negotiation
                             // and descriptor resolution
  FB_HTTP_SLIM_OFF,          // slim HTTP lane gated off
  FB_HTTP_MALFORMED_LINE,    // request line missing tokens
  FB_HTTP_VERSION,           // version not exactly "HTTP/1.1\r\n"
  FB_HTTP_NO_ROUTE,          // METHOD+path not registered
  FB_HTTP_EXPECT,            // Expect header present
  FB_HTTP_UPGRADE,           // Upgrade header present
  FB_HTTP_CONNECTION,        // Connection other than keep-alive
  FB_HTTP_TRANSFER_ENCODING, // Transfer-Encoding framing
  FB_HTTP_BAD_HEADER,        // LF-only endings / colon-less line
  FB_HTTP_LARGE_BODY,        // over-inbuf Content-Length (direct read)
  FB_HTTP_CHUNK_STREAM,      // over-inbuf chunked body (stream FSM)
  FB_HTTP_LAME_DUCK,         // server draining: the classic lane owns
                             // the response so it carries the
                             // x-lame-duck / Connection: close signal
  FB_REASONS
};
static const char* kFbNames[FB_REASONS] = {
    "rpc_dispatch_off",   "rpc_meta_tag",     "rpc_no_method",
    "rpc_att_over_cap",   "rpc_large_frame",  "rpc_trace_raw_lane",
    "rpc_shm_lane",
    "http_slim_off",
    "http_malformed_line", "http_version",    "http_no_route",
    "http_expect",        "http_upgrade",     "http_connection",
    "http_transfer_encoding", "http_bad_header", "http_large_body",
    "http_chunk_stream",  "http_lame_duck",
};

// per-route fallback reasons the header scan can attribute to a
// resolved route (the route lookup precedes the header walk)
enum RouteFb : int {
  RFB_EXPECT = 0, RFB_UPGRADE, RFB_CONNECTION, RFB_TE, RFB_BAD_HEADER,
  kRouteFb
};
static const char* kRouteFbNames[kRouteFb] = {
    "http_expect", "http_upgrade", "http_connection",
    "http_transfer_encoding", "http_bad_header",
};

// Kind-5 streaming-lane fallbacks: every TSTR frame or stream-open
// request that declines the native lane and rides the Python streaming
// path instead lands in exactly one of these (closed enum — no
// "unknown" bucket, same discipline as FbReason).  CONTRACT
// (machine-checked): kStreamFbNames and the Python mirror
// (server/stream_slim.STREAM_FB_NAMES) must track this enum
// member-for-member — tools/check gates all three in tier-1.
enum StreamFb : int {
  SFB_NO_SHIM = 0,     // no kind-5 capability: stream shim never
                       // registered (lane flag off, or the server has
                       // no eligible unary methods)
  SFB_NON_INLINE,      // server runs user code off the loop
                       // (usercode_inline false): the open must ride
                       // the fiber path, so the whole stream stays on
                       // the Python lane
  SFB_COMPRESSED,      // stream-open request carries the compress TLV:
                       // only the classic path can decompress
  SFB_CHUNK_OVERSIZE,  // TSTR frame (or open) too large for the burst
                       // batch: the direct-read path delivers it to
                       // the Python streaming lane whole
  SFB_DRAIN,           // server draining: the classic path owns the
                       // ELAMEDUCK rejection + lame-duck TLV
  SFB_UNREGISTERED,    // TSTR frame for a stream the engine does not
                       // own (pure-Python streams, closed streams,
                       // forged ids) — the Python dispatch's
                       // socket-binding guard arbitrates
  SFB_REASONS
};
static const char* kStreamFbNames[SFB_REASONS] = {
    "stream_no_shim",   "stream_non_inline",  "stream_compressed",
    "stream_chunk_oversize", "stream_drain",  "stream_unregistered",
};

// Data-plane copy accounting: every place the engine COPIES payload
// bytes between buffers (the wire recv/writev themselves are not
// copies in this ledger — they are the transfer) increments a stage
// counter, so the zero-copy invariant of the eligible paths is
// ASSERTED by tests instead of claimed by comments (ISSUE 6).  Spans
// under kDpFloor are framing/bookkeeping, not data-plane traffic.
enum DpStage : int {
  DP_INGEST = 0,    // wire bytes duplicated into a delivery buffer
  DP_SHIM,          // payload/attachment materialized for a shim call
  DP_SERIALIZE,    // response payload copied into the native burst
  DP_INGEST_SPILL,  // buffered-read prefix of a large frame moved into
                    // its direct-read buffer at the rendezvous switch —
                    // bounded by the 128KB inbuf per message, the same
                    // first-segments-inline concession brpc's RDMA
                    // rendezvous makes; kept out of the zero-copy
                    // eligibility assert (tests pin the OTHER stages)
  kDpStages
};
static const char* kDpNames[kDpStages] = {"ingest", "shim", "serialize",
                                          "ingest_spill"};
constexpr size_t kDpFloor = 4096;

struct LoopTelemetry {
  uint64_t fallbacks[FB_REASONS] = {};
  uint64_t sfallbacks[SFB_REASONS] = {};  // kind-5 streaming lane
  uint64_t dp_copies[kDpStages] = {};
  uint64_t dp_copy_bytes[kDpStages] = {};
  Hist queue[kLanes];   // frame parse -> batched shim entry (us)
  Hist shim[kLanes];    // shim entry -> item complete (us)
  Hist resid[kLanes];   // frame parse -> response build done (us)
  Hist burst;           // batched items per flush_py_batch
  Hist stream_burst;    // stream chunks per batched delivery entry
  uint64_t stream_chunks_in = 0;   // DATA/CLOSE frames consumed natively
  uint64_t stream_feedbacks = 0;   // credit feedback frames consumed
                                   // natively (zero GIL entries)
  Hist wiov;            // iovs coalesced per writev in conn_flush
  uint64_t busy_ns = 0; // loop body time (callbacks, parsing, writes)
  uint64_t idle_ns = 0; // time blocked in epoll_wait (busy-poll spin
                        // included: spinning is waiting, not work)
  uint64_t polls = 0;   // epoll_wait returns
  uint64_t spin_polls = 0;  // busy-poll spins that harvested events
                            // before the blocking epoll_wait
  uint64_t accepts = 0;     // conns accepted AND pinned by this loop
  uint64_t frames = 0;      // complete messages parsed by this loop
  uint64_t handoffs = 0;    // cross-loop handoff nodes consumed
  uint64_t wq_hwm = 0;  // write-queue items high-water mark
  uint64_t inbuf_hwm = 0;  // inbuf fill high-water mark (bytes)
};

struct Loop;
static inline void dp_copy(Loop* lp, DpStage stage, size_t n);

// Incremental chunked-body accumulation (ADVICE r5 #4): a chunked
// request outgrowing the inbuf streams its RAW bytes (headers + chunk
// framing, exactly as received — the EV_HTTP contract) into `acc`
// while this FSM tracks chunk boundaries across reads, so the message
// is bounded by http_max_body instead of the 128KB inbuf.  The phase
// walk mirrors http_walk_chunks below — a change to either MUST be
// mirrored in the other.
struct ChunkState {
  std::string acc;       // raw message bytes so far
  size_t cap = 0;        // header length + http_max_body at entry
  int phase = 0;         // 0 size-line, 1 data, 2 CR, 3 LF, 4 trailer
  size_t remaining = 0;  // data bytes left in the current chunk
  size_t line = 0;       // chars accumulated in the current line
  char first = 0;        // first char of the current trailer line
  char szline[34];       // current chunk-size line (hex + extensions)
};

struct Conn {
  int fd = -1;
  uint64_t id = 0;
  struct Loop* loop = nullptr;
  std::string peer_ip;
  int peer_port = 0;
  // close-after-flush: when closing is set the conn lingers until the
  // write queue drains (EPOLLOUT-armed) or this deadline passes —
  // short writev/EAGAIN must not truncate a final response
  int64_t close_deadline = 0;
  // HTTP sniff commitment (ADVICE r5 #5): 0 = prefix matched a method
  // token but the request line has not yet shown " HTTP/1." — the conn
  // must not be held by the HTTP cutter forever; 1 = committed.
  uint8_t http_state = 0;
  int64_t sniff_deadline = 0;   // armed while uncommitted bytes wait
  ChunkState* chunk = nullptr;  // in-flight over-inbuf chunked message

  // read state: fixed buffer, no zero-fill churn (vector::resize would
  // memset 64KB per recv)
  char* inbuf = nullptr;    // malloc(kInbufCap) on accept
  size_t in_start = 0;      // consumed prefix
  size_t in_end = 0;        // valid bytes end
  NativeBuf* msg = nullptr; // in-flight large message (direct reads)
  size_t msg_filled = 0;
  uint32_t msg_meta = 0;
  int msg_kind = EV_MESSAGE;
  // first bytes matched no natively-cut protocol: every subsequent
  // gulp goes to Python whole (EV_BYTES) for the protocol registry
  bool passthrough = false;

  // write state (mutex: send() is called from arbitrary Python threads)
  std::mutex wmu;
  std::deque<WriteItem> wq;
  bool want_out = false;
  bool closing = false;
  bool dead = false;
  // coalesced cross-loop flush pending: CAS false->true gates the
  // handoff post (one node per conn per loop iteration); the owning
  // loop resets it before flushing so a racing send re-posts
  std::atomic<bool> flush_queued{false};
  // frames parsed on this conn (owning-loop writes; racy reads from
  // telemetry are fine) — the loop-pinning tests key on it
  uint64_t frames = 0;

  // native-dispatch responses accumulated during the current read burst
  // (loop thread only); flushed as ONE owned WriteItem before any
  // Python dispatch on this conn and at burst end — a pipelined batch
  // of echo responses costs one writev
  std::string native_out;
};

// Cross-loop completion handoff: a mutex-free MPSC Treiber stack per
// loop.  Producers (GIL-holding completion threads — fiber completions,
// scatter/fan-out results, close requests — and foreign accept loops)
// CAS-push a node and wake the consumer loop; the consumer exchanges
// the whole head once per iteration, reverses for FIFO, and processes
// without ever taking a lock.  This replaces the round-9
// mutex+vector pending_out/pending_close pair: with one loop per core
// a contended mutex on every cross-loop response serializes exactly
// the path per-core sharding exists to unshare.
enum HandoffOp : int { HO_FLUSH = 0, HO_CLOSE = 1, HO_ADOPT = 2 };

struct HandoffNode {
  HandoffNode* next;
  uint64_t id;
  int op;
};

struct Loop {
  int epfd = -1;
  int wakefd = -1;
  std::thread thr;
  struct EngineImpl* eng = nullptr;
  int index = 0;
  // sharded-accept listener owned by THIS loop (SO_REUSEPORT path);
  // -1 = no own listener (single shared fd on loop 0, rr placement)
  int listen_fd = -1;
  // connections owned by this loop
  std::unordered_map<uint64_t, Conn*> conns;
  // cross-loop handoff inbox (lock-free MPSC; see HandoffNode above)
  std::atomic<HandoffNode*> handoff_head{nullptr};
  // conns in close-after-flush linger (owned-loop state, no lock)
  std::vector<uint64_t> lingering;
  // conns holding a sniffed-HTTP prefix not yet committed by the
  // " HTTP/1." marker (owned-loop state; swept on the epoll tick)
  std::vector<uint64_t> sniffing;
  // Py_buffer releases deferred until we hold the GIL anyway
  std::vector<Py_buffer> decrefs;
  std::mutex decref_mu;
  // always-on counters/histograms, written ONLY by this loop's thread
  LoopTelemetry tel;
};

static inline void dp_copy(Loop* lp, DpStage stage, size_t n) {
  if (n >= kDpFloor) {
    lp->tel.dp_copies[stage]++;
    lp->tel.dp_copy_bytes[stage] += (uint64_t)n;
  }
}

// A method the engine answers entirely in C++ (no GIL, no Python
// dispatch) — the tpu-native analogue of the reference's C++ builtin
// services.  Registered pre-listen; the map is read-only afterwards.
//
// kind 3 is the SLIM SERVER LANE for full (cntl, request) methods: the
// engine scans the meta, batches eligible requests, and enters Python
// ONCE per read burst calling
// handler(payload, att, cid, conn_id, dom, nonce, recv_ns, trace,
// timeout_ms, tenant) —
// trace is None or the request's (trace_id, span_id, parent_id);
// timeout_ms is TLV 13's remaining budget (None = absent; 0 =
// expired at arrival); tenant is None or TLV 22's identity bytes
// (per-tenant fair admission) —
// admission,
// MethodStatus accounting and rpcz span sampling live in that shim
// (server/slim_dispatch.py).  A buffer return is framed
// natively; None means the shim escalated to the classic Python
// completion (async methods, sampled spans, compressed/streamed
// responses) and the response leaves via Engine_send instead.
struct NativeMethod {
  int kind = 0;                  // 0 = echo, 1 = const, 2 = py raw,
                                 // 3 = slim full-method dispatch
  std::string const_data;             // kind=1 response payload
  PyObject* handler = nullptr;        // kind=2/3 Python callable
  // kind-5 STREAM-OPEN shim (server/stream_slim.py): a kind-3 method's
  // stream-negotiating variant — requests carrying the stream TLVs
  // dispatch here instead of `handler`, batched in the same burst
  PyObject* stream_handler = nullptr;
  std::atomic<uint64_t> count{0};     // answered natively
  std::atomic<uint64_t> errors{0};    // EREQUEST answers (malformed att)
  // kind-5 lane accounting (stream opens ride LANE_STREAM hists; the
  // hist-count == handled+errors invariant holds per lane)
  std::atomic<uint64_t> stream_opens{0};
  std::atomic<uint64_t> stream_errors{0};
  // per-method fallback attribution (reasons where the method is
  // already resolved); atomics: several loops may hit one method
  std::atomic<uint64_t> fb_att_over_cap{0};
  std::atomic<uint64_t> fb_large_frame{0};
  std::atomic<uint64_t> fb_trace_raw{0};
  std::atomic<uint64_t> fb_stream_open{0};  // opens declined to Python
};

// One kind-5 native stream: the engine owns the WRITE-side credit
// window (produced vs the peer's consumption feedback, both accounted
// here in C++ — the Python producer only ever blocks on `cv`) and
// consumes inbound TSTR frames for `sid` natively.  Registered by the
// stream-open shim after stream_accept; looked up per frame by the
// owning loop; shared_ptr so an unregister/conn-close cannot free it
// under a writer mid-wait.
struct NativeStream {
  uint64_t sid = 0;        // OUR stream id (inbound frames' dest)
  uint64_t peer_sid = 0;   // peer's id (outbound frames' dest)
  uint64_t conn_id = 0;    // pinned connection (forged-frame guard)
  uint64_t window = 0;     // peer's advertised receive window (bytes)
  std::mutex mu;
  std::condition_variable cv;
  uint64_t produced = 0;          // bytes written by our side
  uint64_t remote_consumed = 0;   // peer feedback (absolute)
  bool closed = false;
};

// An HTTP route the engine dispatches through the SLIM HTTP LANE
// (kind 4): the request line + headers of an eligible HTTP/1.1
// message are parsed in C++, the per-route shim
// (server/http_slim.py) runs admission/MethodStatus/rpcz in the
// burst's single batched GIL entry, and the engine serializes the
// (status, headers, body) return natively into the burst's coalesced
// writev.  Registered pre-listen; read-only afterwards.
struct HttpRoute {
  PyObject* handler = nullptr;
  std::atomic<uint64_t> count{0};     // requests through the slim lane
  std::atomic<uint64_t> errors{0};    // shim raised / bad return shape
  // per-route fallback attribution (header-scan rejects on a resolved
  // route); indexed by RouteFb
  std::atomic<uint64_t> fb[kRouteFb] = {};
};

// One buffered-path request bound for a kind=2/3 Python handler, or a
// kind-4 slim-HTTP request (hroute set).  The payload/dom/conn/query/
// ctype pointers aim into the connection's inbuf and are valid only
// until parse_frames returns — every exit path flushes the batch first.
struct PyRawItem {
  NativeMethod* m;
  uint64_t cid;
  const char* payload;   // body past the meta (payload ++ attachment);
                         // kind 4: the HTTP request body
  size_t plen;           // total body-after-meta length
  uint32_t att;          // attachment tail size
  const char* dom = nullptr;    // kind 3: request's ici-domain bytes
  uint32_t dom_len = 0;
  const char* conn = nullptr;   // kind 3: request's conn-nonce bytes
  uint32_t conn_len = 0;
  // kind 3: trace context TLVs (trace/span/parent) — handed to the
  // shim so traced requests stay on the slim lane
  uint64_t trace_id = 0;
  uint64_t span_id = 0;
  uint64_t parent_id = 0;
  // kind 3: remaining-deadline ms (TLV 13) — the shim anchors it at
  // t_parse and sheds queue-expired requests (deadline plane);
  // timeout_present distinguishes an explicit on-wire 0 (expired at
  // arrival) from an absent deadline
  uint32_t timeout_ms = 0;
  bool timeout_present = false;
  // kind 3: tenant identity bytes (TLV 22) — the shim's admission
  // stage keys per-tenant fair admission off it (overload plane)
  const char* ten = nullptr;
  uint32_t ten_len = 0;
  // kind-5 stream-open fields (stream_id != 0 selects the lane): the
  // client's stream id (TLV 12) and its advertised receive window
  // (TLV 14) — the shim accepts the stream, answers the grant in the
  // response meta, and registers the stream with the engine
  uint64_t stream_id = 0;
  uint32_t stream_window = 0;
  // kind-4 slim-HTTP fields (hroute != nullptr selects the lane)
  HttpRoute* hroute = nullptr;
  const char* query = nullptr;  // bytes after '?' in the request target
  uint32_t qlen = 0;
  const char* ctype = nullptr;  // Content-Type header value (raw)
  uint32_t ctlen = 0;
  const char* attsz = nullptr;  // x-rpc-attachment-size value (raw)
  uint32_t attszlen = 0;
  const char* tp = nullptr;     // traceparent header value (raw)
  uint32_t tplen = 0;
  const char* dl = nullptr;     // x-deadline-ms header value (raw) —
  uint32_t dllen = 0;           // the shim sheds queue-expired requests
  const char* xt = nullptr;     // x-tenant header value (raw) — the
  uint32_t xtlen = 0;           // shim's fair-admission tenant key
  // telemetry: CLOCK_MONOTONIC ns at frame parse (comparable with
  // Python's time.monotonic_ns — the shims backdate rpcz spans with it)
  int64_t t_parse = 0;
};

// One inbound stream chunk (DATA/CLOSE/RST) bound for the batched
// Python delivery: payload aims into the connection's inbuf and is
// valid only until parse_frames returns — every exit path flushes the
// stream batch alongside the PyRawItem batch.
struct StreamItem {
  uint64_t sid;          // OUR stream id (the frame's dest)
  int flags;
  const char* payload;
  size_t len;
};

struct EngineImpl {
  PyObject* dispatch = nullptr;  // callable(event, conn_id, obj, extra)
  std::vector<Loop*> loops;
  int listen_fd = -1;
  std::atomic<uint64_t> next_conn{1};
  std::atomic<bool> stopping{false};
  std::atomic<int> rr{0};
  // id -> loop index, guarded (send() resolves conns cross-thread)
  std::mutex cmu;
  std::unordered_map<uint64_t, Conn*> by_id;
  std::atomic<uint64_t> nmessages{0}, bytes_in{0}, bytes_out{0};
  // native dispatch: "svc\0mth" -> handler.  Mutated only before
  // listen(); loops read it lock-free.  The bool gates at runtime
  // (live rpc_dump capture must see every request -> Python path).
  std::unordered_map<std::string, NativeMethod*> native_methods;
  std::atomic<bool> native_dispatch{false};
  // slim HTTP lane: "METHOD\0path" -> route.  Mutated only before
  // listen(); loops read it lock-free.  The bool gates at runtime
  // (tests/bench flip it to compare lanes in one process).
  std::unordered_map<std::string, HttpRoute*> http_routes;
  std::atomic<bool> http_slim{false};
  // pre-encoded local ici-domain TLV (empty when ici is off): kind-3
  // responses answer a request's domain exchange with it, exactly like
  // rpc_dispatch._domain_tlv on the classic fast path.  Set by the
  // bridge before listen(); read-only afterwards.
  std::string domain_tlv;
  bool started = false;
  // optional busy-poll spin (us) before each blocking epoll_wait: the
  // loop burns its core polling for new events instead of paying the
  // sleep/wake scheduler round trip — the latency-tail knob
  // (engine_busy_poll_us flag; runtime-settable, relaxed reads)
  std::atomic<int> busy_poll_us{0};
  // true = the loops run on Python-created threads (bridge calls
  // run_loop from threading.Thread).  A thread whose datastack
  // carries a resident Python frame never munmaps its chunk, so the
  // per-wake Python dispatch skips the mmap + page-fault (~14us on
  // this box) that a frameless C thread pays on EVERY cold eval entry.
  bool external_loops = false;
  // HTTP body limit (mirrors protocol/http.py max_body_size; the
  // bridge syncs it at listen time and on live flag flips)
  std::atomic<size_t> http_max_body{64u * 1024u * 1024u};
  // operability plane: lame-duck drain mode (set_lame_duck).  0 = off;
  // 1 = accept pause only (listeners disarmed, fds kept for a hot-
  // restart successor); 2 = pause + SIGNAL: natively-built tpu_std
  // responses carry the lame-duck TLV (tag 23) and new kind-4 HTTP
  // matches decline to the classic lane (which owns the x-lame-duck /
  // Connection: close headers).
  std::atomic<int> lame_duck{0};
  // optional per-burst epilogue: called ONCE after each flush_py_batch
  // item loop (GIL already held) so the Python shims can flush
  // per-burst aggregated accounting (admitted counts, method samples)
  // instead of paying locked counters per item
  PyObject* burst_end = nullptr;
  // ---- kind-5 streaming lane ----
  // native stream table: OUR stream id -> stream state.  Mutated by
  // GIL-holding Python threads (register/unregister) and conn_destroy;
  // loops look frames up under the same short lock.  nstreams is the
  // lock-free existence check on the per-frame hot path.
  std::mutex smu;
  std::unordered_map<uint64_t, std::shared_ptr<NativeStream>> streams;
  std::atomic<size_t> nstreams{0};
  // 0 = lane off (no capability), 1 = on, 2 = declined because the
  // server runs user code off the loop (usercode_inline false) — the
  // bridge sets it so the fallback reason names WHY, not just that
  std::atomic<int> stream_mode{0};
  // batched chunk delivery: ONE call per read burst with every
  // DATA/CLOSE chunk of every stream on the loop —
  // callable(list[(sid, flags, payload_bytes)])
  PyObject* stream_chunks = nullptr;
  // write-side counters (producers run on arbitrary Python threads,
  // so these are engine-level atomics, unlike the per-loop counters)
  std::atomic<uint64_t> s_chunks_out{0};
  std::atomic<uint64_t> s_chunk_bytes_out{0};
  std::atomic<uint64_t> s_credit_stalls{0};   // writes that had to wait
  std::atomic<uint64_t> s_write_batches{0};   // stream_write_many calls
};

static int64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000 + ts.tv_nsec / 1000000;
}

static inline void count_msg(EngineImpl* eng, Loop* lp, Conn* c) {
  eng->nmessages++;
  lp->tel.frames++;
  c->frames++;
}

// close-after-flush bound: a conn that cannot drain its write queue to
// a slow reader within this window is torn down anyway (≈ the
// reference's lingering close)
constexpr int64_t kCloseLingerMs = 5000;

static void flush_decrefs_locked_gil(Loop* lp) {
  std::vector<Py_buffer> local;
  {
    std::lock_guard<std::mutex> g(lp->decref_mu);
    local.swap(lp->decrefs);
  }
  for (auto& v : local) PyBuffer_Release(&v);
}

static void queue_decref(Loop* lp, Py_buffer* v) {
  std::lock_guard<std::mutex> g(lp->decref_mu);
  lp->decrefs.push_back(*v);
}

// release a completed item's backing.  Owned blocks need no GIL; Python
// views either release inline (gil_held) or defer via the loop's queue.
static void complete_item(Loop* lp, WriteItem& it, bool gil_held) {
  if (it.owned_str) {
    delete it.owned_str;
    it.owned_str = nullptr;
    return;
  }
  if (gil_held)
    PyBuffer_Release(&it.view);
  else
    queue_decref(lp, &it.view);
}

static void loop_wake(Loop* lp) {
  uint64_t one = 1;
  ssize_t r = write(lp->wakefd, &one, 8);
  (void)r;
}

// push one handoff node onto lp's MPSC stack and wake it.  Safe from
// any thread; the release CAS publishes the node's fields to the
// consumer's acquire exchange.
static void loop_post(Loop* lp, uint64_t id, int op) {
  HandoffNode* n = new (std::nothrow) HandoffNode{nullptr, id, op};
  if (!n) return;                       // OOM: drop; linger/close sweeps
  HandoffNode* h = lp->handoff_head.load(std::memory_order_relaxed);
  do {
    n->next = h;
  } while (!lp->handoff_head.compare_exchange_weak(
      h, n, std::memory_order_release, std::memory_order_relaxed));
  loop_wake(lp);
}

// one complete message parsed on lp for conn c — the single site the
// engine-wide, per-loop and per-conn (loop-pinning) counters share
static inline void count_msg(EngineImpl* eng, Loop* lp, Conn* c);

static void call_dispatch(EngineImpl* eng, Loop* lp, int event, uint64_t id,
                          PyObject* obj /* stolen or null */, long extra) {
  PyGILState_STATE gs = PyGILState_Ensure();
  flush_decrefs_locked_gil(lp);
  PyObject* o = obj ? obj : Py_None;
  if (!obj) Py_INCREF(Py_None);
  PyObject* r = PyObject_CallFunction(eng->dispatch, "iKNl", event,
                                      (unsigned long long)id, o, extra);
  if (!r) {
    PyErr_WriteUnraisable(eng->dispatch);
  } else {
    Py_DECREF(r);
  }
  PyGILState_Release(gs);
}

static void conn_destroy(EngineImpl* eng, Loop* lp, Conn* c, bool notify) {
  if (c->dead) return;
  c->dead = true;
  epoll_ctl(lp->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  {
    // serialize with Engine_send's inline writev (it holds wmu): the fd
    // must not be closed — and possibly reused by a new accept — while a
    // sender thread is mid-write on it
    std::lock_guard<std::mutex> g(c->wmu);
    close(c->fd);
    c->fd = -1;
  }
  lp->conns.erase(c->id);
  {
    std::lock_guard<std::mutex> g(eng->cmu);
    eng->by_id.erase(c->id);
  }
  if (eng->nstreams.load(std::memory_order_acquire) != 0) {
    // kind-5 streams pinned to this conn: close (producers blocked on
    // credit wake with -2) and drop from the table — the Python-side
    // Stream teardown rides the EV_CLOSE socket release as before
    std::lock_guard<std::mutex> g(eng->smu);
    for (auto it = eng->streams.begin(); it != eng->streams.end();) {
      if (it->second->conn_id == c->id) {
        {
          std::lock_guard<std::mutex> g2(it->second->mu);
          it->second->closed = true;
          it->second->cv.notify_all();
        }
        it = eng->streams.erase(it);
      } else {
        ++it;
      }
    }
    eng->nstreams.store(eng->streams.size(), std::memory_order_release);
  }
  // free pending writes + in-flight message under the GIL
  PyGILState_STATE gs = PyGILState_Ensure();
  {
    std::lock_guard<std::mutex> g(c->wmu);
    for (auto& it : c->wq) complete_item(lp, it, /*gil_held=*/true);
    c->wq.clear();
  }
  Py_XDECREF((PyObject*)c->msg);
  c->msg = nullptr;
  flush_decrefs_locked_gil(lp);
  PyGILState_Release(gs);
  if (notify) call_dispatch(eng, lp, EV_CLOSE, c->id, nullptr, 0);
  free(c->inbuf);
  delete c->chunk;
  delete c;
}

// try to flush the write queue; returns false on fatal error
static bool conn_flush(Loop* lp, Conn* c) {
  std::unique_lock<std::mutex> g(c->wmu);
  if (c->wq.size() > lp->tel.wq_hwm) lp->tel.wq_hwm = c->wq.size();
  while (!c->wq.empty()) {
    struct iovec iov[64];
    int n = 0;
    for (auto it = c->wq.begin(); it != c->wq.end() && n < 64; ++it, ++n) {
      iov[n].iov_base = (char*)it->view.buf + it->offset;
      iov[n].iov_len = it->view.len - it->offset;
    }
    lp->tel.wiov.add((uint64_t)n);
    ssize_t w = writev(c->fd, iov, n);
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        if (!c->want_out) {
          c->want_out = true;
          struct epoll_event ev;
          // a lingering (close-after-flush) conn stops reading: new
          // requests after close are ignored and a level-triggered
          // EPOLLIN on unread peer bytes would spin the loop
          ev.events = (c->closing ? 0u : (uint32_t)EPOLLIN) | EPOLLOUT;
          ev.data.u64 = c->id;
          epoll_ctl(lp->epfd, EPOLL_CTL_MOD, c->fd, &ev);
        }
        return true;
      }
      if (errno == EINTR) continue;
      return false;
    }
    lp->eng->bytes_out += (uint64_t)w;
    size_t left = (size_t)w;
    while (left > 0 && !c->wq.empty()) {
      WriteItem& it = c->wq.front();
      size_t avail = it.view.len - it.offset;
      if (left >= avail) {
        left -= avail;
        complete_item(lp, it, /*gil_held=*/false);
        c->wq.pop_front();
      } else {
        it.offset += left;
        left = 0;
      }
    }
  }
  if (c->want_out) {
    c->want_out = false;
    struct epoll_event ev;
    ev.events = EPOLLIN;
    ev.data.u64 = c->id;
    epoll_ctl(lp->epfd, EPOLL_CTL_MOD, c->fd, &ev);
  }
  if (c->closing) return false;  // flushed everything; close now
  return true;
}

// ---------------------------------------------------------------------------
// Native dispatch: registered echo-class methods answered entirely in
// C++ — no GIL, no Python objects, responses coalesced per read burst.
// The tpu-native analogue of the reference's built-in C++ services and
// its 200-300ns handler discipline (docs/cn/benchmark.md:57).
// ---------------------------------------------------------------------------

struct MetaScan {
  uint64_t cid = 0;
  uint32_t att = 0;
  const char* svc = nullptr;
  uint32_t svc_len = 0;
  const char* mth = nullptr;
  uint32_t mth_len = 0;
  // tag 15/17 (ici domain / conn nonce): the raw kinds ignore them
  // (lane contract); the SLIM lane (kind 3) forwards them to the shim
  // (peer-domain learning / nonce pinning) and answers the domain
  // exchange with the engine's cached local-domain TLV
  const char* dom = nullptr;
  uint32_t dom_len = 0;
  const char* conn = nullptr;
  uint32_t conn_len = 0;
  // tags 9/10/11 (trace/span/parent): the SLIM lane (kind 3) forwards
  // the context to the shim so traced requests STAY on the fast path;
  // kinds 0/1/2 fall back (reason-coded) — no span machinery there
  uint64_t trace_id = 0;
  uint64_t span_id = 0;
  uint64_t parent_id = 0;
  // tag 13 (remaining-deadline ms): the SLIM lane forwards it to the
  // shim, which sheds the request when — measured against t_parse —
  // the budget expired in queue (deadline plane); raw kinds ignore it
  // (no controller to enforce or propagate it).  timeout_present
  // tells an explicit on-wire 0 apart from an absent tag.
  uint32_t timeout_ms = 0;
  bool timeout_present = false;
  // tags 18-21 (shm ring offer/accept/release/descriptor): ring
  // negotiation and descriptor resolution live in Python — the frame
  // takes the classic path under the NAMED rpc_shm_lane reason
  bool shm = false;
  // tag 22 (tenant identity): the SLIM lane forwards it to the shim's
  // admission stage (per-tenant fair admission, overload plane); raw
  // kinds ignore it — same lane contract as the deadline tag 13
  const char* ten = nullptr;
  uint32_t ten_len = 0;
  // tags 12/14 (stream id / stream receive window): a stream-OPEN
  // request — the kind-5 STREAM lane dispatches it to the method's
  // stream shim; every other kind declines under a named StreamFb
  // reason (the Python lane owns the open there)
  uint64_t stream_id = 0;
  uint32_t stream_window = 0;
  // tag 2 (compress): scanned only so a compressed stream open gets
  // its NAMED kind-5 reason — every lane still declines compressed
  // requests to the classic path (only it can decompress)
  bool compressed = false;
};

// Mirror of native_bridge._scan_request_meta: collect cid/att/svc/mth
// plus the trace context (9/10/11 — slim lane carries it through),
// tolerate timeout/ici-domain/conn-nonce (13/15/17), flag the shm
// data-plane tags (18-21), bail on anything controller-tier
// (compress, errors, auth, stream, desc).  CONTRACT (machine-checked):
// every case label and its `ln !=` width guard must match
// protocol/meta.py's _T_* registry — tools/check gates it in tier-1.
static bool scan_request_meta(const char* p, size_t len, MetaScan* out) {
  size_t off = 0;
  while (off < len) {
    if (off + 5 > len) return false;
    uint8_t tag = (uint8_t)p[off];
    uint32_t ln;
    memcpy(&ln, p + off + 1, 4);
    off += 5;
    if (ln > len || off + ln > len) return false;
    switch (tag) {
      case 1:
        if (ln != 8) return false;
        memcpy(&out->cid, p + off, 8);
        break;
      case 2:
        if (ln != 1) return false;
        out->compressed = true;  // named screening only — every native
        break;                   // kind still declines compressed frames
      case 3:
        if (ln != 4) return false;
        memcpy(&out->att, p + off, 4);
        break;
      case 4:
        out->svc = p + off;
        out->svc_len = ln;
        break;
      case 5:
        out->mth = p + off;
        out->mth_len = ln;
        break;
      case 9:
        if (ln != 8) return false;
        memcpy(&out->trace_id, p + off, 8);
        break;
      case 10:
        if (ln != 8) return false;
        memcpy(&out->span_id, p + off, 8);
        break;
      case 11:
        if (ln != 8) return false;
        memcpy(&out->parent_id, p + off, 8);
        break;
      case 12:
        if (ln != 8) return false;
        memcpy(&out->stream_id, p + off, 8);   // stream open: kind-5
        break;                                 // lane (or named decline)
      case 13:
        if (ln != 4) return false;
        memcpy(&out->timeout_ms, p + off, 4);  // remaining-deadline ms:
        out->timeout_present = true;
        break;              // safe for every lane; enforced by kind 3
      case 14:
        if (ln != 4) return false;
        memcpy(&out->stream_window, p + off, 4);  // open handshake:
        break;                                    // peer's recv window
      case 15:
        out->dom = p + off;
        out->dom_len = ln;
        break;
      case 17:
        out->conn = p + off;
        out->conn_len = ln;
        break;
      case 18:
      case 19:
      case 20:
      case 21:
        out->shm = true;    // shm data plane: classic path, named
        break;              // reason (ring state lives in Python)
      case 22:
        out->ten = p + off;  // tenant identity: enforced by the kind-3
        out->ten_len = ln;   // shim's admission stage; raw kinds ignore
        break;
      default:
        return false;       // controller-tier tag: Python path
    }
    off += ln;
  }
  return out->svc != nullptr && out->mth != nullptr;
}

static NativeMethod* find_native(EngineImpl* eng, const MetaScan& s) {
  std::string key;           // "svc\0mth" — SSO keeps short names heapless
  key.reserve(s.svc_len + 1 + s.mth_len);
  key.append(s.svc, s.svc_len);
  key.push_back('\0');
  key.append(s.mth, s.mth_len);
  auto it = eng->native_methods.find(key);
  return it == eng->native_methods.end() ? nullptr : it->second;
}

// append a success-response frame head (TRPC header + cid TLV +
// optional att TLV + optional extra pre-encoded meta TLVs) for a body
// of plen payload bytes — the single source of the response wire
// layout for both the buffered and the zero-copy (direct-read) native
// paths.  ``extra`` carries the kind-3 domain-exchange answer (the
// cached local ici-domain TLV), appended after the att TLV exactly
// like the classic fast path orders its meta.
// pre-encoded lame-duck TLV (tag 23, u8 1) — MUST mirror meta.py's
// LAME_DUCK_TLV: the drain signal natively-built responses carry
// while the engine is in set_lame_duck mode
static const char kDuckTlv[6] = {0x17, 0x01, 0x00, 0x00, 0x00, 0x01};

static void native_append_head(EngineImpl* eng, std::string& out,
                               uint64_t cid, uint32_t att, size_t plen,
                               const std::string* extra = nullptr) {
  char meta[22];
  uint32_t l8 = 8, l4 = 4;
  meta[0] = 1;
  memcpy(meta + 1, &l8, 4);
  memcpy(meta + 5, &cid, 8);
  uint32_t mlen = 13;
  if (att) {
    meta[13] = 3;
    memcpy(meta + 14, &l4, 4);
    memcpy(meta + 18, &att, 4);
    mlen = 22;
  }
  uint32_t xlen = extra ? (uint32_t)extra->size() : 0;
  uint32_t dlen =
      (eng && eng->lame_duck.load(std::memory_order_relaxed) >= 2) ? 6
                                                                   : 0;
  uint32_t full = mlen + xlen + dlen;
  uint32_t body = full + (uint32_t)plen;
  char hdr[12];
  memcpy(hdr, "TRPC", 4);
  memcpy(hdr + 4, &body, 4);
  memcpy(hdr + 8, &full, 4);
  out.append(hdr, 12);
  out.append(meta, mlen);
  if (xlen) out.append(*extra);
  if (dlen) out.append(kDuckTlv, 6);
}

// append one native response frame (cid + optional att TLV + body bytes)
static void native_respond(Conn* c, uint64_t cid, const char* payload,
                           size_t plen, uint32_t att) {
  native_append_head(c->loop->eng, c->native_out, cid, att, plen);
  if (plen) {
    dp_copy(c->loop, DP_SERIALIZE, plen);
    c->native_out.append(payload, plen);
  }
}

// native error response (cid + error code/text TLVs)
static void native_error(Conn* c, uint64_t cid, int32_t code,
                         const char* text) {
  uint32_t tlen = (uint32_t)strlen(text);
  std::string meta;
  char b[13];
  uint32_t l = 8;
  b[0] = 1;
  memcpy(b + 1, &l, 4);
  memcpy(b + 5, &cid, 8);
  meta.append(b, 13);
  b[0] = 6;
  l = 4;
  memcpy(b + 1, &l, 4);
  memcpy(b + 5, &code, 4);
  meta.append(b, 9);
  b[0] = 7;
  memcpy(b + 1, &tlen, 4);
  meta.append(b, 5);
  meta.append(text, tlen);
  if (c->loop->eng->lame_duck.load(std::memory_order_relaxed) >= 2)
    meta.append(kDuckTlv, 6);   // drain: error frames signal too
  uint32_t body = (uint32_t)meta.size(), mlen = body;
  char hdr[12];
  memcpy(hdr, "TRPC", 4);
  memcpy(hdr + 4, &body, 4);
  memcpy(hdr + 8, &mlen, 4);
  c->native_out.append(hdr, 12);
  c->native_out.append(meta);
}

// defined in the HTTP section below / after this function
static bool native_stage(Conn* c, WriteItem* follow);
static void http_slim_respond(Conn* c, long status, const char* hdr,
                              size_t hlen, const char* body, size_t blen);
static void http_slim_error(Conn* c, const char* text);

// Run one kind-4 slim-HTTP item: call the per-route shim and serialize
// its (status, headers, body) return natively.  Runs under the GIL,
// inside flush_py_batch's single per-burst acquisition.
//
// ORDER GUARD: a shim may complete out-of-band DURING the call
// (progressive heads, fast async finishes) — those writes go through
// engine.send straight into the write queue, so any slim responses
// already accumulated in native_out must be staged into the queue
// FIRST or the pipelined response order breaks (HTTP has no
// correlation id).  Staging is not flushing: the burst still leaves in
// one writev at burst end.
static void http_slim_item(Loop* lp, Conn* c, PyRawItem& it) {
  if (!c->native_out.empty()) native_stage(c, nullptr);
  dp_copy(lp, DP_SHIM, it.plen);
  PyObject* body = PyBytes_FromStringAndSize(it.payload, it.plen);
  PyObject* q = it.query
      ? PyBytes_FromStringAndSize(it.query, it.qlen) : nullptr;
  PyObject* ct = it.ctype
      ? PyBytes_FromStringAndSize(it.ctype, it.ctlen) : nullptr;
  PyObject* asz = it.attsz
      ? PyBytes_FromStringAndSize(it.attsz, it.attszlen) : nullptr;
  PyObject* conn = body ? PyLong_FromUnsignedLongLong(c->id) : nullptr;
  PyObject* rcv = conn
      ? PyLong_FromLongLong((long long)it.t_parse) : nullptr;
  PyObject* tp = it.tp
      ? PyBytes_FromStringAndSize(it.tp, it.tplen) : nullptr;
  PyObject* dl = it.dl
      ? PyBytes_FromStringAndSize(it.dl, it.dllen) : nullptr;
  PyObject* xt = it.xt
      ? PyBytes_FromStringAndSize(it.xt, it.xtlen) : nullptr;
  PyObject* r = nullptr;
  if (body && conn && rcv && (!it.query || q) && (!it.ctype || ct)
      && (!it.attsz || asz) && (!it.tp || tp) && (!it.dl || dl)
      && (!it.xt || xt))
    r = PyObject_CallFunctionObjArgs(it.hroute->handler, body,
                                     q ? q : Py_None, ct ? ct : Py_None,
                                     asz ? asz : Py_None, conn, rcv,
                                     tp ? tp : Py_None,
                                     dl ? dl : Py_None,
                                     xt ? xt : Py_None, nullptr);
  Py_XDECREF(body);
  Py_XDECREF(q);
  Py_XDECREF(ct);
  Py_XDECREF(asz);
  Py_XDECREF(conn);
  Py_XDECREF(rcv);
  Py_XDECREF(tp);
  Py_XDECREF(dl);
  Py_XDECREF(xt);
  if (!r) {
    // shim raised (or OOM building args): answer a plain 500 with the
    // exception text, keeping the keep-alive conn in sync
    char msg[160] = "http slim shim failed";
    PyObject *t, *v, *tb;
    PyErr_Fetch(&t, &v, &tb);
    if (v) {
      PyObject* s = PyObject_Str(v);
      if (s) {
        const char* u = PyUnicode_AsUTF8(s);
        if (u) snprintf(msg, sizeof msg, "%.*s", 150, u);
        Py_DECREF(s);
      }
    }
    PyErr_Clear();
    Py_XDECREF(t); Py_XDECREF(v); Py_XDECREF(tb);
    it.hroute->errors++;
    http_slim_error(c, msg);
    return;
  }
  if (r == Py_None) {
    // completed (or will complete, for async methods) out-of-band
    // through the classic write path
    Py_DECREF(r);
    it.hroute->count++;
    return;
  }
  if (PyTuple_Check(r) && PyTuple_GET_SIZE(r) == 3) {
    long st = PyLong_AsLong(PyTuple_GET_ITEM(r, 0));
    Py_buffer hb = {}, bb = {};
    if ((st == -1 && PyErr_Occurred())
        || PyObject_GetBuffer(PyTuple_GET_ITEM(r, 1), &hb,
                              PyBUF_SIMPLE) != 0
        || PyObject_GetBuffer(PyTuple_GET_ITEM(r, 2), &bb,
                              PyBUF_SIMPLE) != 0) {
      PyErr_Clear();
      if (hb.obj) PyBuffer_Release(&hb);
      Py_DECREF(r);
      it.hroute->errors++;
      http_slim_error(c, "http slim shim returned a bad tuple");
      return;
    }
    http_slim_respond(c, st, (const char*)hb.buf, (size_t)hb.len,
                      (const char*)bb.buf, (size_t)bb.len);
    PyBuffer_Release(&hb);
    PyBuffer_Release(&bb);
    Py_DECREF(r);
    it.hroute->count++;
    return;
  }
  // pre-serialized full response bytes (classic-built escalations that
  // still must keep wire order): append verbatim
  Py_buffer vb = {};
  if (PyObject_GetBuffer(r, &vb, PyBUF_SIMPLE) == 0) {
    c->native_out.append((const char*)vb.buf, (size_t)vb.len);
    PyBuffer_Release(&vb);
    Py_DECREF(r);
    it.hroute->count++;
    return;
  }
  PyErr_Clear();
  Py_DECREF(r);
  it.hroute->errors++;
  http_slim_error(c, "http slim shim returned a non-buffer");
}

// Run one kind-2/3 batched item: call the raw handler / slim shim and
// build the response frame natively.  Runs under the GIL, inside
// flush_py_batch's single per-burst acquisition.
// Payload/attachment reach the handler as bytes copies — the source
// bytes live in the transient inbuf, and a handler that retains its
// argument must never observe them changing.
static void raw_slim_item(Loop* lp, Conn* c, PyRawItem& it) {
    size_t plen = it.plen - it.att;
    // shim args are private bytes copies (transient inbuf source)
    dp_copy(lp, DP_SHIM, plen);
    dp_copy(lp, DP_SHIM, (size_t)it.att);
    PyObject* r = nullptr;
    if (it.m->kind == 3) {
      // slim full-method dispatch: the shim gets BYTES (the classic
      // path hands parse_payload bytes too — handlers may .decode()),
      // plus cid and conn id so escalations can complete classically,
      // plus the request's ici domain/nonce bytes (peer-domain
      // learning / conn-nonce pinning, classic-path semantics), plus
      // the engine's receive timestamp (rpcz spans backdate to it)
      PyObject* pb = PyBytes_FromStringAndSize(it.payload, plen);
      PyObject* ab = nullptr;
      if (pb && it.att)
        ab = PyBytes_FromStringAndSize(it.payload + plen, it.att);
      PyObject* cid = pb ? PyLong_FromUnsignedLongLong(it.cid) : nullptr;
      PyObject* conn = cid ? PyLong_FromUnsignedLongLong(c->id) : nullptr;
      PyObject* dom = it.dom_len
          ? PyBytes_FromStringAndSize(it.dom, it.dom_len) : nullptr;
      PyObject* nonce = it.conn_len
          ? PyBytes_FromStringAndSize(it.conn, it.conn_len) : nullptr;
      PyObject* rcv = conn
          ? PyLong_FromLongLong((long long)it.t_parse) : nullptr;
      // trace context (tags 9/10/11) as one tuple — None on the
      // untraced hot path (no per-call tuple churn there)
      PyObject* tr = nullptr;
      if (it.trace_id)
        tr = Py_BuildValue("(KKK)", (unsigned long long)it.trace_id,
                           (unsigned long long)it.span_id,
                           (unsigned long long)it.parent_id);
      // remaining-deadline ms (None = TLV 13 absent; an int — 0
      // allowed, meaning expired-at-arrival — when present): the shim
      // anchors it at the t_parse timestamp it already receives and
      // sheds queue-expired requests before user code runs
      PyObject* tmo = it.timeout_present
          ? PyLong_FromUnsignedLong(it.timeout_ms) : nullptr;
      // tenant identity (TLV 22): the shim's admission stage keys
      // per-tenant fair admission off it — None on the common
      // untenanted path (no per-call bytes churn there)
      PyObject* ten = it.ten_len
          ? PyBytes_FromStringAndSize(it.ten, it.ten_len) : nullptr;
      if (pb && (it.att == 0 || ab) && cid && conn && rcv
          && (!it.timeout_present || tmo)
          && (it.dom_len == 0 || dom) && (it.conn_len == 0 || nonce)
          && (it.trace_id == 0 || tr) && (it.ten_len == 0 || ten))
        r = PyObject_CallFunctionObjArgs(it.m->handler, pb,
                                         ab ? ab : Py_None, cid, conn,
                                         dom ? dom : Py_None,
                                         nonce ? nonce : Py_None,
                                         rcv, tr ? tr : Py_None,
                                         tmo ? tmo : Py_None,
                                         ten ? ten : Py_None, nullptr);
      Py_XDECREF(pb);
      Py_XDECREF(ab);
      Py_XDECREF(cid);
      Py_XDECREF(conn);
      Py_XDECREF(dom);
      Py_XDECREF(nonce);
      Py_XDECREF(rcv);
      Py_XDECREF(tr);
      Py_XDECREF(tmo);
      Py_XDECREF(ten);
      if (r == Py_None) {
        // handled out-of-band: the shim completed (or will complete)
        // the RPC through the classic Python send path
        Py_DECREF(r);
        it.m->count++;
        return;
      }
    } else {
      // the @raw_method contract hands the handler MEMORYVIEWS (the
      // large-frame Python lane does too — same types either route);
      // they view private bytes copies, so a handler retaining its
      // argument can never observe the transient inbuf changing
      PyObject* pb = PyBytes_FromStringAndSize(it.payload, plen);
      PyObject* pv = pb ? PyMemoryView_FromObject(pb) : nullptr;
      Py_XDECREF(pb);                    // the view keeps its own ref
      PyObject* av = nullptr;
      if (pv && it.att) {
        PyObject* ab = PyBytes_FromStringAndSize(it.payload + plen,
                                                 it.att);
        av = ab ? PyMemoryView_FromObject(ab) : nullptr;
        Py_XDECREF(ab);
      }
      if (pv && (it.att == 0 || av))
        r = PyObject_CallFunctionObjArgs(it.m->handler, pv,
                                         av ? av : Py_None, nullptr);
      Py_XDECREF(pv);
      Py_XDECREF(av);
    }
    if (!r) {
      // handler raised (or OOM building args): answer EINTERNAL with
      // the exception text, like the Python raw lane does
      char msg[160] = "raw handler failed";
      PyObject *t, *v, *tb;
      PyErr_Fetch(&t, &v, &tb);
      if (v) {
        PyObject* s = PyObject_Str(v);
        if (s) {
          const char* u = PyUnicode_AsUTF8(s);
          if (u) snprintf(msg, sizeof msg, "%.*s", 150, u);
          Py_DECREF(s);
        }
      }
      PyErr_Clear();
      Py_XDECREF(t); Py_XDECREF(v); Py_XDECREF(tb);
      it.m->errors++;
      native_error(c, it.cid, 2001 /* EINTERNAL */, msg);
      return;
    }
    PyObject* resp = r;
    PyObject* ratt = nullptr;
    if (PyTuple_Check(r) && PyTuple_GET_SIZE(r) == 2) {
      resp = PyTuple_GET_ITEM(r, 0);
      ratt = PyTuple_GET_ITEM(r, 1);
      if (ratt == Py_None) ratt = nullptr;
    }
    Py_buffer rb = {}, ab = {};
    if (PyObject_GetBuffer(resp, &rb, PyBUF_SIMPLE) != 0
        || (ratt && PyObject_GetBuffer(ratt, &ab, PyBUF_SIMPLE) != 0)) {
      PyErr_Clear();
      if (rb.obj) PyBuffer_Release(&rb);
      Py_DECREF(r);
      it.m->errors++;
      native_error(c, it.cid, 2001,
                   "raw method returned non-bytes");
      return;
    }
    size_t ralen = ab.obj ? (size_t)ab.len : 0;
    // kind 3: a request that carried the ici-domain TLV gets the local
    // domain TLV back in the response meta (the classic fast path's
    // domain-exchange answer, rpc_dispatch._send_response)
    const std::string* extra =
        (it.m->kind == 3 && it.dom_len
         && !lp->eng->domain_tlv.empty())
            ? &lp->eng->domain_tlv : nullptr;
    native_append_head(lp->eng, c->native_out, it.cid, (uint32_t)ralen,
                       (size_t)rb.len + ralen, extra);
    dp_copy(lp, DP_SERIALIZE, (size_t)rb.len);
    dp_copy(lp, DP_SERIALIZE, ralen);
    if (rb.len) c->native_out.append((const char*)rb.buf, rb.len);
    if (ralen) c->native_out.append((const char*)ab.buf, ralen);
    PyBuffer_Release(&rb);
    if (ab.obj) PyBuffer_Release(&ab);
    Py_DECREF(r);
    it.m->count++;
}

// Run one kind-5 STREAM-OPEN item: call the method's stream shim
// (server/stream_slim.py — the interceptor-chain binding) and build
// the grant response natively.  Runs under the GIL, inside
// flush_py_batch's single per-burst acquisition.
//
// Return contract with the shim:
//   (payload, grant_meta_bytes)  success: grant TLVs (stream id +
//                                window) appended to the response meta,
//                                frame built natively
//   bytes / memoryview           success without a stream grant (the
//                                method declined to accept)
//   None                         escalated to the classic completion
static void stream_open_item(Loop* lp, Conn* c, PyRawItem& it) {
  size_t plen = it.plen - it.att;
  dp_copy(lp, DP_SHIM, plen);
  dp_copy(lp, DP_SHIM, (size_t)it.att);
  PyObject* r = nullptr;
  PyObject* pb = PyBytes_FromStringAndSize(it.payload, plen);
  PyObject* ab = nullptr;
  if (pb && it.att)
    ab = PyBytes_FromStringAndSize(it.payload + plen, it.att);
  PyObject* cid = pb ? PyLong_FromUnsignedLongLong(it.cid) : nullptr;
  PyObject* conn = cid ? PyLong_FromUnsignedLongLong(c->id) : nullptr;
  PyObject* dom = it.dom_len
      ? PyBytes_FromStringAndSize(it.dom, it.dom_len) : nullptr;
  PyObject* nonce = it.conn_len
      ? PyBytes_FromStringAndSize(it.conn, it.conn_len) : nullptr;
  PyObject* rcv = conn
      ? PyLong_FromLongLong((long long)it.t_parse) : nullptr;
  PyObject* tr = nullptr;
  if (it.trace_id)
    tr = Py_BuildValue("(KKK)", (unsigned long long)it.trace_id,
                       (unsigned long long)it.span_id,
                       (unsigned long long)it.parent_id);
  PyObject* tmo = it.timeout_present
      ? PyLong_FromUnsignedLong(it.timeout_ms) : nullptr;
  PyObject* ten = it.ten_len
      ? PyBytes_FromStringAndSize(it.ten, it.ten_len) : nullptr;
  PyObject* sid = rcv
      ? PyLong_FromUnsignedLongLong(it.stream_id) : nullptr;
  PyObject* swin = sid
      ? PyLong_FromUnsignedLong(it.stream_window) : nullptr;
  if (pb && (it.att == 0 || ab) && cid && conn && rcv && sid && swin
      && (!it.timeout_present || tmo)
      && (it.dom_len == 0 || dom) && (it.conn_len == 0 || nonce)
      && (it.trace_id == 0 || tr) && (it.ten_len == 0 || ten))
    r = PyObject_CallFunctionObjArgs(it.m->stream_handler, pb,
                                     ab ? ab : Py_None, cid, conn,
                                     dom ? dom : Py_None,
                                     nonce ? nonce : Py_None,
                                     rcv, tr ? tr : Py_None,
                                     tmo ? tmo : Py_None,
                                     ten ? ten : Py_None,
                                     sid, swin, nullptr);
  Py_XDECREF(pb);
  Py_XDECREF(ab);
  Py_XDECREF(cid);
  Py_XDECREF(conn);
  Py_XDECREF(dom);
  Py_XDECREF(nonce);
  Py_XDECREF(rcv);
  Py_XDECREF(tr);
  Py_XDECREF(tmo);
  Py_XDECREF(ten);
  Py_XDECREF(sid);
  Py_XDECREF(swin);
  if (!r) {
    char msg[160] = "stream shim failed";
    PyObject *t, *v, *tb;
    PyErr_Fetch(&t, &v, &tb);
    if (v) {
      PyObject* s = PyObject_Str(v);
      if (s) {
        const char* u = PyUnicode_AsUTF8(s);
        if (u) snprintf(msg, sizeof msg, "%.*s", 150, u);
        Py_DECREF(s);
      }
    }
    PyErr_Clear();
    Py_XDECREF(t); Py_XDECREF(v); Py_XDECREF(tb);
    it.m->stream_errors++;
    native_error(c, it.cid, 2001 /* EINTERNAL */, msg);
    return;
  }
  if (r == Py_None) {
    // escalated: the shim completed (or will complete) the RPC through
    // the classic Python send path (async methods, error shapes,
    // compressed/device responses)
    Py_DECREF(r);
    it.m->stream_opens++;
    return;
  }
  PyObject* resp = r;
  PyObject* grant = nullptr;
  if (PyTuple_Check(r) && PyTuple_GET_SIZE(r) == 2) {
    resp = PyTuple_GET_ITEM(r, 0);
    grant = PyTuple_GET_ITEM(r, 1);
    if (grant == Py_None) grant = nullptr;
  }
  Py_buffer rb = {}, gb = {};
  if (PyObject_GetBuffer(resp, &rb, PyBUF_SIMPLE) != 0
      || (grant && PyObject_GetBuffer(grant, &gb, PyBUF_SIMPLE) != 0)) {
    PyErr_Clear();
    if (rb.obj) PyBuffer_Release(&rb);
    Py_DECREF(r);
    it.m->stream_errors++;
    native_error(c, it.cid, 2001, "stream shim returned non-bytes");
    return;
  }
  // response meta: cid + (domain-exchange answer) + grant TLVs — the
  // classic path orders its meta the same way for escalations
  std::string extra;
  if (it.dom_len && !lp->eng->domain_tlv.empty())
    extra.append(lp->eng->domain_tlv);
  if (gb.obj) extra.append((const char*)gb.buf, (size_t)gb.len);
  native_append_head(lp->eng, c->native_out, it.cid, 0, (size_t)rb.len,
                     extra.empty() ? nullptr : &extra);
  dp_copy(lp, DP_SERIALIZE, (size_t)rb.len);
  if (rb.len) c->native_out.append((const char*)rb.buf, rb.len);
  PyBuffer_Release(&rb);
  if (gb.obj) PyBuffer_Release(&gb);
  Py_DECREF(r);
  it.m->stream_opens++;
}

// Run a burst's worth of batched items (kind-2 raw, kind-3 slim,
// kind-4 slim-HTTP) under ONE GIL acquisition and append their
// responses to c->native_out (shipped by the burst-end native_flush as
// one writev).  This is the amortized GIL crossing of the reference's
// message-batch pattern (input_messenger.cpp:374-394: one bthread per
// batch + flush): a pipelined client pays one Python entry per read
// burst, not one per message.  Telemetry stages captured per item:
// queue (frame parse -> this batch entry), shim (item dispatch time),
// resid (parse -> response build done).
static void flush_py_batch(Loop* lp, Conn* c,
                           std::vector<PyRawItem>& batch,
                           std::vector<StreamItem>& sbatch) {
  if (batch.empty() && sbatch.empty()) return;
  int64_t t_entry = now_ns();
  if (!batch.empty()) lp->tel.burst.add((uint64_t)batch.size());
  PyGILState_STATE gs = PyGILState_Ensure();
  flush_decrefs_locked_gil(lp);
  for (PyRawItem& it : batch) {
    int lane = it.hroute ? LANE_HTTP
                         : (it.stream_id ? LANE_STREAM
                            : (it.m->kind == 3 ? LANE_SLIM : LANE_RAW));
    lp->tel.queue[lane].add(
        (uint64_t)((t_entry - it.t_parse) / 1000));
    int64_t t0 = now_ns();
    if (it.hroute)
      http_slim_item(lp, c, it);   // kind-4 slim-HTTP item
    else if (it.stream_id)
      stream_open_item(lp, c, it); // kind-5 stream-open item
    else
      raw_slim_item(lp, c, it);    // kind-2/3 tpu_std item
    int64_t t1 = now_ns();
    lp->tel.shim[lane].add((uint64_t)((t1 - t0) / 1000));
    lp->tel.resid[lane].add((uint64_t)((t1 - it.t_parse) / 1000));
  }
  if (!sbatch.empty()) {
    // kind-5 chunk delivery: EVERY stream chunk of this read burst —
    // across all streams on the connection — enters Python in this
    // ONE call (the kind-3/4 batching discipline applied to streams)
    lp->tel.stream_burst.add((uint64_t)sbatch.size());
    if (lp->eng->stream_chunks != nullptr) {
      PyObject* list = PyList_New((Py_ssize_t)sbatch.size());
      if (list) {
        bool ok = true;
        for (size_t i = 0; ok && i < sbatch.size(); i++) {
          StreamItem& si = sbatch[i];
          PyObject* t = Py_BuildValue(
              "(Kiy#)", (unsigned long long)si.sid, si.flags,
              si.payload, (Py_ssize_t)si.len);
          if (!t) { ok = false; break; }
          PyList_SET_ITEM(list, (Py_ssize_t)i, t);
        }
        if (ok) {
          PyObject* r = PyObject_CallFunctionObjArgs(
              lp->eng->stream_chunks, list, nullptr);
          if (!r)
            PyErr_WriteUnraisable(lp->eng->stream_chunks);
          else
            Py_DECREF(r);
        } else {
          PyErr_Clear();
        }
        Py_DECREF(list);
      } else {
        PyErr_Clear();
      }
    }
    sbatch.clear();
  }
  if (lp->eng->burst_end != nullptr) {
    // per-burst accounting epilogue (one call per batched GIL entry)
    PyObject* r = PyObject_CallNoArgs(lp->eng->burst_end);
    if (!r)
      PyErr_WriteUnraisable(lp->eng->burst_end);
    else
      Py_DECREF(r);
  }
  PyGILState_Release(gs);
  batch.clear();
}

// Try to answer one complete TRPC frame natively.  body = meta+payload
// (body_len bytes), meta_size from the frame header.  True = handled,
// response appended to c->native_out.  Every False exit increments a
// reason-coded fallback counter on the owning loop — the classic path
// a frame takes instead is never silent.
static bool native_try_handle(EngineImpl* eng, Loop* lp, Conn* c,
                              const char* body, size_t body_len,
                              uint32_t meta_size,
                              std::vector<PyRawItem>* batch = nullptr) {
  if (!eng->native_dispatch.load(std::memory_order_relaxed)) {
    lp->tel.fallbacks[FB_RPC_DISPATCH_OFF]++;
    return false;
  }
  MetaScan s;
  if (!scan_request_meta(body, meta_size, &s)) {
    lp->tel.fallbacks[FB_RPC_META_TAG]++;
    return false;
  }
  if (s.shm) {
    lp->tel.fallbacks[FB_RPC_SHM_LANE]++;
    return false;
  }
  if (s.compressed) {
    // compressed frames always decline (only the classic path can
    // decompress); a compressed stream OPEN earns its kind-5 name
    if (s.stream_id) {
      lp->tel.sfallbacks[SFB_COMPRESSED]++;
      NativeMethod* m0 = find_native(eng, s);
      if (m0) m0->fb_stream_open++;
    } else {
      lp->tel.fallbacks[FB_RPC_META_TAG]++;
    }
    return false;
  }
  NativeMethod* m = find_native(eng, s);
  if (s.stream_id) {
    // kind-5 STREAM OPEN: the unary call negotiating a stream rides
    // the stream shim (interceptor-chain binding).  Every decline is
    // NAMED (closed StreamFb enum); the classic Python lane serves
    // declined opens byte-identically.
    int mode = eng->stream_mode.load(std::memory_order_relaxed);
    int fb = -1;
    if (eng->lame_duck.load(std::memory_order_relaxed) >= 1)
      fb = SFB_DRAIN;         // classic path owns the ELAMEDUCK shape
    else if (mode != 1 || m == nullptr
             || m->stream_handler == nullptr)
      fb = mode == 2 ? SFB_NON_INLINE : SFB_NO_SHIM;
    else if (!batch)
      fb = SFB_CHUNK_OVERSIZE;  // direct-read path: too big to batch
    else if (s.att > kSlimAttCap) {
      lp->tel.fallbacks[FB_RPC_ATT_OVER_CAP]++;
      m->fb_att_over_cap++;
      return false;
    }
    if (fb >= 0) {
      lp->tel.sfallbacks[fb]++;
      if (m) m->fb_stream_open++;
      return false;
    }
    const char* spayload = body + meta_size;
    size_t splen = body_len - meta_size;
    if (s.att > splen) {
      m->stream_errors++;
      native_error(c, s.cid, 1003 /* EREQUEST */,
                   "attachment size exceeds body");
      return true;
    }
    PyRawItem si{};
    si.m = m;
    si.cid = s.cid;
    si.payload = spayload;
    si.plen = splen;
    si.att = s.att;
    si.dom = s.dom;
    si.dom_len = s.dom_len;
    si.conn = s.conn;
    si.conn_len = s.conn_len;
    si.trace_id = s.trace_id;
    si.span_id = s.span_id;
    si.parent_id = s.parent_id;
    si.timeout_ms = s.timeout_ms;
    si.timeout_present = s.timeout_present;
    si.ten = s.ten;
    si.ten_len = s.ten_len;
    si.stream_id = s.stream_id;       // selects the kind-5 lane
    si.stream_window = s.stream_window;
    si.t_parse = now_ns();
    batch->push_back(si);
    return true;
  }
  if (s.stream_window) {
    // window TLV without a stream id: malformed handshake — classic
    // path arbitrates (the pre-stream-lane behavior for tag 14)
    lp->tel.fallbacks[FB_RPC_META_TAG]++;
    return false;
  }
  if (!m) {
    lp->tel.fallbacks[FB_RPC_NO_METHOD]++;
    return false;
  }
  if (s.trace_id && m->kind != 3) {
    // explicit trace on an echo/const/raw method: a span must record,
    // and only the Python path has the span machinery for those lanes
    // (kind 3 carries the context through the shim instead)
    lp->tel.fallbacks[FB_RPC_TRACE_RAW]++;
    m->fb_trace_raw++;
    return false;
  }
  const char* payload = body + meta_size;
  size_t plen = body_len - meta_size;
  if (s.att > plen) {
    m->errors++;
    native_error(c, s.cid, 1003 /* EREQUEST */,
                 "attachment size exceeds body");
    return true;
  }
  PyRawItem pi{};
  pi.m = m;
  pi.cid = s.cid;
  pi.payload = payload;
  pi.plen = plen;
  pi.att = s.att;
  switch (m->kind) {
    case 0:  // echo: payload + attachment unchanged
      native_respond(c, s.cid, payload, plen, s.att);
      break;
    case 1:  // const: fixed payload, no attachment
      native_respond(c, s.cid, m->const_data.data(), m->const_data.size(),
                     0);
      break;
    case 2:  // Python raw handler: batch for one GIL entry per burst
      if (!batch) {               // direct-read path: full Python route
        lp->tel.fallbacks[FB_RPC_LARGE_FRAME]++;
        m->fb_large_frame++;
        return false;
      }
      pi.t_parse = now_ns();
      batch->push_back(pi);
      break;
    case 3:  // slim full-method dispatch: batched like kind 2; over-
             // threshold attachments take the byte-identical Python
             // route (large frames already fall back via direct read)
      if (!batch) {               // direct-read path: full Python route
        lp->tel.fallbacks[FB_RPC_LARGE_FRAME]++;
        m->fb_large_frame++;
        return false;
      }
      if (s.att > kSlimAttCap) {
        lp->tel.fallbacks[FB_RPC_ATT_OVER_CAP]++;
        m->fb_att_over_cap++;
        return false;
      }
      pi.dom = s.dom;
      pi.dom_len = s.dom_len;
      pi.conn = s.conn;
      pi.conn_len = s.conn_len;
      pi.trace_id = s.trace_id;
      pi.span_id = s.span_id;
      pi.parent_id = s.parent_id;
      pi.timeout_ms = s.timeout_ms;
      pi.timeout_present = s.timeout_present;
      pi.ten = s.ten;
      pi.ten_len = s.ten_len;
      pi.t_parse = now_ns();
      batch->push_back(pi);
      break;
    default:
      return false;
  }
  if (m->kind < 2) m->count++;   // kinds 2/3 count at batch flush
  return true;
}

// Stage accumulated native responses: MOVE native_out into the write
// queue as ONE owned WriteItem (no copy), optionally appending a
// follow-up item UNDER THE SAME LOCK — a concurrent Engine_send from a
// GIL-holding thread (stream writes, ack flushes) must never interleave
// its frames between a response's header and its zero-copy body.  No
// flush here: splitting header and body into two writevs wakes the
// blocked peer twice, and on a shared core the first wake costs a
// ~0.5ms scheduler round trip before the body is even written.
static bool native_stage(Conn* c, WriteItem* follow = nullptr) {
  std::string* s = nullptr;
  if (!c->native_out.empty()) {
    s = new (std::nothrow) std::string(std::move(c->native_out));
    if (!s) return false;
    c->native_out.clear();           // moved-from: make state definite
  }
  std::lock_guard<std::mutex> g(c->wmu);
  if (s) {
    WriteItem it;
    memset(&it.view, 0, sizeof(it.view));
    it.view.buf = (void*)s->data();
    it.view.len = (Py_ssize_t)s->size();
    it.owned_str = s;
    c->wq.push_back(it);
  }
  if (follow) c->wq.push_back(*follow);
  return true;
}

// stage + flush: the burst-end path.  False = fatal, destroy conn.
static bool native_flush(Loop* lp, Conn* c) {
  if (c->native_out.empty()) return true;
  if (!native_stage(c)) return false;
  return conn_flush(lp, c);
}

// ---------------------------------------------------------------------------
// HTTP/1.x cutting — the native engine's multi-protocol ingestion step
// (≈ the reference routing every protocol through one C++ cut loop,
// input_messenger.cpp:329).  The engine only CUTS a complete message
// (request line + headers + body, Content-Length or chunked); header
// parsing and dispatch stay in Python (protocol/http.py +
// server/http_dispatch.py) via EV_HTTP.
// ---------------------------------------------------------------------------

constexpr size_t kMaxHttpHeader = 64 * 1024;

// does the buffer start like an HTTP/1.x message?  avail>=4 guaranteed.
static bool http_sniff(const char* p) {
  static const char* kStarts[] = {"GET ",  "POST", "PUT ", "DELE",
                                  "HEAD", "OPTI", "PATC", "CONN",
                                  "TRAC", "HTTP"};
  for (const char* s : kStarts)
    if (memcmp(p, s, 4) == 0) return true;
  return false;
}

// case-insensitive search for a header NAME at line starts inside the
// header block [p, p+len); returns pointer past "name:" or nullptr
static const char* http_find_header(const char* p, size_t len,
                                    const char* name, size_t name_len) {
  const char* end = p + len;
  const char* line = p;
  while (line < end) {
    const char* eol = (const char*)memchr(line, '\n', end - line);
    size_t ll = eol ? (size_t)(eol - line) : (size_t)(end - line);
    if (ll > name_len && line[name_len] == ':'
        && strncasecmp(line, name, name_len) == 0)
      return line + name_len + 1;
    if (!eol) break;
    line = eol + 1;
  }
  return nullptr;
}

// does the header VALUE starting at v (runs to end of line within the
// block ending at blk_end) contain the token, case-insensitively?
static bool http_value_contains(const char* v, const char* blk_end,
                                const char* token, size_t token_len) {
  const char* eol = (const char*)memchr(v, '\n', blk_end - v);
  size_t vlen = (eol ? (size_t)(eol - v) : (size_t)(blk_end - v));
  if (vlen < token_len) return false;
  for (size_t i = 0; i + token_len <= vlen; i++)
    if (strncasecmp(v + i, token, token_len) == 0) return true;
  return false;
}

// walk a chunked body starting at p (first chunk-size line).
// returns consumed length through the terminal CRLF after trailers,
// 0 = need more bytes, -1 = malformed
static ssize_t http_walk_chunks(const char* p, size_t avail) {
  size_t off = 0;
  for (;;) {
    const char* nl = (const char*)memchr(p + off, '\n', avail - off);
    if (!nl) return avail - off > 32 ? -1 : 0;   // size line is short
    size_t line_end = (size_t)(nl - p);
    char* endp = nullptr;
    long sz = strtol(p + off, &endp, 16);
    if (endp == p + off || sz < 0) return -1;
    off = line_end + 1;
    if (sz == 0) {
      // trailers: zero or more header lines, then a blank line
      for (;;) {
        if (off >= avail) return 0;
        const char* tnl = (const char*)memchr(p + off, '\n',
                                              avail - off);
        if (!tnl) return 0;
        size_t tl = (size_t)(tnl - p) - off;
        off = (size_t)(tnl - p) + 1;
        if (tl == 0 || (tl == 1 && p[off - 2] == '\r'))
          return (ssize_t)off;                   // blank line: done
      }
    }
    if (off + (size_t)sz + 2 > avail) return 0;
    off += (size_t)sz;
    if (p[off] != '\r' || p[off + 1] != '\n') return -1;
    off += 2;
  }
}

// try to cut one complete HTTP message at p.  Returns total length,
// 0 = need more bytes, -1 = not/never HTTP or malformed (close),
// -2 = Content-Length body too large for the inbuf: *cl_total carries
// the full message size for the direct-read path,
// -3 = body exceeds max_body (answer 413, then close),
// -4 = incomplete chunked body about to outgrow the inbuf: switch to
// the incremental chunk-stream mode (bounded by max_body, not the
// inbuf).  *hlen_out carries the header-block length (request line
// through the blank line) whenever the headers are complete.
static ssize_t http_cut(const char* p, size_t avail, size_t max_body,
                        size_t* cl_total, size_t* hlen_out) {
  if (!http_sniff(p)) return -1;
  size_t cap = avail < kMaxHttpHeader ? avail : kMaxHttpHeader;
  const char* he = nullptr;
  for (size_t i = 3; i + 1 <= cap; i++) {
    if (p[i] == '\n' && p[i - 1] == '\r' && p[i - 2] == '\n'
        && p[i - 3] == '\r') {
      he = p + i + 1;
      break;
    }
  }
  if (!he) return avail >= kMaxHttpHeader ? -1 : 0;
  size_t hlen = (size_t)(he - p);
  *hlen_out = hlen;
  const char* te = http_find_header(p, hlen, "transfer-encoding", 17);
  if (te != nullptr && http_value_contains(te, he, "chunked", 7)) {
    // chunked framing (any other Transfer-Encoding value keeps CL
    // framing below, matching protocol/http.py's '"chunked" in te')
    ssize_t consumed = http_walk_chunks(he, avail - hlen);
    if (consumed < 0) return -1;
    if (consumed == 0) {
      // total unknown up front: once the accumulating message would
      // outgrow the inbuf, hand it to the incremental chunk FSM
      // (ADVICE r5 #4 — parity with the Python transport's
      // chunked-up-to-max_body acceptance)
      return avail + kMaxHttpHeader >= kInbufCap ? -4 : 0;
    }
    if ((size_t)consumed > max_body) return -3;
    return (ssize_t)(hlen + (size_t)consumed);
  }
  const char* cl = http_find_header(p, hlen, "content-length", 14);
  long clen = 0;
  if (cl != nullptr) {
    char* endp = nullptr;
    clen = strtol(cl, &endp, 10);
    if (endp == cl || clen < 0) return -1;
    // reject from the HEADERS, before buffering a byte of body — an
    // oversized Content-Length must not pin a giant NativeBuf and eat
    // the upload (Python's parse enforces the same max_body limit)
    if ((size_t)clen > max_body) return -3;
  }
  size_t total = hlen + (size_t)clen;
  if (avail >= total) return (ssize_t)total;   // fully buffered: deliver
  if (total > kInbufCap / 2) {
    *cl_total = total;                         // switch to direct read
    return -2;
  }
  return 0;
}

static const char k413[] =
    "HTTP/1.1 413 Payload Too Large\r\n"
    "Content-Length: 0\r\nConnection: close\r\n\r\n";

// does the (complete) request line carry the HTTP-version marker?  A
// 4-byte method-token prefix is not proof of HTTP (redis "GET k\r\n"
// collides) — only " HTTP/1." commits the conn to the HTTP cutter.
static bool line_has_http_marker(const char* p, size_t len) {
  if (len < 8) return false;
  for (size_t i = 0; i + 8 <= len; i++)
    if (memcmp(p + i, " HTTP/1.", 8) == 0) return true;
  return false;
}

// bounds for the sniff commitment: a request line longer than this, or
// one that stalls incomplete past the time budget, is arbitrated by
// the passthrough registry instead of held by the HTTP cutter forever
constexpr size_t kMaxHttpReqLine = 8 * 1024;
constexpr int64_t kSniffBudgetMs = 2000;

// Feed bytes to the incremental chunked-body FSM (mirror of
// http_walk_chunks — keep the two in sync).  Consumes from [d, d+len)
// and reports via *used how many bytes belong to THIS message.
// Returns 1 = message complete (*used ends one past the terminal LF),
// 0 = need more bytes (*used == len), -1 = malformed.
static int chunk_feed(ChunkState* cs, const char* d, size_t len,
                      size_t* used) {
  size_t off = 0;
  while (off < len) {
    char ch = d[off];
    switch (cs->phase) {
      case 0:  // chunk-size line (hex + optional extensions).  Only a
               // bounded prefix is STORED (the hex size lives at line
               // start); longer extension tails are counted and
               // skipped, matching http_walk_chunks accepting complete
               // size lines of any length.
        off++;
        if (ch == '\n') {
          size_t stored = cs->line < sizeof cs->szline - 1
                              ? cs->line : sizeof cs->szline - 1;
          cs->szline[stored] = '\0';
          char* endp = nullptr;
          long sz = strtol(cs->szline, &endp, 16);
          // reject when nothing parsed, or when the stored prefix was
          // truncated AND is hex to the brim (the size itself may have
          // been cut — an absurd >32-digit size either way)
          if (endp == cs->szline || sz < 0
              || (cs->line > stored && *endp == '\0')) {
            *used = off;
            return -1;
          }
          cs->line = 0;
          if (sz == 0) {
            cs->phase = 4;           // trailers until a blank line
            cs->first = 0;
          } else {
            cs->remaining = (size_t)sz;
            cs->phase = 1;
          }
        } else {
          if (cs->line < sizeof cs->szline - 1)
            cs->szline[cs->line] = ch;
          cs->line++;
        }
        break;
      case 1: {  // chunk data
        size_t take = len - off;
        if (take > cs->remaining) take = cs->remaining;
        cs->remaining -= take;
        off += take;
        if (cs->remaining == 0) cs->phase = 2;
        break;
      }
      case 2:  // CR after chunk data
        if (ch != '\r') { *used = off; return -1; }
        off++;
        cs->phase = 3;
        break;
      case 3:  // LF after chunk data
        if (ch != '\n') { *used = off; return -1; }
        off++;
        cs->phase = 0;
        break;
      case 4:  // trailer lines; blank line ends the message
        if (cs->line == 0) cs->first = ch;
        cs->line++;
        off++;
        if (ch == '\n') {
          size_t tl = cs->line - 1;              // excludes the LF
          cs->line = 0;
          if (tl == 0 || (tl == 1 && cs->first == '\r')) {
            *used = off;
            return 1;                            // terminal blank line
          }
        }
        break;
    }
  }
  *used = len;
  return 0;
}

// mirror of protocol/http.py STATUS_REASONS — the slim lane's native
// status line must be byte-identical with build_response's
static const char* http_reason(long status) {
  switch (status) {
    case 200: return "OK";
    case 204: return "No Content";
    case 301: return "Moved Permanently";
    case 302: return "Found";
    case 400: return "Bad Request";
    case 403: return "Forbidden";
    case 404: return "Not Found";
    case 405: return "Method Not Allowed";
    case 500: return "Internal Server Error";
    case 501: return "Not Implemented";
    case 503: return "Service Unavailable";
    default:  return "Unknown";
  }
}

// Serialize one slim-lane response natively: status line +
// Content-Length + the shim's pre-formatted header block ("Name: v\r\n"
// per line, Content-Type first) + blank line + body — the exact byte
// layout of protocol/http.py build_response(keep_alive=True).
static void http_slim_respond(Conn* c, long status, const char* hdr,
                              size_t hlen, const char* body,
                              size_t blen) {
  char line[96];
  int n = snprintf(line, sizeof line,
                   "HTTP/1.1 %ld %s\r\nContent-Length: %zu\r\n", status,
                   http_reason(status), blen);
  c->native_out.append(line, (size_t)n);
  c->native_out.append(hdr, hlen);
  c->native_out.append("\r\n", 2);
  if (blen) {
    dp_copy(c->loop, DP_SERIALIZE, blen);
    c->native_out.append(body, blen);
  }
}

// never-happens lane failure (shim raised / returned a bad shape):
// answer a plain 500 so the keep-alive conn is not desynced
static void http_slim_error(Conn* c, const char* text) {
  size_t tl = strlen(text);
  http_slim_respond(c, 500, "Content-Type: text/plain\r\n", 26, text,
                    tl);
}

// Scan one complete, fully-buffered HTTP message for slim-lane
// eligibility: HTTP/1.1, CRLF line endings, a registered METHOD+path
// route, no Transfer-Encoding / Expect / Upgrade, Connection absent or
// exactly keep-alive.  Fills the kind-4 PyRawItem fields (pointers
// into the inbuf — batch lifetime rules apply).  False = take the
// classic EV_HTTP path; every reject increments a reason-coded
// fallback counter (and the per-route breakdown once the route is
// resolved — the route lookup precedes the header walk).
static bool http_slim_match(EngineImpl* eng, Loop* lp, const char* p,
                            size_t total, size_t hlen, PyRawItem* out) {
  if (eng->lame_duck.load(std::memory_order_relaxed) >= 2) {
    // drain: the classic EV_HTTP lane owns every response now, so the
    // x-lame-duck / Connection: close headers (and the keep-alive
    // teardown they imply) come from ONE serializer
    lp->tel.fallbacks[FB_HTTP_LAME_DUCK]++;
    return false;
  }
  const char* he = p + hlen;                    // body start
  const char* nl = (const char*)memchr(p, '\n', hlen);
  if (!nl) {
    lp->tel.fallbacks[FB_HTTP_MALFORMED_LINE]++;
    return false;
  }
  const char* sp1 = (const char*)memchr(p, ' ', (size_t)(nl - p));
  if (!sp1) {
    lp->tel.fallbacks[FB_HTTP_MALFORMED_LINE]++;
    return false;
  }
  const char* sp2 =
      (const char*)memchr(sp1 + 1, ' ', (size_t)(nl - sp1 - 1));
  if (!sp2) {
    lp->tel.fallbacks[FB_HTTP_MALFORMED_LINE]++;
    return false;
  }
  // version token must be exactly "HTTP/1.1" with a CRLF line ending
  if ((size_t)(nl - sp2) != 10 || memcmp(sp2 + 1, "HTTP/1.1\r", 9) != 0) {
    lp->tel.fallbacks[FB_HTTP_VERSION]++;
    return false;
  }
  const char* tgt = sp1 + 1;
  size_t tlen = (size_t)(sp2 - tgt);
  const char* qm = (const char*)memchr(tgt, '?', tlen);
  size_t path_len = qm ? (size_t)(qm - tgt) : tlen;
  std::string key;                // "METHOD\0path" — SSO for short ones
  key.reserve((size_t)(sp1 - p) + 1 + path_len);
  key.append(p, (size_t)(sp1 - p));
  key.push_back('\0');
  key.append(tgt, path_len);
  auto itr = eng->http_routes.find(key);
  if (itr == eng->http_routes.end()) {
    lp->tel.fallbacks[FB_HTTP_NO_ROUTE]++;
    return false;
  }
  HttpRoute* route = itr->second;
  // reject helper: global reason + the resolved route's breakdown
  auto route_fb = [&](FbReason fb, RouteFb rfb) {
    lp->tel.fallbacks[fb]++;
    route->fb[rfb]++;
    return false;
  };
  const char* ctype = nullptr;
  uint32_t ctlen = 0;
  const char* attsz = nullptr;
  uint32_t attszlen = 0;
  const char* tp = nullptr;
  uint32_t tplen = 0;
  const char* dl = nullptr;
  uint32_t dllen = 0;
  const char* xt = nullptr;
  uint32_t xtlen = 0;
  const char* line = nl + 1;
  while (line < he) {
    const char* leol =
        (const char*)memchr(line, '\n', (size_t)(he - line));
    if (!leol) break;
    size_t ll = (size_t)(leol - line);          // excl LF
    if (ll == 0 || line[ll - 1] != '\r')        // demand CRLF
      return route_fb(FB_HTTP_BAD_HEADER, RFB_BAD_HEADER);
    ll--;                                       // excl CR
    if (ll == 0) break;                         // blank line: done
    const char* col = (const char*)memchr(line, ':', ll);
    if (!col) return route_fb(FB_HTTP_BAD_HEADER, RFB_BAD_HEADER);
    size_t nlen = (size_t)(col - line);
    const char* v = col + 1;
    size_t vlen = ll - nlen - 1;
    switch (nlen) {
      case 6:
        if (strncasecmp(line, "expect", 6) == 0)
          return route_fb(FB_HTTP_EXPECT, RFB_EXPECT);
        break;
      case 7:
        if (strncasecmp(line, "upgrade", 7) == 0)
          return route_fb(FB_HTTP_UPGRADE, RFB_UPGRADE);
        break;
      case 8:
        if (strncasecmp(line, "x-tenant", 8) == 0) {
          xt = v;                               // tenant identity —
          xtlen = (uint32_t)vlen;               // the shim's admission
        }                                       // stage keys off it
        break;
      case 10:
        if (strncasecmp(line, "connection", 10) == 0) {
          while (vlen && (*v == ' ' || *v == '\t')) { v++; vlen--; }
          while (vlen && (v[vlen - 1] == ' ' || v[vlen - 1] == '\t'))
            vlen--;
          if (vlen != 10 || strncasecmp(v, "keep-alive", 10) != 0)
            return route_fb(FB_HTTP_CONNECTION,  // close / upgrade /
                            RFB_CONNECTION);     // odd value
        }
        break;
      case 11:
        if (strncasecmp(line, "traceparent", 11) == 0) {
          tp = v;                               // W3C trace context —
          tplen = (uint32_t)vlen;               // the shim parses it,
        }                                       // traced stays slim
        break;
      case 13:
        if (strncasecmp(line, "x-deadline-ms", 13) == 0) {
          dl = v;                               // remaining deadline —
          dllen = (uint32_t)vlen;               // the shim sheds
        }                                       // queue-expired requests
        break;
      case 12:
        if (strncasecmp(line, "content-type", 12) == 0) {
          ctype = v;                            // last one wins, like
          ctlen = (uint32_t)vlen;               // HttpHeaders.set
        }
        break;
      case 17:
        if (strncasecmp(line, "transfer-encoding", 17) == 0)
          return route_fb(FB_HTTP_TRANSFER_ENCODING,  // chunked OR
                          RFB_TE);                    // identity
        break;
      case 21:
        if (strncasecmp(line, "x-rpc-attachment-size", 21) == 0) {
          attsz = v;
          attszlen = (uint32_t)vlen;
        }
        break;
    }
    line = leol + 1;
  }
  out->hroute = route;
  out->payload = he;
  out->plen = total - hlen;
  out->query = qm ? qm + 1 : nullptr;
  out->qlen = qm ? (uint32_t)(tlen - path_len - 1) : 0;
  out->ctype = ctype;
  out->ctlen = ctlen;
  out->attsz = attsz;
  out->attszlen = attszlen;
  out->tp = tp;
  out->tplen = tplen;
  out->dl = dl;
  out->dllen = dllen;
  out->xt = xt;
  out->xtlen = xtlen;
  return true;
}

// parse as many complete frames as possible from c->inbuf / direct reads
static bool parse_frames_inner(EngineImpl* eng, Loop* lp, Conn* c,
                               std::vector<PyRawItem>& batch,
                               std::vector<StreamItem>& sbatch) {
  if (c->passthrough) {
    // deliver the whole gulp; Python's registry owns this connection
    size_t avail = c->in_end - c->in_start;
    if (avail == 0) return true;
    bool ok;
    {
      PyGILState_STATE gs = PyGILState_Ensure();
      flush_decrefs_locked_gil(lp);
      NativeBuf* b = nativebuf_new((Py_ssize_t)avail);
      ok = (b != nullptr);
      if (ok) {
        dp_copy(lp, DP_INGEST, avail);
        memcpy(b->data, c->inbuf + c->in_start, avail);
        PyObject* r = PyObject_CallFunction(
            eng->dispatch, "iKNl", EV_BYTES,
            (unsigned long long)c->id, (PyObject*)b, 0L);
        if (!r) PyErr_WriteUnraisable(eng->dispatch);
        else Py_DECREF(r);
      }
      PyGILState_Release(gs);
    }
    c->in_start = c->in_end = 0;
    return ok;
  }
  if (c->chunk) {
    // mid chunked-stream HTTP message (ADVICE r5 #4): feed new bytes
    // through the chunk FSM; raw bytes accumulate until the terminal
    // blank line, then ONE EV_HTTP delivers the whole message.  Burst
    // batches are empty here — the mode consumes everything until the
    // message completes.  The raw stream is buffered once here and
    // copied once into the delivery NativeBuf (total size is unknown
    // until the terminal chunk, so the CL direct-read pattern does not
    // apply); the Python-transport chunked path pays the same
    // fetch-then-decode double buffering, so parity holds.
    size_t avail = c->in_end - c->in_start;
    if (avail == 0) return true;
    const char* p = c->inbuf + c->in_start;
    size_t used = 0;
    int st = chunk_feed(c->chunk, p, avail, &used);
    c->chunk->acc.append(p, used);
    c->in_start += used;
    if (c->in_start == c->in_end) c->in_start = c->in_end = 0;
    if (st < 0) return false;               // malformed chunk framing
    if (c->chunk->acc.size() > c->chunk->cap) {
      // raw stream outgrew http_max_body (the Python parser's too_big
      // bound): clean 413, then close
      c->native_out.append(k413, sizeof(k413) - 1);
      native_flush(lp, c);
      return false;
    }
    if (st == 0) return true;               // need more bytes
    // slim responses accumulated earlier in this burst (before the -4
    // entry) must reach the wire before Python can answer this
    // message — HTTP responses have no correlation id
    if (!c->native_out.empty() && !native_flush(lp, c)) return false;
    bool ok;
    {
      PyGILState_STATE gs = PyGILState_Ensure();
      flush_decrefs_locked_gil(lp);
      NativeBuf* b = nativebuf_new((Py_ssize_t)c->chunk->acc.size());
      ok = (b != nullptr);
      if (ok) {
        dp_copy(lp, DP_INGEST, c->chunk->acc.size());
        memcpy(b->data, c->chunk->acc.data(), c->chunk->acc.size());
        PyObject* r = PyObject_CallFunction(
            eng->dispatch, "iKNl", EV_HTTP, (unsigned long long)c->id,
            (PyObject*)b, 0L);
        if (!r) PyErr_WriteUnraisable(eng->dispatch);
        else Py_DECREF(r);
      }
      PyGILState_Release(gs);
    }
    count_msg(eng, lp, c);
    delete c->chunk;
    c->chunk = nullptr;
    if (!ok) return false;
    // fall through: pipelined bytes after the chunked message parse on
  }
  for (;;) {
    size_t avail = c->in_end - c->in_start;
    const char* p = c->inbuf + c->in_start;
    if (avail < 4) return true;
    uint32_t body = 0, meta = 0;
    int kind;
    uint32_t hdr;
    if (memcmp(p, "TRPC", 4) == 0) {
      if (avail < kHeaderSize) return true;
      memcpy(&body, p + 4, 4);
      memcpy(&meta, p + 8, 4);
      if (body > kMaxBody || meta > body) return false;
      kind = EV_MESSAGE;
      hdr = kHeaderSize;
    } else if (memcmp(p, "TICI", 4) == 0) {
      if (avail < kAckHeader) return true;
      uint32_t count = 0;
      memcpy(&count, p + 4, 4);
      if (count > (1u << 20)) return false;
      body = count * 8;
      meta = count;
      kind = EV_ACK;
      hdr = kAckHeader;
    } else if (memcmp(p, "TSTR", 4) == 0) {
      // stream frame: [magic][u8 flags][u64 dest][u32 len][payload].
      // Frames for a kind-5 NATIVE stream are consumed here: credit
      // feedback settles entirely in C++ (zero GIL entries), DATA and
      // CLOSE chunks batch with the burst and enter Python ONCE in
      // flush_py_batch.  Everything else (pure-Python streams, closed
      // streams, forged ids, oversize chunks) rides the classic
      // EV_STREAM path under a NAMED StreamFb reason.
      if (avail < 17) return true;
      uint32_t len = 0;
      memcpy(&len, p + 13, 4);
      if (len > kMaxBody) return false;
      size_t stotal = 17 + (size_t)len;
      if (eng->nstreams.load(std::memory_order_acquire) != 0) {
        uint64_t dest = 0;
        memcpy(&dest, p + 5, 8);
        std::shared_ptr<NativeStream> ns;
        {
          std::lock_guard<std::mutex> g(eng->smu);
          auto sit = eng->streams.find(dest);
          if (sit != eng->streams.end()) ns = sit->second;
        }
        if (ns && ns->conn_id == c->id) {
          if (avail >= stotal) {
            uint8_t flags = (uint8_t)p[4];
            if (flags == 1 /* F_FEEDBACK */) {
              if (len >= 8) {
                uint64_t consumed = 0;
                memcpy(&consumed, p + 17, 8);
                std::lock_guard<std::mutex> g(ns->mu);
                // clamp to produced: an over-acking peer must not
                // push remote_consumed past produced, or the unsigned
                // produced - remote_consumed window check underflows
                // and stalls the stream forever (the Python lane's
                // signed arithmetic tolerates over-ack; so do we)
                if (consumed > ns->produced) consumed = ns->produced;
                if (consumed > ns->remote_consumed) {
                  ns->remote_consumed = consumed;
                  ns->cv.notify_all();   // wake blocked producers
                }
              }
              lp->tel.stream_feedbacks++;
            } else {
              if (flags == 2 || flags == 3) {  // F_CLOSE / F_RST
                std::lock_guard<std::mutex> g(ns->mu);
                ns->closed = true;       // writers fail fast, not at
                ns->cv.notify_all();     // their credit timeout
              }
              sbatch.push_back(StreamItem{
                  dest, (int)flags, p + 17, (size_t)len});
              lp->tel.stream_chunks_in++;
            }
            c->in_start += stotal;
            count_msg(eng, lp, c);
            continue;
          }
          if (stotal > kInbufCap / 2) {
            // about to switch to the direct-read path: too large to
            // batch — the Python streaming lane delivers it whole
            // (counted ONCE: the switch below consumes the frame)
            lp->tel.sfallbacks[SFB_CHUNK_OVERSIZE]++;
          }
          // incomplete small frame: generic tail waits for more bytes
        } else if (avail >= stotal) {
          // not ours (pure-Python stream, closed, or forged onto the
          // wrong conn): the classic dispatch path arbitrates
          lp->tel.sfallbacks[SFB_UNREGISTERED]++;
        }
      } else if (avail >= stotal) {
        lp->tel.sfallbacks[
            eng->stream_mode.load(std::memory_order_relaxed) == 0
                ? SFB_NO_SHIM : SFB_UNREGISTERED]++;
      }
      body = 13 + len;
      meta = 0;
      kind = EV_STREAM;
      hdr = 4;
    } else {
      // not a natively-framed protocol.  HTTP/1.x is cut natively and
      // handed to Python whole (EV_HTTP); anything else that isn't
      // even HTTP-shaped flips the connection to PASSTHROUGH — the
      // Python protocol registry (h2/gRPC, redis, thrift, streams)
      // cuts and dispatches it, so the native port speaks every
      // protocol the Python transport does.  Malformed HTTP (sniffed
      // as HTTP but uncuttable) stays a close.
      if (!http_sniff(p)) {
        flush_py_batch(lp, c, batch, sbatch);
        if (!c->native_out.empty() && !native_flush(lp, c)) return false;
        c->passthrough = true;
        // re-enter: the passthrough head delivers the buffered bytes
        return parse_frames_inner(eng, lp, c, batch, sbatch);
      }
      if (c->http_state == 0) {
        // SNIFF COMMITMENT (ADVICE r5 #5): a 4-byte method-token match
        // is not proof of HTTP.  Only a request line carrying
        // " HTTP/1." commits the conn to the HTTP cutter; a complete
        // line without it (or an over-long / time-stalled one, swept
        // by the loop) goes to the passthrough registry instead of
        // hanging here waiting for a CRLFCRLF that never comes.
        size_t linecap = avail < kMaxHttpReqLine ? avail
                                                 : kMaxHttpReqLine;
        const char* nl = (const char*)memchr(p, '\n', linecap);
        bool commit = false, arbitrate = false;
        if (nl) {
          if (line_has_http_marker(p, (size_t)(nl - p))) commit = true;
          else arbitrate = true;
        } else if (avail >= kMaxHttpReqLine) {
          arbitrate = true;
        }
        if (arbitrate) {
          flush_py_batch(lp, c, batch, sbatch);
          if (!c->native_out.empty() && !native_flush(lp, c))
            return false;
          c->sniff_deadline = 0;
          c->passthrough = true;
          return parse_frames_inner(eng, lp, c, batch, sbatch);
        }
        if (!commit) {
          // incomplete request line: wait, but only within the sniff
          // budget — the loop's sweep flips a stalled conn to the
          // passthrough registry (a slow legit HTTP client is still
          // served there: the registry speaks HTTP too)
          if (c->sniff_deadline == 0) {
            c->sniff_deadline = now_ms() + kSniffBudgetMs;
            lp->sniffing.push_back(c->id);
          }
          if (c->in_start > 0) {
            flush_py_batch(lp, c, batch, sbatch);
            memmove(c->inbuf, c->inbuf + c->in_start, avail);
            c->in_end = avail;
            c->in_start = 0;
          }
          return true;
        }
        c->http_state = 1;
        c->sniff_deadline = 0;
      }
      size_t cl_total = 0, http_hlen = 0;
      ssize_t hr = http_cut(
          p, avail, eng->http_max_body.load(std::memory_order_relaxed),
          &cl_total, &http_hlen);
      if (hr == -3) {
        // body over the limit: answer 413 cleanly, then close
        flush_py_batch(lp, c, batch, sbatch);
        c->native_out.append(k413, sizeof(k413) - 1);
        native_flush(lp, c);
        return false;
      }
      if (hr == -4) {
        // chunked body outgrowing the inbuf: stream raw bytes through
        // the incremental chunk FSM, bounded by http_max_body
        lp->tel.fallbacks[FB_HTTP_CHUNK_STREAM]++;
        flush_py_batch(lp, c, batch, sbatch);
        c->chunk = new (std::nothrow) ChunkState();
        if (!c->chunk) return false;
        c->chunk->cap =
            http_hlen
            + eng->http_max_body.load(std::memory_order_relaxed);
        size_t used = 0;
        int st = chunk_feed(c->chunk, p + http_hlen, avail - http_hlen,
                            &used);
        (void)used;                    // all buffered bytes are ours
        c->chunk->acc.assign(p, avail);
        c->in_start = c->in_end = 0;
        if (st < 0) return false;
        // st == 1 cannot happen (http_walk_chunks said incomplete);
        // more bytes arrive through the chunk head above
        return true;
      }
      if (hr > 0) {
        if (eng->http_slim.load(std::memory_order_relaxed)) {
          // SLIM HTTP LANE (kind 4): eligible messages batch with the
          // burst and enter Python once, in flush_py_batch
          PyRawItem hit{};
          if (http_slim_match(eng, lp, p, (size_t)hr, http_hlen,
                              &hit)) {
            hit.t_parse = now_ns();
            c->in_start += (size_t)hr;
            count_msg(eng, lp, c);
            batch.push_back(hit);
            continue;
          }
        } else {
          lp->tel.fallbacks[FB_HTTP_SLIM_OFF]++;
        }
        // one complete HTTP message: classic EV_HTTP dispatch
        flush_py_batch(lp, c, batch, sbatch);   // wire order vs earlier frames
        if (!c->native_out.empty() && !native_flush(lp, c)) return false;
        c->in_start += (size_t)hr;
        count_msg(eng, lp, c);
        bool ok;
        {
          PyGILState_STATE gs = PyGILState_Ensure();
          flush_decrefs_locked_gil(lp);
          NativeBuf* b = nativebuf_new((Py_ssize_t)hr);
          ok = (b != nullptr);
          if (ok) {
            dp_copy(lp, DP_INGEST, (size_t)hr);
            memcpy(b->data, p, (size_t)hr);
            PyObject* r = PyObject_CallFunction(
                eng->dispatch, "iKNl", EV_HTTP,
                (unsigned long long)c->id, (PyObject*)b, 0L);
            if (!r) PyErr_WriteUnraisable(eng->dispatch);
            else Py_DECREF(r);
          }
          PyGILState_Release(gs);
        }
        if (!ok) return false;
        continue;
      }
      if (hr == 0) {
        // incomplete HTTP message: wait for more bytes
        if (c->in_start > 0) {
          flush_py_batch(lp, c, batch, sbatch);
          memmove(c->inbuf, c->inbuf + c->in_start, avail);
          c->in_end = avail;
          c->in_start = 0;
        }
        return true;
      }
      if (hr == -2) {
        // large Content-Length body: direct-into-buffer reads, same
        // machinery as large tpu_std frames (msg_kind = EV_HTTP)
        lp->tel.fallbacks[FB_HTTP_LARGE_BODY]++;
        flush_py_batch(lp, c, batch, sbatch);
        NativeBuf* b;
        {
          PyGILState_STATE gs = PyGILState_Ensure();
          flush_decrefs_locked_gil(lp);
          b = nativebuf_new((Py_ssize_t)cl_total);
          PyGILState_Release(gs);
        }
        if (!b) return false;
        dp_copy(lp, DP_INGEST_SPILL, avail);
        memcpy(b->data, p, avail);
        c->msg = b;
        c->msg_filled = avail;
        c->msg_meta = 0;
        c->msg_kind = EV_HTTP;
        c->in_start = c->in_end = 0;
        return true;
      }
      // hr == -1: hand the readable prefix to Python, then die
      NativeBuf* b;
      {
        PyGILState_STATE gs = PyGILState_Ensure();
        b = nativebuf_new((Py_ssize_t)avail);
        if (b) memcpy(b->data, p, avail);
        PyGILState_Release(gs);
      }
      if (b) call_dispatch(eng, lp, EV_UNKNOWN, c->id, (PyObject*)b, 0);
      return false;
    }
    size_t total = hdr + (size_t)body;
    if (avail >= total) {
      c->in_start += total;
      count_msg(eng, lp, c);
      // native dispatch first: echo-class frames never leave C++ (the
      // response rides c->native_out, coalesced across the burst);
      // kind=2 Python raw handlers are BATCHED into one GIL entry
      if (kind == EV_MESSAGE
          && native_try_handle(eng, lp, c, p + hdr, body, meta, &batch)) {
        continue;
      }
      // a Python-path frame mid-burst: flush queued native responses
      // first so wire order matches arrival order
      if (!c->native_out.empty() && !native_flush(lp, c)) return false;
      // whole frame in the buffer: ONE GIL acquisition covers the
      // NativeBuf alloc+copy and the Python dispatch (two round trips
      // here doubled the GIL-convoy exposure per message)
      bool ok;
      {
        PyGILState_STATE gs = PyGILState_Ensure();
        flush_decrefs_locked_gil(lp);
        NativeBuf* b = nativebuf_new((Py_ssize_t)body);
        ok = (b != nullptr);
        if (ok) {
          dp_copy(lp, DP_INGEST, (size_t)body);
          memcpy(b->data, p + hdr, body);
          PyObject* r = PyObject_CallFunction(
              eng->dispatch, "iKNl", kind, (unsigned long long)c->id,
              (PyObject*)b, (long)meta);
          if (!r) PyErr_WriteUnraisable(eng->dispatch);
          else Py_DECREF(r);
        }
        PyGILState_Release(gs);
      }
      if (!ok) return false;
      continue;
    }
    // incomplete: large bodies switch to direct-into-buffer reads
    if (total > kInbufCap / 2) {
      NativeBuf* b;
      {
        PyGILState_STATE gs = PyGILState_Ensure();
        // drain deferred view releases NOW: on the pure-native path
        // this is the loop's only periodic GIL point, and the previous
        // large request's buffer must reach the freelist before this
        // alloc or every request pays a fresh multi-MB mmap + soft
        // faults (measured 2x throughput loss at 1MB)
        flush_decrefs_locked_gil(lp);
        b = nativebuf_new((Py_ssize_t)body);
        PyGILState_Release(gs);
      }
      if (!b) return false;
      size_t have = avail - hdr;
      dp_copy(lp, DP_INGEST_SPILL, have);
      memcpy(b->data, p + hdr, have);
      c->msg = b;
      c->msg_filled = have;
      c->msg_meta = meta;
      c->msg_kind = kind;
      // inbuf fully consumed
      c->in_start = c->in_end = 0;
      return true;
    }
    // small frame, wait for more bytes; compact if consumed prefix is big
    if (c->in_start > 0) {
      // batched kind=2 items point into the consumed prefix this
      // memmove is about to overwrite — run them first
      flush_py_batch(lp, c, batch, sbatch);
      memmove(c->inbuf, c->inbuf + c->in_start, avail);
      c->in_end = avail;
      c->in_start = 0;
    }
    return true;
  }
}

static bool parse_frames(EngineImpl* eng, Loop* lp, Conn* c) {
  std::vector<PyRawItem> batch;
  std::vector<StreamItem> sbatch;
  bool ok = parse_frames_inner(eng, lp, c, batch, sbatch);
  // requests already complete on the wire get processed even when a
  // later frame kills the connection (same order the Python path gives)
  flush_py_batch(lp, c, batch, sbatch);
  if (!ok && !c->native_out.empty()) {
    // the conn is about to be destroyed, but the batch above ran side
    // effects (user code, MethodStatus) for requests that were fully
    // on the wire — deliver their responses best-effort before the
    // close, like the classic path's inline sends reached the socket
    // before a close
    native_flush(lp, c);
  }
  return ok;
}

static bool conn_readable(EngineImpl* eng, Loop* lp, Conn* c) {
  for (;;) {
    if (c->msg) {
      // direct read of the in-flight message body
      size_t want = (size_t)c->msg->size - c->msg_filled;
      ssize_t r = recv(c->fd, c->msg->data + c->msg_filled, want, 0);
      if (r == 0) {
        // peer half-closed mid-burst: deliver responses already
        // produced for earlier pipelined requests best-effort
        if (!c->native_out.empty()) native_flush(lp, c);
        return false;
      }
      if (r < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK)
          return native_flush(lp, c);       // burst over: ship responses
        if (errno == EINTR) continue;
        return false;
      }
      eng->bytes_in += (uint64_t)r;
      c->msg_filled += (size_t)r;
      if (c->msg_filled == (size_t)c->msg->size) {
        NativeBuf* b = c->msg;
        c->msg = nullptr;
        c->msg_filled = 0;
        count_msg(eng, lp, c);
        // native echo on the large-frame path: respond zero-copy out of
        // the received NativeBuf (header+meta owned; body is a view)
        MetaScan s;
        NativeMethod* m = nullptr;
        if (c->msg_kind == EV_MESSAGE) {
          // reason-coded mirror of native_try_handle's screening for
          // the direct-read (large-frame) path
          if (!eng->native_dispatch.load(std::memory_order_relaxed))
            lp->tel.fallbacks[FB_RPC_DISPATCH_OFF]++;
          else if (!scan_request_meta(b->data, c->msg_meta, &s))
            lp->tel.fallbacks[FB_RPC_META_TAG]++;
          else if (s.shm)
            lp->tel.fallbacks[FB_RPC_SHM_LANE]++;
          else if (s.stream_id) {
            // large-frame stream open: reason-coded mirror of
            // native_try_handle's kind-5 screening — same request,
            // same NAME regardless of frame size (only the
            // genuinely-eligible-but-oversize shape earns
            // stream_chunk_oversize)
            NativeMethod* m0 = find_native(eng, s);
            int mode = eng->stream_mode.load(std::memory_order_relaxed);
            int sfb;
            if (s.compressed)            // same rank order as the
              sfb = SFB_COMPRESSED;      // buffered-path screening
            else if (eng->lame_duck.load(std::memory_order_relaxed) >= 1)
              sfb = SFB_DRAIN;
            else if (mode != 1 || m0 == nullptr
                     || m0->stream_handler == nullptr)
              sfb = mode == 2 ? SFB_NON_INLINE : SFB_NO_SHIM;
            else
              sfb = SFB_CHUNK_OVERSIZE;
            lp->tel.sfallbacks[sfb]++;
            if (m0) m0->fb_stream_open++;
          } else if (s.compressed || s.stream_window)
            lp->tel.fallbacks[FB_RPC_META_TAG]++;
          else if ((m = find_native(eng, s)) == nullptr)
            lp->tel.fallbacks[FB_RPC_NO_METHOD]++;
        }
        if (m && (m->kind == 2 || m->kind == 3)) {
          lp->tel.fallbacks[FB_RPC_LARGE_FRAME]++;
          m->fb_large_frame++;
          m = nullptr;   // large-frame Python raw/slim: the bridge's
                         // zero-copy NativeBuf path beats a batch copy
                         // (for slim this IS the big-attachment
                         // fallback to the classic dispatch)
        }
        if (m && s.trace_id) {
          // traced echo/const on the direct-read path: the span must
          // record — mirror of native_try_handle's trace screening
          lp->tel.fallbacks[FB_RPC_TRACE_RAW]++;
          m->fb_trace_raw++;
          m = nullptr;
        }
        if (m) {
          size_t plen = (size_t)b->size - c->msg_meta;
          if (s.att > plen) {
            m->errors++;
            native_error(c, s.cid, 1003, "attachment size exceeds body");
            PyGILState_STATE gs = PyGILState_Ensure();
            Py_DECREF(b);
            PyGILState_Release(gs);
          } else if (m->kind == 1) {
            native_respond(c, s.cid, m->const_data.data(),
                           m->const_data.size(), 0);
            m->count++;
            PyGILState_STATE gs = PyGILState_Ensure();
            Py_DECREF(b);
            PyGILState_Release(gs);
          } else {
            // echo: append header+meta to native_out, then queue the
            // received buffer itself (offset past the request meta) —
            // the megabyte body is never copied
            native_append_head(eng, c->native_out, s.cid, s.att, plen);
            WriteItem it;
            bool got = false;
            {
              PyGILState_STATE gs = PyGILState_Ensure();
              flush_decrefs_locked_gil(lp);
              got = PyObject_GetBuffer((PyObject*)b, &it.view,
                                       PyBUF_SIMPLE) == 0;
              Py_DECREF(b);   // the view (if any) holds its own ref
              PyGILState_Release(gs);
            }
            if (!got) return false;
            it.offset = c->msg_meta;   // skip the request meta bytes
            // stage header+meta and the body view ATOMICALLY (one wmu
            // hold — no foreign frame can land between them), flush
            // once: a single writev, a single peer wakeup
            if (!native_stage(c, &it)) {
              PyGILState_STATE gs = PyGILState_Ensure();
              PyBuffer_Release(&it.view);
              PyGILState_Release(gs);
              return false;
            }
            if (!conn_flush(lp, c)) return false;
            m->count++;
          }
          continue;
        }
        if (!c->native_out.empty() && !native_flush(lp, c)) return false;
        call_dispatch(eng, lp, c->msg_kind, c->id, (PyObject*)b,
                      (long)c->msg_meta);
      }
      continue;
    }
    // buffered read into the fixed inbuf (compact first if needed)
    if (c->in_end + 65536 > kInbufCap && c->in_start > 0) {
      memmove(c->inbuf, c->inbuf + c->in_start, c->in_end - c->in_start);
      c->in_end -= c->in_start;
      c->in_start = 0;
    }
    size_t room = kInbufCap - c->in_end;
    if (room > 65536) room = 65536;
    ssize_t r = recv(c->fd, c->inbuf + c->in_end, room, 0);
    if (r <= 0) {
      if (r == 0) {
        if (!c->native_out.empty()) native_flush(lp, c);
        return false;
      }
      if (errno == EAGAIN || errno == EWOULDBLOCK)
        return native_flush(lp, c);         // burst over: ship responses
      if (errno == EINTR) continue;
      return false;
    }
    c->in_end += (size_t)r;
    eng->bytes_in += (uint64_t)r;
    if (c->in_end > lp->tel.inbuf_hwm) lp->tel.inbuf_hwm = c->in_end;
    if (!parse_frames(eng, lp, c)) return false;
  }
}

static void accept_conns(EngineImpl* eng, Loop* lp) {
  // SHARDED ACCEPT (SO_REUSEPORT): each loop accepts off its OWN
  // listen fd and pins the conn to itself for life — no rr handoff, no
  // adopt round trip, no cross-loop state on the whole read→shim→writev
  // path (brpc's one-EventDispatcher-per-core discipline).  The shared
  // single-fd path (lp->listen_fd < 0 — platforms/configs without
  // REUSEPORT) keeps the round-robin + adopt-eventfd placement.
  int lfd = lp->listen_fd >= 0 ? lp->listen_fd : eng->listen_fd;
  for (;;) {
    struct sockaddr_in addr;
    socklen_t alen = sizeof(addr);
    int fd = accept4(lfd, (struct sockaddr*)&addr, &alen,
                     SOCK_NONBLOCK);
    if (fd < 0) return;
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    Conn* c = new Conn();
    c->fd = fd;
    c->inbuf = (char*)malloc(kInbufCap);
    c->id = eng->next_conn++;
    char ip[64] = {0};
    inet_ntop(AF_INET, &addr.sin_addr, ip, sizeof(ip));
    c->peer_ip = ip;
    c->peer_port = ntohs(addr.sin_port);
    // placement: own-listener accepts pin to the accepting loop;
    // shared-fd accepts assign round-robin (fallback path)
    Loop* target = lp->listen_fd >= 0
        ? lp : eng->loops[eng->rr++ % eng->loops.size()];
    c->loop = target;
    {
      std::lock_guard<std::mutex> g(eng->cmu);
      eng->by_id[c->id] = c;
    }
    // EV_OPEN MUST be dispatched before the fd reaches any epoll: once a
    // loop can read the first frame, EV_MESSAGE may race ahead of the
    // bridge learning the connection and the request would be dropped.
    {
      PyGILState_STATE gs = PyGILState_Ensure();
      flush_decrefs_locked_gil(lp);
      PyObject* r =
          PyObject_CallFunction(eng->dispatch, "iKsl", EV_OPEN,
                                (unsigned long long)c->id, ip,
                                (long)c->peer_port);
      if (!r)
        PyErr_WriteUnraisable(eng->dispatch);
      else
        Py_DECREF(r);
      PyGILState_Release(gs);
    }
    if (target == lp) {
      lp->tel.accepts++;
      lp->conns[c->id] = c;
      struct epoll_event ev;
      ev.events = EPOLLIN;
      ev.data.u64 = c->id;
      epoll_ctl(lp->epfd, EPOLL_CTL_ADD, fd, &ev);
    } else {
      loop_post(target, c->id, HO_ADOPT);
    }
  }
}

static thread_local Loop* t_current_loop = nullptr;

static void loop_run(Loop* lp) {
  t_current_loop = lp;
  EngineImpl* eng = lp->eng;
  struct epoll_event evs[128];
  while (!eng->stopping.load()) {
    // busy/idle split: time blocked in epoll_wait is idle, everything
    // else in the iteration (callbacks, parsing, writes) is busy —
    // the loop-thread analogue of /hotspots for the C++ data plane.
    // With engine_busy_poll_us set, the loop first SPINS on zero-
    // timeout polls for that long: events harvested in the spin skip
    // the sleep/wake scheduler round trip (the latency-tail knob; the
    // spin window is accounted idle — spinning is waiting, not work).
    int64_t t_pre = now_ns();
    int n = 0;
    int spin_us = eng->busy_poll_us.load(std::memory_order_relaxed);
    if (spin_us > 0) {
      int64_t spin_end = t_pre + (int64_t)spin_us * 1000;
      do {
        n = epoll_wait(lp->epfd, evs, 128, 0);
      } while (n == 0 && now_ns() < spin_end && !eng->stopping.load());
      if (n > 0) lp->tel.spin_polls++;
    }
    if (n == 0) n = epoll_wait(lp->epfd, evs, 128, 200);
    int64_t t_wake = now_ns();
    lp->tel.idle_ns += (uint64_t)(t_wake - t_pre);
    lp->tel.polls++;
    struct BusyScope {
      LoopTelemetry* tel;
      int64_t t0;
      ~BusyScope() { tel->busy_ns += (uint64_t)(now_ns() - t0); }
    } busy_scope{&lp->tel, t_wake};
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    // cross-loop handoff drain: take the whole MPSC stack in ONE
    // acquire exchange (no lock), reverse it for FIFO processing, and
    // run each node — flush requests from completion threads, close
    // requests, rr-fallback adopts.  Producers never block; this loop
    // never locks: the per-core lanes share nothing on the hot path.
    {
      HandoffNode* head =
          lp->handoff_head.exchange(nullptr, std::memory_order_acquire);
      HandoffNode* rev = nullptr;
      while (head) {
        HandoffNode* nx = head->next;
        head->next = rev;
        rev = head;
        head = nx;
      }
      while (rev) {
        HandoffNode* node = rev;
        rev = rev->next;
        lp->tel.handoffs++;
        uint64_t id = node->id;
        int op = node->op;
        delete node;
        if (op == HO_ADOPT) {            // adopt a freshly accepted conn
          Conn* c = nullptr;
          {
            std::lock_guard<std::mutex> g(eng->cmu);
            auto it = eng->by_id.find(id);
            if (it != eng->by_id.end()) c = it->second;
          }
          if (c) {
            lp->tel.accepts++;
            lp->conns[id] = c;
            struct epoll_event ev;
            ev.events = EPOLLIN;
            ev.data.u64 = id;
            epoll_ctl(lp->epfd, EPOLL_CTL_ADD, c->fd, &ev);
          }
          continue;
        }
        if (op == HO_FLUSH) {
          auto it = lp->conns.find(id);
          if (it != lp->conns.end()) {
            // reset BEFORE flushing: a send racing in after this sees
            // queued bytes and posts a fresh node
            it->second->flush_queued.store(false,
                                           std::memory_order_release);
            if (!conn_flush(lp, it->second))
              conn_destroy(eng, lp, it->second, true);
          }
          continue;
        }
        // HO_CLOSE
        auto it = lp->conns.find(id);
        if (it == lp->conns.end()) continue;
        Conn* c = it->second;
        if (c->closing) continue;        // already lingering
        // close-after-flush: drain what the kernel will take now; if
        // the queue still holds bytes (short writev / EAGAIN — exactly
        // the Connection: close responses this path serves), keep the
        // conn EPOLLOUT-armed and destroy when the queue empties,
        // bounded by a linger deadline.  conn_flush returns false once
        // a closing conn is fully drained (or on a fatal error).
        c->closing = true;
        if (!conn_flush(lp, c)) {
          conn_destroy(eng, lp, c, true);
          continue;
        }
        c->close_deadline = now_ms() + kCloseLingerMs;
        lp->lingering.push_back(id);
        struct epoll_event ev;
        ev.events = EPOLLOUT;            // stop reading; write-drain only
        ev.data.u64 = id;
        epoll_ctl(lp->epfd, EPOLL_CTL_MOD, c->fd, &ev);
      }
    }
    for (int i = 0; i < n; i++) {
      uint64_t id = evs[i].data.u64;
      if (id == 0) {  // wakefd or listener
        if (evs[i].data.u64 == 0) {
          uint64_t drain;
          while (read(lp->wakefd, &drain, 8) > 0) {
          }
        }
        continue;
      }
      if (id == UINT64_MAX) {  // listener
        accept_conns(eng, lp);
        continue;
      }
      auto it = lp->conns.find(id);
      if (it == lp->conns.end()) continue;
      Conn* c = it->second;
      bool ok = true;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) ok = false;
      if (ok && (evs[i].events & EPOLLOUT)) ok = conn_flush(lp, c);
      if (ok && (evs[i].events & EPOLLIN) && !c->closing)
        ok = conn_readable(eng, lp, c);
      if (!ok) conn_destroy(eng, lp, c, true);
    }
    // sniff sweep: conns holding a sniffed-HTTP prefix that never
    // committed (" HTTP/1." unseen) within the budget are flipped to
    // the passthrough registry — a slow legit HTTP client is still
    // served there, and a colliding protocol gets arbitrated instead
    // of hanging against the CRLFCRLF hunt (ADVICE r5 #5)
    if (!lp->sniffing.empty()) {
      int64_t now = now_ms();
      std::vector<uint64_t> keep;
      for (uint64_t id : lp->sniffing) {
        auto it = lp->conns.find(id);
        if (it == lp->conns.end()) continue;          // conn gone
        Conn* c = it->second;
        if (c->sniff_deadline == 0) continue;         // committed
        if (now < c->sniff_deadline) {
          keep.push_back(id);
          continue;
        }
        c->sniff_deadline = 0;
        c->passthrough = true;
        if (!parse_frames(eng, lp, c)) conn_destroy(eng, lp, c, true);
      }
      lp->sniffing.swap(keep);
    }
    // linger sweep: closing conns that could not drain within the
    // deadline are torn down (destroyed conns are simply absent)
    if (!lp->lingering.empty()) {
      int64_t now = now_ms();
      std::vector<uint64_t> keep;
      for (uint64_t id : lp->lingering) {
        auto it = lp->conns.find(id);
        if (it == lp->conns.end()) continue;
        Conn* c = it->second;
        if (now >= c->close_deadline)
          conn_destroy(eng, lp, c, true);
        else
          keep.push_back(id);
      }
      lp->lingering.swap(keep);
    }
  }
  // teardown: close all conns owned by this loop, then drain any
  // handoff nodes posted after the last iteration (an un-adopted conn
  // must still be destroyed — its fd is open and it is in by_id)
  std::vector<Conn*> cs;
  for (auto& kv : lp->conns) cs.push_back(kv.second);
  for (Conn* c : cs) conn_destroy(eng, lp, c, false);
  HandoffNode* head =
      lp->handoff_head.exchange(nullptr, std::memory_order_acquire);
  while (head) {
    HandoffNode* nx = head->next;
    if (head->op == HO_ADOPT) {
      Conn* c = nullptr;
      {
        std::lock_guard<std::mutex> g(eng->cmu);
        auto it = eng->by_id.find(head->id);
        if (it != eng->by_id.end()) c = it->second;
      }
      if (c) conn_destroy(eng, lp, c, false);
    }
    delete head;
    head = nx;
  }
}

// ---------------------------------------------------------------------------
// Python object wrapping EngineImpl
// ---------------------------------------------------------------------------

typedef struct {
  PyObject_HEAD EngineImpl* eng;
} EngineObj;

static PyObject* Engine_new(PyTypeObject* type, PyObject* args,
                            PyObject* kwds) {
  PyObject* dispatch;
  int nloops = 1;
  int external = 0;
  static const char* kwlist[] = {"dispatch", "loops", "external_loops",
                                 nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "O|ip", (char**)kwlist,
                                   &dispatch, &nloops, &external))
    return nullptr;
  if (!PyCallable_Check(dispatch)) {
    PyErr_SetString(PyExc_TypeError, "dispatch must be callable");
    return nullptr;
  }
  if (nloops < 1) nloops = 1;
  if (nloops > 16) nloops = 16;
  EngineObj* self = (EngineObj*)type->tp_alloc(type, 0);
  if (!self) return nullptr;
  self->eng = new EngineImpl();
  self->eng->external_loops = external != 0;
  Py_INCREF(dispatch);
  self->eng->dispatch = dispatch;
  for (int i = 0; i < nloops; i++) {
    Loop* lp = new Loop();
    lp->eng = self->eng;
    lp->index = i;
    lp->epfd = epoll_create1(EPOLL_CLOEXEC);
    lp->wakefd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
    struct epoll_event ev;
    ev.events = EPOLLIN;
    ev.data.u64 = 0;  // wake marker
    epoll_ctl(lp->epfd, EPOLL_CTL_ADD, lp->wakefd, &ev);
    self->eng->loops.push_back(lp);
  }
  return (PyObject*)self;
}

static PyObject* Engine_listen(EngineObj* self, PyObject* args) {
  int fd;
  if (!PyArg_ParseTuple(args, "i", &fd)) return nullptr;
  EngineImpl* eng = self->eng;
  eng->listen_fd = fd;
  // listener lives on loop 0 with the UINT64_MAX marker
  struct epoll_event ev;
  ev.events = EPOLLIN;
  ev.data.u64 = UINT64_MAX;
  if (epoll_ctl(eng->loops[0]->epfd, EPOLL_CTL_ADD, fd, &ev) != 0) {
    PyErr_SetFromErrno(PyExc_OSError);
    return nullptr;
  }
  // start threads on first listen (external mode: the bridge runs the
  // loops on Python threads via run_loop — see EngineImpl comment)
  eng->started = true;
  if (!eng->external_loops) {
    for (Loop* lp : eng->loops) {
      if (!lp->thr.joinable()) lp->thr = std::thread(loop_run, lp);
    }
  }
  Py_RETURN_NONE;
}

// listen_sharded(fds) — the SO_REUSEPORT sharded-accept path: exactly
// one bound+listening fd per loop; each loop accepts its own
// connections and pins them to itself for life (no rr handoff, no
// adopt round trip).  The single-fd listen() above remains the
// fallback for platforms/configs without REUSEPORT.
static PyObject* Engine_listen_sharded(EngineObj* self, PyObject* args) {
  PyObject* fds;
  if (!PyArg_ParseTuple(args, "O", &fds)) return nullptr;
  EngineImpl* eng = self->eng;
  PyObject* seq = PySequence_Fast(fds, "fds must be a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  if ((size_t)n != eng->loops.size()) {
    Py_DECREF(seq);
    PyErr_SetString(PyExc_ValueError,
                    "listen_sharded needs exactly one fd per loop");
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    long fd = PyLong_AsLong(PySequence_Fast_GET_ITEM(seq, i));
    if (fd == -1 && PyErr_Occurred()) {
      Py_DECREF(seq);
      return nullptr;
    }
    Loop* lp = eng->loops[(size_t)i];
    lp->listen_fd = (int)fd;
    struct epoll_event ev;
    ev.events = EPOLLIN;
    ev.data.u64 = UINT64_MAX;
    if (epoll_ctl(lp->epfd, EPOLL_CTL_ADD, (int)fd, &ev) != 0) {
      Py_DECREF(seq);
      PyErr_SetFromErrno(PyExc_OSError);
      return nullptr;
    }
  }
  Py_DECREF(seq);
  eng->started = true;
  if (!eng->external_loops) {
    for (Loop* lp : eng->loops) {
      if (!lp->thr.joinable()) lp->thr = std::thread(loop_run, lp);
    }
  }
  Py_RETURN_NONE;
}

// set_lame_duck(on) — operability plane: enter/leave drain mode.
// While on: natively-built tpu_std responses carry the lame-duck TLV,
// new kind-4 slim-HTTP matches decline to the classic lane, and every
// listener is DISARMED from its loop's epoll — accepting stops but the
// fds stay open+bound, so a hot-restart successor can inherit them
// (SCM_RIGHTS) with the kernel listen queue intact.  off re-arms.
static PyObject* Engine_set_lame_duck(EngineObj* self, PyObject* args) {
  int mode;   // 0 = off, 1 = accept pause only, 2 = pause + signal
  if (!PyArg_ParseTuple(args, "i", &mode)) return nullptr;
  if (mode < 0) mode = 0;
  if (mode > 2) mode = 2;
  EngineImpl* eng = self->eng;
  int on = mode != 0;
  int prev = eng->lame_duck.exchange(mode, std::memory_order_relaxed);
  if ((prev != 0) == on) Py_RETURN_NONE;   // arm state unchanged
  struct epoll_event ev;
  ev.events = EPOLLIN;
  ev.data.u64 = UINT64_MAX;
  if (eng->listen_fd >= 0 && !eng->loops.empty()) {
    if (on)
      epoll_ctl(eng->loops[0]->epfd, EPOLL_CTL_DEL, eng->listen_fd,
                nullptr);
    else
      epoll_ctl(eng->loops[0]->epfd, EPOLL_CTL_ADD, eng->listen_fd, &ev);
  }
  for (Loop* lp : eng->loops) {
    if (lp->listen_fd < 0) continue;
    if (on)
      epoll_ctl(lp->epfd, EPOLL_CTL_DEL, lp->listen_fd, nullptr);
    else
      epoll_ctl(lp->epfd, EPOLL_CTL_ADD, lp->listen_fd, &ev);
  }
  Py_RETURN_NONE;
}

// listener_fds() — the bound+listening fds this engine accepts on
// (shard listeners included): the hot-restart exporter passes them to
// the successor binary over a unix socket.
static PyObject* Engine_listener_fds(EngineObj* self, PyObject* args) {
  (void)args;
  EngineImpl* eng = self->eng;
  PyObject* out = PyList_New(0);
  if (!out) return nullptr;
  if (eng->listen_fd >= 0) {
    PyObject* v = PyLong_FromLong(eng->listen_fd);
    if (!v || PyList_Append(out, v) != 0) {
      Py_XDECREF(v);
      Py_DECREF(out);
      return nullptr;
    }
    Py_DECREF(v);
  }
  for (Loop* lp : eng->loops) {
    if (lp->listen_fd < 0) continue;
    PyObject* v = PyLong_FromLong(lp->listen_fd);
    if (!v || PyList_Append(out, v) != 0) {
      Py_XDECREF(v);
      Py_DECREF(out);
      return nullptr;
    }
    Py_DECREF(v);
  }
  return out;
}

// set_busy_poll_us(us) — arm/disarm the pre-epoll busy-poll spin.
// Runtime-settable (relaxed atomic): flag flips take effect on the
// next loop iteration.
static PyObject* Engine_set_busy_poll_us(EngineObj* self,
                                         PyObject* args) {
  int us;
  if (!PyArg_ParseTuple(args, "i", &us)) return nullptr;
  if (us < 0) us = 0;
  if (us > 1000000) us = 1000000;   // 1s: far past any sane spin
  self->eng->busy_poll_us.store(us, std::memory_order_relaxed);
  Py_RETURN_NONE;
}

// run_loop(index) — the body of one event loop, called from a Python
// thread in external_loops mode.  Blocks (GIL released) until stop().
// The calling thread's resident Python frames keep the datastack
// chunk mapped, so per-burst handler dispatch avoids mmap churn.
static PyObject* Engine_run_loop(EngineObj* self, PyObject* args) {
  int idx;
  if (!PyArg_ParseTuple(args, "i", &idx)) return nullptr;
  EngineImpl* eng = self->eng;
  if (idx < 0 || (size_t)idx >= eng->loops.size()) {
    PyErr_SetString(PyExc_IndexError, "loop index out of range");
    return nullptr;
  }
  Loop* lp = eng->loops[idx];
  Py_BEGIN_ALLOW_THREADS;
  loop_run(lp);
  Py_END_ALLOW_THREADS;
  Py_RETURN_NONE;
}

// register_native_method(svc, mth, kind, data=b"", handler=None) —
// pre-listen only.  kind 0 = echo (payload+attachment back unchanged),
// 1 = const(data), 2 = Python @raw_method handler called from the
// engine loop (burst-batched; one GIL entry per read burst),
// 3 = slim full-method dispatch shim (burst-batched like 2; called as
// handler(payload, att, cid, conn_id, dom, nonce, recv_ns, trace,
// timeout_ms), None return = out-of-band).
static PyObject* Engine_register_native_method(EngineObj* self,
                                               PyObject* args) {
  const char* svc;
  const char* mth;
  int kind;
  Py_buffer data = {};
  PyObject* handler = nullptr;
  if (!PyArg_ParseTuple(args, "ssi|y*O", &svc, &mth, &kind, &data,
                        &handler))
    return nullptr;
  EngineImpl* eng = self->eng;
  if (eng->started) {
    if (data.obj) PyBuffer_Release(&data);
    PyErr_SetString(PyExc_RuntimeError,
                    "native methods must be registered before listen()");
    return nullptr;
  }
  if (kind < 0 || kind > 3) {
    if (data.obj) PyBuffer_Release(&data);
    PyErr_SetString(PyExc_ValueError, "unknown native method kind");
    return nullptr;
  }
  if (kind >= 2 && (handler == nullptr || handler == Py_None
                    || !PyCallable_Check(handler))) {
    if (data.obj) PyBuffer_Release(&data);
    PyErr_SetString(PyExc_TypeError,
                    "kind 2/3 requires a callable handler");
    return nullptr;
  }
  std::string key(svc);
  key.push_back('\0');
  key.append(mth);
  auto it = eng->native_methods.find(key);
  NativeMethod* m = it != eng->native_methods.end() ? it->second
                                                    : new NativeMethod();
  m->kind = kind;
  if (data.obj) {
    m->const_data.assign((const char*)data.buf, (size_t)data.len);
    PyBuffer_Release(&data);
  } else {
    m->const_data.clear();
  }
  Py_XDECREF(m->handler);
  m->handler = nullptr;
  if (kind >= 2) {
    Py_INCREF(handler);
    m->handler = handler;
  }
  eng->native_methods[key] = m;
  Py_RETURN_NONE;
}

// set_burst_end(callable_or_None) — per-burst accounting epilogue for
// the batched shim lanes; pre-listen only (loops read it lock-free)
static PyObject* Engine_set_burst_end(EngineObj* self, PyObject* args) {
  PyObject* cb;
  if (!PyArg_ParseTuple(args, "O", &cb)) return nullptr;
  if (self->eng->started) {
    PyErr_SetString(PyExc_RuntimeError,
                    "burst_end must be set before listen()");
    return nullptr;
  }
  if (cb != Py_None && !PyCallable_Check(cb)) {
    PyErr_SetString(PyExc_TypeError, "burst_end must be callable");
    return nullptr;
  }
  Py_XDECREF(self->eng->burst_end);
  self->eng->burst_end = nullptr;
  if (cb != Py_None) {
    Py_INCREF(cb);
    self->eng->burst_end = cb;
  }
  Py_RETURN_NONE;
}

static PyObject* Engine_set_native_dispatch(EngineObj* self,
                                            PyObject* args) {
  int on;
  if (!PyArg_ParseTuple(args, "p", &on)) return nullptr;
  self->eng->native_dispatch.store(on != 0, std::memory_order_relaxed);
  Py_RETURN_NONE;
}

// ---------------------------------------------------------------------------
// Kind-5 streaming lane: per-method stream-open shims, batched chunk
// delivery, and the WRITE side — C++-accounted credit windows with
// chunk coalescing (many streams' chunks -> one owned buffer -> one
// writev per connection).
// ---------------------------------------------------------------------------

// set_stream_shim(svc, mth, handler) — kind-5 stream-OPEN shim for an
// already-registered kind-3 method; pre-listen only.
static PyObject* Engine_set_stream_shim(EngineObj* self, PyObject* args) {
  const char* svc;
  const char* mth;
  PyObject* handler;
  if (!PyArg_ParseTuple(args, "ssO", &svc, &mth, &handler))
    return nullptr;
  EngineImpl* eng = self->eng;
  if (eng->started) {
    PyErr_SetString(PyExc_RuntimeError,
                    "stream shims must be set before listen()");
    return nullptr;
  }
  if (!PyCallable_Check(handler)) {
    PyErr_SetString(PyExc_TypeError, "stream shim must be callable");
    return nullptr;
  }
  std::string key(svc);
  key.push_back('\0');
  key.append(mth);
  auto it = eng->native_methods.find(key);
  if (it == eng->native_methods.end() || it->second->kind != 3) {
    PyErr_SetString(PyExc_ValueError,
                    "stream shim requires a registered kind-3 method");
    return nullptr;
  }
  Py_INCREF(handler);
  Py_XDECREF(it->second->stream_handler);
  it->second->stream_handler = handler;
  Py_RETURN_NONE;
}

// set_stream_chunks(callable_or_None) — the ONE batched chunk-delivery
// entry: callable(list[(sid, flags, payload_bytes)]); pre-listen only.
static PyObject* Engine_set_stream_chunks(EngineObj* self,
                                          PyObject* args) {
  PyObject* cb;
  if (!PyArg_ParseTuple(args, "O", &cb)) return nullptr;
  if (self->eng->started) {
    PyErr_SetString(PyExc_RuntimeError,
                    "stream_chunks must be set before listen()");
    return nullptr;
  }
  if (cb != Py_None && !PyCallable_Check(cb)) {
    PyErr_SetString(PyExc_TypeError, "stream_chunks must be callable");
    return nullptr;
  }
  Py_XDECREF(self->eng->stream_chunks);
  self->eng->stream_chunks = nullptr;
  if (cb != Py_None) {
    Py_INCREF(cb);
    self->eng->stream_chunks = cb;
  }
  Py_RETURN_NONE;
}

// set_stream_mode(mode) — 0 = lane off, 1 = on, 2 = declined because
// the server runs user code off the loop; names the fallback reason.
static PyObject* Engine_set_stream_mode(EngineObj* self, PyObject* args) {
  int mode;
  if (!PyArg_ParseTuple(args, "i", &mode)) return nullptr;
  if (mode < 0 || mode > 2) {
    PyErr_SetString(PyExc_ValueError, "stream mode must be 0, 1 or 2");
    return nullptr;
  }
  self->eng->stream_mode.store(mode, std::memory_order_relaxed);
  Py_RETURN_NONE;
}

// stream_register(conn_id, sid, peer_sid, window) — adopt one accepted
// stream onto the kind-5 lane.  Called by the stream-open shim (GIL
// held, ON the owning loop inside the batched entry) BEFORE the grant
// response leaves, so no peer frame can race the registration.
static PyObject* Engine_stream_register(EngineObj* self, PyObject* args) {
  unsigned long long conn_id, sid, peer_sid, window;
  if (!PyArg_ParseTuple(args, "KKKK", &conn_id, &sid, &peer_sid,
                        &window))
    return nullptr;
  EngineImpl* eng = self->eng;
  auto ns = std::make_shared<NativeStream>();
  ns->sid = sid;
  ns->peer_sid = peer_sid;
  ns->conn_id = conn_id;
  ns->window = window ? window : (2ull << 20);
  {
    std::lock_guard<std::mutex> g(eng->smu);
    eng->streams[sid] = ns;
    eng->nstreams.store(eng->streams.size(), std::memory_order_release);
  }
  Py_RETURN_NONE;
}

// stream_unregister(sid) — drop a stream from the lane (close path).
// Blocked producers wake with "closed".  Returns whether it was ours.
static PyObject* Engine_stream_unregister(EngineObj* self,
                                          PyObject* args) {
  unsigned long long sid;
  if (!PyArg_ParseTuple(args, "K", &sid)) return nullptr;
  EngineImpl* eng = self->eng;
  std::shared_ptr<NativeStream> ns;
  {
    std::lock_guard<std::mutex> g(eng->smu);
    auto it = eng->streams.find(sid);
    if (it != eng->streams.end()) {
      ns = it->second;
      eng->streams.erase(it);
      eng->nstreams.store(eng->streams.size(),
                          std::memory_order_release);
    }
  }
  if (!ns) Py_RETURN_FALSE;
  {
    std::lock_guard<std::mutex> g(ns->mu);
    ns->closed = true;
    ns->cv.notify_all();
  }
  Py_RETURN_TRUE;
}

// build one TSTR frame header (17 bytes) into out
static void stream_frame_head(std::string& out, uint8_t flags,
                              uint64_t dest, uint32_t len) {
  char h[17];
  memcpy(h, "TSTR", 4);
  h[4] = (char)flags;
  memcpy(h + 5, &dest, 8);
  memcpy(h + 13, &len, 4);
  out.append(h, 17);
}

// Reserve `len` bytes of write credit on ns, blocking (caller must NOT
// hold the GIL) until the peer's feedback frees window or timeout.
// Python-lane parity: a write is admitted while ANY credit remains —
// requiring room for the whole chunk would deadlock chunks larger
// than the window.  0 = ok, -1 = credit timeout, -2 = closed.
static int stream_reserve(EngineImpl* eng, NativeStream* ns, size_t len,
                          int timeout_ms) {
  std::unique_lock<std::mutex> g(ns->mu);
  if (ns->closed) return -2;
  if (ns->produced - ns->remote_consumed >= ns->window) {
    eng->s_credit_stalls++;
    bool ok = ns->cv.wait_for(
        g, std::chrono::milliseconds(timeout_ms > 0 ? timeout_ms : 1),
        [&] {
          return ns->closed
                 || ns->produced - ns->remote_consumed < ns->window;
        });
    if (!ok) return -1;
  }
  if (ns->closed) return -2;
  ns->produced += (uint64_t)len;
  return 0;
}

// queue one owned buffer on conn_id and hand the flush to the owning
// loop (GIL must be held: it serializes this against conn_destroy's
// delete, exactly like Engine_send).  Consumes `s` either way.
static bool send_owned(EngineImpl* eng, uint64_t conn_id,
                       std::string* s) {
  Conn* c = nullptr;
  {
    std::lock_guard<std::mutex> g(eng->cmu);
    auto it = eng->by_id.find(conn_id);
    if (it != eng->by_id.end()) c = it->second;
  }
  if (!c || c->dead || c->closing) {
    delete s;
    return false;
  }
  {
    std::lock_guard<std::mutex> g(c->wmu);
    WriteItem it;
    memset(&it.view, 0, sizeof(it.view));
    it.view.buf = (void*)s->data();
    it.view.len = (Py_ssize_t)s->size();
    it.owned_str = s;
    c->wq.push_back(it);
  }
  bool expect = false;
  if (c->flush_queued.compare_exchange_strong(
          expect, true, std::memory_order_acq_rel))
    loop_post(c->loop, c->id, HO_FLUSH);
  return true;
}

// stream_write_many(items, timeout_ms=10000) -> list[int] — the burst
// write path: items is [(sid, payload), ...]; chunks are credit-
// reserved in order (GIL RELEASED across the waits — a stalled stream
// blocks only its producer thread, never a loop), framed into ONE
// owned buffer per connection and shipped as one writev.  Per-item
// status: 0 = queued, -1 = credit exhaustion (backpressure — the
// producer should yield and retry), -2 = stream closed/unknown.
static PyObject* Engine_stream_write_many(EngineObj* self,
                                          PyObject* args) {
  PyObject* items;
  int timeout_ms = 10000;
  if (!PyArg_ParseTuple(args, "O|i", &items, &timeout_ms))
    return nullptr;
  EngineImpl* eng = self->eng;
  PyObject* seq = PySequence_Fast(items, "items must be a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  struct Pend {
    uint64_t sid = 0;
    Py_buffer buf = {};
    int status = -2;
    std::shared_ptr<NativeStream> ns;
  };
  std::vector<Pend> pend((size_t)n);
  bool argerr = false;
  for (Py_ssize_t i = 0; i < n && !argerr; i++) {
    PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
    if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 2) {
      argerr = true;
      break;
    }
    unsigned long long sid =
        PyLong_AsUnsignedLongLong(PyTuple_GET_ITEM(item, 0));
    if (sid == (unsigned long long)-1 && PyErr_Occurred()) {
      argerr = true;
      break;
    }
    if (PyObject_GetBuffer(PyTuple_GET_ITEM(item, 1), &pend[i].buf,
                           PyBUF_SIMPLE) != 0) {
      argerr = true;
      break;
    }
    pend[i].sid = sid;
    {
      std::lock_guard<std::mutex> g(eng->smu);
      auto it = eng->streams.find(sid);
      if (it != eng->streams.end()) pend[i].ns = it->second;
    }
  }
  if (argerr) {
    for (auto& p : pend)
      if (p.buf.obj) PyBuffer_Release(&p.buf);
    Py_DECREF(seq);
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_TypeError,
                      "items must be (sid, payload) tuples");
    return nullptr;
  }
  eng->s_write_batches++;
  // credit + framing with the GIL released: the Py_buffer views stay
  // pinned by the references taken above.  timeout_ms bounds the
  // WHOLE batch, not each item: N simultaneously stalled streams must
  // cost the caller one bounded stall, not N of them (the continuous
  // batcher's one-short-stall-then-evict contract)
  std::unordered_map<uint64_t, std::string*> per_conn;
  Py_BEGIN_ALLOW_THREADS;
  auto t_end = std::chrono::steady_clock::now()
               + std::chrono::milliseconds(timeout_ms > 0 ? timeout_ms
                                                          : 1);
  for (auto& p : pend) {
    if (!p.ns) continue;            // status stays -2
    int left_ms = (int)std::chrono::duration_cast<
        std::chrono::milliseconds>(
        t_end - std::chrono::steady_clock::now()).count();
    if (left_ms < 1) left_ms = 1;   // budget spent: fail fast, 1ms cap
    int st = stream_reserve(eng, p.ns.get(), (size_t)p.buf.len,
                            left_ms);
    p.status = st;
    if (st != 0) continue;
    std::string*& out = per_conn[p.ns->conn_id];
    if (out == nullptr) out = new std::string();
    stream_frame_head(*out, 0 /* F_DATA */, p.ns->peer_sid,
                      (uint32_t)p.buf.len);
    out->append((const char*)p.buf.buf, (size_t)p.buf.len);
    eng->s_chunks_out++;
    eng->s_chunk_bytes_out += (uint64_t)p.buf.len;
  }
  Py_END_ALLOW_THREADS;
  // a dead/closing connection drops its whole buffer: report those
  // items closed (-2), not success — the Python lane answers
  // EFAILEDSOCKET for the same state, and the decode batcher keys
  // eviction off the status
  std::unordered_set<uint64_t> dead_conns;
  for (auto& kv : per_conn)
    if (!send_owned(eng, kv.first, kv.second))
      dead_conns.insert(kv.first);
  if (!dead_conns.empty()) {
    for (auto& p : pend)
      if (p.status == 0 && p.ns
          && dead_conns.count(p.ns->conn_id) != 0)
        p.status = -2;
  }
  PyObject* out = PyList_New(n);
  bool ok = out != nullptr;
  for (Py_ssize_t i = 0; ok && i < n; i++) {
    PyObject* v = PyLong_FromLong(pend[i].status);
    if (!v) ok = false;
    else PyList_SET_ITEM(out, i, v);
  }
  for (auto& p : pend)
    if (p.buf.obj) PyBuffer_Release(&p.buf);
  Py_DECREF(seq);
  if (!ok) {
    Py_XDECREF(out);
    return nullptr;
  }
  return out;
}

// stream_write(sid, payload, timeout_ms=10000) -> int — single-chunk
// convenience over the same reserve/frame/ship path.
static PyObject* Engine_stream_write(EngineObj* self, PyObject* args) {
  unsigned long long sid;
  Py_buffer buf = {};
  int timeout_ms = 10000;
  if (!PyArg_ParseTuple(args, "Ky*|i", &sid, &buf, &timeout_ms))
    return nullptr;
  EngineImpl* eng = self->eng;
  std::shared_ptr<NativeStream> ns;
  {
    std::lock_guard<std::mutex> g(eng->smu);
    auto it = eng->streams.find(sid);
    if (it != eng->streams.end()) ns = it->second;
  }
  int st = -2;
  std::string* s = nullptr;
  if (ns) {
    Py_BEGIN_ALLOW_THREADS;
    st = stream_reserve(eng, ns.get(), (size_t)buf.len, timeout_ms);
    if (st == 0) {
      s = new (std::nothrow) std::string();
      if (s) {
        stream_frame_head(*s, 0 /* F_DATA */, ns->peer_sid,
                          (uint32_t)buf.len);
        s->append((const char*)buf.buf, (size_t)buf.len);
      } else {
        // frame alloc failed AFTER the credit reservation: roll the
        // reservation back, or the window shrinks by bytes the peer
        // can never ack (permanent spurious backpressure)
        std::lock_guard<std::mutex> g(ns->mu);
        ns->produced -= (uint64_t)buf.len;
      }
    }
    Py_END_ALLOW_THREADS;
  }
  if (s != nullptr) {
    if (send_owned(eng, ns->conn_id, s)) {
      eng->s_chunks_out++;
      eng->s_chunk_bytes_out += (uint64_t)buf.len;
    } else {
      st = -2;       // conn dead/closing: the chunk was dropped — the
    }                // Python lane's EFAILEDSOCKET shape, not success
  }
  PyBuffer_Release(&buf);
  return PyLong_FromLong(st == 0 && s == nullptr ? -2 : st);
}

// register_http_route(method, path, handler) — pre-listen only.  The
// SLIM HTTP LANE (kind 4): eligible HTTP/1.1 requests matching
// METHOD+path are parsed in C++, burst-batched, and dispatched to the
// shim as handler(body, query, content_type, att_size, conn_id,
// recv_ns, traceparent, x_deadline_ms, x_tenant); a
// (status, header_block, body) return is serialized natively, bytes
// are appended verbatim (pre-built classic escalations), None means
// the shim completed out-of-band.
static PyObject* Engine_register_http_route(EngineObj* self,
                                            PyObject* args) {
  const char* method;
  const char* path;
  PyObject* handler;
  if (!PyArg_ParseTuple(args, "ssO", &method, &path, &handler))
    return nullptr;
  EngineImpl* eng = self->eng;
  if (eng->started) {
    PyErr_SetString(PyExc_RuntimeError,
                    "http routes must be registered before listen()");
    return nullptr;
  }
  if (!PyCallable_Check(handler)) {
    PyErr_SetString(PyExc_TypeError, "handler must be callable");
    return nullptr;
  }
  std::string key(method);
  key.push_back('\0');
  key.append(path);
  auto it = eng->http_routes.find(key);
  HttpRoute* r = it != eng->http_routes.end() ? it->second
                                              : new HttpRoute();
  Py_INCREF(handler);
  Py_XDECREF(r->handler);
  r->handler = handler;
  eng->http_routes[key] = r;
  Py_RETURN_NONE;
}

static PyObject* Engine_set_http_slim(EngineObj* self, PyObject* args) {
  int on;
  if (!PyArg_ParseTuple(args, "p", &on)) return nullptr;
  self->eng->http_slim.store(on != 0, std::memory_order_relaxed);
  Py_RETURN_NONE;
}

// http_slim_stats() -> {"METHOD path": (handled, errors)}, or
// http_slim_stats(method, path) -> (handled, errors)
static PyObject* Engine_http_slim_stats(EngineObj* self, PyObject* args) {
  EngineImpl* eng = self->eng;
  const char* method = nullptr;
  const char* path = nullptr;
  if (!PyArg_ParseTuple(args, "|ss", &method, &path)) return nullptr;
  if (method != nullptr && path != nullptr) {
    std::string key(method);
    key.push_back('\0');
    key.append(path);
    auto it = eng->http_routes.find(key);
    if (it == eng->http_routes.end())
      return Py_BuildValue("(KK)", 0ULL, 0ULL);
    return Py_BuildValue("(KK)",
                         (unsigned long long)it->second->count.load(),
                         (unsigned long long)it->second->errors.load());
  }
  PyObject* d = PyDict_New();
  if (!d) return nullptr;
  for (auto& kv : eng->http_routes) {
    std::string name = kv.first;
    size_t z = name.find('\0');
    if (z != std::string::npos) name[z] = ' ';
    PyObject* t = Py_BuildValue(
        "(KK)", (unsigned long long)kv.second->count.load(),
        (unsigned long long)kv.second->errors.load());
    if (!t || PyDict_SetItemString(d, name.c_str(), t) != 0) {
      Py_XDECREF(t);
      Py_DECREF(d);
      return nullptr;
    }
    Py_DECREF(t);
  }
  return d;
}

static PyObject* Engine_set_domain_tlv(EngineObj* self, PyObject* args) {
  Py_buffer data = {};
  if (!PyArg_ParseTuple(args, "y*", &data)) return nullptr;
  if (self->eng->started) {
    PyBuffer_Release(&data);
    PyErr_SetString(PyExc_RuntimeError,
                    "domain TLV must be set before listen()");
    return nullptr;
  }
  self->eng->domain_tlv.assign((const char*)data.buf, (size_t)data.len);
  PyBuffer_Release(&data);
  Py_RETURN_NONE;
}

static PyObject* Engine_set_http_max_body(EngineObj* self,
                                          PyObject* args) {
  unsigned long long n;
  if (!PyArg_ParseTuple(args, "K", &n)) return nullptr;
  if (n > (unsigned long long)kMaxBody) n = kMaxBody;
  self->eng->http_max_body.store((size_t)n, std::memory_order_relaxed);
  Py_RETURN_NONE;
}

// native_stats() -> {"svc.mth": (answered, errors)}, or
// native_stats(svc, mth) -> (answered, errors) — counters of natively-
// dispatched requests (they never reach Python's MethodStatus; bvar
// PassiveStatus readers surface these; the two-arg form avoids
// materializing the whole map per metric read)
static PyObject* Engine_native_stats(EngineObj* self, PyObject* args) {
  EngineImpl* eng = self->eng;
  const char* svc = nullptr;
  const char* mth = nullptr;
  if (!PyArg_ParseTuple(args, "|ss", &svc, &mth)) return nullptr;
  if (svc != nullptr && mth != nullptr) {
    std::string key(svc);
    key.push_back('\0');
    key.append(mth);
    auto it = eng->native_methods.find(key);
    if (it == eng->native_methods.end())
      return Py_BuildValue("(KK)", 0ULL, 0ULL);
    return Py_BuildValue("(KK)",
                         (unsigned long long)it->second->count.load(),
                         (unsigned long long)it->second->errors.load());
  }
  PyObject* d = PyDict_New();
  if (!d) return nullptr;
  for (auto& kv : eng->native_methods) {
    std::string name = kv.first;
    size_t z = name.find('\0');
    if (z != std::string::npos) name[z] = '.';
    PyObject* t = Py_BuildValue(
        "(KK)", (unsigned long long)kv.second->count.load(),
        (unsigned long long)kv.second->errors.load());
    if (!t || PyDict_SetItemString(d, name.c_str(), t) != 0) {
      Py_XDECREF(t);
      Py_DECREF(d);
      return nullptr;
    }
    Py_DECREF(t);
  }
  return d;
}

// ---- telemetry snapshot helpers (GIL held) ----

static PyObject* hist_buckets(const uint64_t* b) {
  PyObject* l = PyList_New(kHistBuckets);
  if (!l) return nullptr;
  for (int i = 0; i < kHistBuckets; i++) {
    PyObject* v = PyLong_FromUnsignedLongLong(b[i]);
    if (!v) {
      Py_DECREF(l);
      return nullptr;
    }
    PyList_SET_ITEM(l, i, v);
  }
  return l;
}

static int set_u64(PyObject* d, const char* k, uint64_t v) {
  PyObject* o = PyLong_FromUnsignedLongLong(v);
  if (!o) return -1;
  int rc = PyDict_SetItemString(d, k, o);
  Py_DECREF(o);
  return rc;
}

// set "<name>": bucket list, "<name>_count", "<name>_sum" on d
static int set_hist(PyObject* d, const char* name, const Hist& h) {
  PyObject* l = hist_buckets(h.b);
  if (!l) return -1;
  int rc = PyDict_SetItemString(d, name, l);
  Py_DECREF(l);
  if (rc != 0) return -1;
  char key[64];
  snprintf(key, sizeof key, "%s_count", name);
  if (set_u64(d, key, h.count) != 0) return -1;
  snprintf(key, sizeof key, "%s_sum", name);
  return set_u64(d, key, h.sum);
}

static void hist_merge(Hist& dst, const Hist& src) {
  for (int i = 0; i < kHistBuckets; i++) dst.b[i] += src.b[i];
  dst.count += src.count;
  dst.sum += src.sum;
}

// telemetry() -> one dict with the engine's whole observability table:
// reason-coded fallback counters, per-lane stage histograms
// (queue/shim/resid, log2-us buckets), burst & writev-coalescing
// distributions, write-queue/inbuf high-water marks, per-loop
// busy/idle nanoseconds, and per-method/per-route breakdowns.  ONE
// GIL crossing serves every bvar/portal reader per sampling interval
// — replaces the per-var native_stats/http_slim_stats polling.
static PyObject* Engine_telemetry(EngineObj* self, PyObject*) {
  EngineImpl* eng = self->eng;
  // aggregate per-loop counters (racy by design: each loop's thread
  // owns its LoopTelemetry; a snapshot may trail a few increments,
  // which monotonic counters tolerate)
  uint64_t fb[FB_REASONS] = {};
  uint64_t sfb[SFB_REASONS] = {};
  Hist queue[kLanes], shim[kLanes], resid[kLanes], burst, wiov, sburst;
  uint64_t wq_hwm = 0, inbuf_hwm = 0;
  uint64_t s_chunks_in = 0, s_feedbacks = 0;
  uint64_t dp[kDpStages] = {}, dpb[kDpStages] = {};
  PyObject* loops = PyList_New((Py_ssize_t)eng->loops.size());
  if (!loops) return nullptr;
  for (size_t i = 0; i < eng->loops.size(); i++) {
    const LoopTelemetry& t = eng->loops[i]->tel;
    for (int r = 0; r < FB_REASONS; r++) fb[r] += t.fallbacks[r];
    for (int r = 0; r < SFB_REASONS; r++) sfb[r] += t.sfallbacks[r];
    for (int s = 0; s < kDpStages; s++) {
      dp[s] += t.dp_copies[s];
      dpb[s] += t.dp_copy_bytes[s];
    }
    for (int ln = 0; ln < kLanes; ln++) {
      hist_merge(queue[ln], t.queue[ln]);
      hist_merge(shim[ln], t.shim[ln]);
      hist_merge(resid[ln], t.resid[ln]);
    }
    hist_merge(burst, t.burst);
    hist_merge(sburst, t.stream_burst);
    s_chunks_in += t.stream_chunks_in;
    s_feedbacks += t.stream_feedbacks;
    hist_merge(wiov, t.wiov);
    if (t.wq_hwm > wq_hwm) wq_hwm = t.wq_hwm;
    if (t.inbuf_hwm > inbuf_hwm) inbuf_hwm = t.inbuf_hwm;
    PyObject* lo = Py_BuildValue(
        "{s:K,s:K,s:K,s:K,s:K,s:K,s:K}",
        "busy_ns", (unsigned long long)t.busy_ns,
        "idle_ns", (unsigned long long)t.idle_ns,
        "polls", (unsigned long long)t.polls,
        "spin_polls", (unsigned long long)t.spin_polls,
        "accepts", (unsigned long long)t.accepts,
        "frames", (unsigned long long)t.frames,
        "handoffs", (unsigned long long)t.handoffs);
    if (!lo) {
      Py_DECREF(loops);
      return nullptr;
    }
    PyList_SET_ITEM(loops, (Py_ssize_t)i, lo);
  }
  // per-lane handled/errors roll up from the registered handlers
  uint64_t handled[kLanes] = {}, errors[kLanes] = {};
  PyObject* methods = PyDict_New();
  if (!methods) {
    Py_DECREF(loops);
    return nullptr;
  }
  for (auto& kv : eng->native_methods) {
    NativeMethod* m = kv.second;
    uint64_t cnt = m->count.load(std::memory_order_relaxed);
    uint64_t err = m->errors.load(std::memory_order_relaxed);
    uint64_t sop = m->stream_opens.load(std::memory_order_relaxed);
    uint64_t serr = m->stream_errors.load(std::memory_order_relaxed);
    if (m->kind == 2) {
      handled[LANE_RAW] += cnt;
      errors[LANE_RAW] += err;
    } else if (m->kind == 3) {
      handled[LANE_SLIM] += cnt;
      errors[LANE_SLIM] += err;
    }
    handled[LANE_STREAM] += sop;
    errors[LANE_STREAM] += serr;
    std::string name = kv.first;
    size_t z = name.find('\0');
    if (z != std::string::npos) name[z] = '.';
    PyObject* md = Py_BuildValue(
        "{s:i,s:K,s:K,s:K,s:K,s:K,s:K,s:K,s:K}", "kind", m->kind,
        "handled",
        (unsigned long long)cnt, "errors", (unsigned long long)err,
        "stream_opens", (unsigned long long)sop,
        "stream_errors", (unsigned long long)serr,
        "fb_rpc_att_over_cap",
        (unsigned long long)m->fb_att_over_cap.load(
            std::memory_order_relaxed),
        "fb_rpc_large_frame",
        (unsigned long long)m->fb_large_frame.load(
            std::memory_order_relaxed),
        "fb_rpc_trace_raw_lane",
        (unsigned long long)m->fb_trace_raw.load(
            std::memory_order_relaxed),
        "fb_stream_open",
        (unsigned long long)m->fb_stream_open.load(
            std::memory_order_relaxed));
    if (!md || PyDict_SetItemString(methods, name.c_str(), md) != 0) {
      Py_XDECREF(md);
      Py_DECREF(methods);
      Py_DECREF(loops);
      return nullptr;
    }
    Py_DECREF(md);
  }
  PyObject* routes = PyDict_New();
  if (!routes) {
    Py_DECREF(methods);
    Py_DECREF(loops);
    return nullptr;
  }
  for (auto& kv : eng->http_routes) {
    HttpRoute* r = kv.second;
    uint64_t cnt = r->count.load(std::memory_order_relaxed);
    uint64_t err = r->errors.load(std::memory_order_relaxed);
    handled[LANE_HTTP] += cnt;
    errors[LANE_HTTP] += err;
    std::string name = kv.first;
    size_t z = name.find('\0');
    if (z != std::string::npos) name[z] = ' ';
    PyObject* rd = Py_BuildValue(
        "{s:K,s:K}", "handled", (unsigned long long)cnt, "errors",
        (unsigned long long)err);
    bool ok = rd != nullptr;
    for (int i = 0; ok && i < kRouteFb; i++) {
      char key[48];
      snprintf(key, sizeof key, "fb_%s", kRouteFbNames[i]);
      ok = set_u64(rd, key,
                   r->fb[i].load(std::memory_order_relaxed)) == 0;
    }
    if (!ok || PyDict_SetItemString(routes, name.c_str(), rd) != 0) {
      Py_XDECREF(rd);
      Py_DECREF(routes);
      Py_DECREF(methods);
      Py_DECREF(loops);
      return nullptr;
    }
    Py_DECREF(rd);
  }
  PyObject* out = PyDict_New();
  PyObject* fbd = PyDict_New();
  PyObject* lanes = PyDict_New();
  bool ok = out && fbd && lanes;
  for (int r = 0; ok && r < FB_REASONS; r++)
    ok = set_u64(fbd, kFbNames[r], fb[r]) == 0;
  // kind-5 stream reasons ride the same fallback family (closed enum,
  // one flat dict for /native + the fallback_total bvar) AND the
  // dedicated streams section below
  for (int r = 0; ok && r < SFB_REASONS; r++)
    ok = set_u64(fbd, kStreamFbNames[r], sfb[r]) == 0;
  for (int ln = 0; ok && ln < kLanes; ln++) {
    PyObject* ld = PyDict_New();
    ok = ld != nullptr;
    if (ok) ok = set_u64(ld, "handled", handled[ln]) == 0;
    if (ok) ok = set_u64(ld, "errors", errors[ln]) == 0;
    if (ok) ok = set_hist(ld, "queue_us", queue[ln]) == 0;
    if (ok) ok = set_hist(ld, "shim_us", shim[ln]) == 0;
    if (ok) ok = set_hist(ld, "resid_us", resid[ln]) == 0;
    if (ok) ok = PyDict_SetItemString(lanes, kLaneNames[ln], ld) == 0;
    Py_XDECREF(ld);
  }
  if (ok) ok = PyDict_SetItemString(out, "fallbacks", fbd) == 0;
  if (ok) ok = PyDict_SetItemString(out, "lanes", lanes) == 0;
  if (ok) {
    // data-plane copy ledger: every engine-side payload memcpy ≥4KB by
    // stage — the zero-copy invariant tests diff this around a call
    PyObject* dpc = PyDict_New();
    PyObject* dpB = PyDict_New();
    ok = dpc && dpB;
    for (int s = 0; ok && s < kDpStages; s++) {
      ok = set_u64(dpc, kDpNames[s], dp[s]) == 0
           && set_u64(dpB, kDpNames[s], dpb[s]) == 0;
    }
    if (ok) ok = PyDict_SetItemString(out, "data_plane_copies", dpc) == 0;
    if (ok)
      ok = PyDict_SetItemString(out, "data_plane_copy_bytes", dpB) == 0;
    Py_XDECREF(dpc);
    Py_XDECREF(dpB);
  }
  if (ok) {
    // loop-pinning map: conn id -> {loop index, frames parsed}.  The
    // id/loop/frames triples snapshot under cmu into plain C++ storage
    // FIRST (no Python allocation while the lock is held: an
    // allocation-triggered GC finalizer calling back into the engine
    // would self-deadlock on the non-recursive mutex), then
    // materialize.  Loop ownership is fixed at accept; frame counts
    // are racy monotonic reads, same discipline as the rest.
    struct ConnSnap { uint64_t id; int loop; uint64_t frames; };
    std::vector<ConnSnap> snap;
    {
      std::lock_guard<std::mutex> g(eng->cmu);
      snap.reserve(eng->by_id.size());
      for (auto& kv : eng->by_id) {
        Conn* c = kv.second;
        snap.push_back({kv.first, c->loop ? c->loop->index : -1,
                        c->frames});
      }
    }
    PyObject* conns = PyDict_New();
    ok = conns != nullptr;
    for (size_t i = 0; ok && i < snap.size(); i++) {
      PyObject* key = PyLong_FromUnsignedLongLong(snap[i].id);
      PyObject* cd = Py_BuildValue(
          "{s:i,s:K}", "loop", snap[i].loop, "frames",
          (unsigned long long)snap[i].frames);
      ok = key != nullptr && cd != nullptr
           && PyDict_SetItem(conns, key, cd) == 0;
      Py_XDECREF(key);
      Py_XDECREF(cd);
    }
    if (ok) ok = PyDict_SetItemString(out, "conns", conns) == 0;
    Py_XDECREF(conns);
  }
  if (ok) {
    // kind-5 streaming section: streams open, chunk/burst/credit
    // accounting — the /native "streaming" block and the
    // native_stream_* bvars read this
    PyObject* sd = PyDict_New();
    ok = sd != nullptr;
    if (ok)
      ok = set_u64(sd, "open",
                   (uint64_t)eng->nstreams.load(
                       std::memory_order_relaxed)) == 0;
    if (ok) ok = set_u64(sd, "chunks_in", s_chunks_in) == 0;
    if (ok) ok = set_u64(sd, "feedbacks_in", s_feedbacks) == 0;
    if (ok)
      ok = set_u64(sd, "chunks_out",
                   eng->s_chunks_out.load(
                       std::memory_order_relaxed)) == 0;
    if (ok)
      ok = set_u64(sd, "chunk_bytes_out",
                   eng->s_chunk_bytes_out.load(
                       std::memory_order_relaxed)) == 0;
    if (ok)
      ok = set_u64(sd, "credit_stalls",
                   eng->s_credit_stalls.load(
                       std::memory_order_relaxed)) == 0;
    if (ok)
      ok = set_u64(sd, "write_batches",
                   eng->s_write_batches.load(
                       std::memory_order_relaxed)) == 0;
    if (ok) ok = set_hist(sd, "chunk_burst", sburst) == 0;
    if (ok) {
      PyObject* sfd = PyDict_New();
      ok = sfd != nullptr;
      for (int r = 0; ok && r < SFB_REASONS; r++)
        ok = set_u64(sfd, kStreamFbNames[r], sfb[r]) == 0;
      if (ok) ok = PyDict_SetItemString(sd, "fallbacks", sfd) == 0;
      Py_XDECREF(sfd);
    }
    if (ok) ok = PyDict_SetItemString(out, "streams", sd) == 0;
    Py_XDECREF(sd);
  }
  if (ok) ok = set_hist(out, "burst", burst) == 0;
  if (ok) ok = set_hist(out, "writev_iov", wiov) == 0;
  if (ok) ok = set_u64(out, "wq_hwm", wq_hwm) == 0;
  if (ok) ok = set_u64(out, "inbuf_hwm", inbuf_hwm) == 0;
  if (ok) ok = PyDict_SetItemString(out, "loops", loops) == 0;
  if (ok) ok = PyDict_SetItemString(out, "methods", methods) == 0;
  if (ok) ok = PyDict_SetItemString(out, "routes", routes) == 0;
  Py_XDECREF(fbd);
  Py_XDECREF(lanes);
  Py_DECREF(loops);
  Py_DECREF(methods);
  Py_DECREF(routes);
  if (!ok) {
    Py_XDECREF(out);
    return nullptr;
  }
  return out;
}

static PyObject* Engine_send(EngineObj* self, PyObject* args) {
  unsigned long long id;
  PyObject* parts;
  if (!PyArg_ParseTuple(args, "KO", &id, &parts)) return nullptr;
  EngineImpl* eng = self->eng;
  Conn* c = nullptr;
  {
    std::lock_guard<std::mutex> g(eng->cmu);
    auto it = eng->by_id.find(id);
    if (it != eng->by_id.end()) c = it->second;
  }
  if (!c || c->dead || c->closing) {
    PyErr_SetString(PyExc_ConnectionError, "connection gone");
    return nullptr;
  }
  PyObject* seq = PySequence_Fast(parts, "parts must be a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  bool try_inline = false;
  {
    std::lock_guard<std::mutex> g(c->wmu);
    bool was_empty = c->wq.empty();
    for (Py_ssize_t i = 0; i < n; i++) {
      PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
      WriteItem it;
      if (PyObject_GetBuffer(item, &it.view, PyBUF_SIMPLE) != 0) {
        Py_DECREF(seq);
        return nullptr;
      }
      if (it.view.len == 0) {
        PyBuffer_Release(&it.view);
        continue;
      }
      c->wq.push_back(it);
    }
    // "write once before KeepWrite" (≈ socket.cpp:1649): when this
    // thread is the sole writer and the payload is small, one inline
    // writev usually drains the whole queue and saves the wake +
    // loop-thread handoff.  The GIL stays HELD: it is what serializes
    // this path against conn_destroy's delete (and the 64KB cap bounds
    // the hold time); nonblocking writev never sleeps.
    //
    // EXCEPTION: on the conn's own loop thread (usercode_inline
    // dispatch mid-parse-burst) the flush is DEFERRED to the loop
    // iteration instead, coalescing a whole pipelined burst of
    // responses into few writevs — otherwise every response wakes the
    // blocked peer and costs two context switches per message.
    size_t queued = 0;
    for (auto& it2 : c->wq) queued += it2.view.len - it2.offset;
    try_inline = was_empty && !c->wq.empty() && queued <= 65536
                 && t_current_loop != c->loop && !c->dead && c->fd >= 0;
    if (try_inline) {
      struct iovec iov[64];
      int ni = 0;
      for (auto it2 = c->wq.begin(); it2 != c->wq.end() && ni < 64;
           ++it2, ++ni) {
        iov[ni].iov_base = (char*)it2->view.buf + it2->offset;
        iov[ni].iov_len = it2->view.len - it2->offset;
      }
      ssize_t w = writev(c->fd, iov, ni);
      if (w > 0) {
        eng->bytes_out += (uint64_t)w;
        size_t left = (size_t)w;
        while (left > 0 && !c->wq.empty()) {
          WriteItem& it3 = c->wq.front();
          size_t avail = it3.view.len - it3.offset;
          if (left >= avail) {
            left -= avail;
            complete_item(c->loop, it3, /*gil_held=*/true);
            c->wq.pop_front();
          } else {
            it3.offset += left;
            left = 0;
          }
        }
      }
      // fatal errors are left to the owning loop's flush to detect
    }
    if (c->wq.empty()) {
      Py_DECREF(seq);
      Py_RETURN_NONE;
    }
  }
  Py_DECREF(seq);
  // hand the remaining flush to the owning loop — the lock-free
  // cross-loop completion handoff (coalesced: the flush_queued CAS
  // admits one node per conn per loop iteration)
  Loop* lp = c->loop;
  bool expect = false;
  if (c->flush_queued.compare_exchange_strong(
          expect, true, std::memory_order_acq_rel))
    loop_post(lp, c->id, HO_FLUSH);
  Py_RETURN_NONE;
}

static PyObject* Engine_close_conn(EngineObj* self, PyObject* args) {
  unsigned long long id;
  if (!PyArg_ParseTuple(args, "K", &id)) return nullptr;
  EngineImpl* eng = self->eng;
  Conn* c = nullptr;
  {
    std::lock_guard<std::mutex> g(eng->cmu);
    auto it = eng->by_id.find(id);
    if (it != eng->by_id.end()) c = it->second;
  }
  if (c) loop_post(c->loop, id, HO_CLOSE);
  Py_RETURN_NONE;
}

static PyObject* Engine_stop(EngineObj* self, PyObject*) {
  EngineImpl* eng = self->eng;
  eng->stopping = true;
  for (Loop* lp : eng->loops) loop_wake(lp);
  Py_BEGIN_ALLOW_THREADS;
  for (Loop* lp : eng->loops) {
    if (lp->thr.joinable()) lp->thr.join();
  }
  Py_END_ALLOW_THREADS;
  Py_RETURN_NONE;
}

static PyObject* Engine_stats(EngineObj* self, PyObject*) {
  EngineImpl* eng = self->eng;
  size_t nconns;
  {
    std::lock_guard<std::mutex> g(eng->cmu);
    nconns = eng->by_id.size();
  }
  return Py_BuildValue(
      "{s:K,s:K,s:K,s:n}", "messages", (unsigned long long)eng->nmessages,
      "bytes_in", (unsigned long long)eng->bytes_in, "bytes_out",
      (unsigned long long)eng->bytes_out, "connections", (Py_ssize_t)nconns);
}

static void Engine_dealloc(EngineObj* self) {
  if (self->eng) {
    self->eng->stopping = true;
    for (Loop* lp : self->eng->loops) loop_wake(lp);
    Py_BEGIN_ALLOW_THREADS;
    for (Loop* lp : self->eng->loops)
      if (lp->thr.joinable()) lp->thr.join();
    Py_END_ALLOW_THREADS;
    for (Loop* lp : self->eng->loops) {
      // nodes posted after the loop thread drained its last batch
      // (close_conn during teardown): free, nothing left to run them
      HandoffNode* head =
          lp->handoff_head.exchange(nullptr, std::memory_order_acquire);
      while (head) {
        HandoffNode* nx = head->next;
        delete head;
        head = nx;
      }
      close(lp->epfd);
      close(lp->wakefd);
      delete lp;
    }
    for (auto& kv : self->eng->native_methods) {
      Py_XDECREF(kv.second->handler);
      Py_XDECREF(kv.second->stream_handler);
      delete kv.second;
    }
    for (auto& kv : self->eng->http_routes) {
      Py_XDECREF(kv.second->handler);
      delete kv.second;
    }
    Py_XDECREF(self->eng->dispatch);
    Py_XDECREF(self->eng->burst_end);
    Py_XDECREF(self->eng->stream_chunks);
    delete self->eng;
  }
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyMethodDef Engine_methods[] = {
    {"listen", (PyCFunction)Engine_listen, METH_VARARGS,
     "adopt a bound+listening fd"},
    {"listen_sharded", (PyCFunction)Engine_listen_sharded, METH_VARARGS,
     "listen_sharded(fds) — one SO_REUSEPORT-bound listening fd per "
     "loop; each loop accepts and pins its own connections"},
    {"set_lame_duck", (PyCFunction)Engine_set_lame_duck, METH_VARARGS,
     "set_lame_duck(mode) — drain: 0 off, 1 = accept pause only, 2 = "
     "pause + lame-duck TLV on native responses + kind-4 declines; "
     "listener fds stay open for a hot-restart successor"},
    {"listener_fds", (PyCFunction)Engine_listener_fds, METH_NOARGS,
     "listener_fds() -> [fd] — bound listening fds for hot-restart "
     "fd passing"},
    {"set_busy_poll_us", (PyCFunction)Engine_set_busy_poll_us,
     METH_VARARGS,
     "set_busy_poll_us(us) — spin this long on zero-timeout polls "
     "before each blocking epoll_wait (0 disables; runtime-settable)"},
    {"run_loop", (PyCFunction)Engine_run_loop, METH_VARARGS,
     "run one event loop on the calling (Python) thread until stop()"},
    {"set_http_max_body", (PyCFunction)Engine_set_http_max_body,
     METH_VARARGS, "cap HTTP request bodies (mirrors max_body_size)"},
    {"set_domain_tlv", (PyCFunction)Engine_set_domain_tlv, METH_VARARGS,
     "pre-encoded local ici-domain TLV for kind-3 domain-exchange "
     "answers; pre-listen only"},
    {"send", (PyCFunction)Engine_send, METH_VARARGS,
     "queue buffers for vectored write on a connection"},
    {"close_conn", (PyCFunction)Engine_close_conn, METH_VARARGS, nullptr},
    {"stop", (PyCFunction)Engine_stop, METH_NOARGS, nullptr},
    {"stats", (PyCFunction)Engine_stats, METH_NOARGS, nullptr},
    {"register_native_method", (PyCFunction)Engine_register_native_method,
     METH_VARARGS,
     "register_native_method(svc, mth, kind, data=b'') — answer the "
     "method in C++ (kind 0=echo, 1=const); pre-listen only"},
    {"set_native_dispatch", (PyCFunction)Engine_set_native_dispatch,
     METH_VARARGS, "enable/disable GIL-free native dispatch at runtime"},
    {"set_burst_end", (PyCFunction)Engine_set_burst_end, METH_VARARGS,
     "set_burst_end(callable|None) — per-burst accounting epilogue "
     "called once after each batched shim entry; pre-listen only"},
    {"set_stream_shim", (PyCFunction)Engine_set_stream_shim,
     METH_VARARGS,
     "set_stream_shim(svc, mth, handler) — kind-5 stream-OPEN shim "
     "for a registered kind-3 method; pre-listen only"},
    {"set_stream_chunks", (PyCFunction)Engine_set_stream_chunks,
     METH_VARARGS,
     "set_stream_chunks(callable|None) — batched chunk delivery: one "
     "call per read burst with [(sid, flags, payload)]; pre-listen "
     "only"},
    {"set_stream_mode", (PyCFunction)Engine_set_stream_mode,
     METH_VARARGS,
     "set_stream_mode(mode) — 0 lane off, 1 on, 2 declined "
     "(non-inline server); names the kind-5 fallback reason"},
    {"stream_register", (PyCFunction)Engine_stream_register,
     METH_VARARGS,
     "stream_register(conn_id, sid, peer_sid, window) — adopt an "
     "accepted stream onto the kind-5 lane (write credit accounted "
     "in C++)"},
    {"stream_unregister", (PyCFunction)Engine_stream_unregister,
     METH_VARARGS,
     "stream_unregister(sid) -> bool — drop a stream from the lane; "
     "blocked producers wake closed"},
    {"stream_write", (PyCFunction)Engine_stream_write, METH_VARARGS,
     "stream_write(sid, payload, timeout_ms=10000) -> 0 ok | -1 "
     "credit exhaustion | -2 closed/unknown"},
    {"stream_write_many", (PyCFunction)Engine_stream_write_many,
     METH_VARARGS,
     "stream_write_many([(sid, payload)], timeout_ms=10000) -> "
     "[status] — chunk-coalesced burst write: one owned buffer and "
     "one writev per connection"},
    {"register_http_route", (PyCFunction)Engine_register_http_route,
     METH_VARARGS,
     "register_http_route(method, path, handler) — slim HTTP lane "
     "route (kind 4); pre-listen only"},
    {"set_http_slim", (PyCFunction)Engine_set_http_slim, METH_VARARGS,
     "enable/disable the slim HTTP lane at runtime"},
    {"http_slim_stats", (PyCFunction)Engine_http_slim_stats,
     METH_VARARGS,
     "http_slim_stats([method, path]) — per-route (handled, errors) "
     "counters for the slim HTTP lane; no args returns the whole map"},
    {"native_stats", (PyCFunction)Engine_native_stats, METH_VARARGS,
     "native_stats([svc, mth]) — per-method (answered, errors) counters "
     "for native dispatch; no args returns the whole map"},
    {"telemetry", (PyCFunction)Engine_telemetry, METH_NOARGS,
     "telemetry() — the whole always-on observability table in one "
     "snapshot: per-lane stage histograms, reason-coded fallback "
     "counters, burst/writev distributions, high-water marks, loop "
     "busy/idle time, per-method and per-route breakdowns"},
    {nullptr, nullptr, 0, nullptr},
};

static PyTypeObject EngineType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ---------------------------------------------------------------------------
// sync_call: the client-side latency fast path.  writev the request parts,
// then block (poll) until exactly one complete TRPC frame is read, all with
// the GIL released.  The caller owns the connection exclusively (pooled /
// short connections) so no other reader races with us.  Returns
// (NativeBuf(meta+payload), meta_size).
// ---------------------------------------------------------------------------

#include <poll.h>

// one recv into buf[*got..cap], blocking on the deadline when the socket
// is dry.  Returns 0 ok (>=1 byte appended), 1 timeout, 2 conn error.
static int wait_fd(int fd, short events, int64_t deadline_ms);
static int recv_more(int fd, char* buf, size_t* got, size_t cap,
                     int64_t deadline, char* errbuf, size_t errcap) {
  for (;;) {
    ssize_t r = recv(fd, buf + *got, cap - *got, 0);
    if (r > 0) { *got += (size_t)r; return 0; }
    if (r == 0) { snprintf(errbuf, errcap, "connection closed by peer"); return 2; }
    if (errno == EAGAIN || errno == EWOULDBLOCK) {
      int pr = wait_fd(fd, POLLIN, deadline);
      if (pr == 0) return 1;
      if (pr < 0) { snprintf(errbuf, errcap, "poll: %s", strerror(errno)); return 2; }
      continue;
    }
    if (errno == EINTR) continue;
    snprintf(errbuf, errcap, "read: %s", strerror(errno));
    return 2;
  }
}

// poll helper honoring an absolute deadline (ms, CLOCK_MONOTONIC); -1 = none
static int wait_fd(int fd, short events, int64_t deadline_ms) {
  struct pollfd p;
  p.fd = fd;
  p.events = events;
  for (;;) {
    int tmo = -1;
    if (deadline_ms >= 0) {
      int64_t left = deadline_ms - now_ms();
      if (left <= 0) return 0;  // timed out
      tmo = (int)(left > 1000000 ? 1000000 : left);
    }
    int r = poll(&p, 1, tmo);
    if (r > 0) return 1;
    if (r == 0) {
      if (deadline_ms < 0) continue;
      return 0;
    }
    if (errno == EINTR) continue;
    return -1;
  }
}

// ---- client request frame layout (single source, shared by raw_call
// and scatter_call) ----

// remaining-deadline TLV; returns its length (0 when no timeout)
static size_t build_tmo_tlv(char* tmo, int timeout_ms) {
  if (timeout_ms <= 0) return 0;
  uint32_t l4 = 4;
  tmo[0] = 13;
  memcpy(tmo + 1, &l4, 4);
  uint32_t t32 = (uint32_t)timeout_ms;
  memcpy(tmo + 5, &t32, 4);
  return 9;
}

// TRPC header + cid TLV + [att TLV] into head (>= 34 bytes); the
// cached tail TLVs, the tmo TLV and the payload/attachment ride their
// own iovs — mlen covers cid/att TLVs + tail_len + tmo_len.  Returns
// the head length.
static size_t build_request_head(char* head, uint64_t cid, size_t alen,
                                 size_t tail_len, size_t tmo_len,
                                 size_t payload_len) {
  char* w = head + kHeaderSize;
  uint32_t l8 = 8, l4 = 4;
  *w = 1;
  memcpy(w + 1, &l8, 4);
  memcpy(w + 5, &cid, 8);
  w += 13;
  if (alen) {
    *w = 3;
    memcpy(w + 1, &l4, 4);
    uint32_t a32 = (uint32_t)alen;
    memcpy(w + 5, &a32, 4);
    w += 9;
  }
  uint32_t mlen = (uint32_t)((size_t)(w - head - kHeaderSize) + tail_len
                             + tmo_len);
  uint32_t body = mlen + (uint32_t)payload_len + (uint32_t)alen;
  memcpy(head, "TRPC", 4);
  memcpy(head + 4, &body, 4);
  memcpy(head + 8, &mlen, 4);
  return (size_t)(w - head);
}

// Scan a response meta for the PLAIN success shape — cid(1)/att(3)/
// ici-domain(15) tags only.  True = plain; rcid/ratt/dom filled.
// Anything else goes back to Python whole for the full RpcMeta decode.
static bool scan_plain_resp(const char* p, size_t meta, uint64_t* rcid,
                            uint32_t* ratt, const char** dom,
                            uint32_t* dom_len) {
  bool plain = true;
  size_t off = 0;
  while (off < meta) {
    if (off + 5 > meta) return false;
    uint8_t tag = (uint8_t)p[off];
    uint32_t ln;
    memcpy(&ln, p + off + 1, 4);
    off += 5;
    if (ln > meta || off + ln > meta) return false;
    if (tag == 1 && ln == 8) memcpy(rcid, p + off, 8);
    else if (tag == 3 && ln == 4) memcpy(ratt, p + off, 4);
    else if (tag == 15) { *dom = p + off; *dom_len = ln; }
    else plain = false;
    off += ln;
  }
  return plain;
}

// Write an iovec array fully (poll on EAGAIN, resume partials) with
// the GIL released by the CALLER.  Shared by sync_call and raw_call.
// Returns the shared error code convention.
static int write_all_iov(int fd, struct iovec* iov, int n,
                         int64_t deadline, char* errbuf, size_t errcap) {
  int err = 0;
  int first = 0;
  while (first < n && !err) {
    ssize_t w = writev(fd, iov + first, n - first);
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        int r = wait_fd(fd, POLLOUT, deadline);
        if (r == 0) err = 1;
        else if (r < 0) {
          err = 2;
          snprintf(errbuf, errcap, "poll: %s", strerror(errno));
        }
        continue;
      }
      if (errno == EINTR) continue;
      err = 2;
      snprintf(errbuf, errcap, "write: %s", strerror(errno));
      break;
    }
    size_t left = (size_t)w;
    while (left > 0 && first < n) {
      if (left >= iov[first].iov_len) {
        left -= iov[first].iov_len;
        first++;
      } else {
        iov[first].iov_base = (char*)iov[first].iov_base + left;
        iov[first].iov_len -= left;
        left = 0;
      }
    }
  }
  return err;
}


// Read exactly one TRPC response frame off an exclusively-owned fd,
// consuming TICI credit-return frames anywhere around it (leading:
// in-handler redeems piggyback in front of the response; trailing:
// lazy redeems ride behind — both must drain to a frame boundary or
// the connection desyncs).  Called WITH the GIL held; IO runs with it
// released.  On success *out_buf is a fresh NativeBuf holding the
// frame body and *out_meta its meta size.  Returns the shared error
// code convention (0 ok, 1 timeout, 2 conn error, 3 bad frame).
//
// NOTE: the TICI parse appears twice below (leading drain interleaved
// with the header hunt, trailing drain after the body) — the two
// loops share the frame format and the cnt>8000 bound; a change to
// either MUST be mirrored in the other (and in call_batch's drains).
static int read_one_response(int fd, int64_t deadline, NativeBuf** out_buf,
                             uint32_t* out_meta,
                             std::vector<uint64_t>& ack_vec,
                             char* errbuf, size_t errcap) {
  int err = 0;
  char scratch[65536];       // greedy-read landing zone (header + body)
  size_t got = 0;
  uint32_t body = 0, meta = 0;
  *out_buf = nullptr;

  Py_BEGIN_ALLOW_THREADS;
  while (!err) {
    while (!err && got < 8)
      err = recv_more(fd, scratch, &got, sizeof scratch, deadline,
                      errbuf, errcap);
    if (err) break;
    if (memcmp(scratch, "TICI", 4) == 0) {
      uint32_t cnt = 0;
      memcpy(&cnt, scratch + 4, 4);
      size_t total = 8 + 8ul * cnt;
      if (cnt > 8000 || total > sizeof scratch) {
        err = 3;
        snprintf(errbuf, errcap, "oversized ack frame cnt=%u", cnt);
        break;
      }
      while (!err && got < total)
        err = recv_more(fd, scratch, &got, sizeof scratch, deadline,
                        errbuf, errcap);
      if (err) break;
      for (uint32_t i = 0; i < cnt; i++) {
        uint64_t id;
        memcpy(&id, scratch + 8 + 8ul * i, 8);
        ack_vec.push_back(id);
      }
      memmove(scratch, scratch + total, got - total);
      got -= total;
      continue;
    }
    while (!err && got < kHeaderSize)
      err = recv_more(fd, scratch, &got, sizeof scratch, deadline,
                      errbuf, errcap);
    if (err) break;
    if (memcmp(scratch, "TRPC", 4) != 0) {
      err = 3;
      snprintf(errbuf, errcap, "unexpected magic on fast-path read");
    } else {
      memcpy(&body, scratch + 4, 4);
      memcpy(&meta, scratch + 8, 4);
      if (body > kMaxBody || meta > body) {
        err = 3;
        snprintf(errbuf, errcap, "bad frame sizes body=%u meta=%u",
                 body, meta);
      }
    }
    break;
  }
  Py_END_ALLOW_THREADS;
  if (err) return err;

  NativeBuf* out = nativebuf_new((Py_ssize_t)body);   // GIL held again
  if (!out) {
    snprintf(errbuf, errcap, "out of memory");
    return 2;
  }
  size_t have = got - kHeaderSize;           // surplus from the greedy read
  if (have > (size_t)body) have = body;
  if (have) memcpy(out->data, scratch + kHeaderSize, have);
  Py_BEGIN_ALLOW_THREADS;
  size_t filled = have;
  while (filled < body && !err) {
    ssize_t r = recv(fd, out->data + filled, body - filled, 0);
    if (r == 0) {
      err = 2;
      snprintf(errbuf, errcap, "connection closed mid-frame");
      break;
    }
    if (r < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        int pr = wait_fd(fd, POLLIN, deadline);
        if (pr == 0) err = 1;
        else if (pr < 0) {
          err = 2;
          snprintf(errbuf, errcap, "poll: %s", strerror(errno));
        }
        continue;
      }
      if (errno == EINTR) continue;
      err = 2;
      snprintf(errbuf, errcap, "read: %s", strerror(errno));
      break;
    }
    filled += (size_t)r;
  }
  // trailing TICI frames the greedy read pulled in past the response:
  // the response is already complete, so a nearly-expired deadline must
  // not fail the call over bytes already in flight — small grace window
  size_t tail_off = kHeaderSize + (size_t)body;
  if (!err && got > tail_off) {
    int64_t tdl = deadline;
    if (tdl >= 0) {
      int64_t grace = now_ms() + 2000;
      if (tdl < grace) tdl = grace;
    }
    size_t tgot = got - tail_off;
    memmove(scratch, scratch + tail_off, tgot);
    while (!err && tgot > 0) {
      while (!err && tgot < 8)
        err = recv_more(fd, scratch, &tgot, sizeof scratch, tdl,
                        errbuf, errcap);
      if (err) break;
      if (memcmp(scratch, "TICI", 4) != 0) {
        err = 3;
        snprintf(errbuf, errcap, "unexpected trailing bytes after response");
        break;
      }
      uint32_t cnt = 0;
      memcpy(&cnt, scratch + 4, 4);
      size_t total = 8 + 8ul * cnt;
      if (cnt > 8000 || total > sizeof scratch) {
        err = 3;
        snprintf(errbuf, errcap, "oversized ack frame cnt=%u", cnt);
        break;
      }
      while (!err && tgot < total)
        err = recv_more(fd, scratch, &tgot, sizeof scratch, tdl,
                        errbuf, errcap);
      if (err) break;
      for (uint32_t i = 0; i < cnt; i++) {
        uint64_t id;
        memcpy(&id, scratch + 8 + 8ul * i, 8);
        ack_vec.push_back(id);
      }
      memmove(scratch, scratch + total, tgot - total);
      tgot -= total;
    }
  }
  Py_END_ALLOW_THREADS;
  if (err) {
    Py_DECREF((PyObject*)out);
    return err;
  }
  *out_buf = out;
  *out_meta = meta;
  return 0;
}


static PyObject* sync_call(PyObject*, PyObject* args) {
  int fd;
  PyObject* parts;
  double timeout_s = -1.0;
  if (!PyArg_ParseTuple(args, "iO|d", &fd, &parts, &timeout_s))
    return nullptr;
  PyObject* seq = PySequence_Fast(parts, "parts must be a sequence");
  if (!seq) return nullptr;
  Py_ssize_t nparts = PySequence_Fast_GET_SIZE(seq);
  if (nparts > 62) {
    Py_DECREF(seq);
    PyErr_SetString(PyExc_ValueError, "too many request parts");
    return nullptr;
  }
  Py_buffer views[62];
  Py_ssize_t nviews = 0;
  for (Py_ssize_t i = 0; i < nparts; i++) {
    PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
    if (PyObject_GetBuffer(item, &views[nviews], PyBUF_SIMPLE) != 0) {
      for (Py_ssize_t j = 0; j < nviews; j++) PyBuffer_Release(&views[j]);
      Py_DECREF(seq);
      return nullptr;
    }
    if (views[nviews].len > 0) nviews++;
    else PyBuffer_Release(&views[nviews]);
  }
  int64_t deadline = timeout_s >= 0 ? now_ms() + (int64_t)(timeout_s * 1000)
                                    : -1;
  // phase 1: write all parts (vectored, poll on EAGAIN)
  int err = 0;               // 0 ok, 1 timeout, 2 conn error, 3 bad frame
  char errbuf[96] = {0};
  uint32_t meta = 0;
  NativeBuf* out = nullptr;
  std::vector<uint64_t> ack_vec;  // TICI credit-returns around the response

  Py_BEGIN_ALLOW_THREADS;
  struct iovec iov[62];
  int n = 0;
  for (Py_ssize_t i = 0; i < nviews; i++) {
    iov[n].iov_base = views[i].buf;
    iov[n].iov_len = views[i].len;
    n++;
  }
  err = write_all_iov(fd, iov, n, deadline, errbuf, sizeof errbuf);
  Py_END_ALLOW_THREADS;
  // phase 2+3: one response frame + surrounding TICI drains (shared
  // with raw_call — read_one_response owns the discipline; GIL held at
  // entry, released around its IO)
  if (!err)
    err = read_one_response(fd, deadline, &out, &meta, ack_vec,
                            errbuf, sizeof errbuf);

  for (Py_ssize_t j = 0; j < nviews; j++) PyBuffer_Release(&views[j]);
  Py_DECREF(seq);
  if (err) {
    Py_XDECREF((PyObject*)out);
    if (err == 1)
      PyErr_SetString(PyExc_TimeoutError, "rpc deadline exceeded");
    else if (err == 2)
      PyErr_SetString(PyExc_ConnectionError, errbuf);
    else
      PyErr_SetString(PyExc_ValueError, errbuf);
    return nullptr;
  }
  if (!ack_vec.empty()) {
    PyObject* acks = PyList_New((Py_ssize_t)ack_vec.size());
    if (!acks) { Py_DECREF((PyObject*)out); return nullptr; }
    for (size_t i = 0; i < ack_vec.size(); i++)
      PyList_SET_ITEM(acks, (Py_ssize_t)i,
                      PyLong_FromUnsignedLongLong(ack_vec[i]));
    return Py_BuildValue("(NkN)", (PyObject*)out, (unsigned long)meta, acks);
  }
  PyObject* tup = Py_BuildValue("(Nk)", (PyObject*)out, (unsigned long)meta);
  return tup;
}

// raw_call(fd, tail, payload, attachment, timeout_ms, cid, lead)
//   -> (ok, a, b, dom, acks)
//
// The client half of the raw latency lane, fully native: builds the
// request frame (cid TLV + optional attachment TLV + the channel's
// cached tail + optional remaining-deadline TLV), writes it vectored,
// reads the response, and scans its meta — Python's per-call work
// drops to generating a cid and unpacking one tuple.
//
//   ok=True : a = NativeBuf(payload+attachment), b = attachment size,
//             dom = peer ici-domain bytes or None
//   ok=False: a = NativeBuf(whole frame body), b = meta size (full
//             RpcMeta decode in Python — errors etc.), dom = None
//   acks    : TICI credit-return ids consumed around the response, or
//             None
static PyObject* raw_call(PyObject*, PyObject* args) {
  int fd;
  Py_buffer tail = {}, payload = {}, att = {}, lead = {};
  int timeout_ms;
  unsigned long long cid;
  PyObject* att_obj;
  PyObject* lead_obj = Py_None;
  if (!PyArg_ParseTuple(args, "iy*y*OiK|O", &fd, &tail, &payload,
                        &att_obj, &timeout_ms, &cid, &lead_obj)) {
    if (tail.obj) PyBuffer_Release(&tail);
    if (payload.obj) PyBuffer_Release(&payload);
    return nullptr;
  }
  auto release_all = [&]() {
    PyBuffer_Release(&tail);
    PyBuffer_Release(&payload);
    if (att.obj) PyBuffer_Release(&att);
    if (lead.obj) PyBuffer_Release(&lead);
  };
  if (att_obj != Py_None
      && PyObject_GetBuffer(att_obj, &att, PyBUF_SIMPLE) != 0) {
    PyBuffer_Release(&tail);
    PyBuffer_Release(&payload);
    return nullptr;
  }
  if (lead_obj != Py_None
      && PyObject_GetBuffer(lead_obj, &lead, PyBUF_SIMPLE) != 0) {
    release_all();
    return nullptr;
  }
  size_t alen = att.obj ? (size_t)att.len : 0;
  // Bound the WHOLE body (meta TLVs + tail + payload + attachment), not
  // the parts individually: a 400MB payload + 400MB attachment would
  // otherwise build a frame the server rejects, failing the pinned
  // connection instead of raising here (call_batch's fail-fast rule).
  if ((size_t)payload.len + alen + (size_t)tail.len + 31
      > (size_t)kMaxBody) {
    release_all();
    PyErr_SetString(PyExc_ValueError,
                    "payload + attachment exceeds max body");
    return nullptr;
  }

  // head block: TRPC header + cid TLV + [att TLV]; the cached tail and
  // the tmo TLV ride their own iovs (single-source frame layout —
  // build_request_head is shared with scatter_call)
  char head[40];
  char tmo[9];
  size_t tmo_len = build_tmo_tlv(tmo, timeout_ms);
  size_t head_len = build_request_head(head, cid, alen, (size_t)tail.len,
                                       tmo_len, (size_t)payload.len);

  int64_t deadline = timeout_ms > 0 ? now_ms() + timeout_ms : -1;
  int err = 0;
  char errbuf[96] = {0};
  uint32_t meta = 0;
  NativeBuf* out = nullptr;
  std::vector<uint64_t> ack_vec;

  Py_BEGIN_ALLOW_THREADS;
  struct iovec iov[6];
  int n = 0;
  if (lead.obj && lead.len > 0) iov[n++] = {lead.buf, (size_t)lead.len};
  iov[n++] = {head, head_len};
  if (tail.len > 0) iov[n++] = {tail.buf, (size_t)tail.len};
  if (tmo_len) iov[n++] = {tmo, tmo_len};
  if (payload.len > 0) iov[n++] = {payload.buf, (size_t)payload.len};
  if (alen) iov[n++] = {att.buf, (size_t)att.len};
  err = write_all_iov(fd, iov, n, deadline, errbuf, sizeof errbuf);
  Py_END_ALLOW_THREADS;

  if (!err)
    err = read_one_response(fd, deadline, &out, &meta, ack_vec,
                            errbuf, sizeof errbuf);
  release_all();
  if (err) {
    Py_XDECREF((PyObject*)out);
    if (err == 1)
      PyErr_SetString(PyExc_TimeoutError, "rpc deadline exceeded");
    else if (err == 2)
      PyErr_SetString(PyExc_ConnectionError, errbuf);
    else
      PyErr_SetString(PyExc_ValueError, errbuf);
    return nullptr;
  }

  // scan the response meta: plain success (cid/att/domain only, cid
  // matching) unpacks here; anything else goes back whole for RpcMeta
  uint64_t rcid = 0;
  uint32_t ratt = 0;
  const char* dom = nullptr;
  uint32_t dom_len = 0;
  bool plain = scan_plain_resp(out->data, meta, &rcid, &ratt, &dom,
                               &dom_len);
  PyObject* acks = Py_None;
  if (!ack_vec.empty()) {
    acks = PyList_New((Py_ssize_t)ack_vec.size());
    if (!acks) { Py_DECREF((PyObject*)out); return nullptr; }
    for (size_t i = 0; i < ack_vec.size(); i++)
      PyList_SET_ITEM(acks, (Py_ssize_t)i,
                      PyLong_FromUnsignedLongLong(ack_vec[i]));
  } else {
    Py_INCREF(Py_None);
  }
  size_t blen = (size_t)out->size - meta;
  if (plain && rcid == cid && ratt <= blen) {
    // the domain bytes live in the meta region — materialize them
    // BEFORE the body is shifted over it
    PyObject* dom_obj;
    if (dom_len) {
      dom_obj = PyBytes_FromStringAndSize(dom, (Py_ssize_t)dom_len);
      if (!dom_obj) {
        Py_DECREF((PyObject*)out);
        Py_DECREF(acks);
        return nullptr;
      }
    } else {
      dom_obj = Py_None;
      Py_INCREF(Py_None);
    }
    // shift the body down in place: the payload view Python receives
    // must start at offset 0 (NativeBuf has no offset concept)
    memmove(out->data, out->data + meta, blen);
    out->size = (Py_ssize_t)blen;
    return Py_BuildValue("(ONkNN)", Py_True, (PyObject*)out,
                         (unsigned long)ratt, dom_obj, acks);
  }
  return Py_BuildValue("(ONkON)", Py_False, (PyObject*)out,
                       (unsigned long)meta, Py_None, acks);
}


// scatter_call(items, timeout_s) -> [result, ...]
//
// The fan-out fast lane for ParallelChannel (≈ the reference's
// parallel_channel.h scatter): items is a sequence of
// (fd, tail, payload, att_or_None, cid, lead_or_None).  ALL request
// frames are built and written first (wire-level scatter — every
// branch's server starts working), then one response frame is read per
// fd in item order, so the whole fan-out costs Python ONE call instead
// of one build+write+read round per branch.  Each fd must be
// exclusively owned with exactly one in-flight request (the Python
// side falls back to per-branch calls when a remote repeats).
//
// results[i] mirrors raw_call's contract:
//   (True,  buf, att_size, dom_or_None, acks_or_None)   plain success
//   (False, buf, meta_size, None, acks_or_None)         full RpcMeta
//                                                       decode path
//   (None,  errkind, text, None, None)                  transport error
//       errkind: 1 = timeout, 2 = connection error, 3 = bad frame
// A failed branch never aborts the others.
static PyObject* scatter_call(PyObject*, PyObject* args) {
  PyObject* items;
  double timeout_s = -1.0;
  if (!PyArg_ParseTuple(args, "O|d", &items, &timeout_s)) return nullptr;
  PyObject* seq = PySequence_Fast(items, "items must be a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  if (n < 1 || n > 4096) {
    Py_DECREF(seq);
    PyErr_SetString(PyExc_ValueError, "bad scatter item count");
    return nullptr;
  }

  struct ScItem {
    int fd = -1;
    Py_buffer tail{}, payload{}, att{}, lead{};
    uint64_t cid = 0;
    char head[40];                 // TRPC hdr + cid TLV + att TLV
    size_t head_len = 0;
    char tmo[9];
    size_t tmo_len = 0;
    int err = 0;
    char errbuf[96] = {0};
    NativeBuf* out = nullptr;
    uint32_t meta = 0;
    std::vector<uint64_t> acks;
  };
  std::vector<ScItem> its((size_t)n);
  auto release_item = [](ScItem& it) {
    if (it.tail.obj) PyBuffer_Release(&it.tail);
    if (it.payload.obj) PyBuffer_Release(&it.payload);
    if (it.att.obj) PyBuffer_Release(&it.att);
    if (it.lead.obj) PyBuffer_Release(&it.lead);
    it.tail.obj = it.payload.obj = it.att.obj = it.lead.obj = nullptr;
  };
  auto release_all = [&]() {
    for (auto& it : its) {
      release_item(it);
      Py_XDECREF((PyObject*)it.out);
    }
    Py_DECREF(seq);
  };
  int timeout_ms = timeout_s >= 0 ? (int)(timeout_s * 1000) : 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    ScItem& it = its[(size_t)i];
    PyObject* t = PySequence_Fast_GET_ITEM(seq, i);
    PyObject *att_obj = Py_None, *lead_obj = Py_None;
    unsigned long long cid = 0;
    if (!PyArg_ParseTuple(t, "iy*y*OKO", &it.fd, &it.tail, &it.payload,
                          &att_obj, &cid, &lead_obj)) {
      release_all();
      return nullptr;
    }
    it.cid = cid;
    if (att_obj != Py_None
        && PyObject_GetBuffer(att_obj, &it.att, PyBUF_SIMPLE) != 0) {
      release_all();
      return nullptr;
    }
    if (lead_obj != Py_None
        && PyObject_GetBuffer(lead_obj, &it.lead, PyBUF_SIMPLE) != 0) {
      release_all();
      return nullptr;
    }
    size_t alen = it.att.obj ? (size_t)it.att.len : 0;
    if ((size_t)it.payload.len + alen + (size_t)it.tail.len + 31
        > (size_t)kMaxBody) {
      release_all();
      PyErr_SetString(PyExc_ValueError,
                      "payload + attachment exceeds max body");
      return nullptr;
    }
    // same wire layout as raw_call's — single source in
    // build_request_head/build_tmo_tlv
    it.tmo_len = build_tmo_tlv(it.tmo, timeout_ms);
    it.head_len = build_request_head(it.head, it.cid, alen,
                                     (size_t)it.tail.len, it.tmo_len,
                                     (size_t)it.payload.len);
  }

  int64_t deadline = timeout_s >= 0 ? now_ms() + (int64_t)(timeout_s * 1000)
                                    : -1;
  // phase 1: scatter — write every branch's frame before reading any
  // response (per-branch errors recorded, the rest proceed)
  Py_BEGIN_ALLOW_THREADS;
  for (auto& it : its) {
    struct iovec iov[6];
    int ni = 0;
    if (it.lead.obj && it.lead.len > 0)
      iov[ni++] = {it.lead.buf, (size_t)it.lead.len};
    iov[ni++] = {it.head, it.head_len};
    if (it.tail.len > 0) iov[ni++] = {it.tail.buf, (size_t)it.tail.len};
    if (it.tmo_len) iov[ni++] = {it.tmo, it.tmo_len};
    if (it.payload.len > 0)
      iov[ni++] = {it.payload.buf, (size_t)it.payload.len};
    if (it.att.obj && it.att.len > 0)
      iov[ni++] = {it.att.buf, (size_t)it.att.len};
    it.err = write_all_iov(it.fd, iov, ni, deadline, it.errbuf,
                           sizeof it.errbuf);
  }
  Py_END_ALLOW_THREADS;

  // phase 2: gather — one response frame per fd (read_one_response
  // manages its own GIL transitions; entered with the GIL held)
  for (auto& it : its) {
    if (it.err) continue;
    it.err = read_one_response(it.fd, deadline, &it.out, &it.meta,
                               it.acks, it.errbuf, sizeof it.errbuf);
  }

  // phase 3: materialize per-item results (GIL held)
  PyObject* out_list = PyList_New(n);
  if (!out_list) {
    release_all();
    return nullptr;
  }
  bool fail = false;
  for (Py_ssize_t i = 0; i < n && !fail; i++) {
    ScItem& it = its[(size_t)i];
    PyObject* res = nullptr;
    if (it.err) {
      res = Py_BuildValue("(OisOO)", Py_None, it.err, it.errbuf,
                          Py_None, Py_None);
    } else {
      // scan the response meta exactly like raw_call: plain success
      // (cid/att/domain only, cid matching) unpacks here
      uint64_t rcid = 0;
      uint32_t ratt = 0;
      const char* dom = nullptr;
      uint32_t dom_len = 0;
      bool plain = scan_plain_resp(it.out->data, it.meta, &rcid, &ratt,
                                   &dom, &dom_len);
      PyObject* acks = Py_None;
      if (!it.acks.empty()) {
        acks = PyList_New((Py_ssize_t)it.acks.size());
        if (!acks) { fail = true; break; }
        for (size_t k = 0; k < it.acks.size(); k++)
          PyList_SET_ITEM(acks, (Py_ssize_t)k,
                          PyLong_FromUnsignedLongLong(it.acks[k]));
      } else {
        Py_INCREF(Py_None);
      }
      size_t blen = (size_t)it.out->size - it.meta;
      if (plain && rcid == it.cid && ratt <= blen) {
        PyObject* dom_obj;
        if (dom_len) {
          dom_obj = PyBytes_FromStringAndSize(dom, (Py_ssize_t)dom_len);
          if (!dom_obj) { Py_DECREF(acks); fail = true; break; }
        } else {
          dom_obj = Py_None;
          Py_INCREF(Py_None);
        }
        memmove(it.out->data, it.out->data + it.meta, blen);
        it.out->size = (Py_ssize_t)blen;
        res = Py_BuildValue("(ONkNN)", Py_True, (PyObject*)it.out,
                            (unsigned long)ratt, dom_obj, acks);
        it.out = nullptr;   // "N" consumed the reference either way —
                            // release_all must not decref it again
      } else {
        res = Py_BuildValue("(ONkON)", Py_False, (PyObject*)it.out,
                            (unsigned long)it.meta, Py_None, acks);
        it.out = nullptr;
      }
    }
    if (!res) { fail = true; break; }
    PyList_SET_ITEM(out_list, i, res);
  }
  release_all();
  if (fail) {
    Py_DECREF(out_list);
    return nullptr;
  }
  return out_list;
}


// sync_call_many(fd, parts, n, timeout_s) -> [(buf, meta_size), ...]
// Pipelined variant: write all parts (a batch of frames), then read
// exactly n TRPC frames.  One GIL release covers the whole batch write;
// reads release it per frame body.
static PyObject* sync_call_many(PyObject*, PyObject* args) {
  int fd;
  PyObject* parts;
  int expect;
  double timeout_s = -1.0;
  if (!PyArg_ParseTuple(args, "iOi|d", &fd, &parts, &expect, &timeout_s))
    return nullptr;
  if (expect < 1 || expect > (1 << 20)) {
    PyErr_SetString(PyExc_ValueError, "bad expect count");
    return nullptr;
  }
  PyObject* seq = PySequence_Fast(parts, "parts must be a sequence");
  if (!seq) return nullptr;
  Py_ssize_t nparts = PySequence_Fast_GET_SIZE(seq);
  std::vector<Py_buffer> views(nparts);
  Py_ssize_t nviews = 0;
  for (Py_ssize_t i = 0; i < nparts; i++) {
    PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
    if (PyObject_GetBuffer(item, &views[nviews], PyBUF_SIMPLE) != 0) {
      for (Py_ssize_t j = 0; j < nviews; j++) PyBuffer_Release(&views[j]);
      Py_DECREF(seq);
      return nullptr;
    }
    if (views[nviews].len > 0) nviews++;
    else PyBuffer_Release(&views[nviews]);
  }
  int64_t deadline = timeout_s >= 0 ? now_ms() + (int64_t)(timeout_s * 1000)
                                    : -1;
  int err = 0;
  char errbuf[96] = {0};

  // phase 1: write everything
  Py_BEGIN_ALLOW_THREADS;
  std::vector<struct iovec> iov(nviews);
  for (Py_ssize_t i = 0; i < nviews; i++) {
    iov[i].iov_base = views[i].buf;
    iov[i].iov_len = views[i].len;
  }
  size_t first = 0;
  while (first < (size_t)nviews && !err) {
    size_t cnt = (size_t)nviews - first;
    if (cnt > 64) cnt = 64;
    ssize_t w = writev(fd, iov.data() + first, (int)cnt);
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        int r = wait_fd(fd, POLLOUT, deadline);
        if (r == 0) err = 1;
        else if (r < 0) { err = 2; snprintf(errbuf, sizeof errbuf, "poll: %s", strerror(errno)); }
        continue;
      }
      if (errno == EINTR) continue;
      err = 2;
      snprintf(errbuf, sizeof errbuf, "write: %s", strerror(errno));
      break;
    }
    size_t left = (size_t)w;
    while (left > 0 && first < (size_t)nviews) {
      if (left >= iov[first].iov_len) {
        left -= iov[first].iov_len;
        first++;
      } else {
        iov[first].iov_base = (char*)iov[first].iov_base + left;
        iov[first].iov_len -= left;
        left = 0;
      }
    }
  }
  Py_END_ALLOW_THREADS;

  for (Py_ssize_t j = 0; j < nviews; j++) PyBuffer_Release(&views[j]);
  Py_DECREF(seq);
  if (err) goto fail;

  {
    // Read the WHOLE batch with the GIL released in one stretch: the
    // server's per-message Python dispatch then runs uncontended (GIL
    // ping-pong between reader and dispatcher is the dominant cost on
    // one core), and frames are sliced into NativeBufs afterwards under
    // a single GIL section.
    std::vector<char> acc;
    acc.reserve(1 << 20);
    std::vector<size_t> offs;       // start offsets of TRPC frames in acc
    offs.reserve((size_t)expect);
    std::vector<uint64_t> batch_acks;  // TICI ids interleaved in the batch
    size_t scanned = 0;   // prefix covered by complete frames
    int found = 0;
    Py_BEGIN_ALLOW_THREADS;
    while (found < expect && !err) {
      // scan newly complete frames (TICI credit-returns may interleave
      // when pipelined calls carry device descriptors — collect, skip)
      for (;;) {
        size_t avail = acc.size() - scanned;
        if (avail < 8) break;
        const char* p = acc.data() + scanned;
        if (memcmp(p, "TICI", 4) == 0) {
          uint32_t cnt = 0;
          memcpy(&cnt, p + 4, 4);
          size_t total = 8 + 8ul * cnt;
          if (cnt > 8000) {
            err = 3;
            snprintf(errbuf, sizeof errbuf, "oversized ack frame cnt=%u", cnt);
            break;
          }
          if (avail < total) break;
          for (uint32_t i = 0; i < cnt; i++) {
            uint64_t id;
            memcpy(&id, p + 8 + 8ul * i, 8);
            batch_acks.push_back(id);
          }
          scanned += total;
          continue;
        }
        if (avail < kHeaderSize) break;
        if (memcmp(p, "TRPC", 4) != 0) {
          err = 3;
          snprintf(errbuf, sizeof errbuf, "unexpected magic in batch read");
          break;
        }
        uint32_t body = 0, meta = 0;
        memcpy(&body, p + 4, 4);
        memcpy(&meta, p + 8, 4);
        (void)meta;
        if (body > kMaxBody || meta > body) {
          err = 3;
          snprintf(errbuf, sizeof errbuf, "bad frame sizes");
          break;
        }
        if (avail < kHeaderSize + (size_t)body) break;
        offs.push_back(scanned);
        scanned += kHeaderSize + body;
        if (++found >= expect) break;
      }
      if (err || found >= expect) break;
      char tmp[65536];
      ssize_t r = recv(fd, tmp, sizeof tmp, 0);
      if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        int pr = wait_fd(fd, POLLIN, deadline);
        if (pr == 0) err = 1;
        else if (pr < 0) { err = 2; snprintf(errbuf, sizeof errbuf, "poll: %s", strerror(errno)); }
        continue;
      }
      if (r == 0) { err = 2; snprintf(errbuf, sizeof errbuf, "connection closed by peer"); continue; }
      if (r < 0) {
        if (errno == EINTR) continue;
        err = 2;
        snprintf(errbuf, sizeof errbuf, "read: %s", strerror(errno));
        continue;
      }
      acc.insert(acc.end(), tmp, tmp + r);
    }
    // trailing bytes past the last expected response can only be TICI
    // credit-returns — drain to a frame boundary (a partial ack frame
    // left unread would desync the connection's next reader).  All
    // responses are in hand: grace the deadline for in-flight bytes.
    int64_t tdl = deadline;
    if (tdl >= 0) {
      int64_t grace = now_ms() + 2000;
      if (tdl < grace) tdl = grace;
    }
    while (!err && scanned < acc.size()) {
      size_t avail = acc.size() - scanned;
      const char* p = acc.data() + scanned;
      if (avail >= 4 && memcmp(p, "TICI", 4) != 0) {
        err = 3;
        snprintf(errbuf, sizeof errbuf, "unexpected trailing bytes in batch read");
        break;
      }
      if (avail >= 8) {
        uint32_t cnt = 0;
        memcpy(&cnt, p + 4, 4);
        if (cnt > 8000) {
          err = 3;
          snprintf(errbuf, sizeof errbuf, "oversized ack frame cnt=%u", cnt);
          break;
        }
        size_t total = 8 + 8ul * cnt;
        if (avail >= total) {
          for (uint32_t i = 0; i < cnt; i++) {
            uint64_t id;
            memcpy(&id, p + 8 + 8ul * i, 8);
            batch_acks.push_back(id);
          }
          scanned += total;
          continue;
        }
      }
      char tmp2[4096];
      ssize_t r = recv(fd, tmp2, sizeof tmp2, 0);
      if (r > 0) { acc.insert(acc.end(), tmp2, tmp2 + r); continue; }
      if (r == 0) { err = 2; snprintf(errbuf, sizeof errbuf, "connection closed mid-ack"); break; }
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        int pr = wait_fd(fd, POLLIN, tdl);
        if (pr == 0) err = 1;
        else if (pr < 0) { err = 2; snprintf(errbuf, sizeof errbuf, "poll: %s", strerror(errno)); }
        continue;
      }
      if (errno == EINTR) continue;
      err = 2;
      snprintf(errbuf, sizeof errbuf, "read: %s", strerror(errno));
    }
    Py_END_ALLOW_THREADS;
    if (!err) {
      PyObject* out_list = PyList_New(expect);
      if (!out_list) return nullptr;
      for (int k = 0; k < expect; k++) {
        const char* p = acc.data() + offs[(size_t)k];
        uint32_t body = 0, meta = 0;
        memcpy(&body, p + 4, 4);
        memcpy(&meta, p + 8, 4);
        NativeBuf* b = nativebuf_new((Py_ssize_t)body);
        if (!b) { Py_DECREF(out_list); return nullptr; }
        memcpy(b->data, p + kHeaderSize, body);
        PyObject* tup = Py_BuildValue("(Nk)", (PyObject*)b,
                                      (unsigned long)meta);
        if (!tup) { Py_DECREF(out_list); return nullptr; }
        PyList_SET_ITEM(out_list, k, tup);
      }
      if (!batch_acks.empty()) {
        PyObject* acks = PyList_New((Py_ssize_t)batch_acks.size());
        if (!acks) { Py_DECREF(out_list); return nullptr; }
        for (size_t i = 0; i < batch_acks.size(); i++)
          PyList_SET_ITEM(acks, (Py_ssize_t)i,
                          PyLong_FromUnsignedLongLong(batch_acks[i]));
        return Py_BuildValue("(NN)", out_list, acks);
      }
      return out_list;
    }
  }
fail:
  if (err == 1)
    PyErr_SetString(PyExc_TimeoutError, "rpc deadline exceeded");
  else if (err == 2)
    PyErr_SetString(PyExc_ConnectionError, errbuf);
  else
    PyErr_SetString(PyExc_ValueError, errbuf);
  return nullptr;
}

// call_batch(fd, tail, payloads, timeout_s, cid_base, first_extra, lead)
//   -> (results, acks)
//
// The fully-native pipelined batch lane: frames are BUILT here (header +
// cid TLV + tail per payload, cids stamped cid_base..cid_base+n-1),
// written vectored, and the responses' metas are parsed here too — the
// whole batch costs Python ONE call.  tail = method/timeout TLVs shared
// by every frame; first_extra rides only frame 0's meta (auth);
// lead = raw bytes written before frame 0 (pending TICI ack flush).
//
// results[i] (matched by cid, so out-of-order servers are fine):
//   NativeBuf                — plain success payload, no attachment
//   (NativeBuf, meta_size)   — anything else (errors, attachments,
//                              descriptors): full frame body for
//                              Python's RpcMeta decode
static PyObject* call_batch(PyObject*, PyObject* args) {
  int fd;
  Py_buffer tail = {}, first_extra = {}, lead = {};
  PyObject* payloads;
  double timeout_s = -1.0;
  unsigned long long cid_base;
  if (!PyArg_ParseTuple(args, "iy*OdK|y*y*", &fd, &tail, &payloads,
                        &timeout_s, &cid_base, &first_extra, &lead)) {
    if (tail.obj) PyBuffer_Release(&tail);
    return nullptr;
  }
  PyObject* seq = PySequence_Fast(payloads, "payloads must be a sequence");
  if (!seq) {
    PyBuffer_Release(&tail);
    if (first_extra.obj) PyBuffer_Release(&first_extra);
    if (lead.obj) PyBuffer_Release(&lead);
    return nullptr;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  auto cleanup_args = [&](std::vector<Py_buffer>& views) {
    for (auto& v : views) PyBuffer_Release(&v);
    PyBuffer_Release(&tail);
    if (first_extra.obj) PyBuffer_Release(&first_extra);
    if (lead.obj) PyBuffer_Release(&lead);
    Py_DECREF(seq);
  };
  std::vector<Py_buffer> views((size_t)n);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
    if (PyObject_GetBuffer(item, &views[(size_t)i], PyBUF_SIMPLE) != 0) {
      views.resize((size_t)i);
      cleanup_args(views);
      return nullptr;
    }
    if ((size_t)views[(size_t)i].len > (size_t)kMaxBody) {
      // fail fast with a precise error instead of truncating the u32
      // header length and desyncing the stream (server would reject
      // anything past kMaxBody anyway)
      views.resize((size_t)i + 1);
      cleanup_args(views);
      PyErr_SetString(PyExc_ValueError, "batch payload exceeds max body");
      return nullptr;
    }
  }
  if (n == 0) {
    // still write `lead` (pending TICI acks the caller already dequeued
    // from its socket — dropping them would leak peer window credit)
    int lerr = 0;
    if (lead.obj && lead.len > 0) {
      Py_BEGIN_ALLOW_THREADS;
      const char* lp = (const char*)lead.buf;
      size_t left = (size_t)lead.len;
      int64_t dl = timeout_s >= 0 ? now_ms() + (int64_t)(timeout_s * 1000)
                                  : -1;
      while (left > 0 && !lerr) {
        ssize_t w = send(fd, lp, left, 0);
        if (w > 0) {
          lp += w;
          left -= (size_t)w;
          continue;
        }
        if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
          if (wait_fd(fd, POLLOUT, dl) <= 0) lerr = 1;
          continue;
        }
        if (w < 0 && errno == EINTR) continue;
        lerr = 2;
      }
      Py_END_ALLOW_THREADS;
    }
    cleanup_args(views);
    if (lerr) {
      PyErr_SetString(lerr == 1 ? PyExc_TimeoutError : PyExc_ConnectionError,
                      "failed to flush pending acks");
      return nullptr;
    }
    return Py_BuildValue("(NN)", PyList_New(0), PyList_New(0));
  }
  if (n > (1 << 20)) {
    cleanup_args(views);
    PyErr_SetString(PyExc_ValueError, "batch too large");
    return nullptr;
  }

  int64_t deadline = timeout_s >= 0 ? now_ms() + (int64_t)(timeout_s * 1000)
                                    : -1;
  int err = 0;
  char errbuf[96] = {0};
  size_t tail_len = (size_t)tail.len;
  size_t extra_len = first_extra.obj ? (size_t)first_extra.len : 0;
  // per-frame arena chunk: 12B header + 13B cid TLV + tail (+extra on 0)
  const size_t kChunk = 25;
  std::vector<char> arena(n * (kChunk + tail_len) + extra_len);
  std::vector<struct iovec> iov;
  iov.reserve(2 * (size_t)n + 1);
  if (lead.obj && lead.len > 0)
    iov.push_back({lead.buf, (size_t)lead.len});
  std::vector<char> acc;                // response accumulator
  std::vector<size_t> offs((size_t)n, SIZE_MAX);  // body offset by index
  std::vector<uint32_t> osize((size_t)n, 0), ometa((size_t)n, 0);
  std::vector<uint64_t> batch_acks;

  Py_BEGIN_ALLOW_THREADS;
  // ---- build + write ----
  char* w = arena.data();
  for (Py_ssize_t i = 0; i < n; i++) {
    size_t ex = i == 0 ? extra_len : 0;
    uint32_t mlen = (uint32_t)(13 + ex + tail_len);
    uint32_t body = mlen + (uint32_t)views[(size_t)i].len;
    char* frame = w;
    memcpy(w, "TRPC", 4);
    memcpy(w + 4, &body, 4);
    memcpy(w + 8, &mlen, 4);
    w += 12;
    uint64_t cid = cid_base + (uint64_t)i;
    *w = 1;
    uint32_t l8 = 8;
    memcpy(w + 1, &l8, 4);
    memcpy(w + 5, &cid, 8);
    w += 13;
    if (ex) {
      memcpy(w, first_extra.buf, ex);
      w += ex;
    }
    if (tail_len) {
      memcpy(w, tail.buf, tail_len);
      w += tail_len;
    }
    iov.push_back({frame, (size_t)(w - frame)});
    if (views[(size_t)i].len > 0)
      iov.push_back({views[(size_t)i].buf, (size_t)views[(size_t)i].len});
  }
  size_t first = 0;
  while (first < iov.size() && !err) {
    size_t cnt = iov.size() - first;
    if (cnt > 64) cnt = 64;
    ssize_t wr = writev(fd, iov.data() + first, (int)cnt);
    if (wr < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        int r = wait_fd(fd, POLLOUT, deadline);
        if (r == 0) err = 1;
        else if (r < 0) {
          err = 2;
          snprintf(errbuf, sizeof errbuf, "poll: %s", strerror(errno));
        }
        continue;
      }
      if (errno == EINTR) continue;
      err = 2;
      snprintf(errbuf, sizeof errbuf, "write: %s", strerror(errno));
      break;
    }
    size_t left = (size_t)wr;
    while (left > 0 && first < iov.size()) {
      if (left >= iov[first].iov_len) {
        left -= iov[first].iov_len;
        first++;
      } else {
        iov[first].iov_base = (char*)iov[first].iov_base + left;
        iov[first].iov_len -= left;
        left = 0;
      }
    }
  }

  // ---- read + scan n responses (TICI interleaves collected) ----
  if (!err) {
    acc.reserve(1 << 20);
    size_t scanned = 0;
    Py_ssize_t found = 0;
    while (found < n && !err) {
      for (;;) {
        size_t avail = acc.size() - scanned;
        if (avail < 8) break;
        const char* p = acc.data() + scanned;
        if (memcmp(p, "TICI", 4) == 0) {
          uint32_t cnt = 0;
          memcpy(&cnt, p + 4, 4);
          size_t total = 8 + 8ul * cnt;
          if (cnt > 8000) {
            err = 3;
            snprintf(errbuf, sizeof errbuf, "oversized ack frame");
            break;
          }
          if (avail < total) break;
          for (uint32_t i = 0; i < cnt; i++) {
            uint64_t id;
            memcpy(&id, p + 8 + 8ul * i, 8);
            batch_acks.push_back(id);
          }
          scanned += total;
          continue;
        }
        if (avail < kHeaderSize) break;
        if (memcmp(p, "TRPC", 4) != 0) {
          err = 3;
          snprintf(errbuf, sizeof errbuf, "unexpected magic in batch read");
          break;
        }
        uint32_t body = 0, meta = 0;
        memcpy(&body, p + 4, 4);
        memcpy(&meta, p + 8, 4);
        if (body > kMaxBody || meta > body) {
          err = 3;
          snprintf(errbuf, sizeof errbuf, "bad frame sizes");
          break;
        }
        if (avail < kHeaderSize + (size_t)body) break;
        // place by cid (servers running handlers on fibers may answer
        // out of order)
        uint64_t rcid = 0;
        {
          // response metas reuse the TLV walk; only cid placement needs
          // to succeed here — full decode stays in Python when unusual
          size_t off2 = 0;
          bool got_cid = false;
          const char* mp = p + kHeaderSize;
          while (off2 + 5 <= meta) {
            uint8_t tag = (uint8_t)mp[off2];
            uint32_t ln;
            memcpy(&ln, mp + off2 + 1, 4);
            off2 += 5;
            if (off2 + ln > meta) break;
            if (tag == 1 && ln == 8) {
              memcpy(&rcid, mp + off2, 8);
              got_cid = true;
            }
            off2 += ln;
          }
          if (!got_cid) {
            err = 3;
            snprintf(errbuf, sizeof errbuf,
                     "batch response missing correlation id");
            break;
          }
        }
        if (rcid < cid_base || rcid >= cid_base + (uint64_t)n
            || offs[(size_t)(rcid - cid_base)] != SIZE_MAX) {
          err = 3;
          snprintf(errbuf, sizeof errbuf,
                   "batch response cid out of range");
          break;
        }
        size_t idx = (size_t)(rcid - cid_base);
        offs[idx] = scanned + kHeaderSize;
        osize[idx] = body;
        ometa[idx] = meta;
        scanned += kHeaderSize + body;
        found++;
      }
      if (err || found >= n) break;
      char tmp[65536];
      ssize_t r = recv(fd, tmp, sizeof tmp, 0);
      if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        int pr = wait_fd(fd, POLLIN, deadline);
        if (pr == 0) err = 1;
        else if (pr < 0) {
          err = 2;
          snprintf(errbuf, sizeof errbuf, "poll: %s", strerror(errno));
        }
        continue;
      }
      if (r == 0) {
        err = 2;
        snprintf(errbuf, sizeof errbuf, "connection closed by peer");
        continue;
      }
      if (r < 0) {
        if (errno == EINTR) continue;
        err = 2;
        snprintf(errbuf, sizeof errbuf, "read: %s", strerror(errno));
        continue;
      }
      acc.insert(acc.end(), tmp, tmp + r);
    }
    // drain trailing TICI frames to a boundary (grace past deadline:
    // every response is already in hand)
    int64_t tdl = deadline;
    if (tdl >= 0) {
      int64_t grace = now_ms() + 2000;
      if (tdl < grace) tdl = grace;
    }
    while (!err && scanned < acc.size()) {
      size_t avail = acc.size() - scanned;
      const char* p = acc.data() + scanned;
      if (avail >= 4 && memcmp(p, "TICI", 4) != 0) {
        err = 3;
        snprintf(errbuf, sizeof errbuf,
                 "unexpected trailing bytes in batch read");
        break;
      }
      if (avail >= 8) {
        uint32_t cnt = 0;
        memcpy(&cnt, p + 4, 4);
        if (cnt > 8000) {
          err = 3;
          snprintf(errbuf, sizeof errbuf, "oversized ack frame");
          break;
        }
        size_t total = 8 + 8ul * cnt;
        if (avail >= total) {
          for (uint32_t i = 0; i < cnt; i++) {
            uint64_t id;
            memcpy(&id, p + 8 + 8ul * i, 8);
            batch_acks.push_back(id);
          }
          scanned += total;
          continue;
        }
      }
      char tmp2[4096];
      ssize_t r = recv(fd, tmp2, sizeof tmp2, 0);
      if (r > 0) {
        acc.insert(acc.end(), tmp2, tmp2 + r);
        continue;
      }
      if (r == 0) {
        err = 2;
        snprintf(errbuf, sizeof errbuf, "connection closed mid-ack");
        break;
      }
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        int pr = wait_fd(fd, POLLIN, tdl);
        if (pr == 0) err = 1;
        else if (pr < 0) {
          err = 2;
          snprintf(errbuf, sizeof errbuf, "poll: %s", strerror(errno));
        }
        continue;
      }
      if (errno == EINTR) continue;
      err = 2;
      snprintf(errbuf, sizeof errbuf, "read: %s", strerror(errno));
    }
  }
  Py_END_ALLOW_THREADS;

  cleanup_args(views);
  if (err) {
    if (err == 1)
      PyErr_SetString(PyExc_TimeoutError, "rpc deadline exceeded");
    else if (err == 2)
      PyErr_SetString(PyExc_ConnectionError, errbuf);
    else
      PyErr_SetString(PyExc_ValueError, errbuf);
    return nullptr;
  }

  // ---- materialize results (GIL held) ----
  PyObject* out_list = PyList_New(n);
  if (!out_list) return nullptr;
  for (Py_ssize_t k = 0; k < n; k++) {
    const char* bp = acc.data() + offs[(size_t)k];
    uint32_t body = osize[(size_t)k], meta = ometa[(size_t)k];
    // classify: plain success (only cid/att/domain tags, att==0) gets a
    // bare payload buffer; everything else goes back whole for RpcMeta
    bool plain = true;
    uint32_t att = 0;
    {
      size_t off2 = 0;
      while (off2 + 5 <= meta) {
        uint8_t tag = (uint8_t)bp[off2];
        uint32_t ln;
        memcpy(&ln, bp + off2 + 1, 4);
        off2 += 5;
        if (off2 + ln > meta) {
          plain = false;
          break;
        }
        if (tag == 3 && ln == 4) memcpy(&att, bp + off2, 4);
        else if (tag != 1 && tag != 15) plain = false;
        off2 += ln;
      }
    }
    PyObject* item;
    if (plain && att == 0) {
      NativeBuf* b = nativebuf_new((Py_ssize_t)(body - meta));
      if (!b) {
        Py_DECREF(out_list);
        return nullptr;
      }
      memcpy(b->data, bp + meta, body - meta);
      item = (PyObject*)b;
    } else {
      NativeBuf* b = nativebuf_new((Py_ssize_t)body);
      if (!b) {
        Py_DECREF(out_list);
        return nullptr;
      }
      memcpy(b->data, bp, body);
      item = Py_BuildValue("(Nk)", (PyObject*)b, (unsigned long)meta);
      if (!item) {
        Py_DECREF(out_list);
        return nullptr;
      }
    }
    PyList_SET_ITEM(out_list, k, item);
  }
  PyObject* acks = PyList_New((Py_ssize_t)batch_acks.size());
  if (!acks) {
    Py_DECREF(out_list);
    return nullptr;
  }
  for (size_t i = 0; i < batch_acks.size(); i++)
    PyList_SET_ITEM(acks, (Py_ssize_t)i,
                    PyLong_FromUnsignedLongLong(batch_acks[i]));
  return Py_BuildValue("(NN)", out_list, acks);
}

// ---------------------------------------------------------------------------
// ClientDemux — the native CLIENT completion lane (the client-side twin
// of the server's kind-3 slim lane).  The full-Controller async path
// used to pay, per response: one dispatcher wakeup, a fiber spawn, a
// Python frame cut, a full RpcMeta decode and a dict lookup.  Here a
// dedicated epoll loop owns the read side of attached client sockets,
// parses response frames off the read burst in C++, correlates them by
// cid against a native in-flight table (registered at send time from
// controller._issue_rpc), and delivers a whole burst of completions to
// Python in ONE batched callback:
//
//     callback(token, status, completions, fallbacks, acks)
//
//     status       0 = burst, 1 = peer EOF, 2 = transport/protocol error
//     completions  [(cid, payload_buf, att_size, dom_or_None), ...] —
//                  PLAIN success responses only (cid/att/ici-domain
//                  meta tags), payload_buf = NativeBuf(payload ++ att)
//     fallbacks    [(reason, raw_frame_buf), ...] — anything the scan
//                  cannot resolve natively, delivered as the EXACT wire
//                  bytes (header included) for the classic Python demux
//                  (byte-identical by construction).  ``reason`` indexes
//                  the closed CliFb enum below — no "unknown" bucket.
//     acks         TICI credit-return ids interleaved in the burst
//
// The in-flight table is the rendezvous: expect(token, cid) BEFORE the
// request write, cancel(token, cid) at call end (mirrors the Python
// socket's add_inflight/remove_inflight, which stays authoritative for
// failure notification).  A response whose meta carries anything
// controller-tier (errors, compression, shm, descriptors, stream
// grants) keeps its table entry and falls back whole — the classic
// path completes it and call teardown cancels the entry.
// ---------------------------------------------------------------------------

// closed client-lane fallback reason enum (mirrors FbReason's
// discipline: every frame routed OFF the native demux increments
// exactly one of these).  CONTRACT (machine-checked): kCliFbNames and
// client_lane.REASONS must track this enum — tools/check gates both.
enum CliFb : int {
  CFB_UNKNOWN_CID = 0,   // cid not in the in-flight table (stale /
                         // cancelled / foreign response)
  CFB_META_UNPARSED,     // no cid tag found / malformed meta walk
  CFB_META_TAGS,         // controller-tier response meta (error codes,
                         // compression, shm, descriptors, stream
                         // grants): full RpcMeta decode in Python
  CFB_STREAM_FRAME,      // TSTR stream frame on a lane socket
  CFB_UNKNOWN_MAGIC,     // not TRPC/TICI/TSTR: sticky passthrough —
                         // the Python protocol registry owns the conn
  CFB_REASONS
};
static const char* kCliFbNames[CFB_REASONS] = {
    "cli_unknown_cid", "cli_meta_unparsed", "cli_meta_tags",
    "cli_stream_frame", "cli_unknown_magic",
};

struct CliConn {
  int fd = -1;            // demux-owned dup() of the Python socket's fd
                          // (a Python-side close can never strand a
                          // recv on a reused fd number)
  uint64_t token = 0;
  bool dead = false;      // detach() marks; only the loop frees
  bool passthrough = false;  // unknown magic seen: forward everything
  std::string acc;        // unconsumed wire bytes across reads
  std::unordered_set<uint64_t> inflight;  // guarded by DemuxImpl::mu
};

struct CliTelemetry {
  uint64_t completions = 0;      // natively-demuxed responses
  uint64_t fallbacks[CFB_REASONS] = {};
  uint64_t acks = 0;
  uint64_t bursts = 0;           // batched callbacks delivered
  uint64_t bytes_in = 0;
  Hist comp_burst;               // completions per batched callback
};

struct DemuxImpl {
  PyObject* callback = nullptr;
  int epfd = -1;
  int wakefd = -1;
  std::atomic<bool> stopping{false};
  std::atomic<bool> running{false};
  // one mutex guards the conn map, every conn's inflight set and the
  // reap list: expect/cancel are sub-microsecond ops from GIL-holding
  // issuer threads, the loop touches the tables only around lookups
  std::mutex mu;
  std::unordered_map<uint64_t, CliConn*> conns;
  std::vector<uint64_t> reap;
  CliTelemetry tel;              // loop-thread writes; racy reads OK
};

// tokens are PROCESS-unique, not per-demux: the client lane runs a
// POOL of demux loops (one per core-ish, client_lane.py), and the
// Python routing tables key on the bare token — two loops handing out
// overlapping counters would cross-wire sockets
static std::atomic<uint64_t> g_cli_token{1};

typedef struct {
  PyObject_HEAD DemuxImpl* d;
} DemuxObj;

static void demux_wake(DemuxImpl* d) {
  uint64_t one = 1;
  ssize_t r = write(d->wakefd, &one, 8);
  (void)r;
}

// one parsed completion / fallback span into CliConn::acc
struct CliComp {
  uint64_t cid;
  size_t pay_off, pay_len;
  uint32_t att;
  size_t dom_off;
  uint32_t dom_len;
};
struct CliFbSpan {
  int reason;
  size_t off, len;
};

// Parse as many complete frames as possible from c->acc starting at 0;
// classifies each against the in-flight table.  Returns consumed bytes;
// *hard_err set on protocol-fatal framing (bad sizes).  Runs on the
// loop thread WITHOUT the GIL; takes d->mu only around table lookups.
static size_t cli_parse(DemuxImpl* d, CliConn* c,
                        std::vector<CliComp>& comps,
                        std::vector<CliFbSpan>& fbs,
                        std::vector<uint64_t>& acks, bool* hard_err) {
  const std::string& a = c->acc;
  size_t off = 0;
  while (a.size() - off >= 4) {
    const char* p = a.data() + off;
    size_t avail = a.size() - off;
    if (c->passthrough) {
      fbs.push_back({CFB_UNKNOWN_MAGIC, off, avail});
      off = a.size();
      break;
    }
    if (memcmp(p, "TICI", 4) == 0) {
      if (avail < 8) break;
      uint32_t cnt = 0;
      memcpy(&cnt, p + 4, 4);
      if (cnt > (1u << 20)) {
        *hard_err = true;
        break;
      }
      size_t total = 8 + 8ul * cnt;
      if (avail < total) break;
      for (uint32_t i = 0; i < cnt; i++) {
        uint64_t id;
        memcpy(&id, p + 8 + 8ul * i, 8);
        acks.push_back(id);
      }
      off += total;
      continue;
    }
    if (memcmp(p, "TRPC", 4) == 0) {
      if (avail < kHeaderSize) break;
      uint32_t body = 0, meta = 0;
      memcpy(&body, p + 4, 4);
      memcpy(&meta, p + 8, 4);
      if (body > kMaxBody || meta > body) {
        *hard_err = true;
        break;
      }
      size_t total = kHeaderSize + (size_t)body;
      if (avail < total) break;
      // response meta walk: cid + plain-success classification (the
      // same shape scan_plain_resp applies on the blocking lanes)
      uint64_t cid = 0;
      bool got_cid = false, plain = true;
      uint32_t att = 0;
      size_t dom_off = 0;
      uint32_t dom_len = 0;
      const char* mp = p + kHeaderSize;
      size_t mo = 0;
      while (mo + 5 <= meta) {
        uint8_t tag = (uint8_t)mp[mo];
        uint32_t ln;
        memcpy(&ln, mp + mo + 1, 4);
        mo += 5;
        if (mo + ln > meta) {
          got_cid = false;       // malformed walk: meta_unparsed
          break;
        }
        if (tag == 1 && ln == 8) {
          memcpy(&cid, mp + mo, 8);
          got_cid = true;
        } else if (tag == 3 && ln == 4) {
          memcpy(&att, mp + mo, 4);
        } else if (tag == 15) {
          dom_off = off + kHeaderSize + mo;
          dom_len = ln;
        } else {
          plain = false;
        }
        mo += ln;
      }
      if (!got_cid) {
        fbs.push_back({CFB_META_UNPARSED, off, total});
        off += total;
        continue;
      }
      bool eligible = plain && (size_t)att <= (size_t)body - meta;
      bool known, taken = false;
      {
        std::lock_guard<std::mutex> g(d->mu);
        known = c->inflight.count(cid) != 0;
        if (known && eligible) {
          c->inflight.erase(cid);
          taken = true;
        }
        // non-eligible shapes keep their entry: the classic demux
        // completes them and call teardown cancels the table row
      }
      if (taken) {
        comps.push_back({cid, off + kHeaderSize + meta,
                         (size_t)body - meta, att, dom_off, dom_len});
      } else if (!known) {
        fbs.push_back({CFB_UNKNOWN_CID, off, total});
      } else {
        fbs.push_back({CFB_META_TAGS, off, total});
      }
      off += total;
      continue;
    }
    if (memcmp(p, "TSTR", 4) == 0) {
      if (avail < 17) break;
      uint32_t len = 0;
      memcpy(&len, p + 13, 4);
      if (len > kMaxBody) {
        *hard_err = true;
        break;
      }
      size_t total = 4 + 13 + (size_t)len;
      if (avail < total) break;
      fbs.push_back({CFB_STREAM_FRAME, off, total});
      off += total;
      continue;
    }
    // unknown magic: STICKY passthrough — from here on every byte of
    // this connection belongs to the Python protocol registry (the
    // Python side detaches and converts to dispatcher reads)
    c->passthrough = true;
    fbs.push_back({CFB_UNKNOWN_MAGIC, off, avail});
    off = a.size();
    break;
  }
  return off;
}

// deliver one batched callback (ONE GIL entry per read burst) — the
// client-side mirror of flush_py_batch's discipline
static void cli_deliver(DemuxImpl* d, CliConn* c, int status,
                        std::vector<CliComp>& comps,
                        std::vector<CliFbSpan>& fbs,
                        std::vector<uint64_t>& acks) {
  if (status == 0 && comps.empty() && fbs.empty() && acks.empty())
    return;
  const std::string& a = c->acc;
  PyGILState_STATE gs = PyGILState_Ensure();
  PyObject* pc = Py_None;
  PyObject* pf = Py_None;
  PyObject* pa = Py_None;
  bool ok = true;
  if (!comps.empty()) {
    pc = PyList_New((Py_ssize_t)comps.size());
    ok = pc != nullptr;
    for (size_t i = 0; ok && i < comps.size(); i++) {
      CliComp& cm = comps[i];
      NativeBuf* b = nativebuf_new((Py_ssize_t)cm.pay_len);
      if (!b) {
        ok = false;
        break;
      }
      if (cm.pay_len) memcpy(b->data, a.data() + cm.pay_off, cm.pay_len);
      PyObject* dom;
      if (cm.dom_len) {
        dom = PyBytes_FromStringAndSize(a.data() + cm.dom_off,
                                        (Py_ssize_t)cm.dom_len);
        if (!dom) {
          Py_DECREF((PyObject*)b);
          ok = false;
          break;
        }
      } else {
        dom = Py_None;
        Py_INCREF(Py_None);
      }
      PyObject* t = Py_BuildValue("(KNkN)", (unsigned long long)cm.cid,
                                  (PyObject*)b, (unsigned long)cm.att,
                                  dom);
      if (!t) {
        ok = false;
        break;
      }
      PyList_SET_ITEM(pc, (Py_ssize_t)i, t);
    }
  }
  if (ok && !fbs.empty()) {
    pf = PyList_New((Py_ssize_t)fbs.size());
    ok = pf != nullptr;
    for (size_t i = 0; ok && i < fbs.size(); i++) {
      CliFbSpan& f = fbs[i];
      NativeBuf* b = nativebuf_new((Py_ssize_t)f.len);
      if (!b) {
        ok = false;
        break;
      }
      if (f.len) memcpy(b->data, a.data() + f.off, f.len);
      PyObject* t = Py_BuildValue("(iN)", f.reason, (PyObject*)b);
      if (!t) {
        ok = false;
        break;
      }
      PyList_SET_ITEM(pf, (Py_ssize_t)i, t);
    }
  }
  if (ok && !acks.empty()) {
    pa = PyList_New((Py_ssize_t)acks.size());
    ok = pa != nullptr;
    for (size_t i = 0; ok && i < acks.size(); i++) {
      PyObject* v = PyLong_FromUnsignedLongLong(acks[i]);
      if (!v) {
        ok = false;
        break;
      }
      PyList_SET_ITEM(pa, (Py_ssize_t)i, v);
    }
  }
  if (ok) {
    d->tel.bursts++;
    d->tel.completions += comps.size();
    d->tel.comp_burst.add((uint64_t)comps.size());
    for (auto& f : fbs) d->tel.fallbacks[f.reason]++;
    d->tel.acks += acks.size();
    PyObject* r = PyObject_CallFunction(
        d->callback, "KiOOO", (unsigned long long)c->token, status,
        pc == nullptr ? Py_None : pc, pf == nullptr ? Py_None : pf,
        pa == nullptr ? Py_None : pa);
    if (!r)
      PyErr_WriteUnraisable(d->callback);
    else
      Py_DECREF(r);
  } else {
    PyErr_WriteUnraisable(d->callback);
  }
  if (pc != Py_None) Py_XDECREF(pc);
  if (pf != Py_None) Py_XDECREF(pf);
  if (pa != Py_None) Py_XDECREF(pa);
  PyGILState_Release(gs);
}

// one readable event on a lane conn: drain the socket, parse, deliver
static void cli_readable(DemuxImpl* d, CliConn* c) {
  int status = 0;
  for (;;) {
    char tmp[65536];
    ssize_t r = recv(c->fd, tmp, sizeof tmp, 0);
    if (r > 0) {
      c->acc.append(tmp, (size_t)r);
      d->tel.bytes_in += (uint64_t)r;
      // bound one burst's accumulation; level-triggered epoll re-fires
      // for whatever the kernel still holds
      if (c->acc.size() >= (8u << 20)) break;
      continue;
    }
    if (r == 0) {
      status = 1;                       // peer EOF
      break;
    }
    if (errno == EAGAIN || errno == EWOULDBLOCK) break;
    if (errno == EINTR) continue;
    status = 2;                         // transport error
    break;
  }
  std::vector<CliComp> comps;
  std::vector<CliFbSpan> fbs;
  std::vector<uint64_t> acks;
  bool hard_err = false;
  size_t used = cli_parse(d, c, comps, fbs, acks, &hard_err);
  if (hard_err && status == 0) status = 2;   // bad framing: fail conn
  cli_deliver(d, c, status, comps, fbs, acks);
  c->acc.erase(0, used);
  if (status != 0) {
    // stop polling a dying conn; the Python side detaches (reap frees)
    c->dead = true;
    epoll_ctl(d->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  }
}

static void demux_run(DemuxImpl* d) {
  struct epoll_event evs[64];
  while (!d->stopping.load()) {
    int n = epoll_wait(d->epfd, evs, 64, 200);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    // reap detached conns (only the loop frees — an issuer thread must
    // never pull a CliConn out from under a recv)
    {
      std::vector<CliConn*> gone;
      {
        std::lock_guard<std::mutex> g(d->mu);
        for (uint64_t tok : d->reap) {
          auto it = d->conns.find(tok);
          if (it == d->conns.end()) continue;
          gone.push_back(it->second);
          d->conns.erase(it);
        }
        d->reap.clear();
      }
      for (CliConn* c : gone) {
        close(c->fd);
        delete c;
      }
    }
    for (int i = 0; i < n; i++) {
      uint64_t tok = evs[i].data.u64;
      if (tok == 0) {
        uint64_t drain;
        while (read(d->wakefd, &drain, 8) > 0) {
        }
        continue;
      }
      CliConn* c = nullptr;
      {
        std::lock_guard<std::mutex> g(d->mu);
        auto it = d->conns.find(tok);
        if (it != d->conns.end() && !it->second->dead) c = it->second;
      }
      if (c == nullptr) continue;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        // drain what the kernel still holds first (a peer close right
        // after the last response must deliver that response)
        cli_readable(d, c);
        if (!c->dead) {
          std::vector<CliComp> e1;
          std::vector<CliFbSpan> e2;
          std::vector<uint64_t> e3;
          cli_deliver(d, c, 1, e1, e2, e3);
          c->dead = true;
          epoll_ctl(d->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
        }
        continue;
      }
      if (evs[i].events & EPOLLIN) cli_readable(d, c);
    }
  }
  d->running.store(false);
}

static PyObject* Demux_new(PyTypeObject* type, PyObject* args,
                           PyObject* kwds) {
  PyObject* callback;
  static const char* kwlist[] = {"callback", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "O", (char**)kwlist,
                                   &callback))
    return nullptr;
  if (!PyCallable_Check(callback)) {
    PyErr_SetString(PyExc_TypeError, "callback must be callable");
    return nullptr;
  }
  DemuxObj* self = (DemuxObj*)type->tp_alloc(type, 0);
  if (!self) return nullptr;
  self->d = new DemuxImpl();
  Py_INCREF(callback);
  self->d->callback = callback;
  self->d->epfd = epoll_create1(EPOLL_CLOEXEC);
  self->d->wakefd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  struct epoll_event ev;
  ev.events = EPOLLIN;
  ev.data.u64 = 0;
  epoll_ctl(self->d->epfd, EPOLL_CTL_ADD, self->d->wakefd, &ev);
  return (PyObject*)self;
}

// run_loop() — the demux loop body, called from a Python thread (its
// resident frame pins the datastack chunk, so per-burst callbacks skip
// the cold-eval mmap churn a C thread pays).  Blocks until stop().
static PyObject* Demux_run_loop(DemuxObj* self, PyObject*) {
  DemuxImpl* d = self->d;
  d->running.store(true);
  Py_BEGIN_ALLOW_THREADS;
  demux_run(d);
  Py_END_ALLOW_THREADS;
  Py_RETURN_NONE;
}

// attach(fd) -> token.  The demux dup()s the fd: reads belong to the
// lane from here on (the Python socket keeps the write side).  The fd
// is NOT armed yet — the caller finishes its token -> socket
// bookkeeping first and then calls arm(token), so the very first
// burst/EOF callback can never race the registration and be dropped.
static PyObject* Demux_attach(DemuxObj* self, PyObject* args) {
  int fd;
  if (!PyArg_ParseTuple(args, "i", &fd)) return nullptr;
  DemuxImpl* d = self->d;
  int dupfd = dup(fd);
  if (dupfd < 0) {
    PyErr_SetFromErrno(PyExc_OSError);
    return nullptr;
  }
  CliConn* c = new CliConn();
  c->fd = dupfd;
  c->token = g_cli_token++;
  {
    std::lock_guard<std::mutex> g(d->mu);
    d->conns[c->token] = c;
  }
  return PyLong_FromUnsignedLongLong(c->token);
}

// arm(token) -> bool: register the attached fd with epoll (reads start
// flowing).  Call AFTER the Python-side routing state is in place.
static PyObject* Demux_arm(DemuxObj* self, PyObject* args) {
  unsigned long long token;
  if (!PyArg_ParseTuple(args, "K", &token)) return nullptr;
  DemuxImpl* d = self->d;
  CliConn* c = nullptr;
  {
    std::lock_guard<std::mutex> g(d->mu);
    auto it = d->conns.find(token);
    if (it != d->conns.end() && !it->second->dead) c = it->second;
  }
  if (c == nullptr) Py_RETURN_FALSE;
  struct epoll_event ev;
  ev.events = EPOLLIN;
  ev.data.u64 = c->token;
  if (epoll_ctl(d->epfd, EPOLL_CTL_ADD, c->fd, &ev) != 0)
    Py_RETURN_FALSE;
  Py_RETURN_TRUE;
}

static PyObject* Demux_detach(DemuxObj* self, PyObject* args) {
  unsigned long long token;
  if (!PyArg_ParseTuple(args, "K", &token)) return nullptr;
  DemuxImpl* d = self->d;
  {
    std::lock_guard<std::mutex> g(d->mu);
    auto it = d->conns.find(token);
    if (it != d->conns.end()) {
      it->second->dead = true;
      epoll_ctl(d->epfd, EPOLL_CTL_DEL, it->second->fd, nullptr);
      d->reap.push_back(token);
    }
  }
  if (d->running.load())
    demux_wake(d);
  else {
    // loop not running (teardown order): reap inline
    std::vector<CliConn*> gone;
    {
      std::lock_guard<std::mutex> g(d->mu);
      for (uint64_t tok : d->reap) {
        auto it = d->conns.find(tok);
        if (it == d->conns.end()) continue;
        gone.push_back(it->second);
        d->conns.erase(it);
      }
      d->reap.clear();
    }
    for (CliConn* c : gone) {
      close(c->fd);
      delete c;
    }
  }
  Py_RETURN_NONE;
}

// expect(token, cid) -> bool: register one in-flight correlation id
// BEFORE the request write (a response racing the registration would
// otherwise demux as unknown_cid)
static PyObject* Demux_expect(DemuxObj* self, PyObject* args) {
  unsigned long long token, cid;
  if (!PyArg_ParseTuple(args, "KK", &token, &cid)) return nullptr;
  DemuxImpl* d = self->d;
  std::lock_guard<std::mutex> g(d->mu);
  auto it = d->conns.find(token);
  if (it == d->conns.end() || it->second->dead) Py_RETURN_FALSE;
  it->second->inflight.insert(cid);
  Py_RETURN_TRUE;
}

// cancel(token, cid) -> bool: drop a registration (call teardown);
// True when the entry was still present
static PyObject* Demux_cancel(DemuxObj* self, PyObject* args) {
  unsigned long long token, cid;
  if (!PyArg_ParseTuple(args, "KK", &token, &cid)) return nullptr;
  DemuxImpl* d = self->d;
  std::lock_guard<std::mutex> g(d->mu);
  auto it = d->conns.find(token);
  if (it == d->conns.end()) Py_RETURN_FALSE;
  if (it->second->inflight.erase(cid)) Py_RETURN_TRUE;
  Py_RETURN_FALSE;
}

static PyObject* Demux_stop(DemuxObj* self, PyObject*) {
  self->d->stopping.store(true);
  demux_wake(self->d);
  Py_RETURN_NONE;
}

// telemetry() -> the client lane's observability table (same racy-read
// discipline as Engine.telemetry)
static PyObject* Demux_telemetry(DemuxObj* self, PyObject*) {
  DemuxImpl* d = self->d;
  PyObject* out = PyDict_New();
  if (!out) return nullptr;
  PyObject* fbd = PyDict_New();
  bool ok = fbd != nullptr;
  uint64_t fb_total = 0;
  for (int i = 0; ok && i < CFB_REASONS; i++) {
    fb_total += d->tel.fallbacks[i];
    ok = set_u64(fbd, kCliFbNames[i], d->tel.fallbacks[i]) == 0;
  }
  if (ok) ok = PyDict_SetItemString(out, "fallbacks", fbd) == 0;
  Py_XDECREF(fbd);
  if (ok) ok = set_u64(out, "completions", d->tel.completions) == 0;
  if (ok) ok = set_u64(out, "fallback_total", fb_total) == 0;
  if (ok) ok = set_u64(out, "acks", d->tel.acks) == 0;
  if (ok) ok = set_u64(out, "bursts", d->tel.bursts) == 0;
  if (ok) ok = set_u64(out, "bytes_in", d->tel.bytes_in) == 0;
  if (ok) ok = set_hist(out, "comp_burst", d->tel.comp_burst) == 0;
  if (ok) {
    size_t n;
    {
      std::lock_guard<std::mutex> g(d->mu);
      n = d->conns.size();
    }
    ok = set_u64(out, "attached", (uint64_t)n) == 0;
  }
  if (!ok) {
    Py_DECREF(out);
    return nullptr;
  }
  return out;
}

// pending() — total in-flight entries still registered across every
// attached conn: the drain plane waits for 0 before process exit (a
// leftover entry is a response the table would deliver into a torn-
// down Python world).
static PyObject* Demux_pending(DemuxObj* self, PyObject* args) {
  (void)args;
  size_t n = 0;
  {
    std::lock_guard<std::mutex> g(self->d->mu);
    for (auto& kv : self->d->conns) n += kv.second->inflight.size();
  }
  return PyLong_FromSize_t(n);
}

static void Demux_dealloc(DemuxObj* self) {
  if (self->d) {
    self->d->stopping.store(true);
    demux_wake(self->d);
    // give a still-running loop a moment to exit (the bridge joins its
    // thread before dropping the object; this is belt-and-braces)
    Py_BEGIN_ALLOW_THREADS;
    for (int i = 0; i < 100 && self->d->running.load(); i++) {
      struct timespec ts{0, 10 * 1000 * 1000};
      nanosleep(&ts, nullptr);
    }
    Py_END_ALLOW_THREADS;
    for (auto& kv : self->d->conns) {
      close(kv.second->fd);
      delete kv.second;
    }
    close(self->d->epfd);
    close(self->d->wakefd);
    Py_XDECREF(self->d->callback);
    delete self->d;
  }
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyMethodDef Demux_methods[] = {
    {"run_loop", (PyCFunction)Demux_run_loop, METH_NOARGS,
     "run the demux loop on the calling (Python) thread until stop()"},
    {"attach", (PyCFunction)Demux_attach, METH_VARARGS,
     "attach(fd) -> token: the lane dup()s and owns the read side "
     "(unarmed until arm(token))"},
    {"arm", (PyCFunction)Demux_arm, METH_VARARGS,
     "arm(token) -> bool: start demuxing an attached fd (call after "
     "the caller's token routing is in place)"},
    {"detach", (PyCFunction)Demux_detach, METH_VARARGS,
     "detach(token): stop demuxing; the dup'd fd closes on the loop"},
    {"expect", (PyCFunction)Demux_expect, METH_VARARGS,
     "expect(token, cid) -> bool: register an in-flight response"},
    {"cancel", (PyCFunction)Demux_cancel, METH_VARARGS,
     "cancel(token, cid) -> bool: drop a registration at call end"},
    {"stop", (PyCFunction)Demux_stop, METH_NOARGS, nullptr},
    {"pending", (PyCFunction)Demux_pending, METH_NOARGS,
     "pending() -> int: in-flight entries across attached conns (the "
     "drain plane waits for 0)"},
    {"telemetry", (PyCFunction)Demux_telemetry, METH_NOARGS,
     "client-lane counters: completions, reason-coded fallbacks, "
     "completions-per-burst histogram, acks, attached conns"},
    {nullptr, nullptr, 0, nullptr},
};

static PyTypeObject DemuxType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

static PyMethodDef module_methods[] = {
    {"sync_call", (PyCFunction)sync_call, METH_VARARGS,
     "sync_call(fd, parts, timeout_s) -> (buf, meta_size): write request "
     "parts, read one TRPC frame, GIL released"},
    {"sync_call_many", (PyCFunction)sync_call_many, METH_VARARGS,
     "sync_call_many(fd, parts, expect, timeout_s) -> [(buf, meta_size)]: "
     "pipelined batch — write all frames, read expect responses"},
    {"call_batch", (PyCFunction)call_batch, METH_VARARGS,
     "call_batch(fd, tail, payloads, timeout_s, cid_base, first_extra, "
     "lead) -> (results, acks): build/write/read a whole pipelined batch "
     "natively; results matched by correlation id"},
    {"raw_call", (PyCFunction)raw_call, METH_VARARGS,
     "raw_call(fd, tail, payload, attachment, timeout_ms, cid, lead) -> "
     "(ok, buf, n, dom, acks): one raw-lane round trip fully native — "
     "frame built, written, read and meta-scanned in C++"},
    {"scatter_call", (PyCFunction)scatter_call, METH_VARARGS,
     "scatter_call(items, timeout_s) -> [per-item result]: fan-out fast "
     "lane — write every branch's frame, then read one response per fd; "
     "items are (fd, tail, payload, att, cid, lead) tuples"},
    {nullptr, nullptr, 0, nullptr},
};

static PyModuleDef native_module = {
    PyModuleDef_HEAD_INIT, "_native",
    "native IO engine for brpc_tpu_torch (epoll + tpu_std framing in C++)", -1,
    module_methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) {
  NativeBufType.tp_name = "brpc_tpu_torch.native.NativeBuf";
  NativeBufType.tp_basicsize = sizeof(NativeBuf);
  NativeBufType.tp_dealloc = (destructor)NativeBuf_dealloc;
  NativeBufType.tp_flags = Py_TPFLAGS_DEFAULT;
  NativeBufType.tp_as_buffer = &NativeBuf_as_buffer;
  NativeBufType.tp_as_sequence = &NativeBuf_as_sequence;
  NativeBufType.tp_doc = "malloc-backed buffer owned by the native engine";
  if (PyType_Ready(&NativeBufType) < 0) return nullptr;

  EngineType.tp_name = "brpc_tpu_torch.native.Engine";
  EngineType.tp_basicsize = sizeof(EngineObj);
  EngineType.tp_dealloc = (destructor)Engine_dealloc;
  EngineType.tp_flags = Py_TPFLAGS_DEFAULT;
  EngineType.tp_methods = Engine_methods;
  EngineType.tp_new = Engine_new;
  EngineType.tp_doc = "epoll IO engine: C++ read/frame/write, Python dispatch";
  if (PyType_Ready(&EngineType) < 0) return nullptr;

  DemuxType.tp_name = "brpc_tpu_torch.native.ClientDemux";
  DemuxType.tp_basicsize = sizeof(DemuxObj);
  DemuxType.tp_dealloc = (destructor)Demux_dealloc;
  DemuxType.tp_flags = Py_TPFLAGS_DEFAULT;
  DemuxType.tp_methods = Demux_methods;
  DemuxType.tp_new = Demux_new;
  DemuxType.tp_doc =
      "native client completion lane: epoll demux of response frames, "
      "cid-correlated against an in-flight table, batched completion "
      "delivery (one GIL entry per read burst)";
  if (PyType_Ready(&DemuxType) < 0) return nullptr;

  PyObject* m = PyModule_Create(&native_module);
  if (!m) return nullptr;
  Py_INCREF(&EngineType);
  PyModule_AddObject(m, "Engine", (PyObject*)&EngineType);
  Py_INCREF(&NativeBufType);
  PyModule_AddObject(m, "NativeBuf", (PyObject*)&NativeBufType);
  Py_INCREF(&DemuxType);
  PyModule_AddObject(m, "ClientDemux", (PyObject*)&DemuxType);
  // client-lane fallback reason codes (closed enum; Python mirrors)
  PyModule_AddIntConstant(m, "CFB_UNKNOWN_CID", CFB_UNKNOWN_CID);
  PyModule_AddIntConstant(m, "CFB_META_UNPARSED", CFB_META_UNPARSED);
  PyModule_AddIntConstant(m, "CFB_META_TAGS", CFB_META_TAGS);
  PyModule_AddIntConstant(m, "CFB_STREAM_FRAME", CFB_STREAM_FRAME);
  PyModule_AddIntConstant(m, "CFB_UNKNOWN_MAGIC", CFB_UNKNOWN_MAGIC);
  PyModule_AddIntConstant(m, "EV_OPEN", EV_OPEN);
  PyModule_AddIntConstant(m, "EV_MESSAGE", EV_MESSAGE);
  PyModule_AddIntConstant(m, "EV_ACK", EV_ACK);
  PyModule_AddIntConstant(m, "EV_UNKNOWN", EV_UNKNOWN);
  PyModule_AddIntConstant(m, "EV_CLOSE", EV_CLOSE);
  PyModule_AddIntConstant(m, "EV_STREAM", EV_STREAM);
  PyModule_AddIntConstant(m, "EV_HTTP", EV_HTTP);
  PyModule_AddIntConstant(m, "EV_BYTES", EV_BYTES);
  return m;
}
