// Flash-attention backward for Hopper (sm_90a): two kernels, bound through
// a plain C interface (ctypes) by brpc_tpu_torch/ops/flash_attention.py.
//
// Replaces the Pallas kernels `_dq_kernel` and `_dkdv_kernel` (with
// `_masked_p`) of brpc_tpu/ops/flash_attention.py, launched from
// `_pallas_backward`.  Same arithmetic: p = exp(s * scale - lse) recomputed
// from the forward's lse, with keys at or past seq_len, and q < k when
// causal, masked to -1e30 first (a dead row, lse = 1e30, gives p = 0);
// dp = do . v^T; ds = p * (dp - dd) with dd = rowsum(do * o) computed by the
// caller; dq = sum_k ds . k * scale with ds rounded to k's dtype;
// dv = sum_q p^T . do with p rounded to do's dtype; dk = sum_q ds^T . q *
// scale with ds rounded to q's dtype.  Sums are f32.
//
// Layout: q/k/v/do are (b, s, h, d) read in place through their strides
// (the last dimension contiguous); lse and dd are f32 (b, h, s) contiguous;
// dq/dk/dv are written (b, s, h, d) contiguous in the input dtype.
//
// The Pallas grid carries its accumulators across a sequential grid axis.
// Here each output tile has one owner block that loops internally, so there
// are no atomics and the result is deterministic.
//
// What bounds them: at the training shape (4, 2048, 16, 128) causal, dq
// does 6 and dkdv 8 FLOPs per head dim per live (q, k) pair, 1.03e11 and
// 1.38e11 FLOPs over 337 and 404 MB of f32 inputs and outputs: bound by
// operations.  At 67 TFLOP/s of f32 FMAs that is 1.54 and 2.05 ms; as
// 3xTF32 on the tensor cores (495 TFLOP/s, three products each) 0.625 and
// 0.834 ms.
//
// flash_dq_kernel runs on the tensor cores with the forward's pieces
// (flash_mma.cuh, flash_fwd.cu): a block owns a q tile of 16 rows per
// warp, q tiles heaviest first, over 32-key k/v tiles in a two-stage
// cp.async ring: s = q.k^T and dp = do.v^T on warp MMA (f32 as 3xTF32,
// bf16 on m16n8k16), p and ds in registers, ds fed straight into
// dq += ds.k as the A operand (k read along the key axis: permuted keys
// for tf32, ldmatrix.trans for bf16).  Only the tiles crossing the
// diagonal are masked.  f32: 8 warps and 128 rows, q and do read from
// shared memory per k step (in registers with dq's accumulator they
// spill), k/v split per use (kept split, the ring would not fit beside q
// and do): 198 KB, one block per SM.  bf16: 4 warps, q in registers.
//
// flash_dkdv_kernel runs on the same pieces, transposed: a warp owns 16
// keys and a block the keys of its warps, with dk and dv for them in
// registers, written once; the block walks the q rows in steps of BQ
// (from its first key when causal; the heaviest key blocks of every head
// and batch start first).  Per step, in the Pallas kernel's order:
// s^T = k.q^T, p^T in its place, dv += p^T.do, dp^T = v.do^T, ds^T =
// p^T (dp^T - dd) in place, dk += ds^T.q.  q and do are the B operand of
// all four products: they stream through the two-stage cp.async ring with
// their lse and dd rows and, for f32, are split to tf32 hi/lo once, in
// place, as each thread's own pieces land (SplitB), so no warp splits a B
// value.  k and v are the A operand of s^T and dp^T, read from shared
// memory per k step; p and ds are the A operand of the dv and dk products
// straight from the accumulators (keys permuted inside each k8 step as in
// the forward; bf16: packed, which is the reference's rounding).  The A
// splits take split_tf32_fast: three instructions where a split by
// cvt.rna.tf32 takes seven, and those splits outnumbered the MMAs.  Keys
// past seq_len need no mask, their rows are not stored; only the steps
// that cross the diagonal are masked, and a warp skips the steps that lie
// wholly above its keys.  DkdvSplit and DkdvBf16, chosen by timings on an
// H100: f32 8 warps, 128 keys and 16-row steps: k and v 2 x 128 x 132
// floats, the ring 2 x 4 x 16 x 132 (q, do and their lo halves) and
// 2 x 32 lse/dd floats = 203,008 B, one block per SM (64 keys of 4 warps
// with 32-row steps, the same shared memory, ran slower).  bf16:
// 4 warps, 64 keys, 32-row steps, 70 KB, two blocks per SM.  At d = 128
// dk and dv take 128 of the 255 registers: the head's bases come from
// shared memory at each step and the key block from blockIdx.y, so that
// no per-block value stays live across the products (ptxas spilled them).
//
// Head dims 1 <= d <= 128 are zero-padded to 16, 32, 64 or 128, and
// 129 <= d <= 256 to 256, as the Pallas kernels pad d to 128s.  At
// d = 256 (DqCfg, DkdvCfg):
// - dq: 4 warps, 64 rows, 16-key k/v tiles; f32 199,680 B, one block per
//   SM (32-key tiles would need 266,240 B); bf16 reads q from shared
//   memory per k step (q_in_regs), 101,376 B, two blocks per SM.  The
//   accumulator is 128 registers a thread.
// - dkdv (DkdvPair, DkdvPairBf16).  What bounds it: 8 FLOPs per head dim
//   per live pair, the d = 128 operations at half the heads (0.834 ms at
//   (4, 2048, 8, 256) as 3xTF32), but dk and dv for 256 columns would take
//   all 255 registers of a thread, and k and v for 128 keys alone 266,240
//   B.  So warp pairs split d (flash_mma.cuh pair_sum): 8 warps and 64
//   keys, four groups of 16 keys, each shared by warps kg and kg + 4 over
//   columns 0-127 and 128-255.  Per q step each warp takes its half of
//   s^T = k.q^T, the pair swaps the partials and both form p^T; dv +=
//   p^T.do over the warp's half of do; the same for dp^T = v.do^T, then
//   ds^T; dk += ds^T.q over its half of q.  Each warp keeps dk and dv for
//   128 columns (the d = 128 budget), the score products are taken once
//   (a grid axis over the column halves of dk and dv, each block taking
//   s^T and dp^T over the whole d, did 1.5x the FLOPs on 4 warps an SM
//   and ran 2.5x slower in f32, 1.4x in bf16), and every dk/dv element
//   still has one owner block.  f32: 16-row steps with the q/do ring
//   unsplit, each warp splitting q and do per use with split_tf32_fast as
//   it splits its A operands (kept split, 16-row steps would not fit;
//   8-row steps kept split ran 1.25x slower, rounded splits per use
//   1.21x): k, v 133,120 B, ring 66,560, lse/dd 256, swap buffers (two a
//   warp, 16 x 16 floats each) 16,384: 216,320 B, one block per SM; ptxas
//   245 registers, no spill.  bf16: 32-row steps (16-row steps ran 1.2x
//   slower): 67,584 + 67,584 + 512 + 32,768 = 168,448 B, one block per SM;
//   ptxas 237 registers, no spill.  Timings on an H100: PERF.md.

#include "flash_mma.cuh"

namespace {

// The schedule of flash_dq_kernel for each dtype and padded head dim:
// warps per block (16 q rows each), keys per k tile and the blocks per SM
// the registers must allow.  q's A fragments stay in registers for bf16
// up to d = 128 and are read from shared memory per k step otherwise, as
// do's always are (QSource, SmemSource).
template <typename T, int D>
struct DqCfg {
  static constexpr bool F32 = std::is_same_v<T, float>;
  static constexpr int NW = F32 && D <= 128 ? 8 : 4;
  static constexpr int BK = D <= 128 ? 32 : 16;
  static constexpr int MINB = F32 ? 1 : 2;
};

// Schedules of flash_dkdv_kernel: warps per block (16 keys each, or each
// warp pair 16 keys), the warps that share 16 keys, one part of the head
// dim each (DSPLIT: warp pairs, flash_mma.cuh pair_sum), q rows per step
// of the q/do ring, whether the ring keeps q and do split into tf32 hi/lo
// (f32; else each warp splits them per use with split_tf32_fast, as it
// splits its A operands), and the blocks per SM the registers must allow.
// Each schedule states where it differs from DkdvSchedule; DkdvCfg picks
// one by dtype and padded head dim.
struct DkdvSchedule {
  static constexpr int NW = 8;
  static constexpr int DSPLIT = 1;
  static constexpr int BQ = 16;
  static constexpr bool SPLIT = false;
  static constexpr int MINB = 1;
};
struct DkdvSplit : DkdvSchedule {  // f32, d <= 128: 128 keys, split ring
  static constexpr bool SPLIT = true;
};
struct DkdvBf16 : DkdvSchedule {  // bf16, d <= 128: 64 keys, two per SM
  static constexpr int NW = 4;
  static constexpr int BQ = 32;
  static constexpr int MINB = 2;
};
struct DkdvPair : DkdvSchedule {  // f32, d = 256: 64 keys, pairs split d
  static constexpr int DSPLIT = 2;
};
struct DkdvPairBf16 : DkdvPair {  // bf16, d = 256: 32-row steps
  static constexpr int BQ = 32;
};
template <typename T, int D>
using DkdvCfg =
    std::conditional_t<std::is_same_v<T, float>,
                       std::conditional_t<(D > 128), DkdvPair, DkdvSplit>,
                       std::conditional_t<(D > 128), DkdvPairBf16, DkdvBf16>>;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* dd;
  void* g0;  // dq, or dk
  void* g1;  // unused, or dv
  int b, s, h, d;
  long long qs0, qs1, qs2;  // element strides of dims b, s, h
  long long ks0, ks1, ks2;
  long long vs0, vs1, vs2;
  long long ds0, ds1, ds2;
  float scale;
  int causal;
};

// Shared memory of one dq block, in elements: two ring stages, each a k
// and a v tile, then do, then q unless q passes through a stage before
// the loop.
template <typename T, int D>
constexpr int dq_smem_elems() {
  using C = DqCfg<T, D>;
  constexpr int LD = flash_mma::tile_ld<T, D>();
  return 4 * C::BK * LD +
         (flash_mma::q_in_regs<T, D>() ? 1 : 2) * 16 * C::NW * LD;
}

template <typename T, int D>
__global__ void __launch_bounds__((32 * DqCfg<T, D>::NW),
                                  (DqCfg<T, D>::MINB))
    flash_dq_kernel(Args a) {
  using namespace flash_mma;
  using C = DqCfg<T, D>;
  constexpr int NT = 32 * C::NW;  // threads
  constexpr int BQ = 16 * C::NW;  // q rows per block
  constexpr int BK = C::BK;       // keys per k tile
  constexpr int LD = tile_ld<T, D>();
  constexpr int TILE = BK * LD;   // elements of one k or v tile
  constexpr int SS = 2 * TILE;    // one ring stage
  constexpr int NJ = BK / 8;      // score n8 tiles of a warp
  constexpr int NO = D / 8;         // dq n8 tiles of a warp
  constexpr bool F32 = std::is_same_v<T, float>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage st: k at st SS, v at st SS + TILE; then do; then q (or q in
  // stage 1)
  T* const ring = reinterpret_cast<T*>(smem_raw);
  T* const sdo = ring + 2 * SS;
  constexpr bool Q_REGS = q_in_regs<T, D>();
  static_assert(!Q_REGS || BQ * LD <= SS, "q must fit one stage");
  T* const sq = Q_REGS ? ring + SS : sdo + BQ * LD;

  // q tiles heaviest first, as in the forward
  const int nq = (a.s + BQ - 1) / BQ, bh = a.b * a.h;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / bh) * BQ;
  const int hh = blockIdx.x % bh % a.h, bb = blockIdx.x % bh / a.h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const T* q = static_cast<const T*>(a.q) + bb * a.qs0 + hh * a.qs2;
  const T* k = static_cast<const T*>(a.k) + bb * a.ks0 + hh * a.ks2;
  const T* v = static_cast<const T*>(a.v) + bb * a.vs0 + hh * a.vs2;
  const T* dout = static_cast<const T*>(a.dout) + bb * a.ds0 + hh * a.ds2;
  const bool kvec = can_vec(k, a.ks1, a.d), vvec = can_vec(v, a.vs1, a.d);

  const int k_end = a.causal ? min(q0 + BQ, a.s) : a.s;
  const int nkt = (k_end + BK - 1) / BK;
  auto load_kv = [&](T* st, int k0) {
    flash_mma::load_tile<T, BK, D, NT>(st, k, a.ks1, k0, a.s, a.d, kvec);
    flash_mma::load_tile<T, BK, D, NT>(st + TILE, v, a.vs1, k0, a.s, a.d,
                                       vvec);
  };

  flash_mma::load_tile<T, BQ, D, NT>(sq, q, a.qs1, q0, a.s, a.d,
                                     can_vec(q, a.qs1, a.d));
  flash_mma::load_tile<T, BQ, D, NT>(sdo, dout, a.ds1, q0, a.s, a.d,
                                     can_vec(dout, a.ds1, a.d));
  load_kv(ring, 0);
  cp_async_commit();
  QSource<T, D> qa;
  if constexpr (Q_REGS) {
    // the q tile sits in stage 1 until its fragments are in registers
    cp_async_wait_all();
    __syncthreads();
  }
  qa.init(sq, warp * 16);
  SmemSource<T, D> doa;
  doa.init(sdo, warp * 16);

  // rows past seq_len: lse 1e30 gives p = 0, so they add nothing
  const float sl = a.scale * LOG2E;
  const long long rows = ((long long)bb * a.h + hh) * a.s;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < a.s ? a.lse[rows + row] * LOG2E : 1e30f;
    dd[r] = row < a.s ? a.dd[rows + row] : 0.f;
  }
  float acc[NO][4] = {};

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    T* const st = ring + (kt & 1) * SS;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; tile kt - 1 (and q) consumed
    if (kt + 1 < nkt) {
      load_kv(ring + ((kt + 1) & 1) * SS, k0 + BK);
      cp_async_commit();
    }

    // s = q . k^T and dp = do . v^T for this warp's 16 rows
    float sc[NJ][4] = {}, dp[NJ][4] = {};
    if constexpr (F32) {
      mma_abt3<D, BK>(sc, qa, RawB{st});
      mma_abt3<D, BK>(dp, doa, RawB{st + TILE});
    } else {
      mma_abt_bf16<D, BK>(sc, qa, st);
      mma_abt_bf16<D, BK>(dp, doa, st + TILE);
    }

    // ds = p * (dp - dd), p = exp(s * scale - lse) in log2 units
    const bool masked = k0 + BK > a.s || (a.causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = sc[j][c] * sl;
        if (masked) {
          const int row = row0 + 8 * (c >> 1);
          const int col = k0 + j * 8 + 2 * t + (c & 1);
          if (col >= a.s || (a.causal && row < col)) x = -1e30f;
        }
        const float p = exp2f(x - lse2[c >> 1]);
        sc[j][c] = p * (dp[j][c] - dd[c >> 1]);
      }
    // dq += ds . k, ds rounded to k's dtype
    if constexpr (F32)
      mma_pb3<D, BK>(acc, sc, RawB{st});
    else
      mma_pb_bf16<D, BK>(acc, sc, st);
  }

  T* dq = static_cast<T*>(a.g0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.s) continue;
    T* out = dq + (((long long)bb * a.s + row) * a.h + hh) * a.d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * t;
      store2(out + col, acc[n][2 * r] * a.scale, acc[n][2 * r + 1] * a.scale,
             a.d - col);
    }
  }
}

// lse and dd of q rows [r0, r0 + ROWS) into dst[0, ROWS) and
// dst[ROWS, 2 ROWS), by 4-byte cp.async; rows past seq_len get lse 1e30
// (so p = 0) and dd 0.
template <int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* lse,
                                          const float* dd, int r0, int s) {
#pragma unroll
  for (int m = 0; m < (2 * ROWS + NT - 1) / NT; ++m) {
    const int i = threadIdx.x + m * NT;
    if (i >= 2 * ROWS) break;
    const bool is_dd = i >= ROWS;
    const int r = r0 + (is_dd ? i - ROWS : i);
    if (r < s)
      flash_mma::cp_async4(dst + i, (is_dd ? dd : lse) + r);
    else
      dst[i] = is_dd ? 0.f : 1e30f;
  }
}

// Shared memory of one dkdv block, in bytes: the block's k and v tiles,
// two ring stages of q and do (and their lo halves when split), each
// stage's lse and dd rows, and with warp pairs two swap buffers per warp
// (a 16 x BQ f32 partial of s^T and of dp^T).
template <typename T, int D, class C>
constexpr size_t dkdv_smem_bytes() {
  constexpr int parts = C::SPLIT ? 4 : 2;
  constexpr int nk = 16 * C::NW / C::DSPLIT;
  constexpr int swap = C::DSPLIT > 1 ? C::NW * 2 * 16 * C::BQ : 0;
  return sizeof(T) * (2 * nk + 2 * parts * C::BQ) *
             flash_mma::tile_ld<T, D>() +
         sizeof(float) * (4 * C::BQ + swap);
}

template <typename T, int D, class C>
__global__ void __launch_bounds__((32 * C::NW), (C::MINB))
    flash_dkdv_kernel(Args a) {
  using namespace flash_mma;
  constexpr int NT = 32 * C::NW;  // threads
  constexpr int P = C::DSPLIT;    // parts of d, one warp each
  constexpr int PW = C::NW / P;   // warps of one part: key groups
  constexpr int NK = 16 * PW;     // keys per block
  constexpr int BQ = C::BQ;       // q rows per ring step
  constexpr int LD = tile_ld<T, D>();
  constexpr int TILE = BQ * LD;  // elements of one q or do tile
  constexpr bool F32 = std::is_same_v<T, float>;
  constexpr bool SPLIT = C::SPLIT;
  static_assert(F32 || !SPLIT, "bf16 tiles are not split");
  constexpr int SS = (SPLIT ? 4 : 2) * TILE;  // one ring stage
  constexpr int NJ = BQ / 8;                  // s^T n8 tiles of a warp
  constexpr int DS = D / P;  // columns of s^T, dp^T, dk and dv of a warp
  constexpr int NO = DS / 8;  // dk/dv n8 tiles of a warp
  // The warp's first column (its part of d): cheap to recompute, not kept
  // live across the products.
  auto col0 = [] {
    return P > 1 ? static_cast<int>(threadIdx.x >> 5) / PW * DS : 0;
  };
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // k, v; then stage st: q at st SS, do at + TILE, their lo halves at
  // + 2 TILE and + 3 TILE (split); then stage st's lse at 2 st BQ floats
  // past the ring and its dd BQ floats further; then the swap buffers
  T* const sk = reinterpret_cast<T*>(smem_raw);
  T* const sv = sk + NK * LD;
  T* const ring = sv + NK * LD;
  float* const srows = reinterpret_cast<float*>(ring + 2 * SS);
  float* const swap = srows + 4 * BQ;

  // grid (b h, key blocks): blocks start in linear order, x fastest, so
  // the heaviest (first) key block of every head and batch goes first;
  // and the block's first key is cheap to recompute, not kept live
  const int k0 = static_cast<int>(blockIdx.y) * NK;
  const int hh = blockIdx.x % a.h, bb = blockIdx.x / a.h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int kg = warp % PW;        // key group; the pair: kg and kg + PW
  const int kw0 = k0 + kg * 16;    // this warp's keys: kw0 .. kw0 + 15
  const T* q = static_cast<const T*>(a.q) + bb * a.qs0 + hh * a.qs2;
  const T* k = static_cast<const T*>(a.k) + bb * a.ks0 + hh * a.ks2;
  const T* v = static_cast<const T*>(a.v) + bb * a.vs0 + hh * a.vs2;
  const T* dout = static_cast<const T*>(a.dout) + bb * a.ds0 + hh * a.ds2;
  const bool qvec = can_vec(q, a.qs1, a.d), dvec = can_vec(dout, a.ds1, a.d);
  const long long rows = ((long long)bb * a.h + hh) * a.s;
  // This head's bases, which the step loader and the stores read from
  // shared memory (after the barrier that follows thread 0's write): kept
  // in registers across the loop, they made ptxas spill at d = 128.
  struct Bases {
    const T* q;
    const T* dout;
    const float* lse;
    const float* dd;
    T* gk;  // dk and dv at row 0 of this head; rows h d apart
    T* gv;
  };
  __shared__ Bases bases;
  if (threadIdx.x == 0) {
    const long long out0 = ((long long)bb * a.s * a.h + hh) * a.d;
    bases = {q,
             dout,
             a.lse + rows,
             a.dd + rows,
             static_cast<T*>(a.g0) + out0,
             static_cast<T*>(a.g1) + out0};
  }

  // causal: q rows below k0 see none of this block's keys.  The step
  // q0 / BQ starts even, so its ring stage is (q0 / BQ) & 1, and the loop
  // keeps no count of its own beside q0.
  static_assert(NK % (2 * BQ) == 0, "the first step must use stage 0");
  const int q_begin = a.causal ? k0 : 0;
  auto load_qdo = [&](int stage, int q0, const Bases& src) {
    T* const dst = ring + stage * SS;
    load_tile<T, BQ, D, NT>(dst, src.q, a.qs1, q0, a.s, a.d, qvec,
                            SPLIT ? dst + 2 * TILE : nullptr);
    load_tile<T, BQ, D, NT>(dst + TILE, src.dout, a.ds1, q0, a.s, a.d, dvec,
                            SPLIT ? dst + 3 * TILE : nullptr);
    load_rows<BQ, NT>(srows + stage * 2 * BQ, src.lse, src.dd, q0, a.s);
  };

  load_tile<T, NK, D, NT>(sk, k, a.ks1, k0, a.s, a.d,
                          can_vec(k, a.ks1, a.d));
  load_tile<T, NK, D, NT>(sv, v, a.vs1, k0, a.s, a.d,
                          can_vec(v, a.vs1, a.d));
  load_qdo(0, q_begin, {q, dout, a.lse + rows, a.dd + rows, nullptr, nullptr});
  cp_async_commit();
  // f32: the A fragments of k and v take the three-instruction split
  std::conditional_t<F32, SmemA<D, true>, BfSmemA<D>> ka, va;
  ka.init(sk + col0(), kg * 16);
  va.init(sv + col0(), kg * 16);

  const float sl = a.scale * LOG2E;
  float dk[NO][4] = {}, dv[NO][4] = {};

  for (int q0 = q_begin; q0 < a.s; q0 += BQ) {
    const int stage = (q0 / BQ) & 1;
    T* const st = ring + stage * SS;
    const float* const sr = srows + stage * 2 * BQ;
    cp_async_wait_all();
    if constexpr (SPLIT) {
      split_own<BQ, D, NT>(st, st + 2 * TILE, qvec);
      split_own<BQ, D, NT>(st + TILE, st + 3 * TILE, dvec);
    }
    __syncthreads();  // this step landed; the last one (and k, v) consumed
    if (q0 + BQ < a.s) {
      load_qdo(stage ^ 1, q0 + BQ, bases);
      cp_async_commit();
    }
    // causal: every row of this step lies above this warp's keys
    if (a.causal && q0 + BQ <= kw0) continue;

    // s^T = k . q^T for this warp's 16 keys and the step's BQ rows (with
    // warp pairs: this warp's part of d, then the pair's sum)
    float sc[NJ][4] = {};
    if constexpr (SPLIT)
      mma_abt3<DS, BQ, D>(sc, ka, SplitB{st + col0(), st + 2 * TILE + col0()});
    else if constexpr (F32)
      mma_abt3<DS, BQ, D>(sc, ka, RawBT<true>{st + col0()});
    else
      mma_abt_bf16<DS, BQ, D>(sc, ka, st + col0());
    if constexpr (P > 1)
      pair_sum(sc, swap + warp * 32 * BQ, swap + (warp ^ PW) * 32 * BQ,
               1 + kg);

    // p = exp(s scale - lse) in log2 units, in place of s^T; a lane's
    // keys are kw0 + g (+ 8), its rows q0 + 8 j + 2 t (+ 1)
    const bool masked = a.causal && q0 < kw0 + 15;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(sr + j * 8 + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = sc[j][c] * sl;
        if (masked && q0 + j * 8 + 2 * t + (c & 1) < kw0 + g + 8 * (c >> 1))
          x = -1e30f;
        sc[j][c] = exp2f(x - ((c & 1) ? l.y : l.x) * LOG2E);
      }
    }
    // dv += p^T . do, p rounded to do's dtype (the warp's columns of do)
    if constexpr (SPLIT)
      mma_pb3<DS, BQ, true, D>(
          dv, sc, SplitB{st + TILE + col0(), st + 3 * TILE + col0()});
    else if constexpr (F32)
      mma_pb3<DS, BQ, true, D>(dv, sc, RawBT<true>{st + TILE + col0()});
    else
      mma_pb_bf16<DS, BQ, D>(dv, sc, st + TILE + col0());

    // dp^T = v . do^T; ds^T = p^T (dp^T - dd), in place of p^T
    float dp[NJ][4] = {};
    if constexpr (SPLIT)
      mma_abt3<DS, BQ, D>(
          dp, va, SplitB{st + TILE + col0(), st + 3 * TILE + col0()});
    else if constexpr (F32)
      mma_abt3<DS, BQ, D>(dp, va, RawBT<true>{st + TILE + col0()});
    else
      mma_abt_bf16<DS, BQ, D>(dp, va, st + TILE + col0());
    if constexpr (P > 1)
      pair_sum(dp, swap + warp * 32 * BQ + 16 * BQ,
               swap + (warp ^ PW) * 32 * BQ + 16 * BQ, 1 + kg);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 e =
          *reinterpret_cast<const float2*>(sr + BQ + j * 8 + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sc[j][c] *= dp[j][c] - ((c & 1) ? e.y : e.x);
    }
    // dk += ds^T . q, ds rounded to q's dtype (times scale at the store)
    if constexpr (SPLIT)
      mma_pb3<DS, BQ, true, D>(dk, sc,
                               SplitB{st + col0(), st + 2 * TILE + col0()});
    else if constexpr (F32)
      mma_pb3<DS, BQ, true, D>(dk, sc, RawBT<true>{st + col0()});
    else
      mma_pb_bf16<DS, BQ, D>(dk, sc, st + col0());
  }

  T* const gk = bases.gk;
  T* const gv = bases.gv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + g + 8 * r;
    if (key >= a.s) continue;
    const long long off = (long long)key * a.h * a.d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = col0() + n * 8 + 2 * t;
      store2(gk + off + col, dk[n][2 * r] * a.scale,
             dk[n][2 * r + 1] * a.scale, a.d - col);
      store2(gv + off + col, dv[n][2 * r], dv[n][2 * r + 1], a.d - col);
    }
  }
}

template <typename T, int D>
int launch_dq(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = sizeof(T) * dq_smem_elems<T, D>();
  static_assert(smem * DqCfg<T, D>::MINB <= 232448, "shared memory of an SM");
  const cudaError_t err = flash_mma::allow_smem(flash_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int bq = 16 * DqCfg<T, D>::NW;
  const int grid = (a.s + bq - 1) / bq * a.b * a.h;
  flash_dq_kernel<T, D><<<grid, 32 * DqCfg<T, D>::NW, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const Args& a, cudaStream_t stream) {
  using C = DkdvCfg<T, D>;
  constexpr size_t smem = dkdv_smem_bytes<T, D, C>();
  static_assert(smem * C::MINB <= 232448, "shared memory of an SM");
  const cudaError_t err =
      flash_mma::allow_smem(flash_dkdv_kernel<T, D, C>, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int nk = 16 * C::NW / C::DSPLIT;
  const dim3 grid(a.b * a.h, (a.s + nk - 1) / nk);
  flash_dkdv_kernel<T, D, C><<<grid, 32 * C::NW, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, bool dkdv, cudaStream_t st) {
  if (a.d <= 16) return dkdv ? launch_dkdv<T, 16>(a, st) : launch_dq<T, 16>(a, st);
  if (a.d <= 32) return dkdv ? launch_dkdv<T, 32>(a, st) : launch_dq<T, 32>(a, st);
  if (a.d <= 64) return dkdv ? launch_dkdv<T, 64>(a, st) : launch_dq<T, 64>(a, st);
  if (a.d <= 128) return dkdv ? launch_dkdv<T, 128>(a, st) : launch_dq<T, 128>(a, st);
  return dkdv ? launch_dkdv<T, 256>(a, st) : launch_dq<T, 256>(a, st);
}

int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* dd, void* g0, void* g1, int b, int s,
        int h, int d, long long qs0, long long qs1, long long qs2,
        long long ks0, long long ks1, long long ks2, long long vs0,
        long long vs1, long long vs2, long long ds0, long long ds1,
        long long ds2, int is_bf16, int causal, float scale, void* stream,
        bool dkdv) {
  if (d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  Args a{q,   k,   v,   dout, static_cast<const float*>(lse),
         static_cast<const float*>(dd), g0, g1, b, s, h, d,
         qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2, ds0, ds1, ds2,
         scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, dkdv, st)
                 : dispatch<float>(a, dkdv, st);
}

}  // namespace

// Each returns a cudaError_t value: 0 on a launch that was accepted.  The
// caller has checked devices, dtypes, shapes, 1 <= d <= 256, unit last
// strides of q/k/v/do, contiguous lse/dd and contiguous outputs.
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dd,
                        void* dq, int b, int s, int h, int d, long long qs0,
                        long long qs1, long long qs2, long long ks0,
                        long long ks1, long long ks2, long long vs0,
                        long long vs1, long long vs2, long long ds0,
                        long long ds1, long long ds2, int is_bf16,
                        int causal, float scale, void* stream) {
  return run(q, k, v, dout, lse, dd, dq, nullptr, b, s, h, d, qs0, qs1, qs2,
             ks0, ks1, ks2, vs0, vs1, vs2, ds0, ds1, ds2, is_bf16, causal,
             scale, stream, false);
}

extern "C" int flash_dkdv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* dd,
                          void* dk, void* dv, int b, int s, int h, int d,
                          long long qs0, long long qs1, long long qs2,
                          long long ks0, long long ks1, long long ks2,
                          long long vs0, long long vs1, long long vs2,
                          long long ds0, long long ds1, long long ds2,
                          int is_bf16, int causal, float scale,
                          void* stream) {
  return run(q, k, v, dout, lse, dd, dk, dv, b, s, h, d, qs0, qs1, qs2, ks0,
             ks1, ks2, vs0, vs1, vs2, ds0, ds1, ds2, is_bf16, causal, scale,
             stream, true);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
