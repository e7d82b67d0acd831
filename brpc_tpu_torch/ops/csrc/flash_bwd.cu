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
// flash_dkdv_kernel: one block per (64-key k tile, head, batch), looping
// over 32-row q tiles (q tile >= k tile when causal); dk and dv stay in
// registers and are written once.  It still computes every product with
// f32 FMAs from shared-memory tiles, bf16 widened on load.  A warp holds
// two rows (ty) of 16 columns (tx).  Tiles that 16 lanes read down one
// column at once get a one-float row pad, which spreads the rows over 16
// banks.  Tiles that a warp reads two rows at a time, the same column in
// each, need only the two rows in different banks: they are "paired"
// (`pair_row`), rows 2m and 2m + 1 of width W sitting W + 1 floats apart in
// a block of 2W + 1, half a float of padding per row: k and v 2 x (64 x 128
// + 32), q and do 2 x 32 x 129, p and ds 2 x (64 x 32 + 32) floats =
// 115,456 B, two blocks per SM.  Its move to flash_mma.cuh is later work.

#include "flash_mma.cuh"

namespace {

constexpr int NT = 256;       // dkdv threads: 16 x 16, ty rows, tx columns
constexpr int DQ_BK = 32;     // dq: keys per k tile
constexpr int KV_BK = 64;     // dkdv: keys per block
constexpr int KV_BQ = 32;     // dkdv: q rows per step

// The schedule of flash_dq_kernel for each dtype: warps per block (16 q
// rows each) and the blocks per SM the registers must allow.  q's A
// fragments stay in registers for bf16 and are read from shared memory
// per k step for f32, as do's always are (QSource, SmemSource).
template <typename T>
struct DqCfg;
template <>
struct DqCfg<float> {
  static constexpr int NW = 8;
  static constexpr int MINB = 1;
};
template <>
struct DqCfg<__nv_bfloat16> {
  static constexpr int NW = 4;
  static constexpr int MINB = 2;
};

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back: where the reference casts a product's
// input to the input dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Offset of row r in a paired tile of width W (see the note above).
template <int W>
__device__ __forceinline__ int pair_row(int r) {
  return (r >> 1) * (2 * W + 1) + (r & 1) * (W + 1);
}

// Floats of a paired tile of `rows` (even) rows of width W.
__host__ __device__ constexpr int paired_size(int rows, int w) {
  return rows * w + rows / 2;
}

// Load rows [r0, r0 + rows) of one head into a (rows x D) f32 tile, paired
// or with rows D + 1 floats apart.  Rows past seq_len and columns past d
// are zero-filled.
template <typename T, int D, bool PAIRED>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int rows, int s, int d) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NT) {
    const int r = idx / D, c = idx - (idx / D) * D;
    float x = 0.f;
    if (r0 + r < s && c < d) x = to_f(src[(long long)(r0 + r) * row_stride + c]);
    dst[(PAIRED ? pair_row<D>(r) : r * (D + 1)) + c] = x;
  }
}

// Shared memory of one dq block, in elements: two ring stages, each a k
// and a v tile, then do, then q unless q passes through a stage before
// the loop.
template <typename T, int D>
constexpr int dq_smem_elems() {
  using C = DqCfg<T>;
  constexpr int LD = flash_mma::tile_ld<T, D>();
  return 4 * DQ_BK * LD +
         (flash_mma::q_in_regs<T>() ? 1 : 2) * 16 * C::NW * LD;
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * DqCfg<T>::NW, DqCfg<T>::MINB)
    flash_dq_kernel(Args a) {
  using namespace flash_mma;
  using C = DqCfg<T>;
  constexpr int NT = 32 * C::NW;  // threads
  constexpr int BQ = 16 * C::NW;  // q rows per block
  constexpr int LD = tile_ld<T, D>();
  constexpr int TILE = DQ_BK * LD;  // elements of one k or v tile
  constexpr int SS = 2 * TILE;      // one ring stage
  constexpr int NJ = DQ_BK / 8;     // score n8 tiles of a warp
  constexpr int NO = D / 8;         // dq n8 tiles of a warp
  constexpr bool F32 = std::is_same_v<T, float>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage st: k at st SS, v at st SS + TILE; then do; then q (or q in
  // stage 1)
  T* const ring = reinterpret_cast<T*>(smem_raw);
  T* const sdo = ring + 2 * SS;
  constexpr bool Q_REGS = q_in_regs<T>();
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
  const int nkt = (k_end + DQ_BK - 1) / DQ_BK;
  auto load_kv = [&](T* st, int k0) {
    flash_mma::load_tile<T, DQ_BK, D, NT>(st, k, a.ks1, k0, a.s, a.d, kvec);
    flash_mma::load_tile<T, DQ_BK, D, NT>(st + TILE, v, a.vs1, k0, a.s, a.d,
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
    const int k0 = kt * DQ_BK;
    T* const st = ring + (kt & 1) * SS;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; tile kt - 1 (and q) consumed
    if (kt + 1 < nkt) {
      load_kv(ring + ((kt + 1) & 1) * SS, k0 + DQ_BK);
      cp_async_commit();
    }

    // s = q . k^T and dp = do . v^T for this warp's 16 rows
    float sc[NJ][4] = {}, dp[NJ][4] = {};
    if constexpr (F32) {
      mma_abt3<D, DQ_BK>(sc, qa, RawB{st});
      mma_abt3<D, DQ_BK>(dp, doa, RawB{st + TILE});
    } else {
      mma_abt_bf16<D, DQ_BK>(sc, qa, st);
      mma_abt_bf16<D, DQ_BK>(dp, doa, st + TILE);
    }

    // ds = p * (dp - dd), p = exp(s * scale - lse) in log2 units
    const bool masked =
        k0 + DQ_BK > a.s || (a.causal && k0 + DQ_BK - 1 > q0);
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
      mma_pb3<D, DQ_BK>(acc, sc, RawB{st});
    else
      mma_pb_bf16<D, DQ_BK>(acc, sc, st);
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

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2) flash_dkdv_kernel(Args a) {
  constexpr int QS = D + 1;        // padded rows of the q/do tiles
  constexpr int RI = KV_BK / 16;   // keys per thread
  constexpr int CJ = KV_BQ / 16;   // q rows per thread
  constexpr int DJ = D / 16;       // dk/dv columns per thread
  extern __shared__ float smem[];
  float* sk = smem;                              // KV_BK x D, paired
  float* sv = sk + paired_size(KV_BK, D);        // KV_BK x D, paired
  float* sq = sv + paired_size(KV_BK, D);        // KV_BQ x QS
  float* sdo = sq + KV_BQ * QS;                  // KV_BQ x QS
  float* sp = sdo + KV_BQ * QS;                  // KV_BK x KV_BQ, paired
  float* sds = sp + paired_size(KV_BK, KV_BQ);   // KV_BK x KV_BQ, paired

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * KV_BK, hh = blockIdx.y, bb = blockIdx.z;
  const T* q = static_cast<const T*>(a.q) + bb * a.qs0 + hh * a.qs2;
  const T* k = static_cast<const T*>(a.k) + bb * a.ks0 + hh * a.ks2;
  const T* v = static_cast<const T*>(a.v) + bb * a.vs0 + hh * a.vs2;
  const T* dout = static_cast<const T*>(a.dout) + bb * a.ds0 + hh * a.ds2;
  const long long row0 = ((long long)bb * a.h + hh) * a.s;

  load_tile<T, D, true>(sk, k, a.ks1, k0, KV_BK, a.s, a.d);
  load_tile<T, D, true>(sv, v, a.vs1, k0, KV_BK, a.s, a.d);

  float dk[RI][DJ], dv[RI][DJ];
  int koff[RI], poff[RI];  // this thread's keys in the paired tiles
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    koff[i] = pair_row<D>(ty + 16 * i);
    poff[i] = pair_row<KV_BQ>(ty + 16 * i);
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  }

  // causal: q rows below k0 see none of this block's keys
  for (int q0 = a.causal ? k0 : 0; q0 < a.s; q0 += KV_BQ) {
    __syncthreads();  // the previous tile's q/do/p/ds are consumed
    load_tile<T, D, false>(sq, q, a.qs1, q0, KV_BQ, a.s, a.d);
    load_tile<T, D, false>(sdo, dout, a.ds1, q0, KV_BQ, a.s, a.d);
    __syncthreads();

    // s^T = k . q^T and dp^T = v . do^T for this thread's keys and rows
    float sc[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qc[CJ], oc[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        qc[j] = sq[(tx + 16 * j) * QS + c];
        oc[j] = sdo[(tx + 16 * j) * QS + c];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float kc = sk[koff[i] + c];
        const float vc = sv[koff[i] + c];
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          sc[i][j] = fmaf(kc, qc[j], sc[i][j]);
          dp[i][j] = fmaf(vc, oc[j], dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int row = q0 + tx + 16 * j;
      // rows past seq_len: lse 1e30 gives p = 0, so they add nothing
      const float lse = row < a.s ? a.lse[row0 + row] : 1e30f;
      const float dd = row < a.s ? a.dd[row0 + row] : 0.f;
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int col = k0 + ty + 16 * i;
        const bool live = col < a.s && (!a.causal || row >= col);
        const float p = expf((live ? sc[i][j] * a.scale : -1e30f) - lse);
        sp[poff[i] + tx + 16 * j] = round_to<T>(p);
        sds[poff[i] + tx + 16 * j] = round_to<T>(p * (dp[i][j] - dd));
      }
    }
    __syncthreads();  // p and ds tiles complete

    // dv += p^T . do and dk += ds^T . q
#pragma unroll 2
    for (int qq = 0; qq < KV_BQ; ++qq) {
      float orow[DJ], qrow[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        orow[j] = sdo[qq * QS + tx + 16 * j];
        qrow[j] = sq[qq * QS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = sp[poff[i] + qq];
        const float g = sds[poff[i] + qq];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv[i][j] = fmaf(p, orow[j], dv[i][j]);
          dk[i][j] = fmaf(g, qrow[j], dk[i][j]);
        }
      }
    }
  }

  T* gk = static_cast<T*>(a.g0);
  T* gv = static_cast<T*>(a.g1);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= a.s) continue;
    const long long off = (((long long)bb * a.s + row) * a.h + hh) * a.d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < a.d) {
        gk[off + col] = from_f<T>(dk[i][j] * a.scale);
        gv[off + col] = from_f<T>(dv[i][j]);
      }
    }
  }
}

template <typename T, int D>
int launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(T) * dq_smem_elems<T, D>();
  const cudaError_t err = flash_mma::allow_smem(flash_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int bq = 16 * DqCfg<T>::NW;
  const int grid = (a.s + bq - 1) / bq * a.b * a.h;
  flash_dq_kernel<T, D><<<grid, 32 * DqCfg<T>::NW, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * paired_size(KV_BK, D) +
                                               2 * KV_BQ * (D + 1) +
                                               2 * paired_size(KV_BK, KV_BQ));
  const cudaError_t err =
      flash_mma::allow_smem(flash_dkdv_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.s + KV_BK - 1) / KV_BK, a.h, a.b);
  flash_dkdv_kernel<T, D><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, bool dkdv, cudaStream_t st) {
  if (a.d <= 16) return dkdv ? launch_dkdv<T, 16>(a, st) : launch_dq<T, 16>(a, st);
  if (a.d <= 32) return dkdv ? launch_dkdv<T, 32>(a, st) : launch_dq<T, 32>(a, st);
  if (a.d <= 64) return dkdv ? launch_dkdv<T, 64>(a, st) : launch_dq<T, 64>(a, st);
  return dkdv ? launch_dkdv<T, 128>(a, st) : launch_dq<T, 128>(a, st);
}

int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* dd, void* g0, void* g1, int b, int s,
        int h, int d, long long qs0, long long qs1, long long qs2,
        long long ks0, long long ks1, long long ks2, long long vs0,
        long long vs1, long long vs2, long long ds0, long long ds1,
        long long ds2, int is_bf16, int causal, float scale, void* stream,
        bool dkdv) {
  if (d < 1 || d > 128) return (int)cudaErrorInvalidValue;
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
// caller has checked devices, dtypes, shapes, 1 <= d <= 128, unit last
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
