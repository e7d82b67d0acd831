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
// scale with ds rounded to q's dtype.  Sums are f32; bf16 inputs are
// widened on load, so each product term is exact.
//
// Layout: q/k/v/do are (b, s, h, d) read in place through their strides
// (the last dimension contiguous); lse and dd are f32 (b, h, s) contiguous;
// dq/dk/dv are written (b, s, h, d) contiguous in the input dtype.
//
// The Pallas grid carries its accumulators across a sequential grid axis.
// Here each output tile has one owner block that loops internally, so there
// are no atomics and the result is deterministic:
// - flash_dq_kernel: one block per (64-row q tile, head, batch), looping
//   over 32-key k tiles (k tile <= q tile when causal); dq stays in
//   registers and is written once.
// - flash_dkdv_kernel: one block per (64-key k tile, head, batch), looping
//   over 32-row q tiles (q tile >= k tile when causal); dk and dv stay in
//   registers and are written once.
//
// Shared memory at d = 128 in f32 is the constraint.  A warp holds two
// rows (ty) of 16 columns (tx).  Tiles that 16 lanes read down one column
// at once get a one-float row pad, which spreads the rows over 16 banks.
// Tiles that a warp reads two rows at a time, the same column in each, need
// only the two rows in different banks: they are "paired" (`pair_row`),
// rows 2m and 2m + 1 of width W sitting W + 1 floats apart in a block of
// 2W + 1, half a float of padding per row.  dq: q and do 2 x (64 x 128 +
// 32), k and v 2 x 32 x 129, ds 64 x 32 + 32 floats = 107,136 B.  dkdv: k
// and v 2 x (64 x 128 + 32), q and do 2 x 32 x 129, p and ds
// 2 x (64 x 32 + 32) floats = 115,456 B.  Both take dynamic shared memory
// above 48 KB, and two blocks fit on an SM (228 KB, 1 KB reserved per
// block).
//
// What bounds it: at the training shape (4, 2048, 16, 128) causal, dq does
// 6 and dkdv 8 FLOPs per head dim per live (q, k) pair, 1.0e11 and 1.4e11
// FLOPs over 337 and 404 MB of f32 inputs and outputs: bound by operations
// at the card's peak rates (1.54 and 2.05 ms at 67 TFLOP/s f32).  This
// first version computes every product with f32 FMAs from shared-memory
// tiles: f32 inputs stay exact (no TF32) and bf16 inputs get the same f32
// sums as the reference, without the tensor cores.  On an H100 80GB HBM3
// at 700 W it takes 7.0 (dq) and 7.6 ms (dkdv) there, f32 or bf16
// (chip_smoke.py phase 4b).  wgmma, TMA and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;       // threads: 16 x 16, ty picks rows, tx columns
constexpr int DQ_BQ = 64;     // dq: q rows per block
constexpr int DQ_BK = 32;     // dq: keys per step
constexpr int KV_BK = 64;     // dkdv: keys per block
constexpr int KV_BQ = 32;     // dkdv: q rows per step

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

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2) flash_dq_kernel(Args a) {
  constexpr int KS = D + 1;        // padded rows of the k/v tiles
  constexpr int RI = DQ_BQ / 16;   // q rows per thread
  constexpr int CJ = DQ_BK / 16;   // keys per thread
  constexpr int DJ = D / 16;       // dq columns per thread
  extern __shared__ float smem[];
  float* sq = smem;                              // DQ_BQ x D, paired
  float* sdo = sq + paired_size(DQ_BQ, D);       // DQ_BQ x D, paired
  float* sk = sdo + paired_size(DQ_BQ, D);       // DQ_BK x KS
  float* sv = sk + DQ_BK * KS;                   // DQ_BK x KS
  float* sds = sv + DQ_BK * KS;                  // DQ_BQ x DQ_BK, paired

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * DQ_BQ, hh = blockIdx.y, bb = blockIdx.z;
  const T* q = static_cast<const T*>(a.q) + bb * a.qs0 + hh * a.qs2;
  const T* k = static_cast<const T*>(a.k) + bb * a.ks0 + hh * a.ks2;
  const T* v = static_cast<const T*>(a.v) + bb * a.vs0 + hh * a.vs2;
  const T* dout = static_cast<const T*>(a.dout) + bb * a.ds0 + hh * a.ds2;
  const long long row0 = ((long long)bb * a.h + hh) * a.s;

  load_tile<T, D, true>(sq, q, a.qs1, q0, DQ_BQ, a.s, a.d);
  load_tile<T, D, true>(sdo, dout, a.ds1, q0, DQ_BQ, a.s, a.d);

  // rows past seq_len: lse 1e30 gives p = 0, so they add nothing
  float lse[RI], dd[RI], acc[RI][DJ];
  int qoff[RI], poff[RI];  // this thread's rows in the paired tiles
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    qoff[i] = pair_row<D>(ty + 16 * i);
    poff[i] = pair_row<DQ_BK>(ty + 16 * i);
    lse[i] = row < a.s ? a.lse[row0 + row] : 1e30f;
    dd[i] = row < a.s ? a.dd[row0 + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int k_end = a.causal ? min(q0 + DQ_BQ, a.s) : a.s;
  const int nkt = (k_end + DQ_BK - 1) / DQ_BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * DQ_BK;
    __syncthreads();  // the previous tile's k/v/ds are consumed
    load_tile<T, D, false>(sk, k, a.ks1, k0, DQ_BK, a.s, a.d);
    load_tile<T, D, false>(sv, v, a.vs1, k0, DQ_BK, a.s, a.d);
    __syncthreads();

    // s = q . k^T and dp = do . v^T for this thread's rows and keys
    float sc[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float kc[CJ], vc[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        kc[j] = sk[(tx + 16 * j) * KS + c];
        vc[j] = sv[(tx + 16 * j) * KS + c];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float qc = sq[qoff[i] + c];
        const float oc = sdo[qoff[i] + c];
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          sc[i][j] = fmaf(qc, kc[j], sc[i][j]);
          dp[i][j] = fmaf(oc, vc[j], dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = col < a.s && (!a.causal || row >= col);
        const float p = expf((live ? sc[i][j] * a.scale : -1e30f) - lse[i]);
        sds[poff[i] + tx + 16 * j] = round_to<T>(p * (dp[i][j] - dd[i]));
      }
    }
    __syncthreads();  // ds tile complete

    // dq += ds . k
#pragma unroll 4
    for (int kk = 0; kk < DQ_BK; ++kk) {
      float kr[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kr[j] = sk[kk * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float g = sds[poff[i] + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(g, kr[j], acc[i][j]);
      }
    }
  }

  T* dq = static_cast<T*>(a.g0);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.s) continue;
    T* out = dq + (((long long)bb * a.s + row) * a.h + hh) * a.d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < a.d) out[col] = from_f<T>(acc[i][j] * a.scale);
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

// Dynamic shared memory above 48 KB, and the largest shared-memory
// carveout, so that two blocks fit on an SM.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, int D>
int launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * paired_size(DQ_BQ, D) +
                                               2 * DQ_BK * (D + 1) +
                                               paired_size(DQ_BQ, DQ_BK));
  const cudaError_t err = allow_smem(flash_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.s + DQ_BQ - 1) / DQ_BQ, a.h, a.b);
  flash_dq_kernel<T, D><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * paired_size(KV_BK, D) +
                                               2 * KV_BQ * (D + 1) +
                                               2 * paired_size(KV_BK, KV_BQ));
  const cudaError_t err = allow_smem(flash_dkdv_kernel<T, D>, smem);
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
