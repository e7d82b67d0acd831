// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by brpc_tpu_torch/ops/flash_attention.py.
//
// Replaces the Pallas kernel `_fwd_kernel` (brpc_tpu/ops/flash_attention.py,
// launched from `_pallas_forward`).  Same arithmetic: blockwise online
// softmax with scale 1/sqrt(d); keys at or past seq_len, and q < k when
// causal, are masked to -1e30; p is rounded to v's dtype before p.v, with
// f32 accumulation; out = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)),
// or 1e30 for a dead row (l <= 0).
//
// Layout: q/k/v/out are (b, s, h, d) read and written in place through
// their strides (the last dimension must be contiguous), lse is f32
// (b, h, s) contiguous.  One thread block per (q tile, head, batch); the
// causal triangle is the k-tile loop bound, not an index grid.
//
// What bounds it: causal prefill at (1, 1024, 16, 128) is 2.1 GFLOP over
// 33 MB, so at the card's peak rates it is bound by operations.  This first
// version computes both products with f32 FMAs from shared-memory tiles
// (padded rows, no bank conflicts on the score product), which keeps f32
// inputs exact (no TF32) and gives bf16 inputs the same f32 accumulation as
// the reference; it does not use the tensor cores.  wgmma, TMA and
// pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per k tile
constexpr int NT = 256;  // threads: 16 x 16, ty picks rows, tx picks columns

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int b, s, h, d;
  long long qs0, qs1, qs2;  // element strides of dims b, s, h
  long long ks0, ks1, ks2;
  long long vs0, vs1, vs2;
  long long os0, os1, os2;
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

// Load rows [r0, r0 + rows) of one head into a (rows x DS) f32 tile,
// zero-filling rows past seq_len and columns past d.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int rows, int s, int d) {
  constexpr int DS = D + 1;
  for (int idx = threadIdx.x; idx < rows * D; idx += NT) {
    const int r = idx / D, c = idx - (idx / D) * D;
    float x = 0.f;
    if (r0 + r < s && c < d) x = to_f(src[(long long)(r0 + r) * row_stride + c]);
    dst[r * DS + c] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  constexpr int DS = D + 1;       // padded row stride of the q/k/v tiles
  constexpr int PS = BK + 1;      // padded row stride of the p tile
  constexpr int RI = BQ / 16;     // rows per thread
  constexpr int CJ = BK / 16;     // score columns per thread
  constexpr int DJ = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + BQ * DS;
  float* sv = sk + BK * DS;
  float* sp = sv + BK * DS;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, bb = blockIdx.z;
  const T* q = static_cast<const T*>(a.q) + bb * a.qs0 + hh * a.qs2;
  const T* k = static_cast<const T*>(a.k) + bb * a.ks0 + hh * a.ks2;
  const T* v = static_cast<const T*>(a.v) + bb * a.vs0 + hh * a.vs2;
  T* o = static_cast<T*>(a.o) + bb * a.os0 + hh * a.os2;

  load_tile<T, D>(sq, q, a.qs1, q0, BQ, a.s, a.d);

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int q_end = min(q0 + BQ, a.s);
  const int k_end = a.causal ? q_end : a.s;
  const int nkt = (k_end + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's k/v/p are consumed
    load_tile<T, D>(sk, k, a.ks1, k0, BK, a.s, a.d);
    load_tile<T, D>(sv, v, a.vs1, k0, BK, a.s, a.d);
    __syncthreads();

    float sc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float kc[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kc[j] = sk[(tx + 16 * j) * DS + c];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float qc = sq[(ty + 16 * i) * DS + c];
#pragma unroll
        for (int j = 0; j < CJ; ++j) sc[i][j] = fmaf(qc, kc[j], sc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = col < a.s && (!a.causal || row >= col);
        sc[i][j] = live ? sc[i][j] * a.scale : -1e30f;
        mx = fmaxf(mx, sc[i][j]);
      }
      // the 16 threads of one row are 16 lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps += p;
        // p rides the second product in the value dtype
        sp[(ty + 16 * i) * PS + tx + 16 * j] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // p tile complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vk[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vk[j] = sv[kk * DS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = sp[(ty + 16 * i) * PS + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vk[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.s) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < a.d) o[(long long)row * a.os1 + col] = from_f<T>(acc[i][j] / lc);
    }
    if (tx == 0)
      a.lse[((long long)bb * a.h + hh) * a.s + row] =
          l[i] <= 0.f ? 1e30f : m[i] + logf(lc);
  }
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.s + BQ - 1) / BQ, a.h, a.b);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Args& a, cudaStream_t stream) {
  if (a.d <= 16) return launch<T, 16>(a, stream);
  if (a.d <= 32) return launch<T, 32>(a, stream);
  if (a.d <= 64) return launch<T, 64>(a, stream);
  return launch<T, 128>(a, stream);
}

}  // namespace

// Returns a cudaError_t value: 0 on a launch that was accepted.  The caller
// has checked devices, dtypes, shapes, 1 <= d <= 128 and unit last strides.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int b, int s, int h, int d,
                         long long qs0, long long qs1, long long qs2,
                         long long ks0, long long ks1, long long ks2,
                         long long vs0, long long vs1, long long vs2,
                         long long os0, long long os1, long long os2,
                         int is_bf16, int causal, float scale, void* stream) {
  if (d < 1 || d > 128) return (int)cudaErrorInvalidValue;
  Args a{q,   k,   v,   o,   static_cast<float*>(lse),
         b,   s,   h,   d,   qs0,
         qs1, qs2, ks0, ks1, ks2,
         vs0, vs1, vs2, os0, os1,
         os2, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(a, st) : dispatch_d<float>(a, st);
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
