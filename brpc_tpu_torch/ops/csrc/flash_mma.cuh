// Tensor-core building blocks shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu) for Hopper (sm_90a): warp-level MMA on f32
// inputs as 3xTF32 and on bf16 inputs, ldmatrix fragment loads, and a
// cp.async tile loader that feeds a two-stage shared-memory ring.
//
// Fragment layouts (PTX ISA, "mma.m16n8k8" / "mma.m16n8k16"): in a warp,
// lane l is (g, t) = (l / 4, l % 4).  The f32 accumulator C of one 16 x 8
// tile holds, per lane, c0 = (row g, col 2t), c1 = (g, 2t + 1),
// c2 = (g + 8, 2t), c3 = (g + 8, 2t + 1).
// - tf32 m16n8k8: A (16 x 8) a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
//   a3 = (g + 8, t + 4); B (8 x 8, k x n) b0 = (k t, n g), b1 = (k t + 4, g).
// - bf16 m16n8k16: each register holds two neighbours along k.  A (16 x 16)
//   a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..), a2 = (g, 2t + 8..), a3 =
//   (g + 8, 2t + 8..); B (16 x 8) b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., g).
//   So C of two neighbouring n8 tiles is, packed to bf16, A of one k16 step.
//
// 3xTF32.  A tf32 product keeps 11 significant bits of each input, about
// three decimal digits, which would miss the kernels' 1e-4 f32 tolerance.
// Each f32 input x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi)
// (x - hi is exact in f32), and a product is lo_a * hi_b + hi_a * lo_b +
// hi_a * hi_b, three tf32 MMAs into f32 accumulators: only lo_a * lo_b,
// about 2^-22 of the product, is dropped, which keeps the error near f32's.
// Single-pass TF32 is not used anywhere.
//
// Why mma.sync and not wgmma: wgmma on tf32 takes both operands K-major
// from shared memory.  The P.V product (forward) and ds.K (dq) read V and K
// along the key axis, so wgmma would need transposed copies of those tiles
// and a hi/lo copy of every tile.  mma.sync fragments are loaded by each
// lane from one padded row-major tile in either orientation, and the split
// happens in registers (or once per tile, in place, where shared memory
// has room for the lo halves: SplitB).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash_mma {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- tf32 ------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The same split in three instructions instead of seven.  cvt.rna.tf32
// compiles to an add, a mask and an Inf/NaN test with a select; here hi =
// rna_tf32(x) by the add and the mask alone (equal for finite x; a NaN or
// Inf still reaches the product, through lo = x - hi), and lo goes to the
// MMA unrounded: the tensor cores read the top 19 bits of a tf32 operand,
// so lo is truncated instead of rounded, which loses at most 2^-21 of x
// (beside the 2^-22 of lo_a * lo_b that 3xTF32 drops anyway).
__device__ __forceinline__ void split_tf32_fast(float x, uint32_t& hi,
                                                uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <bool FAST>
__device__ __forceinline__ void split_a(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (FAST)
    split_tf32_fast(x, hi, lo);
  else
    split_tf32(x, hi, lo);
}

// A fragment split once, reused across the n tiles of one k step.
struct SplitA {
  uint32_t hi[4], lo[4];
  template <bool FAST = false>
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split_a<FAST>(a0, hi[0], lo[0]);
    split_a<FAST>(a1, hi[1], lo[1]);
    split_a<FAST>(a2, hi[2], lo[2]);
    split_a<FAST>(a3, hi[3], lo[3]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- bf16 ------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i of each lane holds its share of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// ---- cp.async tile ring ---------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// One 4-byte word, for rows whose values are single floats (lse, dd).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Row stride, in elements, of a shared tile of width D: 16 bytes of pad
// keep every row 16-byte aligned for cp.async and spread the rows over
// the banks (f32: D + 4, so row r starts at bank 4r mod 32; bf16: D + 8,
// so ldmatrix's eight 16-byte rows hit eight distinct bank groups).
template <typename T, int D>
__host__ __device__ constexpr int tile_ld() {
  return D + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// Whether rows of one head can move in 16-byte pieces: base and row
// stride 16-byte aligned, and d a whole number of pieces.
template <typename T>
__device__ __forceinline__ bool can_vec(const T* base, long long stride,
                                        int d) {
  constexpr int EPC = 16 / sizeof(T);
  return (reinterpret_cast<uintptr_t>(base) % 16 == 0) &&
         ((stride * (long long)sizeof(T)) % 16 == 0) && (d % EPC == 0);
}

// Rows [r0, r0 + ROWS) of one head into a (ROWS x tile_ld) shared tile,
// columns past d and rows past s as zeros.  With `vec` the rows move as
// 16-byte cp.async copies that land by the next cp_async_wait_all; else
// each element is loaded and stored by the thread (rows whose base or
// stride is not 16-byte aligned).  Either way a __syncthreads must come
// before another thread reads the tile.
//
// The block has NT threads, and each takes a fixed number of pieces: with
// a count that depends on threadIdx (i = threadIdx.x; i < n; i += NT) ptxas
// keeps every piece's offsets live across the loop that calls it.
//
// With `lo` (f32 only) the tile is kept split for 3xTF32: `dst` gets the
// tf32 hi parts and `lo` the lo parts.  The per-element path splits as it
// stores; after a vec load each thread splits the pieces it copied itself
// (split_own), between cp_async_wait_all and the __syncthreads.
template <typename T, int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int r0, int s,
                                          int d, bool vec, T* lo = nullptr) {
  constexpr int LD = tile_ld<T, D>();
  if (vec) {
    constexpr int EPC = 16 / sizeof(T);
    constexpr int CPR = D / EPC;  // pieces per row
    constexpr int N = ROWS * CPR;
#pragma unroll
    for (int m = 0; m < (N + NT - 1) / NT; ++m) {
      const int i = threadIdx.x + m * NT;
      if (N % NT != 0 && i >= N) break;
      const int r = i / CPR, c = (i % CPR) * EPC;
      T* dp = dst + r * LD + c;
      if (r0 + r < s && c < d)
        cp_async16(dp, src + (long long)(r0 + r) * stride + c);
      else
        *reinterpret_cast<uint4*>(dp) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += NT) {
      const int r = i / D, c = i % D;
      const T x = (r0 + r < s && c < d) ? src[(long long)(r0 + r) * stride + c]
                                        : zero<T>();
      if constexpr (std::is_same_v<T, float>) {
        if (lo) {
          uint32_t hi_bits, lo_bits;
          split_tf32(x, hi_bits, lo_bits);
          dst[r * LD + c] = __uint_as_float(hi_bits);
          lo[r * LD + c] = __uint_as_float(lo_bits);
          continue;
        }
      }
      dst[r * LD + c] = x;
    }
  }
}

// After a vec load_tile with `lo`: split the pieces this thread copied
// (the same pieces, so no other thread's copy needs to have landed).
template <int ROWS, int D, int NT>
__device__ __forceinline__ void split_own(float* hi, float* lo, bool vec) {
  if (!vec) return;
  constexpr int LD = tile_ld<float, D>();
  constexpr int CPR = D / 4;
  constexpr int N = ROWS * CPR;
#pragma unroll
  for (int m = 0; m < (N + NT - 1) / NT; ++m) {
    const int i = threadIdx.x + m * NT;
    if (N % NT != 0 && i >= N) break;
    const int off = (i / CPR) * LD + (i % CPR) * 4;
    float4 x = *reinterpret_cast<float4*>(hi + off);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// Dynamic shared memory above 48 KB, and the largest shared-memory
// carveout, so that two or more blocks fit on an SM.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// ---- warp tile products ---------------------------------------------
//
// A warp owns 16 rows.  Shared tiles are row-major with stride tile_ld.
//
// f32 (3xTF32).  The A operand is read from its shared tile one k step
// at a time (SmemA) and split once per step for every n tile of it: held
// in registers for the whole k loop, beside the f32 accumulators, it
// makes ptxas spill.  The B operand comes from a raw f32 tile, split per
// use (RawB), or from a tile already split by load_tile (SplitB), which
// saves each warp the split of every B value it reads.

template <int D, bool FAST = false>
struct SmemA {
  const float* r0;  // row g of the warp's 16, column t
  __device__ __forceinline__ void init(const float* tile, int row0) {
    constexpr int LD = tile_ld<float, D>();
    r0 = tile + (row0 + ((threadIdx.x & 31) >> 2)) * LD + (threadIdx.x & 3);
  }
  __device__ __forceinline__ SplitA at(int ks) const {
    constexpr int LD = tile_ld<float, D>();
    SplitA s;
    s.set<FAST>(r0[ks * 8], r0[ks * 8 + 8 * LD], r0[ks * 8 + 4],
                r0[ks * 8 + 8 * LD + 4]);
    return s;
  }
};

struct RawB {
  const float* p;
  __device__ __forceinline__ void get(int o0, int o1, uint32_t (&h)[2],
                                      uint32_t (&l)[2]) const {
    split_tf32(p[o0], h[0], l[0]);
    split_tf32(p[o1], h[1], l[1]);
  }
};

struct SplitB {
  const float* hi;
  const float* lo;
  __device__ __forceinline__ void get(int o0, int o1, uint32_t (&h)[2],
                                      uint32_t (&l)[2]) const {
    h[0] = __float_as_uint(hi[o0]);
    h[1] = __float_as_uint(hi[o1]);
    l[0] = __float_as_uint(lo[o0]);
    l[1] = __float_as_uint(lo[o1]);
  }
};

// c (16 x BK) += A (16 x D) . B^T, B a shared (BK x D) tile (rows are the
// n index): the score products q.k^T and do.v^T.  The two small terms of
// 3xTF32 sum into a second accumulator, added at the end, so that each
// accumulator's chain of dependent MMAs is shorter (BK / 8 chains only).
template <int D, int BK, class A, class B>
__device__ __forceinline__ void mma_abt3(float (&c)[BK / 8][4], const A& a_src,
                                         const B& b) {
  constexpr int LD = tile_ld<float, D>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float cl[BK / 8][4] = {};
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const SplitA a = a_src.at(ks);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      uint32_t h[2], l[2];
      const int o = (j * 8 + g) * LD + ks * 8 + t;
      b.get(o, o + 4, h, l);
      mma_tf32(cl[j], a.lo, h[0], h[1]);
      mma_tf32(cl[j], a.hi, l[0], l[1]);
      mma_tf32(c[j], a.hi, h[0], h[1]);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] += cl[j][i];
}

// o (16 x D) += P . B, P (16 x BK) in accumulator layout in registers, B
// a shared (BK x D) tile (rows are the k index): p.v and ds.k.  B may be
// D columns of a wider tile, of width LDD (its row stride tile_ld<LDD>).
//
// C's layout is not tf32 A's.  Instead of moving values between lanes the
// k index is permuted: logical k t of a k8 step is key 2t and t + 4 is key
// 2t + 1, in A (c0, c2 -> a0, a1; c1, c3 -> a2, a3) and in B (rows 2t and
// 2t + 1 of the tile).  A k-sum does not depend on its order.
template <int D, int BK, bool FAST = false, int LDD = D, class B>
__device__ __forceinline__ void mma_pb3(float (&o)[D / 8][4],
                                        const float (&p)[BK / 8][4],
                                        const B& b) {
  constexpr int LD = tile_ld<float, LDD>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    SplitA a;
    a.set<FAST>(p[kk][0], p[kk][2], p[kk][1], p[kk][3]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t h[2], l[2];
      const int off = (kk * 8 + 2 * t) * LD + n * 8 + g;
      b.get(off, off + LD, h, l);
      mma_tf32(o[n], a.lo, h[0], h[1]);
      mma_tf32(o[n], a.hi, l[0], l[1]);
      mma_tf32(o[n], a.hi, h[0], h[1]);
    }
  }
}

// bf16.  A fragments by ldmatrix, from registers (BfA, the whole k loop)
// or a shared tile per k step; B by ldmatrix (.trans where the tile's rows
// are the k index); P packed to bf16 straight from the accumulators.

template <int D>
struct BfA {
  uint32_t a[D / 16][4];
  __device__ __forceinline__ void init(const __nv_bfloat16* tile, int row0) {
    constexpr int LD = tile_ld<__nv_bfloat16, D>();
    const int l = threadIdx.x & 31;
    const __nv_bfloat16* p = tile + (row0 + (l & 15)) * LD + (l >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) ldsm_x4(a[ks], p + ks * 16);
  }
  __device__ __forceinline__ void at(int ks, uint32_t (&r)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = a[ks][i];
  }
};

template <int D>
struct BfSmemA {
  const __nv_bfloat16* p;
  __device__ __forceinline__ void init(const __nv_bfloat16* tile, int row0) {
    constexpr int LD = tile_ld<__nv_bfloat16, D>();
    const int l = threadIdx.x & 31;
    p = tile + (row0 + (l & 15)) * LD + (l >> 4) * 8;
  }
  __device__ __forceinline__ void at(int ks, uint32_t (&r)[4]) const {
    ldsm_x4(r, p + ks * 16);
  }
};

// The A source of q: f32 from shared memory per k step, bf16 in
// registers for the whole k loop up to d = 128 (at d = 256 its 64
// registers beside the 128 of a 16 x 256 f32 accumulator would spill, so
// it is read from shared memory per k step too).  Of any other A operand
// (do): shared memory per k step.
template <typename T, int D>
__host__ __device__ constexpr bool q_in_regs() {
  return !std::is_same_v<T, float> && D <= 128;
}
template <typename T, int D>
using SmemSource =
    std::conditional_t<std::is_same_v<T, float>, SmemA<D>, BfSmemA<D>>;
template <typename T, int D>
using QSource =
    std::conditional_t<q_in_regs<T, D>(), BfA<D>, SmemSource<T, D>>;

// c (16 x BK) += A (16 x D) . B^T, B a shared (BK x D) tile.
template <int D, int BK, class A>
__device__ __forceinline__ void mma_abt_bf16(float (&c)[BK / 8][4],
                                             const A& a_src,
                                             const __nv_bfloat16* sb) {
  constexpr int LD = tile_ld<__nv_bfloat16, D>();
  const int l = threadIdx.x & 31;
  const __nv_bfloat16* pb =
      sb + ((l & 7) + ((l >> 4) << 3)) * LD + ((l >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    a_src.at(ks, a);
#pragma unroll
    for (int jp = 0; jp < BK / 16; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, pb + jp * 16 * LD + ks * 16);
      mma_bf16(c[2 * jp], a, b[0], b[1]);
      mma_bf16(c[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// o (16 x D) += P . B, P rounded to bf16 (two n8 accumulator tiles are
// one k16 A fragment), B a shared (BK x D) tile read with ldmatrix.trans;
// as in mma_pb3, B may be D columns of a tile of width LDD.
template <int D, int BK, int LDD = D>
__device__ __forceinline__ void mma_pb_bf16(float (&o)[D / 8][4],
                                            const float (&p)[BK / 8][4],
                                            const __nv_bfloat16* sb) {
  constexpr int LD = tile_ld<__nv_bfloat16, LDD>();
  const int l = threadIdx.x & 31;
  const __nv_bfloat16* q =
      sb + ((l & 7) + ((l >> 3) & 1) * 8) * LD + (l >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, q + kk * 16 * LD + np * 16);
      mma_bf16(o[2 * np], a, b[0], b[1]);
      mma_bf16(o[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Reductions over the four lanes (one quad) that share a row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Two neighbouring output columns of one row, of which `left` (possibly
// fewer than 2, or none) lie inside the head dim; one store when both do
// and the address allows it.
__device__ __forceinline__ void store2(float* dst, float x0, float x1,
                                       int left) {
  if (left >= 2 && reinterpret_cast<uintptr_t>(dst) % 8 == 0) {
    *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
  } else {
    if (left >= 1) dst[0] = x0;
    if (left >= 2) dst[1] = x1;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x0, float x1,
                                       int left) {
  if (left >= 2 && reinterpret_cast<uintptr_t>(dst) % 4 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (left >= 1) dst[0] = __float2bfloat16_rn(x0);
    if (left >= 2) dst[1] = __float2bfloat16_rn(x1);
  }
}

}  // namespace flash_mma
