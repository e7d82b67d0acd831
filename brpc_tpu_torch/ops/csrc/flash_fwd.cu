// Flash-attention forward for Hopper (sm_90a) on the tensor cores, bound
// through a plain C interface (ctypes) by
// brpc_tpu_torch/ops/flash_attention.py.
//
// Replaces the Pallas kernel `_fwd_kernel` (brpc_tpu/ops/flash_attention.py,
// launched from `_pallas_forward`).  Same arithmetic: blockwise online
// softmax with scale 1/sqrt(d); keys at or past seq_len, and q < k when
// causal, are masked to -1e30; p is rounded to v's dtype before p.v, with
// f32 accumulation; out = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)),
// or 1e30 for a dead row (l <= 0).  The running max is kept in log2 units
// (scores scaled by log2(e), exp2), which is the same function.
//
// Layout: q/k/v/out are (b, s, h, d) read and written in place through
// their strides (the last dimension must be contiguous), lse is f32
// (b, h, s) contiguous.
//
// What bounds it: causal prefill at (1, 1024, 16, 128) is 4.30 GFLOP over
// 34 MB, and a training micro-batch (4, 2048, 16, 128) 68.7 GFLOP over
// 537 MB (live pairs only): bound by operations.  In f32, the paths'
// dtype, the f32 FMA bound is 0.064 / 1.026 ms at 67 TFLOP/s; on the
// tensor cores as 3xTF32 (three tf32 products per product, see
// flash_mma.cuh) it is 0.026 / 0.417 ms at 495 TFLOP/s.  bf16 runs at the
// bf16 tensor-core rate.
//
// Design (flash_mma.cuh holds the pieces):
// - A block owns a q tile of 16 rows per warp; a warp's 16 rows stay its
//   own for the whole k loop.  Scores q.k^T and p.v run on warp-level
//   MMA: f32 as 3xTF32 on m16n8k8, bf16 on m16n8k16 with ldmatrix
//   (ldmatrix.trans for v).
// - Softmax in registers: row max and sum from the accumulator fragments
//   with quad shuffles; P feeds p.v as the A operand without shared memory
//   (bf16: two n8 accumulator tiles are one k16 A fragment; f32: the key
//   order inside each k8 step is permuted instead, no shuffles).
// - 32-key k/v tiles move with 16-byte cp.async into a two-stage ring, so
//   tile t + 1 loads while tile t computes, one __syncthreads per tile; a
//   per-element path serves rows whose base or stride is not 16-byte
//   aligned.
// - Causal: only the tiles that cross the diagonal (and a ragged last
//   tile) are masked; q tiles are launched heaviest first, for every head
//   and batch before the next lighter tile.
// - Schedules (launch() picks by grid size; chosen from timings on the
//   H100): f32 Wide, 8 warps and 128 rows, the k/v tiles split to tf32
//   hi/lo once in shared memory so no warp splits a B value itself: 198 KB,
//   one block per SM, for grids of four waves or more (a training
//   micro-batch); f32 KSplit, 64 rows and two groups of 4 warps that take
//   even and odd k tiles and merge their softmax states at the end: 165 KB,
//   one block per SM, for grids of two waves or less (a 1024-token
//   prefill), where the heaviest q tiles set the time; f32 Narrow, 4 warps
//   and 64 rows, 99 KB, two blocks per SM, between them.  f32 reads q from
//   shared memory per k step (in registers with the accumulators it
//   spills).  bf16: 4 warps, q's fragments in registers.
// - Head dims 1 <= d <= 128 are zero-padded to 16, 32, 64 or 128, and
//   129 <= d <= 256 to 256, as the Pallas kernel pads d to 128s.  At
//   d = 256 a 32-key k/v tile is 33 KB in f32, so f32 takes Narrow alone:
//   4 warps and 64 rows, the ring unsplit beside the q tile, 199,680 B,
//   one block per SM (Wide's split ring would need 399,360 B and KSplit's
//   332,800); its output accumulator is 128 registers a thread (4 warps
//   at two blocks per SM or one allow a thread 255 alike).  bf16 reads q
//   from shared memory per k step there as f32 does (q_in_regs): 101,376
//   B, two blocks per SM.

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int BK = 32;  // keys per k tile

// Schedules: warps per block, warp groups that take turns over the k
// tiles (KSPLIT; each group holds all the block's q rows, 16 per warp, and
// the groups' softmax states merge at the end), whether the k/v tiles are
// kept split into tf32 hi/lo (f32 only), and the blocks per SM that the
// registers must allow.  f32 picks one by grid size (launch()).  q's A
// fragments stay in registers for bf16 and are read from shared memory
// per k step for f32 (QSource, flash_mma.cuh).
struct Wide {  // f32: 128 q rows, 8 warps share each split k/v tile
  static constexpr int NW = 8;
  static constexpr int KSPLIT = 1;
  static constexpr bool SPLIT = true;
  static constexpr int MINB = 1;
};
struct Narrow {  // f32: 64 q rows, two blocks per SM
  static constexpr int NW = 4;
  static constexpr int KSPLIT = 1;
  static constexpr bool SPLIT = false;
  static constexpr int MINB = 2;
};
struct KSplit {  // f32: 64 q rows, two groups of 4 warps, even/odd k tiles
  static constexpr int NW = 8;
  static constexpr int KSPLIT = 2;
  static constexpr bool SPLIT = false;
  static constexpr int MINB = 1;
};
struct Bf16 {  // bf16: 64 q rows
  static constexpr int NW = 4;
  static constexpr int KSPLIT = 1;
  static constexpr bool SPLIT = false;
  static constexpr int MINB = 2;
};

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

// Shared memory of one block, in elements: two ring stages, each a k and
// a v tile (and their lo halves when split) per warp group, then the q
// tile unless it passes through a stage before the loop.
template <typename T, int D, class C>
constexpr int smem_elems() {
  constexpr int stage = C::KSPLIT * (C::SPLIT ? 4 : 2) * BK * tile_ld<T, D>();
  constexpr int bq = 16 * C::NW / C::KSPLIT;
  return 2 * stage + (q_in_regs<T, D>() ? 0 : bq * tile_ld<T, D>());
}

template <typename T, int D, class C>
__global__ void __launch_bounds__(32 * C::NW, C::MINB)
    flash_fwd_kernel(Args a) {
  constexpr int NT = 32 * C::NW;       // threads
  constexpr int G = C::KSPLIT;         // warp groups
  constexpr int BQ = 16 * C::NW / G;   // query rows per block
  constexpr int LD = tile_ld<T, D>();
  constexpr int TILE = BK * LD;        // elements of one k or v tile
  constexpr int TS = (C::SPLIT ? 4 : 2) * TILE;  // one group's k/v set
  constexpr int SS = G * TS;           // one ring stage
  constexpr int NJ = BK / 8;           // score n8 tiles of a warp
  constexpr int NO = D / 8;            // output n8 tiles of a warp
  constexpr bool F32 = std::is_same_v<T, float>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage st, group gi: k at st SS + gi TS, v at + TILE, their lo halves
  // at + 2 TILE and + 3 TILE when split
  T* const smem = reinterpret_cast<T*>(smem_raw);
  constexpr bool Q_REGS = q_in_regs<T, D>();
  static_assert(!Q_REGS || BQ * LD <= SS, "q tile must fit one stage");
  T* const sq = smem + (Q_REGS ? SS : 2 * SS);

  // q tiles heaviest first: the last q tile of every (head, batch) is
  // dispatched before any second-to-last one
  const int nq = (a.s + BQ - 1) / BQ, bh = a.b * a.h;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / bh) * BQ;
  const int hh = blockIdx.x % bh % a.h, bb = blockIdx.x % bh / a.h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int grp = warp / (C::NW / G), wr = warp % (C::NW / G);
  const T* q = static_cast<const T*>(a.q) + bb * a.qs0 + hh * a.qs2;
  const T* k = static_cast<const T*>(a.k) + bb * a.ks0 + hh * a.ks2;
  const T* v = static_cast<const T*>(a.v) + bb * a.vs0 + hh * a.vs2;
  T* o = static_cast<T*>(a.o) + bb * a.os0 + hh * a.os2;
  const bool kvec = can_vec(k, a.ks1, a.d), vvec = can_vec(v, a.vs1, a.d);

  const int k_end = a.causal ? min(q0 + BQ, a.s) : a.s;
  const int nkt = (k_end + BK - 1) / BK;
  const int nit = (nkt + G - 1) / G;  // ring steps: G k tiles each
  // k tiles it G .. it G + G - 1 into stage `st`, one per group
  auto load_kv = [&](T* st, int it) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (it * G + gi >= nkt) break;
      T* dst = st + gi * TS;
      const int k0 = (it * G + gi) * BK;
      load_tile<T, BK, D, NT>(dst, k, a.ks1, k0, a.s, a.d, kvec,
                              C::SPLIT ? dst + 2 * TILE : nullptr);
      load_tile<T, BK, D, NT>(dst + TILE, v, a.vs1, k0, a.s, a.d, vvec,
                              C::SPLIT ? dst + 3 * TILE : nullptr);
    }
  };

  load_tile<T, BQ, D, NT>(sq, q, a.qs1, q0, a.s, a.d,
                          can_vec(q, a.qs1, a.d));
  load_kv(smem, 0);
  cp_async_commit();
  QSource<T, D> qa;
  if constexpr (Q_REGS) {
    // the q tile sits in stage 1 until its fragments are in registers
    cp_async_wait_all();
    __syncthreads();
  }
  qa.init(sq, wr * 16);

  const float sl = a.scale * LOG2E;
  const int row0 = q0 + wr * 16 + g;  // this lane's rows: row0, row0 + 8
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[NO][4] = {};

  for (int it = 0; it < nit; ++it) {
    T* const st = smem + (it & 1) * SS;
    cp_async_wait_all();
    if constexpr (C::SPLIT) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if (it * G + gi >= nkt) break;
        T* dst = st + gi * TS;
        split_own<BK, D, NT>(dst, dst + 2 * TILE, kvec);
        split_own<BK, D, NT>(dst + TILE, dst + 3 * TILE, vvec);
      }
    }
    __syncthreads();  // step it landed; step it - 1 (and q) consumed
    if (it + 1 < nit) {
      load_kv(smem + ((it + 1) & 1) * SS, it + 1);
      cp_async_commit();
    }
    const int kt = it * G + grp;
    if (kt >= nkt) continue;  // this group has no tile in the last step
    const int k0 = kt * BK;
    T* const sk = st + grp * TS;

    float sc[NJ][4] = {};
    if constexpr (!F32)
      mma_abt_bf16<D, BK>(sc, qa, sk);
    else if constexpr (C::SPLIT)
      mma_abt3<D, BK>(sc, qa, SplitB{sk, sk + 2 * TILE});
    else
      mma_abt3<D, BK>(sc, qa, RawB{sk});

    const bool masked = k0 + BK > a.s || (a.causal && k0 + BK - 1 > q0);
    float mx[2] = {m[0], m[1]};
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
        sc[j][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(sc[j][c] - m[c >> 1]);
        sc[j][c] = p;
        ps[c >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(ps[r]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // acc += p . v, p rounded to v's dtype
    if constexpr (!F32)
      mma_pb_bf16<D, BK>(acc, sc, sk + TILE);
    else if constexpr (C::SPLIT)
      mma_pb3<D, BK>(acc, sc, SplitB{sk + TILE, sk + 3 * TILE});
    else
      mma_pb3<D, BK>(acc, sc, RawB{sk + TILE});
  }

  if constexpr (G == 2) {
    // group 1 hands its (m, l, acc) to the lane that holds the same rows
    // in group 0, through the drained ring: value i of lane x at i L + x
    constexpr int L = 32 * C::NW / G;  // lanes of a group
    constexpr int NV = 4 + 4 * NO;     // values per lane
    float* xs = reinterpret_cast<float*>(smem_raw);
    const int lane = wr * 32 + (threadIdx.x & 31);
    __syncthreads();
    if (grp == 1) {
      xs[lane] = m[0];
      xs[L + lane] = m[1];
      xs[2 * L + lane] = l[0];
      xs[3 * L + lane] = l[1];
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) xs[(4 + 4 * n + c) * L + lane] = acc[n][c];
    }
    __syncthreads();
    if (grp == 1) return;
    float c0[2], c1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = xs[r * L + lane], l1 = xs[(2 + r) * L + lane];
      const float mm = fmaxf(m[r], m1);
      c0[r] = exp2f(m[r] - mm);
      c1[r] = exp2f(m1 - mm);
      l[r] = l[r] * c0[r] + l1 * c1[r];
      m[r] = mm;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[n][c] = acc[n][c] * c0[c >> 1] +
                    xs[(4 + 4 * n + c) * L + lane] * c1[c >> 1];
    static_assert(NV * L <= 2 * SS * sizeof(T) / sizeof(float),
                  "the merge must fit the ring");
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.s) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = o + (long long)row * a.os1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * t;
      store2(orow + col, acc[n][2 * r] / lc, acc[n][2 * r + 1] / lc,
             a.d - col);
    }
    if (t == 0)
      a.lse[((long long)bb * a.h + hh) * a.s + row] =
          l[r] <= 0.f ? 1e30f : m[r] * LN2 + logf(lc);
  }
}

template <typename T, int D, class C>
int launch_cfg(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(T) * smem_elems<T, D, C>();
  const cudaError_t err = allow_smem(flash_fwd_kernel<T, D, C>, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int bq = 16 * C::NW / C::KSPLIT;
  const int grid = (a.s + bq - 1) / bq * a.b * a.h;
  flash_fwd_kernel<T, D, C><<<grid, 32 * C::NW, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// f32 by grid size.  Wide moves and splits each k/v tile once for 128
// rows but gives an SM one block: it pays from four waves of its blocks
// on (a training micro-batch).  Below that the heaviest q tiles set the
// time.  KSplit gives each 64-row tile eight warps, two groups taking
// even and odd k tiles, which halves the heaviest tile's path where its
// blocks fit two waves (one prefill of 1024 tokens); between the two,
// Narrow's 64-row blocks run two to an SM.  At d = 256 only Narrow fits.
template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float> && D > 128) {
    return launch_cfg<T, D, Narrow>(a, stream);
  } else if constexpr (std::is_same_v<T, float>) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const long long heads = (long long)a.b * a.h;
    if ((a.s + 127) / 128 * heads >= 4LL * sms)
      return launch_cfg<T, D, Wide>(a, stream);
    if ((a.s + 63) / 64 * heads <= 2LL * sms)
      return launch_cfg<T, D, KSplit>(a, stream);
    return launch_cfg<T, D, Narrow>(a, stream);
  } else {
    return launch_cfg<T, D, Bf16>(a, stream);
  }
}

template <typename T>
int dispatch_d(const Args& a, cudaStream_t stream) {
  if (a.d <= 16) return launch<T, 16>(a, stream);
  if (a.d <= 32) return launch<T, 32>(a, stream);
  if (a.d <= 64) return launch<T, 64>(a, stream);
  if (a.d <= 128) return launch<T, 128>(a, stream);
  return launch<T, 256>(a, stream);
}

}  // namespace

// Returns a cudaError_t value: 0 on a launch that was accepted.  The caller
// has checked devices, dtypes, shapes, 1 <= d <= 256 and unit last strides.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int b, int s, int h, int d,
                         long long qs0, long long qs1, long long qs2,
                         long long ks0, long long ks1, long long ks2,
                         long long vs0, long long vs1, long long vs2,
                         long long os0, long long os1, long long os2,
                         int is_bf16, int causal, float scale, void* stream) {
  if (d < 1 || d > 256) return (int)cudaErrorInvalidValue;
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
