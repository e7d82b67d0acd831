// 32-bit payload checksum for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by brpc_tpu_torch/ops/device_ops.py.
//
// Replaces the Pallas kernel of `_checksum_fn` (brpc_tpu/ops/device_ops.py,
// the body at :50-62, launched at :64 through `checksum_u32`): the wrapping
// sum of the payload's 32-bit words, read as uint32.  Two's-complement
// addition makes the uint32 sum bit-identical to the TPU's int32 wrap, and
// the sum mod 2^32 does not depend on order, so the result is exact and
// deterministic whatever the grid.
//
// Design.  The TPU kernel walks a zero-padded (rows, 128) copy in a
// sequential grid, carrying the sum in an SMEM scalar.  Here there is no
// sequential grid and no padded copy (zeros do not change the sum): the
// kernel reads the words in place in one pass.  A grid-stride loop takes
// 16-byte loads (uint4) from the first 16-byte-aligned word on, four in
// flight per thread; the at most three words before that point and the at
// most three after the last whole uint4 are added one by one.  Each thread
// keeps a uint32 sum, a warp folds it with __reduce_add_sync, a block folds
// its warps through shared memory, and each block adds its sum into the
// output word with one atomicAdd.  The grid is 8 blocks of 256 threads per
// SM (2048 threads, the SM's limit), fewer for a small payload.
//
// What bounds it: bytes.  A 64 MiB payload is 67,108,864 B over 3.35 TB/s,
// 0.020 ms; the adds are 16.8 M integer operations, nothing beside that.
// Yardstick: `x.view(torch.int32).sum(dtype=torch.int64)`, 0.156 ms at that
// size on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 4b, PERF.md §6).
//
// CUDA C++ rather than Triton: a reduction would suit Triton as well, but
// the port's one build route is nvcc -> shared library -> ctypes
// (ops/cuda_build.py), and one toolchain is simpler than two.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int BLOCKS_PER_SM = 8;  // 8 x 256 = 2048 resident threads per SM

__device__ __forceinline__ unsigned fold(uint4 w) {
  return w.x + w.y + w.z + w.w;
}

__global__ void __launch_bounds__(NT)
    checksum_u32_kernel(const unsigned* __restrict__ x, long long n,
                        unsigned* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * NT + threadIdx.x;
  const long long stride = (long long)gridDim.x * NT;
  // words before the first 16-byte boundary (the base is 4-byte aligned)
  long long head = (long long)((16 - (reinterpret_cast<uintptr_t>(x) & 15)) &
                               15) >> 2;
  if (head > n) head = n;
  const long long nvec = (n - head) >> 2;
  const uint4* __restrict__ v = reinterpret_cast<const uint4*>(x + head);

  unsigned acc = 0;
  long long i = tid;
  for (; i + 3 * stride < nvec; i += 4 * stride) {
    const uint4 a = __ldg(v + i);
    const uint4 b = __ldg(v + i + stride);
    const uint4 c = __ldg(v + i + 2 * stride);
    const uint4 d = __ldg(v + i + 3 * stride);
    acc += fold(a) + fold(b) + fold(c) + fold(d);
  }
  for (; i < nvec; i += stride) acc += fold(__ldg(v + i));
  const long long tail = head + (nvec << 2);  // n - tail <= 3
  if (tid < head) acc += __ldg(x + tid);
  if (tid < n - tail) acc += __ldg(x + tail + tid);

  __shared__ unsigned warp_sum[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc = __reduce_add_sync(0xffffffffu, acc);
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < NT / 32 ? warp_sum[lane] : 0u;
    s = __reduce_add_sync(0xffffffffu, s);
    if (lane == 0 && s != 0u) atomicAdd(out, s);
  }
}

int sm_count() {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      return 132;
    cached = sms;
  }
  return cached;
}

}  // namespace

// Zeroes `*out`, then adds every 32-bit word of x[0:n) into it, both on
// `stream`.  Returns a cudaError_t value: 0 when both were accepted.  The
// caller passes a 4-byte-aligned device pointer (an int32 tensor's) and a
// device word; n may be 0.
extern "C" int checksum_u32(const void* x, long long n, void* out,
                            void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n / 4 + NT - 1) / NT;
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  const int blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  checksum_u32_kernel<<<blocks, NT, 0, st>>>(
      static_cast<const unsigned*>(x), n, static_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* checksum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
