// Device-memory copy, the bandwidth calibration of the per-stage profiler.
//
// Replaces: scripts/kernel_prof.py, the two `pallas_copy` kernels (body
// `_copy_kernel`, :190 in the `slope` stage and :380 in the `membw` stage),
// a block copy of a uint32 (rows, 2048) array in 256-row VMEM blocks.
//
// Contract (plain version: ntjoin_tpu_torch/ops/membw.py, copy_words_ref):
// dst[i] = src[i] for every byte i < nbytes.  Both pointers 16-byte aligned.
//
// What bounds it on an H100: device memory alone (nbytes read and nbytes
// written, no arithmetic).  Each thread moves kUnroll 16-byte vectors (uint4)
// a grid stride apart, all loads before the stores, so a warp reads and
// writes 512 neighbouring bytes per access; the grid covers the array in one
// pass.  A grid capped at 16 blocks per SM striding over the array was 5%
// slower than `copy_` on the H100, with or without the unroll; one pass is
// within ~1% of it (PERF.md).  Persistent blocks moving the array as bulk
// asynchronous copies through shared memory (`cp.async.bulk`, an mbarrier
// ring of 4 x 16 KB, one issuing thread, two blocks per SM) were 3% slower
// than this kernel in every round on the same array, so this one stays
// (PERF.md).  The last nbytes % 16 bytes are copied one by one.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                            int64_t n_vec, int64_t nbytes) {
  const int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = g;
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + u * stride] = v[u];
  }
  for (; i < n_vec; i += stride) dst[i] = src[i];
  const int64_t tail = nbytes - n_vec * 16;
  if (g < tail) {
    reinterpret_cast<uint8_t*>(dst)[n_vec * 16 + g] =
        reinterpret_cast<const uint8_t*>(src)[n_vec * 16 + g];
  }
}

}  // namespace

extern "C" int nj_copy(const void* src, void* dst, int64_t nbytes, void* stream) {
  if (nbytes <= 0) return 0;
  const int64_t n_vec = nbytes / 16;
  const int64_t per_block = (int64_t)kThreads * kUnroll;
  const int64_t blocks = n_vec < per_block ? 1 : (n_vec + per_block - 1) / per_block;
  copy_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (uint4*)dst, n_vec, nbytes);
  return (int)cudaGetLastError();
}

// An empty kernel: what one launch costs on this card, the floor under any
// kernel's time.
namespace {
__global__ void noop_kernel() {}
}  // namespace

extern "C" int nj_noop(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
