// Mann-Kendall S of padded rows: S = sum over i < j < len of sign(x_j - x_i).
//
// Replaces: the pair sums of ntjoin_tpu/ops/mannkendall.py mk_s_batch (:25, a
// lax.scan over blocks of i that XLA fuses; no TPU kernel).  In PyTorch the
// same sums materialised (B, block, L) boolean tensors: 187-203 ms on an
// NVIDIA H100 for the runs of a 1 Gbp path (PERF.md), hence a kernel.
//
// Contract (plain version: ntjoin_tpu_torch/ops/mannkendall.py,
// mk_s_batch_ref).  x (B, width) int64, row-major; row b holds lengths[b]
// values, 0 <= lengths[b] <= width, and whatever follows them is ignored (the
// scaffolder pads with zeros).  s (B,) int64 must be zero on entry; the kernel
// adds each row's S to it.  Exact for any length: S is int64.
//
// What bounds it on an H100: operations, one comparison pair and one add a
// pair of the row; the inputs are read once (8 bytes a value).  Design: a row
// is cut into tiles of T values (T = 32 ... 256, from the width), and a work
// item is a (row, i-tile, j-tile) with i-tile <= j-tile, numbered row by row,
// tile pair p = tj (tj + 1) / 2 + ti.  A thread block of 256 threads takes
// 256 / T items side by side; a group of T threads stages its j-tile in
// shared memory, each thread holds its own x_i in a register and walks the
// tile, counting (x_j > x_i) - (x_j < x_i) in an int32 (every thread of a
// warp reads the same x_j: a broadcast).  Only the diagonal tile masks j > i,
// and the row's own length bounds i and j, so the padding is never read as a
// value.  The group's sum (warp shuffles, then its warps) goes into s[row] by
// one 64-bit integer atomicAdd: integer adds are exact in any order, so S is
// the same in every run.  No sort, no tie count: a tie adds 0.  On an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md), the runs of a 1 Gbp path (1.3e10
// pairs): 5.5 ms, where the PyTorch version took 203 ms; the bound at 4
// operations a pair is 0.77 ms.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// (ti, tj), ti <= tj, of tile pair p = tj (tj + 1) / 2 + ti: the root in
// float64, then corrected (exact for p < 2^45, tests/test_torch_mannkendall.py)
__device__ __forceinline__ void tile_pair(int64_t p, int64_t& ti, int64_t& tj) {
  int64_t t = (int64_t)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
  while (t * (t + 1) / 2 > p) --t;
  while ((t + 1) * (t + 2) / 2 <= p) ++t;
  tj = t;
  ti = p - t * (t + 1) / 2;
}

template <int T>
__global__ void __launch_bounds__(kThreads)
    mk_s_kernel(const int64_t* __restrict__ x, int64_t width,
                const int64_t* __restrict__ lengths, int64_t items, int64_t pairs,
                unsigned long long* __restrict__ s) {
  constexpr int kGroups = kThreads / T, kWarps = T / 32;
  __shared__ int64_t tile[kThreads];
  __shared__ int32_t part[kThreads / 32];
  const int g = threadIdx.x / T, t = threadIdx.x % T;
  for (int64_t b0 = (int64_t)blockIdx.x * kGroups; b0 < items;
       b0 += (int64_t)gridDim.x * kGroups) {
    const int64_t item = b0 + g;
    int64_t row = 0, ti = 0, tj = 0, n = 0;
    if (item < items) {
      row = item / pairs;
      tile_pair(item - row * pairs, ti, tj);
      n = lengths[row];
    }
    const int64_t* xr = x + row * width;
    const int64_t i = ti * T + t, j = tj * T + t;
    __syncthreads();  // the last item's reads of tile and part are done
    tile[threadIdx.x] = j < n ? xr[j] : 0;
    const int64_t xi = i < n ? xr[i] : 0;
    __syncthreads();
    int32_t acc = 0;
    if (i < n) {
      const int64_t* y = tile + g * T;
      const int m = (int)(n - tj * T < T ? n - tj * T : T);  // the tile's j inside the row
#pragma unroll 8
      for (int q = ti == tj ? t + 1 : 0; q < m; ++q) acc += (y[q] > xi) - (y[q] < xi);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, d);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (t == 0 && item < items) {
      int64_t sum = 0;
#pragma unroll
      for (int u = 0; u < kWarps; ++u) sum += part[g * kWarps + u];
      if (sum) atomicAdd(s + row, (unsigned long long)sum);
    }
  }
}

template <int T>
int launch(const void* x, int64_t B, int64_t width, const void* lengths, int64_t blocks,
           void* s, void* stream) {
  const int64_t nt = (width + T - 1) / T, pairs = nt * (nt + 1) / 2;
  mk_s_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)x, width, (const int64_t*)lengths, B * pairs, pairs,
      (unsigned long long*)s);
  return (int)cudaGetLastError();
}

}  // namespace

// tile: T of the rows' tiles (mannkendall.mk_launch); blocks: thread blocks,
// each walks items a grid apart.
extern "C" int nj_mk_s(const void* x, int64_t B, int64_t width, const void* lengths, int tile,
                       int64_t blocks, void* s, void* stream) {
  if (B < 1 || width < 1 || blocks < 1 || blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 256: return launch<256>(x, B, width, lengths, blocks, s, stream);
    case 128: return launch<128>(x, B, width, lengths, blocks, s, stream);
    case 64: return launch<64>(x, B, width, lengths, blocks, s, stream);
    case 32: return launch<32>(x, B, width, lengths, blocks, s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
