// Mann-Kendall S of padded rows: S = sum over i < j < len of sign(x_j - x_i),
// counted while a merge sort splits the pairs.
//
// Replaces: the pair sums of ntjoin_tpu/ops/mannkendall.py mk_s_batch (:25, a
// lax.scan over blocks of i that XLA fuses; no TPU kernel).  In PyTorch the
// same sums materialised (B, block, L) boolean tensors: 187-203 ms on an
// NVIDIA H100 for the runs of a 1 Gbp path (PERF.md), hence a kernel.
//
// Contract (plain version: ntjoin_tpu_torch/ops/mannkendall.py,
// mk_s_batch_ref).  x (B, width) int64, row-major; row b holds lengths[b]
// values, 0 <= lengths[b] <= width, and whatever follows them is never read.
// s (B,) int64 receives each row's S.  Exact for any length: every count is
// an integer and S is int64.
//
// The count.  In a bottom-up merge sort of a row, where each run is a range
// of indices and the left run comes first, each pair i < j is split exactly
// once: at the level where i lies in a left run and j in its right sibling.
// A stable merge places a left value x past the right values below it
// (lower_bound(right, x)) and a right value y past the left values at most y
// (upper_bound(left, y)); the two bounds keep ties from colliding.  So the
// sum over levels of upper_bound(left, y) over the right values, less
// lower_bound(right, x) over the left ones, counts each rising pair +1, each
// falling pair -1 and each tied pair +1; S is that less the tied pairs, which
// the sorted row gives (a value at sorted place i ties with the i -
// lower_bound(row, y) values before it).  The plain version compares the
// pairs one by one, so the two share no arithmetic.
//
// Design.  A row is cut into tiles of T values, T the least power of two that
// holds it, from 32 up to kCap = 2,048 (two int64 buffers of kCap fill 32 KB
// of static shared memory).  Pass 1, a thread block of 1,024 threads a tile
// (rows of T < kCap share a block, kCap / T at a time), loads the tile's
// valid values, merges them in shared memory over log2 T levels, each value
// binary-searching its sibling run for its place and its count, then counts
// the tile's ties; a tile holds under 2^31 pairs, so the counts are int32.
// The block's sums (warp shuffles, then an int32 a row in shared memory) are
// S of a one-tile row, stored.  A row wider than kCap writes its sorted tiles
// to a scratch (B, width) buffer, and pass 2 takes a (row, ti < tj) tile pair
// a block, numbered p = tj (tj - 1) / 2 + ti: tile ti (full, since tj holds
// values) in shared memory, each value y of tile tj adds lower_bound(ti, y) +
// upper_bound(ti, y) - kCap; there the tiles' sums go into s[row], zeroed
// first, by 64-bit integer atomicAdd, exact in any order, so S is the same in
// every run.  A thread
// steps the searches of its values together, bit_length(r) steps at merge
// level r (sibling runs of at most r values), bit_length(T) for the ties and
// 12 over a tile in pass 2 (mannkendall.mk_steps counts them).
//
// What bounds it on an H100: the function must read the valid values once
// (8 bytes each), the lengths, and write S; rows of several tiles also write
// and read their sorted tiles once more, this design's own traffic and not
// part of the bound.  The runs of a 1 Gbp path take 4e8 search steps, a
// shared-memory load each.  A one-tile row's merge runs in one thread block,
// so a batch of few rows fills few of the 132 SMs (63 by time over those
// runs, split_bench mk's trace).  On an NVIDIA H100 80GB
// HBM3 at 700 W, queued (PERF.md section 6): 1.04 ms for those runs' 64
// batches, 0.059 ms for a run of 100,000 and 0.77 ms for one of 2^19, where
// the O(n^2) pair walk this design replaced took 5.07, 1.77 and 48 ms.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCap = 2048;  // values of a tile at most (mannkendall.MK_TILE)
// pass 1: 32 warps a tile, to hide the searches' latency; pass 2: 8 warps,
// 8 values a thread (e = threadIdx.x + k * threads)
constexpr int kSortThreads = 1024, kSortPer = kCap / kSortThreads;
constexpr int kCrossThreads = 256, kCrossPer = kCap / kCrossThreads;

// One step of a binary search, built bit by bit from a power of two at
// least the count: lo += step where the value at lo + step - 1 of sorted
// s[0, n) is below y (at most y with upper).  A thread steps the searches of
// its values together, so that their loads overlap.
__device__ __forceinline__ void probe(const int64_t* s, int n, int64_t y, bool upper, int step,
                                      int& lo) {
  if (lo + step <= n) {
    const int64_t v = s[lo + step - 1];
    if (v < y || (upper && v == y)) lo += step;
  }
}

// (ti, t), ti <= t, of p = t (t + 1) / 2 + ti: the root in float64, then
// corrected (exact for p < 2^45, tests/test_torch_mannkendall.py)
__device__ __forceinline__ void tile_pair(int64_t p, int64_t& ti, int64_t& t) {
  t = (int64_t)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
  while (t * (t + 1) / 2 > p) --t;
  while ((t + 1) * (t + 2) / 2 <= p) ++t;
  ti = p - t * (t + 1) / 2;
}

__device__ __forceinline__ int valid_in(int64_t n, int64_t start, int T) {
  const int64_t m = n - start;
  return (int)(m < 0 ? 0 : m > T ? T : m);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

// Pass 1: item = (block of kRows rows, tile); nt tiles a row.
template <int T>
__global__ void __launch_bounds__(kSortThreads)
    sort_kernel(const int64_t* __restrict__ x, int64_t B, int64_t width,
                const int64_t* __restrict__ lengths, int64_t nt, int64_t items,
                int64_t* __restrict__ sorted, unsigned long long* __restrict__ s) {
  constexpr int kRows = kCap / T;  // > 1 only where a row is one tile
  __shared__ int64_t buf[2][kCap];
  __shared__ int32_t part[kRows];
  const int t = threadIdx.x;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t row0 = item / nt * kRows, tile = item % nt;
    int m[kSortPer], acc[kSortPer];
    __syncthreads();  // the last item's reads of buf and part are done
#pragma unroll
    for (int k = 0; k < kSortPer; ++k) {
      const int e = t + k * kSortThreads, i = e % T;
      const int64_t row = row0 + e / T;
      m[k] = row < B ? valid_in(lengths[row], tile * T, T) : 0;
      acc[k] = 0;
      if (i < m[k]) buf[0][e] = x[row * width + tile * T + i];
    }
    if (t < kRows) part[t] = 0;
    __syncthreads();
    int cur = 0;
    for (int r = 1; r < T; r <<= 1) {
      const int64_t* src = buf[cur];
      int64_t* dst = buf[cur ^ 1];
      // each value's sibling run (from sib, n values) and its count there:
      // a left value x of [a, a + r) counts the right values below x, a
      // right value y of [a + r, a + 2r) (then i & r) the left values at most y
      int64_t y[kSortPer];
      int sib[kSortPer], n[kSortPer], lo[kSortPer];
      bool right[kSortPer];
#pragma unroll
      for (int k = 0; k < kSortPer; ++k) {
        const int e = t + k * kSortThreads, i = e % T, base = e - i;
        const int a = i & ~(2 * r - 1), mid = min(a + r, m[k]), end = min(a + 2 * r, m[k]);
        const bool valid = i < m[k];
        right[k] = i & r;
        y[k] = valid ? src[e] : 0;
        sib[k] = base + (right[k] ? a : mid);
        n[k] = valid ? (right[k] ? r : end - mid) : 0;
        lo[k] = 0;
      }
      for (int step = r; step > 0; step >>= 1) {  // sibling runs hold at most r values
#pragma unroll
        for (int k = 0; k < kSortPer; ++k)
          probe(src + sib[k], n[k], y[k], right[k], step, lo[k]);
      }
#pragma unroll
      for (int k = 0; k < kSortPer; ++k) {
        const int e = t + k * kSortThreads, i = e % T;
        if (i < m[k]) {
          if (right[k]) {
            acc[k] += lo[k];
            dst[sib[k] + (i & (r - 1)) + lo[k]] = y[k];
          } else {
            acc[k] -= lo[k];
            dst[e + lo[k]] = y[k];
          }
        }
      }
      __syncthreads();
      cur ^= 1;
    }
    {  // less the tile's tied pairs, each counted +1 at its level: a value at
       // sorted place i ties with the i - lower_bound(tile, y) before it
      const int64_t* src = buf[cur];
      int64_t y[kSortPer];
      int lo[kSortPer];
#pragma unroll
      for (int k = 0; k < kSortPer; ++k) {
        const int e = t + k * kSortThreads, i = e % T;
        y[k] = i < m[k] ? src[e] : 0;
        lo[k] = 0;
      }
      for (int step = T; step > 0; step >>= 1) {
#pragma unroll
        for (int k = 0; k < kSortPer; ++k) {
          const int e = t + k * kSortThreads;
          probe(src + e - e % T, e % T < m[k] ? m[k] : 0, y[k], false, step, lo[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kSortPer; ++k) {
        const int i = (t + k * kSortThreads) % T;
        if (i < m[k]) acc[k] -= i - lo[k];
      }
    }
    if (nt > 1) {  // kRows == 1: pass 2 reads the sorted tile
#pragma unroll
      for (int k = 0; k < kSortPer; ++k) {
        const int e = t + k * kSortThreads;
        if (e < m[k]) sorted[row0 * width + tile * T + e] = buf[cur][e];
      }
    }
#pragma unroll
    for (int k = 0; k < kSortPer; ++k) {  // a warp's lanes lie in one row (T >= 32)
      const int v = warp_sum(acc[k]);
      if ((t & 31) == 0 && v) atomicAdd(&part[(t + k * kSortThreads) / T], v);
    }
    __syncthreads();
    if (t < kRows && row0 + t < B) {
      if (nt == 1)  // the row's one block: S itself
        s[row0 + t] = (unsigned long long)(int64_t)part[t];
      else if (part[t])
        atomicAdd(s + row0 + t, (unsigned long long)(int64_t)part[t]);
    }
  }
}

// Pass 2: item = (row, tile pair ti < tj); pairs tile pairs a row.
__global__ void __launch_bounds__(kCrossThreads)
    cross_kernel(const int64_t* __restrict__ sorted, int64_t width,
                 const int64_t* __restrict__ lengths, int64_t pairs, int64_t items,
                 unsigned long long* __restrict__ s) {
  __shared__ int64_t left[kCap];
  __shared__ int32_t part[kCrossThreads / 32];
  const int t = threadIdx.x;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t row = item / pairs;
    int64_t ti, tj;
    tile_pair(item - row * pairs, ti, tj);
    ++tj;  // p = tj (tj - 1) / 2 + ti, ti < tj
    // tile tj's values; tile ti is then full
    const int mj = valid_in(lengths[row], tj * kCap, kCap), mi = mj ? kCap : 0;
    const int64_t* xr = sorted + row * width;
    __syncthreads();  // the last item's reads of left and part are done
#pragma unroll
    for (int k = 0; k < kCrossPer; ++k) {
      const int e = t + k * kCrossThreads;
      if (e < mi) left[e] = xr[ti * kCap + e];
    }
    __syncthreads();
    int64_t y[kCrossPer];
    int n[kCrossPer], lo[kCrossPer], hi[kCrossPer];
#pragma unroll
    for (int k = 0; k < kCrossPer; ++k) {
      const int e = t + k * kCrossThreads;
      n[k] = e < mj ? kCap : 0;
      y[k] = e < mj ? xr[tj * kCap + e] : 0;
      lo[k] = hi[k] = 0;
    }
    for (int step = kCap; step > 0; step >>= 1) {
#pragma unroll
      for (int k = 0; k < kCrossPer; ++k) {
        probe(left, n[k], y[k], false, step, lo[k]);
        probe(left, n[k], y[k], true, step, hi[k]);
      }
    }
    int acc = 0;
#pragma unroll
    for (int k = 0; k < kCrossPer; ++k) acc += n[k] ? lo[k] + hi[k] - kCap : 0;
    acc = warp_sum(acc);
    if ((t & 31) == 0) part[t >> 5] = acc;
    __syncthreads();
    if (t == 0) {
      int64_t sum = 0;
#pragma unroll
      for (int u = 0; u < kCrossThreads / 32; ++u) sum += part[u];
      if (sum) atomicAdd(s + row, (unsigned long long)sum);
    }
  }
}

template <int T>
int sort_launch(const int64_t* x, int64_t B, int64_t width, const int64_t* lengths,
                int64_t blocks, int64_t* sorted, unsigned long long* s, cudaStream_t stream) {
  constexpr int64_t kRows = kCap / T;
  const int64_t nt = (width + T - 1) / T;
  sort_kernel<T><<<(unsigned)blocks, kSortThreads, 0, stream>>>(
      x, B, width, lengths, nt, (B + kRows - 1) / kRows * nt, sorted, s);
  return (int)cudaGetLastError();
}

}  // namespace

// tile: T of the rows' tiles; sort_blocks, cross_blocks: thread blocks of
// the two passes, each walking items a grid apart (mannkendall.mk_launch);
// sorted: the (B, width) scratch of the sorted tiles where width > tile,
// else null.  Launches pass 1, then pass 2 where a row has several tiles.
extern "C" int nj_mk_s(const void* x, int64_t B, int64_t width, const void* lengths, int tile,
                       int64_t sort_blocks, int64_t cross_blocks, void* sorted, void* s,
                       void* stream) {
  if (B < 1 || width < 1 || tile < 1 || sort_blocks < 1 || sort_blocks > INT32_MAX ||
      cross_blocks < 0 || cross_blocks > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t nt = (width + tile - 1) / tile;
  if (nt > 1 && (tile != kCap || sorted == nullptr || cross_blocks < 1))
    return (int)cudaErrorInvalidValue;
  const int64_t* xp = (const int64_t*)x;
  const int64_t* lp = (const int64_t*)lengths;
  int64_t* sp = (int64_t*)sorted;
  unsigned long long* out = (unsigned long long*)s;
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  if (nt > 1) err = (int)cudaMemsetAsync(s, 0, B * sizeof(int64_t), st);  // tiles add to S
  if (err != 0) return err;
  switch (tile) {
    case 2048: err = sort_launch<2048>(xp, B, width, lp, sort_blocks, sp, out, st); break;
    case 1024: err = sort_launch<1024>(xp, B, width, lp, sort_blocks, sp, out, st); break;
    case 512: err = sort_launch<512>(xp, B, width, lp, sort_blocks, sp, out, st); break;
    case 256: err = sort_launch<256>(xp, B, width, lp, sort_blocks, sp, out, st); break;
    case 128: err = sort_launch<128>(xp, B, width, lp, sort_blocks, sp, out, st); break;
    case 64: err = sort_launch<64>(xp, B, width, lp, sort_blocks, sp, out, st); break;
    case 32: err = sort_launch<32>(xp, B, width, lp, sort_blocks, sp, out, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0 || nt == 1) return err;
  const int64_t pairs = nt * (nt - 1) / 2;
  cross_kernel<<<(unsigned)cross_blocks, kCrossThreads, 0, st>>>(sp, width, lp, pairs,
                                                                 B * pairs, out);
  return (int)cudaGetLastError();
}
