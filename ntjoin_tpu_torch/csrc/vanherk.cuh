// Van Herk / Gil-Werman sliding-window argmin, shared by the window/emission
// kernel (window_emit.cu) and the exact window kernel (window.cu): first the
// per-thread passes over device memory, then (namespace tile) the pieces of
// the thread-block version that keeps a tile of chunks in shared memory.
//
// One thread owns one chunk column hcol of the end-indexed hash array
// h (rows, hC) and one column scol of the scratch arrays (w, sC).  Element s
// of the chunk (s in [0, L + w - 1)) is the k-mer at
// row off + s; window j (j in [0, L)) is elements [j, j + w - 1].  Order is
// lexicographic on (unsigned hash, s), so ties go to the leftmost position.
//
// The elements are cut into blocks of w.  A window starting at block offset t
// is the suffix [t, w) of its block plus the prefix [0, t) of the next one:
// a backward pass stores the block's suffix minima in scratch, and a forward
// pass over the next block keeps the running prefix minimum and combines.
// Every element is read twice and the scratch written and read once, so the
// work per window is constant whatever the input: an equal-hash run (a
// homopolymer), where the leftmost argmin leaves every window, costs no more
// than random sequence.  All threads of a chunk grid walk the same (t, block)
// in step, so scratch[t * sC + scol] and h[row * hC + hcol] accesses of a warp
// fall on neighbouring words when neighbouring threads own neighbouring
// columns.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace vanherk {

// Suffix minima of elements [base, base + w) into the scratch rows 0..w-1.
__device__ __forceinline__ void suffix_pass(const uint64_t* __restrict__ h, int64_t hC,
                                            int64_t hcol, int64_t off, int64_t n_el,
                                            int w, int64_t base, uint64_t* __restrict__ sk,
                                            int32_t* __restrict__ sp, int64_t sC,
                                            int64_t scol) {
  uint64_t key = ~0ull;
  int32_t arg = INT32_MAX;
  for (int t = w - 1; t >= 0; --t) {
    const int64_t e = base + t;
    if (e < n_el) {
      const uint64_t v = h[(off + e) * hC + hcol];
      if (v <= key) {  // the later-scanned element is further left: wins ties
        key = v;
        arg = (int32_t)e;
      }
    }
    sk[t * sC + scol] = key;
    sp[t * sC + scol] = arg;
  }
}

// Calls sink(j, key, s) for the windows j of one block, [base, base + w)
// clipped to [0, L), in order, with the window's minimum hash and its
// element index s.  Blocks are independent: a thread can take one or all.
template <class Sink>
__device__ void scan_block(const uint64_t* __restrict__ h, int64_t hC, int64_t hcol,
                           int64_t L, int w, int64_t off, int64_t base,
                           uint64_t* __restrict__ sk, int32_t* __restrict__ sp, int64_t sC,
                           int64_t scol, Sink& sink) {
  const int64_t n_el = L + w - 1;
  const int64_t next = base + w;
  suffix_pass(h, hC, hcol, off, n_el, w, base, sk, sp, sC, scol);
  uint64_t pkey = ~0ull;
  int32_t parg = INT32_MAX;
  for (int t = 0; t < w; ++t) {
    const int64_t j = base + t;
    if (j >= L) break;
    uint64_t key = sk[t * sC + scol];
    int32_t arg = sp[t * sC + scol];
    if (pkey < key) {  // the suffix holds the earlier rows: it wins ties
      key = pkey;
      arg = parg;
    }
    sink(j, key, arg);
    const int64_t e = next + t;
    if (e < n_el) {
      const uint64_t v = h[(off + e) * hC + hcol];
      if (v < pkey) {
        pkey = v;
        parg = (int32_t)e;
      }
    }
  }
}

// Every window j in [0, L) of the chunk, in order.
template <class Sink>
__device__ void scan(const uint64_t* __restrict__ h, int64_t hC, int64_t hcol, int64_t L,
                     int w, int64_t off, uint64_t* __restrict__ sk, int32_t* __restrict__ sp,
                     int64_t sC, int64_t scol, Sink& sink) {
  for (int64_t base = 0; base < L; base += w)
    scan_block(h, hC, hcol, L, w, off, base, sk, sp, sC, scol, sink);
}

// -- pieces of the shared-memory tile version (window_emit.cu) -----------------
//
// A segment of w rows of one chunk column is cut into G row groups, one
// thread each (G is the kernel's template parameter, a multiple of 32: one
// warp scans a column's groups, G / 32 neighbouring groups a lane).  A
// (key, arg) pair is a minimum and the row offset it sits at;
// kNoArg marks "no row".  left_wins keeps the left operand on equal keys, so
// folding rows or groups left to right yields the leftmost minimum, and
// (~0, kNoArg) is neutral on either side wherever the result is only used
// after a strict `<` (prefix side) or is overwritten by a row of the thread's
// own group through `<=` (suffix side).
namespace tile {

constexpr uint32_t kNoArg = 0xFFFF;

struct KeyArg {
  uint64_t key;
  uint32_t arg;
};

__device__ __forceinline__ KeyArg left_wins(KeyArg l, KeyArg r) { return r.key < l.key ? r : l; }

__device__ __forceinline__ KeyArg shfl_up(KeyArg x, int d) {
  return {__shfl_up_sync(0xffffffffu, (unsigned long long)x.key, d),
          __shfl_up_sync(0xffffffffu, x.arg, d)};
}

__device__ __forceinline__ KeyArg shfl_down(KeyArg x, int d) {
  return {__shfl_down_sync(0xffffffffu, (unsigned long long)x.key, d),
          __shfl_down_sync(0xffffffffu, x.arg, d)};
}

// One warp, one column: lane l holds the minima v[0..P) of groups lP .. lP+P-1.
// On return pre[p] is the minimum over all groups before group lP+p and
// suf[p] over all groups after it (exclusive both ways).
template <int P>
__device__ __forceinline__ void scan_groups(const KeyArg (&v)[P], int lane, KeyArg (&pre)[P],
                                            KeyArg (&suf)[P]) {
  const KeyArg none{~0ull, kNoArg};
  KeyArg all = v[0];
#pragma unroll
  for (int p = 1; p < P; ++p) all = left_wins(all, v[p]);
  KeyArg x = all;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const KeyArg o = shfl_up(x, d);
    if (lane >= d) x = left_wins(o, x);
  }
  KeyArg run = shfl_up(x, 1);
  if (lane == 0) run = none;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    pre[p] = run;
    run = left_wins(run, v[p]);
  }
  KeyArg y = all;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const KeyArg o = shfl_down(y, d);
    if (lane + d < 32) y = left_wins(y, o);
  }
  run = shfl_down(y, 1);
  if (lane == 31) run = none;
#pragma unroll
  for (int p = P - 1; p >= 0; --p) {
    suf[p] = run;
    run = left_wins(v[p], run);
  }
}

// The same for counts: exclusive sums before each of the lane's groups, and
// the total.
template <int P>
__device__ __forceinline__ void scan_counts(const int (&n)[P], int lane, int (&pre)[P],
                                            int& total) {
  int mine = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) mine += n[p];
  int x = mine;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int o = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += o;
  }
  total = __shfl_sync(0xffffffffu, x, 31);
  int run = x - mine;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    pre[p] = run;
    run += n[p];
  }
}

}  // namespace tile

}  // namespace vanherk
