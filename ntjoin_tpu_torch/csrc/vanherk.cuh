// Van Herk / Gil-Werman sliding-window argmin, shared by the window/emission
// kernel (window_emit.cu) and the exact window kernel (window.cu): the pieces
// of the version that keeps a tile of chunks in shared memory (namespace
// tile), then the version that reads its rows from device memory (namespace
// split).  Neither keeps anything in a device-memory scratch.
//
// Element s of a chunk (s in [0, L + w - 1)) is the k-mer at row off + s of
// the end-indexed hash array h (rows, C); window j (j in [0, L)) is elements
// [j, j + w - 1].  Order is lexicographic on (unsigned hash, s), so ties go
// to the leftmost position.
//
// The elements are cut into segments of w.  A window starting at offset t of
// segment b is the suffix [t, w) of that segment plus the prefix [0, t) of
// segment b + 1.  The rows of a segment are split into row groups, one thread
// each: every thread folds its rows to a group minimum, a scan over the group
// minima gives each group the minimum of all groups after it (segment b) and
// before it (segment b + 1), and each thread then turns its own rows into
// suffix minima and combines them with the running prefix minimum.  Every
// element is read a fixed number of times, so the work per window is constant
// whatever the input: an equal-hash run (a homopolymer), where the leftmost
// argmin leaves every window, costs no more than random sequence.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace vanherk {

// -- pieces of the shared-memory tile version (window_emit.cu) -----------------
//
// A staged segment of w rows of one chunk column is cut into G row groups, one
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

// -- the version that reads its rows from device memory (window.cu, -------------
// -- window_emit.cu's device-memory route) ---------------------------------------
//
// A thread block owns T neighbouring columns (T a power of two up to 32: the
// 8-byte hashes of four columns are one 32-byte sector, of 32 a run of 256
// bytes) and one block of w windows at a time.  Thread tid is row group g =
// tid / T of column tid % T, so the G = blockDim.x / T groups of a column sit
// T lanes apart in their warps, and a scan over them is a warp scan by
// shuffles at distances T, 2T, ... and a fold over the warps' totals in
// shared memory (with T = 32 a warp is one row group of 32 columns, and the
// scan is that fold alone).
//
// A thread keeps kRows rows of each segment in registers, so one pass covers
// a sub-tile of Q = G * kRows rows, and a segment is S = ceil(w / Q)
// sub-tiles.  Where S > 1 the suffix minimum over the later sub-tiles of segment
// b comes from a first pass over that segment, which leaves every sub-tile's
// minimum in shared memory (24 bytes a sub-tile and column: `sub_bytes`); the
// prefix minimum over the earlier sub-tiles of segment b + 1 runs along.  So
// a hash is read twice where w <= Q (once as segment b, once as segment b +
// 1) and three times otherwise, from L2 after the first time.
//
// A thread block that walks a tile's blocks of windows in order (`Walk`)
// reads less: segment b + 1 of one block is segment b of the next, so where S
// > 1 the sub-tile minima are noted while the segment passes as b + 1 and the
// first pass falls away (two reads of a hash), and where S = 1 the thread
// keeps its rows and the scan of their group minima in registers for the next
// block (one read of a hash, one barrier a block).
//
// (~0, kNone) stands for "no row": a row past the segment, past the chunk's
// last element, or of a column past the last.  It is neutral wherever the
// result is used: on the prefix side only after a strict `<`, on the suffix
// side a thread's own row overrides it through `<=`, and every window below L
// covers only rows that exist.
namespace split {

using tile::KeyArg;
using tile::left_wins;
using tile::shfl_down;
using tile::shfl_up;

constexpr int kRows = 8;           // rows of a segment that a thread holds in registers
constexpr int kMaxThreads = 512;   // of a thread block
constexpr uint32_t kNone = 0xFFFFFFFFu;

// Warp totals of one block scan, per column.
template <int T>
struct ScanBuf {
  uint64_t key[kMaxThreads / 32 * T];
  uint32_t arg[kMaxThreads / 32 * T];
};

// What a kernel declares in shared memory for `block_windows`.
template <int T>
struct Shared {
  ScanBuf<T> buf[4];  // taken in turns, so that a scan costs one barrier
};

// Dynamic shared memory of a block: the sub-tile minima of a segment, as
// noted and as their suffix minima.
__host__ __device__ constexpr size_t sub_bytes(int w, int T, int threads) {
  const int q = threads / T * kRows, s = (w + q - 1) / q;
  return s > 1 ? (size_t)s * T * 24 : 0;
}

// What a thread block that walks a tile's blocks of windows in order carries
// from one block to the next.
struct Walk {
  bool warm = false;   // the block before has left its segment b + 1 behind:
  uint64_t key[kRows]; // S = 1: the thread's rows of it
  KeyArg suf;          // S = 1: its minimum over the row groups after the thread's own
};

// Minimum over the row groups of the thread's column before (Fwd) or after
// (!Fwd) its own, exclusive; with Fwd also, where asked for, the minimum over
// all of them.  A warp scan by shuffles T lanes apart, then a fold over the
// warps' totals.  Every thread of the block calls it; one barrier.
template <int T, bool Fwd>
__device__ __forceinline__ KeyArg block_exclusive(KeyArg mine, ScanBuf<T>& buf, KeyArg* total) {
  const KeyArg none{~0ull, kNone};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int col = lane % T;
  KeyArg x = mine;
#pragma unroll
  for (int d = T; d < 32; d *= 2) {
    if (Fwd) {
      const KeyArg o = shfl_up(x, d);
      if (lane >= d) x = left_wins(o, x);
    } else {
      const KeyArg o = shfl_down(x, d);
      if (lane + d < 32) x = left_wins(x, o);
    }
  }
  if (Fwd ? lane >= 32 - T : lane < T) {  // the warp's total of this column
    buf.key[warp * T + col] = x.key;
    buf.arg[warp * T + col] = x.arg;
  }
  KeyArg ex = Fwd ? shfl_up(x, T) : shfl_down(x, T);
  if (Fwd ? lane < T : lane + T >= 32) ex = none;
  __syncthreads();
  KeyArg carry = none;
  if (Fwd) {
    for (int v = 0; v < warp; ++v)
      carry = left_wins(carry, KeyArg{buf.key[v * T + col], buf.arg[v * T + col]});
    ex = left_wins(carry, ex);
    if (total) {
      for (int v = warp; v < nw; ++v)
        carry = left_wins(carry, KeyArg{buf.key[v * T + col], buf.arg[v * T + col]});
      *total = carry;
    }
  } else {
    for (int v = nw - 1; v > warp; --v)
      carry = left_wins(KeyArg{buf.key[v * T + col], buf.arg[v * T + col]}, carry);
    ex = left_wins(ex, carry);
  }
  return ex;
}

// Both scans of one value behind one barrier: `pre` over the groups before
// the thread's own, `suf` over those after it.
template <int T>
__device__ __forceinline__ void block_both(KeyArg mine, ScanBuf<T>& fwd, ScanBuf<T>& back,
                                           KeyArg& pre, KeyArg& suf) {
  const KeyArg none{~0ull, kNone};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int col = lane % T;
  KeyArg x = mine, y = mine;
#pragma unroll
  for (int d = T; d < 32; d *= 2) {
    const KeyArg ox = shfl_up(x, d), oy = shfl_down(y, d);
    if (lane >= d) x = left_wins(ox, x);
    if (lane + d < 32) y = left_wins(y, oy);
  }
  if (lane >= 32 - T) {
    fwd.key[warp * T + col] = x.key;
    fwd.arg[warp * T + col] = x.arg;
  }
  if (lane < T) {
    back.key[warp * T + col] = y.key;
    back.arg[warp * T + col] = y.arg;
  }
  pre = shfl_up(x, T);
  suf = shfl_down(y, T);
  if (lane < T) pre = none;
  if (lane + T >= 32) suf = none;
  __syncthreads();
  KeyArg carry = none;
  for (int v = 0; v < warp; ++v)
    carry = left_wins(carry, KeyArg{fwd.key[v * T + col], fwd.arg[v * T + col]});
  pre = left_wins(carry, pre);
  carry = none;
  for (int v = nw - 1; v > warp; --v)
    carry = left_wins(KeyArg{back.key[v * T + col], back.arg[v * T + col]}, carry);
  suf = left_wins(suf, carry);
}

// The same for counts: the sum over the groups before the thread's own, and
// the sum over all.  buf: a word for every warp and column.  One barrier.
template <int T>
__device__ __forceinline__ int block_exclusive_sum(int n, int* buf, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int col = lane % T;
  int x = n;
#pragma unroll
  for (int d = T; d < 32; d *= 2) {
    const int o = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += o;
  }
  if (lane >= 32 - T) buf[warp * T + col] = x;
  __syncthreads();
  int before = x - n;
  total = 0;
  for (int v = 0; v < nw; ++v) {
    const int t = buf[v * T + col];
    if (v < warp) before += t;
    total += t;
  }
  return before;
}

// One block of w windows of the block's T columns: windows b*w + t, t in
// [0, w).  Thread tid works on column hcol (its column of h, or -1 for a
// column past the last).  For every sub-tile, in order, every thread calls
//   sink.prefetch(t0)           before the rows are read, and
//   sink.windows(t0, key, arg)  with the minimum hash and the argmin, as an
//                               element offset from b*w, of windows t0 + r,
//                               r in [0, kRows); a window with t0 + r >= w or
//                               b*w + t0 + r >= L, or of a column past the
//                               last, holds no result.
// Both may hold barriers: all threads call them alike.  sub: `sub_bytes` of
// dynamic shared memory.  walk: null for a block of windows by itself, else
// what the calls for blocks 0, 1, 2, ... of one tile hand on.
template <int T, class Sink>
__device__ __forceinline__ void block_windows(const uint64_t* __restrict__ h, int64_t h_pitch,
                                              int64_t hcol, int64_t L, int w, int64_t off, int b,
                                              Shared<T>& sm, unsigned char* sub, Walk* walk,
                                              Sink& sink) {
  const KeyArg none{~0ull, kNone};
  const int col = threadIdx.x % T, g = threadIdx.x / T, G = blockDim.x / T;
  const int Q = G * kRows, S = (w + Q - 1) / Q;
  const int64_t n_el = L + w - 1, base = (int64_t)b * w;
  // sub-tile minima of segment b: as noted (`noted_*`), and the minimum over
  // the sub-tiles after each (`sub_*`)
  uint64_t* sub_key = reinterpret_cast<uint64_t*>(sub);
  uint64_t* noted_key = sub_key + (size_t)S * T;
  uint32_t* sub_arg = reinterpret_cast<uint32_t*>(noted_key + (size_t)S * T);
  uint32_t* noted_arg = sub_arg + (size_t)S * T;
  const uint64_t* hc = h + off * h_pitch + hcol;
  const bool warm = walk && walk->warm;

  // row t of the segment that starts at element seg0
  const auto load = [&](int64_t seg0, int t) {
    const int64_t e = seg0 + t;
    return hcol >= 0 && t < w && e < n_el ? hc[e * h_pitch] : ~0ull;
  };
  const auto fold = [&](const uint64_t (&k)[kRows], uint32_t a0) {
    KeyArg m = none;
#pragma unroll
    for (int r = 0; r < kRows; ++r) m = left_wins(m, KeyArg{k[r], a0 + r});
    return m;
  };

  if (S == 1 && walk) {
    // one pass a block of windows: the rows of segment b + 1, and both scans
    // of their group minima behind one barrier, serve the next block too
    const int t0 = g * kRows;
    sink.prefetch(t0);
    uint64_t kb[kRows], kn[kRows];
    uint32_t ab[kRows];
    KeyArg suf;
    if (warm) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) kb[r] = walk->key[r];
      suf = walk->suf;
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) kb[r] = load(base, t0 + r);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) kn[r] = load(base + w, t0 + r);
    // (a buffer of the other turn: the scans below write this turn's at once)
    if (!warm)
      suf = block_exclusive<T, false>(fold(kb, (uint32_t)t0), sm.buf[2 * (~b & 1)], nullptr);
#pragma unroll
    for (int r = kRows - 1; r >= 0; --r) {
      if (kb[r] <= suf.key) suf = {kb[r], (uint32_t)(t0 + r)};  // further left: wins ties
      kb[r] = suf.key;
      ab[r] = suf.arg;
    }
    KeyArg pre;
    block_both<T>(fold(kn, (uint32_t)(w + t0)), sm.buf[2 * (b & 1)], sm.buf[2 * (b & 1) + 1], pre,
                  suf);
    walk->warm = true;
    walk->suf = {suf.key, suf.arg == kNone ? kNone : suf.arg - w};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint64_t v = kn[r];
      walk->key[r] = v;
      if (pre.key < kb[r]) {  // the suffix holds the earlier rows: it wins ties
        kb[r] = pre.key;
        ab[r] = pre.arg;
      }
      if (v < pre.key) pre = {v, (uint32_t)(w + t0 + r)};
    }
    sink.windows(t0, kb, ab);
    return;
  }

  if (S > 1) {
    // sub-tile minima of segment b, unless the block before noted them as its
    // segment b + 1 went by; then the minimum over the sub-tiles after each
    if (!warm) {
      for (int s = 0; s < S; ++s) {
        const int t0 = s * Q + g * kRows;
        uint64_t k[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) k[r] = load(base, t0 + r);
        KeyArg tot;
        block_exclusive<T, true>(fold(k, (uint32_t)t0), sm.buf[s & 1], &tot);
        if (g == 0) {
          noted_key[s * T + col] = tot.key;
          noted_arg[s * T + col] = tot.arg;
        }
      }
    }
    __syncthreads();
    if (g == 0) {
      KeyArg run = none;
      for (int s = S - 1; s >= 0; --s) {
        sub_key[s * T + col] = run.key;
        sub_arg[s * T + col] = run.arg;
        run = left_wins(KeyArg{noted_key[s * T + col], noted_arg[s * T + col]}, run);
      }
    }
    __syncthreads();
  }

  KeyArg before = none;  // minimum over the earlier sub-tiles of segment b + 1
  for (int s = 0; s < S; ++s) {
    const int t0 = s * Q + g * kRows;
    sink.prefetch(t0);
    uint64_t kb[kRows], kn[kRows];
    uint32_t ab[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) kb[r] = load(base, t0 + r);
#pragma unroll
    for (int r = 0; r < kRows; ++r) kn[r] = load(base + w, t0 + r);

    // suffix minima of the thread's rows of segment b, in place; segment
    // b + 1 is still on its way
    KeyArg suf = block_exclusive<T, false>(fold(kb, (uint32_t)t0), sm.buf[0], nullptr);
    if (S > 1) suf = left_wins(suf, KeyArg{sub_key[s * T + col], sub_arg[s * T + col]});
#pragma unroll
    for (int r = kRows - 1; r >= 0; --r) {
      if (kb[r] <= suf.key) suf = {kb[r], (uint32_t)(t0 + r)};  // further left: wins ties
      kb[r] = suf.key;
      ab[r] = suf.arg;
    }

    // window t = suffix [t, w) of segment b + prefix [0, t) of segment b + 1
    KeyArg tot = none;
    KeyArg pre = block_exclusive<T, true>(fold(kn, (uint32_t)(w + t0)), sm.buf[1],
                                          S > 1 ? &tot : nullptr);
    pre = left_wins(before, pre);
    before = left_wins(before, tot);
    if (S > 1 && walk && g == 0) {  // segment b + 1 is the next block's segment b
      noted_key[s * T + col] = tot.key;
      noted_arg[s * T + col] = tot.arg == kNone ? kNone : tot.arg - w;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint64_t v = kn[r];
      if (pre.key < kb[r]) {  // the suffix holds the earlier rows: it wins ties
        kb[r] = pre.key;
        ab[r] = pre.arg;
      }
      if (v < pre.key) pre = {v, (uint32_t)(w + t0 + r)};
    }
    sink.windows(t0, kb, ab);
  }
  if (walk) walk->warm = true;
}

}  // namespace split

}  // namespace vanherk
