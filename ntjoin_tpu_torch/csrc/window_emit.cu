// Kernel 2 of the minimizer sketch: windowed argmin with the emission step
// and per-chunk compaction.
//
// Replaces: ntjoin_tpu/ops/sketch_pallas.py, _window_emit_kernel (launched by
// _window_emit_chunked).  The TPU kernel ran Van Herk over 128-lane tiles and
// packed emissions into 31 slots per (lane, w-block), with equal-hash runs
// compressed; here each chunk appends its emissions to its own
// capacity-bounded list.  Runs are not compressed: a repeat-dense chunk
// overflows its list, the count says so, and the caller runs the exact kernel
// (window.cu) over the chunks that overflowed.
//
// Contract (plain version: ntjoin_tpu_torch/ops/sketch_cuda.py,
// window_emit_ref).  For chunk c and window j in [0, L), with flags[j, c]
// bit0 = window valid (all w k-mers valid) and bit1 = force (first valid
// window of a record), window j emits when it is valid and either forced or
// its argmin differs from window j-1's.  Emission i of the chunk, if i < cap,
// lands in pos[i, c] = c*L + s (the k-mer start in the stream) and
// hsh[i, c] = its canonical hash; slots past the emissions hold -1 and 0.
// count[c] is the true number of emissions, which may exceed cap.  h and
// flags have row pitches h_pitch and f_pitch (elements); pos and hsh are
// (cap, C) without padding.
//
// What bounds it on an H100: memory (8 B of hash and 1 B of flags read per
// window; emissions are ~2 per w windows).  Two routes, chosen by the wrapper
// from w alone, this file's and window_emit_gmem.cu's:
//
// nj_window_emit (shared memory).  A thread block owns a tile of T
// neighbouring chunks and walks their blocks of w windows in order.  The rows
// are staged once, by 16-byte `cp.async` (hence the pitch), into a ring of
// three w-row segments: block b works on segments b and b+1 while b+2 loads;
// the block's flags are staged the same way, a pass ahead of their use.  Some
// warps of the thread block do nothing but stage, so that starting the copies
// never holds a working thread, and the thread blocks are persistent: each
// walks many tiles with the ring running on, so a tile's first segment loads
// under the last block of the tile before.
// G working threads per chunk split a segment's rows: group minima, a
// warp scan across the groups of each chunk (vanherk.cuh, tile), then each
// thread turns its rows of segment b into suffix minima in place and combines
// them with the running prefix minimum of segment b+1, leaving each window's
// argmin as a 16-bit offset inside the two segments.  A second pass decides
// the emissions (the first window of a group takes `prev` from its
// neighbour's last, the first of a block from the block before), a warp scan
// of the counts gives every thread its slot in the chunk's list, and the few
// threads that emit write.  No scratch in device memory, every hash read
// once.
// T is the widest of 8, 4, 2, 1 whose segments fit (27 bytes a row and chunk:
// w <= 1,014, 2,090, 4,242, 8,362).  Tiles of 8, 4 and 2 have 64 row groups a
// chunk and four loader warps.  A tile of one chunk (w > 4,242, where chunks
// are few and long) gets the parallelism from inside the chunk: 256 row
// groups, eight a lane in the scans, and eight loader warps, because its rows
// arrive as lone 8-byte hashes and lone flag bytes, one 32-byte sector
// each, four and 32 neighbouring thread blocks sharing a sector through L2.
// A row of one or two flag bytes is below what `cp.async` copies, so there the
// loaders fetch the flags with plain loads, and before they start the copies
// of the segment ahead: this block's emission pass waits for the flags, the
// segment only has to land by the next block.
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), 2^27 bases: tiles of 8 at
// w=1000 1.35 ms against 6.1 ms for one thread per chunk and a bound of
// 0.44 ms; staging and arithmetic take about as long as each other and
// overlap only in part.  Tiles of 1 at w=5000 2.7 ms against 26.4 ms for one
// thread per chunk, bound 0.44 ms: arithmetic alone 1.4 ms, staging the
// hashes alone 1.4 ms, staging with the flags 2.4 ms.  What costs is the
// number of sectors asked for, not the bytes: the flags, one useful byte a
// sector, take a millisecond however they are fetched (plain loads, 4-byte
// copies, more loaders, a crew of loaders of their own), and narrower tiles
// are slower at equal bytes (tiles of 4 at w=2000 1.9 ms, of 2 at w=4000 3.3
// ms).
//
// nj_window_emit_gmem (device memory, window_emit_gmem.cu).  Any w; serves
// the w above 8,362, whose segments no tile holds.
#include <type_traits>

#include "vanherk.cuh"

namespace {

// -- shared-memory route ----------------------------------------------------------

using vanherk::tile::KeyArg;
using vanherk::tile::kNoArg;
using vanherk::tile::left_wins;

constexpr uint32_t kEmit = 0x8000;  // top bit of a window's 16-bit argmin offset

// Row groups (working threads) per chunk of a tile of T chunks: a one-chunk
// tile has only its own rows to spread over the SM's warps.  emit_groups in
// sketch_cuda.py says the same.
template <int T>
constexpr int kGroupsOf = T == 1 ? 256 : 64;

// Shared memory of one block, in bytes; the kernel carves it in this order.
__host__ __device__ constexpr size_t tile_smem_bytes(int w, int T, int G) {
  return 8 * ((size_t)3 * w * T + 2 * G * T)  // ring; group minima; suffix carries
         + 4 * ((size_t)G * T + 2 * T)        // counts; running count and prev per chunk
         + 2 * ((size_t)w * T + 3 * G * T)    // window argmins; args; groups' last argmins
         + (size_t)w * T;                     // the block's flags
}

template <int N>  // N = 4 or 8 bytes, both sides aligned to N
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(__cvta_generic_to_global(gmem)), "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(__cvta_generic_to_global(gmem))
               : "memory");
}

// Threads that do nothing but stage: four warps, eight for a one-chunk tile,
// whose rows come as lone 8-byte hashes and lone flag bytes.
template <int T>
constexpr int kLoadersOf = T == 1 ? 256 : 128;

// Named barriers: 0 is __syncthreads (everyone); kWorkBar the working threads
// among themselves; kSegBar and kFlagBar the loaders' "segment b+1 has
// landed" and "the flags have landed" (loaders arrive, workers wait).
constexpr int kWorkBar = 1, kSegBar = 2, kFlagBar = 3;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int T, int G>
__global__ void __launch_bounds__(G* T + kLoadersOf<T>, 1)
    window_emit_tile_kernel(const uint64_t* __restrict__ h, int64_t h_pitch,
                            const int8_t* __restrict__ flags, int64_t f_pitch, int64_t L,
                            int64_t C, int w, int64_t off, int64_t cap,
                            int64_t* __restrict__ pos, uint64_t* __restrict__ hsh,
                            int64_t* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int GT = G * T;               // working threads; the loaders come after them
  constexpr int P = G / 32;               // groups of a column that one lane scans
  constexpr int kLoaders = kLoadersOf<T>;
  constexpr int kAll = GT + kLoaders;
  const int tid = threadIdx.x, col = tid % T, g = tid / T;
  const int warp = tid / 32, lane = tid % 32;
  const bool loader = tid >= GT;
  const int64_t n_tiles = (C + T - 1) / T;
  const int64_t n_el = L + w - 1;
  const int nb = (int)((L + w - 1) / w);  // blocks of windows; segments 0..nb
  // rows [t_lo, t_hi) of every segment are this thread's; an odd group
  // length keeps the groups of a warp on different banks
  const int q = ((w + G - 1) / G) | 1;
  const int t_lo = min(g * q, w), t_hi = min(t_lo + q, w);

  uint64_t* ring = reinterpret_cast<uint64_t*>(smem);  // 3 segments of (w, T)
  uint64_t* gm_k = ring + (size_t)3 * w * T;           // (G, T) minima, then prefix carries
  uint64_t* suf_k = gm_k + GT;                         // (G, T) suffix carries
  int32_t* cnt = reinterpret_cast<int32_t*>(suf_k + GT);  // (G, T) counts, then slots
  int32_t* running = cnt + GT;                         // (T) emissions of the chunk so far
  int32_t* prev_s = running + T;                       // (T) argmin of the block's last window
  uint16_t* am = reinterpret_cast<uint16_t*>(prev_s + T);  // (w, T) argmin offsets
  uint16_t* gm_a = am + (size_t)w * T;                 // args of gm_k
  uint16_t* suf_a = gm_a + GT;                         // args of suf_k
  uint16_t* last_am = suf_a + GT;                      // (G, T) argmin of a group's last window
  int8_t* sflags = reinterpret_cast<int8_t*>(last_am + GT);  // (w, T) flags of the block
  constexpr bool kCopyFlags = T >= 4;                  // a row's T flag bytes in one asynchronous copy

  // Segments are numbered through the block's tiles (nb + 1 a tile), and
  // segment n lives in buffer n % 3: a tile's first segment then falls into
  // the buffer that the tile before frees first.
  auto buffer = [&](int64_t n) { return ring + (size_t)(n % 3) * w * T; };

  // Loaders: stage segment seg of the tile at column tile0 into buffer n
  // (elements [seg*w, seg*w + w), clamped to the last one: no window below L
  // reaches a clamped row).
  auto load_segment = [&](int64_t tile0, int seg, int64_t n) {
    constexpr int kPieces = T == 1 ? 1 : T / 2;  // pieces of a row: 16 bytes, or a lone hash
    uint64_t* dst = buffer(n);
    for (int i = tid - GT; i < w * kPieces; i += kLoaders) {
      const int row = i / kPieces, piece = i % kPieces;
      int64_t e = (int64_t)seg * w + row;
      if (e > n_el - 1) e = n_el - 1;
      if constexpr (T == 1) {
        cp_async_small<8>(dst + row, h + (off + e) * h_pitch + tile0);
      } else {
        cp_async16(dst + row * T + piece * 2, h + (off + e) * h_pitch + tile0 + piece * 2);
      }
    }
  };

  // Loaders: flags of block b's windows (rows clamped to the last window).  A
  // row of a narrow tile has fewer flag bytes than an asynchronous copy
  // takes: the loaders fetch those themselves, with plain loads.
  auto load_flags = [&](int64_t tile0, int b) {
    const auto row = [&](int t) {
      int64_t j = (int64_t)b * w + t;
      if (j > L - 1) j = L - 1;
      return flags + j * f_pitch + tile0;
    };
    if constexpr (kCopyFlags) {
      for (int t = tid - GT; t < w; t += kLoaders) cp_async_small<T>(sflags + t * T, row(t));
    } else {
      using Row = std::conditional_t<T == 2, int16_t, int8_t>;  // T bytes
#pragma unroll 8
      for (int t = tid - GT; t < w; t += kLoaders)
        reinterpret_cast<Row*>(sflags)[t] = *reinterpret_cast<const Row*>(row(t));
      __threadfence_block();
    }
  };

  // Workers: group minima of a staged segment and their scans; the prefix
  // carries replace the minima in gm_*, the suffix carries go to suf_*.
  auto scan_segment = [&](const uint64_t* s) {
    KeyArg m{~0ull, kNoArg};
    if (t_lo < t_hi) m = {s[t_lo * T + col], (uint32_t)t_lo};
#pragma unroll 4
    for (int t = t_lo + 1; t < t_hi; ++t) m = left_wins(m, {s[t * T + col], (uint32_t)t});
    gm_k[g * T + col] = m.key;
    gm_a[g * T + col] = (uint16_t)m.arg;
    bar_sync(kWorkBar, GT);
    if (warp < T) {  // warp c scans the groups of column c, P neighbours a lane
      KeyArg v[P], pre[P], suf[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int i = (P * lane + p) * T + warp;
        v[p] = {gm_k[i], gm_a[i]};
      }
      vanherk::tile::scan_groups<P>(v, lane, pre, suf);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int i = (P * lane + p) * T + warp;
        gm_k[i] = pre[p].key, gm_a[i] = (uint16_t)pre[p].arg;
        suf_k[i] = suf[p].key, suf_a[i] = (uint16_t)suf[p].arg;
      }
    }
    bar_sync(kWorkBar, GT);
  };

  // The loaders stage and wait, so that starting the copies never holds a
  // worker; they meet the workers at the top of every block of windows.  A
  // block of threads walks its tiles with the ring running on: during a
  // tile's last block of windows the next tile's first segment loads.
  if (loader && blockIdx.x < n_tiles) {
    load_segment((int64_t)blockIdx.x * T, 0, 0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  int64_t n0 = 0;  // number of the tile's segment 0
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, n0 += nb + 1) {
    const int64_t tile0 = tile * T, chunk = tile0 + col;
    const bool more = tile + gridDim.x < n_tiles;
    for (int b = 0; b < nb; ++b) {
      __syncthreads();  // segment b has landed (b+1 too, past b = 0); the step before is done
      if (loader) {
        const auto load_ahead = [&] {  // the segment two ahead, or the next tile's first
          if (b + 2 <= nb) {
            load_segment(tile0, b + 2, n0 + b + 2);
          } else if (more) {
            load_segment((tile + gridDim.x) * T, 0, n0 + nb + 1);
          }
        };
        if constexpr (kCopyFlags) {
          // three groups, oldest first: segment b+1 (empty past b = 0), the
          // flags, and the segment ahead
          if (b == 0) load_segment(tile0, 1, n0 + 1);
          asm volatile("cp.async.commit_group;\n" ::: "memory");
          load_flags(tile0, b);
          asm volatile("cp.async.commit_group;\n" ::: "memory");
          load_ahead();
          asm volatile("cp.async.commit_group;\n" ::: "memory");
          asm volatile("cp.async.wait_group 2;\n" ::: "memory");
          bar_arrive(kSegBar, kAll);
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
          bar_arrive(kFlagBar, kAll);
        } else {
          // the flags by hand, and before the segment ahead: this block's
          // emission pass waits for them, the segment only has to land by
          // the next block.  Segment b+1 landed a block ago, except at b = 0,
          // where the flags are fetched under its flight.
          if (b == 0) {
            load_segment(tile0, 1, n0 + 1);
            asm volatile("cp.async.commit_group;\n" ::: "memory");
          } else {
            bar_arrive(kSegBar, kAll);
          }
          load_flags(tile0, b);
          if (b == 0) {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
            bar_arrive(kSegBar, kAll);
          }
          bar_arrive(kFlagBar, kAll);
          load_ahead();
          asm volatile("cp.async.commit_group;\n" ::: "memory");
        }
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        continue;
      }

      uint64_t* cur = buffer(n0 + b);
      const uint64_t* nxt = buffer(n0 + b + 1);
      const int32_t base = b * w;  // element of the block's first window
      if (b == 0) {
        if (tid < T) {
          running[tid] = 0;
          prev_s[tid] = -1;
        }
        scan_segment(cur);
      }
      if (t_lo < t_hi) {
        // suffix minima of the thread's rows of segment b, in place
        uint64_t key = suf_k[g * T + col];
        uint32_t arg = suf_a[g * T + col];
#pragma unroll 4
        for (int t = t_hi - 1; t >= t_lo; --t) {
          const uint64_t v = cur[t * T + col];
          if (v <= key) {  // the later-scanned row is further left: wins ties
            key = v;
            arg = t;
          }
          cur[t * T + col] = key;
          am[t * T + col] = (uint16_t)arg;
        }
      }
      bar_sync(kSegBar, kAll);
      scan_segment(nxt);  // its first barrier also orders the suffix carries' reuse
      if (t_lo < t_hi) {
        // window t = suffix [t, w) of segment b + prefix [0, t) of segment b+1
        uint64_t pkey = gm_k[g * T + col];
        uint32_t parg = gm_a[g * T + col];
        uint32_t a = 0;
#pragma unroll 4
        for (int t = t_lo; t < t_hi; ++t) {
          a = am[t * T + col];
          if (pkey < cur[t * T + col]) {
            a = w + parg;
            am[t * T + col] = (uint16_t)a;
          }
          const uint64_t v = nxt[t * T + col];
          if (v < pkey) {
            pkey = v;
            parg = t;
          }
        }
        last_am[g * T + col] = (uint16_t)a;
      }
      bar_sync(kFlagBar, kAll);  // the flags are here, and every argmin is written

      // emissions of the thread's windows: count and mark
      const int64_t left = L - (int64_t)b * w;  // windows of this block
      const int hi = (int)min((int64_t)t_hi, left);
      int n = 0, first = 0;
      if (chunk < C && t_lo < hi) {
        int32_t prev = t_lo == 0 ? prev_s[col] : base + last_am[(g - 1) * T + col];
#pragma unroll 4
        for (int t = t_lo; t < hi; ++t) {
          const int8_t f = sflags[t * T + col];
          const uint32_t a = am[t * T + col];
          const int32_t s = base + (int32_t)a;
          if ((f & 1) && ((f & 2) || s != prev)) {
            if (n == 0) first = t;
            ++n;
            am[t * T + col] = (uint16_t)(a | kEmit);
          }
          prev = s;
        }
      }
      cnt[g * T + col] = n;
      bar_sync(kWorkBar, GT);
      if (warp < T) {  // slots of every group's emissions in the chunk's list
        int each[P], pre[P], total;
#pragma unroll
        for (int p = 0; p < P; ++p) each[p] = cnt[(P * lane + p) * T + warp];
        vanherk::tile::scan_counts<P>(each, lane, pre, total);
        const int32_t before = running[warp];
#pragma unroll
        for (int p = 0; p < P; ++p) cnt[(P * lane + p) * T + warp] = before + pre[p];
        if (lane == 0) {
          running[warp] = before + total;
          prev_s[warp] = base + (am[(w - 1) * T + warp] & (kEmit - 1));
        }
      }
      bar_sync(kWorkBar, GT);
      if (n > 0) {  // few threads: walk from the first emission to the last
        int64_t slot = cnt[g * T + col];
        for (int t = first; n > 0 && slot < cap; ++t) {
          uint32_t a = am[t * T + col];
          if (a & kEmit) {
            a &= kEmit - 1;
            pos[slot * C + chunk] = chunk * L + base + a;
            // a suffix minimum equals the row's own hash at its argmin
            hsh[slot * C + chunk] = a < (uint32_t)w ? cur[a * T + col] : nxt[(a - w) * T + col];
            ++slot;
            --n;
          }
        }
      }
    }
    if (loader) continue;
    // the tile's unused slots and counts (running is final since the last scan)
    for (int64_t i = tid; i < cap * T; i += GT) {
      const int64_t slot = i / T, c = tile0 + i % T;
      if (c < C && slot >= running[i % T]) {
        pos[slot * C + c] = -1;
        hsh[slot * C + c] = 0;
      }
    }
    if (tid < T && chunk < C) count[chunk] = running[tid];
  }
}

template <int T>
int launch_tile(const void* h, int64_t h_pitch, const void* flags, int64_t f_pitch, int64_t L,
                int64_t C, int w, int64_t off, int64_t cap, void* pos, void* hsh, void* count,
                void* stream) {
  constexpr int G = kGroupsOf<T>;
  const auto kernel = window_emit_tile_kernel<T, G>;
  const size_t bytes = tile_smem_bytes(w, T, G);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // as many blocks of threads as the card holds at once walk the tiles (one
  // an SM where a tile's segments fill its shared memory)
  int per_sm = 0;
  constexpr int threads = G * T + kLoadersOf<T>;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int64_t n_tiles = (C + T - 1) / T, resident = (int64_t)sms * per_sm;
  const unsigned blocks = (unsigned)(n_tiles < resident ? n_tiles : resident);
  kernel<<<blocks, threads, bytes, (cudaStream_t)stream>>>(
      (const uint64_t*)h, h_pitch, (const int8_t*)flags, f_pitch, L, C, w, off, cap,
      (int64_t*)pos, (uint64_t*)hsh, (int64_t*)count);
  return (int)cudaGetLastError();
}

}  // namespace

// tile: chunks per thread block, 8, 4, 2 or 1 (the widest whose segments
// fit).  h and flags must be 16-byte aligned, with pitches that are multiples
// of 16 elements (whole tiles, rows on copy boundaries).
extern "C" int nj_window_emit(const void* h, int64_t h_pitch, const void* flags,
                              int64_t f_pitch, int64_t L, int64_t C, int w, int64_t off,
                              int64_t cap, int tile, void* pos, void* hsh, void* count,
                              void* stream) {
  switch (tile) {
    case 8:
      return launch_tile<8>(h, h_pitch, flags, f_pitch, L, C, w, off, cap, pos, hsh, count, stream);
    case 4:
      return launch_tile<4>(h, h_pitch, flags, f_pitch, L, C, w, off, cap, pos, hsh, count, stream);
    case 2:
      return launch_tile<2>(h, h_pitch, flags, f_pitch, L, C, w, off, cap, pos, hsh, count, stream);
    case 1:
      return launch_tile<1>(h, h_pitch, flags, f_pitch, L, C, w, off, cap, pos, hsh, count, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
