// Stream compaction of the general sketch path: the valid k-mers of a batch
// with N runs, and a dead slot between records, laid out by rank in the
// chunks the window kernels read; and, after the window kernels, the genomic
// positions of the emitted ranks.
//
// Replaces: the re-chunk maps of ntjoin_tpu/ops/sketch_pallas.py
// _sketch_fused_general (_diff :1562, _colcum :1584, _stream :1605; XLA code,
// no TPU kernel).  In PyTorch the same step was nonzero, take and five strided
// copies: 4.5 ms of the general path's 7.2 ms call on phase A's 100 Mbp draft
// on an NVIDIA H100 (PERF.md), hence a kernel.
//
// Contract (plain version: ntjoin_tpu_torch/ops/sketch_general.py,
// stream_batch and decode_ranks on a CPU tensor or with plain).  Input: the
// hash layout of hash_batch, (off + L, C) arrays of int64 hashes h and 0/1
// int8 valid flags val with row pitches h_pitch and v_pitch; row off + r of
// column c is the k-mer that starts at genomic position p = c*L + r, for
// p < N = n - k + 1.  Position p is kept when its k-mer is valid or when
// p + 1 = starts[i] for some i >= 1 (the dead slot before every record after
// the first, whose k-mer is never valid; starts ascends, starts[0] = 0).  The
// kept positions in ascending order are the stream, rank q for the q-th.  A
// tile is 32 rows of one column, rows [32t, 32t + 32) of column c, entry
// c*T + t with T = ceil(L / 32).  Four passes:
//   count:  counts[0] = 0 and counts[1 + c*T + t] = the kept positions of
//           tile (c, t), int64.  The caller's prefix sum of counts gives
//           firsts, the rank of each tile's first kept position, then S.
//   gather: hflat[q] = rank q's hash, vflat[q] = 1 (0 at a dead slot).
//   chunks: element e of the stream's chunk layout, column e / Ls, row e % Ls
//           of (Ls + w - 1, Cs) arrays hs (int64) and vs (int8), and also row
//           Ls + e % Ls of column e / Ls - 1 where e % Ls < w - 1 (the halo),
//           is hflat[e] and vflat[e] for e < S, else -1 and 0.  Columns past
//           Cs are not touched.
//   decode: pos[e] = the genomic position of rank ranks[e], for E ranks < S.
//
// What bounds it on an H100: memory.  It must read the flags (1 byte a
// position) and the kept hashes (8 bytes a rank), write 8 + 1 bytes a rank
// of chunks plus the halo, and decode the ranks the window kernels emit,
// about 2S / (w + 1).  No pass makes a position for every rank: a rank's
// position is found from its tile's first rank and the tile's 32 flags.
// Every tile is independent of every other once the scan has given its first
// rank, so no pass carries a rank down a column and none of count, gather and
// decode has a block barrier.  count streams the flags: a thread adds the 32
// rows of a tile of 16 neighbouring columns as 16-byte words (0/1 bytes over
// 32 rows cannot carry from one byte to the next), a warp's lanes lie down
// 16 tiles of two groups so that a column's counts are one store, and the
// dead slots are added afterwards, one atomic each, by a second launch of the
// same pass.  gather gives a warp a tile of 32 columns x 32 rows: lane j
// reads row j's 32 flags in two 16-byte loads, so a ballot of one byte over
// the lanes is a column's kept rows; the warp loads the hashes row by row
// (256 bytes a load) into its own shared memory; a column's kept rows take
// its tile's first rank plus a population count, so a warp's stores are
// runs of consecutive ranks.  The input and the output are both laid out
// column after column in row-major arrays, with columns of different
// lengths, so a kept k-mer's column and row in one have no simple relation to
// those in the other, and the stream goes through rank order: chunks is a
// transpose of rank order into the chunk layout through tiles of 32 x 32 in
// shared memory (a design that wrote the chunks straight from a column
// walk, its 8-byte stores landing on 32 rows at once, was slower than the
// PyTorch version).  gather and chunks hand the tiles of a group of columns
// to neighbouring warps (blocks) in order down the columns, so that the work
// in flight touches neighbouring runs of ranks: across the columns each
// took 7-60% longer on an H100.
// decode is a thread a rank: a binary search of the first ranks, the tile's
// 32 flags and dead slots, and the j-th kept row.  Dead slots are found by a
// binary search of starts at a tile's first row.  Ranks and positions are
// int64: n reaches 2^31.  On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md),
// phase A's 100 Mbp draft at w=1000: count with its scan and sync 0.14 ms,
// gather 0.68, chunks 0.75, decode 0.09, where the passes of a design that
// carried each rank down a column segment and wrote a position for every
// rank took 0.37, 0.99, 0.80 and 0.50.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;       // rows of a tile: a bit each of a 32-bit mask
constexpr int kCountCols = 16;  // columns of a count thread: a 16-byte load a row
constexpr int kThreads = 256;
constexpr int kGatherWarps = 4, kGatherThreads = 32 * kGatherWarps;

struct Layout {
  const int8_t* val;  // row off of val
  int64_t v_pitch, L, C, N;
  const int64_t* starts;
  int64_t n_starts;
  int64_t T;  // tiles a column
};

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) { return x < y ? x : y; }
__device__ __forceinline__ int64_t max64(int64_t x, int64_t y) { return x > y ? x : y; }

// Rows of tile (c, r0 / 32) that hold a position below N.
__device__ __forceinline__ int tile_rows(const Layout& a, int64_t c, int64_t r0) {
  return (int)max64(0, min64(kTile, min64(a.L - r0, a.N - c * a.L - r0)));
}

__device__ __forceinline__ uint32_t low_bits(int n) { return n >= 32 ? ~0u : (1u << n) - 1; }

// The bytes of a 32-bit word that hold the first n of 4 columns.
__device__ __forceinline__ uint32_t byte_mask(int n) {
  return n <= 0 ? 0u : n >= 4 ? ~0u : (1u << (8 * n)) - 1;
}

// The dead slots among positions [p0, p0 + rows): bit d for p0 + d.
__device__ uint32_t dead_bits(const Layout& a, int64_t p0, int rows) {
  int64_t lo = 1, hi = a.n_starts;  // the least i >= 1 with starts[i] - 1 >= p0
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a.starts[mid] - 1 < p0) lo = mid + 1;
    else hi = mid;
  }
  uint32_t m = 0;
  for (; lo < a.n_starts; ++lo) {
    const int64_t d = a.starts[lo] - 1 - p0;
    if (d >= rows) break;
    m |= 1u << d;
  }
  return m;
}

// A thread a tile of 16 neighbouring columns: their valid k-mers.  A warp's
// lanes take 16 tiles down two neighbouring groups of 16 columns, so that a
// load of two lanes is a whole 32-byte sector of a row and a column's counts
// of 16 tiles are one 128-byte store.
__global__ void __launch_bounds__(kThreads)
    count_kernel(Layout a, int64_t groups, int64_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int64_t wid = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t pairs = (groups + 1) / 2;
  if (wid == 0 && lane == 0) counts[0] = 0;
  if (wid >= pairs * ((a.T + 15) / 16)) return;  // the whole warp
  const int64_t g = (wid % pairs) * 2 + (lane & 1), t = (wid / pairs) * 16 + (lane >> 1);
  if (g >= groups || t >= a.T) return;
  const int64_t c0 = g * kCountCols, r0 = t * kTile;
  const int rows = (int)min64(kTile, a.L - r0);
  // some column's rows pass N: mask its bytes row by row
  const bool tail = (c0 + kCountCols - 1) * a.L + r0 + rows > a.N;
  const int8_t* v = a.val + r0 * a.v_pitch + c0;
  uint32_t s[4] = {0, 0, 0, 0};
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    if (r >= rows) break;
    const uint4 x = __ldcs(reinterpret_cast<const uint4*>(v + r * a.v_pitch));
    uint32_t m[4] = {~0u, ~0u, ~0u, ~0u};
    if (tail) {  // column c0 + b holds position (c0 + b) * L + r0 + r
      const int64_t lim = a.N - r0 - r;
      const int64_t nb = (lim > 0 ? (lim + a.L - 1) / a.L : 0) - c0;
      const int n = (int)max64(0, min64(kCountCols, nb));
#pragma unroll
      for (int k = 0; k < 4; ++k) m[k] = byte_mask(n - 4 * k);
    }
    s[0] += x.x & m[0];
    s[1] += x.y & m[1];
    s[2] += x.z & m[2];
    s[3] += x.w & m[3];
  }
#pragma unroll
  for (int b = 0; b < kCountCols; ++b) {
    const int64_t c = c0 + b;
    if (c < a.C) counts[1 + c * a.T + t] = (s[b >> 2] >> (8 * (b & 3))) & 0xff;
  }
}

// A thread a dead slot: one more kept position in its tile.
__global__ void __launch_bounds__(kThreads) dead_kernel(Layout a, int64_t* counts) {
  const int64_t i = 1 + (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_starts) return;
  const int64_t p = a.starts[i] - 1;
  if (p < 0 || p >= a.N) return;
  atomicAdd(reinterpret_cast<unsigned long long*>(counts + 1 + (p / a.L) * a.T + (p % a.L) / kTile),
            1ull);
}

// A warp a tile of 32 columns x 32 rows: the tiles of a group of 32 columns
// go to neighbouring warps in order down the columns, so that the warps in
// flight write neighbouring runs of ranks.  The warp loads the tile's hashes
// row by row (lane = column, 256 bytes a load) into its own shared memory.
__global__ void __launch_bounds__(kGatherThreads)
    gather_kernel(Layout a, const int64_t* __restrict__ h, int64_t h_pitch,
                  const int64_t* __restrict__ firsts, int64_t groups,
                  int64_t* __restrict__ hflat, int8_t* __restrict__ vflat) {
  __shared__ int64_t ht[kGatherWarps][kTile][33];  // [row][column]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t wid = (int64_t)blockIdx.x * kGatherWarps + warp;
  if (wid >= groups * a.T) return;
  const int64_t c0 = (wid / a.T) * 32, t = wid % a.T, r0 = t * kTile;
  const int64_t c = c0 + lane;  // the column whose facts this lane holds
  const bool col = c < a.C;
  const int trows = (int)min64(kTile, a.L - r0);
  // every load first: the column's first rank, the row's 32 flags (lane =
  // row), the tile's hashes (lane = column)
  const int64_t q = col ? firsts[c * a.T + t] : 0;
  uint4 f0 = make_uint4(0, 0, 0, 0), f1 = f0;
  if (lane < trows) {
    const int8_t* v = a.val + (r0 + lane) * a.v_pitch + c0;
    f0 = *reinterpret_cast<const uint4*>(v);
    if (c0 + 16 < a.C) f1 = *reinterpret_cast<const uint4*>(v + 16);
  }
  int64_t x[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) x[r] = r < trows && col ? h[(r0 + r) * h_pitch + c] : 0;
  // lane = column: its rows below N and its dead slots
  const int rows = col ? tile_rows(a, c, r0) : 0;
  const uint32_t live = low_bits(rows);
  const uint32_t dead = rows ? dead_bits(a, c * a.L + r0, rows) : 0u;
#pragma unroll
  for (int r = 0; r < kTile; ++r) ht[warp][r][lane] = x[r];
  __syncwarp();
  const uint32_t fw[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
  const uint32_t below = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < 32; ++j) {  // column c0 + j; lane = row
    const bool fl = (fw[j >> 2] >> (8 * (j & 3)) & 0xff) != 0;
    const uint32_t m = (__ballot_sync(~0u, fl) | __shfl_sync(~0u, dead, j)) &
                       __shfl_sync(~0u, live, j);
    if (m == 0) continue;  // the same for the whole warp
    const int64_t qj = __shfl_sync(~0u, q, j);
    if (m >> lane & 1) {
      const int64_t rank = qj + __popc(m & below);
      hflat[rank] = ht[warp][lane][j];
      vflat[rank] = fl;  // a dead slot's k-mer is never valid
    }
  }
}

// Rank order into the chunk layout, a tile of 32 columns x 32 rows a block;
// the tiles of a group of 32 columns go to neighbouring blocks in order down
// the rows, so that the blocks in flight read neighbouring runs of ranks.
__global__ void __launch_bounds__(kThreads)
    chunks_kernel(const int64_t* __restrict__ hflat, const int8_t* __restrict__ vflat, int64_t S,
                  int64_t Ls, int64_t Cs, int64_t rows, int64_t* __restrict__ hs,
                  int64_t hs_pitch, int8_t* __restrict__ vs, int64_t vs_pitch,
                  int64_t row_tiles) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int64_t ht[32][33];  // [column][row]
  __shared__ int32_t vt[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t c0 = ((int64_t)blockIdx.x / row_tiles) * 32;
  const int64_t r0 = ((int64_t)blockIdx.x % row_tiles) * 32;
#pragma unroll
  for (int k = 0; k < 32 / kWarps; ++k) {
    const int j = warp + kWarps * k;
    const int64_t e = (c0 + j) * Ls + r0 + lane;  // rows past Ls run into the next chunk
    const bool in = c0 + j < Cs && r0 + lane < rows && e < S;
    ht[j][lane] = in ? hflat[e] : -1;
    vt[j][lane] = in ? vflat[e] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 32 / kWarps; ++k) {
    const int i = warp + kWarps * k;
    const int64_t r = r0 + i, c = c0 + lane;
    if (r < rows && c < Cs) {
      hs[r * hs_pitch + c] = ht[lane][i];
      vs[r * vs_pitch + c] = (int8_t)vt[lane][i];
    }
  }
}

// A thread a rank: the last tile whose first rank is at most the rank, then
// the tile's kept rows.
__global__ void __launch_bounds__(kThreads)
    decode_kernel(Layout a, const int64_t* __restrict__ firsts,
                  const int64_t* __restrict__ ranks, int64_t E, int64_t* __restrict__ pos) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  const int64_t q = ranks[e];
  int64_t lo = 0, hi = a.C * a.T;  // firsts[lo] <= q < firsts[hi] = S
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) >> 1;
    if (firsts[mid] <= q) lo = mid;
    else hi = mid;
  }
  const int64_t c = lo / a.T, r0 = (lo % a.T) * kTile, p0 = c * a.L + r0;
  const int rows = tile_rows(a, c, r0);
  const int8_t* v = a.val + r0 * a.v_pitch + c;
  uint32_t m = 0;
#pragma unroll
  for (int r = 0; r < kTile; ++r)
    if (r < rows && v[r * a.v_pitch] != 0) m |= 1u << r;
  m |= dead_bits(a, p0, rows);
  for (int64_t j = q - firsts[lo]; j > 0; --j) m &= m - 1;  // drop the kept rows before q's
  pos[e] = p0 + __ffs(m) - 1;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int layout(const void* val, int64_t v_pitch, int64_t off, int64_t L, int64_t C, int64_t N,
           const void* starts, int64_t n_starts, Layout* a) {
  if (L < 1 || C < 1 || N < 0 || N > C * L || n_starts < 1 || v_pitch < C || v_pitch % 16 ||
      !aligned16(val))
    return (int)cudaErrorInvalidValue;
  *a = Layout{(const int8_t*)val + off * v_pitch, v_pitch, L, C, N, (const int64_t*)starts,
              n_starts, (L + kTile - 1) / kTile};
  return 0;
}

int launch_error(int64_t blocks) {
  return blocks > INT32_MAX ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

// counts int64 (C * T + 1): 0, then each tile's kept positions.  Two
// launches: the flags, then the dead slots.
extern "C" int nj_stream_count(const void* val, int64_t v_pitch, int64_t off, int64_t L,
                               int64_t C, int64_t N, const void* starts, int64_t n_starts,
                               void* counts, void* stream) {
  Layout a;
  if (int err = layout(val, v_pitch, off, L, C, N, starts, n_starts, &a)) return err;
  const int64_t groups = (C + kCountCols - 1) / kCountCols;
  const int64_t warps = (groups + 1) / 2 * ((a.T + 15) / 16);
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (int err = launch_error(blocks)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  count_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(a, groups, (int64_t*)counts);
  if (n_starts > 1) {
    dead_kernel<<<(unsigned)((n_starts - 1 + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        a, (int64_t*)counts);
  }
  return (int)cudaGetLastError();
}

// firsts int64 (C * T + 1): each tile's first rank, then S.  hflat int64
// (S), vflat int8 (S).
extern "C" int nj_stream_gather(const void* h, int64_t h_pitch, const void* val,
                                int64_t v_pitch, int64_t off, int64_t L, int64_t C, int64_t N,
                                const void* starts, int64_t n_starts, const void* firsts,
                                void* hflat, void* vflat, void* stream) {
  Layout a;
  if (int err = layout(val, v_pitch, off, L, C, N, starts, n_starts, &a)) return err;
  if (h_pitch < C || h_pitch % 2 || !aligned16(h)) return (int)cudaErrorInvalidValue;
  const int64_t groups = (C + 31) / 32;
  const int64_t blocks = (groups * a.T + kGatherWarps - 1) / kGatherWarps;
  if (int err = launch_error(blocks)) return err;
  gather_kernel<<<(unsigned)blocks, kGatherThreads, 0, (cudaStream_t)stream>>>(
      a, (const int64_t*)h + off * h_pitch, h_pitch, (const int64_t*)firsts, groups,
      (int64_t*)hflat, (int8_t*)vflat);
  return (int)cudaGetLastError();
}

// hs, vs (Ls + w - 1, Cs) with pitches hs_pitch, vs_pitch.
extern "C" int nj_stream_chunks(const void* hflat, const void* vflat, int64_t S, int64_t Ls,
                                int64_t Cs, int w, void* hs, int64_t hs_pitch, void* vs,
                                int64_t vs_pitch, void* stream) {
  if (w < 1 || Ls < 1 || Cs < 1 || S < 0 || S > Cs * Ls) return (int)cudaErrorInvalidValue;
  const int64_t rows = Ls + w - 1, row_tiles = (rows + 31) / 32;
  const int64_t blocks = (Cs + 31) / 32 * row_tiles;
  if (int err = launch_error(blocks)) return err;
  chunks_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)hflat, (const int8_t*)vflat, S, Ls, Cs, rows, (int64_t*)hs, hs_pitch,
      (int8_t*)vs, vs_pitch, row_tiles);
  return (int)cudaGetLastError();
}

// ranks int64 (E), each below S; pos int64 (E).
extern "C" int nj_stream_decode(const void* val, int64_t v_pitch, int64_t off, int64_t L,
                                int64_t C, int64_t N, const void* starts, int64_t n_starts,
                                const void* firsts, const void* ranks, int64_t E, void* pos,
                                void* stream) {
  Layout a;
  if (int err = layout(val, v_pitch, off, L, C, N, starts, n_starts, &a)) return err;
  if (E < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (E + kThreads - 1) / kThreads;
  if (int err = launch_error(blocks)) return err;
  decode_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, (const int64_t*)firsts, (const int64_t*)ranks, E, (int64_t*)pos);
  return (int)cudaGetLastError();
}
