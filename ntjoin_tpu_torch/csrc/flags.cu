// Window flags of the minimizer sketch: which windows are valid, and which
// are the first valid window after an invalid one.
//
// Replaces: the XLA code of ntjoin_tpu/ops/sketch_pallas.py:1299-1317 that
// builds the `flags` input of _window_emit_chunked (a cumulative sum of the
// k-mer valid flags and its differences; no TPU kernel).  In PyTorch the same
// cumulative sum moved some 5 GB for a function of 0.3 GB and was two thirds
// of the fused sketch call on an NVIDIA H100, hence a kernel.
//
// Contract (plain version: ntjoin_tpu_torch/ops/sketch_cuda.py,
// window_flags_ref).  val (rows, C) int8 holds 1 where the k-mer ending at
// the row is valid; element e of column c is row off + e.  For window j in
// [0, L), flags[j, c] bit0 = all of elements j .. j + w - 1 are valid, bit1 =
// bit0 and (j = 0 or bit0 of window j - 1 is clear).  val and flags have row
// pitches v_pitch and f_pitch (elements).  The pad columns of val up to a
// multiple of 16 are read, and reach only the pad columns of flags, which
// are written.
//
// What bounds it on an H100: memory.  The function reads n_el = L + w - 1
// bytes a column and writes L; this design adds 1/8 of val's bytes three
// times over (masks written, masks read by the scan, P written) and reads the
// masks of the tiles where windows end, and a row of P, once more: 398 MB
// against the bound's 301 MB at 2^27 bases, w=1000.  With lastbad(e) the
// greatest invalid element <= e (-1: none), window j is valid iff
// lastbad(j + w - 1) < j.  Three passes, none of which reads anything a
// distance w away:
//   summary: masks[t][c], bit r set where element 32t + r is invalid.  A
//            warp 32 rows x 64 columns of two tiles: lane r loads row
//            32t + r's bytes in 16-byte words, and one ballot a column is
//            that column's mask, stored by lane c (128 bytes a warp).  val
//            is read once, streamed.
//   scan:    P[t][c] = the last invalid element of tiles 0 .. t, a max-scan
//            down each column of 32t + 31 - clz(mask).  A thread block 32
//            columns, its warps segments of the columns' tiles: each folds
//            its own, they meet, and each walks again writing P.  Loads go
//            16 tiles at a time.
//   walk:    a thread 16 neighbouring columns (a 16-byte store of a flag
//            row) and a segment of 32 windows whose ends fill one tile
//            (sketch_cuda.flag_segments, flag_launch): as many threads as
//            windows / 32 x columns / 16, whatever w.  Its carry is P of the
//            tile before; a tile's 32 windows are then a few bit operations
//            a column (below), and a row of flags four shifts and masks.
// The op launches the three through one call (nj_flags).  On an NVIDIA
// H100 80GB HBM3 at 700 W, 2^27 bases, k=32 (PERF.md section 6,
// `python -m ntjoin_tpu_torch.split_bench times --flags`, back-to-back
// calls): 0.177-0.180 / 0.185-0.188 / 0.184 ms at w=1000 / 5000 / 10000
// (queued behind a spinning kernel 0.173 / 0.182 / 0.178: summary 0.082,
// scan 0.015-0.023, walk 0.065-0.069) against a bound of 0.090 ms, where
// the one-pass kernel this design replaced, which read val twice and the w
// rows before each band again, took 0.250-0.254 / 0.318-0.322 / 0.359-0.361
// in the same calls; at 2^24 bases, w=20000 (209 chunks) 0.061-0.073
// against 0.430-0.435.  At 2^24, w=10 the host's call sets the time:
// 0.060-0.075 against 0.053-0.056 (queued, 0.029 both).  The cumulative sum
// in PyTorch took 4.95 / 12.3 / 21.5 ms at 2^27.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;  // rows of a tile: a bit each of a 32-bit mask
// summary: a warp 16 * kWords columns (kWords 16-byte words of a row a lane)
// of kSumTiles tiles, kSumWarps warps a block
constexpr int kWords = 4, kSumTiles = 2, kSumWarps = 8, kSumThreads = 32 * kSumWarps;
constexpr int kScanWarps = 32, kScanBatch = 16;
constexpr int kCols = 16;  // columns of a walk thread
// windows and threads of the walk: 32 windows whose ends fill one tile, 128
// threads a block (sketch_cuda.FLAG_ROWS, FLAG_THREADS)
constexpr int kWalkRows = 32, kWalkThreads = 128;

// The last element of tile t that mask m marks (m != 0).
__device__ __forceinline__ int32_t last_of(uint32_t m, int32_t t) {
  return kTile * t + 31 - __clz(m);
}

__global__ void __launch_bounds__(kSumThreads)
    summary_kernel(const int8_t* __restrict__ val, int64_t v_pitch, int32_t n_el, int64_t C,
                   int64_t groups, int64_t tiles, uint32_t* __restrict__ masks,
                   int64_t m_pitch) {
  constexpr int kWarpCols = 16 * kWords;
  const int lane = threadIdx.x & 31;
  const int64_t wid = ((int64_t)blockIdx.x * kSumThreads + threadIdx.x) >> 5;
  const int64_t runs = (tiles + kSumTiles - 1) / kSumTiles;
  if (wid >= groups * runs) return;  // the whole warp
  const int64_t c0 = (wid % groups) * kWarpCols;
  const int32_t t0 = (int32_t)(wid / groups) * kSumTiles;
  // every load first; a row past the elements, or columns past C, read as valid
  uint4 x[kSumTiles][kWords];
#pragma unroll
  for (int u = 0; u < kSumTiles; ++u) {
    const int32_t e = (t0 + u) * kTile + lane;
    const int8_t* v = val + e * v_pitch + c0;
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      x[u][q] = make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
      if (e < n_el && c0 + 16 * q < C)
        x[u][q] = __ldcs(reinterpret_cast<const uint4*>(v + 16 * q));
    }
  }
#pragma unroll
  for (int u = 0; u < kSumTiles; ++u) {
    if (t0 + u >= tiles) break;
    uint32_t mine[kWords / 2];  // lane's columns c0 + lane + 32 * h
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const uint32_t y[4] = {x[u][q].x, x[u][q].y, x[u][q].z, x[u][q].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t z = __vcmpeq4(y[i], 0u);  // 0xFF in each byte that is 0
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int col = 16 * q + 4 * i + k;
          const uint32_t m = __ballot_sync(~0u, z & (1u << (8 * k)));
          if (lane == (col & 31)) mine[col >> 5] = m;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kWords / 2; ++h)
      masks[(t0 + u) * m_pitch + c0 + 32 * h + lane] = mine[h];
  }
}

// A block 32 columns, a lane each; its warps segments of the columns' tiles.
// Each segment folds its tiles' last invalid elements, the segments meet in
// shared memory, and each walks its tiles again writing P; where a segment
// is one batch of loads, the second walk reuses the first's registers.
__global__ void __launch_bounds__(32 * kScanWarps)
    scan_kernel(const uint32_t* __restrict__ masks, int64_t m_pitch, int32_t tiles, int warps,
                int32_t* __restrict__ P) {
  __shared__ int32_t part[kScanWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t c = (int64_t)blockIdx.x * 32 + lane;
  const int32_t per = (tiles + warps - 1) / warps;
  const int32_t t0 = min(warp * per, tiles), t1 = min(t0 + per, tiles);
  const uint32_t* m = masks + c;
  uint32_t x[kScanBatch];  // after the fold: the last batch, the only one if per <= a batch
  int32_t last = -1;
  for (int32_t t = t0; t < t1; t += kScanBatch) {
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i) x[i] = t + i < t1 ? m[(t + i) * m_pitch] : 0u;
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i)
      if (x[i]) last = last_of(x[i], t + i);
  }
  part[warp][lane] = last;
  __syncthreads();
  int32_t carry = -1;  // the segments before this one
  for (int s = 0; s < warp; ++s) carry = max(carry, part[s][lane]);
  int32_t* p = P + c;
  for (int32_t t = t0; t < t1; t += kScanBatch) {
    if (per > kScanBatch) {
#pragma unroll
      for (int i = 0; i < kScanBatch; ++i) x[i] = t + i < t1 ? m[(t + i) * m_pitch] : 0u;
    }
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i) {
      if (t + i >= t1) break;
      if (x[i]) carry = last_of(x[i], t + i);  // a later tile's element is the larger
      p[(t + i) * m_pitch] = carry;
    }
  }
}

__device__ __forceinline__ void load16(const uint32_t* p, uint32_t (&m)[kCols]) {
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q) {
    const uint4 x = *reinterpret_cast<const uint4*>(p + 4 * q);
    m[4 * q] = x.x;
    m[4 * q + 1] = x.y;
    m[4 * q + 2] = x.z;
    m[4 * q + 3] = x.w;
  }
}

// Byte q of each of four words, as one word.
__device__ __forceinline__ uint32_t bytes_q(const uint32_t* x, int q) {
  const uint32_t sel = q | (4 + q) << 4;
  return __byte_perm(__byte_perm(x[0], x[1], sel), __byte_perm(x[2], x[3], sel), 0x5410);
}

// A thread 16 columns and the windows of its segment, tile by tile of the
// elements e0 .. e1 - 1 where they end.  For tile t (elements base = 32t ..) and a
// column whose last invalid element before the tile is `carry`, the window
// ending at row r is valid iff carry < base + r - w + 1 (bits r >= carry -
// base + w) and no invalid element of the tile lies in [r - w + 1, r] (the
// tile's mask smeared upward by w - 1 rows, capped at 31): 32 windows a few
// operations.  The flags of a row are then four words of 0x01010101 masks:
// byte q of the four columns' bit words, shifted by the row in the group of 8.
__global__ void __launch_bounds__(kWalkThreads)
    walk_kernel(const uint32_t* __restrict__ masks, const int32_t* __restrict__ P,
                int64_t m_pitch, int32_t L, int32_t w, int64_t groups, int64_t segs,
                int8_t* __restrict__ flags, int64_t f_pitch) {
  const int64_t tid = (int64_t)blockIdx.x * kWalkThreads + threadIdx.x;
  if (tid >= groups * segs) return;
  const int64_t c0 = (tid % groups) * kCols;
  // the elements where the segment's windows end: kWalkRows of them from the
  // start of the tile of window 0's end (sketch_cuda.flag_segments)
  const int32_t s0 = (w - 1) / kTile * kTile + (int32_t)(tid / groups) * kWalkRows;
  const int32_t e0 = max(s0, w - 1), e1 = min(s0 + kWalkRows, L + w - 1);
  const int32_t ta = e0 >> 5, tb = (e1 - 1) >> 5;
  const uint32_t* mc = masks + c0;
  int32_t carry[kCols];  // the last invalid element before the tile
  {
    uint32_t p[kCols];
    if (ta > 0) {
      load16(reinterpret_cast<const uint32_t*>(P) + c0 + (ta - 1) * m_pitch, p);
    } else {
#pragma unroll
      for (int i = 0; i < kCols; ++i) p[i] = ~0u;
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) carry[i] = (int32_t)p[i];
  }
  uint32_t prev = 0;  // bit i: window of the element before the tile valid
#pragma unroll
  for (int i = 0; i < kCols; ++i) prev |= (uint32_t)(carry[i] < kTile * ta - w) << i;
  const int wc = min(w, kTile);
  int8_t* f = flags + c0;
  for (int32_t t = ta; t <= tb; ++t) {
    const int32_t base = kTile * t;
    uint32_t m[kCols], ok[kCols], first[kCols];
    load16(mc + t * m_pitch, m);
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int32_t k = carry[i] - base + w;
      const uint32_t ok_a = k <= 0 ? ~0u : k >= 32 ? 0u : ~0u << k;
      uint32_t s = m[i];
      for (int cover = 1; cover < wc;) {
        const int sh = min(cover, wc - cover);
        s |= s << sh;
        cover += sh;
      }
      ok[i] = ok_a & ~s;
      first[i] = ok[i] & ~((ok[i] << 1) | (prev >> i & 1));
      if (m[i]) carry[i] = last_of(m[i], t);
    }
    prev = 0;
#pragma unroll
    for (int i = 0; i < kCols; ++i) prev |= (ok[i] >> 31) << i;
    const int ra = max(e0 - base, 0), rb = min(e1 - base, kTile);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (8 * q + 8 <= ra || 8 * q >= rb) continue;
      uint32_t wok[4], wf[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        wok[g] = bytes_q(ok + 4 * g, q);
        wf[g] = bytes_q(first + 4 * g, q);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = 8 * q + k;
        if (r < ra || r >= rb) continue;
        uint32_t out[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          out[g] = (wok[g] >> k & 0x01010101u) | (wf[g] >> k & 0x01010101u) << 1;
        const int32_t j = base + r - w + 1;
        *reinterpret_cast<uint4*>(f + j * f_pitch) =
            make_uint4(out[0], out[1], out[2], out[3]);
      }
    }
  }
}

}  // namespace

// The summary pass over elements [0, n_el) of val (the pointer is at row
// off): masks, (ceil(n_el / 32), m_pitch) uint32, m_pitch a multiple of 128
// columns and at least C.  val must be 16-byte aligned with a pitch that is
// a multiple of 16 and at least C rounded up to 16.
extern "C" int nj_flags_summary(const void* val, int64_t v_pitch, int64_t n_el, int64_t C,
                                void* masks, int64_t m_pitch, void* stream) {
  if (n_el < 1 || n_el > INT32_MAX - kTile || m_pitch % 128 || m_pitch < C)
    return (int)cudaErrorInvalidValue;
  const int64_t groups = (C + 16 * kWords - 1) / (16 * kWords);
  const int64_t tiles = (n_el + kTile - 1) / kTile, runs = (tiles + kSumTiles - 1) / kSumTiles;
  const int64_t blocks = (groups * runs + kSumWarps - 1) / kSumWarps;
  summary_kernel<<<(unsigned)blocks, kSumThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)val, v_pitch, (int32_t)n_el, C, groups, tiles, (uint32_t*)masks, m_pitch);
  return (int)cudaGetLastError();
}

// The scan pass: P, (tiles, m_pitch) int32, from the masks; a block of 32
// columns, each warp at least a batch of tiles.
extern "C" int nj_flags_scan(const void* masks, int64_t m_pitch, int64_t tiles, void* P,
                             void* stream) {
  if (tiles < 1 || tiles > INT32_MAX / kTile || m_pitch % 32)
    return (int)cudaErrorInvalidValue;
  const int warps = (int)std::min<int64_t>(kScanWarps, (tiles + kScanBatch - 1) / kScanBatch);
  scan_kernel<<<(unsigned)(m_pitch / 32), 32 * warps, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)masks, m_pitch, (int32_t)tiles, warps, (int32_t*)P);
  return (int)cudaGetLastError();
}

// The walk: flags (L, f_pitch) of windows [0, L), a thread a group of 16
// columns and kWalkRows windows.  flags must be 16-byte aligned with a pitch
// that is a multiple of 16 and at least C rounded up to 16.
extern "C" int nj_flags_walk(const void* masks, const void* P, int64_t m_pitch, int64_t L,
                             int64_t C, int w, void* flags, int64_t f_pitch, void* stream) {
  if (w < 1 || L < 1 || L + w - 1 > INT32_MAX - kTile || m_pitch % 32 || m_pitch < C)
    return (int)cudaErrorInvalidValue;
  const int64_t groups = (C + kCols - 1) / kCols;
  const int64_t segs = (L + w - 1 - (w - 1) / kTile * kTile + kWalkRows - 1) / kWalkRows;
  const int64_t blocks = (groups * segs + kWalkThreads - 1) / kWalkThreads;
  walk_kernel<<<(unsigned)blocks, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)masks, (const int32_t*)P, m_pitch, (int32_t)L, w, groups, segs,
      (int8_t*)flags, f_pitch);
  return (int)cudaGetLastError();
}

// The op: the three passes in one call, masks and then P in `scratch`, two
// (ceil((L + w - 1) / 32), m_pitch) int32 arrays; val's pointer is at row
// off.  One call from the host where the passes' own entry points take
// three, so that a host slower than the card spaces the launches out less.
extern "C" int nj_flags(const void* val, int64_t v_pitch, int64_t L, int64_t C, int w,
                        void* scratch, int64_t m_pitch, void* flags, int64_t f_pitch,
                        void* stream) {
  const int64_t tiles = (L + w - 1 + kTile - 1) / kTile;
  uint32_t* masks = (uint32_t*)scratch;
  int32_t* P = (int32_t*)scratch + tiles * m_pitch;
  int err = nj_flags_summary(val, v_pitch, L + w - 1, C, masks, m_pitch, stream);
  if (err == 0) err = nj_flags_scan(masks, m_pitch, tiles, P, stream);
  if (err == 0) err = nj_flags_walk(masks, P, m_pitch, L, C, w, flags, f_pitch, stream);
  return err;
}
