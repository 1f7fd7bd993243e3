// Stream compaction of the general sketch path: the valid k-mers of a batch
// with N runs, and a dead slot between records, laid out by rank in the
// chunks the window kernels read.
//
// Replaces: the re-chunk maps of ntjoin_tpu/ops/sketch_pallas.py
// _sketch_fused_general (_diff :1562, _colcum :1584, _stream :1605; XLA code,
// no TPU kernel).  In PyTorch the same step was nonzero, take and five strided
// copies: 4.5 ms of the general path's 7.2 ms call on phase A's 100 Mbp draft
// on an NVIDIA H100 (PERF.md), hence a kernel.
//
// Contract (plain version: ntjoin_tpu_torch/ops/sketch_general.py,
// stream_batch on a CPU tensor or with plain).  Input: the hash layout of
// hash_batch, (off + L, C) arrays of int64 hashes h and int8 valid flags val
// with row pitches h_pitch and v_pitch; row off + r of column c is the k-mer that starts at genomic
// position p = c*L + r, for p < N = n - k + 1.  Position p is kept when its
// k-mer is valid or when p + 1 = starts[i] for some i >= 1 (the dead slot
// before every record after the first; starts ascends, starts[0] = 0).  The
// kept positions in ascending order are the stream, rank q for the q-th.
// Four launches:
//   count:  counts[c*nseg + s] = the kept positions among rows
//           [s*seg, (s+1)*seg) of column c (a segment).  The caller's
//           exclusive prefix sum of counts gives firsts, the rank of each
//           segment's first kept position, and the total S.
//   gather: hflat[q] = rank q's hash, vflat[q] = 1 (0 at a dead slot).
//   chunks: element e of the stream's chunk layout, column e / Ls, row e % Ls
//           of (Ls + w - 1, Cs) arrays hs (int64) and vs (int8), and also row
//           Ls + e % Ls of column e / Ls - 1 where e % Ls < w - 1 (the halo),
//           is hflat[e] and vflat[e] for e < S, else -1 and 0.  Columns past
//           Cs are not touched.
//   pos:    pos[q] = the position of rank q, int64.
//
// What bounds it on an H100: memory.  It must read the flags (1 byte a
// position) and the kept hashes (8 bytes a rank) and write 8 + 1 bytes a rank
// of chunks plus the halo, and 8 of positions.  The input and the output are
// both laid out column after column in row-major arrays, with columns of
// different lengths, so that a kept k-mer's column and row in one have no
// simple relation to those in the other: a thread that walks one column of
// the input writes each rank to another row of the output, and a first design
// whose 8-byte stores landed on 32 rows at once was slower than the PyTorch
// version.  So the stream goes through rank order.  count, gather and pos
// walk a segment of 32 neighbouring columns in tiles of 32 rows: the tile is
// read row by row (a warp reads a row's 32 flags and 32 hashes at once) into
// shared memory, then each warp takes a column of it, one row a lane, and
// ranks its kept rows by a ballot and a population count from the column's
// running rank, so that the stores of a warp are consecutive ranks; the next
// tile's rows are loaded into registers meanwhile (with segments of 1,024
// rows, faster than 256 on the H100).  chunks is a transpose of rank order
// into the chunk layout through tiles of 32 x 32 in shared memory: a warp
// reads 32 consecutive ranks and writes 32 neighbouring columns of a row.
// Dead slots are found by a binary search of starts at a segment's first
// row, then followed in order.  hflat and vflat cost 9 bytes a rank for a
// while: the caller frees the hash layout after gather and hflat and vflat
// after chunks, and makes pos last, so that at most the flags, two of
// {layout, rank order, chunks, pos} and the codes are held at once.  Ranks
// and positions are int64: n reaches 2^31.  On an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md), phase A's 100 Mbp at w=1000: 2.6 ms for the four passes
// against a bound of 0.79 ms, where the PyTorch version took 4.6.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;

enum Pass { kCount, kGather, kPos };

struct Input {
  const int8_t* val;  // row off of val
  int64_t v_pitch, L, C, N;
  const int64_t* starts;
  int64_t n_starts;
  int seg;
  int64_t nseg;
};

// the first dead slot at or after position p: starts[i] - 1 for the least
// i >= 1 with starts[i] - 1 >= p, else INT64_MAX; i in *at
__device__ __forceinline__ int64_t next_dead(const Input& a, int64_t p, int64_t* at) {
  int64_t lo = 1, hi = a.n_starts;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a.starts[mid] - 1 < p) lo = mid + 1;
    else hi = mid;
  }
  *at = lo;
  return lo < a.n_starts ? a.starts[lo] - 1 : INT64_MAX;
}

// One thread block a segment of 32 neighbouring columns; warp w ranks the
// columns w, w + 8, w + 16, w + 24 of each tile of 32 rows.
template <Pass P>
__global__ void __launch_bounds__(kThreads)
    rank_kernel(Input a, const int64_t* __restrict__ h, int64_t h_pitch, int32_t* counts,
                const int64_t* __restrict__ firsts, int64_t* __restrict__ out64,
                int8_t* __restrict__ out8, int64_t col_groups) {
  __shared__ int64_t ht[32][33];  // [row][column]; odd pitch: no bank conflicts either way
  __shared__ int32_t vt[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t c0 = ((int64_t)blockIdx.x % col_groups) * 32;
  const int64_t s = (int64_t)blockIdx.x / col_groups;
  const int64_t r_begin = s * a.seg, r_end = min(r_begin + a.seg, a.L);
  // this thread's 4 rows of a tile, loaded one tile ahead
  int32_t vr[4];
  int64_t hr[4];
  auto load = [&](int64_t rt) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t r = rt + warp + 8 * k, c = c0 + lane;
      const bool in = r < r_end && c < a.C && c * a.L + r < a.N;
      vr[k] = in ? a.val[r * a.v_pitch + c] : 0;
      if (P == kGather) hr[k] = in ? h[r * h_pitch + c] : 0;
    }
  };
  load(r_begin);
  int64_t q[4], dead[4], at[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t c = c0 + warp + 8 * i;
    q[i] = 0;
    dead[i] = INT64_MAX;
    at[i] = a.n_starts;
    if (c < a.C) {
      if (P != kCount) q[i] = firsts[c * a.nseg + s];
      dead[i] = next_dead(a, c * a.L + r_begin, &at[i]);
    }
  }
  for (int64_t rt = r_begin; rt < r_end; rt += 32) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      vt[warp + 8 * k][lane] = vr[k];
      if (P == kGather) ht[warp + 8 * k][lane] = hr[k];
    }
    __syncthreads();
    if (rt + 32 < r_end) load(rt + 32);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = warp + 8 * i;
      const int64_t c = c0 + j;
      if (c >= a.C) continue;  // the same for the whole warp
      const int64_t p0 = c * a.L + rt, p = p0 + lane;
      uint32_t dm = 0;  // the dead slots among the tile's 32 rows
      while (dead[i] < p0 + 32) {
        if (dead[i] >= p0) dm |= 1u << (dead[i] - p0);
        dead[i] = ++at[i] < a.n_starts ? a.starts[at[i]] - 1 : INT64_MAX;
      }
      const int32_t fl = vt[lane][j];
      const bool keep = rt + lane < r_end && p < a.N && (fl != 0 || (dm >> lane & 1));
      const uint32_t ball = __ballot_sync(0xffffffffu, keep);
      if (keep && P != kCount) {
        const int64_t rank = q[i] + __popc(ball & ((1u << lane) - 1));
        if (P == kGather) {
          out64[rank] = ht[lane][j];
          out8[rank] = fl != 0;  // a dead slot's k-mer is never valid
        } else {
          out64[rank] = p;
        }
      }
      q[i] += __popc(ball);
    }
    __syncthreads();
  }
  if (P == kCount && lane == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t c = c0 + warp + 8 * i;
      if (c < a.C) counts[c * a.nseg + s] = (int32_t)q[i];
    }
  }
}

// Rank order into the chunk layout, a tile of 32 columns x 32 rows a block.
__global__ void __launch_bounds__(kThreads)
    chunks_kernel(const int64_t* __restrict__ hflat, const int8_t* __restrict__ vflat, int64_t S,
                  int64_t Ls, int64_t Cs, int64_t rows, int64_t* __restrict__ hs,
                  int64_t hs_pitch, int8_t* __restrict__ vs, int64_t vs_pitch,
                  int64_t col_groups) {
  __shared__ int64_t ht[32][33];  // [column][row]
  __shared__ int32_t vt[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t c0 = ((int64_t)blockIdx.x % col_groups) * 32;
  const int64_t r0 = ((int64_t)blockIdx.x / col_groups) * 32;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = warp + 8 * k;
    const int64_t e = (c0 + j) * Ls + r0 + lane;  // rows past Ls run into the next chunk
    const bool in = c0 + j < Cs && r0 + lane < rows && e < S;
    ht[j][lane] = in ? hflat[e] : -1;
    vt[j][lane] = in ? vflat[e] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = warp + 8 * k;
    const int64_t r = r0 + i, c = c0 + lane;
    if (r < rows && c < Cs) {
      hs[r * hs_pitch + c] = ht[lane][i];
      vs[r * vs_pitch + c] = (int8_t)vt[lane][i];
    }
  }
}

template <Pass P>
int launch_rank(const Input& a, const void* h, int64_t h_pitch, void* counts,
                const void* firsts, void* out64, void* out8, void* stream) {
  if (a.seg < 1 || a.C < 1 || a.nseg < 1 || a.nseg * a.seg < a.L)
    return (int)cudaErrorInvalidValue;
  const int64_t col_groups = (a.C + 31) / 32, blocks = col_groups * a.nseg;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  rank_kernel<P><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, (const int64_t*)h, h_pitch, (int32_t*)counts, (const int64_t*)firsts, (int64_t*)out64,
      (int8_t*)out8, col_groups);
  return (int)cudaGetLastError();
}

Input input(const void* val, int64_t v_pitch, int64_t off, int64_t L, int64_t C, int64_t N,
            const void* starts, int64_t n_starts, int seg, int64_t nseg) {
  return Input{(const int8_t*)val + off * v_pitch, v_pitch, L, C, N, (const int64_t*)starts,
               n_starts, seg, nseg};
}

}  // namespace

// seg, nseg: rows of a segment and segments of a column
// (sketch_general.STREAM_SEG, stream_segments); counts int32 (C * nseg).
extern "C" int nj_stream_count(const void* val, int64_t v_pitch, int64_t off, int64_t L,
                               int64_t C, int64_t N, const void* starts, int64_t n_starts,
                               int seg, int64_t nseg, void* counts, void* stream) {
  return launch_rank<kCount>(input(val, v_pitch, off, L, C, N, starts, n_starts, seg, nseg),
                             nullptr, 0, counts, nullptr, nullptr, nullptr, stream);
}

// firsts int64 (C * nseg): each segment's first rank; hflat int64 (S), vflat
// int8 (S).
extern "C" int nj_stream_gather(const void* h, int64_t h_pitch, const void* val,
                                int64_t v_pitch, int64_t off, int64_t L, int64_t C, int64_t N,
                                const void* starts, int64_t n_starts, int seg, int64_t nseg,
                                const void* firsts, void* hflat, void* vflat, void* stream) {
  return launch_rank<kGather>(input(val, v_pitch, off, L, C, N, starts, n_starts, seg, nseg),
                              (const int64_t*)h + off * h_pitch, h_pitch, nullptr, firsts,
                              hflat, vflat, stream);
}

// hs, vs (Ls + w - 1, Cs) with pitches hs_pitch, vs_pitch.
extern "C" int nj_stream_chunks(const void* hflat, const void* vflat, int64_t S, int64_t Ls,
                                int64_t Cs, int w, void* hs, int64_t hs_pitch, void* vs,
                                int64_t vs_pitch, void* stream) {
  if (w < 1 || Ls < 1 || Cs < 1 || S < 0 || S > Cs * Ls) return (int)cudaErrorInvalidValue;
  const int64_t rows = Ls + w - 1, col_groups = (Cs + 31) / 32;
  const int64_t blocks = col_groups * ((rows + 31) / 32);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  chunks_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)hflat, (const int8_t*)vflat, S, Ls, Cs, rows, (int64_t*)hs, hs_pitch,
      (int8_t*)vs, vs_pitch, col_groups);
  return (int)cudaGetLastError();
}

// pos int64 (S).
extern "C" int nj_stream_pos(const void* val, int64_t v_pitch, int64_t off, int64_t L, int64_t C,
                             int64_t N, const void* starts, int64_t n_starts, int seg,
                             int64_t nseg, const void* firsts, void* pos, void* stream) {
  return launch_rank<kPos>(input(val, v_pitch, off, L, C, N, starts, n_starts, seg, nseg),
                           nullptr, 0, nullptr, firsts, pos, nullptr, stream);
}
