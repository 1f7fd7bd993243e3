// Kernel 1 of the minimizer sketch: the ntHash2 rolling hash over a chunked
// code stream, many threads per chunk.
//
// Replaces: ntjoin_tpu/ops/sketch_pallas.py, _hash_kernel (launched by
// _hash_chunked).  The TPU kernel carried each lane's hash state across a
// sequential grid in VMEM scratch; here a chunk's rows are cut into segments
// and every (chunk, segment) is a thread that rebuilds the state itself.
//
// Contract (plain version: ntjoin_tpu_torch/ops/sketch_cuda.py,
// hash_chunked_ref).  Chunk c reads codes flat[c*L + r] for r in [0, rows).
// Row r of the output is the k-mer that ENDS at row r:
//   h[r, c]   = fwd + rev (mod 2^64), the canonical ntHash2 value,
//   val[r, c] = 1 iff rows r-k+1 .. r all hold a valid base (code < 4).
// Row r of h starts at h + r * h_pitch and row r of val at val + r * v_pitch
// (in elements, both >= C): the wrapper rounds the pitch up so that the
// window/emission kernel can stage rows by 16-byte asynchronous copies.
// Both recurrences are state = rot1(state) ^ m, with the seed terms of the
// incoming and outgoing base pre-rotated on the host (seed_tables), so an
// invalid base (seed 0) keeps the rolling state consistent through N runs.
//
// Design.  The state at a row depends only on the k bases that end there, so
// thread (chunk c, segment s) owns rows [s*kSeg, s*kSeg + kSeg): it starts k-1
// rows early from a zero state, takes the outgoing base for invalid during
// its first k steps (as a chunk's first rows do), stores nothing before its
// own first row, and from there on holds what one walk down the whole chunk
// would hold.  A launch then has rows * C / kSeg threads whatever w is: a long
// window means few, long chunks, and the parallelism has to come from inside
// them.  A warp is 32 neighbouring chunks on one segment, so its stores stay
// whole rows (256 B of h, 32 B of val).  Its codes, kSeg + k - 1 bytes a
// chunk, are staged first: the warp reads each chunk's run by 4-byte words
// along the stream (whole words, aligned down, every code clamped to 4) into
// its own slice of shared memory, one chunk after another at a pitch of an
// odd number of words, so that the 32 lanes reading byte j of their chunks
// hit 32 banks.  Incoming and outgoing base then come from shared memory,
// and so do the seed terms: one 16-byte read of pair[out][in] gives what a
// step xors into both states, where four-way selects on tables in registers
// cost half the step's instructions and 16 more registers.  Warps share
// nothing but that table: past its barrier the only one is __syncwarp.
//
// What bounds it on an H100: memory, 1 B read and 9 B written per row; the
// k-1 warm-up rows of a segment cost steps, not bytes.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md), 2^27 bases, k=32, bound
// 0.49 ms: 0.80 ms at w=1000 (32,577 chunks of 5,151 rows) and 0.73 ms at
// w=5000 (6,670 chunks of 25,153 rows), where one thread per chunk took 3.0
// and 13.4 ms in the same call.  The time follows the warps in flight, not
// the bytes: with the selects in registers (56 registers, 24 warps an SM at
// segments of 256 rows) it was 1.11 ms, with the table 0.95 ms at 256 rows
// and 0.77 ms at 80, although a third of the steps are then warm-up.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint64_t srol1(uint64_t x) {
  return ((x << 1) & 0xFFFFFFFDFFFFFFFFull) | ((x >> 63) << 33) | ((x >> 32) & 1ull);
}

__device__ __forceinline__ uint64_t sror1(uint64_t x) {
  return ((x >> 1) & ~((1ull << 32) | (1ull << 63))) | ((x & 1ull) << 32) |
         ((x & (1ull << 33)) << 30);
}

constexpr int kWarps = 4;  // warps of a thread block, each on its own (32 chunks, segment)

// Rows a thread owns.  It pays k - 1 warm-up rows on top, and shorter
// segments mean more warps in flight: at k=32, 64 to 96 rows measured within
// 3% of each other at 32,577 chunks of 5,151 rows and at 6,670 of 25,153, 48
// and 128 rows 10-15% slower; at k=64, 64 to 256 rows within 10%.
constexpr int kSeg = 80;

constexpr int kCodes = 5;   // A, C, G, T and "invalid": every code >= 4 is staged as 4
constexpr int kPairs = kCodes * kCodes;

// Four codes of one chunk's run as the staging loop needs them: a whole word
// where the stream holds it, single bytes (invalid outside [flat, end)) at
// its ends; each byte clamped to 4.
__device__ __forceinline__ uint32_t load_codes(const uint8_t* a, const uint8_t* flat,
                                               const uint8_t* end) {
  uint32_t word = 0x04040404u;
  if (a >= flat && a + 4 <= end) {
    word = *reinterpret_cast<const uint32_t*>(a);
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (a + b >= flat && a + b < end)
        word = (word & ~(0xFFu << (8 * b))) | ((uint32_t)a[b] << (8 * b));
  }
  return __vminu4(word, 0x04040404u);
}

// tables: 4 rows of 4 uint64 (seed_in, seed_out, seed_rc_out_rot, seed_rc_in)
// indexed by base code.  pitch_w: words between two chunks' codes in shared
// memory, odd, >= (kSeg + k + 5) / 4.
__global__ void __launch_bounds__(32 * kWarps)
    hash_kernel(const uint8_t* __restrict__ flat, int64_t L, int64_t C, int64_t rows, int k,
                int pitch_w, const uint64_t* __restrict__ tables,
                uint64_t* __restrict__ h, int64_t h_pitch, int8_t* __restrict__ val,
                int64_t v_pitch) {
  // pair[out * 5 + in]: what a step xors into the forward (x) and the reverse
  // (y) state when base `out` leaves the k-mer and base `in` enters it
  extern __shared__ __align__(16) ulonglong2 pair[];
  uint32_t* staged = reinterpret_cast<uint32_t*>(pair + kPairs);
  if (threadIdx.x < kPairs) {
    const int o = threadIdx.x / kCodes, i = threadIdx.x % kCodes;
    pair[threadIdx.x] = make_ulonglong2((o < 4 ? tables[4 + o] : 0) ^ (i < 4 ? tables[i] : 0),
                                        (o < 4 ? tables[8 + o] : 0) ^ (i < 4 ? tables[12 + i] : 0));
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t groups = (C + 31) / 32;  // of 32 chunks
  const int64_t segs = (rows + kSeg - 1) / kSeg;
  // neighbouring warps take neighbouring chunk groups on the same segment:
  // what the card writes at one time is a band of whole rows
  const int64_t unit = blockIdx.x * (int64_t)kWarps + warp;
  if (unit >= groups * segs) return;
  const int64_t chunk0 = (unit % groups) * 32;
  const int64_t first = (unit / groups) * kSeg;             // the thread's first own row
  const int64_t last = min(first + kSeg, rows);             // one past its last
  const int64_t start = max(first - (k - 1), (int64_t)0);   // first row it reads
  const int len = (int)(last - start);
  const uint8_t* end = flat + (C - 1) * L + rows;           // one past the last code any chunk reads
  uint32_t* mine = staged + (size_t)warp * 32 * pitch_w;

  for (int cc = 0; cc < 32 && chunk0 + cc < C; ++cc) {
    const uint8_t* run = flat + (chunk0 + cc) * L + start;
    const unsigned shift = (unsigned)(reinterpret_cast<uintptr_t>(run) & 3);
    const int words = (int)(shift + len + 3) >> 2;
    for (int j = lane; j < words; j += 32)
      mine[cc * pitch_w + j] = load_codes(run - shift + 4 * j, flat, end);
  }
  __syncwarp();
  const int64_t chunk = chunk0 + lane;
  if (chunk >= C) return;

  // src[j] is the code of row start + j
  const uint8_t* src = reinterpret_cast<const uint8_t*>(mine + lane * pitch_w) +
                       (reinterpret_cast<uintptr_t>(flat + chunk * L + start) & 3);
  uint64_t f = 0, r = 0;
  int last_bad = -1;
  const int warm = (int)(first - start);  // at most k - 1: no base leaves during the warm-up
  for (int j = 0; j < warm; ++j) {
    const unsigned in = src[j];
    const ulonglong2 t = pair[4 * kCodes + in];
    f = srol1(f) ^ t.x;
    r = sror1(r) ^ t.y;
    if (in == 4u) last_bad = j;
  }
  uint64_t* hp = h + first * h_pitch + chunk;
  int8_t* vp = val + first * v_pitch + chunk;
#pragma unroll 4
  for (int j = warm; j < len; ++j) {
    const unsigned in = src[j];
    const unsigned out = j >= k ? src[j - k] : 4u;
    const ulonglong2 t = pair[out * kCodes + in];
    f = srol1(f) ^ t.x;
    r = sror1(r) ^ t.y;
    if (in == 4u) last_bad = j;
    *hp = f + r;
    *vp = (int8_t)(j - last_bad >= k);
    hp += h_pitch;
    vp += v_pitch;
  }
}

}  // namespace

extern "C" int nj_hash(const void* flat, int64_t L, int64_t C, int64_t rows, int k,
                       const void* tables, void* h, int64_t h_pitch, void* val,
                       int64_t v_pitch, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const int pitch_w = ((kSeg + k + 5) / 4) | 1;
  const size_t bytes = kPairs * sizeof(ulonglong2) + (size_t)kWarps * 32 * pitch_w * 4;
  cudaError_t err = cudaFuncSetAttribute(hash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(hash_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int64_t units = ((C + 31) / 32) * ((rows + kSeg - 1) / kSeg);
  const int64_t blocks = (units + kWarps - 1) / kWarps;
  hash_kernel<<<(unsigned)blocks, 32 * kWarps, bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)flat, L, C, rows, k, pitch_w, (const uint64_t*)tables, (uint64_t*)h,
      h_pitch, (int8_t*)val, v_pitch);
  return (int)cudaGetLastError();
}
