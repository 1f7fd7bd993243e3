// Kernel 1 of the minimizer sketch: the ntHash2 rolling hash over a chunked
// code stream, one thread per chunk.
//
// Replaces: ntjoin_tpu/ops/sketch_pallas.py, _hash_kernel (launched by
// _hash_chunked).  The TPU kernel carried each lane's hash state across a
// sequential grid in VMEM scratch; here the carry is the thread's own loop.
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
// What bounds it on an H100: memory.  Each base costs 1 B read (the lagged
// outgoing base is the same byte k iterations later, from L1) and 9 B
// written, against ~20 integer operations.  Outputs are laid out (rows, C),
// so the 32 threads of a warp write 32 neighbouring words per row; the code
// reads are strided by L and lean on L1 to serve the next 31 rows of each
// 32-byte sector.  Staging the codes through shared memory is later work.
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

// Four-way select by base code with constant indices, so the tables stay in
// registers; any code >= 4 is invalid and selects 0.
__device__ __forceinline__ uint64_t pick(const uint64_t (&t)[4], unsigned c) {
  return c == 0 ? t[0] : c == 1 ? t[1] : c == 2 ? t[2] : c == 3 ? t[3] : 0ull;
}

// tables: 4 rows of 4 uint64 (seed_in, seed_out, seed_rc_out_rot, seed_rc_in)
// indexed by base code.
__global__ void hash_kernel(const uint8_t* __restrict__ flat, int64_t L, int64_t C,
                            int64_t rows, int k, const uint64_t* __restrict__ tables,
                            uint64_t* __restrict__ h, int64_t h_pitch,
                            int8_t* __restrict__ val, int64_t v_pitch) {
  const int64_t chunk = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (chunk >= C) return;
  uint64_t t_in[4], t_out[4], t_rc_out[4], t_rc_in[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    t_in[b] = tables[b];
    t_out[b] = tables[4 + b];
    t_rc_out[b] = tables[8 + b];
    t_rc_in[b] = tables[12 + b];
  }
  const uint8_t* src = flat + chunk * L;
  uint64_t f = 0, r = 0;
  int64_t last_bad = -1;
  for (int64_t i = 0; i < rows; ++i) {
    const unsigned in = src[i];
    const unsigned out = i >= k ? src[i - k] : 4u;
    f = srol1(f) ^ pick(t_out, out) ^ pick(t_in, in);
    r = sror1(r) ^ pick(t_rc_out, out) ^ pick(t_rc_in, in);
    if (in >= 4u) last_bad = i;
    h[i * h_pitch + chunk] = f + r;
    val[i * v_pitch + chunk] = (int8_t)(i - last_bad >= k);
  }
}

}  // namespace

extern "C" int nj_hash(const void* flat, int64_t L, int64_t C, int64_t rows, int k,
                       const void* tables, void* h, int64_t h_pitch, void* val,
                       int64_t v_pitch, void* stream) {
  const int threads = 64;
  const int64_t blocks = (C + threads - 1) / threads;
  hash_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)flat, L, C, rows, k, (const uint64_t*)tables, (uint64_t*)h,
      h_pitch, (int8_t*)val, v_pitch);
  return (int)cudaGetLastError();
}
