// Kernel 2 of the minimizer sketch: windowed argmin with the emission step
// and per-chunk compaction, one thread per chunk.
//
// Replaces: ntjoin_tpu/ops/sketch_pallas.py, _window_emit_kernel (launched by
// _window_emit_chunked).  The TPU kernel ran Van Herk over 128-lane tiles and
// packed emissions into 31 slots per (lane, w-block), with equal-hash runs
// compressed; here one thread scans its chunk (vanherk.cuh) and appends each
// emission to its own capacity-bounded list.  Runs are not compressed: a
// repeat-dense chunk overflows its list, the count says so, and the caller
// runs the exact kernel (window.cu) over the chunks that overflowed.
//
// Contract (plain version: ntjoin_tpu_torch/ops/sketch_cuda.py,
// window_emit_ref).  For chunk c and window j in [0, L), with flags[j, c]
// bit0 = window valid (all w k-mers valid) and bit1 = force (first valid
// window of a record), window j emits when it is valid and either forced or
// its argmin differs from window j-1's.  Emission i of the chunk, if i < cap,
// lands in pos[i, c] = c*L + s (the k-mer start in the stream) and
// hsh[i, c] = its canonical hash; slots past the emissions hold -1 and 0.
// count[c] is the true number of emissions, which may exceed cap.
//
// What bounds it on an H100: memory and latency.  Per window it reads 16 B
// of hashes and 1 B of flags and moves 24 B of scratch; emissions are ~2 per
// w windows.  Threads per chunk column keep the warps' accesses coalesced
// (see vanherk.cuh), and the scan does constant work per window, so repeat
// runs cost no more than random sequence.
#include "vanherk.cuh"

namespace {

struct EmitSink {
  const int8_t* __restrict__ flags;
  int64_t C, chunk, L, cap;
  int64_t* __restrict__ pos;
  uint64_t* __restrict__ hsh;
  int64_t count;
  int32_t prev;

  __device__ void operator()(int64_t j, uint64_t key, int32_t s) {
    const int8_t f = flags[j * C + chunk];
    if ((f & 1) && ((f & 2) || s != prev)) {
      if (count < cap) {
        pos[count * C + chunk] = chunk * L + s;
        hsh[count * C + chunk] = key;
      }
      ++count;
    }
    prev = s;
  }
};

__global__ void window_emit_kernel(const uint64_t* __restrict__ h,
                                   const int8_t* __restrict__ flags, int64_t L, int64_t C,
                                   int w, int64_t off, int64_t cap, uint64_t* __restrict__ sk,
                                   int32_t* __restrict__ sp, int64_t* __restrict__ pos,
                                   uint64_t* __restrict__ hsh, int64_t* __restrict__ count) {
  const int64_t chunk = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (chunk >= C) return;
  EmitSink sink{flags, C, chunk, L, cap, pos, hsh, 0, -1};
  vanherk::scan(h, C, chunk, L, w, off, sk, sp, C, chunk, sink);
  for (int64_t i = sink.count < cap ? sink.count : cap; i < cap; ++i) {
    pos[i * C + chunk] = -1;
    hsh[i * C + chunk] = 0;
  }
  count[chunk] = sink.count;
}

}  // namespace

extern "C" int nj_window_emit(const void* h, const void* flags, int64_t L, int64_t C, int w,
                              int64_t off, int64_t cap, void* sk, void* sp, void* pos,
                              void* hsh, void* count, void* stream) {
  const int threads = 64;
  const int64_t blocks = (C + threads - 1) / threads;
  window_emit_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)h, (const int8_t*)flags, L, C, w, off, cap, (uint64_t*)sk,
      (int32_t*)sp, (int64_t*)pos, (uint64_t*)hsh, (int64_t*)count);
  return (int)cudaGetLastError();
}
