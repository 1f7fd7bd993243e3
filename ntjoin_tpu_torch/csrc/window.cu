// Kernel 3 of the minimizer sketch: the exact windowed argmin over a list of
// chunks, one thread per (listed chunk, block of w windows), every window
// written out.
//
// Replaces: ntjoin_tpu/ops/sketch_pallas.py, _window_kernel_v2 and
// _window_kernel (launched by _window_chunked), the TPU's exact fallback when
// emission slots overflow.  The port runs it over the chunks whose emission
// count exceeded the capacity of kernel 2 (window_emit.cu); the other chunks
// keep kernel 2's lists.
//
// Contract (plain version: ntjoin_tpu_torch/ops/sketch_cuda.py,
// window_argmin_ref).  For listed chunk c = chunks[i], am[j, i] = c*L + s,
// where s is the leftmost element of minimal hash in window j of chunk c;
// windows j in [0, L), elements at rows off + s of h (rows, C), row pitch
// h_pitch elements.
//
// What bounds it on an H100: memory when many chunks are listed (per window
// 16 B of hashes read, 24 B of scratch moved, 8 B written), latency when few
// are, as on the main path, where a handful of chunks overflow.  The scan is
// the same constant-work Van Herk as kernel 2 (vanherk.cuh), but its blocks
// need no emission order, so each thread takes one block: a thread walks 2w
// elements instead of L + w, and a chunk's ceil(L/w) blocks run side by side.
#include "vanherk.cuh"

namespace {

struct ArgSink {
  int64_t n_sel, i, chunk, L;
  int64_t* __restrict__ am;

  __device__ void operator()(int64_t j, uint64_t, int32_t s) {
    am[j * n_sel + i] = chunk * L + s;
  }
};

// Thread g takes block b = g / n_sel of listed chunk i = g % n_sel, so a
// warp's threads share a block and read neighbouring chunks' hashes.
// Scratch is (w, n_sel * nb), column g.
__global__ void window_kernel(const uint64_t* __restrict__ h, int64_t L, int64_t h_pitch, int w,
                              int64_t off, const int64_t* __restrict__ chunks, int64_t n_sel,
                              uint64_t* __restrict__ sk, int32_t* __restrict__ sp,
                              int64_t* __restrict__ am) {
  const int64_t nb = (L + w - 1) / w;
  const int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (g >= n_sel * nb) return;
  const int64_t i = g % n_sel;
  const int64_t chunk = chunks[i];
  ArgSink sink{n_sel, i, chunk, L, am};
  vanherk::scan_block(h, h_pitch, chunk, L, w, off, (g / n_sel) * w, sk, sp, n_sel * nb, g, sink);
}

}  // namespace

// sk, sp: scratch of w * n_sel * ceil(L / w) entries each.
extern "C" int nj_window(const void* h, int64_t L, int64_t h_pitch, int w, int64_t off,
                         const void* chunks, int64_t n_sel, void* sk, void* sp, void* am,
                         void* stream) {
  const int threads = 64;
  const int64_t blocks = (n_sel * ((L + w - 1) / w) + threads - 1) / threads;
  window_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)h, L, h_pitch, w, off, (const int64_t*)chunks, n_sel, (uint64_t*)sk,
      (int32_t*)sp, (int64_t*)am);
  return (int)cudaGetLastError();
}
