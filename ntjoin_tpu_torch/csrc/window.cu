// Kernel 3 of the minimizer sketch: the exact windowed argmin over a list of
// chunks, one thread block per (tile of listed chunks, block of w windows),
// every window written out.
//
// Replaces: ntjoin_tpu/ops/sketch_pallas.py, _window_kernel_v2 and
// _window_kernel (launched by _window_chunked), the TPU's exact fallback when
// emission slots overflow.  The port runs it over the chunks whose emission
// count exceeded the capacity of kernel 2 (window_emit.cu); the other chunks
// keep kernel 2's lists.
//
// Contract (plain version: ntjoin_tpu_torch/ops/sketch_cuda.py,
// window_argmin_ref).  For listed chunk c = chunks[i] (c = i where chunks is
// null: every chunk), am[j, i] = c*L + s, where s is the leftmost element of
// minimal hash in window j of chunk c; windows j in [0, L), elements at rows
// off + s of h (rows, C), row pitch h_pitch elements.
//
// What bounds it on an H100: latency when few chunks are listed, as on the
// main path, where a handful overflow; memory when many are (per window 8 B
// of hash read, 8 B written).  Design (vanherk.cuh, namespace split): the w
// rows of the block's segment and of the next one are split over the
// threads of a block, up to 512 of them, eight rows a thread in registers;
// no scratch in device memory.  A thread block and not a warp, because at the
// few chunks of the main path the whole launch is a handful of (chunk, block)
// units and their time is the longest chain of dependent steps in one of
// them: 2w rows over 128 threads at w=1000 are sixteen loads a thread, all
// in flight at once, and two scans.  There the blocks of a chunk need no
// order, so each is a thread block of its own, and since listed chunks are
// scattered a tile is one chunk: a row read is 8 useful bytes of a sector.
// Where every chunk is listed (chunks null) a tile is up to 32 neighbouring
// chunks, whose hashes and results of a row are one run of 256 bytes (with
// tiles of 4, the 32-byte stores of the results alone took a millisecond at
// 2^27 bases), and a thread block walks its tile's blocks of windows in
// order, so that a segment serves two blocks for one read from device memory.
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), 2^27 bases, k=32, w=1000:
// 0.006 ms on the card over the 4 chunks that overflow (an empty launch takes
// 0.002 ms; one thread per (chunk, block) with its suffix minima in a
// device-memory scratch took 0.37 ms) and 1.9 ms over all 32,577 chunks
// (bound 0.72 ms; 3.9 ms before), of which 0.9 ms remain with every load and
// store compiled out: the barriers and the folds over the warps' minima.
#include "vanherk.cuh"

namespace {

namespace split = vanherk::split;

struct ArgSink {
  int64_t* __restrict__ am;
  int64_t n_sel, i, chunk, L, base;
  int w;

  __device__ void prefetch(int) {}

  __device__ void windows(int t0, const uint64_t (&)[split::kRows],
                          const uint32_t (&arg)[split::kRows]) {
#pragma unroll
    for (int r = 0; r < split::kRows; ++r) {
      const int64_t j = base + t0 + r;
      if (chunk >= 0 && t0 + r < w && j < L) am[j * n_sel + i] = chunk * L + base + arg[r];
    }
  }
};

// A list of chunks (kWalk false): thread block u takes tile u % n_tiles of the
// list and block u / n_tiles of its windows, each by itself: the fewest
// steps in a row when the launch is a handful of them.  Every chunk (kWalk
// true): thread block u takes tile u and walks its blocks of windows in order,
// handing each block's second segment on to the next.
template <int T, bool kWalk>
__global__ void __launch_bounds__(split::kMaxThreads)
    window_kernel(const uint64_t* __restrict__ h, int64_t L, int64_t h_pitch, int w, int64_t off,
                  const int64_t* __restrict__ chunks, int64_t n_sel, int64_t* __restrict__ am) {
  extern __shared__ __align__(16) unsigned char sub[];
  __shared__ split::Shared<T> sm;
  const int64_t n_tiles = (n_sel + T - 1) / T;
  const int64_t i = (blockIdx.x % n_tiles) * T + threadIdx.x % T;
  const int64_t chunk = i < n_sel ? (chunks ? chunks[i] : i) : -1;
  ArgSink sink{am, n_sel, i, chunk, L, 0, w};
  if (kWalk) {
    split::Walk walk;
    const int nb = (int)((L + w - 1) / w);
    for (int b = 0; b < nb; ++b) {
      sink.base = (int64_t)b * w;
      split::block_windows<T>(h, h_pitch, chunk, L, w, off, b, sm, sub, &walk, sink);
    }
  } else {
    const int b = (int)(blockIdx.x / n_tiles);
    sink.base = (int64_t)b * w;
    split::block_windows<T>(h, h_pitch, chunk, L, w, off, b, sm, sub, nullptr, sink);
  }
}

template <int T, bool kWalk>
int launch(const void* h, int64_t L, int64_t h_pitch, int w, int64_t off, const void* chunks,
           int64_t n_sel, int threads, void* am, void* stream) {
  const auto kernel = window_kernel<T, kWalk>;
  const size_t bytes = split::sub_bytes(w, T, threads);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (n_sel + T - 1) / T * (kWalk ? 1 : (L + w - 1) / w);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, bytes, (cudaStream_t)stream>>>(
      (const uint64_t*)h, L, h_pitch, w, off, (const int64_t*)chunks, n_sel, (int64_t*)am);
  return (int)cudaGetLastError();
}

}  // namespace

// chunks: the listed chunks, or null for all n_sel = C of them.  tile: chunks
// per thread block, 32, 16, 8, 4 or 1 (1 for a list); threads: of a block, a multiple of 32 up to
// 512 (sketch_cuda.split_threads).
extern "C" int nj_window(const void* h, int64_t L, int64_t h_pitch, int w, int64_t off,
                         const void* chunks, int64_t n_sel, int tile, int threads, void* am,
                         void* stream) {
  if (w < 1 || threads < 32 || threads > split::kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (chunks) {
    if (tile != 1) return (int)cudaErrorInvalidValue;
    return launch<1, false>(h, L, h_pitch, w, off, chunks, n_sel, threads, am, stream);
  }
  switch (tile) {
    case 32:
      return launch<32, true>(h, L, h_pitch, w, off, chunks, n_sel, threads, am, stream);
    case 16:
      return launch<16, true>(h, L, h_pitch, w, off, chunks, n_sel, threads, am, stream);
    case 8:
      return launch<8, true>(h, L, h_pitch, w, off, chunks, n_sel, threads, am, stream);
    case 4:
      return launch<4, true>(h, L, h_pitch, w, off, chunks, n_sel, threads, am, stream);
    case 1:
      return launch<1, true>(h, L, h_pitch, w, off, chunks, n_sel, threads, am, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
