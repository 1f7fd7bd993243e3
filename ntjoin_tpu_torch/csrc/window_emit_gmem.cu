// Kernel 2 of the minimizer sketch, device-memory route: windowed argmin with
// the emission step and per-chunk compaction for any window, its rows read
// from device memory.
//
// Replaces: ntjoin_tpu/ops/sketch_pallas.py, _window_emit_kernel (launched by
// _window_emit_chunked), as window_emit.cu does; the contract is stated there
// (plain version: ntjoin_tpu_torch/ops/sketch_cuda.py, window_emit_ref).
// The wrapper takes this route where three w-row segments of one chunk do not
// fit in a thread block's shared memory (w > 8,362); it serves any w.
//
// What bounds it on an H100: memory (8 B of hash and 1 B of flags read per
// window; emissions are ~2 per w windows).  Design: a thread block owns a
// tile of 8, 4, 2 or 1 neighbouring chunks (the widest that still gives the
// card two thread blocks an SM: the hashes of neighbouring chunks share a
// row's sectors) and walks their blocks of w windows in order, as the
// one-chunk tiles of window_emit.cu do, but reads its rows from device memory
// where they have their ring: 128 threads (256 for a tile of one chunk)
// split a segment's rows, eight rows a thread in registers a pass
// (vanherk.cuh, namespace split), the passes' minima of a segment noted
// while it goes by as the block's second segment, so a hash is read twice,
// the second time from L2.  After every pass the threads decide their
// windows' emissions (`prev` from the neighbouring thread's last window, from
// the pass before, or from the block before), a scan of the counts gives each
// thread its slot in the chunk's list, and the threads that emit write the
// minimum they hold in registers.  The running count and `prev` carry from
// block to block, so the emissions come out in order; no scratch in device
// memory.
// A thread block per tile of chunks and not a grid over (chunk, block of
// windows), because the latter needs the counts scanned over a chunk's blocks
// and a second pass that finds every argmin again to write it: twice the reads
// for 5 times the thread blocks, where 419 tiles at w=10000 already give
// every SM its thread blocks.  Small thread blocks, because several of them
// an SM overlap one's scans and barriers with another's loads: 128 threads a
// tile of 8 chunks took 2.3 ms where 256 took 2.6 and 512 3.0.
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), 2^27 bases, k=32: 2.3 ms at
// w=10000 against a bound of 0.44 ms, where one thread per chunk with its
// suffix minima in a device-memory scratch took 52 ms; 2.2 ms at w=5000 and
// 1.8 ms at w=1000, beside 2.8 and 1.35 ms for the shared-memory tiles.  With
// the scans compiled out it takes 1.9 ms (tiles of 4, 256 threads, of 2.75),
// with the loads too 1.5 ms: the emission passes' barriers and scans are what
// is left, not the bytes.
#include "vanherk.cuh"

namespace {

namespace split = vanherk::split;

// Emissions of one tile's windows, pass by pass (the sink of
// split::block_windows).  Thread tid is row group tid / T of chunk `chunk`
// (-1: past the last).
template <int T>
struct EmitSink {
  const int8_t* __restrict__ flags;
  int64_t f_pitch, C, chunk, L, cap, base;
  int w;
  int64_t* __restrict__ pos;
  uint64_t* __restrict__ hsh;
  int32_t* last_s;  // (threads) element of each thread's last window
  int32_t* prev_s;  // (T) element of the last window of the pass before
  int* cnt;         // (32 * T) scan buffer of the counts
  int64_t running;  // emissions of the chunk so far
  int8_t f[split::kRows];

  __device__ bool live(int t) const { return chunk >= 0 && t < w && base + t < L; }

  __device__ void prefetch(int t0) {
#pragma unroll
    for (int r = 0; r < split::kRows; ++r)
      f[r] = live(t0 + r) ? flags[(base + t0 + r) * f_pitch + chunk] : 0;
  }

  __device__ void windows(int t0, const uint64_t (&key)[split::kRows],
                          const uint32_t (&arg)[split::kRows]) {
    constexpr int R = split::kRows;
    const int col = threadIdx.x % T;
    last_s[threadIdx.x] = (int32_t)(base + arg[R - 1]);
    __syncthreads();
    int32_t prev = threadIdx.x < T ? prev_s[col] : last_s[threadIdx.x - T];
    int n = 0;
    unsigned emits = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int32_t s = (int32_t)(base + arg[r]);
      if (live(t0 + r) && (f[r] & 1) && ((f[r] & 2) || s != prev)) {
        ++n;
        emits |= 1u << r;
      }
      prev = s;
    }
    int total;
    int64_t slot = running + split::block_exclusive_sum<T>(n, cnt, total);
    running += total;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (emits >> r & 1) {
        if (slot < cap) {
          pos[slot * C + chunk] = chunk * L + base + arg[r];
          hsh[slot * C + chunk] = key[r];  // the minimum is the hash at its argmin
        }
        ++slot;
      }
      // the last window of this pass (a pass ends with the segment or with
      // the threads' rows): the next pass' or block's first `prev`
      const int t = t0 + r;
      if (t == w - 1 || (t < w && r == R - 1 && threadIdx.x / T == blockDim.x / T - 1))
        prev_s[col] = (int32_t)(base + arg[r]);
    }
  }
};

template <int T>
__global__ void __launch_bounds__(split::kMaxThreads)
    window_emit_gmem_kernel(const uint64_t* __restrict__ h, int64_t h_pitch,
                            const int8_t* __restrict__ flags, int64_t f_pitch, int64_t L,
                            int64_t C, int w, int64_t off, int64_t cap,
                            int64_t* __restrict__ pos, uint64_t* __restrict__ hsh,
                            int64_t* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char sub[];
  __shared__ split::Shared<T> sm;
  __shared__ int32_t last_s[split::kMaxThreads];
  __shared__ int32_t prev_s[T];
  __shared__ int cnt[split::kMaxThreads / 32 * T];
  const int64_t c = blockIdx.x * (int64_t)T + threadIdx.x % T;
  const int64_t chunk = c < C ? c : -1;
  if (threadIdx.x < T) prev_s[threadIdx.x] = -1;  // ordered by the first scan's barrier
  EmitSink<T> sink{flags, f_pitch, C, chunk, L, cap, 0, w, pos, hsh, last_s, prev_s, cnt, 0, {}};
  const int nb = (int)((L + w - 1) / w);
  split::Walk walk;
  for (int b = 0; b < nb; ++b) {
    sink.base = (int64_t)b * w;
    split::block_windows<T>(h, h_pitch, chunk, L, w, off, b, sm, sub, &walk, sink);
  }
  if (chunk < 0) return;
  // i % T is the thread's own column: blockDim.x is a multiple of T
  for (int64_t i = threadIdx.x; i < cap * T; i += blockDim.x) {
    const int64_t slot = i / T;
    if (slot >= sink.running) {
      pos[slot * C + chunk] = -1;
      hsh[slot * C + chunk] = 0;
    }
  }
  if (threadIdx.x < T) count[chunk] = sink.running;
}

template <int T>
int launch_gmem(const void* h, int64_t h_pitch, const void* flags, int64_t f_pitch, int64_t L,
                int64_t C, int w, int64_t off, int64_t cap, int threads, void* pos, void* hsh,
                void* count, void* stream) {
  const auto kernel = window_emit_gmem_kernel<T>;
  const size_t bytes = split::sub_bytes(w, T, threads);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((C + T - 1) / T), threads, bytes, (cudaStream_t)stream>>>(
      (const uint64_t*)h, h_pitch, (const int8_t*)flags, f_pitch, L, C, w, off, cap,
      (int64_t*)pos, (uint64_t*)hsh, (int64_t*)count);
  return (int)cudaGetLastError();
}

}  // namespace

// tile: chunks per thread block, 8, 4, 2 or 1; threads: of a block, a
// multiple of 32 up to 512 (sketch_cuda.split_threads).
extern "C" int nj_window_emit_gmem(const void* h, int64_t h_pitch, const void* flags,
                                   int64_t f_pitch, int64_t L, int64_t C, int w, int64_t off,
                                   int64_t cap, int tile, int threads, void* pos, void* hsh,
                                   void* count, void* stream) {
  if (w < 1 || threads < 32 || threads > split::kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 8:
      return launch_gmem<8>(h, h_pitch, flags, f_pitch, L, C, w, off, cap, threads, pos, hsh,
                            count, stream);
    case 4:
      return launch_gmem<4>(h, h_pitch, flags, f_pitch, L, C, w, off, cap, threads, pos, hsh,
                            count, stream);
    case 2:
      return launch_gmem<2>(h, h_pitch, flags, f_pitch, L, C, w, off, cap, threads, pos, hsh,
                            count, stream);
    case 1:
      return launch_gmem<1>(h, h_pitch, flags, f_pitch, L, C, w, off, cap, threads, pos, hsh,
                            count, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
