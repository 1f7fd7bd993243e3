// Window flags of the minimizer sketch: which windows are valid, and which
// are the first valid window after an invalid one.
//
// Replaces: the XLA code of ntjoin_tpu/ops/sketch_pallas.py that builds the
// `flags` input of _window_emit_chunked (a cumulative sum of the k-mer valid
// flags and its differences; no TPU kernel).  In PyTorch the same cumulative
// sum moved some 5 GB for a function of 0.3 GB and was two thirds of the fused
// sketch call on an NVIDIA H100, hence a kernel.
//
// Contract (plain version: ntjoin_tpu_torch/ops/sketch_cuda.py,
// window_flags_ref).  val (rows, C) int8 holds 1 where the k-mer ending at
// the row is valid; element e of column c is row off + e.  For window j in
// [0, L), flags[j, c] bit0 = all of elements j .. j + w - 1 are valid, bit1 =
// bit0 and (j = 0 or bit0 of window j - 1 is clear).  val and flags have row
// pitches v_pitch and f_pitch (elements); columns past C are not touched.
//
// What bounds it on an H100: memory, (L + w - 1) + L bytes a column.  Design:
// with lastbad(e) the greatest element <= e that is invalid (-1: none),
// window j is valid iff lastbad(j + w - 1) < j, a running maximum down the
// column instead of a sum.  A thread owns four neighbouring columns, one
// 32-bit word of a row, so a warp reads and writes 128 bytes of a row at a
// time; a thread block owns 128 columns and one band of rows, and its 32
// warps cut the band, and the w rows before it, into segments.  Thread
// (segment, columns) first finds the last invalid element of its segment; a
// fold over the segments before it, in shared memory, gives its carry
// (nothing further back than w rows can reach a window that ends in the band
// or the one before its first, so the bands need nothing from each other); a
// second walk writes the flags of the windows that end in its rows of the
// band.  The rows before the band are read twice more, from L2: the wrapper
// keeps the bands at least as long as w, and takes as many as give the card
// two thread blocks an SM.  On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md),
// 2^27 bases, k=32: 0.25 / 0.32 / 0.36 ms at w=1000 / 5000 / 10000 against a
// bound of 0.09 ms, where the cumulative sum in PyTorch took 4.9 / 12.2 / 21.2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024, kSegs = kThreads / 32;

__device__ __forceinline__ uint32_t load4(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
    flags_kernel(const int8_t* __restrict__ val, int64_t v_pitch, int64_t L, int64_t C, int w,
                 int64_t off, int band, int8_t* __restrict__ flags, int64_t f_pitch) {
  __shared__ int32_t last_of[kSegs][32][4];
  const int lane = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const int64_t groups = (C + 127) / 128;
  const int64_t c = (blockIdx.x % groups) * 128 + 4 * lane;
  const int32_t n_el = (int32_t)(L + w - 1);
  // the band's elements [b0, b1), and the rows that can reach its windows
  const int32_t b0 = (int32_t)(blockIdx.x / groups) * band, b1 = min(b0 + band, n_el);
  const int32_t lo = max(b0 - w, 0);  // w - 1 rows for the band's first window, one more for bit1
  const int32_t len = (b1 - lo + kSegs - 1) / kSegs;
  const int32_t e0 = min(lo + seg * len, b1), e1 = min(e0 + len, b1);
  const int8_t* v = val + off * v_pitch + c;

  int32_t last[4] = {-1, -1, -1, -1};
  if (c < C) {
#pragma unroll 8
    for (int32_t e = e0; e < e1; ++e) {
      const uint32_t x = load4(v + e * v_pitch);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if ((x >> (8 * i) & 0xFF) == 0) last[i] = e;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) last_of[seg][lane][i] = last[i];
  __syncthreads();
  const int32_t first = max(max(e0, b0), w - 1);  // the first element that ends a window here
  if (c >= C || first >= e1) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) last[i] = -1;
  for (int s = 0; s < seg; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) last[i] = max(last[i], last_of[s][lane][i]);
  }
  // rows of the segment before `first` belong to the band before or end no
  // window: they only move the carry
  for (int32_t e = e0; e < first; ++e) {
    const uint32_t x = load4(v + e * v_pitch);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((x >> (8 * i) & 0xFF) == 0) last[i] = e;
  }
  // window j = e - w + 1 ends at element e; the window before `first`'s saw
  // the carry
  bool before[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) before[i] = first >= w && last[i] < first - w;
  int8_t* f = flags + c;
#pragma unroll 8
  for (int32_t e = first; e < e1; ++e) {
    const uint32_t x = load4(v + e * v_pitch);
    const int32_t j = e - w + 1;
    uint32_t out = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if ((x >> (8 * i) & 0xFF) == 0) last[i] = e;
      const bool ok = last[i] < j;
      out |= (uint32_t)(ok | ((ok && !before[i]) << 1)) << (8 * i);
      before[i] = ok;
    }
    *reinterpret_cast<uint32_t*>(f + j * f_pitch) = out;
  }
}

}  // namespace

// band: elements of a band of rows (sketch_cuda.flag_band).  val and flags
// must be 4-byte aligned with pitches that are multiples of 4, at least C
// rounded up to 4: the four columns of a thread's word lie inside a row, and
// the pad columns of flags are written.
extern "C" int nj_flags(const void* val, int64_t v_pitch, int64_t L, int64_t C, int w,
                        int64_t off, int band, void* flags, int64_t f_pitch, void* stream) {
  if (w < 1 || band < 1 || L + w - 1 > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (C + 127) / 128 * ((L + w - 1 + band - 1) / band);
  flags_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)val, v_pitch, L, C, w, off, band, (int8_t*)flags, f_pitch);
  return (int)cudaGetLastError();
}
