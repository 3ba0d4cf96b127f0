// Window extraction for NVIDIA Hopper (sm_90a): K windows of wlen samples
// from two float32 planes at dynamic offsets, out_x[k, j] = x[o_k + j].
//
// Replaces the Pallas TPU kernel cognitive_radio_network_tpu/ops/extract.py
// (function _extract_kernel), which DMAs a 1024-aligned slab per window and
// realigns it in VMEM with lane rolls, because Mosaic slices device memory
// only at tile boundaries.  A GPU thread reads any address, so none of that
// carries over: each window is a plain copy.
//
// Contract (see ops/extract.py for the wrapper that checks it):
//   rr, ri    (n,)        float32, contiguous
//   offsets   (k,)        int32 or int64, as the caller holds them; each is
//                         clipped to [0, max(n - wlen, 0)]
//   out_r/i   (k, wlen)   float32, row-major; where n < wlen the samples
//                         past n are 0, as the reference's fallback pads
//
// What bounds it: nothing but device memory.  Each output sample costs one
// 4-byte load and one 4-byte store per plane, and no arithmetic.  Windows
// may overlap (refinement windows around nearby candidates), so reads of
// one sample by several windows hit L2.  The design keeps every access
// coalesced: neighbouring threads copy neighbouring samples of one window,
// so a warp reads 128 contiguous bytes (two lines when the offset is not
// 32-aligned) and writes 128 contiguous bytes.
//
// Layout: grid (k, ceil(wlen / 1024)); block 256 threads; each block copies
// one 1024-sample chunk of one window from both planes, 4 samples a thread
// at stride 256.  Each block clips its window's offset once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;

// Offset: int32_t or int64_t, the offsets as the caller holds them.
template <typename Offset>
__global__ void __launch_bounds__(kThreads)
extract_windows_kernel(const float* __restrict__ rr, const float* __restrict__ ri,
                       const Offset* __restrict__ offsets, float* __restrict__ out_r,
                       float* __restrict__ out_i, int64_t n, int wlen) {
  const int64_t w = blockIdx.x;
  const int64_t hi = n > wlen ? n - wlen : 0;
  int64_t o = offsets[w];
  o = o < 0 ? 0 : (o > hi ? hi : o);
  const int64_t row = w * wlen;
  const int j0 = blockIdx.y * kChunk + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int j = j0 + i * kThreads;
    if (j < wlen) {
      const int64_t src = o + j;
      const bool in = src < n;  // false only when n < wlen
      out_r[row + j] = in ? rr[src] : 0.0f;
      out_i[row + j] = in ? ri[src] : 0.0f;
    }
  }
}

template <typename Offset>
void launch(const void* rr, const void* ri, const void* offsets, void* out_r, void* out_i,
            long long n, int k, int wlen, void* stream) {
  const dim3 grid(static_cast<unsigned>(k), static_cast<unsigned>((wlen + kChunk - 1) / kChunk));
  extract_windows_kernel<Offset><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rr), static_cast<const float*>(ri),
      static_cast<const Offset*>(offsets), static_cast<float*>(out_r),
      static_cast<float*>(out_i), static_cast<int64_t>(n), wlen);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `offsets_i32` says which integer the offsets are.  The wrapper launches
// nothing when k or wlen is 0.
extern "C" int crn_extract_windows(const void* rr, const void* ri, const void* offsets,
                                   int offsets_i32, void* out_r, void* out_i, long long n, int k,
                                   int wlen, void* stream) {
  if (offsets_i32) {
    launch<int32_t>(rr, ri, offsets, out_r, out_i, n, k, wlen, stream);
  } else {
    launch<int64_t>(rr, ri, offsets, out_r, out_i, n, k, wlen, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
