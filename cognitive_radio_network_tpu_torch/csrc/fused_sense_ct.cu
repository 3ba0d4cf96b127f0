// Fused sense chain for NVIDIA Hopper (sm_90a): planar IQ rows -> 512-point
// FFT -> |X| -> mean over the A buffers of a cycle -> band amplitude sums,
// squared.
//
// Replaces the Pallas TPU kernel cognitive_radio_network_tpu/ops/fused_sense_ct.py
// (function _kernel), which factors the DFT as 4 x 128 so the 128-point
// stage lands on the TPU's matrix unit.  This kernel keeps what that one
// computes, not how: the same outputs, in natural bin order, from an FFT
// that lives in registers.
//
// Contract (see ops/fused_sense_ct.py for the wrapper that checks it):
//   xr, xi  (C*A, 512) float32 or bfloat16, row-major, contiguous
//   tw      (2, 512)   float32: cos and sin of -2*pi*k/512, built in float64
//   band    (512, 4)   float32 0/1 indicator, natural bin order
//   avg     (C, 512)   float32 out: sum_a |X_a[k]| / A
//   feats   (C, 4)     float32 out: (sum_k band[k, j] * avg[k])^2
//
// Precision: every stage runs in float32 at every `precision` of the
// wrapper; bf16 input is upcast right after the load, as the TPU kernel does.
// An f32 FFT meets the bounds of all three rungs of the reference's ladder.
//
// What bounds it: per sample the kernel reads 8 bytes (f32) or 4 bytes
// (bf16) from device memory and does about 50 flops, about 6 flops per byte,
// far below the card's compute-to-bandwidth ratio: device-memory bandwidth
// bounds it, and the instruction rate comes second (at the memory bound an SM
// has about 290 clocks per row, and a row is about 850 warp instructions).
// The design therefore keeps a row's FFT in registers, touches shared memory
// once per row, and keeps the next row's loads in flight while the current
// row computes.  Measured on an H100 80GB HBM3 at 700 W, C = 4096 f32: with
// the arithmetic taken out the loads alone take 0.068 ms, the whole kernel
// 0.076-0.077 ms: all but about 0.01 ms of the arithmetic hides under the loads.
//
// The FFT (512 = 16 x 32, a warp per row, in registers) and the block's walk
// over cycles (row classes rotating over 4 warps, class sums added in class
// order, no atomics) are in fft512_warp.cuh, shared with the features-only
// kernel (fused_sense.cu); the cycle's tail is in sense_epilogue.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft512_warp.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(crn::kSenseThreads, crn::kFftBlocksPerSm)
fused_sense_ct_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                      const float* __restrict__ tw, const float* __restrict__ band,
                      float* __restrict__ avg, float* __restrict__ feats, int cycles,
                      int averaging) {
  crn::sense_cycles<T, true>(xr, xi, tw, band, avg, feats, cycles, averaging);
}

}  // namespace

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller checks shapes, types and contiguity; it allocates avg and feats.
extern "C" int crn_fused_sense_ct(const void* xr, const void* xi, int is_bf16, const void* tw,
                                  const void* band, void* avg, void* feats, int cycles,
                                  int averaging, void* stream) {
  if (cycles <= 0 || averaging <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  const cudaError_t err = crn::sense_grid(cycles, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(crn::kSenseThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* twf = static_cast<const float*>(tw);
  const float* bandf = static_cast<const float*>(band);
  float* avgf = static_cast<float*>(avg);
  float* featsf = static_cast<float*>(feats);
  if (is_bf16) {
    fused_sense_ct_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(xr), static_cast<const uint16_t*>(xi), twf, bandf, avgf,
        featsf, cycles, averaging);
  } else {
    fused_sense_ct_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(xr), static_cast<const float*>(xi), twf, bandf, avgf, featsf,
        cycles, averaging);
  }
  return static_cast<int>(cudaGetLastError());
}
