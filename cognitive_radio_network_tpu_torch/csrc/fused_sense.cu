// Features-only sense chain for NVIDIA Hopper (sm_90a): planar IQ rows ->
// 512-point DFT -> |X| -> mean over the A buffers of a cycle -> band amplitude
// sums, squared.  No spectrum leaves the chip.
//
// Replaces the Pallas TPU kernel cognitive_radio_network_tpu/ops/fused_sense.py
// (function _kernel), which computes the DFT as four f32 matmuls against the
// (512, 512) cos and sin matrices, because a dense product is how a TPU's
// matrix unit gets a spectrum, and keeps the spectra out of device memory.
// The function is "(C*A, 512) planes -> (C, 4) features" in full float32 (the
// reference's contract is f32-HIGHEST, which TF32 tensor cores would miss);
// the dense product costs 8 * 512 flops per sample where an FFT needs about
// 50, so on this card the spectrum comes from the register FFT of
// fft512_warp.cuh, the one fused_sense_ct.cu runs, in float32 throughout.
//
// Contract (the wrapper in ops/fused_sense.py checks it):
//   xr, xi  (C*A, 512) float32, row-major, contiguous
//   tw      (2, 512)   float32: cos and sin of -2*pi*k/512, built in float64
//   band    (512, 4)   float32 0/1 indicator, natural bin order
//   feats   (C, 4)     float32 out: (sum_k band[k, j] * mean_a |X_a[k]|)^2
//
// What bounds it: 8 bytes read and about 50 flops per sample, 16 bytes
// written per cycle: device-memory bandwidth, as for fused_sense_ct.cu, less
// that kernel's (C, 512) spectrum write.  The design is that kernel's (a warp
// per row, one trip through shared memory per row, the next row's loads in
// flight, class sums added in class order, no atomics), so a cycle's bits are
// the same from run to run, whatever C is and whichever block ran it, and the
// features are the ones fused_sense_ct.cu writes beside its spectrum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft512_warp.cuh"

namespace {

__global__ void __launch_bounds__(crn::kSenseThreads, crn::kFftBlocksPerSm)
fused_sense_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   const float* __restrict__ tw, const float* __restrict__ band,
                   float* __restrict__ feats, int cycles, int averaging) {
  crn::sense_cycles<float, false>(xr, xi, tw, band, nullptr, feats, cycles, averaging);
}

}  // namespace

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller checks shapes, types and contiguity; it allocates feats.
extern "C" int crn_fused_sense(const void* xr, const void* xi, const void* tw, const void* band,
                               void* feats, int cycles, int averaging, void* stream) {
  if (cycles <= 0 || averaging <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  const cudaError_t err = crn::sense_grid(cycles, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_sense_kernel<<<grid, dim3(crn::kSenseThreads), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(tw), static_cast<const float*>(band),
      static_cast<float*>(feats), cycles, averaging);
  return static_cast<int>(cudaGetLastError());
}
