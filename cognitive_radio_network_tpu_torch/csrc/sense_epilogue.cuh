// The tail of the sense chain, shared by the two sense kernels
// (fused_sense_ct.cu: spectrum and features; fused_sense.cu: features only)
// through fft512_warp.cuh: the bin magnitude, then per cycle the mean over the A buffers, the band
// amplitude sums through the (512, 4) indicator matrix, and their squares
// (CE_Predictive_Node.cpp:152-154 and :173-197).
//
// One block of 128 threads finishes one cycle: thread t owns bins t, t+128,
// t+256 and t+384 and brings the sum over the A buffers of |X| at each.  The
// band sums reduce over the block in a fixed order (lanes by shuffle, then
// the four warps in turn), so a cycle's features are the same from run to
// run and from kernel to kernel.

#pragma once

#include <cuda_runtime.h>

namespace crn {

constexpr int kSenseN = 512;        // bins per spectrum
constexpr int kSenseThreads = 128;  // threads that finish one cycle
constexpr int kSenseBins = kSenseN / kSenseThreads;  // bins per thread
constexpr int kSenseBands = 4;      // feature columns: NF, CH1, CH2, CH3

// |X| of one bin: cabsf(buffer_F[i]) of CE_Predictive_Node.cpp:153.
__device__ __forceinline__ float magnitude(float re, float im) {
  return sqrtf(re * re + im * im);
}

// acc[j]: sum over the cycle's A buffers of |X[t + 128 j]|.  Writes the
// cycle's averaged spectrum to avg_row (512 floats; skipped when null) and
// its four features to feats_row.  s_red is block-shared scratch.  Every
// thread of the block must call this; it holds one __syncthreads(), and the
// caller places another before s_red is used again.
__device__ __forceinline__ void sense_epilogue(const float (&acc)[kSenseBins], int averaging,
                                               const float* __restrict__ band,
                                               float* __restrict__ avg_row,
                                               float* __restrict__ feats_row,
                                               float (*s_red)[kSenseBands]) {
  const int t = threadIdx.x;
  // mean over the A buffers (sum, then divide), then the band partial sums
  float part[kSenseBands] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kSenseBins; ++j) {
    const int k = t + j * kSenseThreads;
    const float v = acc[j] / static_cast<float>(averaging);
    if (avg_row != nullptr) avg_row[k] = v;
#pragma unroll
    for (int q = 0; q < kSenseBands; ++q) part[q] += band[k * kSenseBands + q] * v;
  }
#pragma unroll
  for (int q = 0; q < kSenseBands; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part[q] += __shfl_down_sync(0xffffffffu, part[q], off);
  }
  if ((t & 31) == 0) {
#pragma unroll
    for (int q = 0; q < kSenseBands; ++q) s_red[t >> 5][q] = part[q];
  }
  __syncthreads();
  if (t < kSenseBands) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kSenseThreads / 32; ++w) sum += s_red[w][t];
    feats_row[t] = sum * sum;  // power = (sum |X|)^2, CE_Predictive_Node.cpp:193-197
  }
}

}  // namespace crn
