// The classify tail of the sense chain (models/sense.py after the features):
// per cycle x = log1p(feats) (checkpoints trained on log features) or feats,
// the 4-H-3 sigmoid MLP (CE_Predictive_Node.cpp:214-235) and the decision,
// the first output >= threshold, 1-indexed, else 0 (:245-261).  The classify
// form of fused_sense_ct.cu passes it to the walk of fft512_warp.cuh.
//
// The block stages the weights in shared memory once, after its first row's
// loads are issued (staged first, the stores waited for the weights' loads
// before any row load left).  One warp runs a cycle's tail: lane j < H holds
// hidden unit j, lanes 0-2 the outputs, in float32 FMAs with expf and log1pf
// (no fast math; the one intrinsic, __frcp_rn, is rounded as the division it
// replaces).  The features come from the warps' partial sums in the
// epilogue's order, so they are the bits the kernel writes to feats.

#pragma once

#include <cuda_runtime.h>

#include "sense_epilogue.cuh"

namespace crn {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHidden = 32;  // one hidden unit per lane of the tail's warp
constexpr int kOutputs = 3;     // occupancy of CH1, CH2, CH3
constexpr int kTailWeights = kMaxHidden * (kSenseBands + 1 + kOutputs) + kOutputs;

// 1 / (1 + e^-v) as PyTorch's sigmoid computes it in float32; the reciprocal
// rounded to nearest is the bits of 1.0f / x in fewer instructions.
__device__ __forceinline__ float sigmoid(float v) { return __frcp_rn(1.0f + expf(-v)); }

// The classify tail of one cycle, run by every lane of one warp.  w is the
// block's shared copy of w1 (4, H) | b1 (H) | w2 (H, 3) | b2 (3), which
// stage() fills.
struct ClassifyTail {
  static constexpr bool kActive = true;
  float* w;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* outputs;
  int* decision;
  int hidden;
  int log1p;
  float threshold;

  __device__ __forceinline__ void stage() const {
    const int n_w1 = kSenseBands * hidden, n_w2 = hidden * kOutputs;
    for (int i = threadIdx.x; i < n_w1 + hidden + n_w2 + kOutputs; i += blockDim.x) {
      float v;
      if (i < n_w1) {
        v = w1[i];
      } else if (i < n_w1 + hidden) {
        v = b1[i - n_w1];
      } else if (i < n_w1 + hidden + n_w2) {
        v = w2[i - n_w1 - hidden];
      } else {
        v = b2[i - n_w1 - hidden - n_w2];
      }
      w[i] = v;
    }
  }

  __device__ __forceinline__ void operator()(long long cycle, int lane,
                                             const float (*s_red)[kSenseBands]) const {
    const int h_n = hidden;
    float f = 0.0f;
    if (lane < kSenseBands) {
      f = band_feature(s_red, lane);  // the bits sense_epilogue wrote to feats
      if (log1p) f = log1pf(f);
    }
    float x[kSenseBands];
#pragma unroll
    for (int q = 0; q < kSenseBands; ++q) x[q] = __shfl_sync(kFull, f, q);
    // hidden unit `lane`: x @ w1[:, lane], then + b1[lane]
    float h = 0.0f;
    if (lane < h_n) {
      float acc = x[0] * w[lane];
#pragma unroll
      for (int q = 1; q < kSenseBands; ++q) acc = fmaf(x[q], w[q * h_n + lane], acc);
      h = sigmoid(acc + w[kSenseBands * h_n + lane]);
    }
    // output k = lane (lanes 3-31 repeat output 0 and write nothing)
    const float* w2 = w + (kSenseBands + 1) * h_n;
    const int k = lane < kOutputs ? lane : 0;
    float o = 0.0f;
#pragma unroll 4
    for (int j = 0; j < h_n; ++j) o = fmaf(__shfl_sync(kFull, h, j), w2[j * kOutputs + k], o);
    o = sigmoid(o + w2[h_n * kOutputs + k]);
    const float o1 = __shfl_sync(kFull, o, 1), o2 = __shfl_sync(kFull, o, 2);
    if (lane < kOutputs) outputs[cycle * kOutputs + lane] = o;
    if (lane == 0) {
      decision[cycle] = o >= threshold ? 1 : o1 >= threshold ? 2 : o2 >= threshold ? 3 : 0;
    }
  }
};

}  // namespace crn
