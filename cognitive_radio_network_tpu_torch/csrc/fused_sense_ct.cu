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
//
// The classify form (crn_fused_sense_classify) is a second instantiation of
// the same walk that also finishes the sense chain of models/sense.py: per
// cycle x = log1p(feats) (checkpoints trained on log features) or feats, the
// 4-H-3 sigmoid MLP (CE_Predictive_Node.cpp:214-235), and the decision, the
// first output >= threshold, 1-indexed, else 0 (:245-261).  It writes
//   outputs  (C, 3) float32 and decision (C,) int32
// beside avg and feats, from
//   w1 (4, H), b1 (H,), w2 (H, 3), b2 (3,) float32, 1 <= H <= kMaxHidden.
// The reference runs that tail as a handful of small XLA operations inside
// one jit; eagerly it was 17 PyTorch operators after the kernel, each a
// launch that cost the host far more than the card.  Here it costs 20 bytes of
// output a cycle beside the 40 KB read, so the kernel's bound does not move.
// The tail is in sense_classify.cuh; fft512_warp.cuh says which warp runs it.
// A cycle's outputs and decision depend on its own bits alone, as its
// features do.
//
// The retune trace (crn_sense_trace) crosses cycles that different blocks
// own, so it is a second kernel on the same stream: one block scans "the last
// non-zero decision" over C in chunks of 4096, carrying it from chunk to
// chunk (the reference's lax.scan at models/sense.py:158).  The other way, the
// last block of the classify launch running the scan after a ticket, needs a
// ticket that is zero at every launch: a memset before it (a second device
// operation anyway) or one counter that launches on two streams would share.
// The separate kernel keeps no state between launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft512_warp.cuh"
#include "sense_classify.cuh"

namespace {

using crn::ClassifyTail;
using crn::kFull;
using crn::kMaxHidden;
using crn::kTailWeights;

template <typename T>
__global__ void __launch_bounds__(crn::kSenseThreads, crn::kFftBlocksPerSm)
fused_sense_classify_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                            const float* __restrict__ tw, const float* __restrict__ band,
                            const float* __restrict__ w1, const float* __restrict__ b1,
                            const float* __restrict__ w2, const float* __restrict__ b2,
                            int hidden, int log1p, float threshold, float* __restrict__ avg,
                            float* __restrict__ feats, float* __restrict__ outputs,
                            int* __restrict__ decision, int cycles, int averaging) {
  __shared__ float s_w[kTailWeights];
  const ClassifyTail tail{s_w, w1, b1, w2, b2, outputs, decision, hidden, log1p, threshold};
  crn::sense_cycles<T, true>(xr, xi, tw, band, avg, feats, cycles, averaging, tail);
}

constexpr int kTraceThreads = 1024;
constexpr int kTracePerThread = 4;  // consecutive cycles a thread scans in its registers
constexpr int kTraceChunk = kTraceThreads * kTracePerThread;

// The scan's operator: the last non-zero decision of "before, then v".
__device__ __forceinline__ int last_nonzero(int before, int v) { return v != 0 ? v : before; }

__device__ __forceinline__ int warp_scan_last(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = last_nonzero(u, v);
  }
  return v;
}

// trace[c] = the tx frequency after cycle c: the channel the last non-zero
// decision at or before c selects (1 -> ch_b, 2 -> ch_a, 3 -> ch_b), or tx0
// (*tx0_ptr when it is not null) before any.  One block.
__global__ void __launch_bounds__(kTraceThreads)
sense_trace_kernel(const int* __restrict__ decision, long long cycles,
                   const float* __restrict__ tx0_ptr, float tx0, float ch_a, float ch_b,
                   float* __restrict__ trace) {
  __shared__ int s_warp[kTraceThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float keep = tx0_ptr != nullptr ? *tx0_ptr : tx0;
  int carry = 0;  // the last non-zero decision before the chunk
  for (long long base = 0; base < cycles; base += kTraceChunk) {
    const long long first = base + static_cast<long long>(t) * kTracePerThread;
    int d[kTracePerThread];
    int run = 0;
#pragma unroll
    for (int i = 0; i < kTracePerThread; ++i) {
      d[i] = first + i < cycles ? decision[first + i] : 0;
      run = last_nonzero(run, d[i]);
    }
    const int incl = warp_scan_last(run, lane);  // through this thread's cycles
    int excl = __shfl_up_sync(kFull, incl, 1);   // through the lane before
    if (lane == 0) excl = 0;
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) s_warp[lane] = warp_scan_last(s_warp[lane], lane);
    __syncthreads();
    int before = warp > 0 ? last_nonzero(carry, s_warp[warp - 1]) : carry;
    before = last_nonzero(before, excl);
#pragma unroll
    for (int i = 0; i < kTracePerThread; ++i) {
      before = last_nonzero(before, d[i]);
      if (first + i < cycles) trace[first + i] = before == 0 ? keep : before == 2 ? ch_a : ch_b;
    }
    carry = last_nonzero(carry, s_warp[kTraceThreads / 32 - 1]);
    __syncthreads();  // s_warp is written again in the next chunk
  }
}

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

// The classify form: launches on `stream` and returns the first CUDA error (0
// on success).  The caller checks shapes, types and contiguity and allocates
// avg, feats, outputs and decision.
extern "C" int crn_fused_sense_classify(const void* xr, const void* xi, int is_bf16,
                                        const void* tw, const void* band, const void* w1,
                                        const void* b1, const void* w2, const void* b2, int hidden,
                                        int log1p, float threshold, void* avg, void* feats,
                                        void* outputs, void* decision, int cycles, int averaging,
                                        void* stream) {
  if (cycles <= 0 || averaging <= 0 || hidden < 1 || hidden > kMaxHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid;
  const cudaError_t err = crn::sense_grid(cycles, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(crn::kSenseThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* twf = static_cast<const float*>(tw);
  const float* bandf = static_cast<const float*>(band);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* b2f = static_cast<const float*>(b2);
  float* avgf = static_cast<float*>(avg);
  float* featsf = static_cast<float*>(feats);
  float* outf = static_cast<float*>(outputs);
  int* dec = static_cast<int*>(decision);
  if (is_bf16) {
    fused_sense_classify_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(xr), static_cast<const uint16_t*>(xi), twf, bandf, w1f, b1f,
        w2f, b2f, hidden, log1p, threshold, avgf, featsf, outf, dec, cycles, averaging);
  } else {
    fused_sense_classify_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(xr), static_cast<const float*>(xi), twf, bandf, w1f, b1f, w2f,
        b2f, hidden, log1p, threshold, avgf, featsf, outf, dec, cycles, averaging);
  }
  return static_cast<int>(cudaGetLastError());
}

// The retune trace over `cycles` decisions: launches one block on `stream`
// and returns the first CUDA error (0 on success).  tx0_ptr (a float32 on the
// card) is read there when it is not null, else tx0 is the start.
extern "C" int crn_sense_trace(const void* decision, long long cycles, const void* tx0_ptr,
                               float tx0, float ch_a, float ch_b, void* trace, void* stream) {
  if (cycles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  sense_trace_kernel<<<1, kTraceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(decision), cycles, static_cast<const float*>(tx0_ptr), tx0, ch_a,
      ch_b, static_cast<float*>(trace));
  return static_cast<int>(cudaGetLastError());
}
