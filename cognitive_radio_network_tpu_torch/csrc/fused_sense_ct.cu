// Fused sense chain for NVIDIA Hopper (sm_90a): planar IQ rows -> 512-point
// FFT -> |X| -> mean over the A buffers of a cycle -> band amplitude sums,
// squared.
//
// Replaces the Pallas TPU kernel cognitive_radio_network_tpu/ops/fused_sense_ct.py
// (function _kernel), which factors the DFT as 4 x 128 so the 128-point
// stage lands on the TPU's matrix unit.  This kernel keeps what that one
// computes, not how: the same outputs, in natural bin order, from a radix-2
// FFT in shared memory.
//
// Contract (see ops/fused_sense_ct.py for the wrapper that checks it):
//   xr, xi  (C*A, 512) float32 or bfloat16, row-major, contiguous, 16-byte aligned
//   tw      (2, 256)   float32: cos and sin of -2*pi*k/512, built in float64
//   band    (512, 4)   float32 0/1 indicator, natural bin order
//   avg     (C, 512)   float32 out: sum_a |X_a[k]| / A
//   feats   (C, 4)     float32 out: (sum_k band[k, j] * avg[k])^2
//
// Precision: every stage runs in float32 at every `precision` of the
// wrapper; bf16 input is upcast right after the load, as the TPU kernel does.
// An f32 FFT meets the bounds of all three rungs of the reference's ladder.
//
// What bounds it: per sample the kernel reads 8 bytes (f32) or 4 bytes
// (bf16) from device memory and does about 45 flops (9 radix-2 stages of
// 5 flops per sample, then the magnitude), about 6 flops per byte, far
// below the card's compute-to-bandwidth ratio.  It is bound by device-memory
// bandwidth.  The design therefore reads each sample once with 16-byte
// vector loads, keeps the FFT, the magnitude, the mean and the band sums in
// shared memory and registers, and writes only avg and feats.  The next
// row's loads are issued before the current row's FFT so their latency
// overlaps the shared-memory work.
//
// Layout: one thread block per cycle, 128 threads.  Thread t loads samples
// 4t..4t+3 of a row (a float4, or 8 bytes of bf16) and stores them at their
// bit-reversed positions; 9 decimation-in-time stages of 256 butterflies
// follow, two per thread; thread t then owns bins t, t+128, t+256, t+384,
// whose |X| it accumulates in registers over the A rows.  The grid has
// exactly C blocks, so no cycle is padded and no block is partial.  The
// magnitude, the mean and the band sums are those of sense_epilogue.cuh,
// shared with the dense-DFT kernel (fused_sense.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sense_epilogue.cuh"

namespace {

constexpr int kN = crn::kSenseN;
constexpr int kLog2N = 9;
constexpr int kThreads = crn::kSenseThreads;
constexpr int kBins = crn::kSenseBins;        // bins (and samples) per thread
constexpr int kButterflies = kN / 2 / kThreads;  // butterflies per thread per stage
constexpr int kBands = crn::kSenseBands;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four bf16 values (8 bytes) -> float4.  A bf16 is the high half of an f32,
// so the upcast is exact: shift the bits into place.
__device__ __forceinline__ float4 load4(const uint16_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ int bitrev(int n) {
  return static_cast<int>(__brev(static_cast<unsigned>(n)) >> (32 - kLog2N));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_sense_ct_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                      const float* __restrict__ tw, const float* __restrict__ band,
                      float* __restrict__ avg, float* __restrict__ feats, int averaging) {
  __shared__ float s_re[kN];
  __shared__ float s_im[kN];
  __shared__ float s_twr[kN / 2];
  __shared__ float s_twi[kN / 2];
  __shared__ float s_red[kThreads / 32][kBands];

  const int t = threadIdx.x;
  const size_t cycle = blockIdx.x;
  for (int k = t; k < kN / 2; k += kThreads) {
    s_twr[k] = tw[k];
    s_twi[k] = tw[kN / 2 + k];
  }

  const T* row_r = xr + cycle * averaging * kN + 4 * t;
  const T* row_i = xi + cycle * averaging * kN + 4 * t;
  float4 next_r = load4(row_r);
  float4 next_i = load4(row_i);
  float acc[kBins] = {0.f, 0.f, 0.f, 0.f};

  for (int a = 0; a < averaging; ++a) {
    __syncthreads();  // the previous row's |X| reads (and the twiddle stores) are done
    const float vr[4] = {next_r.x, next_r.y, next_r.z, next_r.w};
    const float vi[4] = {next_i.x, next_i.y, next_i.z, next_i.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = bitrev(4 * t + j);
      s_re[r] = vr[j];
      s_im[r] = vi[j];
    }
    if (a + 1 < averaging) {  // prefetch the next row during this row's FFT
      row_r += kN;
      row_i += kN;
      next_r = load4(row_r);
      next_i = load4(row_i);
    }
#pragma unroll
    for (int s = 0; s < kLog2N; ++s) {
      __syncthreads();
      const int half = 1 << s;
#pragma unroll
      for (int j = 0; j < kButterflies; ++j) {
        const int b = t + j * kThreads;            // butterfly 0..255
        const int pos = b & (half - 1);
        const int i0 = ((b >> s) << (s + 1)) + pos;
        const int i1 = i0 + half;
        const int k = pos << (kLog2N - 1 - s);     // W_{2 half}^pos = W_512^k
        const float wr = s_twr[k], wi = s_twi[k];
        const float ur = s_re[i1], ui = s_im[i1];
        const float pr = ur * wr - ui * wi;
        const float pi = ur * wi + ui * wr;
        const float qr = s_re[i0], qi = s_im[i0];
        s_re[i0] = qr + pr;
        s_im[i0] = qi + pi;
        s_re[i1] = qr - pr;
        s_im[i1] = qi - pi;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      const int k = t + j * kThreads;
      acc[j] += crn::magnitude(s_re[k], s_im[k]);
    }
  }

  crn::sense_epilogue(acc, averaging, band, avg + cycle * kN, feats + cycle * kBands, s_red);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks shapes, types, contiguity and alignment; it allocates avg
// and feats.
extern "C" int crn_fused_sense_ct(const void* xr, const void* xi, int is_bf16, const void* tw,
                                  const void* band, void* avg, void* feats, int cycles,
                                  int averaging, void* stream) {
  if (cycles <= 0 || averaging <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cycles), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* twf = static_cast<const float*>(tw);
  const float* bandf = static_cast<const float*>(band);
  float* avgf = static_cast<float*>(avg);
  float* featsf = static_cast<float*>(feats);
  if (is_bf16) {
    fused_sense_ct_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(xr), static_cast<const uint16_t*>(xi), twf, bandf, avgf,
        featsf, averaging);
  } else {
    fused_sense_ct_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(xr), static_cast<const float*>(xi), twf, bandf, avgf, featsf,
        averaging);
  }
  return static_cast<int>(cudaGetLastError());
}
