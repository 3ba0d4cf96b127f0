// Fused 64-channel wideband energy detector for NVIDIA Hopper (sm_90a):
// planar wide stream -> 8-tap polyphase FIR per channel -> 64-point DFT over
// the channel axis -> |y|^2 -> mean over the block_len times of a sense cycle.
//
// Replaces the Pallas TPU kernel cognitive_radio_network_tpu/ops/fused_wideband.py
// (function _kernel).  That kernel is shaped by the TPU: pair rows (T/2, 128)
// to fill 128 lanes, a lane roll for the odd delays, a 16-row coefficient
// table, an 8-row halo block and a (256, 256) DFT block matrix that is half
// zeros, for the matrix unit.  This kernel keeps what that one computes, not
// how.  Here the stream is a (T, 64) row-major array per plane:
//
//   v[t, c]   = sum_{d=0..7} taps[d, c] * x[t - d, c]       (per plane)
//   y[t, k]   = sum_c v[t, c] * exp(-2 pi i c k / 64)
//   out[n, k] = mean over the block_len rows t of cycle n of |y[t, k]|^2
//
// with x[t] for t < 0 taken from the 8 phase rows before the stream (`hist`,
// the last 7 used) or zero when there are none.
//
// Contract (the wrapper in ops/fused_wideband.py checks it):
//   xr, xi  (T * 64,) float32, contiguous, 16-byte aligned; T = cycles * block_len
//   taps    (8, 64)   float32
//   tw      (2, 32)   float32: cos and sin of -2*pi*k/64, built in float64
//   hist_r, hist_i  (8, 64) float32 phase rows before the stream, or null
//   out     (cycles, 64) float32, natural channel order
//
// The DFT is a radix-2 FFT, not the dense matrix product of the TPU kernel.
// A dense complex 64-point DFT costs 8 * 64 * 64 flops per row, 17.2 GFLOP
// for 524,288 rows, at least 0.26 ms on the FP32 pipes; the input, 268 MB,
// passes in 0.08 ms at 3.35 TB/s.  The FFT with the FIR costs about
// 2 GFLOP, so the kernel can be bound by device-memory bandwidth, and the
// design is about reading each sample once.  Every stage runs in float32 at
// every `precision` of the wrapper, which meets the bounds of all three
// rungs of the reference's ladder.
//
// Layout: one thread block per sense cycle, 256 threads; warp w takes rows
// w * R .. w * R + R - 1 of the cycle, R = block_len / 8 (a tail of
// block_len % 8 rows goes to the last warp), one row at a time.  Lane l
// holds channels l and l + 32 of both planes, so a row is two coalesced
// 128-byte reads per plane.  The FIR slides over time in registers: a lane
// keeps the last 7 rows of its channels and reads 8 new rows at once, so
// their latency overlaps.  Each warp re-reads the 7 rows before its first
// one (from L1/L2: a neighbouring warp or block reads them too).
//
// The FFT is decimation in frequency.  Stage 1 pairs channel n with n + 32,
// both in one lane, and leaves two 32-point transforms (even and odd output
// bins) with one point each per lane.  Their five stages exchange values
// between lanes l and l ^ h (h = 16 .. 1) by shuffle.  Outputs come out in
// bit-reversed lane order: lane l holds bins 2 * brev5(l) and
// 2 * brev5(l) + 1, the same two for every row, so it sums their power in
// registers and the order only matters at the final store.  The eight
// warps' sums are added through shared memory in warp order: no atomics, so
// the result is the same from run to run, and a stream cut in two with the
// first part's last rows as the second part's history gives the same bits as
// the whole stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 64;        // channels
constexpr int kP = 8;         // taps per channel
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 8;     // rows read at once by a warp

__device__ __forceinline__ void cmul(float& re, float& im, float wr, float wi) {
  const float r = re * wr - im * wi;
  im = re * wi + im * wr;
  re = r;
}

// Row `row` of the stream (row < 0: the history, or zero), channels l and l + 32.
__device__ __forceinline__ void load_row(const float* __restrict__ x,
                                         const float* __restrict__ hist, long long row, int lane,
                                         float& lo, float& hi) {
  if (row >= 0) {
    const float* p = x + row * kM + lane;
    lo = p[0];
    hi = p[32];
  } else if (hist != nullptr) {
    const float* p = hist + (kP + row) * kM + lane;  // row -1 is the history's last row
    lo = p[0];
    hi = p[32];
  } else {
    lo = 0.f;
    hi = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_wideband_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                      const float* __restrict__ taps, const float* __restrict__ tw,
                      const float* __restrict__ hist_r, const float* __restrict__ hist_i,
                      float* __restrict__ out, int block_len) {
  __shared__ float s_pow[kWarps][kM];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long cycle = blockIdx.x;

  // this lane's taps: h[d][0] for channel l, h[d][1] for channel l + 32
  float h[kP][2];
#pragma unroll
  for (int d = 0; d < kP; ++d) {
    h[d][0] = taps[d * kM + lane];
    h[d][1] = taps[d * kM + lane + 32];
  }
  // stage-1 twiddle W_64^l, then per 32-point stage the factor of this lane:
  // W_{2h}^{l mod h} = W_64^{(l mod h) * 32 / h} where bit h of l is set, else 1
  const float w1r = tw[lane], w1i = tw[32 + lane];
  float wsr[5], wsi[5];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int half = 16 >> s;
    const int k = (lane & (half - 1)) * (32 / half);
    const bool odd = (lane & half) != 0;
    wsr[s] = odd ? tw[k] : 1.f;
    wsi[s] = odd ? tw[32 + k] : 0.f;
  }

  const int rows_per_warp = block_len / kWarps;
  const int first = warp * rows_per_warp;
  const int count = (warp == kWarps - 1) ? block_len - first : rows_per_warp;
  const long long row0 = cycle * block_len + first;  // first row of this warp

  // ext[j]: rows g - 7 + j of the current group starting at g; [.][0..1] the
  // two channels of the real plane, [.][2..3] of the imaginary plane
  float ext[kP - 1 + kGroup][4];
#pragma unroll
  for (int j = 0; j < kP - 1; ++j) {
    load_row(xr, hist_r, row0 - (kP - 1) + j, lane, ext[j][0], ext[j][1]);
    load_row(xi, hist_i, row0 - (kP - 1) + j, lane, ext[j][2], ext[j][3]);
  }

  float pow_even = 0.f, pow_odd = 0.f;  // bins 2 * brev5(lane) and 2 * brev5(lane) + 1
  for (int g = 0; g < count; g += kGroup) {
    const int n = min(kGroup, count - g);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < n) {  // rows of this warp are in the stream: row0 + g + j >= 0
        const long long off = (row0 + g + j) * kM + lane;
        ext[kP - 1 + j][0] = xr[off];
        ext[kP - 1 + j][1] = xr[off + 32];
        ext[kP - 1 + j][2] = xi[off];
        ext[kP - 1 + j][3] = xi[off + 32];
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < n) {  // uniform over the warp, so every lane reaches the shuffles
        // FIR, from the oldest delay to the newest: v = sum_d h[d] * x[t - d]
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = h[kP - 1][q & 1] * ext[j][q];
#pragma unroll
        for (int d = kP - 2; d >= 0; --d) {
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = fmaf(h[d][q & 1], ext[j + kP - 1 - d][q], v[q]);
        }
        // stage 1: a = v[n] + v[n + 32] (even bins), b = (v[n] - v[n + 32]) W_64^n (odd bins)
        float ar = v[0] + v[1], ai = v[2] + v[3];
        float br = v[0] - v[1], bi = v[2] - v[3];
        cmul(br, bi, w1r, w1i);
        // five stages of the two 32-point transforms, one point of each per lane
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          const int half = 16 >> s;
          const bool odd = (lane & half) != 0;
          const float oar = __shfl_xor_sync(0xffffffffu, ar, half);
          const float oai = __shfl_xor_sync(0xffffffffu, ai, half);
          const float obr = __shfl_xor_sync(0xffffffffu, br, half);
          const float obi = __shfl_xor_sync(0xffffffffu, bi, half);
          ar = odd ? oar - ar : ar + oar;
          ai = odd ? oai - ai : ai + oai;
          br = odd ? obr - br : br + obr;
          bi = odd ? obi - bi : bi + obi;
          if (half > 1) {  // the last stage's factor is 1
            cmul(ar, ai, wsr[s], wsi[s]);
            cmul(br, bi, wsr[s], wsi[s]);
          }
        }
        pow_even += ar * ar + ai * ai;
        pow_odd += br * br + bi * bi;
      }
    }
    // slide: the group's last 7 rows become the history of the next group
#pragma unroll
    for (int j = 0; j < kP - 1; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) ext[j][q] = ext[j + kGroup][q];
    }
  }

  const int k32 = static_cast<int>(__brev(static_cast<unsigned>(lane)) >> 27);  // brev5(lane)
  s_pow[warp][2 * k32] = pow_even;
  s_pow[warp][2 * k32 + 1] = pow_odd;
  __syncthreads();
  if (threadIdx.x < kM) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_pow[w][threadIdx.x];
    out[cycle * kM + threadIdx.x] = sum / static_cast<float>(block_len);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks shapes, types, contiguity and alignment; it allocates out.
extern "C" int crn_fused_wideband(const void* xr, const void* xi, const void* taps, const void* tw,
                                  const void* hist_r, const void* hist_i, void* out,
                                  long long cycles, int block_len, void* stream) {
  if (cycles <= 0 || cycles > 2147483647LL || block_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(cycles)), block(kThreads);
  fused_wideband_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(taps), static_cast<const float*>(tw),
      static_cast<const float*>(hist_r), static_cast<const float*>(hist_i),
      static_cast<float*>(out), block_len);
  return static_cast<int>(cudaGetLastError());
}
