// The 512-point FFT a warp runs on one row in its registers, and a block's
// walk over sense cycles built on it.  Shared by the two sense kernels:
// fused_sense_ct.cu (averaged spectrum and features) and fused_sense.cu
// (features only).
//
// The FFT: 512 = 16 x 32, and a warp owns a row.
//   pass 1  lane n2 holds x[32 n1 + n2], n1 = 0..15 (16 coalesced loads per
//           plane), and runs a 16-point FFT over n1 in its registers;
//   twiddle z[k1][n2] = y[k1][n2] * W_512^(n2 k1), the lane's 15 factors held
//           in registers for the kernel's lifetime;
//   exchange the one trip through shared memory: lane n2 stores z[k1][n2] at
//           row k1 of a (16, 33) float2 tile (pitch 33: stores and loads are
//           conflict-free), and lane L = k1 + 16 p reads row k1 back;
//   pass 2  the 32-point DFT over n2 as 2 x 16, decimated in frequency: lane
//           (k1, p) forms v[b] = z[k1][b] + (-1)^p z[k1][b + 16], turns the
//           odd half by W_32^b, and runs a 16-point FFT over b; its output
//           k2' is bin k1 + 16 (2 k2' + p) = L + 32 k2'.
// So lane L ends with bins L, L + 32, ..., L + 480 of every row, in natural
// order, and adds their magnitudes over its rows in registers.
//
// The walk: a block of 128 threads (4 warps) finishes one cycle at a time and
// walks over cycles blockIdx.x, blockIdx.x + gridDim.x, ...  Within a cycle
// the rows a = r, r + 4, r + 8, ... form class r; a warp takes one class and
// the classes rotate over the warps from cycle to cycle, so that at A = 10
// (classes of 3, 3, 2, 2 rows) every scheduler carries the same load.  A
// warp needs only __syncwarp() around its exchange.  The block meets twice
// per cycle: the four class sums go through shared memory and are added in
// class order (so a cycle's bits do not depend on where it ran), then 128
// threads finish the cycle in sense_epilogue.cuh: thread t owns bins t,
// t + 128, t + 256, t + 384.  No atomics: results are the same from run to
// run.  The next row's loads are in flight while the current row computes.
//
// A tail (sense_classify.cuh: the MLP and decision) finishes each
// cycle after its features on one warp, the one that owns the last row class
// in the next cycle.  That class is the shortest when A is not a multiple of 4
// (at A = 10 classes of 3, 3, 2, 2 rows), so the tail runs in the slack that
// warp has before the next cycle's block meeting, off the longest warp's path.
// The tail reads the band partial sums before that meeting, which is the
// first point at which they are written again.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sense_epilogue.cuh"

namespace crn {

constexpr int kFftWarps = kSenseThreads / 32;  // also the number of row classes
constexpr int kFftR = 16;      // points per lane: the radix of both passes
constexpr int kFftPitch = 33;  // float2 per row of the exchange tile
// Resident blocks per SM the register budget is held to.  Measured on an
// H100 80GB HBM3 at 700 W, C = 4096 f32, spectrum written: 3 blocks (167
// registers, no spills) are the fastest; 2 take 1.3 times as long, and 4 (128
// registers, 164 bytes spilled) 1.4 times.
constexpr int kFftBlocksPerSm = 3;

// cos and sin of -2*pi*e/32, e = 0..31: W_32^e, and W_16^e = W_32^(2e)
static __constant__ float kW32[32][2] = {
    {1.0f, 0.0f},  // 0
    {0.980785251f, -0.195090324f},  // 1
    {0.923879504f, -0.382683426f},  // 2
    {0.831469595f, -0.555570245f},  // 3
    {0.707106769f, -0.707106769f},  // 4
    {0.555570245f, -0.831469595f},  // 5
    {0.382683426f, -0.923879504f},  // 6
    {0.195090324f, -0.980785251f},  // 7
    {0.0f, -1.0f},  // 8
    {-0.195090324f, -0.980785251f},  // 9
    {-0.382683426f, -0.923879504f},  // 10
    {-0.555570245f, -0.831469595f},  // 11
    {-0.707106769f, -0.707106769f},  // 12
    {-0.831469595f, -0.555570245f},  // 13
    {-0.923879504f, -0.382683426f},  // 14
    {-0.980785251f, -0.195090324f},  // 15
    {-1.0f, 0.0f},  // 16
    {-0.980785251f, 0.195090324f},  // 17
    {-0.923879504f, 0.382683426f},  // 18
    {-0.831469595f, 0.555570245f},  // 19
    {-0.707106769f, 0.707106769f},  // 20
    {-0.555570245f, 0.831469595f},  // 21
    {-0.382683426f, 0.923879504f},  // 22
    {-0.195090324f, 0.980785251f},  // 23
    {0.0f, 1.0f},  // 24
    {0.195090324f, 0.980785251f},  // 25
    {0.382683426f, 0.923879504f},  // 26
    {0.555570245f, 0.831469595f},  // 27
    {0.707106769f, 0.707106769f},  // 28
    {0.831469595f, 0.555570245f},  // 29
    {0.923879504f, 0.382683426f},  // 30
    {0.980785251f, 0.195090324f},  // 31
};

__device__ __forceinline__ float load1(const float* p) { return *p; }

// A bf16 is the high half of an f32, so the upcast is exact: shift the bits
// into place.
__device__ __forceinline__ float load1(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(*p) << 16);
}

// (r + i j) *= (c + s j)
__device__ __forceinline__ void cmul(float& r, float& i, float c, float s) {
  const float t = r * c - i * s;
  i = r * s + i * c;
  r = t;
}

// Forward 4-point DFT in place, outputs in natural order (W_4 = -j).
__device__ __forceinline__ void dft4(float& r0, float& i0, float& r1, float& i1, float& r2,
                                     float& i2, float& r3, float& i3) {
  const float s0r = r0 + r2, s0i = i0 + i2;
  const float s1r = r0 - r2, s1i = i0 - i2;
  const float s2r = r1 + r3, s2i = i1 + i3;
  const float s3r = r1 - r3, s3i = i1 - i3;
  r0 = s0r + s2r;
  i0 = s0i + s2i;
  r2 = s0r - s2r;
  i2 = s0i - s2i;
  r1 = s1r + s3i;  // s1 - j s3
  i1 = s1i - s3r;
  r3 = s1r - s3i;  // s1 + j s3
  i3 = s1i + s3r;
}

// Forward 16-point FFT in registers, in and out in natural order, as 4 x 4:
// n = 4 n1 + n2, k = k1 + 4 k2.  Every index is a compile-time constant once
// the loops unroll, so the arrays stay in registers.
__device__ __forceinline__ void fft16(float (&re)[kFftR], float (&im)[kFftR]) {
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) {  // over n1: element n2 + 4 k1 <- t[n2][k1]
    dft4(re[n2], im[n2], re[n2 + 4], im[n2 + 4], re[n2 + 8], im[n2 + 8], re[n2 + 12],
         im[n2 + 12]);
  }
#pragma unroll
  for (int n2 = 1; n2 < 4; ++n2) {
#pragma unroll
    for (int k1 = 1; k1 < 4; ++k1) {  // W_16^(n2 k1)
      cmul(re[n2 + 4 * k1], im[n2 + 4 * k1], kW32[2 * n2 * k1][0], kW32[2 * n2 * k1][1]);
    }
  }
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {  // over n2: element 4 k1 + k2 <- X[k1 + 4 k2]
    dft4(re[4 * k1], im[4 * k1], re[4 * k1 + 1], im[4 * k1 + 1], re[4 * k1 + 2], im[4 * k1 + 2],
         re[4 * k1 + 3], im[4 * k1 + 3]);
  }
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {  // transpose to natural order
#pragma unroll
    for (int k2 = k1 + 1; k2 < 4; ++k2) {
      const float tr = re[4 * k1 + k2], ti = im[4 * k1 + k2];
      re[4 * k1 + k2] = re[4 * k2 + k1];
      im[4 * k1 + k2] = im[4 * k2 + k1];
      re[4 * k2 + k1] = tr;
      im[4 * k2 + k1] = ti;
    }
  }
}

// The walk's default tail: nothing after a cycle's features.  A tail's
// stage() runs once per block, after the first row's loads are issued (a
// tail that copies its tables to shared memory waits for them there, not
// before the loads); operator() once per cycle.
struct NoTail {
  static constexpr bool kActive = false;
  __device__ __forceinline__ void stage() const {}
  __device__ __forceinline__ void operator()(long long, int, const float (*)[kSenseBands]) const {}
};

// A warp's walk over its rows: in cycle number `it` of its block the warp
// owns class (warp + it) mod 4, rows a = class, class + 4, ... of that cycle.
struct RowCursor {
  long long cycle;  // >= cycles: no row left
  int it;
  int a;
};

// Moves `c` from a row of the warp to the warp's next row, past cycles in
// which the warp's class is empty (A < 4).
__device__ __forceinline__ void next_row(RowCursor& c, int warp, int step, int cycles,
                                         int averaging, int stride) {
  c.a += step;
  while (c.a >= averaging) {
    c.cycle += stride;
    ++c.it;
    if (c.cycle >= cycles) return;
    c.a = (warp + c.it) & (kFftWarps - 1);
  }
}

template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ xr, const T* __restrict__ xi,
                                         const RowCursor& c, int averaging, int lane,
                                         float (&re)[kFftR], float (&im)[kFftR]) {
  const size_t at = (static_cast<size_t>(c.cycle) * averaging + c.a) * kSenseN + lane;
#pragma unroll
  for (int n1 = 0; n1 < kFftR; ++n1) {
    re[n1] = load1(xr + at + 32 * n1);
    im[n1] = load1(xi + at + 32 * n1);
  }
}

// The whole of a sense kernel's block: every thread of a block of 128 calls
// it once.  xr, xi (cycles * averaging, 512) rows of T (float or a bf16's
// bits); tw (2, 512) cos and sin of -2*pi*k/512; band (512, 4); feats
// (cycles, 4).  With kWriteAvg the averaged spectrum goes to avg (cycles,
// 512); without it avg is not read and nothing but feats is written.  An
// active Tail is called as tail(cycle, lane, s_red) by every lane of one warp
// once the cycle's features are reduced (see the note at the top), and its
// stage() by every thread once.
template <typename T, bool kWriteAvg, typename Tail = NoTail>
__device__ __forceinline__ void sense_cycles(const T* __restrict__ xr, const T* __restrict__ xi,
                                             const float* __restrict__ tw,
                                             const float* __restrict__ band,
                                             float* __restrict__ avg, float* __restrict__ feats,
                                             int cycles, int averaging,
                                             const Tail& tail = Tail()) {
  __shared__ float2 s_x[kFftWarps][kFftR * kFftPitch];  // one exchange tile per warp
  __shared__ float s_class[kFftWarps][kSenseN];  // a cycle's |X| sums, one row per class
  __shared__ float s_red[kFftWarps][kSenseBands];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int stride = gridDim.x;

  // the lane's pass-1 twiddles W_512^(lane k1), loaded once
  float twr[kFftR], twi[kFftR];
#pragma unroll
  for (int k1 = 1; k1 < kFftR; ++k1) {
    twr[k1] = tw[lane * k1];
    twi[k1] = tw[kSenseN + lane * k1];
  }

  float2* tile = s_x[warp];
  const float2* tile_row = tile + (lane & 15) * kFftPitch;  // pass 2 reads row k1 = lane mod 16
  const bool odd = (lane >> 4) != 0;                        // p: which half of the 32-point DFT
  const float sign = odd ? -1.0f : 1.0f;

  // the row in flight: loaded one row ahead of the row being transformed
  RowCursor ahead{static_cast<long long>(blockIdx.x), 0, warp - kFftWarps};
  next_row(ahead, warp, kFftWarps, cycles, averaging, stride);
  float nr[kFftR], ni[kFftR];
  if (ahead.cycle < cycles) load_row(xr, xi, ahead, averaging, lane, nr, ni);
  tail.stage();  // the first block meeting below falls before the tail's first call

  int it = 0;
  for (long long cycle = blockIdx.x; cycle < cycles; cycle += stride, ++it) {
    const int cls = (warp + it) & (kFftWarps - 1);
    float acc[kFftR];
#pragma unroll
    for (int k = 0; k < kFftR; ++k) acc[k] = 0.0f;

    for (int a = cls; a < averaging; a += kFftWarps) {
      float re[kFftR], im[kFftR];
#pragma unroll
      for (int n1 = 0; n1 < kFftR; ++n1) {
        re[n1] = nr[n1];
        im[n1] = ni[n1];
      }
      next_row(ahead, warp, kFftWarps, cycles, averaging, stride);
      if (ahead.cycle < cycles) load_row(xr, xi, ahead, averaging, lane, nr, ni);

      fft16(re, im);  // pass 1, over n1
#pragma unroll
      for (int k1 = 1; k1 < kFftR; ++k1) cmul(re[k1], im[k1], twr[k1], twi[k1]);
      __syncwarp();  // the previous row's reads of the tile are done
#pragma unroll
      for (int k1 = 0; k1 < kFftR; ++k1) {
        tile[k1 * kFftPitch + lane] = make_float2(re[k1], im[k1]);
      }
      __syncwarp();
#pragma unroll
      for (int b = 0; b < kFftR; ++b) {
        const float2 lo = tile_row[b], hi = tile_row[b + kFftR];
        re[b] = fmaf(sign, hi.x, lo.x);
        im[b] = fmaf(sign, hi.y, lo.y);
      }
      if (odd) {
#pragma unroll
        for (int b = 1; b < kFftR; ++b) cmul(re[b], im[b], kW32[b][0], kW32[b][1]);
      }
      fft16(re, im);  // pass 2, over b: re[k] is bin lane + 32 k
#pragma unroll
      for (int k = 0; k < kFftR; ++k) acc[k] += magnitude(re[k], im[k]);
    }

#pragma unroll
    for (int k = 0; k < kFftR; ++k) s_class[cls][lane + 32 * k] = acc[k];
    __syncthreads();
    float sum[kSenseBins];
#pragma unroll
    for (int j = 0; j < kSenseBins; ++j) {
      const int k = t + j * kSenseThreads;
      sum[j] = ((s_class[0][k] + s_class[1][k]) + s_class[2][k]) + s_class[3][k];
    }
    // its __syncthreads() falls after every read of s_class above, so the
    // next cycle may write s_class again
    sense_epilogue(sum, averaging, band, kWriteAvg ? avg + cycle * kSenseN : nullptr,
                   feats + cycle * kSenseBands, s_red);
    // the warp whose class in the next cycle is the last one: (warp + it + 1)
    // mod 4 == 3
    if (Tail::kActive && warp == ((kFftWarps - 2 - it) & (kFftWarps - 1))) {
      tail(cycle, lane, s_red);
    }
  }
}

// The grid of a sense kernel: one block per cycle up to the blocks the card
// holds at once (kFftBlocksPerSm on each SM of the current device).
inline cudaError_t sense_grid(int cycles, dim3* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int resident = sms * kFftBlocksPerSm;
  *grid = dim3(cycles < resident ? cycles : resident);
  return cudaSuccess;
}

}  // namespace crn
