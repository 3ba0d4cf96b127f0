// Dense-DFT sense chain for NVIDIA Hopper (sm_90a): planar IQ rows -> dense
// 512-point DFT as a float32 matrix product -> |X| -> mean over the A buffers
// of a cycle -> band amplitude sums, squared.
//
// Replaces the Pallas TPU kernel cognitive_radio_network_tpu/ops/fused_sense.py
// (function _kernel), which computes the DFT as four f32 matmuls against the
// (512, 512) cos and sin matrices on the TPU's matrix unit and keeps the
// spectra out of device memory.  The product is part of that kernel, so it is
// a hand-written tiled product here, on the FP32 pipes, in full float32 (the
// reference's contract is f32-HIGHEST):
//
//   xre = xr * Fre - xi * Fim        xim = xr * Fim + xi * Fre
//
// Contract (the wrapper in ops/fused_sense.py checks it):
//   xr, xi    (C*A, 512) float32, row-major, contiguous, 16-byte aligned
//   fre, fim  (512, 512) float32: cos and sin of -2*pi*j*k/512, built in float64
//   band      (512, 4)   float32 0/1 indicator, natural bin order
//   feats     (C, 4)     float32 out: (sum_k band[k, j] * mean_a |X_a[k]|)^2
//
// What bounds it: 8 * 512 * 512 flops per row (85.9 GFLOP at C = 4096, A = 10)
// against 4 KB read per row: about 512 flops per byte, so operations bound it,
// at the card's 67 TFLOP/s of float32 outside the tensor cores (TF32 would
// miss the contract).  The 2 MB of DFT matrices stay in L2.
//
// Layout: a block of 128 threads takes a tile of whole cycles, so the mean
// over A stays inside the block: min(8, 80 / A) cycles (at least one), whose
// rows it walks in chunks of 80.  For each chunk and each tile of 64 output
// bins it runs the product over k in steps of 16: the x tile (transposed) and
// the F tile pass through shared memory, the next step's tiles are read into
// registers while the current step is multiplied, and each thread keeps a
// 10 x 4 tile of xre and of xim in registers (80 accumulators, 160 FMAs per k
// for 12 shared-memory loads).  80 rows x 512 bins of two accumulators do not
// fit a block's registers at once, hence the loop over bin tiles; the bin
// tile's magnitudes go to shared memory and are added per cycle and bin in
// row order, so the sums are the same from run to run.  With all 512 bin
// sums of its cycles in shared memory the block finishes each cycle with
// sense_epilogue.cuh, the tail it shares with fused_sense_ct.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sense_epilogue.cuh"

namespace {

constexpr int kN = crn::kSenseN;
constexpr int kThreads = crn::kSenseThreads;
constexpr int kBands = crn::kSenseBands;
constexpr int kBM = 80;       // rows per chunk
constexpr int kBN = 64;       // output bins per tile
constexpr int kBK = 16;       // depth per step
constexpr int kTM = 10;       // rows per thread
constexpr int kTN = 4;        // bins per thread
constexpr int kMaxCycles = 8; // cycles per block at most
constexpr int kXStride = kBM + 2;  // row stride of the transposed x tiles: spreads the
                                   // four k-columns a warp stores at once over the banks
constexpr int kXLoads = (kBM * kBK / 4 + kThreads - 1) / kThreads;  // float4 per thread, x tile
constexpr int kFLoads = kBK * kBN / 4 / kThreads;                   // float4 per thread, F tile

static_assert(kBM / kTM * (kBN / kTN) == kThreads, "one register tile per thread");
static_assert(kBK * kBN / 4 % kThreads == 0, "the F tile divides over the threads");
static_assert(kTM % 2 == 0 && kXStride % 2 == 0 && kTN == 4, "rows load as float2, bins as float4");
static_assert(kBK * kXStride % 4 == 0, "the members after the x tiles stay 16-byte aligned");

struct Smem {
  float xr[kBK][kXStride];  // x tiles, transposed: [k][row]
  float xi[kBK][kXStride];
  float fre[kBK][kBN];  // F tiles: [k][bin]
  float fim[kBK][kBN];
  float mag[kBM][kBN];  // |X| of the chunk's rows at the tile's bins
  float sum[kMaxCycles][kN];  // per cycle: sum over its rows of |X| at each bin
  float red[kThreads / 32][kBands];
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads)
fused_sense_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   const float* __restrict__ fre, const float* __restrict__ fim,
                   const float* __restrict__ band, float* __restrict__ feats, long long cycles,
                   int averaging, int cycles_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int t = threadIdx.x;
  const int tx = t % (kBN / kTN);  // bin group: bins tx * 4 .. tx * 4 + 3 of the tile
  const int ty = t / (kBN / kTN);  // row group: rows ty * 10 .. ty * 10 + 9 of the chunk
  const long long cycle0 = static_cast<long long>(blockIdx.x) * cycles_per_block;
  const int ncyc = static_cast<int>(min(static_cast<long long>(cycles_per_block), cycles - cycle0));
  const int rows = ncyc * averaging;               // rows of this block
  const float* xr0 = xr + cycle0 * averaging * kN;  // its first row
  const float* xi0 = xi + cycle0 * averaging * kN;

  for (int i = t; i < ncyc * kN; i += kThreads) s.sum[i / kN][i % kN] = 0.f;

  for (int chunk = 0; chunk < rows; chunk += kBM) {
    const int chunk_rows = min(kBM, rows - chunk);
    for (int n0 = 0; n0 < kN; n0 += kBN) {
      float are[kTM][kTN], aim[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) are[i][j] = aim[i][j] = 0.f;
      }

      // registers for the next step's tiles
      float4 pxr[kXLoads], pxi[kXLoads], pfr[kFLoads], pfi[kFLoads];
      auto fetch = [&](int k0) {
#pragma unroll
        for (int u = 0; u < kXLoads; ++u) {
          const int idx = t + u * kThreads;  // float4 index in the (kBM, kBK / 4) tile
          const int r = idx / (kBK / 4), c4 = idx % (kBK / 4);
          if (idx < kBM * kBK / 4 && r < chunk_rows) {
            const long long off = static_cast<long long>(chunk + r) * kN + k0 + 4 * c4;
            pxr[u] = ldg4(xr0 + off);
            pxi[u] = ldg4(xi0 + off);
          } else {  // past the block's rows: zeros
            pxr[u] = pxi[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < kFLoads; ++u) {
          const int idx = t + u * kThreads;  // float4 index in the (kBK, kBN / 4) tile
          const int k = idx / (kBN / 4), c4 = idx % (kBN / 4);
          const int off = (k0 + k) * kN + n0 + 4 * c4;
          pfr[u] = ldg4(fre + off);
          pfi[u] = ldg4(fim + off);
        }
      };
      auto stash = [&]() {
#pragma unroll
        for (int u = 0; u < kXLoads; ++u) {
          const int idx = t + u * kThreads;
          const int r = idx / (kBK / 4), c4 = idx % (kBK / 4);
          if (idx < kBM * kBK / 4) {
            s.xr[4 * c4 + 0][r] = pxr[u].x;
            s.xr[4 * c4 + 1][r] = pxr[u].y;
            s.xr[4 * c4 + 2][r] = pxr[u].z;
            s.xr[4 * c4 + 3][r] = pxr[u].w;
            s.xi[4 * c4 + 0][r] = pxi[u].x;
            s.xi[4 * c4 + 1][r] = pxi[u].y;
            s.xi[4 * c4 + 2][r] = pxi[u].z;
            s.xi[4 * c4 + 3][r] = pxi[u].w;
          }
        }
#pragma unroll
        for (int u = 0; u < kFLoads; ++u) {
          const int idx = t + u * kThreads;
          const int k = idx / (kBN / 4), c4 = idx % (kBN / 4);
          *reinterpret_cast<float4*>(&s.fre[k][4 * c4]) = pfr[u];
          *reinterpret_cast<float4*>(&s.fim[k][4 * c4]) = pfi[u];
        }
      };

      fetch(0);
      for (int k0 = 0; k0 < kN; k0 += kBK) {
        __syncthreads();  // the previous step's tiles (and the last mag sums) are read
        stash();
        __syncthreads();
        if (k0 + kBK < kN) fetch(k0 + kBK);
#pragma unroll
        for (int k = 0; k < kBK; ++k) {
          float ar[kTM], ai[kTM];
#pragma unroll
          for (int i = 0; i < kTM; i += 2) {
            const float2 vr = *reinterpret_cast<const float2*>(&s.xr[k][ty * kTM + i]);
            const float2 vi = *reinterpret_cast<const float2*>(&s.xi[k][ty * kTM + i]);
            ar[i] = vr.x;
            ar[i + 1] = vr.y;
            ai[i] = vi.x;
            ai[i + 1] = vi.y;
          }
          const float4 f4r = *reinterpret_cast<const float4*>(&s.fre[k][tx * kTN]);
          const float4 f4i = *reinterpret_cast<const float4*>(&s.fim[k][tx * kTN]);
          const float br[kTN] = {f4r.x, f4r.y, f4r.z, f4r.w};
          const float bi[kTN] = {f4i.x, f4i.y, f4i.z, f4i.w};
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
#pragma unroll
            for (int j = 0; j < kTN; ++j) {
              are[i][j] = fmaf(ar[i], br[j], are[i][j]);
              are[i][j] = fmaf(-ai[i], bi[j], are[i][j]);
              aim[i][j] = fmaf(ar[i], bi[j], aim[i][j]);
              aim[i][j] = fmaf(ai[i], br[j], aim[i][j]);
            }
          }
        }
      }

      // |X| of the tile, then per cycle and bin the sum over the cycle's rows
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        float4 m;
        m.x = crn::magnitude(are[i][0], aim[i][0]);
        m.y = crn::magnitude(are[i][1], aim[i][1]);
        m.z = crn::magnitude(are[i][2], aim[i][2]);
        m.w = crn::magnitude(are[i][3], aim[i][3]);
        *reinterpret_cast<float4*>(&s.mag[ty * kTM + i][tx * kTN]) = m;
      }
      __syncthreads();
      for (int idx = t; idx < ncyc * kBN; idx += kThreads) {
        const int cyc = idx / kBN, col = idx % kBN;
        // rows of this cycle inside the chunk, in the block's row numbering
        const int lo = max(cyc * averaging, chunk);
        const int hi = min((cyc + 1) * averaging, chunk + chunk_rows);
        float acc = s.sum[cyc][n0 + col];
        for (int r = lo; r < hi; ++r) acc += s.mag[r - chunk][col];
        s.sum[cyc][n0 + col] = acc;
      }
      // the next tile's first __syncthreads() orders these reads before its stores
    }
  }
  __syncthreads();

  for (int cyc = 0; cyc < ncyc; ++cyc) {
    float acc[crn::kSenseBins];
#pragma unroll
    for (int j = 0; j < crn::kSenseBins; ++j) acc[j] = s.sum[cyc][t + j * kThreads];
    crn::sense_epilogue(acc, averaging, band, nullptr, feats + (cycle0 + cyc) * kBands, s.red);
    __syncthreads();  // s.red is free again
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or the
// error of raising the kernel's shared-memory limit.  The caller checks
// shapes, types, contiguity and alignment; it allocates feats.
extern "C" int crn_fused_sense(const void* xr, const void* xi, const void* fre, const void* fim,
                               const void* band, void* feats, long long cycles, int averaging,
                               void* stream) {
  if (cycles <= 0 || averaging <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int per_block = kBM / averaging;
  per_block = per_block < 1 ? 1 : (per_block > kMaxCycles ? kMaxCycles : per_block);
  const long long blocks = (cycles + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      fused_sense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(blocks)), block(kThreads);
  fused_sense_kernel<<<grid, block, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(fre), static_cast<const float*>(fim),
      static_cast<const float*>(band), static_cast<float*>(feats), cycles, averaging, per_block);
  return static_cast<int>(cudaGetLastError());
}
