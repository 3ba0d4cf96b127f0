// Fused 64-channel wideband energy detector for NVIDIA Hopper (sm_90a):
// wide streams -> 8-tap polyphase FIR per channel -> 64-point DFT over the
// channel axis -> |y|^2 -> mean over the block_len times of a sense cycle
// (and, when asked, the cycle's noise floor and the energy detector's
// decisions, and each stream's last 8 rows for the next call's history),
// for a batch of streams in one launch.
//
// Replaces the Pallas TPU kernel cognitive_radio_network_tpu/ops/fused_wideband.py
// (function _kernel).  That kernel is shaped by the TPU: pair rows (T/2, 128)
// to fill 128 lanes, a lane roll for the odd delays, a 16-row coefficient
// table, an 8-row halo block and a (256, 256) DFT block matrix that is half
// zeros, for the matrix unit.  This kernel keeps what that one computes, not
// how.  Here a stream is a (T, 64) row-major array per plane:
//
//   v[t, c]   = sum_{d=0..7} taps[d, c] * x[t - d, c]       (per plane)
//   y[t, k]   = sum_c v[t, c] * exp(-2 pi i c k / 64)
//   out[n, k] = mean over the block_len rows t of cycle n of |y[t, k]|^2
//
// with x[t] for t < 0 taken from the 8 phase rows before the stream (`hist`,
// the last 7 used) or zero when there are none.
//
// Contract (the wrapper in ops/fused_wideband.py checks it):
//   B streams, each T * 64 samples, T = cycles * block_len, block_len even:
//   planar       xr, xi: stream b at xr + b * stride_r, xi + b * stride_i
//                (floats; whole rows of 64), each (T * 64,) float32;
//   interleaved  xr: stream b at xr + b * stride_r, (T * 64, 2) float32
//                [re, im] pairs (a complex64 tensor's layout); xi unused;
//   bases and strides 16-byte aligned (the bulk copies need it);
//   taps    (8, 64)   float32
//   tw      (2, 32)   float32: cos and sin of -2*pi*k/64, built in float64
//   hist_r, hist_i  per stream (8, 64) float32 phase rows before the stream,
//           at hist + b * hstride, or null
//   out     (B, cycles, 64) float32, natural channel order
//   noise, occ  optional (B, cycles) float32 and (B, cycles, 64) bytes, both
//           or neither: per cycle the noise floor 0.5 (min + min(mean, 2 min))
//           of its 64 energies and the decisions out > ratio * noise (0 or 1)
//   tail_r, tail_i  optional per stream (8, 64) float32 at tail + b * tstride:
//           the stream's last 8 rows (with those of `hist` before a stream
//           shorter than that), the history form, so the next call over the
//           stream's continuation takes them as its `hist`; not `hist` itself
//
// What bounds it: device memory, 512 bytes a row, once the issue slots
// keep up.  The FIR is 1024 multiply-adds a row and the FFT about 1,100
// float32 operations (the dense DFT of the TPU kernel would need more time
// than the bytes).  On an H100 the first design (one block a cycle, loads
// from device memory, a shuffle FFT) stood at 1.7-2.0x the bytes' time
// with its loads in the way; with the loads in flight it was bound by its
// instructions (about 120 a row a warp, 20 of them shuffles).  This design
// (PERF.md has the measurements):
//
// - One launch for the batch.  The grid is one wave on the card (two
//   blocks per SM), or whole waves where a batch's streams do not divide
//   one: each block a contiguous run of whole sense cycles of one stream
//   (runs of a stream differ by at most one cycle).  The 7-row FIR halo
//   before a run is read once a run, from device memory or the history.
// - A ring of kRingRows rows in dynamic shared memory, kStages stages of
//   kTileRows rows, filled by 1-D bulk copies (cp.async.bulk, the Tensor
//   Memory Accelerator) that thread 0 issues, each stage's completion
//   reported on its own mbarrier.  A stage is one copy of kTileRows * 512
//   bytes (interleaved) or two of kTileRows * 256 (planar: a run's rows are
//   contiguous in each plane), so an interleaved stream is read in place,
//   with no de-interleaving copy before the kernel.  After each step thread 0
//   refills the stages the block has passed, so the rows not in use (about
//   57) are in flight while the warps compute.
// - Each of the 8 warps takes a group of kGroup rows a step (groups are cut
//   from each cycle's first row).  For the FIR lane l holds channels 2l and
//   2l + 1 of both planes (one 16-byte or two 8-byte shared loads a row),
//   reads the group's rows and the 7 before them from the ring and writes
//   the FIR output rows to the warp's own rows of shared memory.
// - The FFT is 8 x 8 in registers, no shuffles: channel c = 8 c1 + c2,
//   bin k = k1 + 8 k2.  Eight lanes take a row; lane q does the 8-point DFT
//   over c1 of channels q + 8 c1 and the twiddles W_64^(q k1), writes the
//   8 x 8 block's row q into the row it read (only its 8 lanes use that row),
//   reads column q back and does the 8-point DFT over c2: bins q + 8 k2.  So
//   a lane keeps the power of the same 8 bins for every row it takes.
//
// The order of every sum depends on the cycle's rows alone: a group's power
// is summed over its rows (rows j and j + 4 in a lane, then the four lanes
// that share a bin as (0 + 1) + (2 + 3)), and a cycle's groups are added in
// order by one warp, which carries the sum from step to step.  No atomics.
// So the result is the same from run to run, whatever the grid; a batch
// equals its streams launched one by one; the interleaved layout equals the
// planar one; and a stream cut at a cycle boundary, with the first part's
// last rows as the second part's history, gives the whole stream's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 64;          // channels
constexpr int kP = 8;           // taps per channel
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 8;       // rows a warp takes in a step
constexpr int kRingRows = 128;  // rows of the ring (a power of two: row r at r & (kRingRows - 1))
constexpr int kTileRows = 16;   // rows of a ring stage: one bulk copy per plane
constexpr int kStages = kRingRows / kTileRows;
constexpr int kRowFloats = 2 * kM;
constexpr int kVStride = 176;   // floats a row of a warp's FIR output: 128 + 48, = 16 mod 32 banks
constexpr int kTStride = 20;    // floats a row of an 8 x 8 transpose block (16-byte rows, no conflicts)
constexpr int kBlocksPerSM = 2;
// dynamic shared memory: the ring, each warp's FIR output rows (which also
// hold its transposes), the groups' partial sums (two steps), one mbarrier a stage
constexpr int kRingFloats = kRingRows * kRowFloats;
constexpr int kVFloats = kWarps * kGroup * kVStride;
constexpr int kSmemBytes = (kRingFloats + kVFloats + 2 * kWarps * kM) * 4 + kStages * 8;

struct Args {
  const float* xr;
  const float* xi;
  long long stride_r, stride_i;  // floats between streams
  const float* hist_r;
  const float* hist_i;
  long long hstride_r, hstride_i;
  const float* taps;
  const float* tw;
  float* out;
  float* noise;        // null: energies only
  unsigned char* occ;
  float ratio;
  float* tail_r;       // null: no tail
  float* tail_i;
  long long tstride_r, tstride_i;
  long long cycles;  // per stream
  int block_len;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from global src to shared dst, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cmul(float& re, float& im, float wr, float wi) {
  const float r = re * wr - im * wi;
  im = re * wi + im * wr;
  re = r;
}

// Ring row `r` (already masked): channels 2l and 2l + 1 of both planes, as
// v[0..1] (real) and v[2..3] (imaginary).  The planar ring holds the real
// rows, then the imaginary rows.
template <bool kInterleaved>
__device__ __forceinline__ void ring_row(const float* ring, int r, int lane, float v[4]) {
  if constexpr (kInterleaved) {
    const float4 x = reinterpret_cast<const float4*>(ring + r * kRowFloats)[lane];
    v[0] = x.x;
    v[1] = x.z;
    v[2] = x.y;
    v[3] = x.w;
  } else {
    const float2 re = reinterpret_cast<const float2*>(ring + r * kM)[lane];
    const float2 im = reinterpret_cast<const float2*>(ring + kRingRows * kM + r * kM)[lane];
    v[0] = re.x;
    v[1] = re.y;
    v[2] = im.x;
    v[3] = im.y;
  }
}

__host__ __device__ constexpr int brev3(int p) { return ((p & 1) << 2) | (p & 2) | ((p & 4) >> 2); }

// 8-point DFT in registers, decimation in frequency: natural order in,
// position p holds X[brev3(p)] out.
__device__ __forceinline__ void dft8(float r[8], float i[8]) {
  constexpr float kS = 0.70710678118654752f;
#pragma unroll
  for (int n = 0; n < 4; ++n) {  // span 4, times W_8^n
    const float ar = r[n] + r[n + 4], ai = i[n] + i[n + 4];
    const float br = r[n] - r[n + 4], bi = i[n] - i[n + 4];
    r[n] = ar;
    i[n] = ai;
    if (n == 0) {
      r[4] = br;
      i[4] = bi;
    } else if (n == 1) {  // (1 - i) / sqrt 2
      r[5] = (br + bi) * kS;
      i[5] = (bi - br) * kS;
    } else if (n == 2) {  // -i
      r[6] = bi;
      i[6] = -br;
    } else {  // (-1 - i) / sqrt 2
      r[7] = (bi - br) * kS;
      i[7] = -(br + bi) * kS;
    }
  }
#pragma unroll
  for (int h = 0; h < 8; h += 4) {  // span 2, times W_4^n
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float ar = r[h + n] + r[h + n + 2], ai = i[h + n] + i[h + n + 2];
      const float br = r[h + n] - r[h + n + 2], bi = i[h + n] - i[h + n + 2];
      r[h + n] = ar;
      i[h + n] = ai;
      r[h + n + 2] = n == 0 ? br : bi;
      i[h + n + 2] = n == 0 ? bi : -br;
    }
  }
#pragma unroll
  for (int h = 0; h < 8; h += 2) {  // span 1
    const float ar = r[h] + r[h + 1], ai = i[h] + i[h + 1];
    const float br = r[h] - r[h + 1], bi = i[h] - i[h + 1];
    r[h] = ar;
    i[h] = ai;
    r[h + 1] = br;
    i[h + 1] = bi;
  }
}

// Row `row` of stream (xr, xi) from device memory, as ring_row lays it
// out; row < 0: the history, or zero.
template <bool kInterleaved>
__device__ __forceinline__ void device_row(const float* xr, const float* xi, const float* hr,
                                           const float* hi, long long row, int lane, float v[4]) {
  if (row >= 0) {
    if constexpr (kInterleaved) {
      const float4 x = reinterpret_cast<const float4*>(xr + row * kRowFloats)[lane];
      v[0] = x.x;
      v[1] = x.z;
      v[2] = x.y;
      v[3] = x.w;
    } else {
      const float2 re = reinterpret_cast<const float2*>(xr + row * kM)[lane];
      const float2 im = reinterpret_cast<const float2*>(xi + row * kM)[lane];
      v[0] = re.x;
      v[1] = re.y;
      v[2] = im.x;
      v[3] = im.y;
    }
  } else if (hr != nullptr) {
    const int r = static_cast<int>(kP + row) * kM;  // row -1 is the history's last row
    const float2 re = reinterpret_cast<const float2*>(hr + r)[lane];
    const float2 im = reinterpret_cast<const float2*>(hi + r)[lane];
    v[0] = re.x;
    v[1] = re.y;
    v[2] = im.x;
    v[3] = im.y;
  } else {
    v[0] = v[1] = v[2] = v[3] = 0.f;
  }
}

// One group: rows g0 .. g0 + n - 1 of the run (all kGroup of them when
// kFull), the 7 before them for the FIR; adds each bin's power over the
// group's rows of this lane's slot to pw.
template <bool kInterleaved, bool kFull>
__device__ __forceinline__ void group_power(const float* ring, const float* xr, const float* xi,
                                            const float* hr, const float* hi, long long row0,
                                            int g0, int n, int lane, const float (&h)[kP][2],
                                            const float (&twr)[8], const float (&twi)[8],
                                            float* vw, float (&pw)[8]) {
  const int slot = lane >> 3, q = lane & 7;
  // ext[j]: rows g0 - 7 + j; [.][0..1] the real plane's two channels, [.][2..3] the imaginary's
  float ext[kP - 1 + kGroup][4];
  const int r0 = g0 - (kP - 1);
  const int base = r0 & (kRingRows - 1);
  if (r0 >= 0 && base <= kRingRows - (kP - 1 + kGroup)) {  // in the ring, not across its end
#pragma unroll
    for (int j = 0; j < kP - 1 + kGroup; ++j) {
      if (kFull || j < kP - 1 + n) ring_row<kInterleaved>(ring, base + j, lane, ext[j]);
    }
  } else if (r0 >= 0) {  // in the ring, across its end
#pragma unroll
    for (int j = 0; j < kP - 1 + kGroup; ++j) {
      if (kFull || j < kP - 1 + n) ring_row<kInterleaved>(ring, (r0 + j) & (kRingRows - 1), lane, ext[j]);
    }
  } else {  // the run's first rows: those before it from device memory or the history
#pragma unroll
    for (int j = 0; j < kP - 1 + kGroup; ++j) {
      if (!kFull && j >= kP - 1 + n) break;
      if (r0 + j >= 0) {
        ring_row<kInterleaved>(ring, (r0 + j) & (kRingRows - 1), lane, ext[j]);
      } else {
        device_row<kInterleaved>(xr, xi, hr, hi, row0 + r0 + j, lane, ext[j]);
      }
    }
  }
  // FIR, from the oldest delay to the newest: v = sum_d h[d] * x[t - d];
  // row j's complex values of channels 2l and 2l + 1 into the warp's rows
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    if (kFull || j < n) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = h[kP - 1][c & 1] * ext[j][c];
#pragma unroll
      for (int d = kP - 2; d >= 0; --d) {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = fmaf(h[d][c & 1], ext[j + kP - 1 - d][c], v[c]);
      }
      // channels 2l and 2l + 1 as (re, im) pairs
      reinterpret_cast<float4*>(vw + j * kVStride)[lane] = make_float4(v[0], v[2], v[1], v[3]);
    }
  }
  __syncwarp();
  // the FFT: slot s takes rows s and s + 4 of the group, one after the other
  const unsigned slot_mask = 0xffu << (8 * slot);
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int j = slot + 4 * it;
    if (kFull || j < n) {
      float* vrow = vw + j * kVStride;
      float re[8], im[8];
#pragma unroll
      for (int c1 = 0; c1 < 8; ++c1) {
        const float2 x = reinterpret_cast<const float2*>(vrow)[q + 8 * c1];
        re[c1] = x.x;
        im[c1] = x.y;
      }
      dft8(re, im);  // position p: A[q][k1 = brev3(p)]
#pragma unroll
      for (int p = 1; p < 8; ++p) cmul(re[p], im[p], twr[brev3(p)], twi[brev3(p)]);
      // transpose through the slot's own row (read by this slot alone): lane q
      // writes A[q][k1] at row q of an 8 x 8 block, then reads column q
      __syncwarp(slot_mask);
#pragma unroll
      for (int k1 = 0; k1 < 8; k1 += 2) {
        *reinterpret_cast<float4*>(vrow + q * kTStride + 2 * k1) =
            make_float4(re[brev3(k1)], im[brev3(k1)], re[brev3(k1 + 1)], im[brev3(k1 + 1)]);
      }
      __syncwarp(slot_mask);
#pragma unroll
      for (int c2 = 0; c2 < 8; ++c2) {
        const float2 y = *reinterpret_cast<const float2*>(vrow + c2 * kTStride + 2 * q);
        re[c2] = y.x;
        im[c2] = y.y;
      }
      dft8(re, im);  // position p: X[q + 8 brev3(p)]
#pragma unroll
      for (int p = 0; p < 8; ++p) pw[p] = fmaf(re[p], re[p], fmaf(im[p], im[p], pw[p]));
    }
  }
}

template <bool kInterleaved>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) fused_wideband_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* vbuf = ring + kRingFloats;  // [kWarps][kGroup][kVStride]
  float* part = vbuf + kVFloats;     // [2][kWarps][kM]
  uint64_t* full = reinterpret_cast<uint64_t*>(part + 2 * kWarps * kM);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int bl = a.block_len;
  // this block's run: cycles [c0, c1) of stream b
  const long long c0 = a.cycles * blockIdx.x / gridDim.x;
  const long long c1 = a.cycles * (blockIdx.x + 1) / gridDim.x;
  if (c0 == c1) return;
  const long long row0 = c0 * bl;
  // rows, tiles and groups of the run fit 32 bits: a run is at most one
  // stream, and a stream of 2**31 rows would be 1 TB
  const int n_rows = static_cast<int>((c1 - c0) * bl);
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int groups_per_cycle = (bl + kGroup - 1) / kGroup;
  const int n_groups = static_cast<int>(c1 - c0) * groups_per_cycle;

  const float* xr = a.xr + b * a.stride_r;
  const float* xi = kInterleaved ? nullptr : a.xi + b * a.stride_i;
  const float* hr = a.hist_r == nullptr ? nullptr : a.hist_r + b * a.hstride_r;
  const float* hi = a.hist_i == nullptr ? nullptr : a.hist_i + b * a.hstride_i;
  float* out = a.out + (static_cast<long long>(b) * a.cycles + c0) * kM;
  float* noise = a.noise == nullptr ? nullptr : a.noise + static_cast<long long>(b) * a.cycles + c0;
  unsigned char* occ = a.occ == nullptr ? nullptr : a.occ + (static_cast<long long>(b) * a.cycles + c0) * kM;

  // tile i of the run (rows i * kTileRows ...) into stage i % kStages
  auto issue = [&](int i) {
    const long long r = row0 + static_cast<long long>(i) * kTileRows;
    const int n = min(kTileRows, n_rows - i * kTileRows);
    const int at = (i % kStages) * kTileRows;  // the stage's first ring row
    uint64_t* bar = full + i % kStages;
    bar_expect(bar, n * kRowFloats * 4);
    if constexpr (kInterleaved) {
      bulk_copy(ring + at * kRowFloats, xr + r * kRowFloats, n * kRowFloats * 4, bar);
    } else {
      bulk_copy(ring + at * kM, xr + r * kM, n * kM * 4, bar);
      bulk_copy(ring + kRingRows * kM + at * kM, xi + r * kM, n * kM * 4, bar);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(full + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(kStages, n_tiles); ++i) issue(i);
  }
  __syncthreads();

  // the FIR: lane l holds channels 2l and 2l + 1 of both planes;
  // h[d][0] the taps of channel 2l, h[d][1] of channel 2l + 1
  float h[kP][2];
#pragma unroll
  for (int d = 0; d < kP; ++d) {
    h[d][0] = a.taps[d * kM + 2 * lane];
    h[d][1] = a.taps[d * kM + 2 * lane + 1];
  }
  // the FFT, 64 = 8 x 8 with channel c = 8 c1 + c2 and bin k = k1 + 8 k2:
  // lane (slot, q) of a row first takes c2 = q (an 8-point DFT over c1, then
  // the twiddles W_64^(q k1)), then k1 = q (an 8-point DFT over c2)
  const int q = lane & 7;
  float twr[8], twi[8];
#pragma unroll
  for (int k1 = 1; k1 < 8; ++k1) {
    const int m = q * k1;  // W_64^m, m < 64: the table holds m < 32, W_64^(m + 32) = -W_64^m
    const float sign = m < 32 ? 1.f : -1.f;
    twr[k1] = sign * a.tw[m & 31];
    twi[k1] = sign * a.tw[32 + (m & 31)];
  }
  float* vw = vbuf + warp * kGroup * kVStride;  // this warp's FIR output rows

  int next_free = 0;                 // thread 0: the first tile not yet released
  float acc_lo = 0.f, acc_hi = 0.f;  // the last warp: the current cycle's sums, bins l and l + 32
  // the step's first group is group j0 of cycle cyc0 (both relative to the run)
  int cyc0 = 0, j0 = 0;

  for (int step = 0; step * kWarps < n_groups; ++step) {
    float pw[8];  // bins q + 8 brev3(p), this lane's rows of the group
#pragma unroll
    for (int p = 0; p < 8; ++p) pw[p] = 0.f;
    if (step * kWarps + warp < n_groups) {
      int cyc = cyc0, j = j0 + warp;  // this warp's group
      while (j >= groups_per_cycle) {
        j -= groups_per_cycle;
        ++cyc;
      }
      const int first = j * kGroup;
      const int n = min(kGroup, bl - first);
      const int g0 = cyc * bl + first;  // the group's first row in the run
      // wait for the tiles that hold rows g0 - 7 .. g0 + n - 1 of the run
      for (int t = max(g0 - (kP - 1), 0) / kTileRows; t <= (g0 + n - 1) / kTileRows; ++t) {
        bar_wait(full + t % kStages, static_cast<uint32_t>((t / kStages) & 1));
      }
      if (n == kGroup) {
        group_power<kInterleaved, true>(ring, xr, xi, hr, hi, row0, g0, n, lane, h, twr, twi, vw, pw);
      } else {
        group_power<kInterleaved, false>(ring, xr, xi, hr, hi, row0, g0, n, lane, h, twr, twi, vw, pw);
      }
    }
    // the group's sum over its rows: slots (0 + 1) + (2 + 3), the same bits in every lane
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      pw[p] += __shfl_xor_sync(0xffffffffu, pw[p], 8);
      pw[p] += __shfl_xor_sync(0xffffffffu, pw[p], 16);
    }
    if (lane < 8) {
      float* pp = part + (step & 1) * kWarps * kM + warp * kM;
#pragma unroll
      for (int p = 0; p < 8; ++p) pp[q + 8 * brev3(p)] = pw[p];
    }
    __syncthreads();
    const int cyc_step = cyc0, j_step = j0;
    j0 += kWarps;  // the next step's first group
    while (j0 >= groups_per_cycle) {
      j0 -= groups_per_cycle;
      ++cyc0;
    }
    if (threadIdx.x == 0) {
      // release the tiles below the next step's first row (its group's
      // first row less the FIR's 7), and refill their stages
      const int need = (step + 1) * kWarps < n_groups ? cyc0 * bl + j0 * kGroup - (kP - 1) : n_rows;
      bool fenced = false;
      while (next_free < n_tiles && (next_free + 1) * kTileRows <= need) {
        if (next_free + kStages < n_tiles) {
          if (!fenced) {  // the warps' reads of the stage before the copy's write
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            fenced = true;
          }
          issue(next_free + kStages);
        }
        ++next_free;
      }
    }
    if (warp == kWarps - 1) {
      // the step's groups, in order, into their cycles' sums
      const float* pq = part + (step & 1) * kWarps * kM;
      int cyc = cyc_step, j = j_step;
      for (int w = 0; w < kWarps && step * kWarps + w < n_groups; ++w) {
        acc_lo += pq[w * kM + lane];
        acc_hi += pq[w * kM + lane + 32];
        if (++j == groups_per_cycle) {  // the cycle's last group
          const float e_lo = acc_lo / static_cast<float>(bl), e_hi = acc_hi / static_cast<float>(bl);
          out[cyc * kM + lane] = e_lo;
          out[cyc * kM + lane + 32] = e_hi;
          if (noise != nullptr) {
            // the cycle's sum and minimum over its 64 channels, the same bits in every lane
            float sum = e_lo + e_hi, least = fminf(e_lo, e_hi);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              sum += __shfl_xor_sync(0xffffffffu, sum, o);
              least = fminf(least, __shfl_xor_sync(0xffffffffu, least, o));
            }
            const float nf = 0.5f * (least + fminf(sum / static_cast<float>(kM), 2.f * least));
            const float thr = a.ratio * nf;
            occ[cyc * kM + lane] = e_lo > thr;
            occ[cyc * kM + lane + 32] = e_hi > thr;
            if (lane == 0) noise[cyc] = nf;
          }
          acc_lo = 0.f;
          acc_hi = 0.f;
          j = 0;
          ++cyc;
        }
      }
    }
  }
  if (a.tail_r != nullptr && blockIdx.x == gridDim.x - 1) {
    // the stream's last 8 rows (the last run's own, read again from L2),
    // the history's before a shorter stream
    float* tr = a.tail_r + b * a.tstride_r;
    float* ti = a.tail_i + b * a.tstride_i;
    for (int k = threadIdx.x; k < kP * kM; k += kThreads) {
      const long long row = a.cycles * bl - kP + k / kM;
      const int c = k % kM;
      float re = 0.f, im = 0.f;
      if (row >= 0) {
        re = kInterleaved ? xr[(row * kM + c) * 2] : xr[row * kM + c];
        im = kInterleaved ? xr[(row * kM + c) * 2 + 1] : xi[row * kM + c];
      } else if (hr != nullptr) {
        re = hr[(kP + row) * kM + c];
        im = hi[(kP + row) * kM + c];
      }
      tr[k] = re;
      ti[k] = im;
    }
  }
}

constexpr int kMaxDevices = 64;

template <bool kInterleaved>
int launch(const Args& a, int batch, cudaStream_t stream) {
  // per device: the shared-memory limit is set once, and the wave (blocks
  // resident on the whole card) is read once
  static int wave[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (wave[dev] == 0) {
    err = cudaFuncSetAttribute(fused_wideband_kernel<kInterleaved>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_wideband_kernel<kInterleaved>,
                                                        kThreads, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    wave[dev] = max(1, sms * per_sm);
  }
  // runs per stream: one wave over the batch, no more runs than cycles, unless
  // another count finishes sooner.  Blocks run wave after wave, so a launch
  // takes (waves) x (cycles of the longest run); a count whose blocks spill
  // a few past a wave (48 streams: 6 runs, 288 blocks on 264 slots) doubles
  // it, and one that fills whole waves (11 runs, 528 blocks) does not.  The
  // fewest runs among the soonest.
  const long long w = wave[dev];
  auto span = [&](long long r) { return (batch * r + w - 1) / w * ((a.cycles + r - 1) / r); };
  long long runs = max(1LL, min(a.cycles, (w + batch - 1LL) / batch));
  long long best = span(runs);
  for (long long r = 1, most = min(a.cycles, (4 * w + batch - 1LL) / batch); r <= most; ++r) {
    if (span(r) < best) {
      best = span(r);
      runs = r;
    }
  }
  const dim3 grid(static_cast<unsigned>(runs), static_cast<unsigned>(batch)), block(kThreads);
  fused_wideband_kernel<kInterleaved><<<grid, block, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks shapes, types, strides and alignment; it allocates out (and
// noise, occ and the tail where it asks for them).
extern "C" int crn_fused_wideband(const void* xr, const void* xi, long long stride_r,
                                  long long stride_i, const void* hist_r, const void* hist_i,
                                  long long hstride_r, long long hstride_i, const void* taps,
                                  const void* tw, void* out, void* noise, void* occ, float ratio,
                                  void* tail_r, void* tail_i, long long tstride_r,
                                  long long tstride_i, int batch, long long cycles,
                                  int block_len, int interleaved, void* stream) {
  if (batch <= 0 || batch > 65535 || cycles <= 0 || block_len <= 0 ||
      (hist_r == nullptr) != (hist_i == nullptr) || (!interleaved && xi == nullptr) ||
      (noise == nullptr) != (occ == nullptr) || (tail_r == nullptr) != (tail_i == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(xr),     static_cast<const float*>(xi),
               stride_r,
               stride_i,
               static_cast<const float*>(hist_r), static_cast<const float*>(hist_i),
               hstride_r,
               hstride_i,
               static_cast<const float*>(taps),   static_cast<const float*>(tw),
               static_cast<float*>(out),
               static_cast<float*>(noise),        static_cast<unsigned char*>(occ),
               ratio,
               static_cast<float*>(tail_r),       static_cast<float*>(tail_i),
               tstride_r,
               tstride_i,
               cycles,
               block_len};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return interleaved ? launch<true>(a, batch, s) : launch<false>(a, batch, s);
}
