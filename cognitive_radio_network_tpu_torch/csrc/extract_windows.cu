// Window extraction for NVIDIA Hopper (sm_90a): up to four sets of K windows
// of two float32 planes at ONE offset vector, in one launch,
// out_s[k, j] = plane[clip_s(o_k) + j].
//
// Replaces the Pallas TPU kernel cognitive_radio_network_tpu/ops/extract.py
// (function _extract_kernel), which DMAs a 1024-aligned slab per window and
// realigns it in VMEM with lane rolls, because Mosaic slices device memory
// only at tile boundaries.  The counterpart here: each warp loads the
// 16-byte aligned vectors that cover its run of a window and realigns them
// in registers, taking the vector it lacks from the next lane by a shuffle.
//
// Contract (see ops/extract.py for the wrapper that checks it):
//   rr, ri      (n,)          float32, contiguous, any 4-byte aligned base
//   offsets     (k,)          int32 or int64, as the caller holds them
//   per set s:  out_r/i (k, wlen_s) float32, row-major; o_k is clipped to
//               [0, max(n - wlen_s, 0)] for that set alone (near the end of
//               the planes a prefix of a long window is not the short
//               window); samples past n are 0, as the reference pads
//
// What bounds it: device memory alone, no arithmetic.  The OFDM stream step
// asks for its header windows and each speculated configuration's frame
// windows at the same offsets: one launch reads those samples once from
// device memory (the sets' later reads of them hit L2) and pays one launch.
// The design keeps the memory system busy:
//   - a warp copies a run of kRun = 256 samples of one window of one set,
//     both planes, and a block of 4 warps takes 4 such runs, so windows of
//     160 or 688 samples are packed several to a block;
//   - each lane loads its 16-byte vectors of both planes before it stores
//     any (6 vectors, 96 bytes in flight per thread), by absolute address,
//     so the loads are aligned whatever the plane's base and the offset;
//   - the realignment by (address / 4) mod 4 takes one shuffle from the
//     next lane per component; lane 31 takes lane 0's vector of the next
//     round, and lane 0 loads one vector past the run for the last round;
//   - rows whose start is 16-byte aligned (the output's base is, and
//     wlen_s % 4 == 0: 4864, 2080, 688 and 160 all are) take 16-byte
//     stores; other rows store sample by sample;
//   - stores stream past L2 (st.global.cs, evict first): a window is written
//     once and read once, by the demodulator, while the planes it comes from
//     are read again by the other sets and by overlapping windows, so they
//     are what L2 should keep.  On an H100 this took the stream step's
//     three sets from 1.2x to about 1.0x their bound (PERF.md).
// A vector is loaded only when it holds a sample of the plane, so no load
// leaves the plane's 16-byte granules.
//
// Grid: one warp per (set, window, run), the sets' tasks one after another;
// ceil(tasks / 4) blocks of 128 threads.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxSets = 4;
constexpr int kWarps = 4;                  // warps (runs) per block
constexpr int kRounds = 2;                 // 16-byte vectors per lane per plane in a run
constexpr int kRun = 32 * 4 * kRounds;     // samples per run
constexpr unsigned kFull = 0xffffffffu;

struct Sets {
  float* out_r[kMaxSets];
  float* out_i[kMaxSets];
  long long end[kMaxSets];  // runs of sets 0..s together (a prefix sum of k * runs)
  int wlen[kMaxSets];
  int runs[kMaxSets];       // ceil(wlen / kRun)
  int vec_store[kMaxSets];  // every row starts 16-byte aligned
  int count;
};

// One plane's run: the aligned vectors that cover plane[src, src + len).
struct Run {
  const float4* base;  // the aligned vector holding plane[src]
  long long first;     // plane index of base's first sample (src - shift, may be < 0)
  int shift;           // (address of plane[src] / 4) mod 4
};

__device__ __forceinline__ Run run_of(const float* plane, long long src) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(plane) + 4 * static_cast<uintptr_t>(src);
  Run r;
  r.shift = static_cast<int>((addr >> 2) & 3);
  r.base = reinterpret_cast<const float4*>(addr - 4 * static_cast<uintptr_t>(r.shift));
  r.first = src - r.shift;
  return r;
}

// Vector v of the run, or zeros when it holds no sample of the plane (its
// first sample lies at or past n; it cannot end before plane[0], as first >= -3).
__device__ __forceinline__ float4 load(const Run& r, int v, int nvec, long long n) {
  const long long at = r.first + 4LL * v;
  if (v < nvec && n > 0 && at < n) return __ldg(r.base + v);
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// Lane l's four samples of a round from its vector and the next lane's
// (lane 31: lane 0's vector of the next round, passed as `ahead`).
__device__ __forceinline__ float4 realign(float4 cur, float4 ahead, int shift, int lane) {
  if (shift == 0) return cur;  // warp-uniform
  const float4 w = lane == 0 ? ahead : cur;
  const int from = (lane + 1) & 31;
  float4 nx;
  nx.x = __shfl_sync(kFull, w.x, from);
  nx.y = __shfl_sync(kFull, w.y, from);
  nx.z = __shfl_sync(kFull, w.z, from);
  if (shift == 1) return make_float4(cur.y, cur.z, cur.w, nx.x);
  if (shift == 2) return make_float4(cur.z, cur.w, nx.x, nx.y);
  return make_float4(cur.w, nx.x, nx.y, nx.z);
}

__device__ __forceinline__ void store(float* dst, int j, int len, float4 x, bool vec) {
  if (j >= len) return;
  if (vec) {
    __stcs(reinterpret_cast<float4*>(dst + j), x);
  } else {
    __stcs(dst + j, x.x);
    if (j + 1 < len) __stcs(dst + j + 1, x.y);
    if (j + 2 < len) __stcs(dst + j + 2, x.z);
    if (j + 3 < len) __stcs(dst + j + 3, x.w);
  }
}

// Zero the samples of x (output positions j..j+3 of a run from src) at or past n.
__device__ __forceinline__ float4 past_end(float4 x, long long src, int j, long long n) {
  const long long p = src + j;
  if (p >= n) x.x = 0.f;
  if (p + 1 >= n) x.y = 0.f;
  if (p + 2 >= n) x.z = 0.f;
  if (p + 3 >= n) x.w = 0.f;
  return x;
}

// Offset: int32_t or int64_t, the offsets as the caller holds them.
template <typename Offset>
__global__ void __launch_bounds__(kWarps * 32)
extract_window_sets_kernel(const float* __restrict__ rr, const float* __restrict__ ri,
                           const Offset* __restrict__ offsets, long long n, Sets sets) {
  const int lane = threadIdx.x & 31;
  const long long task = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  int s = 0;
  while (s + 1 < sets.count && task >= sets.end[s]) ++s;
  if (task >= sets.end[s]) return;  // the last block's spare warps
  const long long local = task - (s > 0 ? sets.end[s - 1] : 0);
  const int runs = sets.runs[s];
  const long long w = local / runs;
  const int j0 = static_cast<int>(local - w * runs) * kRun;
  const int wlen = sets.wlen[s];
  const int len = min(kRun, wlen - j0);
  const long long hi = n > wlen ? n - wlen : 0;
  long long o = static_cast<long long>(offsets[w]);
  o = o < 0 ? 0 : (o > hi ? hi : o);
  const long long src = o + j0;

  const Run a = run_of(rr, src), b = run_of(ri, src);
  const int na = (a.shift + len + 3) >> 2, nb = (b.shift + len + 3) >> 2;
  float4 va[kRounds + 1], vb[kRounds + 1];
#pragma unroll
  for (int u = 0; u < kRounds; ++u) {
    va[u] = load(a, 32 * u + lane, na, n);
    vb[u] = load(b, 32 * u + lane, nb, n);
  }
  // the vector past the last round's, which lane 31 needs: lane 0 holds it
  va[kRounds] = load(a, lane == 0 ? 32 * kRounds : na, na, n);
  vb[kRounds] = load(b, lane == 0 ? 32 * kRounds : nb, nb, n);

  float* dr = sets.out_r[s] + w * wlen + j0;
  float* di = sets.out_i[s] + w * wlen + j0;
  const bool vec = sets.vec_store[s] != 0;
  const bool tail = src + len > n;  // only when n < wlen
#pragma unroll
  for (int u = 0; u < kRounds; ++u) {
    if (32 * 4 * u < len) {  // warp-uniform: the shuffles see every lane
      const int j = 32 * 4 * u + 4 * lane;
      float4 xr = realign(va[u], va[u + 1], a.shift, lane);
      float4 xi = realign(vb[u], vb[u + 1], b.shift, lane);
      if (tail) {
        xr = past_end(xr, src, j, n);
        xi = past_end(xi, src, j, n);
      }
      store(dr, j, len, xr, vec);
      store(di, j, len, xi, vec);
    }
  }
}

template <typename Offset>
void launch(const void* rr, const void* ri, const void* offsets, long long n, const Sets& sets,
            unsigned blocks, cudaStream_t stream) {
  extract_window_sets_kernel<Offset><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(rr), static_cast<const float*>(ri),
      static_cast<const Offset*>(offsets), n, sets);
}

}  // namespace

// Gathers `count` (1..4) window sets at one offset vector in one launch on
// `stream` and returns cudaGetLastError() (0 on success; cudaErrorInvalidValue
// for a count or a length it does not take).  Set s writes k rows of wlen_s
// samples to out_r_s and out_i_s.  `offsets_i32` says which integer the
// offsets are.  Launches nothing when there is no sample to write.
extern "C" int crn_extract_window_sets(const void* rr, const void* ri, const void* offsets,
                                       int offsets_i32, long long n, int k, int count,
                                       void* out_r0, void* out_i0, int wlen0,
                                       void* out_r1, void* out_i1, int wlen1,
                                       void* out_r2, void* out_i2, int wlen2,
                                       void* out_r3, void* out_i3, int wlen3, void* stream) {
  if (count < 1 || count > kMaxSets || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  void* const out_r[kMaxSets] = {out_r0, out_r1, out_r2, out_r3};
  void* const out_i[kMaxSets] = {out_i0, out_i1, out_i2, out_i3};
  const int wlen[kMaxSets] = {wlen0, wlen1, wlen2, wlen3};
  Sets sets{};
  sets.count = count;
  long long tasks = 0;
  for (int s = 0; s < count; ++s) {
    if (wlen[s] < 0) return static_cast<int>(cudaErrorInvalidValue);
    sets.out_r[s] = static_cast<float*>(out_r[s]);
    sets.out_i[s] = static_cast<float*>(out_i[s]);
    sets.wlen[s] = wlen[s];
    sets.runs[s] = (wlen[s] + kRun - 1) / kRun;
    sets.vec_store[s] = wlen[s] % 4 == 0 && reinterpret_cast<uintptr_t>(out_r[s]) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(out_i[s]) % 16 == 0;
    tasks += static_cast<long long>(k) * sets.runs[s];
    sets.end[s] = tasks;
  }
  const long long blocks = (tasks + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (offsets_i32) {
    launch<int32_t>(rr, ri, offsets, n, sets, static_cast<unsigned>(blocks), st);
  } else {
    launch<int64_t>(rr, ri, offsets, n, sets, static_cast<unsigned>(blocks), st);
  }
  return static_cast<int>(cudaGetLastError());
}
