// Greedy resolution of frame candidates for NVIDIA Hopper (sm_90a): the
// adaptive stream step's walk over its K candidates in offset order, which
// accepts a candidate when it clears the threshold, starts at or after the end
// of the last accepted frame, has a valid header and fits the buffer, and
// stops at the first candidate whose header region or frame overruns the
// buffer (its tail is still to arrive).
//
// No TPU kernel stands behind it: the JAX package runs this walk as a
// lax.scan with a scalar carry inside its stream-step graph
// (cognitive_radio_network_tpu/phy/framesync.py, _stream_step_graph).  In
// PyTorch the same walk as tensor operations is some 15 launches per candidate,
// and on the host it is a device-to-host round trip per block, which would
// make every stream step wait for the one before.  One small kernel keeps the
// step's state on the card.
//
// Contract (the wrapper in ops/resolve.py checks it); candidates sorted by offset:
//   offs    (K,) int64    frame start in the buffer
//   peaks   (K,) float32  detection metric at the start
//   ok      (K,) uint8    header CRC passed and the PHY header parses (0 or 1)
//   flen    (K,) int64    frame length from the candidate's own PHY header
//   keep0   (1,) int64    where the residual starts when nothing is incomplete
//   accept  (K,) uint8    out: 1 where the candidate is a frame to decode
//   meta    (3,) int64    out: end of the last accepted frame, the residual's
//                         keep point, and 1 when the walk stopped at an
//                         incomplete frame
//
// What bounds it: nothing on the card's scale.  It reads 21 bytes per
// candidate; the walk is a chain of K dependent steps through the end of the
// last accepted frame, so its time is that chain's latency in one thread plus
// a launch.  One warp: all lanes stage a chunk of candidates in shared memory
// with coalesced loads and settle, in parallel, everything that does not
// depend on the chain (threshold, header, the two overrun tests) into one flag
// word per candidate; lane 0 walks the chunk with predicated selects and no
// branch, so the compiler can batch the next candidates' loads under the
// chain; all lanes write the chunk's flags back.  Integer arithmetic and one
// float compare: the result is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;  // candidates staged per trip
// what a candidate's flag word says, all of it known before the walk
constexpr int kStrong = 1;      // the peak clears the threshold
constexpr int kPrefixOver = 2;  // its header region overruns the buffer
constexpr int kHeaderOk = 4;    // header CRC passed and the PHY header parses
constexpr int kFrameOver = 8;   // its frame overruns the buffer

__global__ void __launch_bounds__(32)
resolve_candidates_kernel(const int64_t* __restrict__ offs, const float* __restrict__ peaks,
                          const uint8_t* __restrict__ ok, const int64_t* __restrict__ flen,
                          const int64_t* __restrict__ keep0, uint8_t* __restrict__ accept,
                          int64_t* __restrict__ meta, int k, float thr, int64_t n,
                          int64_t prefix) {
  __shared__ int64_t s_off[kChunk];
  __shared__ int64_t s_end[kChunk];
  __shared__ int s_flags[kChunk];
  __shared__ uint8_t s_accept[kChunk];

  const int lane = threadIdx.x;
  // the walk's carry, live in lane 0 only
  int64_t consumed = 0, keep_from = keep0[0];
  bool stopped = false;

  for (int base = 0; base < k; base += kChunk) {
    const int count = min(kChunk, k - base);
    for (int i = lane; i < count; i += 32) {
      const int64_t off = offs[base + i], end = off + flen[base + i];
      s_off[i] = off;
      s_end[i] = end;
      s_flags[i] = (peaks[base + i] >= thr ? kStrong : 0) | (off + prefix > n ? kPrefixOver : 0) |
                   (ok[base + i] ? kHeaderOk : 0) | (end > n ? kFrameOver : 0);
    }
    __syncwarp();
    if (lane == 0) {
#pragma unroll 8
      for (int i = 0; i < count; ++i) {
        const int64_t off = s_off[i], end = s_end[i];
        const int f = s_flags[i];
        const bool considered = !stopped && (f & kStrong) && off >= consumed;
        const bool prefix_over = considered && (f & kPrefixOver);
        const bool after_header = considered && !prefix_over && (f & kHeaderOk);
        const bool frame_over = after_header && (f & kFrameOver);
        const bool take = after_header && !frame_over;
        const bool stop_now = prefix_over || frame_over;
        consumed = take ? end : consumed;
        keep_from = stop_now && off < keep_from ? off : keep_from;
        stopped = stopped || stop_now;
        s_accept[i] = take ? 1 : 0;
      }
    }
    __syncwarp();
    for (int i = lane; i < count; i += 32) accept[base + i] = s_accept[i];
    __syncwarp();  // the chunk's flags are read before the next chunk's are written
  }
  if (lane == 0) {
    meta[0] = consumed;
    meta[1] = keep_from;
    meta[2] = stopped ? 1 : 0;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  With
// k = 0 the kernel writes meta alone.
extern "C" int crn_resolve_candidates(const void* offs, const void* peaks, const void* ok,
                                      const void* flen, const void* keep0, void* accept,
                                      void* meta, int k, float thr, long long n, long long prefix,
                                      void* stream) {
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  resolve_candidates_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(offs), static_cast<const float*>(peaks),
      static_cast<const uint8_t*>(ok), static_cast<const int64_t*>(flen),
      static_cast<const int64_t*>(keep0), static_cast<uint8_t*>(accept),
      static_cast<int64_t*>(meta), k, thr, static_cast<int64_t>(n),
      static_cast<int64_t>(prefix));
  return static_cast<int>(cudaGetLastError());
}
