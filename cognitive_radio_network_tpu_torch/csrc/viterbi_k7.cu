// Hard-decision Viterbi decoder of the K=7, rate-1/2 convolutional code
// (polynomials 0171 and 0133, liquid-dsp's LIQUID_FEC_CONV_V27) for NVIDIA
// Hopper (sm_90a): a batch of frames, one warp per frame, the forward
// add-compare-select (ACS) recursion and the traceback in one launch.
//
// It replaces no pallas_call: the JAX package decodes v27 with the lax.scan
// of cognitive_radio_network_tpu/phy/fec.py::viterbi_decode_jnp.  In PyTorch
// that scan is a host loop (ops/viterbi.py::viterbi_decode_plain) of about
// five launches per ACS step and four per traceback step: 12,536 host steps
// and some 56,000 launches for one 256-byte v27+v27 packet.
//
// What bounds it: nothing on the card's scale.  A frame of T steps reads 2T
// bytes and writes T - 6; the work is 64 states x two adds and a compare a
// step.  Its time is the latency of T dependent ACS steps, then of T dependent
// traceback steps.  The design keeps both chains short:
//   - ACS in registers.  Lane l keeps the metrics of two states and computes
//     the new states l and l + 32, whose predecessors are both 2l and 2l + 1.
//     Even lanes keep (state l, state l + 32), odd lanes the swapped pair, so
//     that two __shfl_sync bring every lane both predecessors: a step's chain
//     is shuffle, add, min, with no shared memory and no barrier.  The new
//     metric is the smaller candidate whatever the tie rule, so the selector
//     (a tie keeps the first predecessor, as the plain version's
//     `cand1 < cand0`) stays off the chain.
//   - Selectors.  Two __ballot_sync and two bitwise selects pack a step's 64
//     into two words in state order; lane t % 32 keeps step t's pair, and
//     every 32 steps the warp stores 256 contiguous bytes into a global
//     scratch the wrapper allocates (8 B a step: 33.5 KB for the 4,182-step
//     inner code of a 256-byte packet, and any length a 16-bit payload
//     length allows).  The stores are off the chain; a packet's selectors
//     are still in the 50 MB L2 when the traceback reads them.
//   - Coded bits are staged into shared memory a chunk at a time with 16-byte
//     loads; a step reads its two bits there, off the chain.
//   - Traceback (lane 0) from state 0, where the tail flush leaves every
//     frame.  The warp stages the selectors back into shared memory a chunk
//     at a time; the address of a step's selector words does not depend on
//     the state, so their loads run ahead of the chain, which is a select, a
//     shift and an add a step.
//   - Frames run in parallel, one block of one warp each, over the 132 SMs.
// Integers only, with the plain version's int32 metrics (0 for state 0,
// 1 << 20 for the others, no renormalisation) and branch metrics: the output
// is bit-equal to the plain version's on every input.
//
// Contract (the wrapper in ops/viterbi.py checks it):
//   coded    uint8, frames rows row_stride bytes apart; a row's first
//            2 * (n_bits + 6) bytes are the coded bits, two a step
//   out      (frames, n_bits) uint8: the decoded bits
//   scratch  (frames, round32(n_bits + 6)) uint2: the selectors

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPoly0 = 0171, kPoly1 = 0133;  // phy/fec.py's _CONV_POLYS, first poly the high bit
constexpr int kTail = 6;                      // K - 1 flush steps
constexpr int kInitMetric = 1 << 20;          // every state but 0 at the start
constexpr int kChunk = 2048;                  // steps staged per trip, a multiple of 32
constexpr int kStageBytes = 2 * kChunk + 16;  // a chunk's coded bits, from a 16-byte block start
constexpr int kStageLoads = (kStageBytes / 16 + 31) / 32;  // 16-byte loads a lane makes per chunk
constexpr int kMaxBits = 1 << 30;
constexpr unsigned kAll = 0xffffffffu;

constexpr int kSmem = kStageBytes + 8 * kChunk;  // staging and a chunk of selectors: 20 KB,
                                                 // inside the default 48 KB: no opt-in
__device__ __forceinline__ int round32(int x) { return (x + 31) / 32 * 32; }

__device__ __forceinline__ int conv_out(int state, int bit) {
  const int reg = (bit << 6) | state;  // the newest bit in the high place of the 7-bit window
  return ((__popc(reg & kPoly0) & 1) << 1) | (__popc(reg & kPoly1) & 1);
}

// The plain version's branch metric: the Hamming distance of two 2-bit
// symbols, and the same formula on whatever bytes the input holds.
__device__ __forceinline__ int branch_metric(int sym, int expected) {
  const int d = sym ^ expected;
  return (d & 1) + (d >> 1);
}

// Copies the `valid` bytes at `src` into `stage` with 16-byte loads of the
// aligned blocks that hold them and zeroes the bytes after them up to `total`;
// returns where src's first byte lies in `stage` (its offset in its block).
// A 16-byte block that holds a byte of the row lies inside the tensor's
// allocation (allocations are aligned to far more than 16 bytes), so reading
// its other bytes is safe; they are not used.
__device__ int stage_coded(const uint8_t* src, int valid, int total, uint8_t* stage, int lane) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const uint4* blocks = reinterpret_cast<const uint4*>(src - mis);
  const int nblocks = (mis + valid + 15) >> 4;
  uint4 v[kStageLoads];
#pragma unroll
  for (int k = 0; k < kStageLoads; ++k) {
    const int b = lane + 32 * k;
    if (b < nblocks) v[k] = __ldg(blocks + b);
  }
#pragma unroll
  for (int k = 0; k < kStageLoads; ++k) {
    const int b = lane + 32 * k;
    if (b < nblocks) reinterpret_cast<uint4*>(stage)[b] = v[k];
  }
  __syncwarp();
  for (int i = mis + valid + lane; i < mis + total; i += 32) stage[i] = 0;
  __syncwarp();
  return mis;
}

__global__ void __launch_bounds__(32)
viterbi_k7_kernel(const uint8_t* __restrict__ coded, long long row_stride, int n_bits,
                  uint8_t* __restrict__ out, uint2* __restrict__ scratch) {
  extern __shared__ uint4 smem[];
  uint8_t* stage = reinterpret_cast<uint8_t*>(smem);                // coded bits, then decoded bits
  uint2* sel_smem = reinterpret_cast<uint2*>(stage + kStageBytes);  // a chunk of selectors
  const int lane = threadIdx.x;
  const long long frame = blockIdx.x;
  const int steps = n_bits + kTail, padded = round32(steps);
  const uint8_t* row = coded + frame * row_stride;
  uint2* sel_row = scratch + frame * padded;

  // The states whose metrics this lane keeps in x and y, and the expected
  // outputs of their two predecessors 2 * lane and 2 * lane + 1.  Shuffle 1
  // brings the first predecessor's metric to lanes 0-15 and the second's to
  // lanes 16-31, shuffle 2 the other way round.
  const bool low_half = lane < 16;
  const int sx = (lane & 1) ? lane + 32 : lane, sy = sx ^ 32;
  const int src1 = (2 * lane + (lane >> 4)) & 31, src2 = (2 * lane + 1 - (lane >> 4)) & 31;
  const int ex_first = conv_out(2 * lane, sx >> 5), ex_second = conv_out(2 * lane + 1, sx >> 5);
  const int ey_first = conv_out(2 * lane, sy >> 5), ey_second = conv_out(2 * lane + 1, sy >> 5);
  const int e1x = low_half ? ex_first : ex_second, e2x = low_half ? ex_second : ex_first;
  const int e1y = low_half ? ey_first : ey_second, e2y = low_half ? ey_second : ey_first;
  int x = sx == 0 ? 0 : kInitMetric, y = kInitMetric;
  unsigned keep0 = 0, keep1 = 0;  // step (lane mod 32)'s selector words

  // Forward over `padded` steps: the ones past the frame read zeroed bits and
  // are never traced back.
  for (int c0 = 0; c0 < padded; c0 += kChunk) {
    const int n = min(kChunk, padded - c0), valid = min(n, steps - c0);
    const uint8_t* bits = stage + stage_coded(row + 2LL * c0, 2 * valid, 2 * n, stage, lane);
    for (int i = 0; i < n; i += 32) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int sym = (static_cast<int>(bits[2 * (i + j)]) << 1) | bits[2 * (i + j) + 1];
        const int r1 = __shfl_sync(kAll, x, src1), r2 = __shfl_sync(kAll, y, src2);
        const int c1x = r1 + branch_metric(sym, e1x), c2x = r2 + branch_metric(sym, e2x);
        const int c1y = r1 + branch_metric(sym, e1y), c2y = r2 + branch_metric(sym, e2y);
        x = min(c1x, c2x);
        y = min(c1y, c2y);
        // the second predecessor only when strictly better: a tie keeps the first
        const bool sel_x = low_half ? c2x < c1x : c1x < c2x;
        const bool sel_y = low_half ? c2y < c1y : c1y < c2y;
        // bit l of wx: state sx of lane l, which is l for an even lane and
        // l + 32 for an odd one; the natural words take even bits from one
        // ballot and odd bits from the other
        const unsigned wx = __ballot_sync(kAll, sel_x), wy = __ballot_sync(kAll, sel_y);
        const unsigned w0 = (wx & 0x55555555u) | (wy & 0xaaaaaaaau);  // states 0-31
        const unsigned w1 = (wy & 0x55555555u) | (wx & 0xaaaaaaaau);  // states 32-63
        if (lane == j) {
          keep0 = w0;
          keep1 = w1;
        }
      }
      sel_row[c0 + i + lane] = make_uint2(keep0, keep1);
    }
    __syncwarp();  // the chunk's bits are read before the next chunk is staged
  }
  __syncwarp();  // the selectors are stored before they are read back

  // Traceback from state 0, a chunk at a time from the end.  The state
  // entered at step t holds that step's input bit in its high place.
  int state = 0;
  uint8_t* out_row = out + frame * n_bits;
  for (int c0 = (steps - 1) / kChunk * kChunk; c0 >= 0; c0 -= kChunk) {
    const int n = min(kChunk, steps - c0);
#pragma unroll 8
    for (int i = lane; i < n; i += 32) sel_smem[i] = sel_row[c0 + i];
    __syncwarp();
    if (lane == 0) {
#pragma unroll 8
      for (int t = n - 1; t >= 0; --t) {
        const uint2 w = sel_smem[t];
        const unsigned word = (state & 32) ? w.y : w.x;
        stage[t] = static_cast<uint8_t>(state >> 5);
        state = ((state & 31) << 1) | ((word >> (state & 31)) & 1);
      }
    }
    __syncwarp();
    const int m = min(n, n_bits - c0);  // the tail's steps carry no data bits
    for (int i = lane; i < m; i += 32) out_row[c0 + i] = stage[i];
    __syncwarp();  // written out before the next chunk overwrites it
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller checks type, strides and length, and allocates out and scratch.
extern "C" int crn_viterbi_k7(const void* coded, long long row_stride, int n_bits, int frames,
                              void* out, void* scratch, void* stream) {
  if (n_bits < 0 || n_bits > kMaxBits || frames <= 0 || row_stride < 0 || !scratch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  viterbi_k7_kernel<<<frames, 32, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(coded), row_stride, n_bits, static_cast<uint8_t*>(out),
      static_cast<uint2*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
