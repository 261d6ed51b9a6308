// Banded exact Levenshtein distance for Hopper (sm_90a): anti-diagonal
// fronts in a warp's registers for bands up to 1055, and for wider bands a
// ladder of narrow bands in warps, then strips of rows a CTA a pair.
//
// Replaces the TPU kernel svim_tpu/ops/wavefront_kernel.py
// (_wavefront_pallas_kernel, launched by banded_distance_pallas).  For every
// pair it returns what the plain PyTorch version
// (svim_tpu_torch/ops/wavefront_kernel.py::banded_distance_torch) returns,
// entry for entry, also above the band: the distance restricted to the cells
// |i - j| <= W, 1 << 20 when (m, n) itself lies outside the band.
//
// What bounds it on this card: operations, not bytes.  A pair is read once
// (2L bytes; 16 MiB a launch at B, L = 8192, 1024, 5 us of HBM time), while
// its m*n live cells (0.59 M at m = n = 768, 4.8e9 a launch) cost about five
// int32 operations each (one compare, one add, two min, one add-min):
// 2.4e10 operations, 1.4 ms at the card's 1.67e13 int32 op/s.  The DP is a
// chain of dependent steps, so a design keeps each step short, keeps its
// state in registers and runs many pairs or many strips side by side.
//
// The warp layout (min(W, L) + 1 <= 1056 slots):
//
//  * Dead slots.  A front holds only cells of one parity: slot q of front d
//    is diagonal e = 2q - Q + (d & 1), cell i = (d+e)/2, j = (d-e)/2, with
//    Q the even number >= min(w, n).  The band is clipped to the pair,
//    w = min(W, max(m, n)) and e in [-min(w, n), min(w, m)], so a pair needs
//    (min(w, m) + min(w, n))/2 + 2 slots, each warp picks the narrowest
//    strip that holds them, and the loop ends at the pair's own m+n.  Cells
//    outside 0 <= i <= m, 0 <= j <= n are masked to INF, which also makes the
//    boundaries D(0, d) = D(d, 0) = d fall out of the recurrence.
//  * No barrier.  Lane t owns the S consecutive slots [tS, tS+S) and keeps
//    the last even and the last odd front of its strip in registers (the
//    new front overwrites the one two steps back in place).  An even front
//    needs slot tS-1 of the odd front from lane t-1, an odd front slot tS+S
//    of the even front from lane t+1: one warp shuffle a front.  Several
//    warps (pairs) share a CTA and never synchronise with each other.
//  * Characters.  A warp copies its pair's strings into shared memory once
//    (16-byte loads).  Each lane keeps the characters of its cells in
//    registers: along a diagonal a[i-1] advances on odd fronts and b[j-1]
//    on even fronts, a shift by one slot, so a front costs a lane one byte
//    from shared memory.
//  * Loose bands.  Before the pass at the caller's band the warp runs the
//    pair at the rungs 63 (S = 2) and 255 (S = 8) where those are below half
//    the band.  A value <= the band it was computed in is the exact distance
//    (an optimal path with k edits never leaves |i - j| <= k), so it equals
//    what the pass at W would return.  A rung gives up as soon as no cell of
//    its last two fronts is <= its band (every path crosses one of them and
//    values never decrease along a path).
//
// Hopper's DPX instruction __viaddmin_s32 folds the +1 and the last min of a
// cell (CUDA 12 toolkits declare it; older ones get the two-instruction form).
//
// The strip layout (wider bands; two launches a call, no device memory a
// front, no block barrier a front):
//
//  * A ladder.  The warp kernel first tries the rungs 63, 255 and 1023 (S =
//    33: 1056 slots) in one warp a pair, several pairs a CTA, and writes -1
//    for a pair it leaves open.  The strip kernel then tries the rung 4095
//    (where it is below half the band) and the band itself, only on the open
//    pairs.  The work of a resolved pair is bounded by about 4/3 of the
//    cells of the first rung that holds its distance.
//  * Strips of rows.  A rung runs in the (i, j) plane restricted to the band:
//    strip k holds rows kR+1 .. kR+R (R = 32 S, S = 32 rows a lane) and
//    sweeps its columns [max(1, kR+1-w), min(n, kR+R+w)] left to right, lane
//    t one column behind lane t-1.  A lane keeps D(i, j-1) of its S rows and
//    a[i-1] in registers; D(i-1, j) of its first row comes from lane t-1 by
//    one shuffle a column, and b[j-1] from the staged string.  Cells with
//    |i - j| > w are INF; a step whose 32 x S cells all lie inside the band
//    (all of them when W >= L) skips that mask.
//  * Strips in flight.  The CTA's K warps take strips k, k+K, ...  The
//    bottom row of strip k is the top row of strip k+1: between warps it
//    goes through a ring of 256 columns in shared memory, from the last
//    warp back to warp 0 through one row of L+1 ints a CTA in device memory
//    (written and read once a strip, not a front).  Each warp publishes the
//    columns it has written and read every 32 columns, and waits only for
//    its neighbours' counts: no block barrier inside a pass.
//  * Giving up.  Every path crosses each row, so a rung gives up when no
//    cell of a strip's bottom row is <= its band.
//  * Filling the card.  The strip kernel is persistent: as many CTAs as fit
//    take the open pairs from an atomic counter, so a launch whose pairs
//    resolved on the ladder costs a few microseconds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 20;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kLadderRung = 1023;     // the warp ladder's last rung (S = 33)
constexpr int kStripRung = 4095;      // the strip kernel's rung below W
constexpr int kStripRows = 32;        // rows a lane in the strip kernel
constexpr int kStripMaxWarps = 8;
constexpr int kRing = 256;            // columns a ring between two warps
constexpr int kCounterInts = 64;      // scratch ints before the rows
constexpr long long kMaxSpins = 1LL << 24;

__device__ __forceinline__ int add_min(int a, int b, int c) {
#if defined(__CUDACC_VER_MAJOR__) && __CUDACC_VER_MAJOR__ >= 12
  return __viaddmin_s32(a, b, c);  // min(a + b, c)
#else
  return min(a + b, c);
#endif
}

__device__ __forceinline__ int code_at(const uint8_t* text, int index,
                                       int size) {
  return (index >= 0 && index < size) ? text[index] : 0;
}

// Live slots of front d: the cells with 0 <= i <= m, 0 <= j <= n, |e| <= w.
__device__ __forceinline__ void live_slots(int d, int m, int n, int w,
                                           int q_offset, int* q_lo,
                                           int* q_hi) {
  // e >= -min(w, d), e >= d - 2n, e <= min(w, d), e <= 2m - d; slot q of
  // this front is e = 2q - Q + parity
  const int base = q_offset - (d & 1);
  const int reach = min(w, d);
  *q_lo = max((base - reach + 1) >> 1, (base + d - 2 * n + 1) >> 1);
  *q_hi = min((base + reach) >> 1, (base + 2 * m - d) >> 1);
}

// One pass of a warp over one pair at band w, S slots a lane.  Needs
// |m - n| <= w and (min(w, m) + Q)/2 + 1 <= 32 S.  Returns D(m, n) within the
// band, or kInf when `may_stop` and the pass proved the value above w.
template <int S>
__device__ int warp_pass(const uint8_t* a, const uint8_t* b, int m, int n,
                         int w, bool may_stop) {
  const int lane = threadIdx.x & 31;
  const int q_offset = (min(w, n) + 1) & ~1;  // Q, even
  const int half = q_offset >> 1;
  const int q0 = lane * S;
  int even[S], odd[S], ca[S], cb[S];
#pragma unroll
  for (int x = 0; x < S; ++x) {
    const int q = q0 + x;
    even[x] = q == half ? 0 : kInf;  // front 0: D(0, 0)
    odd[x] = kInf;                   // front -1
    ca[x] = code_at(a, q - half - 1, m);
    cb[x] = code_at(b, half - q - 1, n);
  }
  const int last_front = m + n;
  for (int r = 0; 2 * r + 1 <= last_front; ++r) {
    {  // odd front d = 2r+1: i grows by one on every diagonal
      const int d = 2 * r + 1;
#pragma unroll
      for (int x = 0; x + 1 < S; ++x) ca[x] = ca[x + 1];
      ca[S - 1] = code_at(a, r + q0 + S - 1 - half, m);
      int q_lo, q_hi;
      live_slots(d, m, n, w, q_offset, &q_lo, &q_hi);
      const unsigned span = static_cast<unsigned>(max(q_hi - q_lo + 1, 0));
      int beyond = __shfl_down_sync(kFullMask, even[0], 1);
      if (lane == 31) beyond = kInf;
#pragma unroll
      for (int x = 0; x < S; ++x) {
        const int right = x + 1 < S ? even[x + 1] : beyond;
        const int diagonal = odd[x] + (ca[x] != cb[x] ? 1 : 0);
        const int value = add_min(min(even[x], right), 1, diagonal);
        const bool live = static_cast<unsigned>(q0 + x - q_lo) < span;
        odd[x] = live ? value : kInf;
      }
    }
    if (2 * r + 2 <= last_front) {  // even front d = 2r+2: j grows by one
      const int d = 2 * r + 2;
#pragma unroll
      for (int x = S - 1; x > 0; --x) cb[x] = cb[x - 1];
      cb[0] = code_at(b, r - q0 + half, n);
      int q_lo, q_hi;
      live_slots(d, m, n, w, q_offset, &q_lo, &q_hi);
      const unsigned span = static_cast<unsigned>(max(q_hi - q_lo + 1, 0));
      int before = __shfl_up_sync(kFullMask, odd[S - 1], 1);
      if (lane == 0) before = kInf;
#pragma unroll
      for (int x = S - 1; x >= 0; --x) {
        const int left = x > 0 ? odd[x - 1] : before;
        const int diagonal = even[x] + (ca[x] != cb[x] ? 1 : 0);
        const int value = add_min(min(left, odd[x]), 1, diagonal);
        const bool live = static_cast<unsigned>(q0 + x - q_lo) < span;
        even[x] = live ? value : kInf;
      }
    }
    if (may_stop && (r & 15) == 15) {
      int least = kInf;
#pragma unroll
      for (int x = 0; x < S; ++x) least = min(least, min(even[x], odd[x]));
      if (!__any_sync(kFullMask, least <= w)) return kInf;
    }
  }
  const int final_q = (m - n + q_offset - (last_front & 1)) >> 1;
  int mine = kInf;
#pragma unroll
  for (int x = 0; x < S; ++x) {
    if (q0 + x == final_q) mine = (last_front & 1) ? odd[x] : even[x];
  }
  return __shfl_sync(kFullMask, mine, final_q / S);
}

__device__ __forceinline__ int slots_needed(int m, int n, int w) {
  const int q_offset = (min(w, n) + 1) & ~1;
  return ((min(w, m) + q_offset) >> 1) + 1;
}

// The pairs answered without a front: 0 for two empty strings, kInf when
// (m, n) is outside the band, max(m, n) when one string is empty (within
// the band: D(m, 0) = m), 1 for m + n == 1.  Returns -1 otherwise.
__device__ __forceinline__ int trivial_answer(int m, int n, int band) {
  if (m + n == 0) return 0;
  if (abs(m - n) > band) return kInf;
  if (m == 0 || n == 0) return max(m, n);
  return -1;
}

// The rungs of a pair whose band w is more than twice as wide: 63, then 255
// (kMaxS > 8), then 1023 (kLadder).  Returns the exact distance, or -1 when
// open.
template <int kMaxS, bool kLadder>
__device__ int narrow_passes(const uint8_t* a, const uint8_t* b, int m, int n,
                             int w) {
  const int skew = abs(m - n);
  if (2 * 63 < w && skew <= 63) {
    const int value = warp_pass<2>(a, b, m, n, 63, true);
    if (value <= 63) return value;
  }
  if constexpr (kMaxS > 8) {
    if (2 * 255 < w && skew <= 255) {
      const int value = warp_pass<8>(a, b, m, n, 255, true);
      if (value <= 255) return value;
    }
  }
  if constexpr (kLadder) {
    if (2 * kLadderRung < w && skew <= kLadderRung) {
      const int value = warp_pass<33>(a, b, m, n, kLadderRung, true);
      if (value <= kLadderRung) return value;
    }
  }
  return -1;
}

// The warp's answer for one pair; with kLadder, -1 for a pair whose band
// does not fit 32 * kMaxS slots and that no rung resolved.
template <int kMaxS, bool kLadder>
__device__ int solve_in_warp(const uint8_t* a, const uint8_t* b, int m, int n,
                             int band) {
  const int trivial = trivial_answer(m, n, band);
  if (trivial >= 0) return trivial;
  const int w = min(band, max(m, n));  // a wider band holds no more cells
  const int narrow = narrow_passes<kMaxS, kLadder>(a, b, m, n, w);
  if (narrow >= 0) return narrow;
  const int slots = slots_needed(m, n, w);
  if (kLadder && slots > 32 * kMaxS) return -1;
  // otherwise the launch guarantees slots <= 32 * kMaxS
  if (kMaxS <= 3 || slots <= 32 * 3) return warp_pass<3>(a, b, m, n, w, false);
  if constexpr (kMaxS >= 9) {
    if (slots <= 32 * 5) return warp_pass<5>(a, b, m, n, w, false);
    if (kMaxS <= 9 || slots <= 32 * 9) {
      return warp_pass<9>(a, b, m, n, w, false);
    }
  }
  if constexpr (kMaxS >= 33) {
    if (slots <= 32 * 17) return warp_pass<17>(a, b, m, n, w, false);
    return warp_pass<33>(a, b, m, n, w, false);
  }
  return kInf;  // not reached
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copies the first `size` bytes of `row` (rounded up to 16 when `wide`) to
// shared memory with the threads lane, lane + step, ...
__device__ __forceinline__ void stage_text(uint8_t* text, const uint8_t* row,
                                           int size, bool wide, int lane,
                                           int step) {
  if (wide) {
    const uint4* from = reinterpret_cast<const uint4*>(row);
    uint4* to = reinterpret_cast<uint4*>(text);
    for (int k = lane; 16 * k < size; k += step) to[k] = from[k];
  } else {
    for (int k = lane; k < size; k += step) text[k] = row[k];
  }
}

// One warp per pair, blockDim.x / 32 pairs a CTA.  Dynamic shared memory
// holds 2 * length bytes a warp for the staged strings; the ladder (with
// `stage` 0) reads them from global memory instead.  With kLadder (kMaxS =
// 33), the rung 1023 runs too and a pair too wide for the warp is left
// open (-1) for the strip kernel.
template <int kMaxS, bool kLadder>
__global__ void __launch_bounds__(128)
    wavefront_warp_kernel(const uint8_t* __restrict__ a_codes,
                          const int32_t* __restrict__ a_lens,
                          const uint8_t* __restrict__ b_codes,
                          const int32_t* __restrict__ b_lens,
                          int32_t* __restrict__ out, int batch, int length,
                          int band, int stage) {
  extern __shared__ uint4 shared_words[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * (blockDim.x >> 5) + warp;
  if (pair >= batch) return;  // the whole warp leaves; no block barrier below
  const int m = a_lens[pair];
  const int n = b_lens[pair];
  const uint8_t* text_a = a_codes + static_cast<int64_t>(pair) * length;
  const uint8_t* text_b = b_codes + static_cast<int64_t>(pair) * length;
  if (!kLadder || stage) {  // the warp layout always stages
    uint8_t* staged_a = reinterpret_cast<uint8_t*>(shared_words) +
                        static_cast<size_t>(warp) * 2 * length;
    uint8_t* staged_b = staged_a + length;
    const bool wide =
        (length & 15) == 0 && aligned16(a_codes) && aligned16(b_codes);
    stage_text(staged_a, text_a, m, wide, lane, 32);
    stage_text(staged_b, text_b, n, wide, lane, 32);
    __syncwarp();
    text_a = staged_a;
    text_b = staged_b;
  }
  const int answer =
      solve_in_warp<kMaxS, kLadder>(text_a, text_b, m, n, band);
  if (lane == 0) out[pair] = answer;
}

// --- the strip kernel ---------------------------------------------------------

// What the warps of a strip-kernel CTA share: counts encoded as strip *
// stride + column + 1 (monotone as a warp moves on), the rings between
// warp k and warp k+1, and the pass's outcome.
struct StripShared {
  int written[kStripMaxWarps];  // bottom-row columns a warp has stored
  int read[kStripMaxWarps];     // top-row columns a warp has loaded
  int ring[kStripMaxWarps - 1][kRing];
  int gave_up;
  int answer;
  int pair;
};

// Lane 0 spins until *count >= value or the pass gave up, then the warp
// goes on together; traps after ~1 s, so that a fault in the hand-off ends
// the launch with an error, not a hang.
__device__ __forceinline__ void wait_for(const volatile int* count, int value,
                                         const volatile int* gave_up) {
  if ((threadIdx.x & 31) == 0) {
    long long spins = 0;
    while (*count < value && !*gave_up) {
      __nanosleep(64);
      if (++spins > kMaxSpins) __trap();
    }
  }
  __syncwarp();
}

// The pass's give-up flag as lane 0 reads it, the same in every lane.
__device__ __forceinline__ bool gave_up_now(const volatile int* gave_up) {
  return __shfl_sync(kFullMask, *gave_up, 0) != 0;
}

__device__ __forceinline__ int boundary_value(int index, int w) {
  return index <= w ? index : kInf;  // D(i, 0) and D(0, j) inside the band
}

// One pass of the CTA over a pair at band w (|m - n| <= w, m, n >= 1):
// D(m, n) restricted to |i - j| <= w, or kInf when `may_stop` and a strip's
// bottom row proved it above w.  `row`: L + 1 ints of device memory.
template <int S>
__device__ int strip_pass(const uint8_t* a, const uint8_t* b, int m, int n,
                          int w, bool may_stop, int* row, StripShared& sh) {
  constexpr int R = 32 * S;
  volatile StripShared& vs = sh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  __syncthreads();  // every thread has read the last pass's outcome
  for (int j = threadIdx.x; j <= n; j += blockDim.x) {
    row[j] = boundary_value(j, w);  // row 0
  }
  if (threadIdx.x < kStripMaxWarps) {
    sh.written[threadIdx.x] = 0;
    sh.read[threadIdx.x] = 0;
  }
  if (threadIdx.x == 0) {
    sh.gave_up = 0;
    sh.answer = kInf;
  }
  __syncthreads();

  const int strips = (m + R - 1) / R;
  const int stride = n + 64;
  const int m_strip = (m - 1) / R;
  const int m_lane = ((m - 1) % R) / S;
  const int m_x = (m - 1) % S;
  for (int strip = warp; strip < strips; strip += warps) {
    if (gave_up_now(&vs.gave_up)) break;
    const int i_first = strip * R + 1;
    const int i_lane = i_first + lane * S;
    const int j0 = max(1, i_first - w);
    const int j_end = min(n, min(m, i_first + R - 1) + w);
    const int top_end = min(n, i_first - 1 + w);
    const int steps = j_end - j0 + 32;
    // the top row: row 0 or the last warp's strip from `row`, else the ring
    // of warp - 1; the bottom row: the ring of this warp, or `row` from the
    // last warp
    const int* top = warp == 0 ? row : sh.ring[warp - 1];
    const int top_mask = warp == 0 ? -1 : kRing - 1;
    int* sink = warp == warps - 1 ? row : sh.ring[warp];
    const int sink_mask = warp == warps - 1 ? -1 : kRing - 1;
    const int producer = (warp + warps - 1) % warps;
    const bool has_consumer = warp != warps - 1 && strip + 1 < strips;
    const int consumer_j0 = max(1, i_first + R - w);

    int ca[S], left[S];
    const bool before_start = j0 - lane - 1 <= 0;
#pragma unroll
    for (int x = 0; x < S; ++x) {
      const int i = i_lane + x;
      ca[x] = i <= m ? a[i - 1] : 0;
      left[x] = before_start ? boundary_value(i, w) : kInf;
    }
    int bottom = left[S - 1];
    int previous_up = before_start ? boundary_value(i_lane - 1, w) : kInf;
    int least = kInf;
    int top_values = kInf;
    for (int s = 0; s < steps; ++s) {
      if ((s & 31) == 0) {
        if (gave_up_now(&vs.gave_up)) break;
        const int c0 = j0 + s;  // lane 0's columns: c0 .. c0 + 31
        const int need = min(c0 + 31, top_end);
        if (strip > 0 && need >= c0 - 1) {
          wait_for(&vs.written[producer], (strip - 1) * stride + need + 1,
                   &vs.gave_up);
        }
        __threadfence_block();
        if (s == 0 && lane == 0) previous_up = top[(j0 - 1) & top_mask];
        const int column = c0 + lane;
        top_values = column <= top_end ? top[column & top_mask] : kInf;
        __syncwarp();
        if (lane == 0 && warp > 0) {
          __threadfence_block();
          vs.read[warp] = strip * stride + need + 1;
        }
        // this chunk stores bottom-row columns up to c0 into the ring: the
        // consumer of this warp's last strip must have loaded all of it, and
        // the consumer of this one column c0 - kRing, if it needs it
        if (s == 0 && warp != warps - 1 && strip >= warps) {
          const int last = strip - warps + 1;
          wait_for(&vs.read[warp + 1],
                   last * stride + min(n, last * R + w) + 1, &vs.gave_up);
        }
        const int victim = c0 - kRing;
        if (has_consumer && victim >= consumer_j0 - 1) {
          wait_for(&vs.read[warp + 1], (strip + 1) * stride + victim + 1,
                   &vs.gave_up);
        }
      }
      const int j = j0 + s - lane;
      const int cb = b[min(max(j, 1), n) - 1];
      int up = __shfl_up_sync(kFullMask, bottom, 1);
      const int from_top = __shfl_sync(kFullMask, top_values, s & 31);
      if (lane == 0) up = from_top;
      int diagonal = previous_up;
      previous_up = up;
      const int base = i_first - j0 - s;  // least i - j of the warp's cells
      if (base >= -w && base + 32 * S + 30 <= w && j0 + s >= 32) {
#pragma unroll
        for (int x = 0; x < S; ++x) {  // every cell inside the band
          const int old = left[x];
          const int value =
              add_min(min(up, old), 1, diagonal + (ca[x] != cb ? 1 : 0));
          left[x] = value;
          diagonal = old;
          up = value;
        }
      } else if (j <= 0) {
#pragma unroll
        for (int x = 0; x < S; ++x) left[x] = boundary_value(i_lane + x, w);
      } else {
        const int offset = i_lane - j + w;  // i - j + w of row x = 0
#pragma unroll
        for (int x = 0; x < S; ++x) {
          const int old = left[x];
          int value =
              add_min(min(up, old), 1, diagonal + (ca[x] != cb ? 1 : 0));
          if (static_cast<unsigned>(offset + x) > static_cast<unsigned>(2 * w)) {
            value = kInf;
          }
          left[x] = value;
          diagonal = old;
          up = value;
        }
      }
      bottom = left[S - 1];
      if (j == n && strip == m_strip && lane == m_lane) {
        int mine = kInf;
#pragma unroll
        for (int x = 0; x < S; ++x) {
          if (x == m_x) mine = left[x];
        }
        sh.answer = mine;
      }
      if (lane == 31 && j >= 0 && j <= j_end) {
        sink[j & sink_mask] = bottom;
        least = min(least, bottom);
      }
      if ((s & 31) == 31 || s + 1 == steps) {
        __syncwarp();
        if (lane == 31) {
          __threadfence_block();
          vs.written[warp] = strip * stride + min(j, j_end) + 1;
        }
      }
    }
    if (may_stop && strip != m_strip && lane == 31 && least > w) {
      vs.gave_up = 1;
    }
    __syncwarp();
  }
  __syncthreads();
  return sh.gave_up ? kInf : sh.answer;
}

// Persistent CTAs of `blockDim.x / 32` warps; a CTA takes the open pairs
// (out[pair] < 0 after the warp kernel's ladder) from the counter at
// scratch[0] and runs the rung 4095 (where it is below half the band),
// then the band.  scratch: kCounterInts ints, then L + 1 ints a CTA.  With
// `stage`, dynamic shared memory holds the pair's two strings.
template <int S>
__global__ void __launch_bounds__(kStripMaxWarps * 32, 2)
    wavefront_strip_kernel(const uint8_t* __restrict__ a_codes,
                           const int32_t* __restrict__ a_lens,
                           const uint8_t* __restrict__ b_codes,
                           const int32_t* __restrict__ b_lens, int32_t* out,
                           int32_t* scratch, int batch, int length, int band,
                           int stage) {
  extern __shared__ uint4 shared_words[];
  __shared__ StripShared sh;
  int* row = scratch + kCounterInts +
             static_cast<int64_t>(blockIdx.x) * (length + 1);
  uint8_t* staged_a = reinterpret_cast<uint8_t*>(shared_words);
  uint8_t* staged_b = staged_a + length;
  for (;;) {
    if (threadIdx.x == 0) sh.pair = atomicAdd(scratch, 1);
    __syncthreads();
    const int pair = sh.pair;
    const int open = pair < batch ? out[pair] < 0 : 0;
    __syncthreads();  // sh.pair is read before thread 0 takes the next one
    if (pair >= batch) return;
    if (!open) continue;
    const int m = a_lens[pair];
    const int n = b_lens[pair];
    const uint8_t* text_a = a_codes + static_cast<int64_t>(pair) * length;
    const uint8_t* text_b = b_codes + static_cast<int64_t>(pair) * length;
    if (stage) {
      const bool wide =
          (length & 15) == 0 && aligned16(a_codes) && aligned16(b_codes);
      stage_text(staged_a, text_a, m, wide, threadIdx.x, blockDim.x);
      stage_text(staged_b, text_b, n, wide, threadIdx.x, blockDim.x);
      text_a = staged_a;
      text_b = staged_b;
    }
    const int w = min(band, max(m, n));
    int value = kInf;
    bool resolved = false;
    if (2 * kStripRung < w && abs(m - n) <= kStripRung) {
      value = strip_pass<S>(text_a, text_b, m, n, kStripRung, true, row, sh);
      resolved = value <= kStripRung;
    }
    if (!resolved) {
      value = strip_pass<S>(text_a, text_b, m, n, w, false, row, sh);
    }
    if (threadIdx.x == 0) out[pair] = value;
    __syncthreads();  // the staged strings are free for the next pair
  }
}

template <int kMaxS, bool kLadder>
int launch_warp_kernel(const void* a_codes, const void* a_lens,
                       const void* b_codes, const void* b_lens, void* out,
                       int batch, int length, int band, int warps, int stage,
                       cudaStream_t stream) {
  const size_t shared_bytes =
      stage ? static_cast<size_t>(warps) * 2 * length : 0;
  cudaError_t status = cudaFuncSetAttribute(
      wavefront_warp_kernel<kMaxS, kLadder>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_bytes));
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = (batch + warps - 1) / warps;
  wavefront_warp_kernel<kMaxS, kLadder>
      <<<blocks, 32 * warps, shared_bytes, stream>>>(
      static_cast<const uint8_t*>(a_codes),
      static_cast<const int32_t*>(a_lens),
      static_cast<const uint8_t*>(b_codes),
      static_cast<const int32_t*>(b_lens), static_cast<int32_t*>(out), batch,
      length, band, stage);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA may opt into on the current
// device, or -1.
int wavefront_max_shared_bytes() {
  int device = 0;
  int bytes = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

// Bytes of static shared memory of the strip kernel.
int wavefront_strip_static_bytes() {
  return static_cast<int>(sizeof(StripShared));
}

// 1 when the toolkit that built this library has the DPX intrinsics.
int wavefront_uses_dpx() {
#if defined(__CUDACC_VER_MAJOR__) && __CUDACC_VER_MAJOR__ >= 12
  return 1;
#else
  return 0;
#endif
}

// One warp per pair, `warps` pairs a CTA, strings staged in shared memory;
// `max_slots_per_lane` is 3, 9 or 33 and min(band, length) + 1 <= 32 *
// max_slots_per_lane.  Returns the cudaGetLastError() code of the launch (0
// on success), -1 for a bad `max_slots_per_lane`.
int wavefront_banded_distance_warp(const void* a_codes, const void* a_lens,
                                   const void* b_codes, const void* b_lens,
                                   void* out, int batch, int length, int band,
                                   int max_slots_per_lane, int warps,
                                   void* stream_handle) {
  cudaGetLastError();  // clear a stale error so the code below is ours
  if (batch <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  switch (max_slots_per_lane) {
    case 3:
      return launch_warp_kernel<3, false>(a_codes, a_lens, b_codes, b_lens,
                                          out, batch, length, band, warps, 1,
                                          stream);
    case 9:
      return launch_warp_kernel<9, false>(a_codes, a_lens, b_codes, b_lens,
                                          out, batch, length, band, warps, 1,
                                          stream);
    case 33:
      return launch_warp_kernel<33, false>(a_codes, a_lens, b_codes, b_lens,
                                           out, batch, length, band, warps, 1,
                                           stream);
    default:
      return -1;
  }
}

// CTAs the strip kernel runs for this call: as many as are resident at
// once, at most `batch` (the rows of `scratch`); -1 on an error.
int wavefront_strip_grid(int batch, int length, int strip_warps, int stage) {
  if (strip_warps < 1 || strip_warps > kStripMaxWarps) return -1;
  const size_t shared_bytes = stage ? static_cast<size_t>(2) * length : 0;
  if (cudaFuncSetAttribute(wavefront_strip_kernel<kStripRows>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(shared_bytes)) != cudaSuccess) {
    return -1;
  }
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, wavefront_strip_kernel<kStripRows>, 32 * strip_warps,
          shared_bytes) != cudaSuccess ||
      per_sm <= 0) {
    return -1;
  }
  return min(batch, sms * per_sm);
}

// The strip layout: the warp kernel's ladder (`ladder_warps` pairs a CTA,
// strings staged with `ladder_stage`), then the strip kernel (`strip_warps`
// warps a CTA, `grid` CTAs from wavefront_strip_grid, strings staged with
// `stage`) on the pairs the ladder left open.  `scratch` holds 64 + grid *
// (length + 1) int32.  Returns the first nonzero CUDA error code of the two
// launches, -1 for bad arguments.
int wavefront_banded_distance_strip(const void* a_codes, const void* a_lens,
                                    const void* b_codes, const void* b_lens,
                                    void* out, void* scratch, int batch,
                                    int length, int band, int ladder_warps,
                                    int ladder_stage, int strip_warps,
                                    int grid, int stage,
                                    void* stream_handle) {
  cudaGetLastError();
  if (batch <= 0) return 0;
  if (strip_warps < 1 || strip_warps > kStripMaxWarps || grid < 1) return -1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  int code = launch_warp_kernel<33, true>(a_codes, a_lens, b_codes, b_lens,
                                          out, batch, length, band,
                                          ladder_warps, ladder_stage, stream);
  if (code != 0) return code;
  cudaError_t status = cudaMemsetAsync(scratch, 0, sizeof(int32_t), stream);
  if (status != cudaSuccess) return static_cast<int>(status);
  const size_t shared_bytes = stage ? static_cast<size_t>(2) * length : 0;
  status = cudaFuncSetAttribute(wavefront_strip_kernel<kStripRows>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(shared_bytes));
  if (status != cudaSuccess) return static_cast<int>(status);
  wavefront_strip_kernel<kStripRows>
      <<<grid, 32 * strip_warps, shared_bytes, stream>>>(
          static_cast<const uint8_t*>(a_codes),
          static_cast<const int32_t*>(a_lens),
          static_cast<const uint8_t*>(b_codes),
          static_cast<const int32_t*>(b_lens), static_cast<int32_t*>(out),
          static_cast<int32_t*>(scratch), batch, length, band, stage);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
