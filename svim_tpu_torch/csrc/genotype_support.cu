// GENOTYPE's reference-support interval join for Hopper (sm_90a).
//
// Replaces the jit-compiled TPU program svim_tpu/ops/genotype_kernel.py
// (genotype_support_batched, vmapping _genotype_one over the candidates)
// and computes what it computes, one int32 count a candidate.  Candidate c
// looks at rows lo[c] .. lo[c] + width[c] of a coordinate-sorted table of
// doubled coordinates (starts2, ends2, ids), padded so that no window runs
// off its end, and at a sorted row of S support ids (padding INT_MAX).  In
// coordinate order, a row
//   1. qualifies when it lies in the slice, its end passes window_start2,
//      and its id is not a support id (jnp.searchsorted on the left,
//      clamped to the last entry, then an equality test: a table id of
//      INT_MAX matches the row's padding, as in the reference);
//   2. is capped when fewer than 500 qualifying rows come before it;
//   3. supports when it is capped and spans the candidate (type_class 0:
//      DEL/INV, else INS/DUP_INT; margins of 200 in doubled coordinates).
// The count is the number of distinct ids among the supporting rows, as
// the reference counts boundaries of the sorted ids with non-supporters
// masked to INT_MAX and a first previous of INT_MIN: neither sentinel is
// ever counted.  end2 + 200, start2 - 200, end2 - min_overlap2 and
// start2 + min_overlap2 wrap as jnp's int32 do (taken in uint32).  The
// window's start is clamped to [0, rows - slice_len] and its length to
// [0, slice_len], as jax.lax.dynamic_slice and the slice's mask do.
//
// Design: a warp a candidate, eight candidates a CTA, and no block
// barrier anywhere: a warp synchronises with __syncwarp and its own
// collectives, and a warp whose window is empty writes 0 and leaves.
//   * The support row is staged in the warp's slice of shared memory when
//     it holds at most 512 ids (by cp.async, while the window's first rows
//     load), and searched in device memory above that (S has no cap), by
//     a branch-free lower bound of ceil(log2 S) steps.
//   * The window is walked in coordinate order in steps of 4 x 32 rows:
//     lane l loads rows base + r * 32 + l for r = 0..3 (coalesced, issued
//     together).  After the first step the ends come first: a step none of
//     whose rows ends past the window's start is done (no row of it can
//     qualify), else the lanes load those rows' starts and ids.  Then for
//     each r in order two ballots, of the qualifying rows and of the
//     supporting ones, give each row its exact rank (the rows qualified so
//     far plus the qualifying lanes below it, plus one) and a supporting
//     row its slot in the list (the ids listed so far plus the supporting
//     lanes below it).  A row
//     supports when it spans and its rank is at most 500: the cap keeps the
//     first 500 qualifying rows in coordinate order, without atomics.
//   * The walk stops once 500 rows qualified: no later row can be capped,
//     so the stop is exact, and it bounds the work at any width.
//   * The supporting ids (at most 500) sit in the warp's list of 512 ints in
//     shared memory.  They are sorted in registers by a bitonic network
//     over the smallest power of two that holds them (at least 32; the
//     rest INT_MAX), size / 32 values a lane, compare-exchanges within a
//     lane or across lanes by shuffles; the boundaries are counted in each
//     lane and summed over the warp; lane 0 writes the count.
// What bounds it on this card: the walk's operations (a binary search of
// the support row a row in the window) once the windows' rows sit in L2;
// at the main path's sizes (a few hundred candidates, windows of <= 1,024
// rows) a call is one short launch.  No host synchronisation.  See PERF.md
// for its time against the bound.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;             // candidates a CTA
constexpr int kThreads = kWarps * 32;
constexpr int kRowsALane = 4;         // rows a lane loads a step
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCap = 500;            // ALIGNMENT_CAP, SVIM_genotyping.py:56
constexpr int kList = 512;           // the cap rounded up to a power of two
constexpr int kStageWords = 512;     // support ids staged a warp
constexpr int32_t kIntMax = 2147483647;
constexpr int32_t kIntMin = -kIntMax - 1;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// jnp.searchsorted(row, id) on the left, clamped to s - 1, then equality.
// The search is branch-free and takes ceil(log2 s) steps whatever the id,
// the same in every lane of a warp: on a sorted row it is the lower bound.
__device__ __forceinline__ bool in_support(const int32_t* row, int s,
                                           int32_t id) {
  const int32_t* at = row;
  for (int n = s; n > 1;) {
    const int half = n >> 1;
    at = at[half] < id ? at + half : at;
    n -= half;
  }
  const int index = static_cast<int>(at - row) + (*at < id ? 1 : 0);
  return row[index < s ? index : s - 1] == id;
}

// The number of distinct ids among the first `listed` entries of `list`
// (at most 32 * kPerLane of them), as the reference counts them: sorted,
// then the boundaries with a first previous of INT_MIN, INT_MAX never
// counted.  The bitonic network over 32 * kPerLane entries runs in
// registers, entry x = lane * kPerLane + e in value e of a lane: stages
// whose partner differs in the low bits compare within a lane, the others
// exchange with lane ^ (j / kPerLane) by __shfl_xor_sync.  Entries past
// `listed` are INT_MAX.  Called by the whole warp after a __syncwarp.
template <int kPerLane>
__device__ __forceinline__ int distinct_ids(const int32_t* list, int listed,
                                            int lane) {
  constexpr int kSize = 32 * kPerLane;
  int32_t value[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int x = lane * kPerLane + e;
    value[e] = x < listed ? list[x] : kIntMax;
  }
#pragma unroll
  for (int k = 2; k <= kSize; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= kPerLane) {
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) {
          const int x = lane * kPerLane + e;
          const int32_t other = __shfl_xor_sync(kFull, value[e], j / kPerLane);
          const bool keep_min = ((x & j) == 0) == ((x & k) == 0);
          value[e] = keep_min ? min(value[e], other) : max(value[e], other);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) {
          if (e & j) continue;
          const bool ascending = ((lane * kPerLane + e) & k) == 0;
          const int32_t low = min(value[e], value[e | j]);
          const int32_t high = max(value[e], value[e | j]);
          value[e] = ascending ? low : high;
          value[e | j] = ascending ? high : low;
        }
      }
    }
  }
  const int32_t above = __shfl_up_sync(kFull, value[kPerLane - 1], 1);
  int distinct = 0;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int32_t previous =
        e > 0 ? value[e - 1] : (lane == 0 ? kIntMin : above);
    distinct += value[e] != kIntMax && value[e] != previous ? 1 : 0;
  }
  return __reduce_add_sync(kFull, distinct);
}

// 4 CTAs an SM (64 registers): 4,224 warps in flight on 132 SMs
__global__ void __launch_bounds__(kThreads, 4)
    genotype_support_kernel(const int32_t* __restrict__ lo,
                            const int32_t* __restrict__ width,
                            const int32_t* __restrict__ window_start2,
                            const int32_t* __restrict__ start2,
                            const int32_t* __restrict__ end2,
                            const int32_t* __restrict__ min_overlap2,
                            const int32_t* __restrict__ type_class,
                            const int32_t* __restrict__ support, int s,
                            int candidates,
                            const int32_t* __restrict__ starts2,
                            const int32_t* __restrict__ ends2,
                            const int32_t* __restrict__ ids, int table_rows,
                            int slice_len, int32_t* __restrict__ counts) {
  __shared__ int32_t stage[kWarps][kStageWords];
  __shared__ int32_t lists[kWarps][kList];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= candidates) return;
  const int rows = min(max(width[c], 0), slice_len);
  if (rows == 0) {
    if (lane == 0) counts[c] = 0;
    return;
  }
  const int first = min(max(lo[c], 0), table_rows - slice_len);
  const int32_t ws2 = window_start2[c];
  const int32_t s2 = start2[c];
  const int32_t e2 = end2[c];
  const int32_t mo2 = min_overlap2[c];
  const bool del_inv = type_class[c] == 0;
  // the reference's four wrapping bounds
  const int32_t end_less_overlap = wrap_sub(e2, mo2);
  const int32_t end_plus_margin = wrap_add(e2, 200);
  const int32_t start_less_margin = wrap_sub(s2, 200);
  const int32_t start_plus_overlap = wrap_add(s2, mo2);

  // the support row is staged by cp.async, beside the loads of the
  // window's first rows: the two share one trip to memory
  const int32_t* row_ids = support + static_cast<size_t>(c) * s;
  const bool staged = s <= kStageWords;
  if (staged) {
    for (int i = lane; i < s; i += 32) {
      __pipeline_memcpy_async(&stage[warp][i], row_ids + i, sizeof(int32_t));
    }
    __pipeline_commit();
  }
  int32_t* list = lists[warp];
  const unsigned lanes_below = (1u << lane) - 1u;

  int32_t end[kRowsALane];
  int32_t start[kRowsALane];
  int32_t id[kRowsALane];
#pragma unroll
  for (int r = 0; r < kRowsALane; ++r) {
    const int k = r * 32 + lane;
    end[r] = k < rows ? ends2[first + k] : kIntMin;
    start[r] = k < rows ? starts2[first + k] : 0;
    id[r] = k < rows ? ids[first + k] : 0;
  }
  if (staged) {
    __pipeline_wait_prior(0);
    __syncwarp();
    row_ids = stage[warp];
  }

  int qualified = 0;   // qualifying rows so far (the same in every lane)
  int listed = 0;      // supporting ids in the list so far
  for (int base = 0; base < rows && qualified < kCap;
       base += 32 * kRowsALane) {
    // a row qualifies only when its end passes the window's start: after
    // the first step the ends come first, and a step with none of them
    // past it is skipped
    if (base > 0) {
#pragma unroll
      for (int r = 0; r < kRowsALane; ++r) {
        const int k = base + r * 32 + lane;
        end[r] = k < rows ? ends2[first + k] : kIntMin;
      }
    }
    bool in_window[kRowsALane];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRowsALane; ++r) {
      in_window[r] = base + r * 32 + lane < rows && end[r] > ws2;
      any = any || in_window[r];
    }
    if (!__any_sync(kFull, any)) continue;
    if (base > 0) {
#pragma unroll
      for (int r = 0; r < kRowsALane; ++r) {
        const int k = base + r * 32 + lane;
        start[r] = in_window[r] ? starts2[first + k] : 0;
        id[r] = in_window[r] ? ids[first + k] : 0;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsALane; ++r) {
      const bool qualifying = in_window[r] && !in_support(row_ids, s, id[r]);
      const bool spans =
          del_inv ? ((start[r] < end_less_overlap && end[r] > end_plus_margin) ||
                     (start[r] < start_less_margin &&
                      end[r] > start_plus_overlap))
                  : (start[r] < start_less_margin && end[r] > end_plus_margin);
      const unsigned qualifying_lanes = __ballot_sync(kFull, qualifying);
      const int rank = qualified + __popc(qualifying_lanes & lanes_below) + 1;
      const bool supports = qualifying && spans && rank <= kCap;
      const unsigned supporting_lanes = __ballot_sync(kFull, supports);
      if (supports) {
        list[listed + __popc(supporting_lanes & lanes_below)] = id[r];
      }
      listed += __popc(supporting_lanes);
      qualified += __popc(qualifying_lanes);
      if (qualified >= kCap) break;
    }
  }
  __syncwarp();
  // the smallest power of two >= listed (at least 32) entries sorted
  const int distinct = listed <= 32    ? distinct_ids<1>(list, listed, lane)
                       : listed <= 64  ? distinct_ids<2>(list, listed, lane)
                       : listed <= 128 ? distinct_ids<4>(list, listed, lane)
                       : listed <= 256 ? distinct_ids<8>(list, listed, lane)
                                       : distinct_ids<16>(list, listed, lane);
  if (lane == 0) counts[c] = distinct;
}

}  // namespace

extern "C" {

// Inputs: lo, width, window_start2, start2, end2, min_overlap2, type_class
// (candidates,) int32; support (candidates, s) int32, each row sorted;
// starts2, ends2, ids (table_rows,) int32 with table_rows >= slice_len;
// output counts (candidates,) int32, written in full.  One launch on
// `stream` (none when candidates == 0); returns the CUDA error code of the
// launch (0 on success).
int genotype_support(const void* lo, const void* width,
                     const void* window_start2, const void* start2,
                     const void* end2, const void* min_overlap2,
                     const void* type_class, const void* support,
                     int candidates, int s, const void* starts2,
                     const void* ends2, const void* ids, int table_rows,
                     int slice_len, void* counts, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is ours
  if (candidates == 0) return 0;
  genotype_support_kernel<<<static_cast<unsigned>(
                                (candidates + kWarps - 1) / kWarps),
                            kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(width),
      static_cast<const int32_t*>(window_start2),
      static_cast<const int32_t*>(start2), static_cast<const int32_t*>(end2),
      static_cast<const int32_t*>(min_overlap2),
      static_cast<const int32_t*>(type_class),
      static_cast<const int32_t*>(support), s, candidates,
      static_cast<const int32_t*>(starts2), static_cast<const int32_t*>(ends2),
      static_cast<const int32_t*>(ids), table_rows, slice_len,
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
