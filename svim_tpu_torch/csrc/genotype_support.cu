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
// Design: one CTA of 256 threads a candidate.
//   * The support row is staged in shared memory when it holds at most
//     4,096 ids, and searched in device memory above that (S has no cap).
//   * The window is walked in tiles of 256 rows, a thread a row, in
//     coordinate order (coalesced loads of the three columns).  One block
//     scan a tile (warp shuffles and one pass over the warp sums) of
//     qualifying + (qualifying & spans) << 16 gives each row its exact rank
//     and its place among the tile's spanning rows: the cap keeps the first
//     500 qualifying rows in coordinate order, so it is a scan, not atomics.
//     A capped spanning row's place in the list is the count of spanning
//     rows before it, since every qualifying row before a capped one is
//     capped too.
//   * The walk stops once 500 rows qualified: no later row can be capped,
//     so the stop is exact, and it bounds the work at any width.
//   * The supporting ids (at most 500) sit in a list of 512 ints in shared
//     memory, INT_MAX where nothing was written; a bitonic sort of the
//     smallest power of two that holds them, then the boundaries counted
//     with __syncthreads_count.  Thread 0 writes the count.
// What bounds it on this card: bytes.  A candidate reads its rows up to
// the 500th qualifying one (12 bytes a row), its support row and writes 4
// bytes; at the main path's sizes that is kilobytes, so a call is one short
// launch.  No host synchronisation.  See PERF.md for its time against the
// bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCap = 500;            // ALIGNMENT_CAP, SVIM_genotyping.py:56
constexpr int kList = 512;           // the cap rounded up to a power of two
constexpr int kStageWords = 4096;    // support ids staged in shared memory
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
__device__ __forceinline__ bool in_support(const int32_t* row, int s,
                                           int32_t id) {
  int lo = 0;
  int hi = s;
  while (lo < hi) {
    const int mid = static_cast<int>(
        (static_cast<unsigned>(lo) + static_cast<unsigned>(hi)) >> 1);
    if (row[mid] < id) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return row[lo < s ? lo : s - 1] == id;
}

// Inclusive sum over the CTA of `value`; *total gets the CTA's sum.  Two
// barriers; warp_sums may be written again only after a third.
__device__ __forceinline__ int block_inclusive_scan(int value, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int offset = 1; offset < 32; offset <<= 1) {
    const int other = __shfl_up_sync(kFull, value, offset);
    if (lane >= offset) value += other;
  }
  if (lane == 31) warp_sums[warp] = value;
  __syncthreads();
  if (warp == 0) {
    int sum = lane < kWarps ? warp_sums[lane] : 0;
    for (int offset = 1; offset < kWarps; offset <<= 1) {
      const int other = __shfl_up_sync(kFull, sum, offset);
      if (lane >= offset) sum += other;
    }
    if (lane < kWarps) warp_sums[lane] = sum;
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  return value + (warp > 0 ? warp_sums[warp - 1] : 0);
}

__global__ void __launch_bounds__(kThreads)
    genotype_support_kernel(const int32_t* __restrict__ lo,
                            const int32_t* __restrict__ width,
                            const int32_t* __restrict__ window_start2,
                            const int32_t* __restrict__ start2,
                            const int32_t* __restrict__ end2,
                            const int32_t* __restrict__ min_overlap2,
                            const int32_t* __restrict__ type_class,
                            const int32_t* __restrict__ support, int s,
                            const int32_t* __restrict__ starts2,
                            const int32_t* __restrict__ ends2,
                            const int32_t* __restrict__ ids, int table_rows,
                            int slice_len, int32_t* __restrict__ counts) {
  __shared__ int32_t stage[kStageWords];
  __shared__ int32_t list[kList];
  __shared__ int warp_sums[kWarps];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int rows = min(max(width[c], 0), slice_len);
  if (rows == 0) {
    if (tid == 0) counts[c] = 0;
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

  const int32_t* row_ids = support + static_cast<size_t>(c) * s;
  if (s <= kStageWords) {
    for (int i = tid; i < s; i += kThreads) stage[i] = row_ids[i];
    row_ids = stage;
  }
  for (int i = tid; i < kList; i += kThreads) list[i] = kIntMax;
  __syncthreads();

  int qualified = 0;   // qualifying rows so far (the same in every thread)
  int listed = 0;      // supporting ids in the list so far
  for (int base = 0; base < rows && qualified < kCap; base += kThreads) {
    const int k = base + tid;
    bool qualifying = false;
    bool spans = false;
    int32_t id = 0;
    if (k < rows) {
      const int row = first + k;
      const int32_t end = ends2[row];
      id = ids[row];
      if (end > ws2 && !in_support(row_ids, s, id)) {
        qualifying = true;
        const int32_t start = starts2[row];
        spans = del_inv ? ((start < end_less_overlap && end > end_plus_margin) ||
                           (start < start_less_margin &&
                            end > start_plus_overlap))
                        : (start < start_less_margin && end > end_plus_margin);
      }
    }
    int tile = 0;
    const int inclusive = block_inclusive_scan(
        static_cast<int>(qualifying) + (static_cast<int>(qualifying && spans)
                                        << 16),
        warp_sums, &tile);
    const bool supports = qualifying && spans &&
                          qualified + (inclusive & 0xffff) <= kCap;
    if (supports) list[listed + (inclusive >> 16) - 1] = id;
    // the barrier also ends this tile's reads of warp_sums
    listed += __syncthreads_count(supports);
    qualified += tile & 0xffff;
  }

  // bitonic sort of the first power of two >= listed entries (the rest are
  // INT_MAX already)
  int size = 1;
  while (size < listed) size <<= 1;
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < size; i += kThreads) {
        const int partner = i ^ j;
        if (partner > i) {
          const int32_t a = list[i];
          const int32_t b = list[partner];
          if ((a > b) == ((i & k) == 0)) {
            list[i] = b;
            list[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  int distinct = 0;
  for (int i = tid; i < kList; i += kThreads) {
    const int32_t value = list[i];
    const int32_t previous = i > 0 ? list[i - 1] : kIntMin;
    distinct += __syncthreads_count(value != kIntMax && value != previous);
  }
  if (tid == 0) counts[c] = distinct;
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
  genotype_support_kernel<<<static_cast<unsigned>(candidates), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(width),
      static_cast<const int32_t*>(window_start2),
      static_cast<const int32_t*>(start2), static_cast<const int32_t*>(end2),
      static_cast<const int32_t*>(min_overlap2),
      static_cast<const int32_t*>(type_class),
      static_cast<const int32_t*>(support), s,
      static_cast<const int32_t*>(starts2), static_cast<const int32_t*>(ends2),
      static_cast<const int32_t*>(ids), table_rows, slice_len,
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
