// COLLECT's CIGAR scan with ordered event compaction for Hopper (sm_90a).
//
// Replaces the jit-compiled TPU program svim_tpu/ops/cigar_kernel.py
// (collect_scan: _decode, _geometry and _compact_events) and computes
// exactly what it computes, bit for bit, for a batch of N alignments of K
// BAM CIGAR words (length << 4 | op, padded with 0; the synthetic ops 9 and
// 10 of host-side compaction advance the reference and the read and are
// never events; op 3 advances only the geometry's reference end):
//   * geometry a row: ref_end = ref_start + the reference-consuming lengths
//     (M, D, N, =, X, 9), read_len = the query-consuming lengths (M, I, S, =,
//     X, 10) + the hard clips, qa_start = the soft clips before the row's
//     first op that is no clip (an op is clip-like when it is a soft clip of
//     positive length, a hard clip, or of length 0), qa_end = the query
//     length less the soft clips after its last such op, has_hard_clip;
//   * events: every D or I op of length >= min_sv_size, with its exclusive
//     reference and read offsets within the row, written in (row, op) order
//     to a table of max_events entries; entries past the true count hold
//     row -1 and zeros, and the true count is stored, so the caller can
//     re-run with a larger table without having read anything before.
// Sums wrap as the reference's int32 sums do: they are taken in uint32.
//
// Three launches on the caller's stream, none of which decides a position
// by an atomic (the (row, op) order is the contract):
//   1. a warp a row, over K in chunks of 32 words: warp reductions give the
//      geometry sums, a ballot the row's non-clip ops (the first and the
//      last bound the leading and trailing soft clips), another the row's
//      events, whose count goes to scratch;
//   2. one CTA scans the N counts (exclusive, a carried prefix over chunks
//      of 1024) into each row's first place in the table, and stores the
//      total;
//   3. a warp a row again: a warp scan with a carried prefix gives each
//      op's reference and read offsets, and each event goes to its row's
//      place plus the events before it in the row (a ballot and a popcount);
//      the CTAs past the rows write the fill after the count.
// What bounds it on this card: the words are read twice (passes 1 and 3)
// and nothing else is large, so it is bound by device memory: 4NK bytes
// read once in the function, twice here.  A row is a dependent chain of
// K / 32 steps of a few warp reductions, so a batch with few rows and very
// long rows is bound by that chain instead.  See PERF.md for its time
// against the bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 8;          // rows a CTA in passes 1 and 3
constexpr int kScanThreads = 1024;    // the one CTA of pass 2
constexpr int kFillThreads = 256;
constexpr int kMaxFillBlocks = 1024;

__device__ __forceinline__ bool is_match(int op) {
  return op == 0 || op == 7 || op == 8;
}

__device__ __forceinline__ uint32_t warp_inclusive_sum(uint32_t value,
                                                       int lane) {
#pragma unroll
  for (int delta = 1; delta < 32; delta <<= 1) {
    uint32_t other = __shfl_up_sync(kFull, value, delta);
    if (lane >= delta) value += other;
  }
  return value;
}

__global__ void __launch_bounds__(kRowWarps * 32)
    scan_rows(const int32_t* __restrict__ words,
              const int32_t* __restrict__ ref_start, int n, int k,
              int min_sv_size, int32_t* __restrict__ ref_end,
              int32_t* __restrict__ read_len, int32_t* __restrict__ qa_start,
              int32_t* __restrict__ qa_end, bool* __restrict__ has_hard_clip,
              int32_t* __restrict__ row_events) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp: a row is a warp
  const int32_t* row_words = words + static_cast<size_t>(row) * k;
  uint32_t ref_sum = 0, query_sum = 0, hard_sum = 0;
  uint32_t leading_soft = 0, trailing_soft = 0, events = 0;
  bool any_hard = false, seen_nonclip = false;
  for (int base = 0; base < k; base += 32) {
    const int col = base + lane;
    const bool inside = col < k;
    const int32_t word = inside ? __ldg(row_words + col) : 0;
    const int op = word & 0xF;
    const int len = word >> 4;  // arithmetic shift, as jnp's
    const uint32_t ulen = static_cast<uint32_t>(len);
    const bool match = is_match(op);
    const bool ref_consuming =
        inside && (match || op == 2 || op == 3 || op == 9);
    const bool query_consuming =
        inside && (match || op == 1 || op == 4 || op == 10);
    const bool soft = inside && op == 4 && len > 0;
    const bool hard = inside && op == 5 && len > 0;
    const bool nonclip = inside && !(soft || op == 5 || len == 0);
    const bool event = inside && (op == 1 || op == 2) && len >= min_sv_size;
    ref_sum += __reduce_add_sync(kFull, ref_consuming ? ulen : 0u);
    query_sum += __reduce_add_sync(kFull, query_consuming ? ulen : 0u);
    hard_sum += __reduce_add_sync(kFull, hard ? ulen : 0u);
    any_hard |= __any_sync(kFull, hard);
    events += __popc(__ballot_sync(kFull, event));
    const unsigned nonclip_lanes = __ballot_sync(kFull, nonclip);
    if (nonclip_lanes == 0) {  // warp-uniform branches from here on
      const uint32_t chunk_soft = __reduce_add_sync(kFull, soft ? ulen : 0u);
      if (seen_nonclip) {
        trailing_soft += chunk_soft;
      } else {
        leading_soft += chunk_soft;
      }
    } else {
      const int first = __ffs(nonclip_lanes) - 1;
      const int last = 31 - __clz(nonclip_lanes);
      if (!seen_nonclip) {
        leading_soft +=
            __reduce_add_sync(kFull, soft && lane < first ? ulen : 0u);
      }
      trailing_soft = __reduce_add_sync(kFull, soft && lane > last ? ulen : 0u);
      seen_nonclip = true;
    }
  }
  if (lane == 0) {
    ref_end[row] =
        static_cast<int32_t>(static_cast<uint32_t>(ref_start[row]) + ref_sum);
    read_len[row] = static_cast<int32_t>(query_sum + hard_sum);
    qa_start[row] = static_cast<int32_t>(leading_soft);
    // with no non-clip op every soft clip is leading and none trails
    qa_end[row] = static_cast<int32_t>(query_sum - trailing_soft);
    has_hard_clip[row] = any_hard;
    row_events[row] = static_cast<int32_t>(events);
  }
}

__global__ void __launch_bounds__(kScanThreads)
    scan_offsets(const int32_t* __restrict__ row_events, int n,
                 int32_t* __restrict__ row_offsets,
                 int32_t* __restrict__ count) {
  __shared__ uint32_t warp_offsets[kScanThreads / 32];
  __shared__ uint32_t carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const uint32_t value = i < n ? static_cast<uint32_t>(row_events[i]) : 0u;
    const uint32_t inclusive = warp_inclusive_sum(value, lane);
    if (lane == 31) warp_offsets[warp] = inclusive;
    __syncthreads();
    if (warp == 0) {
      const uint32_t total = warp_offsets[lane];
      warp_offsets[lane] = warp_inclusive_sum(total, lane) - total;
    }
    __syncthreads();
    const uint32_t exclusive = carry + warp_offsets[warp] + inclusive - value;
    if (i < n) row_offsets[i] = static_cast<int32_t>(exclusive);
    __syncthreads();  // every thread has read carry and warp_offsets
    if (threadIdx.x == kScanThreads - 1) carry = exclusive + value;
    __syncthreads();
  }
  if (threadIdx.x == 0) *count = static_cast<int32_t>(carry);
}

__global__ void __launch_bounds__(kRowWarps * 32)
    write_events(const int32_t* __restrict__ words, int n, int k,
                 int min_sv_size, int max_events, int row_blocks,
                 const int32_t* __restrict__ row_offsets,
                 const int32_t* __restrict__ count,
                 int32_t* __restrict__ rows, int32_t* __restrict__ pos_ref,
                 int32_t* __restrict__ pos_read,
                 int32_t* __restrict__ lengths,
                 bool* __restrict__ is_insertion) {
  if (static_cast<int>(blockIdx.x) >= row_blocks) {
    // the fill after the events the table keeps
    const uint32_t total = static_cast<uint32_t>(*count);
    const uint32_t kept =
        total < static_cast<uint32_t>(max_events) ? total : max_events;
    const uint32_t stride = (gridDim.x - row_blocks) * blockDim.x;
    for (uint32_t i = kept + (blockIdx.x - row_blocks) * blockDim.x +
                      threadIdx.x;
         i < static_cast<uint32_t>(max_events); i += stride) {
      rows[i] = -1;
      pos_ref[i] = 0;
      pos_read[i] = 0;
      lengths[i] = 0;
      is_insertion[i] = false;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const int32_t* row_words = words + static_cast<size_t>(row) * k;
  const unsigned below = (1u << lane) - 1u;
  uint32_t place = static_cast<uint32_t>(row_offsets[row]);
  uint32_t ref_before = 0, read_before = 0;
  for (int base = 0; base < k; base += 32) {
    if (place >= static_cast<uint32_t>(max_events)) return;  // warp-uniform
    const int col = base + lane;
    const bool inside = col < k;
    const int32_t word = inside ? __ldg(row_words + col) : 0;
    const int op = word & 0xF;
    const int len = word >> 4;
    const uint32_t ulen = static_cast<uint32_t>(len);
    const bool match = is_match(op);
    const uint32_t ref_advance =
        inside && (match || op == 2 || op == 9) ? ulen : 0u;
    const uint32_t read_advance =
        inside && (match || op == 1 || op == 4 || op == 10) ? ulen : 0u;
    const uint32_t ref_inclusive = warp_inclusive_sum(ref_advance, lane);
    const uint32_t read_inclusive = warp_inclusive_sum(read_advance, lane);
    const bool event = inside && (op == 1 || op == 2) && len >= min_sv_size;
    const unsigned event_lanes = __ballot_sync(kFull, event);
    if (event) {
      const uint32_t at = place + __popc(event_lanes & below);
      if (at < static_cast<uint32_t>(max_events)) {
        rows[at] = row;
        pos_ref[at] =
            static_cast<int32_t>(ref_before + ref_inclusive - ref_advance);
        pos_read[at] =
            static_cast<int32_t>(read_before + read_inclusive - read_advance);
        lengths[at] = len;
        is_insertion[at] = op == 1;
      }
    }
    place += __popc(event_lanes);
    ref_before += __shfl_sync(kFull, ref_inclusive, 31);
    read_before += __shfl_sync(kFull, read_inclusive, 31);
  }
}

}  // namespace

extern "C" {

// words (n, k) int32, ref_start (n,) int32; outputs ref_end, read_len,
// qa_start, qa_end (n,) int32 and has_hard_clip (n,) bytes; rows, pos_ref,
// pos_read, lengths (max_events,) int32 and is_insertion (max_events,)
// bytes; count, one int32; scratch (2, n) int32 (each row's event count,
// then its first place in the table).  Every output is written in full.
// Three launches on `stream` (none when n == 0); returns the CUDA error code
// of the first launch that failed (0 on success).
int collect_scan(const void* words, const void* ref_start, int n, int k,
                 int min_sv_size, int max_events, void* ref_end,
                 void* read_len, void* qa_start, void* qa_end,
                 void* has_hard_clip, void* rows, void* pos_ref,
                 void* pos_read, void* lengths, void* is_insertion,
                 void* count, void* scratch, void* stream) {
  cudaGetLastError();  // clear a stale error so the codes below are ours
  if (n <= 0) return 0;
  cudaStream_t on = static_cast<cudaStream_t>(stream);
  int32_t* row_events = static_cast<int32_t*>(scratch);
  int32_t* row_offsets = row_events + n;
  const int row_blocks = (n + kRowWarps - 1) / kRowWarps;
  scan_rows<<<row_blocks, kRowWarps * 32, 0, on>>>(
      static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(ref_start), n, k, min_sv_size,
      static_cast<int32_t*>(ref_end), static_cast<int32_t*>(read_len),
      static_cast<int32_t*>(qa_start), static_cast<int32_t*>(qa_end),
      static_cast<bool*>(has_hard_clip), row_events);
  cudaError_t error = cudaGetLastError();
  if (error != cudaSuccess) return static_cast<int>(error);
  scan_offsets<<<1, kScanThreads, 0, on>>>(row_events, n, row_offsets,
                                          static_cast<int32_t*>(count));
  error = cudaGetLastError();
  if (error != cudaSuccess) return static_cast<int>(error);
  int fill_blocks = (max_events + kFillThreads - 1) / kFillThreads;
  if (fill_blocks > kMaxFillBlocks) fill_blocks = kMaxFillBlocks;
  if (fill_blocks < 1) fill_blocks = 1;
  // pass 3's CTAs are kRowWarps rows, or kFillThreads fill entries: both 256
  write_events<<<row_blocks + fill_blocks, kRowWarps * 32, 0, on>>>(
      static_cast<const int32_t*>(words), n, k, min_sv_size, max_events,
      row_blocks, row_offsets, static_cast<const int32_t*>(count),
      static_cast<int32_t*>(rows), static_cast<int32_t*>(pos_ref),
      static_cast<int32_t*>(pos_read), static_cast<int32_t*>(lengths),
      static_cast<bool*>(is_insertion));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
