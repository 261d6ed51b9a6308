// COLLECT's split-read sort-and-classify for Hopper (sm_90a).
//
// Replaces the jit-compiled TPU program svim_tpu/ops/segments_kernel.py
// (classify_groups_fused and _classify_core) and computes exactly what it
// computes, bit for bit, for G groups (reads) of S segment slots:
//   1. each slot's geometry: a slot with a packed row (slot_row >= 0) takes
//      the row's ref_end, read_len, qa_start, qa_end from the COLLECT pass's
//      outputs still on the device and its ref_id, ref_start and strand
//      from the packed columns, its query bounds strand-corrected
//      (read_len - qa_end, read_len - qa_start on the reverse strand); any
//      other slot takes the host-parsed columns;
//   2. a stable sort by (q_start, q_end) with invalid slots keyed INT32_MAX
//      in both: a slot's place is the number of slots with a smaller key,
//      or an equal key and a lower index (a rank sort), which is the
//      permutation of the reference's two stable argsorts;
//   3. the first max_segments sorted slots stay valid, and none does when
//      the group's hard-clip gate row has a hard clip;
//   4. each adjacent pair runs the reference's chain of masked selects in
//      its order (INS, DEL and its twin, huge DEL, tandem near and far and
//      their twin, huge tandem, INV and its twin, huge INV, cross-contig;
//      the first match wins), and contig2 becomes the next segment's contig
//      for a BND.
// Differences of coordinates wrap as jnp's int32 do (taken in uint32);
// the thresholds are compared exactly (in 64 bits), as the reference's
// Python integers are.  Outputs (G, S-1): code, p1, p2, aux, contig2,
// qpos, twin_mask, twin_p1, twin_p2, twin_aux, and the sorted strand and
// contig of each pair's first segment.
//
// Design: one CTA a group, a thread a slot (a warp when S <= 32; up to
// 1024 threads, each taking every 1024th slot above that), the group's
// slots in shared memory twice (as gathered, then in sorted order), then
// a thread a pair.  What bounds it on this card: nothing large moves (a
// group is S slots of ~24 bytes in and S-1 pairs of ~38 bytes out), so at
// the main path's G and S it is one short launch; the rank sort is S^2
// compares a group, which only matters for the rare reads with hundreds of
// segments.  See PERF.md for its time against the bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int32_t kIntMax = 2147483647;

struct Thresholds {
  long long min_sv_size, max_sv_size, gap_tolerance, overlap_tolerance;
};

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// The group's slots in shared memory: five int32 columns and two byte
// columns of S entries each, the whole rounded up to 16 bytes so that the
// second copy starts aligned.
struct Slots {
  int32_t *q_start, *q_end, *ref_id, *ref_start, *ref_end;
  uint8_t *reverse, *valid;

  __device__ Slots(char* base, int s) {
    int32_t* words = reinterpret_cast<int32_t*>(base);
    q_start = words;
    q_end = words + s;
    ref_id = words + 2 * s;
    ref_start = words + 3 * s;
    ref_end = words + 4 * s;
    reverse = reinterpret_cast<uint8_t*>(words + 5 * s);
    valid = reverse + s;
  }
};

__host__ __device__ constexpr size_t slots_bytes(int s) {
  return (static_cast<size_t>(s) * (5 * sizeof(int32_t) + 2) + 15) / 16 * 16;
}

struct Pair {
  int32_t code = 0, p1 = 0, p2 = 0, aux = 0;
  bool twin = false;
  int32_t twin_p1 = 0, twin_p2 = 0, twin_aux = 0;

  // the reference's setwhere: the first mask that holds wins
  __device__ bool set(bool mask, bool pair_valid, int32_t new_code,
                      int32_t new_p1, int32_t new_p2, int32_t new_aux) {
    mask = mask && code == 0 && pair_valid;
    if (mask) {
      code = new_code;
      p1 = new_p1;
      p2 = new_p2;
      aux = new_aux;
    }
    return mask;
  }

  __device__ void set_twin(bool mask, int32_t new_p1, int32_t new_p2,
                           int32_t new_aux) {
    twin = twin || mask;
    if (mask) {
      twin_p1 = new_p1;
      twin_p2 = new_p2;
      twin_aux = new_aux;
    }
  }
};

__global__ void classify_groups(
    const int32_t* __restrict__ slot_row,
    const int32_t* __restrict__ q_start_h, const int32_t* __restrict__ q_end_h,
    const int32_t* __restrict__ ref_id_h,
    const int32_t* __restrict__ ref_start_h,
    const int32_t* __restrict__ ref_end_h,
    const uint8_t* __restrict__ is_reverse_h,
    const uint8_t* __restrict__ valid_h,
    const int32_t* __restrict__ hard_gate_row,
    const int32_t* __restrict__ ref_id_all,
    const int32_t* __restrict__ ref_start_all,
    const uint8_t* __restrict__ is_reverse_all,
    const int32_t* __restrict__ ref_end_dev,
    const int32_t* __restrict__ read_len_dev,
    const int32_t* __restrict__ qa_start_dev,
    const int32_t* __restrict__ qa_end_dev,
    const uint8_t* __restrict__ has_hard_dev, int s, int max_segments,
    Thresholds limits, int32_t* __restrict__ code_out,
    int32_t* __restrict__ p1_out, int32_t* __restrict__ p2_out,
    int32_t* __restrict__ aux_out, int32_t* __restrict__ contig2_out,
    int32_t* __restrict__ qpos_out, uint8_t* __restrict__ twin_mask_out,
    int32_t* __restrict__ twin_p1_out, int32_t* __restrict__ twin_p2_out,
    int32_t* __restrict__ twin_aux_out, uint8_t* __restrict__ reverse_out,
    int32_t* __restrict__ ref_id_out) {
  extern __shared__ __align__(16) char shared[];
  Slots gathered(shared, s);
  Slots sorted(shared + slots_bytes(s), s);
  const size_t group = blockIdx.x;
  const size_t in = group * s;

  // 1. gather
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    const int32_t row = slot_row[in + i];
    if (row >= 0) {
      const bool reverse = is_reverse_all[row] != 0;
      const int32_t read_len = read_len_dev[row];
      const int32_t qa_start = qa_start_dev[row];
      const int32_t qa_end = qa_end_dev[row];
      gathered.q_start[i] = reverse ? wrap_sub(read_len, qa_end) : qa_start;
      gathered.q_end[i] = reverse ? wrap_sub(read_len, qa_start) : qa_end;
      gathered.ref_id[i] = ref_id_all[row];
      gathered.ref_start[i] = ref_start_all[row];
      gathered.ref_end[i] = ref_end_dev[row];
      gathered.reverse[i] = reverse;
    } else {
      gathered.q_start[i] = q_start_h[in + i];
      gathered.q_end[i] = q_end_h[in + i];
      gathered.ref_id[i] = ref_id_h[in + i];
      gathered.ref_start[i] = ref_start_h[in + i];
      gathered.ref_end[i] = ref_end_h[in + i];
      gathered.reverse[i] = is_reverse_h[in + i] != 0;
    }
    gathered.valid[i] = valid_h[in + i] != 0;
  }
  __syncthreads();

  // 2. rank sort by (q_start, q_end, slot)
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    const bool valid = gathered.valid[i];
    const int32_t start = valid ? gathered.q_start[i] : kIntMax;
    const int32_t end = valid ? gathered.q_end[i] : kIntMax;
    int rank = 0;
    for (int j = 0; j < s; ++j) {
      const bool other_valid = gathered.valid[j];
      const int32_t other_start = other_valid ? gathered.q_start[j] : kIntMax;
      const int32_t other_end = other_valid ? gathered.q_end[j] : kIntMax;
      rank += other_start < start ||
              (other_start == start &&
               (other_end < end || (other_end == end && j < i)));
    }
    sorted.q_start[rank] = gathered.q_start[i];
    sorted.q_end[rank] = gathered.q_end[i];
    sorted.ref_id[rank] = gathered.ref_id[i];
    sorted.ref_start[rank] = gathered.ref_start[i];
    sorted.ref_end[rank] = gathered.ref_end[i];
    sorted.reverse[rank] = gathered.reverse[i];
    sorted.valid[rank] = valid;
  }
  __syncthreads();

  // 3. truncation and the hard-clip gate
  const int32_t gate = hard_gate_row[group];
  const bool enabled = gate < 0 || has_hard_dev[gate] == 0;

  // 4. a thread a pair
  const size_t out = group * (s - 1);
  for (int p = threadIdx.x; p < s - 1; p += blockDim.x) {
    const int n = p + 1;
    const bool pair_valid = enabled && sorted.valid[p] && sorted.valid[n] &&
                            n < max_segments;
    const int32_t d_read = wrap_sub(sorted.q_start[n], sorted.q_end[p]);
    const bool same_ref = sorted.ref_id[p] == sorted.ref_id[n];
    const bool rev_cur = sorted.reverse[p] != 0;
    const bool same_orient = rev_cur == (sorted.reverse[n] != 0);
    const int32_t rs_cur = sorted.ref_start[p], re_cur = sorted.ref_end[p];
    const int32_t rs_nxt = sorted.ref_start[n], re_nxt = sorted.ref_end[n];
    const int32_t d_ref =
        rev_cur ? wrap_sub(rs_cur, re_nxt) : wrap_sub(rs_nxt, re_cur);
    const int32_t deviation = wrap_sub(d_read, d_ref);
    const long long d_read_l = d_read, d_ref_l = d_ref,
                    deviation_l = deviation;

    const bool read_no_overlap = d_read_l >= -limits.overlap_tolerance;
    const bool read_no_gap = d_read_l <= limits.gap_tolerance;
    const bool read_window = read_no_overlap && read_no_gap;
    Pair pair;
    int32_t contig2 = sorted.ref_id[p];
    const int32_t qpos = rev_cur ? sorted.q_start[n] : sorted.q_end[p];

    // same contig, same orientation
    const bool colinear = same_ref && same_orient;
    const bool no_ref_overlap = d_ref_l >= -limits.overlap_tolerance;
    pair.set(colinear && read_no_overlap && no_ref_overlap &&
                 deviation_l >= limits.min_sv_size &&
                 d_ref_l <= limits.gap_tolerance,
             pair_valid, 1, rev_cur ? rs_cur : re_cur, deviation, 0);

    const int32_t del_anchor = rev_cur ? re_nxt : re_cur;
    const bool del_mask = pair.set(
        colinear && read_no_overlap && no_ref_overlap &&
            deviation_l <= -limits.min_sv_size &&
            deviation_l >= -limits.max_sv_size && read_no_gap,
        pair_valid, 2, del_anchor, wrap_sub(0, deviation), 0);
    pair.set_twin(del_mask, wrap_sub(del_anchor, 1),
                  wrap_sub(del_anchor, deviation), 0);

    pair.set(colinear && read_no_overlap && no_ref_overlap &&
                 deviation_l < -limits.max_sv_size && read_no_gap,
             pair_valid, 5, rev_cur ? rs_cur : wrap_sub(re_cur, 1),
             rev_cur ? wrap_sub(re_nxt, 1) : rs_nxt, rev_cur ? 3 : 0);

    // reference overlap: tandem duplication evidence
    const bool overlap_branch = colinear && read_no_overlap &&
                                !no_ref_overlap &&
                                d_ref_l <= -limits.min_sv_size;
    const bool tan_near = rev_cur ? rs_nxt < re_cur : re_nxt > rs_cur;
    const bool tan_far = !tan_near && d_ref_l >= -limits.max_sv_size;
    const int32_t tan_start = rev_cur ? rs_cur : rs_nxt;
    const int32_t tan_end = rev_cur ? re_nxt : re_cur;
    const int32_t tan_fwd_bit = rev_cur ? 0 : 2;
    const bool tan_mask1 = pair.set(overlap_branch && tan_near, pair_valid, 4,
                                    tan_start, tan_end, 1 + tan_fwd_bit);
    const bool tan_mask2 = pair.set(overlap_branch && tan_far, pair_valid, 4,
                                    tan_start, tan_end, tan_fwd_bit);
    const int32_t tan_twin_p1 = rev_cur ? rs_cur : wrap_sub(re_cur, 1);
    const int32_t tan_twin_p2 = rev_cur ? wrap_sub(re_nxt, 1) : rs_nxt;
    const int32_t tan_twin_aux = rev_cur ? 3 : 0;
    pair.set_twin(tan_mask1 || tan_mask2, tan_twin_p1, tan_twin_p2,
                  tan_twin_aux);
    pair.set(overlap_branch && !tan_near && !tan_far, pair_valid, 5,
             tan_twin_p1, tan_twin_p2, tan_twin_aux);

    // same contig, opposite orientations
    const bool inverted = same_ref && !same_orient && read_window;
    const bool fwd_rev = inverted && !rev_cur;
    const bool rev_fwd = inverted && rev_cur;
    const bool case_near = static_cast<long long>(wrap_sub(rs_nxt, re_cur)) >=
                           -limits.overlap_tolerance;
    const bool case_far =
        !case_near && static_cast<long long>(wrap_sub(rs_cur, re_nxt)) >=
                          -limits.overlap_tolerance;
    const int32_t span =
        fwd_rev ? (case_near ? wrap_sub(re_nxt, re_cur)
                             : wrap_sub(re_cur, re_nxt))
                : (case_near ? wrap_sub(rs_nxt, rs_cur)
                             : wrap_sub(rs_cur, rs_nxt));
    const long long span_l = span;
    const bool inv_case = (fwd_rev || rev_fwd) && (case_near || case_far);
    const int32_t inv_dir = fwd_rev ? (case_near ? 0 : 1) : (case_near ? 2 : 3);
    const int32_t inv_start = fwd_rev ? (case_near ? re_cur : re_nxt)
                                      : (case_near ? rs_cur : rs_nxt);
    const int32_t inv_twin_p1 = fwd_rev ? wrap_sub(re_cur, 1) : rs_cur;
    const int32_t inv_twin_p2 = fwd_rev ? wrap_sub(re_nxt, 1) : rs_nxt;
    const int32_t inv_twin_aux = fwd_rev ? 2 : 1;
    const bool inv_mask =
        pair.set(inv_case && span_l >= limits.min_sv_size &&
                     span_l <= limits.max_sv_size,
                 pair_valid, 3, inv_start, wrap_add(inv_start, span), inv_dir);
    pair.set_twin(inv_mask, inv_twin_p1, inv_twin_p2, inv_twin_aux);
    pair.set(inv_case && span_l > limits.max_sv_size, pair_valid, 5,
             inv_twin_p1, inv_twin_p2, inv_twin_aux);

    // different contigs
    const int32_t cross_p2 =
        same_orient ? (rev_cur ? wrap_sub(re_nxt, 1) : rs_nxt)
                    : (rev_cur ? rs_nxt : wrap_sub(re_nxt, 1));
    const int32_t cross_aux =
        same_orient ? (rev_cur ? 3 : 0) : (rev_cur ? 1 : 2);
    const bool cross_mask =
        pair.set(!same_ref && read_window, pair_valid, 5,
                 rev_cur ? rs_cur : wrap_sub(re_cur, 1), cross_p2, cross_aux);
    if (cross_mask || pair.code == 5) contig2 = sorted.ref_id[n];

    code_out[out + p] = pair.code;
    p1_out[out + p] = pair.p1;
    p2_out[out + p] = pair.p2;
    aux_out[out + p] = pair.aux;
    contig2_out[out + p] = contig2;
    qpos_out[out + p] = qpos;
    twin_mask_out[out + p] = pair.twin;
    twin_p1_out[out + p] = pair.twin_p1;
    twin_p2_out[out + p] = pair.twin_p2;
    twin_aux_out[out + p] = pair.twin_aux;
    reverse_out[out + p] = rev_cur;
    ref_id_out[out + p] = sorted.ref_id[p];
  }
}

int threads_for(int s) {
  const int rounded = (s + 31) / 32 * 32;
  return rounded < kMaxThreads ? rounded : kMaxThreads;
}

}  // namespace

extern "C" {

// The largest S whose two copies of a group fit a CTA's shared memory.
int classify_max_slots() {
  int device = 0, limit = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  int s = limit / 44;
  while (s > 0 && 2 * slots_bytes(s) > static_cast<size_t>(limit)) --s;
  return s;
}

// Inputs: slot_row, q_start_h, q_end_h, ref_id_h, ref_start_h, ref_end_h
// (groups, s) int32, is_reverse_h and valid (groups, s) bytes,
// hard_gate_row (groups,) int32, ref_id_all, ref_start_all (rows,) int32,
// is_reverse_all (rows,) bytes, ref_end, read_len, qa_start, qa_end
// (rows,) int32, has_hard_clip (rows,) bytes, then the scalars; outputs
// the twelve (groups, s - 1) columns in the order of the file's header
// (int32, except twin_mask and the strand: bytes), written in full.  One
// launch on `stream` (none when groups == 0 or s < 2); returns the CUDA
// error code of the set-up or of the launch (0 on success).
int classify_segments(const void* slot_row, const void* q_start_h,
                      const void* q_end_h, const void* ref_id_h,
                      const void* ref_start_h, const void* ref_end_h,
                      const void* is_reverse_h, const void* valid,
                      const void* hard_gate_row, const void* ref_id_all,
                      const void* ref_start_all, const void* is_reverse_all,
                      const void* ref_end, const void* read_len,
                      const void* qa_start, const void* qa_end,
                      const void* has_hard_clip, int groups, int s,
                      int max_segments, long long min_sv_size,
                      long long max_sv_size, long long gap_tolerance,
                      long long overlap_tolerance, void* code, void* p1,
                      void* p2, void* aux, void* contig2, void* qpos,
                      void* twin_mask, void* twin_p1, void* twin_p2,
                      void* twin_aux, void* reverse_out, void* ref_id_out,
                      void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is ours
  if (groups <= 0 || s < 2) return 0;
  const size_t shared = 2 * slots_bytes(s);
  if (shared > 48 * 1024) {
    const cudaError_t error = cudaFuncSetAttribute(
        classify_groups, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (error != cudaSuccess) return static_cast<int>(error);
  }
  const Thresholds limits{min_sv_size, max_sv_size, gap_tolerance,
                          overlap_tolerance};
  classify_groups<<<groups, threads_for(s), shared,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slot_row),
      static_cast<const int32_t*>(q_start_h),
      static_cast<const int32_t*>(q_end_h),
      static_cast<const int32_t*>(ref_id_h),
      static_cast<const int32_t*>(ref_start_h),
      static_cast<const int32_t*>(ref_end_h),
      static_cast<const uint8_t*>(is_reverse_h),
      static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(hard_gate_row),
      static_cast<const int32_t*>(ref_id_all),
      static_cast<const int32_t*>(ref_start_all),
      static_cast<const uint8_t*>(is_reverse_all),
      static_cast<const int32_t*>(ref_end),
      static_cast<const int32_t*>(read_len),
      static_cast<const int32_t*>(qa_start),
      static_cast<const int32_t*>(qa_end),
      static_cast<const uint8_t*>(has_hard_clip), s, max_segments, limits,
      static_cast<int32_t*>(code), static_cast<int32_t*>(p1),
      static_cast<int32_t*>(p2), static_cast<int32_t*>(aux),
      static_cast<int32_t*>(contig2), static_cast<int32_t*>(qpos),
      static_cast<uint8_t*>(twin_mask), static_cast<int32_t*>(twin_p1),
      static_cast<int32_t*>(twin_p2), static_cast<int32_t*>(twin_aux),
      static_cast<uint8_t*>(reverse_out), static_cast<int32_t*>(ref_id_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
