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
// Design, by slot count.  At S <= 32 (the main path's: the dispatcher pads
// S to a power of two, 2 on the bench batch) a warp takes 32 / S groups, a
// lane a slot in segments of S lanes: each lane gathers its slot, the rank
// sort is S shuffles of the keys within the segment, the lane at sorted
// place i finds the slot of rank i by S more, one shuffle hands each pair
// its next segment, and a lane a pair runs the chain.  No shared memory and
// no barrier: the bench batch (G = 256, S = 2) is 16 warps in two CTAs,
// where a CTA a group ran 256 CTAs of which each used 2 of its 32 lanes.
// Above 32 slots one CTA takes a group, a thread a slot (up to 1024
// threads, each taking every 1024th slot above that), the group's slots in
// shared memory twice (as gathered, then in sorted order), then a thread a
// pair.  What bounds it on this card: nothing large moves (a group is S
// slots of ~24 bytes in and S-1 pairs of ~38 bytes out), so at the main
// path's G and S it is one short launch, bound by launching it and by its
// chains of dependent loads (slot_row, then the row's COLLECT outputs; the
// gate row, then its hard-clip flag): both routes issue the two chains side
// by side, and read a slot's host columns beside its slot_row.  The rank
// sort is S^2 compares a group, which only matters for the rare reads with
// hundreds of segments.  See PERF.md for its time against the bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kWarpRouteThreads = 256;  // a CTA of the warp route
constexpr int kWarpRouteSlots = 32;     // the warp route up to here
constexpr int32_t kIntMax = 2147483647;

struct Thresholds {
  long long min_sv_size, max_sv_size, gap_tolerance, overlap_tolerance;
};

// the kernels' inputs and outputs (see the C entry point)
struct Columns {
  const int32_t *slot_row, *q_start_h, *q_end_h, *ref_id_h, *ref_start_h,
      *ref_end_h;
  const uint8_t *is_reverse_h, *valid_h;
  const int32_t *hard_gate_row, *ref_id_all, *ref_start_all;
  const uint8_t* is_reverse_all;
  const int32_t *ref_end_dev, *read_len_dev, *qa_start_dev, *qa_end_dev;
  const uint8_t* has_hard_dev;
  int s, max_segments;
  Thresholds limits;
  int32_t *code, *p1, *p2, *aux, *contig2, *qpos;
  uint8_t* twin_mask;
  int32_t *twin_p1, *twin_p2, *twin_aux;
  uint8_t* reverse_out;
  int32_t* ref_id_out;
};

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

struct Slot {
  int32_t q_start = 0, q_end = 0, ref_id = 0, ref_start = 0, ref_end = 0;
  bool reverse = false, valid = false;
};

// slot `index` of the (G, S) columns: from its packed row's COLLECT outputs
// when it has one, else from the host columns.  The host columns are read
// beside slot_row whatever it holds, so that a slot waits for two loads in
// a row at most.
__device__ Slot gather(const Columns& c, size_t index) {
  const int32_t row = c.slot_row[index];
  Slot slot;
  slot.q_start = c.q_start_h[index];
  slot.q_end = c.q_end_h[index];
  slot.ref_id = c.ref_id_h[index];
  slot.ref_start = c.ref_start_h[index];
  slot.ref_end = c.ref_end_h[index];
  slot.reverse = c.is_reverse_h[index] != 0;
  slot.valid = c.valid_h[index] != 0;
  if (row >= 0) {
    const bool reverse = c.is_reverse_all[row] != 0;
    const int32_t read_len = c.read_len_dev[row];
    const int32_t qa_start = c.qa_start_dev[row];
    const int32_t qa_end = c.qa_end_dev[row];
    slot.q_start = reverse ? wrap_sub(read_len, qa_end) : qa_start;
    slot.q_end = reverse ? wrap_sub(read_len, qa_start) : qa_end;
    slot.ref_id = c.ref_id_all[row];
    slot.ref_start = c.ref_start_all[row];
    slot.ref_end = c.ref_end_dev[row];
    slot.reverse = reverse;
  }
  return slot;
}

// whether slot (start, end, index) sorts after (other_start, other_end,
// other_index): the keys of invalid slots are INT32_MAX in both
__device__ __forceinline__ bool sorts_after(int32_t start, int32_t end,
                                            int index, int32_t other_start,
                                            int32_t other_end,
                                            int other_index) {
  return other_start < start ||
         (other_start == start &&
          (other_end < end || (other_end == end && other_index < index)));
}

// whether group `group`'s hard-clip gate row lets its pairs through
__device__ __forceinline__ bool gate_open(const Columns& c, size_t group) {
  const int32_t gate = c.hard_gate_row[group];
  return gate < 0 || c.has_hard_dev[gate] == 0;
}

// The group's slots in shared memory (the CTA route): five int32 columns
// and two byte columns of S entries each, the whole rounded up to 16 bytes
// so that the second copy starts aligned.
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

  __device__ void put(int i, const Slot& slot) {
    q_start[i] = slot.q_start;
    q_end[i] = slot.q_end;
    ref_id[i] = slot.ref_id;
    ref_start[i] = slot.ref_start;
    ref_end[i] = slot.ref_end;
    reverse[i] = slot.reverse;
    valid[i] = slot.valid;
  }

  __device__ Slot get(int i) const {
    Slot slot;
    slot.q_start = q_start[i];
    slot.q_end = q_end[i];
    slot.ref_id = ref_id[i];
    slot.ref_start = ref_start[i];
    slot.ref_end = ref_end[i];
    slot.reverse = reverse[i] != 0;
    slot.valid = valid[i] != 0;
    return slot;
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

// The reference's chain of masked selects for one adjacent pair of sorted
// segments (cur, nxt), written to output entry `out`.
__device__ void classify_pair(const Columns& c, const Slot& cur,
                              const Slot& nxt, bool pair_valid, size_t out) {
  const Thresholds& limits = c.limits;
  const int32_t d_read = wrap_sub(nxt.q_start, cur.q_end);
  const bool same_ref = cur.ref_id == nxt.ref_id;
  const bool rev_cur = cur.reverse;
  const bool same_orient = rev_cur == nxt.reverse;
  const int32_t rs_cur = cur.ref_start, re_cur = cur.ref_end;
  const int32_t rs_nxt = nxt.ref_start, re_nxt = nxt.ref_end;
  const int32_t d_ref =
      rev_cur ? wrap_sub(rs_cur, re_nxt) : wrap_sub(rs_nxt, re_cur);
  const int32_t deviation = wrap_sub(d_read, d_ref);
  const long long d_read_l = d_read, d_ref_l = d_ref, deviation_l = deviation;

  const bool read_no_overlap = d_read_l >= -limits.overlap_tolerance;
  const bool read_no_gap = d_read_l <= limits.gap_tolerance;
  const bool read_window = read_no_overlap && read_no_gap;
  Pair pair;
  int32_t contig2 = cur.ref_id;
  const int32_t qpos = rev_cur ? nxt.q_start : cur.q_end;

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
  const bool overlap_branch = colinear && read_no_overlap && !no_ref_overlap &&
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
  const int32_t cross_aux = same_orient ? (rev_cur ? 3 : 0) : (rev_cur ? 1 : 2);
  const bool cross_mask =
      pair.set(!same_ref && read_window, pair_valid, 5,
               rev_cur ? rs_cur : wrap_sub(re_cur, 1), cross_p2, cross_aux);
  if (cross_mask || pair.code == 5) contig2 = nxt.ref_id;

  c.code[out] = pair.code;
  c.p1[out] = pair.p1;
  c.p2[out] = pair.p2;
  c.aux[out] = pair.aux;
  c.contig2[out] = contig2;
  c.qpos[out] = qpos;
  c.twin_mask[out] = pair.twin;
  c.twin_p1[out] = pair.twin_p1;
  c.twin_p2[out] = pair.twin_p2;
  c.twin_aux[out] = pair.twin_aux;
  c.reverse_out[out] = rev_cur;
  c.ref_id_out[out] = cur.ref_id;
}

// The CTA route (S > 32): one CTA a group.
__global__ void classify_groups(const Columns c) {
  extern __shared__ __align__(16) char shared[];
  const int s = c.s;
  Slots gathered(shared, s);
  Slots sorted(shared + slots_bytes(s), s);
  const size_t group = blockIdx.x;
  const size_t in = group * s;
  // 3. (read first: it waits on no slot) the hard-clip gate
  const bool enabled = gate_open(c, group);

  // 1. gather
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    gathered.put(i, gather(c, in + i));
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
      rank += sorts_after(start, end, i,
                          other_valid ? gathered.q_start[j] : kIntMax,
                          other_valid ? gathered.q_end[j] : kIntMax, j);
    }
    sorted.put(rank, gathered.get(i));
  }
  __syncthreads();

  // 3. truncation and the gate; 4. a thread a pair
  const size_t out = group * (s - 1);
  for (int p = threadIdx.x; p < s - 1; p += blockDim.x) {
    const Slot cur = sorted.get(p), nxt = sorted.get(p + 1);
    classify_pair(c, cur, nxt,
                  enabled && cur.valid && nxt.valid && p + 1 < c.max_segments,
                  out + p);
  }
}

// `slot` as lane `from` holds it
__device__ __forceinline__ Slot shuffle(const Slot& slot, int from) {
  Slot got;
  got.q_start = __shfl_sync(kFull, slot.q_start, from);
  got.q_end = __shfl_sync(kFull, slot.q_end, from);
  got.ref_id = __shfl_sync(kFull, slot.ref_id, from);
  got.ref_start = __shfl_sync(kFull, slot.ref_start, from);
  got.ref_end = __shfl_sync(kFull, slot.ref_end, from);
  const int flags = __shfl_sync(kFull, slot.reverse | slot.valid << 1, from);
  got.reverse = flags & 1;
  got.valid = flags >> 1;
  return got;
}

// The warp route (S <= 32): 32 / S groups a warp, a lane a slot.  Every
// lane of the warp runs every shuffle; the lanes past the last whole
// segment and those of groups past G hold invalid slots and write nothing.
__global__ void __launch_bounds__(kWarpRouteThreads)
    classify_groups_warp(const Columns c, long long groups) {
  const int s = c.s;
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / s;
  const int segment = lane / s;
  const int slot = lane - segment * s;
  const int first_lane = segment * s;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long group = warp * per_warp + segment;
  const bool active = segment < per_warp && group < groups;
  // the gate and the slot, each at most two loads in a row, side by side
  const bool enabled = active && gate_open(c, group);
  const Slot mine =
      active ? gather(c, static_cast<size_t>(group) * s + slot) : Slot();

  // the rank sort within the segment
  const int32_t start = mine.valid ? mine.q_start : kIntMax;
  const int32_t end = mine.valid ? mine.q_end : kIntMax;
  int rank = 0;
  for (int j = 0; j < s; ++j) {
    const int32_t other_start = __shfl_sync(kFull, start, first_lane + j);
    const int32_t other_end = __shfl_sync(kFull, end, first_lane + j);
    rank += sorts_after(start, end, slot, other_start, other_end, j);
  }
  // this lane's sorted place is `slot`: take the slot whose rank it is
  int source = 0;
  for (int j = 0; j < s; ++j) {
    if (__shfl_sync(kFull, rank, first_lane + j) == slot) source = j;
  }
  const Slot cur = shuffle(mine, first_lane + source);
  const Slot nxt = shuffle(cur, lane + 1);  // the next sorted segment
  if (active && slot < s - 1) {
    classify_pair(c, cur, nxt,
                  enabled && cur.valid && nxt.valid &&
                      slot + 1 < c.max_segments,
                  static_cast<size_t>(group) * (s - 1) + slot);
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
// launch on `stream` (none when groups == 0 or s < 2): the warp route at
// s <= 32, else the CTA route; returns the CUDA error code of the set-up or
// of the launch (0 on success).
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
  Columns c;
  c.slot_row = static_cast<const int32_t*>(slot_row);
  c.q_start_h = static_cast<const int32_t*>(q_start_h);
  c.q_end_h = static_cast<const int32_t*>(q_end_h);
  c.ref_id_h = static_cast<const int32_t*>(ref_id_h);
  c.ref_start_h = static_cast<const int32_t*>(ref_start_h);
  c.ref_end_h = static_cast<const int32_t*>(ref_end_h);
  c.is_reverse_h = static_cast<const uint8_t*>(is_reverse_h);
  c.valid_h = static_cast<const uint8_t*>(valid);
  c.hard_gate_row = static_cast<const int32_t*>(hard_gate_row);
  c.ref_id_all = static_cast<const int32_t*>(ref_id_all);
  c.ref_start_all = static_cast<const int32_t*>(ref_start_all);
  c.is_reverse_all = static_cast<const uint8_t*>(is_reverse_all);
  c.ref_end_dev = static_cast<const int32_t*>(ref_end);
  c.read_len_dev = static_cast<const int32_t*>(read_len);
  c.qa_start_dev = static_cast<const int32_t*>(qa_start);
  c.qa_end_dev = static_cast<const int32_t*>(qa_end);
  c.has_hard_dev = static_cast<const uint8_t*>(has_hard_clip);
  c.s = s;
  c.max_segments = max_segments;
  c.limits = Thresholds{min_sv_size, max_sv_size, gap_tolerance,
                        overlap_tolerance};
  c.code = static_cast<int32_t*>(code);
  c.p1 = static_cast<int32_t*>(p1);
  c.p2 = static_cast<int32_t*>(p2);
  c.aux = static_cast<int32_t*>(aux);
  c.contig2 = static_cast<int32_t*>(contig2);
  c.qpos = static_cast<int32_t*>(qpos);
  c.twin_mask = static_cast<uint8_t*>(twin_mask);
  c.twin_p1 = static_cast<int32_t*>(twin_p1);
  c.twin_p2 = static_cast<int32_t*>(twin_p2);
  c.twin_aux = static_cast<int32_t*>(twin_aux);
  c.reverse_out = static_cast<uint8_t*>(reverse_out);
  c.ref_id_out = static_cast<int32_t*>(ref_id_out);
  const cudaStream_t on = static_cast<cudaStream_t>(stream);
  if (s <= kWarpRouteSlots) {
    const long long warps = (groups + 32 / s - 1) / (32 / s);
    const long long blocks =
        (warps * 32 + kWarpRouteThreads - 1) / kWarpRouteThreads;
    classify_groups_warp<<<static_cast<unsigned>(blocks), kWarpRouteThreads,
                           0, on>>>(c, groups);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t shared = 2 * slots_bytes(s);
  if (shared > 48 * 1024) {
    const cudaError_t error = cudaFuncSetAttribute(
        classify_groups, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (error != cudaSuccess) return static_cast<int>(error);
  }
  classify_groups<<<groups, threads_for(s), shared, on>>>(c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
