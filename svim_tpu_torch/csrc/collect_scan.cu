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
// Sums wrap as the reference's int32 sums do: they are taken in uint32, so
// the order in which a block adds them does not change a bit.  A padding
// word 0 (op 0 of length 0) adds nothing, is clip-like and is no event.
//
// What bounds it on this card: the words (4NK bytes) are the only large
// input, so the function is bound by device memory; at the main path's
// batch (N = 4096, K = 32: 512 KiB) that is a fraction of a microsecond,
// and what costs is launching, draining and the chain of dependent loads
// and barriers between them.  The design is one launch: a persistent
// grid, launched cooperatively, of one 1024-thread CTA a SM (as many as
// are co-resident, at most one a row), each CTA a contiguous block of
// rows, in two phases around one grid barrier.
//   A. A team takes a row, sized so that a thread's run is at most 32 ops
//      up to K = 8192: a warp up to K = 1024 (32 rows at once in a CTA),
//      128 threads up to 4096 and 256 above (8 and 4 rows at once, named
//      barriers); each kernel of the three is built for one team size.
//      Warps read words that the CTA first copied into shared memory (its
//      first rows, up to kStageBytes, about 26 MB over the H100's 132 SMs,
//      kept for phase B; the rows past them from device memory).  A wider
//      team first copies its row into a buffer of its own (up to K =
//      11,377; longer rows are read from device memory).  Copies are
//      coalesced 16-byte loads, four in flight a thread, into places padded
//      by 16 bytes after every 128 so that the runs below read them without
//      bank conflicts.  Each thread of the team sums a run of consecutive
//      ops; team reductions combine the runs, the first and last non-clip
//      op are a min and a max over them,
//      and the soft clips before (after) them are those of the runs before
//      (after) the run that holds it plus those in that run before (after)
//      it.  The team writes the row's geometry.  The CTA then scans its
//      first 1024 rows' event counts into places relative to its own first
//      one (kept in shared memory across the barrier; the counts of later
//      rows go to scratch) and stores its total in a grid-sized scratch:
//      every slot is written before the barrier, so nothing needs clearing.
//   B. After the barrier a warp adds up the totals of the CTAs before this
//      one (its first place in the table) and all of them (the count); the
//      CTAs share the fill after the count, and CTA 0 stores the count.
//      Each team writes its rows' events at the row's place plus the events
//      before them in the row (a team scan of the runs' advances and event
//      counts, then each thread walks its run), from the staged words (with
//      K = 32 every row is staged up to 1,422 rows a CTA, N = 187,704 on
//      132 SMs) or read again from device memory (L2 where it still holds
//      them), wider teams through their buffers again.
// No atomic decides where an event goes, and every run gives the same
// table.  A cooperative launch the card refuses returns its error code.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarpK = 1024;            // a warp a row up to here,
constexpr int kMidK = 4096;             // 128 threads up to here, 256 above
constexpr int kStageBytes = 200 * 1024;  // dynamic shared memory a CTA
constexpr int kMaxCtas = 1024;          // CTA totals the scratch holds
constexpr int kMaxDevices = 64;
constexpr uint32_t kNoEvents = 0xffffffffu;  // a row with nothing to write

struct Params {
  const int32_t* words;
  const int32_t* ref_start;
  int n, k, min_sv_size, max_events;
  int stage_words;  // words of dynamic shared memory a CTA has, padding in
  int buffer_words;  // padded words of a team's row buffer, or 0: teams
                     // wider than a warp read their runs from device memory
  int32_t *ref_end, *read_len, *qa_start, *qa_end;
  bool* has_hard_clip;
  int32_t *rows, *pos_ref, *pos_read, *lengths;
  bool* is_insertion;
  int32_t* count;
  int32_t* row_events;   // (n,) the event counts of rows past a CTA's first
                         // 1024
  uint32_t* cta_totals;  // (gridDim.x,) each CTA's event count
};

// what one word adds to a row
struct Word {
  uint32_t ref;           // reference end (M, D, N, =, X, 9)
  uint32_t ref_advance;   // events' reference offsets (op 3 not counted)
  uint32_t query;         // query length and events' read offsets
  uint32_t hard, soft;
  int len;
  bool hard_clip, nonclip, event, insertion;
};

// the ops that advance the events' reference offsets (M, D, =, X, 9), the
// geometry's reference end (those and N) and the query (M, I, S, =, X, 10),
// as bit sets over the op code
constexpr unsigned kRefAdvanceOps = 1u << 0 | 1u << 2 | 1u << 7 | 1u << 8 |
                                    1u << 9;
constexpr unsigned kRefOps = kRefAdvanceOps | 1u << 3;
constexpr unsigned kQueryOps = 1u << 0 | 1u << 1 | 1u << 4 | 1u << 7 |
                               1u << 8 | 1u << 10;

__device__ __forceinline__ Word decode(int32_t word, int min_sv_size) {
  const int op = word & 0xF;
  const int len = word >> 4;  // arithmetic shift, as jnp's
  const uint32_t ulen = static_cast<uint32_t>(len);
  const unsigned bit = 1u << op;
  const bool soft = op == 4 && len > 0;
  Word w;
  w.ref_advance = bit & kRefAdvanceOps ? ulen : 0u;
  w.ref = bit & kRefOps ? ulen : 0u;
  w.query = bit & kQueryOps ? ulen : 0u;
  w.hard_clip = op == 5 && len > 0;
  w.hard = w.hard_clip ? ulen : 0u;
  w.soft = soft ? ulen : 0u;
  w.len = len;
  w.nonclip = !(soft || op == 5 || len == 0);
  w.event = (op == 1 || op == 2) && len >= min_sv_size;
  w.insertion = op == 1;
  return w;
}

// Staged word i of a CTA sits at padded(i): 4 words of padding after every
// 32, so that the 16-byte reads of runs 16, 32, 64 or 128 bytes apart fall in
// different banks.
__device__ __forceinline__ int padded(int i) { return i + ((i >> 5) << 2); }

__device__ __forceinline__ uint32_t warp_inclusive_sum(uint32_t value,
                                                       int lane) {
#pragma unroll
  for (int delta = 1; delta < 32; delta <<= 1) {
    const uint32_t other = __shfl_up_sync(kFull, value, delta);
    if (lane >= delta) value += other;
  }
  return value;
}

// scratch of the team collectives; `offsets` and `counts` hold the chunk of
// up to 1024 rows whose places are being worked out
struct Shared {
  uint32_t part[8][kThreads / 32];
  uint32_t whole[8][kThreads / 32];
  uint32_t offsets[kThreads];  // a row's place relative to the chunk's
  uint32_t counts[kThreads];   // the CTA's first rows' event counts
};

// kSize consecutive threads of the CTA that work on one row: a warp, 256
// threads (named barrier 1 + id) or the whole CTA (barrier 0)
template <int kSize>
struct Team {
  static constexpr int kWarps = kSize / 32;
  int id, rank, lane, warp, first_warp;

  __device__ Team()
      : id(threadIdx.x / kSize),
        rank(threadIdx.x % kSize),
        lane(threadIdx.x & 31),
        warp(threadIdx.x >> 5),
        first_warp(threadIdx.x / kSize * kWarps) {}

  __device__ void sync() const {
    if constexpr (kSize == 32) {
      __syncwarp();
    } else if constexpr (kSize == kThreads) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + id), "n"(kSize) : "memory");
    }
  }
};

enum Combine { kAdd, kMin, kMax };

__device__ __forceinline__ uint32_t warp_combine(Combine how, uint32_t v) {
  return how == kAdd   ? __reduce_add_sync(kFull, v)
         : how == kMin ? __reduce_min_sync(kFull, v)
                       : __reduce_max_sync(kFull, v);
}

// N values a thread -> their combination over the team, in `values`.  A
// team wider than a warp writes its warps' parts, waits, lets its first
// warp combine them into `whole`, and waits again, so that a collective
// called right after another never overwrites what a slow warp still
// reads; teams use disjoint columns of both arrays.
template <int kSize, int N>
__device__ void team_reduce(Shared& shared, const Team<kSize>& team,
                            uint32_t (&values)[N], const Combine (&how)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) values[i] = warp_combine(how[i], values[i]);
  if constexpr (kSize > 32) {
    if (team.lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) shared.part[i][team.warp] = values[i];
    }
    team.sync();
    if (team.warp == team.first_warp) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const uint32_t identity = how[i] == kMin ? 0xffffffffu : 0u;
        const uint32_t p = team.lane < Team<kSize>::kWarps
                               ? shared.part[i][team.first_warp + team.lane]
                               : identity;
        const uint32_t v = warp_combine(how[i], p);
        if (team.lane == 0) shared.whole[i][team.first_warp] = v;
      }
    }
    team.sync();
#pragma unroll
    for (int i = 0; i < N; ++i) values[i] = shared.whole[i][team.first_warp];
  }
}

// N values a thread -> their exclusive prefix sums over the team in thread
// order, in `values`; the team's sums in `totals`
template <int kSize, int N>
__device__ void team_exclusive_scan(Shared& shared, const Team<kSize>& team,
                                    uint32_t (&values)[N],
                                    uint32_t (&totals)[N]) {
  uint32_t inclusive[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    inclusive[i] = warp_inclusive_sum(values[i], team.lane);
  }
  if constexpr (kSize == 32) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      totals[i] = __shfl_sync(kFull, inclusive[i], 31);
      values[i] = inclusive[i] - values[i];
    }
  } else {
    if (team.lane == 31) {
#pragma unroll
      for (int i = 0; i < N; ++i) shared.part[i][team.warp] = inclusive[i];
    }
    team.sync();
    if (team.warp == team.first_warp) {
      const bool mine = team.lane < Team<kSize>::kWarps;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const uint32_t p =
            mine ? shared.part[i][team.first_warp + team.lane] : 0u;
        const uint32_t scanned = warp_inclusive_sum(p, team.lane);
        if (mine) shared.whole[i][team.first_warp + team.lane] = scanned - p;
        if (team.lane == Team<kSize>::kWarps - 1) {
          shared.whole[i + N][team.first_warp] = scanned;
        }
      }
    }
    team.sync();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      values[i] = shared.whole[i][team.warp] + inclusive[i] - values[i];
      totals[i] = shared.whole[i + N][team.first_warp];
    }
  }
}

// Copies `count` words from device memory into shared memory at their
// padded places, `size` threads (of rank 0 .. size - 1) sharing the work,
// with four 16-byte loads in flight a thread before their stores.
__device__ __forceinline__ void copy_words(const int32_t* from, int count,
                                           int32_t* to, bool aligned,
                                           int rank, int size) {
  int scalar_from = 0;
  if (aligned) {
    const int4* from4 = reinterpret_cast<const int4*>(from);
    int4* to4 = reinterpret_cast<int4*>(to);
    const int fours = count / 4;
    for (int q = rank; q < fours; q += 4 * size) {
      int4 got[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int at = q + u * size;
        if (at < fours) got[u] = __ldg(from4 + at);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int at = q + u * size;
        if (at < fours) to4[at + (at >> 3)] = got[u];
      }
    }
    scalar_from = fours * 4;
  }
  for (int i = scalar_from + rank; i < count; i += size) {
    to[padded(i)] = __ldg(from + i);
  }
}

// The CTA's block of rows and where their words are: warps stage the
// block's first rows for both phases; wider teams copy each row into a
// buffer of their own when it is taken.
struct Block {
  int first_row, end_row, staged_rows;
  int32_t* stage;  // the staged words, or the teams' buffers; padded
  bool aligned;    // 16-byte loads of whole rows and runs are possible

  __device__ Block(const Params& p, int32_t* dynamic, bool stages) {
    first_row = static_cast<int>(static_cast<long long>(blockIdx.x) * p.n /
                                 gridDim.x);
    end_row = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * p.n /
                               gridDim.x);
    // words the padded stage holds: 32 of every 36
    const int capacity = p.stage_words / 36 * 32;
    staged_rows = p.k == 0 || !stages
                      ? 0
                      : min(end_row - first_row, capacity / p.k);
    stage = dynamic;
    aligned = (p.k & 3) == 0 &&
              (reinterpret_cast<uintptr_t>(p.words) & 15) == 0;
  }
};

// where a row's words are read: shared memory (padded, from word `base`)
// or device memory
struct RowSource {
  const int32_t* stage;  // the row's words in shared memory, or nullptr
  int base;
  const int32_t* global;
};

// The source of `row` for `team`: the stage when the row is staged; else
// the team's buffer, into which the team copies the row first; else device
// memory.
template <int kSize>
__device__ RowSource row_source(const Params& p, const Block& block,
                                const Team<kSize>& team, int row) {
  const int local = row - block.first_row;
  const int32_t* global = p.words + static_cast<size_t>(row) * p.k;
  if (local < block.staged_rows) return {block.stage, local * p.k, global};
  if (kSize == 32 || p.buffer_words == 0) return {nullptr, 0, global};
  int32_t* buffer = block.stage + team.id * p.buffer_words;
  team.sync();  // the team's reads of its previous row are done
  copy_words(global, p.k, buffer, block.aligned, team.rank, kSize);
  team.sync();
  return {buffer, 0, global};
}

// Calls visit(j, word) for the words [begin, end) of a row, in order.  The
// visitors below are structs with inlined calls, so that their sums stay in
// registers.
template <typename Visitor>
__device__ __forceinline__ void for_each_word(const RowSource& source,
                                              bool aligned, int begin,
                                              int end, Visitor& visit) {
  if (aligned && ((end - begin) & 3) == 0) {
#pragma unroll 4
    for (int j = begin; j < end; j += 4) {
      const int4 four =
          source.stage
              ? *reinterpret_cast<const int4*>(source.stage +
                                               padded(source.base + j))
              : __ldg(reinterpret_cast<const int4*>(source.global + j));
      visit(j, four.x);
      visit(j + 1, four.y);
      visit(j + 2, four.z);
      visit(j + 3, four.w);
    }
  } else {
    for (int j = begin; j < end; ++j) {
      visit(j, source.stage ? source.stage[padded(source.base + j)]
                            : __ldg(source.global + j));
    }
  }
}

// a team thread's run of a row's ops: [begin, end)
template <int kSize>
struct Run {
  int length, begin, end;
  __device__ Run(int k, int rank) {
    length = (k + kSize - 1) / kSize;
    begin = min(k, rank * length);
    end = min(k, begin + length);
  }
};

// a run's sums for the geometry and the event count; `first` and `last`
// are its first and last non-clip op (`none` and -1 without one), the soft
// clips before the first and after the last are kept apart
struct RunCounts {
  int min_sv_size, none, first, last = -1;
  uint32_t ref = 0, query = 0, hard = 0, events = 0, any_hard = 0;
  uint32_t soft_total = 0, soft_before = 0, soft_after = 0;

  __device__ RunCounts(int min_sv_size, int none)
      : min_sv_size(min_sv_size), none(none), first(none) {}

  __device__ __forceinline__ void operator()(int j, int32_t word) {
    const Word w = decode(word, min_sv_size);
    ref += w.ref;
    query += w.query;
    hard += w.hard;
    any_hard |= w.hard_clip;
    events += w.event;
    soft_total += w.soft;
    if (first == none) soft_before += w.soft;
    if (w.nonclip) {
      if (first == none) first = j;
      last = j;
      soft_after = 0;
    } else {
      soft_after += w.soft;
    }
  }
};

// a run's reference and read advances and its event count
struct RunAdvances {
  int min_sv_size;
  uint32_t sums[3] = {0, 0, 0};  // reference, read, events

  __device__ __forceinline__ void operator()(int, int32_t word) {
    const Word w = decode(word, min_sv_size);
    sums[0] += w.ref_advance;
    sums[1] += w.query;
    sums[2] += w.event;
  }
};

// writes a run's events from table entry `at` on, the run starting at
// reference and read offsets `ref` and `read`
struct EventWriter {
  const Params& p;
  int row;
  uint32_t at, ref, read;

  __device__ __forceinline__ void operator()(int, int32_t word) {
    const Word w = decode(word, p.min_sv_size);
    if (w.event && at < static_cast<uint32_t>(p.max_events)) {
      p.rows[at] = row;
      p.pos_ref[at] = static_cast<int32_t>(ref);
      p.pos_read[at] = static_cast<int32_t>(read);
      p.lengths[at] = w.len;
      p.is_insertion[at] = w.insertion;
    }
    at += w.event;
    ref += w.ref_advance;
    read += w.query;
  }
};

// Phase A for one row: its geometry, written by the team's first thread;
// returns the row's event count (to every thread of the team).
template <int kSize>
__device__ uint32_t team_row_counts(const Params& p, Shared& shared,
                                    const Block& block,
                                    const Team<kSize>& team, int row) {
  const int32_t start = team.rank == 0 ? p.ref_start[row] : 0;
  const RowSource source = row_source(p, block, team, row);
  const Run<kSize> run(p.k, team.rank);
  const int none = p.k;
  RunCounts c(p.min_sv_size, none);
  for_each_word(source, block.aligned, run.begin, run.end, c);
  uint32_t sums[7] = {c.ref,      c.query, c.hard, c.events, c.any_hard,
                      static_cast<uint32_t>(c.first),
                      static_cast<uint32_t>(c.last + 1)};
  const Combine sums_by[7] = {kAdd, kAdd, kAdd, kAdd, kMax, kMin, kMax};
  team_reduce(shared, team, sums, sums_by);
  // the soft clips before the row's first non-clip op: every soft clip of
  // the runs before the one that holds it, and those before it in that run;
  // likewise after the last one (none trails a row without a non-clip op)
  const int row_first = static_cast<int>(sums[5]);
  const int row_last = static_cast<int>(sums[6]) - 1;
  const int first_run = row_first == none ? kSize : row_first / run.length;
  const int last_run = row_last < 0 ? kSize : row_last / run.length;
  uint32_t clips[2] = {team.rank < first_run    ? c.soft_total
                       : team.rank == first_run ? c.soft_before
                                                : 0u,
                       team.rank > last_run    ? c.soft_total
                       : team.rank == last_run ? c.soft_after
                                               : 0u};
  const Combine clips_by[2] = {kAdd, kAdd};
  team_reduce(shared, team, clips, clips_by);
  if (team.rank == 0) {
    p.ref_end[row] =
        static_cast<int32_t>(static_cast<uint32_t>(start) + sums[0]);
    p.read_len[row] = static_cast<int32_t>(sums[1] + sums[2]);
    p.qa_start[row] = static_cast<int32_t>(clips[0]);
    p.qa_end[row] = static_cast<int32_t>(sums[1] - clips[1]);
    p.has_hard_clip[row] = sums[4] != 0;
  }
  return sums[3];
}

// Phase B for one row: its events from `place` on.
template <int kSize>
__device__ void team_row_events(const Params& p, Shared& shared,
                                const Block& block, const Team<kSize>& team,
                                int row, uint32_t place) {
  const RowSource source = row_source(p, block, team, row);
  const Run<kSize> run(p.k, team.rank);
  RunAdvances advances{p.min_sv_size};
  for_each_word(source, block.aligned, run.begin, run.end, advances);
  const uint32_t own_events = advances.sums[2];
  uint32_t totals[3];
  team_exclusive_scan(shared, team, advances.sums, totals);
  EventWriter write{p, row, place + advances.sums[2], advances.sums[0],
                    advances.sums[1]};
  if (own_events == 0 || write.at >= static_cast<uint32_t>(p.max_events)) {
    return;
  }
  for_each_word(source, block.aligned, run.begin, run.end, write);
}

// Phase A: every row of the block, a team a row.  Keeps the first 1024
// rows' counts in shared memory and stores the later ones' in scratch;
// returns the events of those later rows this thread counted.
template <int kSize>
__device__ uint32_t count_rows(const Params& p, Shared& shared,
                               const Block& block) {
  const Team<kSize> team;
  uint32_t later = 0;
  for (int row = block.first_row + team.id; row < block.end_row;
       row += kThreads / kSize) {
    const uint32_t events = team_row_counts(p, shared, block, team, row);
    const int local = row - block.first_row;
    if (team.rank == 0) {
      if (local < kThreads) {
        shared.counts[local] = events;
      } else {
        p.row_events[row] = static_cast<int32_t>(events);
        later += events;
      }
    }
  }
  return later;
}

// Phase B: the events of the chunk's rows [chunk, chunk_end), a team a row,
// each at `carry` plus its place in shared.offsets.
template <int kSize>
__device__ void write_rows(const Params& p, Shared& shared,
                           const Block& block, int chunk, int chunk_end,
                           uint32_t carry) {
  const Team<kSize> team;
  for (int row = chunk + team.id; row < chunk_end; row += kThreads / kSize) {
    const uint32_t relative = shared.offsets[row - chunk];
    if (relative == kNoEvents) continue;  // team-uniform
    const uint32_t place = carry + relative;
    if (place >= static_cast<uint32_t>(p.max_events)) continue;
    team_row_events(p, shared, block, team, row, place);
  }
}

// The kernel for teams of kSize threads (team_size).
template <int kSize>
__global__ void __launch_bounds__(kThreads, 1)
    scan_and_compact(const Params p) {
  extern __shared__ __align__(16) int32_t dynamic_words[];
  __shared__ Shared shared;
  __shared__ uint32_t cta_base, all_events;
  const Team<kThreads> cta;
  const Block block(p, dynamic_words, kSize == 32);

  // phase A: the stage, then geometry and counts
  copy_words(p.words + static_cast<size_t>(block.first_row) * p.k,
             block.staged_rows * p.k, dynamic_words, block.aligned,
             threadIdx.x, kThreads);
  __syncthreads();
  const uint32_t later = count_rows<kSize>(p, shared, block);
  __syncthreads();
  // the first chunk's places relative to the CTA's first, and its total
  const int first_chunk = min(block.end_row - block.first_row, kThreads);
  const uint32_t own =
      static_cast<int>(threadIdx.x) < first_chunk ? shared.counts[threadIdx.x]
                                                  : 0u;
  uint32_t scanned[2] = {own, later}, totals[2];
  team_exclusive_scan(shared, cta, scanned, totals);
  shared.offsets[threadIdx.x] = own == 0 ? kNoEvents : scanned[0];
  if (threadIdx.x == 0) p.cta_totals[blockIdx.x] = totals[0] + totals[1];

  cg::this_grid().sync();

  // phase B: the CTA's first place, the count, the fill, the events
  if (cta.warp == 0) {
    uint32_t before = 0, all = 0;
    for (int b = cta.lane; b < static_cast<int>(gridDim.x); b += 32) {
      const uint32_t value = __ldcg(p.cta_totals + b);
      all += value;
      if (b < static_cast<int>(blockIdx.x)) before += value;
    }
    before = __reduce_add_sync(kFull, before);
    all = __reduce_add_sync(kFull, all);
    if (cta.lane == 0) {
      cta_base = before;
      all_events = all;
    }
  }
  __syncthreads();
  const uint32_t max_events = static_cast<uint32_t>(p.max_events);
  const uint32_t all = all_events;
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.count = static_cast<int32_t>(all);
  const uint32_t kept = all < max_events ? all : max_events;
  for (uint32_t i = kept + blockIdx.x * kThreads + threadIdx.x;
       i < max_events; i += gridDim.x * kThreads) {
    p.rows[i] = -1;
    p.pos_ref[i] = 0;
    p.pos_read[i] = 0;
    p.lengths[i] = 0;
    p.is_insertion[i] = false;
  }
  uint32_t carry = cta_base;
  uint32_t chunk_total = totals[0];
  for (int chunk = block.first_row; chunk < block.end_row && carry < max_events;
       chunk += kThreads) {
    const int chunk_end = min(block.end_row, chunk + kThreads);
    if (chunk != block.first_row) {  // the rows past the CTA's first 1024
      const int row = chunk + threadIdx.x;
      const uint32_t count =
          row < chunk_end ? static_cast<uint32_t>(__ldcg(p.row_events + row))
                          : 0u;
      uint32_t offset[1] = {count}, total[1];
      team_exclusive_scan(shared, cta, offset, total);
      shared.offsets[threadIdx.x] = count == 0 ? kNoEvents : offset[0];
      chunk_total = total[0];
      __syncthreads();
    }
    write_rows<kSize>(p, shared, block, chunk, chunk_end, carry);
    carry += chunk_total;
    __syncthreads();  // offsets are read before the next chunk writes them
  }
}

// threads a row: a run is at most 32 ops a thread up to K = 8192
__host__ __device__ constexpr int team_size(int k) {
  return k <= kWarpK ? 32 : k <= kMidK ? 128 : 256;
}

const void* const kKernels[] = {
    reinterpret_cast<const void*>(&scan_and_compact<32>),
    reinterpret_cast<const void*>(&scan_and_compact<128>),
    reinterpret_cast<const void*>(&scan_and_compact<256>)};

int multiprocessors[kMaxDevices];  // 0 until the device is set up

}  // namespace

extern "C" {

// int32 words of the scratch collect_scan takes for n rows: each row's
// event count, then each CTA's total.
int collect_scan_scratch_words(int n) { return n + kMaxCtas; }

// words (n, k) int32, ref_start (n,) int32; outputs ref_end, read_len,
// qa_start, qa_end (n,) int32 and has_hard_clip (n,) bytes; rows, pos_ref,
// pos_read, lengths (max_events,) int32 and is_insertion (max_events,)
// bytes; count, one int32; scratch collect_scan_scratch_words(n) int32,
// written before it is read.  Every output is written in full.  One
// cooperative launch on `stream` (none when n == 0); returns the CUDA error
// code of the set-up or of the launch (0 on success).
int collect_scan(const void* words, const void* ref_start, int n, int k,
                 int min_sv_size, int max_events, void* ref_end,
                 void* read_len, void* qa_start, void* qa_end,
                 void* has_hard_clip, void* rows, void* pos_ref,
                 void* pos_read, void* lengths, void* is_insertion,
                 void* count, void* scratch, void* stream) {
  cudaGetLastError();  // clear a stale error so the codes below are ours
  if (n <= 0) return 0;
  int device = 0;
  cudaError_t error = cudaGetDevice(&device);
  if (error != cudaSuccess) return static_cast<int>(error);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (multiprocessors[device] == 0) {
    int cooperative = 0, sms = 0;
    error = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch,
                                   device);
    if (error == cudaSuccess && !cooperative) {
      error = cudaErrorNotSupported;
    }
    if (error == cudaSuccess) {
      error = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    }
    for (const void* kernel : kKernels) {
      if (error == cudaSuccess) {
        error = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
      }
    }
    if (error != cudaSuccess) return static_cast<int>(error);
    multiprocessors[device] = sms;
  }
  const int sms = multiprocessors[device];
  const int team = team_size(k);
  long long stage_bytes = 0, buffer_words = 0;
  if (team == 32) {
    // the most rows a CTA takes (the grid has at least min(n, sms) CTAs),
    // and the shared memory their words need with the padding (4 words
    // after every 32), up to kStageBytes
    const int least_ctas = n < sms ? n : sms;
    const long long rows_a_cta = (n + least_ctas - 1) / least_ctas;
    stage_bytes = (rows_a_cta * k + 31) / 32 * 36 * 4;
    if (stage_bytes > kStageBytes) stage_bytes = kStageBytes;
  } else {
    // a padded row buffer a team, where they fit
    buffer_words = (static_cast<long long>(k) + 31) / 32 * 36;
    stage_bytes = kThreads / team * buffer_words * 4;
    if (stage_bytes > kStageBytes) stage_bytes = buffer_words = 0;
  }
  const void* kernel = kKernels[team == 32 ? 0 : team == 128 ? 1 : 2];
  int resident = 0;
  error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, kernel, kThreads, static_cast<size_t>(stage_bytes));
  if (error != cudaSuccess) return static_cast<int>(error);
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  long long grid = static_cast<long long>(resident) * sms;
  if (grid > n) grid = n;
  if (grid > kMaxCtas) grid = kMaxCtas;
  Params params;
  params.words = static_cast<const int32_t*>(words);
  params.ref_start = static_cast<const int32_t*>(ref_start);
  params.n = n;
  params.k = k;
  params.min_sv_size = min_sv_size;
  params.max_events = max_events;
  params.stage_words = static_cast<int>(stage_bytes / 4);
  params.buffer_words = static_cast<int>(buffer_words);
  params.ref_end = static_cast<int32_t*>(ref_end);
  params.read_len = static_cast<int32_t*>(read_len);
  params.qa_start = static_cast<int32_t*>(qa_start);
  params.qa_end = static_cast<int32_t*>(qa_end);
  params.has_hard_clip = static_cast<bool*>(has_hard_clip);
  params.rows = static_cast<int32_t*>(rows);
  params.pos_ref = static_cast<int32_t*>(pos_ref);
  params.pos_read = static_cast<int32_t*>(pos_read);
  params.lengths = static_cast<int32_t*>(lengths);
  params.is_insertion = static_cast<bool*>(is_insertion);
  params.count = static_cast<int32_t*>(count);
  params.row_events = static_cast<int32_t*>(scratch);
  params.cta_totals = static_cast<uint32_t*>(scratch) + n;
  void* arguments[] = {&params};
  error = cudaLaunchCooperativeKernel(
      kernel, dim3(static_cast<unsigned>(grid)), dim3(kThreads), arguments,
      static_cast<size_t>(stage_bytes), static_cast<cudaStream_t>(stream));
  if (error != cudaSuccess) return static_cast<int>(error);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
