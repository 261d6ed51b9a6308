// Two-piece-affine global alignment (Gotoh) for Hopper (sm_90a): a batch of
// (a, b) pairs, one warp a pair, each at its own band, every pair's
// alignment the one the host aligner gives.
//
// Replaces no TPU kernel: svim_tpu aligns the insertion consensus on the
// host.  It replaces the host's gotoh_align / gotoh_align_banded
// (svim_tpu_torch/native/svimnative.cpp, under gotoh_align_auto) on the card
// route of COMBINE's consensus pool: the members against the center in each
// polish round and the consensus against the reference window.  The band
// ladder (full matrix, band 64 doubling while the path grazes the corridor,
// then the full matrix) stays in the wrapper
// (svim_tpu_torch/ops/gotoh_kernel.py), which launches a rung and relaunches
// the pairs that report `touched`.
//
// The recurrence is the host's, operation for operation: five states M, V1,
// V2, H1, H2 in float, the scores as arguments, -1e30 for a cell outside the
// corridor (it absorbs every score added to it, as on the host), the tie
// order "V >= diag and V >= H, then H >= diag", and the traceback byte
// (bits 0-1 the state: 0 M, 1 V, 2 H; bit 2 V piece 2 won; bits 3/4 V piece
// 1/2 extended; bit 5 H piece 2 won; bits 6/7 H piece 1/2 extended).  Only
// adds, compares and maxes: nothing for the compiler to contract.
//
// What bounds it on this card: operations.  A band cell costs about 25
// float and integer operations (ten adds and maxes of the five states,
// seven compares for the flags, the selects), the traceback one byte
// written and a few read back; a pair's strings are read once.  The cells
// of a row depend on their left neighbour, so a design keeps each step's
// chain short, keeps the states in registers and runs many pairs at once.
//
//  * Strips of 32 columns.  Lane t owns column j = 32 n + t of strip n and
//    walks down its corridor rows one row a step, one step behind lane t-1:
//    at step s it computes row rbase + s - t, so the left cell (same row)
//    and the diagonal (row above) come from lane t-1 by one shuffle a state
//    (best, H1, H2, and the character of a), and the cell above is the
//    lane's own previous step (best, V1, V2 in registers).  Lane 0 reads the
//    left column from the strip before, which its lane 31 left in device
//    memory (one float4 a row; two such columns a pair, so that a strip
//    never writes the one it reads): the warp loads 32 rows of it, and of
//    a, a lane a row and a chunk ahead, and lane 0 takes each row from its
//    lane by a shuffle, so no load waits inside the chain of steps.
//  * The corridor as a mask.  Column j's rows are [max(0, j - hi_off),
//    min(la, j - lo_off)]; a lane outside them publishes -1e30, which is
//    what the host reads outside a row's corridor.  The full matrix is the
//    corridor lo_off = -la, hi_off = lb.
//  * The traceback in device scratch, one byte a cell: a lane packs four
//    steps into a word and the warp stores 32 words at once (128 bytes), a
//    strip's steps a contiguous block.
//  * One call a rung (gotoh_rung): the host writes the pairs' parameters
//    and the sequences into the caller's page-locked buffer, one copy goes
//    up, the kernel runs, one copy comes down, and the call waits for it,
//    blocked on an event rather than spinning (the host's cores run the
//    other pool threads' seeds meanwhile); a caller thread of the
//    interpreter holds no lock meanwhile and enters it once a rung.
//  * The walk.  The whole warp walks the path from (la, lb) with the host's
//    gap-piece persistence, every lane the same, reading the traceback from
//    a window of 64 four-step groups of the current strip that the warp
//    stages in shared memory (a strip is left behind for good once the path
//    leaves it).  Lane 0 writes the states, last first, at the end of the
//    pair's region; the wrapper spells the rows.  A cell on the corridor's
//    inner edge sets `touched` and ends the walk (the wrapper widens the
//    band), as does an end cell the corridor cut off.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNegInf = -1e30f;
constexpr int kStageGroups = 64;   // four-step groups a warp stages to walk

// the int64 parameters of a pair, in this order
enum {
  kAOffset,     // a's first byte in the sequence blob
  kALength,
  kBOffset,
  kBLength,
  kBand,        // band of the corridor, or < 0 for the full matrix
  kOpsOffset,   // the pair's la + lb bytes of states in `ops`
  kTraceOffset, // the pair's traceback words in `trace`
  kLeftOffset,  // the pair's 2 (la + 1) float4 of strip boundaries in `left`
  kParams
};

struct Scores {
  float match, mismatch, open1, ext1, open2, ext2;
};

// The corridor offsets of a pair: row i holds columns
// [max(0, i + lo_off), min(lb, i + hi_off)].
__host__ __device__ __forceinline__ void corridor(int la, int lb, int band,
                                                  int* lo_off, int* hi_off) {
  if (band < 0) {
    *lo_off = -la;
    *hi_off = lb;
  } else {
    const int delta = lb - la;
    *lo_off = (delta < 0 ? delta : 0) - band;
    *hi_off = (delta > 0 ? delta : 0) + band;
  }
}

// Steps a strip takes at most (rows of its 32 columns' corridors, plus the
// 31 steps of skew), rounded up to whole groups of four.
__host__ __device__ __forceinline__ int strip_groups(int la, int lo_off,
                                                    int hi_off) {
  const int rows = hi_off - lo_off + 1 + 31 < la + 1
                       ? hi_off - lo_off + 1 + 31
                       : la + 1;
  return (rows + 31 + 3) >> 2;
}

// Lane t's share of 32 rows of lane 0's inputs from row `first`: the left
// column's (best, H1, H2) at row first + t (-1e30 outside its corridor, or
// with no column to the left) and a's character of that row.
__device__ __forceinline__ void stage_rows(const float4* read_left, bool left,
                                           int left_lo, int left_hi,
                                           const uint8_t* a, int la, int first,
                                           int lane, float4* value,
                                           uint32_t* ca) {
  const int row = first + lane;
  *value = (left && row >= left_lo && row <= left_hi)
               ? read_left[row]
               : make_float4(kNegInf, kNegInf, kNegInf, 0.0f);
  *ca = (row >= 1 && row <= la) ? a[row - 1] : 0;
}

__global__ void __launch_bounds__(32)
gotoh_kernel(const uint8_t* __restrict__ seqs,
             const long long* __restrict__ params, int batch, Scores score,
             uint32_t* __restrict__ trace, float4* __restrict__ left,
             uint8_t* __restrict__ ops, int* __restrict__ result) {
  __shared__ __align__(16) uint32_t stage[kStageGroups * 32];
  const int pair = blockIdx.x;
  if (pair >= batch) return;
  const int lane = threadIdx.x;
  const long long* p = params + static_cast<long long>(pair) * kParams;
  const uint8_t* a = seqs + p[kAOffset];
  const uint8_t* b = seqs + p[kBOffset];
  const int la = static_cast<int>(p[kALength]);
  const int lb = static_cast<int>(p[kBLength]);
  int lo_off, hi_off;
  corridor(la, lb, static_cast<int>(p[kBand]), &lo_off, &hi_off);
  const int groups = strip_groups(la, lo_off, hi_off);
  uint32_t* pair_trace = trace + p[kTraceOffset];
  float4* boundary = left + p[kLeftOffset];
  const int strips = (lb + 32) >> 5;  // columns 0 .. lb

  float end_best = kNegInf;
  for (int n = 0; n < strips; ++n) {
    const int j0 = n << 5;
    const int j = j0 + lane;
    const int rbase = max(0, j0 - hi_off);
    const int last_j = min(lb, j0 + 31);
    const int steps = min(la, last_j - lo_off) - rbase + (last_j - j0) + 1;
    const bool column = j <= lb;
    const int row_lo = max(0, j - hi_off);
    const int row_hi = min(la, j - lo_off);
    const uint8_t cb = (column && j >= 1) ? b[j - 1] : 0;
    // lane 0's left neighbour is column j0 - 1, of the strip before
    const int left_lo = max(0, j0 - 1 - hi_off);
    const int left_hi = min(la, j0 - 1 - lo_off);
    // strips alternate between two boundary columns: strip n reads the one
    // strip n - 1 wrote and writes the other
    const float4* read_left = boundary + ((n + 1) & 1) * (la + 1LL);
    float4* write_left = boundary + (n & 1) * (la + 1LL);
    float up_best = kNegInf, up_v1 = kNegInf, up_v2 = kNegInf;
    float out_best = kNegInf, out_h1 = kNegInf, out_h2 = kNegInf;
    uint32_t out_a = 0;
    // the diagonal of lane 0's first row: the strip before's row rbase - 1
    float diag = kNegInf;
    if (lane == 0 && j0 >= 1 && rbase - 1 >= left_lo && rbase - 1 <= left_hi) {
      diag = read_left[rbase - 1].x;
    }
    uint32_t packed = 0;
    uint32_t* strip_trace =
        pair_trace + static_cast<long long>(n) * groups * 32;
    // lane 0's inputs of 32 rows at a time, lane t holding row first + t,
    // the next 32 loaded a chunk ahead
    float4 chunk, next;
    uint32_t chunk_a, next_a;
    stage_rows(read_left, j0 >= 1, left_lo, left_hi, a, la, rbase, lane,
               &chunk, &chunk_a);
    stage_rows(read_left, j0 >= 1, left_lo, left_hi, a, la, rbase + 32, lane,
               &next, &next_a);
    for (int s = 0; s < steps; ++s) {
      const int i = rbase + s - lane;
      const int k = s & 31;
      if (k == 0 && s > 0) {
        chunk = next;
        chunk_a = next_a;
        stage_rows(read_left, j0 >= 1, left_lo, left_hi, a, la, rbase + s + 32,
                   lane, &next, &next_a);
      }
      float in_best = __shfl_up_sync(kFullMask, out_best, 1);
      float in_h1 = __shfl_up_sync(kFullMask, out_h1, 1);
      float in_h2 = __shfl_up_sync(kFullMask, out_h2, 1);
      uint32_t ca = __shfl_up_sync(kFullMask, out_a, 1);
      const float left_best = __shfl_sync(kFullMask, chunk.x, k);
      const float left_h1 = __shfl_sync(kFullMask, chunk.y, k);
      const float left_h2 = __shfl_sync(kFullMask, chunk.z, k);
      const uint32_t left_a = __shfl_sync(kFullMask, chunk_a, k);
      if (lane == 0) {
        in_best = left_best;
        in_h1 = left_h1;
        in_h2 = left_h2;
        ca = left_a;
      }
      const float from_diag = diag;
      diag = in_best;
      out_a = ca;
      const bool live = column && i >= row_lo && i <= row_hi;
      // The host's general cell.  Row 0 and column 0 need no code of their
      // own: what they cannot reach (the row above, the column to the left,
      // the diagonal) reads -1e30 and absorbs every score, so the general
      // cell gives their best and their state; only the flags of the
      // unreachable gap states, which the host leaves 0 there, are cleared.
      const float v_open1 = up_best + score.open1;
      const float v_ext1 = up_v1 + score.ext1;
      const float v1 = fmaxf(v_open1, v_ext1);
      const float v_open2 = up_best + score.open2;
      const float v_ext2 = up_v2 + score.ext2;
      const float v2 = fmaxf(v_open2, v_ext2);
      const bool v_piece2 = v2 > v1;
      const float vbest = v_piece2 ? v2 : v1;
      const float h_open1 = in_best + score.open1;
      const float h_ext1 = in_h1 + score.ext1;
      const float h1 = fmaxf(h_open1, h_ext1);
      const float h_open2 = in_best + score.open2;
      const float h_ext2 = in_h2 + score.ext2;
      const float h2 = fmaxf(h_open2, h_ext2);
      const float hbest = fmaxf(h1, h2);
      const float match =
          from_diag + (ca == cb ? score.match : score.mismatch);
      const bool take_v = vbest >= match && vbest >= hbest;
      const bool take_h = !take_v && hbest >= match;
      float best = take_v ? vbest : (take_h ? hbest : match);
      uint32_t flags = (take_v ? 1u : 0u) | (take_h ? 2u : 0u) |
                       (v_piece2 ? 0x04u : 0u) |
                       (v_ext1 >= v_open1 ? 0x08u : 0u) |
                       (v_ext2 >= v_open2 ? 0x10u : 0u) |
                       (h2 > h1 ? 0x20u : 0u) |
                       (h_ext1 >= h_open1 ? 0x40u : 0u) |
                       (h_ext2 >= h_open2 ? 0x80u : 0u);
      if (i == 0) flags &= ~0x18u;  // row 0: no vertical gap
      if (j == 0) flags &= ~0xc0u;  // column 0: no horizontal gap
      if (i == 0 && j == 0) {       // the origin
        best = 0.0f;
        flags = 0;
      }
      if (!live) flags = 0;
      up_best = live ? best : up_best;
      up_v1 = live ? v1 : up_v1;
      up_v2 = live ? v2 : up_v2;
      out_best = live ? best : kNegInf;
      out_h1 = live ? h1 : kNegInf;
      out_h2 = live ? h2 : kNegInf;
      if (live && lane == 31) write_left[i] = make_float4(best, h1, h2, 0.0f);
      packed |= flags << ((s & 3) << 3);
      if ((s & 3) == 3 || s == steps - 1) {
        strip_trace[(s >> 2) * 32 + lane] = packed;
        packed = 0;
      }
    }
    // the end cell (la, lb) is the last row of column lb, in the last strip
    if (n == strips - 1) end_best = __shfl_sync(kFullMask, up_best, lb & 31);
    __syncwarp();  // the boundary and the traceback are written
  }

  int* pair_result = result + 2 * static_cast<long long>(pair);
  if (end_best <= kNegInf / 2) {
    // the corridor cut the end cell off: a wider band
    if (lane == 0) {
      pair_result[0] = 0;
      pair_result[1] = 1;
    }
    return;
  }

  // the walk: every lane the same, lane 0 writes
  uint8_t* pair_ops = ops + p[kOpsOffset];
  const long long last = static_cast<long long>(la) + lb - 1;
  int staged_strip = -1, staged_lo = 0, staged_hi = -1;
  int i = la, j = lb;
  int state = -1, piece = 0, touched = 0;
  long long length = 0;
  while (i > 0 || j > 0) {
    const int n = j >> 5;
    const int t = j & 31;
    const int lo_i = max(0, i + lo_off);
    const int hi_i = min(lb, i + hi_off);
    if ((lo_i > 0 && j <= lo_i) || (hi_i < lb && j >= hi_i) || j < lo_i ||
        j > hi_i) {
      touched = 1;  // the corridor's edge (or, never on a finite path, out)
      break;
    }
    const int s = i - max(0, (n << 5) - hi_off) + t;
    const int g = s >> 2;
    if (n != staged_strip || g < staged_lo || g > staged_hi) {
      staged_strip = n;
      staged_hi = g;
      staged_lo = max(0, g - (kStageGroups - 1));
      __syncwarp();
      const uint4* from = reinterpret_cast<const uint4*>(
          pair_trace + (static_cast<long long>(n) * groups + staged_lo) * 32);
      uint4* to = reinterpret_cast<uint4*>(stage);
      for (int k = lane; k < (staged_hi - staged_lo + 1) * 8; k += 32) {
        to[k] = from[k];
      }
      __syncwarp();
    }
    const uint32_t flags =
        (stage[(g - staged_lo) * 32 + t] >> ((s & 3) << 3)) & 0xffu;
    if (state < 0) {
      state = flags & 3;
      piece = 0;
    }
    if (lane == 0) pair_ops[last - length] = static_cast<uint8_t>(state);
    ++length;
    if (state == 0) {
      --i;
      --j;
      state = -1;
    } else if (state == 1) {
      if (piece == 0) piece = (flags & 0x04) ? 2 : 1;
      const bool extended = flags & (piece == 2 ? 0x10 : 0x08);
      --i;
      if (!extended) state = -1;
    } else {
      if (piece == 0) piece = (flags & 0x20) ? 2 : 1;
      const bool extended = flags & (piece == 2 ? 0x80 : 0x40);
      --j;
      if (!extended) state = -1;
    }
  }
  if (lane == 0) {
    pair_result[0] = touched ? 0 : static_cast<int>(length);
    pair_result[1] = touched;
  }
}

// The buffers of a rung, in the order of its sizes: the upload (the
// parameters, kParams int64 a pair, then the sequences), the traceback
// (words), the strip boundaries (float4) and the download (two int32 a
// pair, then the op strings).
enum { kUpload, kTrace, kLeft, kDownload, kSizes };
constexpr int kNeedMore = -2;

}  // namespace

extern "C" {

// One rung of the ladder over `batch` pairs, waited for on `stream`: the
// plan (five int64 a pair: a's offset in `blob`, its length, b's offset,
// its length, the band or -1 for the full matrix) and the sequences go up
// in one copy from the page-locked `host_upload`, the kernel runs one
// warp (one CTA) a pair, and the results come back in one copy into the
// page-locked `host_download`: two int32 a pair (the op string's length,
// and 1 where the path touched the corridor's edge), then each pair's
// la + lb bytes of op states.  The caller's buffers hold `capacity` of
// each size; the sizes the rung needs go to `need`.  Returns 0, kNeedMore
// when a buffer is too small (nothing was enqueued: grow it and call
// again), -1 for a pair outside the blob, or a CUDA error code.
int gotoh_rung(const uint8_t* blob, long long blob_size,
               const long long* plan, int batch, float match,
               float mismatch, float open1, float ext1, float open2,
               float ext2, void* host_upload, void* card_upload,
               void* card_trace, void* card_left, void* card_download,
               void* host_download, const long long* capacity,
               long long* need, void* stream_handle) {
  cudaGetLastError();  // clear a stale error so the code below is ours
  long long trace_words = 0, left_rows = 0, ops_bytes = 0;
  for (int k = 0; k < batch; ++k) {
    const long long* pair = plan + 5LL * k;
    if (pair[0] < 0 || pair[1] < 0 || pair[2] < 0 || pair[3] < 0 ||
        pair[0] + pair[1] > blob_size || pair[2] + pair[3] > blob_size) {
      return -1;
    }
    const int la = static_cast<int>(pair[1]);
    const int lb = static_cast<int>(pair[3]);
    int lo_off, hi_off;
    corridor(la, lb, static_cast<int>(pair[4]), &lo_off, &hi_off);
    trace_words += static_cast<long long>((lb + 32) >> 5) *
                   strip_groups(la, lo_off, hi_off) * 32;
    left_rows += 2LL * (la + 1);
    ops_bytes += static_cast<long long>(la) + lb;
  }
  const long long head = 8LL * kParams * batch;
  need[kUpload] = head + blob_size;
  need[kTrace] = trace_words;
  need[kLeft] = left_rows;
  need[kDownload] = 8LL * batch + ops_bytes;
  for (int size = 0; size < kSizes; ++size) {
    if (need[size] > capacity[size]) return kNeedMore;
  }
  if (batch <= 0) return 0;
  long long* params = static_cast<long long*>(host_upload);
  long long ops_at = 0, trace_at = 0, left_at = 0;
  for (int k = 0; k < batch; ++k) {
    const long long* pair = plan + 5LL * k;
    long long* out = params + static_cast<long long>(kParams) * k;
    const int la = static_cast<int>(pair[1]);
    const int lb = static_cast<int>(pair[3]);
    int lo_off, hi_off;
    corridor(la, lb, static_cast<int>(pair[4]), &lo_off, &hi_off);
    out[kAOffset] = pair[0];
    out[kALength] = la;
    out[kBOffset] = pair[2];
    out[kBLength] = lb;
    out[kBand] = pair[4];
    out[kOpsOffset] = ops_at;
    out[kTraceOffset] = trace_at;
    out[kLeftOffset] = left_at;
    ops_at += static_cast<long long>(la) + lb;
    trace_at += static_cast<long long>((lb + 32) >> 5) *
                strip_groups(la, lo_off, hi_off) * 32;
    left_at += 2LL * (la + 1);
  }
  std::memcpy(static_cast<uint8_t*>(host_upload) + head, blob, blob_size);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  cudaError_t status = cudaMemcpyAsync(card_upload, host_upload,
                                       need[kUpload], cudaMemcpyHostToDevice,
                                       stream);
  if (status != cudaSuccess) return static_cast<int>(status);
  uint8_t* download = static_cast<uint8_t*>(card_download);
  const Scores score{match, mismatch, open1, ext1, open2, ext2};
  gotoh_kernel<<<batch, 32, 0, stream>>>(
      static_cast<const uint8_t*>(card_upload) + head,
      static_cast<const long long*>(card_upload), batch, score,
      static_cast<uint32_t*>(card_trace), static_cast<float4*>(card_left),
      download + 8LL * batch, reinterpret_cast<int*>(download));
  status = cudaGetLastError();
  if (status != cudaSuccess) return static_cast<int>(status);
  status = cudaMemcpyAsync(host_download, card_download, need[kDownload],
                           cudaMemcpyDeviceToHost, stream);
  if (status != cudaSuccess) return static_cast<int>(status);
  // wait blocked, not spinning: the consensus pool's other threads need
  // the host's cores for their seeds meanwhile
  cudaEvent_t done;
  status = cudaEventCreateWithFlags(
      &done, cudaEventBlockingSync | cudaEventDisableTiming);
  if (status != cudaSuccess) return static_cast<int>(status);
  status = cudaEventRecord(done, stream);
  if (status == cudaSuccess) status = cudaEventSynchronize(done);
  cudaEventDestroy(done);
  return static_cast<int>(status);
}

}  // extern "C"
