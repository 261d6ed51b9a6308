// Banded exact Levenshtein distance as anti-diagonal wavefronts for Hopper
// (sm_90a): one warp per pair with the fronts in registers.
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
// 2.4e10 operations, 1.4 ms at the card's 1.67e13 int32 op/s.  Fronts d-1
// and d-2 feed front d, so a pair is m+n dependent steps; the design keeps
// each step short and runs thousands of pairs side by side.
//
// What the design does about the four costs of a slot-per-band-position,
// CTA-per-pair kernel:
//
//  * Dead slots.  A front holds only cells of one parity: slot q of front d
//    is diagonal e = 2q - Q + (d & 1), cell i = (d+e)/2, j = (d-e)/2, with
//    Q the even number >= min(w, n).  The band is clipped to the pair,
//    w = min(W, max(m, n)) and e in [-min(w, n), min(w, m)], so a pair needs
//    (min(w, m) + min(w, n))/2 + 2 slots, each warp picks the narrowest
//    strip that holds them, and the loop ends at the pair's own m+n.  Cells
//    outside 0 <= i <= m, 0 <= j <= n are masked to INF, which also makes the
//    boundaries D(0, d) = D(d, 0) = d fall out of the recurrence.
//  * The block barrier a front.  Lane t owns the S consecutive slots
//    [tS, tS+S) and keeps the last even and the last odd front of its strip
//    in registers (the new front overwrites the one two steps back in
//    place).  An even front needs slot tS-1 of the odd front from lane t-1,
//    an odd front slot tS+S of the even front from lane t+1: one warp
//    shuffle a front, no shared memory, no barrier.  Several warps (pairs)
//    share a CTA and never synchronise with each other.
//  * Global character reads.  A warp copies its pair's strings into shared
//    memory once (16-byte loads).  Each lane keeps the characters of its
//    cells in registers: along a diagonal a[i-1] advances on odd fronts and
//    b[j-1] on even fronts, which is a shift by one slot, so a front costs a
//    lane one byte from shared memory.
//  * Loose bands.  Before the pass at the caller's band the warp runs the
//    pair at band 63 (S = 2) and 255 (S = 8) where those are below half the
//    band.  A value <= the band it was computed in is the exact distance
//    (an optimal path with k edits never leaves |i - j| <= k), so it equals
//    what the pass at W would return.  A narrow pass gives up as soon as no
//    cell of its last two fronts is <= its band (every path crosses one of
//    them and values never decrease along a path).  The last pass runs at W
//    to the end, so unresolved pairs get the plain version's value.
//
// Hopper's DPX instruction __viaddmin_s32 folds the +1 and the last min of a
// cell (CUDA 12 toolkits declare it; older ones get the two-instruction form).
//
// Bands whose strip does not fit a warp's registers (more than 1056 slots)
// run one CTA per pair over the live slots of each front, with a barrier a
// front: fronts in shared memory (strings staged beside them when both fit),
// or in a global scratch buffer above the shared-memory limit.  Warp 0 runs
// the narrow passes first there too.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 20;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kCtaThreads = 256;

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

// The pairs a warp answers without a front: 0 for two empty strings, kInf
// when (m, n) is outside the band, 1 for m + n == 1.  Returns -1 otherwise.
__device__ __forceinline__ int trivial_answer(int m, int n, int band) {
  if (m + n == 0) return 0;
  if (abs(m - n) > band) return kInf;
  if (m + n == 1) return 1;
  return -1;
}

// The narrow passes (band 63, then 255) of a pair whose band w is more than
// twice as wide.  Returns the exact distance, or -1 when unresolved.
template <bool kWide>
__device__ int narrow_passes(const uint8_t* a, const uint8_t* b, int m, int n,
                             int w) {
  const int skew = abs(m - n);
  if (2 * 63 < w && skew <= 63) {
    const int value = warp_pass<2>(a, b, m, n, 63, true);
    if (value <= 63) return value;
  }
  if (kWide && 2 * 255 < w && skew <= 255) {
    const int value = warp_pass<8>(a, b, m, n, 255, true);
    if (value <= 255) return value;
  }
  return -1;
}

template <int kMaxS>
__device__ int solve_in_warp(const uint8_t* a, const uint8_t* b, int m, int n,
                             int band) {
  const int trivial = trivial_answer(m, n, band);
  if (trivial >= 0) return trivial;
  const int w = min(band, max(m, n));  // a wider band holds no more cells
  const int narrow = narrow_passes<(kMaxS > 8)>(a, b, m, n, w);
  if (narrow >= 0) return narrow;
  // the launch guarantees slots <= 32 * kMaxS
  const int slots = slots_needed(m, n, w);
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

// One warp per pair, blockDim.x / 32 pairs a CTA.  Dynamic shared memory:
// 2 * length bytes a warp for the staged strings.
template <int kMaxS>
__global__ void __launch_bounds__(128)
    wavefront_warp_kernel(const uint8_t* __restrict__ a_codes,
                          const int32_t* __restrict__ a_lens,
                          const uint8_t* __restrict__ b_codes,
                          const int32_t* __restrict__ b_lens,
                          int32_t* __restrict__ out, int batch, int length,
                          int band) {
  extern __shared__ uint4 shared_words[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * (blockDim.x >> 5) + warp;
  if (pair >= batch) return;  // the whole warp leaves; no block barrier below
  const int m = a_lens[pair];
  const int n = b_lens[pair];
  uint8_t* text_a = reinterpret_cast<uint8_t*>(shared_words) +
                    static_cast<size_t>(warp) * 2 * length;
  uint8_t* text_b = text_a + length;
  const bool wide =
      (length & 15) == 0 && aligned16(a_codes) && aligned16(b_codes);
  stage_text(text_a, a_codes + static_cast<int64_t>(pair) * length, m, wide,
             lane, 32);
  stage_text(text_b, b_codes + static_cast<int64_t>(pair) * length, n, wide,
             lane, 32);
  __syncwarp();
  const int answer = solve_in_warp<kMaxS>(text_a, text_b, m, n, band);
  if (lane == 0) out[pair] = answer;
}

// One CTA per pair for bands too wide for a warp's registers.  The two
// fronts (even, odd) have `stride` int32 slots each, one INF margin slot on
// either side of the live range; they lie in dynamic shared memory, or in
// `scratch` (batch, 2, stride) when that is not null.  With `stage` the
// strings are staged behind the shared fronts.
__global__ void __launch_bounds__(kCtaThreads)
    wavefront_cta_kernel(const uint8_t* __restrict__ a_codes,
                         const int32_t* __restrict__ a_lens,
                         const uint8_t* __restrict__ b_codes,
                         const int32_t* __restrict__ b_lens,
                         int32_t* __restrict__ out,
                         int32_t* __restrict__ scratch, int length, int band,
                         int stride, int stage) {
  extern __shared__ uint4 shared_words[];
  __shared__ int narrow_answer;
  const int pair = blockIdx.x;
  const int m = a_lens[pair];
  const int n = b_lens[pair];
  const uint8_t* a = a_codes + static_cast<int64_t>(pair) * length;
  const uint8_t* b = b_codes + static_cast<int64_t>(pair) * length;
  const int trivial = trivial_answer(m, n, band);
  if (trivial >= 0) {  // the same for every thread
    if (threadIdx.x == 0) out[pair] = trivial;
    return;
  }
  const int w = min(band, max(m, n));
  if (threadIdx.x < 32) {
    const int narrow = narrow_passes<true>(a, b, m, n, w);
    if (threadIdx.x == 0) narrow_answer = narrow;
  }
  __syncthreads();
  if (narrow_answer >= 0) {
    if (threadIdx.x == 0) out[pair] = narrow_answer;
    return;
  }

  int32_t* fronts = scratch == nullptr
                        ? reinterpret_cast<int32_t*>(shared_words)
                        : scratch + static_cast<int64_t>(pair) * 2 * stride;
  int32_t* even = fronts + 1;  // slot -1 is the left margin
  int32_t* odd = even + stride;
  const int q_offset = (min(w, n) + 1) & ~1;
  const int half = q_offset >> 1;
  const int slots = slots_needed(m, n, w);  // <= stride - 2
  for (int q = threadIdx.x - 1; q <= slots; q += blockDim.x) {
    even[q] = q == half ? 0 : kInf;
    odd[q] = kInf;
  }
  if (stage) {
    uint8_t* text_a = reinterpret_cast<uint8_t*>(shared_words) +
                      static_cast<size_t>(2) * stride * sizeof(int32_t);
    uint8_t* text_b = text_a + length;
    const bool wide =
        (length & 15) == 0 && aligned16(a_codes) && aligned16(b_codes);
    stage_text(text_a, a, m, wide, threadIdx.x, blockDim.x);
    stage_text(text_b, b, n, wide, threadIdx.x, blockDim.x);
    a = text_a;
    b = text_b;
  }
  __syncthreads();

  const int last_front = m + n;
  for (int d = 1; d <= last_front; ++d) {
    const int parity = d & 1;
    const int r = d >> 1;
    int32_t* current = parity ? odd : even;
    const int32_t* previous = parity ? even : odd;
    int q_lo, q_hi;
    live_slots(d, m, n, w, q_offset, &q_lo, &q_hi);
    for (int q = q_lo + static_cast<int>(threadIdx.x); q <= q_hi;
         q += blockDim.x) {
      // odd fronts take slots q, q+1 of the even front; even fronts slots
      // q-1, q of the odd front
      const int neighbours = min(previous[q - 1 + parity], previous[q + parity]);
      const int ia = r + q - half - 1 + parity;
      const int ib = r - q + half - 1;
      const int differ = a[max(ia, 0)] != b[max(ib, 0)] ? 1 : 0;
      current[q] = add_min(neighbours, 1, current[q] + differ);
    }
    if (threadIdx.x == 0) {  // the live range moves by at most one slot
      current[max(q_lo - 1, -1)] = kInf;
      current[min(q_hi + 1, slots)] = kInf;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int final_q = (m - n + q_offset - (last_front & 1)) >> 1;
    out[pair] = (last_front & 1) ? odd[final_q] : even[final_q];
  }
}

template <int kMaxS>
int launch_warp_kernel(const void* a_codes, const void* a_lens,
                       const void* b_codes, const void* b_lens, void* out,
                       int batch, int length, int band, int warps,
                       cudaStream_t stream) {
  const size_t shared_bytes = static_cast<size_t>(warps) * 2 * length;
  cudaError_t status = cudaFuncSetAttribute(
      wavefront_warp_kernel<kMaxS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_bytes));
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = (batch + warps - 1) / warps;
  wavefront_warp_kernel<kMaxS><<<blocks, 32 * warps, shared_bytes, stream>>>(
      static_cast<const uint8_t*>(a_codes),
      static_cast<const int32_t*>(a_lens),
      static_cast<const uint8_t*>(b_codes),
      static_cast<const int32_t*>(b_lens), static_cast<int32_t*>(out), batch,
      length, band);
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

// 1 when the toolkit that built this library has the DPX intrinsics.
int wavefront_uses_dpx() {
#if defined(__CUDACC_VER_MAJOR__) && __CUDACC_VER_MAJOR__ >= 12
  return 1;
#else
  return 0;
#endif
}

// One warp per pair, `warps` pairs a CTA; `max_slots_per_lane` is 3, 9 or 33
// and min(band, length) + 1 <= 32 * max_slots_per_lane.  Returns the
// cudaGetLastError() code of the launch (0 on success), -1 for a bad
// `max_slots_per_lane`.
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
      return launch_warp_kernel<3>(a_codes, a_lens, b_codes, b_lens, out,
                                   batch, length, band, warps, stream);
    case 9:
      return launch_warp_kernel<9>(a_codes, a_lens, b_codes, b_lens, out,
                                   batch, length, band, warps, stream);
    case 33:
      return launch_warp_kernel<33>(a_codes, a_lens, b_codes, b_lens, out,
                                    batch, length, band, warps, stream);
    default:
      return -1;
  }
}

// One CTA per pair.  `stride` is even and >= min(band, length) + 3 slots a
// front;
// `scratch` is null for shared-memory fronts (2 * stride * 4 bytes, plus
// 2 * length when `stage`), else a (batch, 2, stride) int32 buffer.
int wavefront_banded_distance_cta(const void* a_codes, const void* a_lens,
                                  const void* b_codes, const void* b_lens,
                                  void* out, void* scratch, int batch,
                                  int length, int band, int stride, int stage,
                                  void* stream_handle) {
  cudaGetLastError();
  if (batch <= 0) return 0;
  size_t shared_bytes = 0;
  if (scratch == nullptr) {
    shared_bytes = static_cast<size_t>(2) * stride * sizeof(int32_t) +
                   (stage ? static_cast<size_t>(2) * length : 0);
  }
  cudaError_t status = cudaFuncSetAttribute(
      wavefront_cta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_bytes));
  if (status != cudaSuccess) return static_cast<int>(status);
  wavefront_cta_kernel<<<batch, kCtaThreads, shared_bytes,
                         static_cast<cudaStream_t>(stream_handle)>>>(
      static_cast<const uint8_t*>(a_codes),
      static_cast<const int32_t*>(a_lens),
      static_cast<const uint8_t*>(b_codes),
      static_cast<const int32_t*>(b_lens), static_cast<int32_t*>(out),
      static_cast<int32_t*>(scratch), length, band, stride, stage);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
