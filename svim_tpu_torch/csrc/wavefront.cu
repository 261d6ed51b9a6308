// Banded exact Levenshtein distance as anti-diagonal wavefronts, one CTA per
// pair, for Hopper (sm_90a).
//
// Replaces the TPU kernel svim_tpu/ops/wavefront_kernel.py
// (_wavefront_pallas_kernel, launched by banded_distance_pallas) and computes
// exactly what its plain twin banded_distance computes: for every pair the
// wavefronts d = 2 .. m+n of width K = 2W+1 (cell k sits on diagonal
// e = k - W, i = floor((d+e)/2), j = floor((d-e)/2)), the same boundary
// injections D(0,d) = D(d,0) = d, the same INF = 1<<20 masking and the same
// clipped character reads.  Every output, including the "band too small"
// values above W, is bit-identical to the plain PyTorch version
// (svim_tpu_torch/ops/wavefront_kernel.py::banded_distance_torch).
//
// What bounds it on this card: each anti-diagonal depends on the previous
// two, so one pair is ~m+n dependent steps with one __syncthreads() each and
// a few integer ops per cell — the kernel is latency-bound, not byte-bound
// (a pair reads its two strings once; L1/L2 serve the sequential character
// reads a[i-1], b[j-1], so no shift register is kept).  The design answers
// that with parallelism across pairs: every pair is its own CTA, so a batch
// keeps many CTAs in flight on all 132 SMs and the barrier latency of one
// pair hides behind the others.
//
// Fronts: three rotating int32 fronts of K cells.  They live in dynamic
// shared memory while 3*K*4 bytes fit the opt-in per-block limit (W = 4096
// needs 98 KB); wider fronts use a (B, 3, K) global scratch that the caller
// allocates.  __syncthreads() orders global accesses within the block too.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 20;
constexpr int kThreads = 256;

__device__ __forceinline__ int floor_half(int x) {
  // Python floor division by 2 (x may be negative)
  return x >= 0 ? x / 2 : -((1 - x) / 2);
}

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void wavefront_kernel(const uint8_t* __restrict__ a_codes,
                                 const int32_t* __restrict__ a_lens,
                                 const uint8_t* __restrict__ b_codes,
                                 const int32_t* __restrict__ b_lens,
                                 int32_t* __restrict__ out,
                                 int32_t* __restrict__ scratch,
                                 int length, int band) {
  extern __shared__ int32_t shared_fronts[];
  const int pair = blockIdx.x;
  const int k_width = 2 * band + 1;
  int32_t* fronts = scratch == nullptr
                        ? shared_fronts
                        : scratch + static_cast<int64_t>(pair) * 3 * k_width;
  const uint8_t* a = a_codes + static_cast<int64_t>(pair) * length;
  const uint8_t* b = b_codes + static_cast<int64_t>(pair) * length;
  const int m = a_lens[pair];
  const int n = b_lens[pair];
  const int final_k = band + (m - n);
  const bool final_in_band = final_k >= 0 && final_k < k_width;

  // wavefront 0: D(0,0) = 0; wavefront 1: D(1,0) = 1, D(0,1) = 1 in range
  int32_t* prev2 = fronts;
  int32_t* prev = fronts + k_width;
  int32_t* cur = fronts + 2 * k_width;
  for (int k = threadIdx.x; k < k_width; k += blockDim.x) {
    prev2[k] = k == band ? 0 : kInf;
    int32_t value = kInf;
    if (band >= 1 && k == band + 1 && m >= 1) value = 1;
    if (band >= 1 && k == band - 1 && n >= 1) value = 1;
    prev[k] = value;
  }
  if (threadIdx.x == 0) {
    int32_t answer = (m + n == 0) ? 0 : kInf;
    if (m + n == 1 && final_in_band) answer = 1;
    out[pair] = answer;
  }
  __syncthreads();

  const int d_stop = m + n;
  for (int d = 2; d <= d_stop; ++d) {
    const int k_top = band - d;   // e = -d (i == 0)
    const int k_left = band + d;  // e = +d (j == 0)
    for (int k = threadIdx.x; k < k_width; k += blockDim.x) {
      const int e = k - band;
      const int i = floor_half(d + e);
      const int j = floor_half(d - e);
      const bool in_range = i >= 1 && i <= m && j >= 1 && j <= n;
      const int ca = a[clip(i - 1, 0, length - 1)];
      const int cb = b[clip(j - 1, 0, length - 1)];
      const int from_insert = (k == 0 ? kInf : prev[k - 1]) + 1;
      const int from_delete = (k == k_width - 1 ? kInf : prev[k + 1]) + 1;
      const int from_match = prev2[k] + (ca == cb ? 0 : 1);
      int value = min(min(from_insert, from_delete), from_match);
      if (k == k_top && d <= n) value = d;
      if (k == k_left && d <= m) value = d;
      if (!(in_range || k == k_top || k == k_left)) value = kInf;
      cur[k] = value;
      if (d == d_stop && k == final_k) out[pair] = value;
    }
    __syncthreads();
    int32_t* spare = prev2;
    prev2 = prev;
    prev = cur;
    cur = spare;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA may opt into on device 0, or -1.
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

// Launches one CTA per pair on `stream`.  `scratch` is null for
// shared-memory fronts, else a (batch, 3, 2*band+1) int32 buffer.  Returns
// the cudaGetLastError() code of the launch (0 on success).
int wavefront_banded_distance(const void* a_codes, const void* a_lens,
                              const void* b_codes, const void* b_lens,
                              void* out, void* scratch, int batch, int length,
                              int band, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is ours
  if (batch <= 0) return 0;
  const int k_width = 2 * band + 1;
  size_t shared_bytes = 0;
  if (scratch == nullptr) {
    shared_bytes = static_cast<size_t>(3) * k_width * sizeof(int32_t);
    cudaError_t status = cudaFuncSetAttribute(
        wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared_bytes));
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  wavefront_kernel<<<batch, kThreads, shared_bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a_codes),
      static_cast<const int32_t*>(a_lens),
      static_cast<const uint8_t*>(b_codes),
      static_cast<const int32_t*>(b_lens), static_cast<int32_t*>(out),
      static_cast<int32_t*>(scratch), length, band);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
