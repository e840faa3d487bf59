// The fused TRAIL probe step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/probe.py: probe_update (_probe_kernel).
//
// Semantics (the plain PyTorch version is repro_torch/kernels/ref.py
// probe_update_ref): for each row b of the tap (B, d), float32 or bfloat16,
//   h     = relu(tap[b] @ w1 + b1)            w1 (d, hid), b1 (hid,)
//   p     = softmax(h @ w2 + b2)              w2 (hid, k), b2 (k,)
//   prior = q_prev[b] @ T^T                   q_prev (B, k), T (k, k)
//   q_new = prior * p / sum(prior * p), or prior where that sum is 0;
// weights, q_prev, T and both outputs (q_new, p) are float32, k <= 32.
// The TPU kernel pads k to its 128-lane tile; here one warp holds the k
// bins, one lane each, and lanes past k are masked.
//
// What bounds it: memory. w1 is d x hid float32 (3584 x 512 = 7.3 MB at
// gemma2-9b width) against 2*B*d*hid flops, so at decode batch sizes the
// call moves w1 once and little else. Two passes:
//   probe_hidden_kernel: partial sums of tap @ w1 for ALL rows, tiled over
//     (32 hid columns, a slice of d, up to 16 rows) so that w1 is read once
//     per 16 rows and the grid fills the card; a warp reads 32 neighbouring
//     columns of one w1 row (128 bytes), the tap slice sits in shared
//     memory. Partials over the d slices go to a scratch buffer, summed in
//     a fixed order (no atomics, so the result does not change from run to
//     run);
//   probe_filter_kernel: one block per row sums the partials, adds b1,
//     applies ReLU, then computes the k logits (one warp per bin), the
//     softmax, the prior and the normalised posterior in one warp.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kHiddenThreads = 256;
constexpr int kCols = 32;                          // hid columns per block
constexpr int kRowTile = 16;                       // tap rows per block
constexpr int kDGroups = kHiddenThreads / kCols;   // d interleave per block
constexpr int kFilterThreads = 128;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// grid (ceil(hid/kCols), ceil(B/kRowTile), nsplit); dynamic shared memory
// kRowTile * dslice floats. partial: (nsplit, B, hid).
template <typename T>
__global__ void __launch_bounds__(kHiddenThreads) probe_hidden_kernel(
    const T* __restrict__ tap, const float* __restrict__ w1,
    float* __restrict__ partial, int B, int d, int hid, int dslice) {
  extern __shared__ float tap_s[];                 // kRowTile x dslice
  __shared__ float red[kDGroups][kRowTile][kCols];
  const int j0 = blockIdx.x * kCols, r0 = blockIdx.y * kRowTile;
  const int split = blockIdx.z;
  const int d0 = split * dslice, d1 = min(d0 + dslice, d);
  const int tid = threadIdx.x, lane = tid % kCols, grp = tid / kCols;
  const int nrows = min(kRowTile, B - r0);

  for (int idx = tid; idx < kRowTile * dslice; idx += kHiddenThreads) {
    const int r = idx / dslice, dd = idx % dslice;
    tap_s[idx] = (r < nrows && d0 + dd < d1)
                     ? load_f32(tap + (size_t)(r0 + r) * d + d0 + dd)
                     : 0.f;
  }
  __syncthreads();

  float acc[kRowTile];
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) acc[r] = 0.f;
  const int j = j0 + lane;
  if (j < hid) {
    for (int dd = grp; d0 + dd < d1; dd += kDGroups) {
      const float w = w1[(size_t)(d0 + dd) * hid + j];
#pragma unroll
      for (int r = 0; r < kRowTile; ++r)
        acc[r] = fmaf(tap_s[r * dslice + dd], w, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) red[grp][r][lane] = acc[r];
  __syncthreads();
  for (int idx = tid; idx < kRowTile * kCols; idx += kHiddenThreads) {
    const int r = idx / kCols, c = idx % kCols;
    if (r < nrows && j0 + c < hid) {
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < kDGroups; ++g) sum += red[g][r][c];
      partial[((size_t)split * B + r0 + r) * hid + j0 + c] = sum;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// grid (B,), kFilterThreads threads, dynamic shared memory hid floats.
__global__ void __launch_bounds__(kFilterThreads) probe_filter_kernel(
    const float* __restrict__ partial, int nsplit,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ q_prev,
    const float* __restrict__ T, float* __restrict__ q_new,
    float* __restrict__ p_out, int B, int hid, int k) {
  extern __shared__ float h_s[];                   // hid
  __shared__ float logit_s[32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kFilterThreads / 32;

  for (int j = tid; j < hid; j += kFilterThreads) {
    float s = 0.f;
    for (int sp = 0; sp < nsplit; ++sp)
      s += partial[((size_t)sp * B + b) * hid + j];
    h_s[j] = fmaxf(s + b1[j], 0.f);
  }
  __syncthreads();
  for (int i = warp; i < k; i += kWarps) {
    float s = 0.f;
    for (int j = lane; j < hid; j += 32) s = fmaf(h_s[j], w2[(size_t)j * k + i], s);
    s = warp_sum(s);
    if (lane == 0) logit_s[i] = s + b2[i];
  }
  __syncthreads();
  if (warp != 0) return;
  const bool in = lane < k;
  const float logit = in ? logit_s[lane] : -INFINITY;
  const float m = warp_max(logit);
  const float e = in ? expf(logit - m) : 0.f;
  const float p = e / warp_sum(e);
  float prior = 0.f;
  if (in)
    for (int j = 0; j < k; ++j)
      prior = fmaf(q_prev[(size_t)b * k + j], T[lane * k + j], prior);
  const float post = prior * p;
  const float z = warp_sum(post);
  if (in) {
    q_new[(size_t)b * k + lane] = z > 0.f ? post / fmaxf(z, 1e-30f) : prior;
    p_out[(size_t)b * k + lane] = p;
  }
}

}  // namespace

// dtype (of the tap): 0 = float32, 1 = bfloat16. partial: scratch of
// nsplit * B * hid floats; dslice = ceil(d / nsplit) <= 256. k <= 32.
extern "C" int probe_update_launch(const void* tap, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, const void* q_prev,
                                   const void* T, void* q_new, void* p,
                                   void* partial, int dtype, int B, int d,
                                   int hid, int k, int nsplit, int dslice,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 32 || dslice < 1 || dslice > 256 ||
      (long long)nsplit * dslice < d)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((hid + kCols - 1) / kCols, (B + kRowTile - 1) / kRowTile,
                  nsplit);
  const size_t smem = sizeof(float) * kRowTile * dslice;
  float* part = static_cast<float*>(partial);
  if (dtype == 0)
    probe_hidden_kernel<float><<<grid, kHiddenThreads, smem, s>>>(
        static_cast<const float*>(tap), static_cast<const float*>(w1), part,
        B, d, hid, dslice);
  else if (dtype == 1)
    probe_hidden_kernel<__nv_bfloat16><<<grid, kHiddenThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(tap), static_cast<const float*>(w1),
        part, B, d, hid, dslice);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  probe_filter_kernel<<<B, kFilterThreads, sizeof(float) * hid, s>>>(
      part, nsplit, static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(q_prev), static_cast<const float*>(T),
      static_cast<float*>(q_new), static_cast<float*>(p), B, hid, k);
  return (int)cudaGetLastError();
}
