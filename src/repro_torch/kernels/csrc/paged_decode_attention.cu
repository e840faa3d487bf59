// Flash-decode over a paged KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the reference package,
// src/repro/kernels/paged_decode_attention.py:
//   paged_decode_attention        (_paged_kernel)       -> decode_kernel
//                                   over PagedRows (flash_decode.cuh)
//   paged_decode_attention_multi  (_paged_multi_kernel) -> paged_multi_kernel
//
// Semantics (the plain PyTorch version is repro_torch/kernels/ref.py):
// K/V live in a pool of pages k/v_pages (P, ps, KH, hd) shared by every
// sequence; block_table (B, pmax) maps logical page p of sequence b to a
// physical page, 0 being the null page whose kpos is always -1. Query head
// h = kh*G + g reads KV head kh (GQA). Key position kpos is valid for a
// query at q_pos when kpos >= 0 && kpos <= q_pos (&& kpos > q_pos - window).
// Scores are scaled by hd^-0.5 after the dot, optionally soft-capped, and
// folded into an online softmax kept in float32; a row with nothing valid
// (q_pos = -1) comes out as 0, never NaN (l is clamped at 1e-30, as in the
// reference's NEG_INF = -2^30 semantics).
//
// What bounds it: memory. Decode reads every referenced page's K, V and
// kpos once per (sequence, KV head) and does 4 flops per K/V element per
// query row, far below the card's ~295 flops/byte ridge. The design keeps
// that traffic to one pass: one block per (sequence, KV head) serves all
// G query heads of the group from one stream of the pages, loads are 16
// bytes per thread with neighbouring threads on neighbouring addresses,
// the K and V rows of a whole chunk are issued before any of them is
// used (so many loads are in flight per block), and null pages are
// skipped without a load. The multi-query kernel streams each page
// once per tile of 32 query rows for a chunk of T queries; a tile whose
// rows are all inactive (q_pos = -1, most slots of a prefill batch)
// writes zeros and returns at once. Its dot products run on plain FMA in
// float32 from shared memory; tensor cores (wgmma), TMA and splitting the
// pages of one sequence over several blocks are left for later work.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

constexpr int kRows = 32;      // multi: query rows per tile (one per lane)
constexpr int kMChunk = 32;    // multi: tokens per chunk

// True when some page overlapping tokens [c0, c1) of row b is not the null
// page. Uniform across the block.
__device__ __forceinline__ bool chunk_has_pages(const int* bt, int b, int pmax,
                                                int ps, int c0, int c1) {
  for (int lp = c0 / ps; lp * ps < c1; ++lp)
    if (bt[b * pmax + lp] != 0) return true;
  return false;
}

// Token rows of the single-query kernel (flash_decode.cuh): token n of
// sequence b is slot n % ps of page block_table[b][n / ps]; the null page
// is never loaded and a chunk of null pages is skipped.
struct PagedRows {
  const int* bt;
  int pmax, ps;
  __device__ int ntok(int, int) const { return pmax * ps; }
  __device__ bool live(int b, int c0, int c1) const {
    return chunk_has_pages(bt, b, pmax, ps, c0, c1);
  }
  __device__ long long slot(int b, int n) const {
    const int pid = bt[b * pmax + n / ps];
    return pid != 0 ? (long long)pid * ps + n % ps : -1;
  }
};

// ---------------------------------------------------------------------------
// T queries per sequence: one block per (tile of kRows query rows, KV head,
// sequence). Row r of the (T*G) rows of a (sequence, KV head) is query
// token r / G, head kh*G + r % G. K/V chunks are staged in shared memory as
// float32 and used by all kRows rows.
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t multi_smem_bytes() {
  return sizeof(float) * ((size_t)kRows * (HD + 1) + 2 * kMChunk * HD +
                          kRows * (kMChunk + 1) + kMChunk * kRows + 2 * kRows) +
         sizeof(int) * (kMChunk + kRows);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_multi_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ kpos_pages,
    const int* __restrict__ block_table, const int* __restrict__ q_pos,
    T* __restrict__ out, int Tq, int H, int KH, int ps, int pmax, float scale,
    int window, float softcap) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;                          // vectors per row
  constexpr int CPT = HD >= kThreads ? HD / kThreads : 1;  // columns/thread
  constexpr int NRG = HD >= kThreads ? 1 : kThreads / HD;  // row groups
  constexpr int RPT = kRows / NRG;                         // rows/thread
  constexpr int NW = kThreads / 32;
  constexpr int TPW = kMChunk / NW;                        // tokens/warp
  static_assert(kRows == 32, "one query row per lane in the score phase");
  static_assert(HD % 4 == 0 && RPT % 4 == 0, "float4 reads");

  extern __shared__ float4 smem4[];
  float* Q_s = reinterpret_cast<float*>(smem4);   // kRows x (HD+1)
  float* K_s = Q_s + kRows * (HD + 1);            // kMChunk x HD
  float* V_s = K_s + kMChunk * HD;                // kMChunk x HD
  float* S_s = V_s + kMChunk * HD;                // kRows x (kMChunk+1)
  float* P_s = S_s + kRows * (kMChunk + 1);       // kMChunk x kRows
  float* alpha_s = P_s + kMChunk * kRows;         // kRows
  float* l_s = alpha_s + kRows;                   // kRows
  int* kpos_s = reinterpret_cast<int*>(l_s + kRows);  // kMChunk
  int* qpos_s = kpos_s + kMChunk;                 // kRows

  const int tile = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int R = Tq * G;
  const int r0 = tile * kRows;
  const int tid = threadIdx.x;
  const int ntok = pmax * ps;

  for (int r = tid; r < kRows; r += kThreads) {
    const int row = r0 + r;
    qpos_s[r] = row < R ? q_pos[b * Tq + row / G] : -1;
  }
  __syncthreads();
  bool any = false;
  for (int r = 0; r < kRows; ++r) any |= qpos_s[r] >= 0;
  const int nrows = min(kRows, R - r0);
  if (!any) {  // every row inactive: zeros, no page traffic
    for (int idx = tid; idx < nrows * HD; idx += kThreads) {
      const int row = r0 + idx / HD, d = idx % HD;
      store_out(out + (((size_t)b * Tq + row / G) * H + kh * G + row % G) * HD
                    + d, 0.f);
    }
    return;
  }

  for (int idx = tid; idx < kRows * CPR; idx += kThreads) {
    const int r = idx / CPR, c = idx % CPR, row = r0 + r;
    float f[VEC];
    if (row < R) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * Tq + row / G) * H + kh * G + row % G) * HD +
          c * VEC);
      to_f32<T>(raw, f);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) Q_s[r * (HD + 1) + c * VEC + j] = f[j];
  }

  const int col = tid % HD, rg = tid / HD;
  float acc[CPT][RPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[c][i] = 0.f;
  float m_run = kNegInf, l_run = 0.f;  // owned by thread tid == row < kRows

  for (int c0 = 0; c0 < ntok; c0 += kMChunk) {
    if (!chunk_has_pages(block_table, b, pmax, ps, c0,
                         min(c0 + kMChunk, ntok)))
      continue;
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < kMChunk * CPR; idx += kThreads) {
      const int t = idx / CPR, c = idx % CPR, n = c0 + t;
      const int pid = n < ntok ? block_table[b * pmax + n / ps] : 0;
      float kf[VEC], vf[VEC];
      if (pid != 0) {
        const size_t off = (((size_t)pid * ps + n % ps) * KH + kh) * HD +
                           c * VEC;
        to_f32<T>(*reinterpret_cast<const uint4*>(k_pages + off), kf);
        to_f32<T>(*reinterpret_cast<const uint4*>(v_pages + off), vf);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kf[j] = vf[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        K_s[t * HD + c * VEC + j] = kf[j];
        V_s[t * HD + c * VEC + j] = vf[j];
      }
    }
    for (int t = tid; t < kMChunk; t += kThreads) {
      const int n = c0 + t;
      const int pid = n < ntok ? block_table[b * pmax + n / ps] : 0;
      kpos_s[t] = pid != 0 ? kpos_pages[(size_t)pid * ps + n % ps] : -1;
    }
    __syncthreads();
    {  // scores: lane = query row, warp = TPW tokens
      const int w = tid / 32, lane = tid % 32;
      const float* qrow = Q_s + lane * (HD + 1);
      float s[TPW];
#pragma unroll
      for (int i = 0; i < TPW; ++i) s[i] = 0.f;
      for (int d = 0; d < HD; d += 4) {
        const float q0 = qrow[d], q1 = qrow[d + 1], q2 = qrow[d + 2],
                    q3 = qrow[d + 3];
#pragma unroll
        for (int i = 0; i < TPW; ++i) {
          const float4 kv =
              *reinterpret_cast<const float4*>(K_s + (w * TPW + i) * HD + d);
          s[i] = fmaf(q0, kv.x, s[i]);
          s[i] = fmaf(q1, kv.y, s[i]);
          s[i] = fmaf(q2, kv.z, s[i]);
          s[i] = fmaf(q3, kv.w, s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < TPW; ++i)
        S_s[lane * (kMChunk + 1) + w * TPW + i] = cap_score(s[i] * scale,
                                                            softcap);
    }
    __syncthreads();
    if (tid < kRows) {  // online softmax statistics, one thread per row
      const int r = tid, qp = qpos_s[r];
      float mx = m_run;
      for (int t = 0; t < kMChunk; ++t)
        if (key_valid(kpos_s[t], qp, window))
          mx = fmaxf(mx, S_s[r * (kMChunk + 1) + t]);
      float sum = 0.f;
      for (int t = 0; t < kMChunk; ++t) {
        const float p = key_valid(kpos_s[t], qp, window)
                            ? expf(S_s[r * (kMChunk + 1) + t] - mx) : 0.f;
        P_s[t * kRows + r] = p;
        sum += p;
      }
      const float alpha = expf(m_run - mx);
      l_run = l_run * alpha + sum;
      m_run = mx;
      alpha_s[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a = alpha_s[rg * RPT + i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c][i] *= a;
    }
    for (int t = 0; t < kMChunk; ++t) {
      float v[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) v[c] = V_s[t * HD + col + c * kThreads];
      const float* prow = P_s + t * kRows + rg * RPT;
#pragma unroll
      for (int i = 0; i < RPT; i += 4) {
        const float4 p = *reinterpret_cast<const float4*>(prow + i);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[c][i] = fmaf(p.x, v[c], acc[c][i]);
          acc[c][i + 1] = fmaf(p.y, v[c], acc[c][i + 1]);
          acc[c][i + 2] = fmaf(p.z, v[c], acc[c][i + 2]);
          acc[c][i + 3] = fmaf(p.w, v[c], acc[c][i + 3]);
        }
      }
    }
  }

  if (tid < kRows) l_s[tid] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i, row = r0 + r;
    if (row >= R) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = out + (((size_t)b * Tq + row / G) * H + kh * G + row % G) * HD;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store_out(orow + col + c * kThreads,
                                            acc[c][i] / l);
  }
}

template <typename T, int HD>
cudaError_t launch_multi(const void* q, const void* k, const void* v,
                         const int* kpos, const int* bt, const int* qpos,
                         void* out, int B, int Tq, int H, int KH, int ps,
                         int pmax, float scale, int window, float softcap,
                         cudaStream_t stream) {
  constexpr size_t smem = multi_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_multi_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = Tq * (H / KH);
  const dim3 grid((rows + kRows - 1) / kRows, KH, B);
  paged_multi_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kpos, bt, qpos, (T*)out, Tq, H,
      KH, ps, pmax, scale, window, softcap);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim in {32, 64, 128, 256}; H/KH
// <= 8 for the single-query kernel. Shapes as in ref.py; all tensors
// contiguous.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* kpos_pages, const void* block_table, const void* q_pos,
    void* out, int dtype, int B, int H, int KH, int hd, int ps, int pmax,
    float scale, int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kp = static_cast<const int*>(kpos_pages);
  const PagedRows rows{static_cast<const int*>(block_table), pmax, ps};
  const int* qp = static_cast<const int*>(q_pos);
  if (H % KH != 0 || H / KH > 8) return (int)cudaErrorInvalidValue;
#define DEC(T, HD)                                                         \
  return (int)launch_decode<T, HD>(q, k_pages, v_pages, kp, rows, qp, out, \
                                   B, H, KH, scale, window, softcap, s)
  if (dtype == 0) {
    if (hd == 32) DEC(float, 32);
    if (hd == 64) DEC(float, 64);
    if (hd == 128) DEC(float, 128);
    if (hd == 256) DEC(float, 256);
  } else if (dtype == 1) {
    if (hd == 32) DEC(__nv_bfloat16, 32);
    if (hd == 64) DEC(__nv_bfloat16, 64);
    if (hd == 128) DEC(__nv_bfloat16, 128);
    if (hd == 256) DEC(__nv_bfloat16, 256);
  }
#undef DEC
  return (int)cudaErrorInvalidValue;
}

extern "C" int paged_decode_attention_multi_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* kpos_pages, const void* block_table, const void* q_pos,
    void* out, int dtype, int B, int T, int H, int KH, int hd, int ps,
    int pmax, float scale, int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kp = static_cast<const int*>(kpos_pages);
  const int* bt = static_cast<const int*>(block_table);
  const int* qp = static_cast<const int*>(q_pos);
  if (H % KH != 0) return (int)cudaErrorInvalidValue;
#define MULTI(T_, HD)                                                        \
  return (int)launch_multi<T_, HD>(q, k_pages, v_pages, kp, bt, qp, out, B, \
                                   T, H, KH, ps, pmax, scale, window,        \
                                   softcap, s)
  if (dtype == 0) {
    if (hd == 32) MULTI(float, 32);
    if (hd == 64) MULTI(float, 64);
    if (hd == 128) MULTI(float, 128);
    if (hd == 256) MULTI(float, 256);
  } else if (dtype == 1) {
    if (hd == 32) MULTI(__nv_bfloat16, 32);
    if (hd == 64) MULTI(__nv_bfloat16, 64);
    if (hd == 128) MULTI(__nv_bfloat16, 128);
    if (hd == 256) MULTI(__nv_bfloat16, 256);
  }
#undef MULTI
  return (int)cudaErrorInvalidValue;
}
