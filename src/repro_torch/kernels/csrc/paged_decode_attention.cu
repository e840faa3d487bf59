// Flash-decode over a paged KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the reference package,
// src/repro/kernels/paged_decode_attention.py:
//   paged_decode_attention        (_paged_kernel)       -> paged_decode_kernel
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
// the K and V rows of a whole 64-token chunk are issued before any of
// them is used (so many loads are in flight per block), and null pages
// are skipped without a load. The multi-query kernel streams each page
// once per tile of 32 query rows for a chunk of T queries; a tile whose
// rows are all inactive (q_pos = -1, most slots of a prefill batch)
// writes zeros and returns at once. Its dot products run on plain FMA in
// float32 from shared memory; tensor cores (wgmma), TMA and splitting the
// pages of one sequence over several blocks are left for later work.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30
constexpr int kThreads = 128;
constexpr int kChunk = 64;     // decode: tokens per chunk
constexpr int kRows = 32;      // multi: query rows per tile (one per lane)
constexpr int kMChunk = 32;    // multi: tokens per chunk

template <typename T>
__device__ __forceinline__ void to_f32(const uint4& raw, float* out);

template <>
__device__ __forceinline__ void to_f32<float>(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void to_f32<__nv_bfloat16>(const uint4& raw,
                                                      float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float cap_score(float s, float softcap) {
  return softcap != 0.f ? tanhf(s / softcap) * softcap : s;
}

__device__ __forceinline__ bool key_valid(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window == 0 || kp > qp - window);
}

// True when some page overlapping tokens [c0, c1) of row b is not the null
// page. Uniform across the block.
__device__ __forceinline__ bool chunk_has_pages(const int* bt, int b, int pmax,
                                                int ps, int c0, int c1) {
  for (int lp = c0 / ps; lp * ps < c1; ++lp)
    if (bt[b * pmax + lp] != 0) return true;
  return false;
}

// ---------------------------------------------------------------------------
// Single query per sequence: one block per (KV head, sequence).
// Threads form groups of TPR = HD/VEC lanes; a group owns one token row at a
// time (each lane a 16-byte slice), so a warp covers 32/TPR tokens at once.
// ---------------------------------------------------------------------------
template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ kpos_pages,
    const int* __restrict__ block_table, const int* __restrict__ q_pos,
    T* __restrict__ out, int H, int KH, int ps, int pmax, float scale,
    int window, float softcap) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TPR = HD / VEC;
  constexpr int NGRP = kThreads / TPR;
  constexpr int TPG = kChunk / NGRP;
  static_assert(TPR >= 1 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "TPR");
  static_assert(kChunk % NGRP == 0, "chunk");

  __shared__ float s_sm[GMAX][kChunk];
  __shared__ float p_sm[GMAX][kChunk];
  __shared__ unsigned char valid_sm[kChunk];
  __shared__ float alpha_sm[GMAX];
  __shared__ float l_sm[GMAX];
  __shared__ float red[kThreads * VEC];  // == NGRP * HD

  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / KH;
  const int tid = threadIdx.x, grp = tid / TPR, li = tid % TPR;
  const int qp = q_pos[b];
  const int ntok = pmax * ps;

  float qr[GMAX][VEC];
  float acc[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + ((size_t)b * H + kh * G + g) * HD + li * VEC);
      to_f32<T>(raw, qr[g]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) qr[g][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;
  }
  float m_run = kNegInf, l_run = 0.f;  // owned by thread tid == g < G

  for (int c0 = 0; c0 < ntok; c0 += kChunk) {
    if (!chunk_has_pages(block_table, b, pmax, ps, c0, min(c0 + kChunk, ntok)))
      continue;
    // issue every K and V load of this group's tokens before using any
    uint4 kr[TPG], vr[TPG];
    bool ok[TPG];
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      const int n = c0 + grp + i * NGRP;
      kr[i] = make_uint4(0, 0, 0, 0);
      vr[i] = make_uint4(0, 0, 0, 0);
      ok[i] = false;
      if (n < ntok) {
        const int pid = block_table[b * pmax + n / ps];
        if (pid != 0) {
          const size_t slot = (size_t)pid * ps + n % ps;
          if (key_valid(kpos_pages[slot], qp, window)) {
            ok[i] = true;
            const size_t off = (slot * KH + kh) * HD + li * VEC;
            kr[i] = *reinterpret_cast<const uint4*>(k_pages + off);
            vr[i] = *reinterpret_cast<const uint4*>(v_pages + off);
          }
        }
      }
    }
    // scores: G dot products per token, reduced over the group's lanes
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      float kf[VEC];
      to_f32<T>(kr[i], kf);
      float s[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        s[g] = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[g] = fmaf(qr[g][j], kf[j], s[g]);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
      if (li == 0) {
        const int t = grp + i * NGRP;
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) s_sm[g][t] = ok[i] ? cap_score(s[g] * scale, softcap)
                                        : kNegInf;
        valid_sm[t] = ok[i];
      }
    }
    __syncthreads();
    // online softmax statistics, one thread per query head
    if (tid < G) {
      const int g = tid;
      float mx = m_run;
      for (int t = 0; t < kChunk; ++t)
        if (valid_sm[t]) mx = fmaxf(mx, s_sm[g][t]);
      float sum = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        const float p = valid_sm[t] ? expf(s_sm[g][t] - mx) : 0.f;
        p_sm[g][t] = p;
        sum += p;
      }
      const float alpha = expf(m_run - mx);
      l_run = l_run * alpha + sum;
      m_run = mx;
      alpha_sm[g] = alpha;
    }
    __syncthreads();
    // rescale and accumulate P @ V over this group's tokens
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float a = alpha_sm[g];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] *= a;
      }
    }
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      if (!ok[i]) continue;
      const int t = grp + i * NGRP;
      float vf[VEC];
      to_f32<T>(vr[i], vf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float p = p_sm[g][t];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[g][j] = fmaf(p, vf[j], acc[g][j]);
        }
      }
    }
  }

  // sum the groups' partial accumulators, one query head at a time
  if (tid < G) l_sm[tid] = l_run;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[grp * HD + li * VEC + j] = acc[g][j];
    __syncthreads();
    const float l = fmaxf(l_sm[g], 1e-30f);
    for (int d = tid; d < HD; d += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int gi = 0; gi < NGRP; ++gi) sum += red[gi * HD + d];
      store_out(out + ((size_t)b * H + kh * G + g) * HD + d, sum / l);
    }
  }
}

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
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* kpos, const int* bt, const int* qpos,
                          void* out, int B, int H, int KH, int ps, int pmax,
                          float scale, int window, float softcap,
                          cudaStream_t stream) {
  const dim3 grid(KH, B);
  if (H / KH <= 4)
    paged_decode_kernel<T, HD, 4><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, kpos, bt, qpos, (T*)out, H, KH,
        ps, pmax, scale, window, softcap);
  else
    paged_decode_kernel<T, HD, 8><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, kpos, bt, qpos, (T*)out, H, KH,
        ps, pmax, scale, window, softcap);
  return cudaGetLastError();
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

// dtype: 0 = float32, 1 = bfloat16. head_dim in {32, 64, 128}; H/KH <= 8 for
// the single-query kernel. Shapes as in ref.py; all tensors contiguous.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* kpos_pages, const void* block_table, const void* q_pos,
    void* out, int dtype, int B, int H, int KH, int hd, int ps, int pmax,
    float scale, int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kp = static_cast<const int*>(kpos_pages);
  const int* bt = static_cast<const int*>(block_table);
  const int* qp = static_cast<const int*>(q_pos);
  if (H % KH != 0 || H / KH > 8) return (int)cudaErrorInvalidValue;
#define DEC(T, HD)                                                          \
  return (int)launch_decode<T, HD>(q, k_pages, v_pages, kp, bt, qp, out, B, \
                                   H, KH, ps, pmax, scale, window, softcap, s)
  if (dtype == 0) {
    if (hd == 32) DEC(float, 32);
    if (hd == 64) DEC(float, 64);
    if (hd == 128) DEC(float, 128);
  } else if (dtype == 1) {
    if (hd == 32) DEC(__nv_bfloat16, 32);
    if (hd == 64) DEC(__nv_bfloat16, 64);
    if (hd == 128) DEC(__nv_bfloat16, 128);
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
  } else if (dtype == 1) {
    if (hd == 32) MULTI(__nv_bfloat16, 32);
    if (hd == 64) MULTI(__nv_bfloat16, 64);
    if (hd == 128) MULTI(__nv_bfloat16, 128);
  }
#undef MULTI
  return (int)cudaErrorInvalidValue;
}
