// Blocked flash attention over full sequences, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/flash_attention.py: flash_attention (_fa_kernel).
//
// Semantics (the plain PyTorch version is repro_torch/kernels/ref.py
// flash_attention_ref): q (B, S, H, hd); k/v (B, S, KH, hd), float32 or
// bfloat16; out like q. Query head h = kh*G + g reads KV head kh (G =
// H/KH). Scores are q.k in float32, scaled by hd^-0.5, soft-capped, then
// masked: key j is valid for the query at position i when j < S, j <= i
// under causal, and j > i - window when a window is set. Masked keys get
// probability exactly 0 and the softmax denominator is floored at 1e-30.
// Unlike the Pallas kernel, which pads K/V with zeros to a multiple of its
// block and lets the padded keys into a non-causal softmax, keys at
// positions >= S never count here.
//
// Layout: the G query heads of one KV head share every K/V tile. For a
// (sequence b, KV head kh) the S*G query rows are flattened as row =
// position*G + g, and one block of kThreads threads takes kBM of them
// (kBM/G positions), so a K/V tile loaded into shared memory serves the
// whole query group. The block walks the keys its rows can see in tiles
// of kBN: from the first position's window start (0 without a window) to
// its last position under causal (S otherwise), so tiles that the causal
// or window mask fully masks are never loaded, as the Pallas kernel's
// block pruning does. Heavier tiles (later positions) are scheduled first.
//
// Per key tile, with the rows' running max and sum kept in float32:
//   scores  S = Q K^T: lane = query row, warp = 8 keys (K reads broadcast,
//           Q rows padded to HD+1 floats so lanes hit distinct banks);
//   softmax one warp per 8 rows, lane = key: warp max and sum, the tile's
//           probabilities written transposed for the next phase;
//   P V     thread = one output column and kBM*HD/kThreads rows, V reads
//           on neighbouring addresses, P reads broadcast as float4.
//
// What bounds it: at the path's shapes attention is operations-bound on
// the tensor cores (the bound counts the (query head, key) pairs the mask
// lets through at the bf16 tensor-core rate). This first version computes
// in float32 on the CUDA cores (FMA) out of shared memory, so it runs at a
// small share of that bound; tensor cores (wgmma), TMA and a pipelined
// K/V ring are left for later work.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include "flash_decode.cuh"

namespace {

using flash_decode::cap_score;
using flash_decode::kNegInf;
using flash_decode::store_out;
using flash_decode::to_f32;

constexpr int kBM = 64;              // query rows ((position, head) pairs)
constexpr int kBN = 32;              // keys per tile: one per lane
constexpr int kThreads = 256;        // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kBM / kWarps;   // softmax rows per warp
constexpr int kKeysPerWarp = kBN / 4;        // score keys per warp
constexpr int kPStride = kBM + 4;    // floats per transposed P row

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBM * (HD + 1)       // Q
                          + 2 * (size_t)kBN * HD       // K, V
                          + kBM * (kBN + 1)            // scores
                          + kBN * kPStride             // P, transposed
                          + 2 * kBM);                  // alpha, l
}

// Store 16 bytes' worth of converted elements as float4s.
template <int VEC>
__device__ __forceinline__ void put4(float* dst, const float* f) {
#pragma unroll
  for (int u = 0; u < VEC; u += 4)
    *reinterpret_cast<float4*>(dst + u) =
        make_float4(f[u], f[u + 1], f[u + 2], f[u + 3]);
}

// One block per (tile of kBM query rows, KV head, sequence).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int H, int KH,
    float scale, int causal, int window, float softcap) {
  constexpr int VEC = 16 / sizeof(T);         // elements per 16-byte vector
  constexpr int CPR = HD / VEC;               // vectors per row
  constexpr int NRG = kThreads / HD;          // row groups in P V
  constexpr int RPT = kBM / NRG;              // rows per thread in P V
  static_assert(kThreads % HD == 0 && RPT % 4 == 0, "P V tiling");
  static_assert(kBM == 2 * 32 && kWarps == 8, "score tiling");

  extern __shared__ float4 smem4[];
  float* Q_s = reinterpret_cast<float*>(smem4);    // kBM x (HD+1)
  float* K_s = Q_s + kBM * (HD + 1);               // kBN x HD
  float* V_s = K_s + kBN * HD;                     // kBN x HD
  float* S_s = V_s + kBN * HD;                     // kBM x (kBN+1)
  float* P_s = S_s + kBM * (kBN + 1);              // kBN x kPStride
  float* alpha_s = P_s + kBN * kPStride;           // kBM
  float* l_s = alpha_s + kBM;                      // kBM

  const int G = H / KH;
  const int R = S * G;                             // rows of (b, kh)
  const int tile = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int kh = blockIdx.y, b = blockIdx.z;
  const int r0 = tile * kBM;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // the keys this block's rows can see: [k_begin, k_end)
  const int p_first = r0 / G;
  const int p_last = (min(r0 + kBM, R) - 1) / G;
  const int k_end = causal ? min(p_last + 1, S) : S;
  const int k_begin =
      window > 0 ? max(0, p_first - window + 1) / kBN * kBN : 0;

  for (int idx = tid; idx < kBM * CPR; idx += kThreads) {
    const int r = idx / CPR, c = idx % CPR, row = r0 + r;
    float f[VEC];
    if (row < R) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * S + row / G) * H + kh * G + row % G) * HD +
          c * VEC);
      to_f32<T>(raw, f);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) Q_s[r * (HD + 1) + c * VEC + j] = f[j];
  }

  const int col = tid % HD, rg = tid / HD;         // P V ownership
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];  // rows warp*8 + i
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }

  for (int c0 = k_begin; c0 < k_end; c0 += kBN) {
    __syncthreads();  // Q is written; the previous tile's readers are done
    for (int idx = tid; idx < kBN * CPR; idx += kThreads) {
      const int t = idx / CPR, c = idx % CPR, key = c0 + t;
      float kf[VEC], vf[VEC];
      if (key < S) {
        const size_t off = (((size_t)b * S + key) * KH + kh) * HD + c * VEC;
        to_f32<T>(*reinterpret_cast<const uint4*>(k + off), kf);
        to_f32<T>(*reinterpret_cast<const uint4*>(v + off), vf);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kf[j] = vf[j] = 0.f;
      }
      put4<VEC>(K_s + t * HD + c * VEC, kf);
      put4<VEC>(V_s + t * HD + c * VEC, vf);
    }
    __syncthreads();
    {  // scores: lane = row of this warp's half, 8 keys per warp
      const int r = (warp / 4) * 32 + lane, t0 = (warp % 4) * kKeysPerWarp;
      const float* qrow = Q_s + r * (HD + 1);
      float s[kKeysPerWarp];
#pragma unroll
      for (int i = 0; i < kKeysPerWarp; ++i) s[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        const float q0 = qrow[d], q1 = qrow[d + 1], q2 = qrow[d + 2],
                    q3 = qrow[d + 3];
#pragma unroll
        for (int i = 0; i < kKeysPerWarp; ++i) {
          const float4 kv =
              *reinterpret_cast<const float4*>(K_s + (t0 + i) * HD + d);
          s[i] = fmaf(q0, kv.x, s[i]);
          s[i] = fmaf(q1, kv.y, s[i]);
          s[i] = fmaf(q2, kv.z, s[i]);
          s[i] = fmaf(q3, kv.w, s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kKeysPerWarp; ++i)
        S_s[r * (kBN + 1) + t0 + i] = cap_score(s[i] * scale, softcap);
    }
    __syncthreads();
    {  // online softmax: one warp per 8 rows, lane = key
      const int key = c0 + lane;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp * kRowsPerWarp + i, row = r0 + r, pos = row / G;
        const bool ok = row < R && key < S && (!causal || key <= pos) &&
                        (window == 0 || key > pos - window);
        const float sc = S_s[r * (kBN + 1) + lane];
        float mx = ok ? sc : kNegInf;
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[i], mx);
        const float p = ok ? expf(sc - m_new) : 0.f;
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float alpha = expf(m_run[i] - m_new);
        l_run[i] = l_run[i] * alpha + sum;
        m_run[i] = m_new;
        P_s[lane * kPStride + r] = p;
        if (lane == 0) alpha_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] *= alpha_s[rg * RPT + i];
#pragma unroll 4
    for (int t = 0; t < kBN; ++t) {
      const float vv = V_s[t * HD + col];
      const float* prow = P_s + t * kPStride + rg * RPT;
#pragma unroll
      for (int i = 0; i < RPT; i += 4) {
        const float4 p = *reinterpret_cast<const float4*>(prow + i);
        acc[i] = fmaf(p.x, vv, acc[i]);
        acc[i + 1] = fmaf(p.y, vv, acc[i + 1]);
        acc[i + 2] = fmaf(p.z, vv, acc[i + 2]);
        acc[i + 3] = fmaf(p.w, vv, acc[i + 3]);
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      l_s[warp * kRowsPerWarp + i] = l_run[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i, row = r0 + r;
    if (row >= R) continue;
    store_out(out + (((size_t)b * S + row / G) * H + kh * G + row % G) * HD
                  + col,
              acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KH, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = S * (H / KH);
  const dim3 grid((rows + kBM - 1) / kBM, KH, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, KH, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim in {32, 64, 128, 256}; H a
// multiple of KH; S >= 1. Shapes as above; all tensors contiguous.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int S, int H, int KH, int hd,
                                      float scale, int causal, int window,
                                      float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
#define FA(T, HD)                                                        \
  return (int)launch<T, HD>(q, k, v, out, B, S, H, KH, scale, causal,    \
                            window, softcap, s)
  if (dtype == 0) {
    if (hd == 32) FA(float, 32);
    if (hd == 64) FA(float, 64);
    if (hd == 128) FA(float, 128);
    if (hd == 256) FA(float, 256);
  } else if (dtype == 1) {
    if (hd == 32) FA(__nv_bfloat16, 32);
    if (hd == 64) FA(__nv_bfloat16, 64);
    if (hd == 128) FA(__nv_bfloat16, 128);
    if (hd == 256) FA(__nv_bfloat16, 256);
  }
#undef FA
  return (int)cudaErrorInvalidValue;
}
