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
// position*G + g, and one block takes a tile of them, so a K/V tile
// loaded into shared memory serves the whole query group. The block walks
// the keys its rows can see: from the first position's window start (0
// without a window) to its last position under causal (S otherwise), so
// tiles that the causal or window mask fully masks are never loaded, as
// the Pallas kernel's block pruning does; the elementwise mask runs only
// on tiles that cut the diagonal, the window edge or S. Heavier tiles
// (later positions) are scheduled first.
//
// The kernel is chosen by dtype, at the C entry:
//
// bfloat16 -> flash_attention_tc_kernel, on the tensor cores. What bounds
//   it: at the path's shapes attention is operations-bound on the tensor
//   cores (the bound counts the (query head, key) pairs the mask lets
//   through at the bf16 rate; at 8 x 512 and hd <= 128 the bytes of q,
//   k, v and out weigh more). The design (tc_attention.cuh): 128 query
//   rows per block in two consumer warpgroups and a producer warpgroup
//   that gives them its registers (setmaxnreg), Q K^T and P V by wgmma
//   with bf16 operands and float32 accumulators, P rounded to bf16 in
//   registers, and a ring of 2 (hd >= 128) or 4 K/V stages in shared
//   memory filled by TMA from one producer thread: a 4-D tensor map over
//   (hd, KH, S, B) per tensor, 128-byte swizzle (64-byte at hd 32), so a
//   tile that runs past S is zero-filled by the hardware and masked by
//   j < S. The map is encoded on the host with cuTensorMapEncodeTiled,
//   looked up in libcuda at run time through cudaGetDriverEntryPoint, so
//   the build needs no -lcuda.
//   Within a warpgroup, a tile's Q K^T is issued with the previous
//   tile's P V, and its softmax runs while that P V finishes. What it
//   leaves: the softmax (with the accurate tanhf of the softcap) and
//   the products still overlap only in part; at 8 x 512 a block sees a
//   few key tiles, so the ring never fills and its latencies, not the
//   products, set the time; the output is stored from registers 4 bytes
//   at a time.
//
// float32 -> flash_attention_kernel, on the CUDA cores, unchanged: tensor
//   cores cannot hold float32 to the 1e-5 the card's float32 model and
//   training checks use. Per key tile of 32, with the rows' running max
//   and sum in float32: scores S = Q K^T with lane = query row and warp =
//   8 keys; softmax one warp per 8 rows, lane = key; P V with thread =
//   one output column. K/V are staged as float32 in shared memory with a
//   __syncthreads() between loading and computing.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up
                    // in libcuda at run time

#include "flash_decode.cuh"
#include "tc_attention.cuh"

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

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel (tc_attention.cuh)
// ---------------------------------------------------------------------------
constexpr int kTcGroups = 2;   // consumer warpgroups: 128 query rows a block
constexpr int kTcProducerRegs = 24;   // one thread issuing TMA

// The key tiles of one block: [k_begin, k_end) in tiles of BN, and, for
// one consumer warpgroup, which of them its rows see and which need the
// elementwise mask.
template <int BN>
struct FlashTiles {
  int k_begin, S, causal, window;
  int wp_first, wp_last;   // positions of the warpgroup's rows
  int pos[2];              // positions of the thread's two rows
  __device__ int key0(int it) const { return k_begin + it * BN; }
  __device__ bool visible(int c0) const {
    return wp_first <= wp_last && c0 < (causal ? wp_last + 1 : S) &&
           (window == 0 || c0 + BN > wp_first - window + 1);
  }
  __device__ bool needs_mask(int, int c0) const {
    return c0 + BN > S || (causal && c0 + BN - 1 > wp_first) ||
           (window != 0 && c0 <= wp_last - window);
  }
  __device__ bool valid(int c0, int, int col, int r) const {
    const int j = c0 + col;
    return j < S && (!causal || j <= pos[r]) &&
           (window == 0 || j > pos[r] - window);
  }
};

// One block per (tile of 128 query rows, KV head, sequence).
template <int HD>
__global__ void __launch_bounds__(tc::Smem<HD, kTcGroups>::kThreads, 1)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __nv_bfloat16* __restrict__ q,
                              __nv_bfloat16* __restrict__ out, int S, int H,
                              int KH, float scale, int causal, int window,
                              float softcap) {
  using C = tc::Cfg<HD>;
  using L = tc::Smem<HD, kTcGroups>;
  constexpr int BN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = tc::align1024(smem_raw);
  const uint32_t base = tc::smem_u32(sm);

  const int G = H / KH, R = S * G;
  const int tile = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const tc::Rows rows{(int)blockIdx.z, (int)blockIdx.y, G, H, S, R,
                      tile * L::kRows};
  const int p_first = rows.r0 / G;
  const int p_last = (min(rows.r0 + L::kRows, R) - 1) / G;
  const int k_end = causal ? min(p_last + 1, S) : S;
  const int k_begin = window > 0 ? max(0, p_first - window + 1) / BN * BN : 0;
  const int ntiles = (k_end - k_begin + BN - 1) / BN;
  const int warp = tc::warp_uniform(threadIdx.x / 32);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) tc::init_barriers<HD, kTcGroups>(base, 1, 1);
  __syncthreads();

  if (warp >= 4 * kTcGroups) {          // producer: one thread issues TMA
    tc::producer_regs<kTcGroups, kTcProducerRegs>();
    if (warp != 4 * kTcGroups || lane != 0) return;
    for (int it = 0; it < ntiles; ++it) {
      const int stage = it % C::kStages, c0 = k_begin + it * BN;
#pragma unroll
      for (int v = 0; v < 2; ++v) {       // K, then V
        if (it >= C::kStages)
          tc::mbar_wait(L::empty(base, v, stage), (it / C::kStages - 1) & 1);
        const uint32_t full = L::full(base, v, stage);
        const uint32_t dst =
            v ? L::v_tile(base, stage) : L::k_tile(base, stage);
        const uint64_t map = reinterpret_cast<uint64_t>(v ? &tm_v : &tm_k);
        tc::mbar_expect_tx(full, C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          asm volatile(
              "cp.async.bulk.tensor.4d.shared::cluster.global"
              ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
              "[%6];\n" ::"r"(dst + c * BN * C::kRowBytes), "l"(map),
              "r"(c * C::kChunkCols), "r"(rows.kh), "r"(c0), "r"(rows.b),
              "r"(full) : "memory");
      }
    }
    return;
  }

  tc::consumer_regs<kTcGroups, kTcProducerRegs>();
  const int wg = warp / 4;
  tc::load_q<HD, kTcGroups>(sm, q, rows, wg, threadIdx.x % 128);
  FlashTiles<BN> tiles;
  tiles.k_begin = k_begin;
  tiles.S = S;
  tiles.causal = causal;
  tiles.window = window;
  const int wr0 = rows.r0 + wg * 64;
  tiles.wp_first = wr0 / G;
  tiles.wp_last = wr0 < R ? (min(wr0 + 64, R) - 1) / G : -1;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    tiles.pos[r] = (wr0 + 16 * (warp % 4) + lane / 4 + 8 * r) / G;
  float o[HD / 2], l[2];
  tc::consume<HD, kTcGroups>(sm, wg, ntiles, tiles, scale, softcap, o, l);
  tc::store_rows<HD>(out, rows, wg, o, l);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The tensor map of k or v (B, S, KH, HD) as (HD, KH, S, B): a box of one
// swizzle chunk of columns x BN keys of one (KV head, sequence).
template <int HD>
bool kv_map(CUtensorMap* map, const void* ptr, int B, int S, int KH) {
  using C = tc::Cfg<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)KH, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)KH * HD * 2,
                                 (cuuint64_t)S * KH * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::kChunkCols, 1, (cuuint32_t)C::kBN,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int H, int KH, float scale, int causal,
                      int window, float softcap, cudaStream_t stream) {
  using L = tc::Smem<HD, kTcGroups>;
  CUtensorMap tm_k, tm_v;
  if (!kv_map<HD>(&tm_k, k, B, S, KH) || !kv_map<HD>(&tm_v, v, B, S, KH))
    return cudaErrorInvalidValue;
  constexpr int smem = L::kExtra + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = S * (H / KH);
  const dim3 grid((rows + L::kRows - 1) / L::kRows, KH, B);
  flash_attention_tc_kernel<HD><<<grid, L::kThreads, smem, stream>>>(
      tm_k, tm_v, (const __nv_bfloat16*)q, (__nv_bfloat16*)out, S, H, KH,
      scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). head_dim
// in {32, 64, 128, 256}; H a multiple of KH; S >= 1. Shapes as above; all
// tensors contiguous and 16-byte aligned.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int S, int H, int KH, int hd,
                                      float scale, int causal, int window,
                                      float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
#define FA(HD) \
  return (int)launch<float, HD>(q, k, v, out, B, S, H, KH, scale, causal, \
                                window, softcap, s)
#define TC(HD) \
  return (int)launch_tc<HD>(q, k, v, out, B, S, H, KH, scale, causal, \
                            window, softcap, s)
  if (dtype == 0) {
    if (hd == 32) FA(32);
    if (hd == 64) FA(64);
    if (hd == 128) FA(128);
    if (hd == 256) FA(256);
  } else if (dtype == 1) {
    if (hd == 32) TC(32);
    if (hd == 64) TC(64);
    if (hd == 128) TC(128);
    if (hd == 256) TC(256);
  }
#undef TC
#undef FA
  return (int)cudaErrorInvalidValue;
}
