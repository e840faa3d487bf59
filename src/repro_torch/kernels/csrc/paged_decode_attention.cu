// Flash-decode over a paged KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the reference package,
// src/repro/kernels/paged_decode_attention.py:
//   paged_decode_attention        (_paged_kernel)       -> decode_kernel
//                                   over PagedRows (flash_decode.cuh)
//   paged_decode_attention_multi  (_paged_multi_kernel) ->
//       paged_multi_tc_kernel (bfloat16), paged_multi_kernel (float32)
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
// paged_decode_attention (one query per sequence). What bounds it:
// memory. Decode reads every valid K/V row of the pages once per
// (sequence, KV head) and does 4 operations per K/V element per query
// head, far below the card's ~295 operations-a-byte ridge. The design is
// flash_decode.cuh's: each (KV head, sequence) row is split over a
// thread-block cluster; each CTA stages the block-table row in shared
// memory, scans the kpos of its share of the tokens (a null page is
// skipped without reading its kpos) and lists the valid slots before
// loading any K/V row, streams the listed rows through a per-warp cp.async
// ring with no block-wide barrier per tile, and the CTAs merge their
// partial softmax states through distributed shared memory: one launch,
// no workspace.
//
// paged_decode_attention_multi (T queries per sequence, the prefill
// chunk). The kernel is chosen by dtype, at the C entry:
//
// bfloat16 -> paged_multi_tc_kernel, on the tensor cores. What bounds it:
//   at a prefill chunk's shape (T = 256) operations on the tensor cores;
//   at T = 8 the bytes of the pages. The design (tc_attention.cuh): one
//   block per (tile of 64 or 128 query rows, KV head, sequence), one
//   consumer warpgroup per 64 rows (one when T*G <= 64), Q K^T and P V by
//   wgmma with bf16 operands and float32 accumulators, P rounded to bf16
//   in registers. The producer warpgroup gathers each key tile through the
//   block table with 16-byte cp.async per thread (any page size: a tile
//   spans several pages) into the same swizzled ring of 2 (hd >= 128) or
//   4 stages, with the tile's kpos beside it; each copy arrives on its
//   stage's mbarrier when it lands (cp.async.mbarrier.arrive), so the
//   producer runs ahead and one tile's gather overlaps the consumers'
//   wgmma on the tiles before it. The null page is never
//   read (cp.async with a source size of 0 writes zeros). Before any K/V
//   is loaded, the block lists the key tiles that some row may see: a
//   tile whose kpos are all -1 or all past the row tile's largest q_pos
//   (or, with a window, all at or before its smallest q_pos - window) is
//   skipped. A row tile whose rows are all inactive (q_pos = -1, most
//   slots of a prefill batch) writes zeros and returns before any of
//   that; a warpgroup whose 64 rows are all inactive skips the math. The
//   mask is the position mask (kpos >= 0 && kpos <= q_pos, and the
//   window) on the kpos copied beside K/V, applied only to tiles that
//   some row sees in part (the block table is staged in shared memory and
//   each live tile's kpos range noted while the tiles are listed). What
//   it leaves: as in flash_attention.cu; and the gather (two producer
//   threads a key row, 16 bytes a copy) is still a large share of the
//   time at T = 256.
//
// float32 -> paged_multi_kernel, on the CUDA cores, unchanged: K/V chunks
//   of 32 tokens staged as float32 in shared memory for a tile of 32
//   query rows, plain FMA, chunks of null pages skipped. Tensor cores
//   cannot hold float32 to the card's 1e-5 float32 checks.
//
// Plain C interface for ctypes; each entry returns a CUDA error code.

#include "flash_decode.cuh"
#include "tc_attention.cuh"

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
// sequence b is slot n % ps of page block_table[b][n / ps], the block-table
// row being staged in shared memory; the null page is never read.
struct PagedRows {
  const int* bt;
  int pmax, ps;
  __host__ __device__ int staged() const { return pmax; }
  __device__ void stage(int b, int* s) const {
    for (int i = threadIdx.x; i < pmax; i += blockDim.x)
      s[i] = bt[(size_t)b * pmax + i];
  }
  __device__ int ntok(int) const { return pmax * ps; }
  __device__ int slot(int, int n, const int* s) const {
    const int pid = s[n / ps];
    return pid != 0 ? pid * ps + n % ps : -1;
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

// ---------------------------------------------------------------------------
// bfloat16 multi-query: the tensor-core kernel (tc_attention.cuh)
// ---------------------------------------------------------------------------

// The block's live key tiles (a list in shared memory) and, for one
// consumer warpgroup, the position mask on the kpos staged beside K/V.
// A list entry is the tile's index, with bit kMaskBit + w set when
// warpgroup w needs the elementwise mask on it: a tile whose keys are all
// valid (kpos >= 0), none past the smallest q_pos of the warpgroup's rows
// (-1 for an inactive row) and, with a window, none at or before the
// largest q_pos - window, needs none.
constexpr int kMaskBit = 29;

template <int BN, int STAGES>
struct PagedTiles {
  const int* list;       // the ring's kpos (STAGES x BN) end BN ints before
  int window, mask_bit;
  bool active;           // some row of the warpgroup has q_pos >= 0
  int qp[2];             // q_pos of the thread's two rows
  __device__ int key0(int it) const {
    return (list[it] & ((1 << kMaskBit) - 1)) * BN;
  }
  __device__ bool visible(int) const { return active; }
  __device__ bool needs_mask(int it, int) const {
    return list[it] & mask_bit;
  }
  __device__ bool valid(int, int stage, int col, int r) const {
    return key_valid(list[(stage - STAGES - 1) * BN + col], qp[r], window);
  }
};

// Bytes of the caller's region after the ring: q_pos of the rows, the
// ring's kpos, the producer's page slots, the live-tile list and each
// tile's kpos range, and the sequence's block-table row.
template <int HD, int NWG>
constexpr size_t multi_tc_smem_bytes(int ntiles, int pmax) {
  using C = tc::Cfg<HD>;
  return tc::Smem<HD, NWG>::kExtra + 1024 +
         sizeof(int) * (NWG * 64 + (C::kStages + 1) * C::kBN + 3 * ntiles +
                        pmax);
}

constexpr int kProducerBarrier = 15;   // named barrier of the producer
constexpr int kProducerRegs = 56;      // its registers (setmaxnreg)

// One block per (tile of NWG*64 query rows, KV head, sequence).
template <int HD, int NWG>
__global__ void __launch_bounds__(tc::Smem<HD, NWG>::kThreads, 1)
    paged_multi_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k_pages,
                          const __nv_bfloat16* __restrict__ v_pages,
                          const int* __restrict__ kpos_pages,
                          const int* __restrict__ block_table,
                          const int* __restrict__ q_pos,
                          __nv_bfloat16* __restrict__ out, int Tq, int H,
                          int KH, int ps, int pmax, float scale, int window,
                          float softcap) {
  using C = tc::Cfg<HD>;
  using L = tc::Smem<HD, NWG>;
  constexpr int BN = C::kBN, NT = L::kThreads, CH = HD / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = tc::align1024(smem_raw);
  const uint32_t base = tc::smem_u32(sm);
  const int G = H / KH, R = Tq * G;
  const tc::Rows rows{(int)blockIdx.z, (int)blockIdx.y, G, H, Tq, R,
                      (int)blockIdx.x * L::kRows};
  const int b = rows.b, kh = rows.kh, tid = threadIdx.x;
  const int ntok = pmax * ps, ntiles = (ntok + BN - 1) / BN;
  int* qpos_s = reinterpret_cast<int*>(sm + L::kExtra);  // kRows
  int* kpos_s = qpos_s + L::kRows;                        // kStages x BN
  int* slot_s = kpos_s + C::kStages * BN;                 // BN
  int* list_s = slot_s + BN;                              // ntiles
  int* kmin_s = list_s + ntiles;                          // ntiles
  int* kmax_s = kmin_s + ntiles;                          // ntiles
  int* bt_s = kmax_s + ntiles;                            // pmax
  __shared__ int max_qp, min_qp, nlive, wq_min[NWG], wq_max[NWG];

  if (tid == 0) {
    max_qp = -1;
    min_qp = 0x7fffffff;
  }
  if (tid < NWG) {             // per consumer warpgroup, inactive rows -1
    wq_min[tid] = 0x7fffffff;
    wq_max[tid] = -1;
  }
  for (int t = tid; t < ntiles; t += NT) {
    list_s[t] = 0;
    kmin_s[t] = (t + 1) * BN > ntok ? -1 : 0x7fffffff;  // keys past ntok
    kmax_s[t] = -1;
  }
  for (int p = tid; p < pmax; p += NT)
    bt_s[p] = block_table[(size_t)b * pmax + p];
  __syncthreads();
  for (int r = tid; r < L::kRows; r += NT) {
    const int row = rows.r0 + r;
    const int qp = row < R ? q_pos[b * Tq + row / G] : -1;
    qpos_s[r] = qp;
    atomicMin(&wq_min[r / 64], qp);
    atomicMax(&wq_max[r / 64], qp);
    if (qp >= 0) {
      atomicMax(&max_qp, qp);
      atomicMin(&min_qp, qp);
    }
  }
  __syncthreads();
  if (tc::warp_uniform(max_qp) < 0) {  // every row inactive: zeros, no
                                       // page traffic
    const int nrows = min(L::kRows, R - rows.r0);
    for (int idx = tid; idx < nrows * CH; idx += NT) {
      const int row = rows.r0 + idx / CH;
      *reinterpret_cast<uint4*>(out + rows.offset(row, HD) + idx % CH * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  // the key tiles some row may see, before any K/V is loaded
  const int hi = max_qp, lo = window > 0 ? min_qp - window : -1;
  for (int n = tid; n < ntok; n += NT) {
    const int pid = bt_s[n / ps];
    const int kp = pid != 0 ? kpos_pages[(size_t)pid * ps + n % ps] : -1;
    atomicMin(&kmin_s[n / BN], max(kp, -1));
    atomicMax(&kmax_s[n / BN], kp);
    if (kp >= 0 && kp <= hi && kp > lo) list_s[n / BN] = 1;
  }
  __syncthreads();
  if (tid == 0) {
    int cnt = 0;
    for (int t = 0; t < ntiles; ++t) {
      if (!list_s[t]) continue;
      int entry = t;
      for (int w = 0; w < NWG; ++w)
        if (kmin_s[t] < 0 || kmax_s[t] > wq_min[w] ||
            (window > 0 && kmin_s[t] <= wq_max[w] - window))
          entry |= 1 << (kMaskBit + w);
      list_s[cnt++] = entry;
    }
    nlive = cnt;
    tc::init_barriers<HD, NWG>(base, 256, 128);   // K: stores + copies
  }
  __syncthreads();
  const int ntl = tc::warp_uniform(nlive);
  const int warp = tc::warp_uniform(tid / 32), lane = tid % 32;

  if (warp >= 4 * NWG) {  // producer warpgroup: gather each tile by cp.async
    tc::producer_regs<NWG, kProducerRegs>();
    const int ptid = tid - 128 * NWG;
    // two threads a key row, on neighbouring 16-byte chunks (so a warp
    // reads whole 32-byte sectors), each row's address computed once
    auto gather = [&](const __nv_bfloat16* src, uint32_t dst) {
      for (int t = ptid / 2; t < BN; t += 64) {
        const int slot = slot_s[t];
        const __nv_bfloat16* row =
            src + (slot >= 0 ? ((size_t)slot * KH + kh) * HD : 0);
        const int bytes = slot >= 0 ? 16 : 0;
#pragma unroll 4
        for (int j = 0; j < CH / 2; ++j) {
          const int c = 2 * j + (ptid & 1);
          tc::cp_async16(dst + tc::operand_offset<HD>(BN, t, c), row + c * 8,
                         bytes);
        }
      }
    };
    for (int it = 0; it < ntl; ++it) {
      const int stage = it % C::kStages;
      const int c0 = (list_s[it] & ((1 << kMaskBit) - 1)) * BN;
      const uint32_t parity = (it / C::kStages - 1) & 1;
      tc::named_barrier(kProducerBarrier, 128);   // the last slots are read
      if (it >= C::kStages) tc::mbar_wait(L::empty(base, 0, stage), parity);
      for (int t = ptid; t < BN; t += 128) {   // the null page is not read
        const int n = c0 + t;
        const int pid = n < ntok ? bt_s[n / ps] : 0;
        const int slot = pid != 0 ? pid * ps + n % ps : -1;
        slot_s[t] = slot;
        if (slot >= 0)
          tc::cp_async4(tc::smem_u32(kpos_s + stage * BN + t),
                        kpos_pages + slot);
        else
          kpos_s[stage * BN + t] = -1;
      }
      tc::mbar_arrive(L::full(base, 0, stage));   // the -1 kpos are stored
      tc::named_barrier(kProducerBarrier, 128);
      gather(k_pages, L::k_tile(base, stage));
      tc::cp_async_arrive(L::full(base, 0, stage));
      if (it >= C::kStages) tc::mbar_wait(L::empty(base, 1, stage), parity);
      gather(v_pages, L::v_tile(base, stage));
      tc::cp_async_arrive(L::full(base, 1, stage));
    }
    tc::cp_async_wait_all();
    return;
  }

  tc::consumer_regs<NWG, kProducerRegs>();
  const int wg = warp / 4;
  tc::load_q<HD, NWG>(sm, q, rows, wg, tid % 128);
  PagedTiles<BN, C::kStages> tiles;
  tiles.list = list_s;
  tiles.window = window;
  tiles.mask_bit = 1 << (kMaskBit + wg);
  tiles.active = tc::warp_uniform(wq_max[wg]) >= 0;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    tiles.qp[r] = qpos_s[wg * 64 + 16 * (warp % 4) + lane / 4 + 8 * r];
  float o[HD / 2], l[2];
  tc::consume<HD, NWG>(sm, wg, ntl, tiles, scale, softcap, o, l);
  tc::store_rows<HD>(out, rows, wg, o, l);
}

template <int HD, int NWG>
cudaError_t launch_multi_tc(const void* q, const void* k, const void* v,
                            const int* kpos, const int* bt, const int* qpos,
                            void* out, int B, int Tq, int H, int KH, int ps,
                            int pmax, float scale, int window, float softcap,
                            cudaStream_t stream) {
  using L = tc::Smem<HD, NWG>;
  const int ntiles = (pmax * ps + tc::Cfg<HD>::kBN - 1) / tc::Cfg<HD>::kBN;
  const size_t smem = multi_tc_smem_bytes<HD, NWG>(ntiles, pmax);
  if (smem > 232448 - 64) return cudaErrorInvalidValue;  // + static
  cudaError_t err = cudaFuncSetAttribute(
      paged_multi_tc_kernel<HD, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = Tq * (H / KH);
  const dim3 grid((rows + L::kRows - 1) / L::kRows, KH, B);
  paged_multi_tc_kernel<HD, NWG><<<grid, L::kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, kpos, bt, qpos, (__nv_bfloat16*)out, Tq, H, KH,
      ps, pmax, scale, window, softcap);
  return cudaGetLastError();
}

// One consumer warpgroup when the rows of a (sequence, KV head) fit in 64.
template <int HD>
cudaError_t launch_multi_bf16(const void* q, const void* k, const void* v,
                              const int* kpos, const int* bt, const int* qpos,
                              void* out, int B, int Tq, int H, int KH, int ps,
                              int pmax, float scale, int window,
                              float softcap, cudaStream_t stream) {
  if (Tq * (H / KH) <= 64)
    return launch_multi_tc<HD, 1>(q, k, v, kpos, bt, qpos, out, B, Tq, H, KH,
                                  ps, pmax, scale, window, softcap, stream);
  return launch_multi_tc<HD, 2>(q, k, v, kpos, bt, qpos, out, B, Tq, H, KH,
                                ps, pmax, scale, window, softcap, stream);
}

// The single-query kernel: launch (split == nullptr) or report the CTAs
// per row it would use.
int single(const void* q, const void* k_pages, const void* v_pages,
           const void* kpos_pages, const void* block_table, const void* q_pos,
           void* out, int dtype, int B, int H, int KH, int hd, int ps,
           int pmax, float scale, int window, float softcap, cudaStream_t s,
           int* split) {
  const int* kp = static_cast<const int*>(kpos_pages);
  const PagedRows rows{static_cast<const int*>(block_table), pmax, ps};
  const int* qp = static_cast<const int*>(q_pos);
  if (H % KH != 0 || H / KH > 8) return (int)cudaErrorInvalidValue;
#define DEC(T, HD)                                                       \
  return (int)launch_decode<T, T, HD>(q, k_pages, v_pages, nullptr,       \
                                      nullptr, kp, rows, qp, out, B, H, KH, \
                                      pmax * ps, scale, window, softcap, s, \
                                      split)
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the multi-query entry: tensor cores).
// head_dim in {32, 64, 128, 256}; H/KH <= 8 for the single-query kernel.
// Shapes as in ref.py; all tensors contiguous.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* kpos_pages, const void* block_table, const void* q_pos,
    void* out, int dtype, int B, int H, int KH, int hd, int ps, int pmax,
    float scale, int window, float softcap, void* stream) {
  return single(q, k_pages, v_pages, kpos_pages, block_table, q_pos, out,
                dtype, B, H, KH, hd, ps, pmax, scale, window, softcap,
                static_cast<cudaStream_t>(stream), nullptr);
}

// The CTAs per (KV head, sequence) that paged_decode_attention_launch
// would use for these sizes (>= 1), or a negative CUDA error code.
extern "C" int paged_decode_attention_split(int dtype, int B, int H, int KH,
                                            int hd, int ps, int pmax) {
  int split = 0;
  const int err = single(nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, dtype, B, H, KH, hd, ps, pmax, 1.f,
                         0, 0.f, nullptr, &split);
  return err != 0 ? -err : split;
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
#define MULTI(HD)                                                           \
  return (int)launch_multi<float, HD>(q, k_pages, v_pages, kp, bt, qp, out, \
                                      B, T, H, KH, ps, pmax, scale, window, \
                                      softcap, s)
#define MULTI_TC(HD)                                                        \
  return (int)launch_multi_bf16<HD>(q, k_pages, v_pages, kp, bt, qp, out, B, \
                                    T, H, KH, ps, pmax, scale, window,       \
                                    softcap, s)
  if (dtype == 0) {
    if (hd == 32) MULTI(32);
    if (hd == 64) MULTI(64);
    if (hd == 128) MULTI(128);
    if (hd == 256) MULTI(256);
  } else if (dtype == 1) {
    if (hd == 32) MULTI_TC(32);
    if (hd == 64) MULTI_TC(64);
    if (hd == 128) MULTI_TC(128);
    if (hd == 256) MULTI_TC(256);
  }
#undef MULTI_TC
#undef MULTI
  return (int)cudaErrorInvalidValue;
}
