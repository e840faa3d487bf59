// Grouped expert MLPs of a dropless mixture-of-experts call, for Hopper
// (sm_90a): every expert's gated-SiLU MLP over the tokens routed to it,
// reading only the experts that some token routes to.
//
// Replaces no Pallas TPU kernel: the reference package's experts
// (src/repro/models/moe.py moe_mlp) are plain batched matmuls over an
// (E, C, d) dispatch buffer, left to XLA. It was added because that form,
// ported as three torch.bmm, runs every expert over C = T slots in a
// dropless call: every weight of the layer is read each call, and the
// products run over every padded position and inactive row. At
// granite-4.0-h-small's decode shape (64 rows, 72 experts of 768, top 10,
// d 4096) a layer's experts hold 1.36 GB, and a decode step of a few live
// rows needs about a third of them.
//
// Semantics (the plain PyTorch version is repro_torch/kernels/ref.py
// moe_experts_ref): hf (T, d) bf16; w_gate/w_up (E, d, ff), w_down
// (E, ff, d) bf16; entry (P,) int32, P = T * k: the routed entries sorted
// by expert, each its token-major index token * k + j; offsets (E + 1,)
// int32: expert e's entries are sorted positions offsets[e] ..
// offsets[e + 1] - 1, and offsets[E] entries in all are live (the rest
// belong to no expert and are not read); weight (T * k,) float32, the
// router weight of each entry, token-major. For each live entry q of
// expert e, with x = hf[q / k]:
//   a      = bf16(silu(x w_gate[e]) * (x w_up[e]))      (float32, rounded once)
//   out[q] = weight[q] * (a w_down[e])                   float32
// out (T * k, d) float32; rows of entries that are not live are not
// written. act (P, ff) bf16 is the scratch between the two launches.
//
// What bounds it: at decode an expert holds a few tokens, so each weight
// element read is used a few times: the bytes of the hit experts' weights
// bind, at 3.35 TB/s. The design reads each hit expert's weights once a
// call and nothing of an expert no token routes to:
//   - two launches, gate+up (silu(g) * u in the epilogue, bf16 activations
//     in sorted-entry order) and down (scaled by the router weight,
//     written to the entry's token-major row); each block takes 64 output
//     features of one tile of up to 64 entries of one expert;
//   - the grid is static: x walks the tiles of all experts in expert order
//     (tiles (E + 1,) holds each expert's first tile, computed on the
//     device), y the output features; a block past the call's tiles
//     returns before it loads anything, and an expert with no entry has
//     no tile, so its weights are never read; the tiles of one expert are
//     neighbours in x, so a weight tile read for several of them meets
//     the L2 cache;
//   - the swap-AB form: the weights are wgmma's 64-row A operand and the
//     entries its N = 64 columns, so an expert with one token costs its
//     weight bytes and no more; the weights stay in their stored layout
//     (the output features contiguous) and are read through the
//     descriptor's transpose bit (MN-major), streamed by TMA (a 3-D map
//     over (features, reduction, expert), 128-byte swizzle) from one
//     producer thread into a ring of kStages stages;
//   - the token rows are gathered by index straight from hf (the gate+up
//     launch) or read from act (down) by cp.async, 16 bytes a lane, 4
//     whole rows a warp instruction; rows past the tile's entries are not
//     loaded: their columns of the product are never stored;
//   - one consumer warpgroup issues the wgmma of a stage while the
//     producer warp fills the next ones; two blocks fit an SM.
// The gate+up launch also keeps a tally (2,) of uint64: one thread of
// each hit expert's first block adds 1 (experts whose weights were read),
// one thread of the call adds E. It costs two atomics a call, no launch.
//
// Precision: bf16 operands, float32 accumulators; silu(g) * u in float32,
// rounded once to bf16 (the plain torch.bmm path rounds g, u and their
// product); the down product and its router weight in float32.
//
// Float32 (the smoke configurations the tests run on the card) has a body
// of its own on the CUDA cores: the same grid, tiles, tally and outputs,
// products by fmaf over 16 of the reduction a stage in shared memory, the
// activation kept in float32.
//
// Shapes: bf16 needs d and ff multiples of 8 (16-byte rows for TMA and
// cp.async), float32 any; ragged edges (features past ff or d, reduction
// past d or ff) are zero filled by TMA and zero filled or masked in the
// gather; the binding raises on any other.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up
                    // in libcuda at run time

#include "hopper.cuh"

namespace {

constexpr int kBM = 64;       // output features a block (wgmma M)
constexpr int kBN = 64;       // entries a tile (wgmma N)
constexpr int kBK = 64;       // reduction a stage: one 128-byte row
constexpr int kTileBytes = kBK * 128;   // one 64 x 64 bf16 operand tile
constexpr int kThreads = 128 + 32;      // consumer warpgroup + producer warp

// The block's shared memory, from a 1024-byte aligned base:
//   [stages x (kA weight tiles, one entry tile)] [full and empty mbarriers]
//   [the tile's source rows] [(down) its entries and their weights]
template <bool GATED>
struct Layout {
  static constexpr int kA = GATED ? 2 : 1;          // weight tiles a stage
  static constexpr int kStages = GATED ? 4 : 6;
  static constexpr uint32_t kStageBytes = (kA + 1) * kTileBytes;
  static constexpr uint32_t kBars = kStages * kStageBytes;
  static constexpr uint32_t kRows = kBars + 2 * kStages * 8;
  static constexpr uint32_t kEnd = kRows + 3 * kBN * 4;

  __device__ static uint32_t a(uint32_t base, int s, int i) {
    return base + s * kStageBytes + i * kTileBytes;
  }
  __device__ static uint32_t b(uint32_t base, int s) {
    return base + s * kStageBytes + kA * kTileBytes;
  }
  __device__ static uint32_t full(uint32_t base, int s) {
    return base + kBars + 8 * s;
  }
  __device__ static uint32_t empty(uint32_t base, int s) {
    return base + kBars + 8 * (kStages + s);
  }
};

// d (64 x 64) (+)= A (64 x 16, smem, MN-major) * B (64 x 16, smem,
// K-major)^T: the weights read in their stored layout (transpose bit of A).
__device__ __forceinline__ void wgmma_tn_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       int x, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::
          "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(z), "r"(bar) : "memory");
}

// Tile t of the call: its expert e, its first sorted entry p0 and its n
// entries; false past the call's tiles. The expert is the last e with
// tiles[e] <= t (an expert with no entry starts where the next one does,
// so it is passed over). (tc::warp_uniform: ptxas serialises a wgmma it
// cannot prove is on a warp-uniform path, and these come from loads.)
__device__ __forceinline__ bool find_tile(const int* tiles, const int* offsets,
                                          int E, int t, int& e, int& p0,
                                          int& n) {
  if (t >= tc::warp_uniform(tiles[E])) return false;
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tiles[mid] <= t) lo = mid;
    else hi = mid - 1;
  }
  e = tc::warp_uniform(lo);
  p0 = tc::warp_uniform(offsets[e] + (t - tiles[e]) * kBN);
  n = tc::warp_uniform(min(kBN, offsets[e + 1] - p0));
  return true;
}

// One block per (tile of up to 64 entries of one expert, 64 output
// features). GATED: the gate+up launch (K = d, M = ff; rows of hf by token,
// act out); else the down launch (K = ff, M = d; rows of act, out).
template <bool GATED>
__global__ void __launch_bounds__(kThreads, 2)
    moe_experts_kernel(const __grid_constant__ CUtensorMap tm_a0,
                       const __grid_constant__ CUtensorMap tm_a1,
                       const __nv_bfloat16* __restrict__ src,
                       const int* __restrict__ entry,
                       const int* __restrict__ offsets,
                       const int* __restrict__ tiles,
                       const float* __restrict__ weight,
                       void* __restrict__ out,
                       unsigned long long* __restrict__ tally, int E, int k,
                       int K, int M) {
  using L = Layout<GATED>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = tc::align1024(smem_raw);
  const uint32_t base = tc::smem_u32(sm);
  const int t = blockIdx.x, mt = blockIdx.y, tid = threadIdx.x;
  if (GATED && t == 0 && mt == 0 && tid == 0)
    atomicAdd(&tally[1], (unsigned long long)E);
  int e, p0, n;
  if (!find_tile(tiles, offsets, E, t, e, p0, n)) return;
  if (GATED && p0 == offsets[e] && mt == 0 && tid == 0)
    atomicAdd(&tally[0], 1ull);
  const int nk = (K + kBK - 1) / kBK;

  int* rows_s = reinterpret_cast<int*>(sm + L::kRows);
  int* ent_s = rows_s + kBN;
  float* wt_s = reinterpret_cast<float*>(ent_s + kBN);
  if (tid < n) {
    const int q = entry[p0 + tid];
    rows_s[tid] = GATED ? q / k : p0 + tid;
    ent_s[tid] = q;
    wt_s[tid] = GATED ? 0.f : weight[q];
  }
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      tc::mbar_init(L::full(base, s), 32 + 1);   // 32 gathers + TMA's
      tc::mbar_init(L::empty(base, s), 4);       // the consumer warps
    }
    tc::fence_barrier_init();
  }
  __syncthreads();
  const int warp = tc::warp_uniform(tid / 32), lane = tid % 32;

  if (warp == 4) {   // producer: weights by TMA, entry rows by cp.async
    const int c = lane % 8;   // this lane's 16-byte unit of a 128-byte row
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % L::kStages;
      if (kt >= L::kStages)
        tc::mbar_wait(L::empty(base, s), (kt / L::kStages - 1) & 1);
      const uint32_t full = L::full(base, s);
      if (lane == 0) {
        tc::mbar_expect_tx(full, L::kA * kTileBytes);
        tma_3d(L::a(base, s, 0), &tm_a0, mt * kBM, kt * kBK, e, full);
        if (GATED) tma_3d(L::a(base, s, 1), &tm_a1, mt * kBM, kt * kBK, e,
                          full);
      }
      const int col = kt * kBK + c * 8;
      const int bytes = col < K ? 16 : 0;   // past K: zeros, read nothing
      const uint32_t dst = L::b(base, s);
      for (int r = lane / 8; r < n; r += 4)
        tc::cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4),
                       src + (size_t)rows_s[r] * K + (bytes ? col : 0),
                       bytes);
      tc::cp_async_arrive(full);
    }
    tc::cp_async_wait_all();
    return;
  }

  // consumer warpgroup: D (64 features x 64 entries) over the K stages
  float acc0[32], acc1[GATED ? 32 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = 0.f;
  if constexpr (GATED) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc1[i] = 0.f;
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % L::kStages;
    tc::mbar_wait(L::full(base, s), (kt / L::kStages) & 1);
    tc::fence_proxy_async();       // cp.async's writes, before wgmma reads
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int acc = kt > 0 || ks > 0;
      const uint64_t db = tc::make_desc(L::b(base, s) + ks * 32, 16, 1024, 1);
      wgmma_tn_n64(acc0,
                   tc::make_desc(L::a(base, s, 0) + ks * 16 * 128,
                                 kTileBytes, 1024, 1),
                   db, acc);
      if constexpr (GATED)
        wgmma_tn_n64(acc1,
                     tc::make_desc(L::a(base, s, 1) + ks * 16 * 128,
                                   kTileBytes, 1024, 1),
                     db, acc);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<1>();           // the stage before is done with
    if (kt > 0 && lane == 0)
      tc::mbar_arrive(L::empty(base, (kt - 1) % L::kStages));
  }
  tc::wgmma_wait<0>();
  tc::fence_regs(acc0);
  if constexpr (GATED) tc::fence_regs(acc1);

  // rows of the accumulator are output features, columns the tile's entries
  const int quad = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = mt * kBM + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
    if (col >= n || row >= M) continue;
    if constexpr (GATED) {
      const float g = acc0[i], u = acc1[i];
      reinterpret_cast<__nv_bfloat16*>(out)[(size_t)(p0 + col) * M + row] =
          __float2bfloat16(g / (1.f + expf(-g)) * u);
    } else {
      reinterpret_cast<float*>(out)[(size_t)ent_s[col] * M + row] =
          acc0[i] * wt_s[col];
    }
  }
}

// The float32 body, on the CUDA cores: the same grid, tiles and tally;
// each block stages 16 of the reduction at a time, the tile's entry rows
// and its weight tiles in shared memory, and each of its 256 threads
// accumulates 4 features x 4 entries. act is float32 here, not rounded.
constexpr int kF32K = 16;        // reduction a stage
constexpr int kF32Threads = 256;

template <bool GATED>
__global__ void __launch_bounds__(kF32Threads)
    moe_experts_f32_kernel(const float* __restrict__ w0,
                           const float* __restrict__ w1,
                           const float* __restrict__ src,
                           const int* __restrict__ entry,
                           const int* __restrict__ offsets,
                           const int* __restrict__ tiles,
                           const float* __restrict__ weight,
                           float* __restrict__ out,
                           unsigned long long* __restrict__ tally, int E,
                           int k, int K, int M) {
  __shared__ float xs[kF32K][kBN + 1];   // + 1: the row-wise stores spread
  __shared__ float ws[GATED ? 2 : 1][kF32K][kBM];
  __shared__ int rows_s[kBN], ent_s[kBN];
  __shared__ float wt_s[kBN];
  const int t = blockIdx.x, mt = blockIdx.y, tid = threadIdx.x;
  if (GATED && t == 0 && mt == 0 && tid == 0)
    atomicAdd(&tally[1], (unsigned long long)E);
  int e, p0, n;
  if (!find_tile(tiles, offsets, E, t, e, p0, n)) return;
  if (GATED && p0 == offsets[e] && mt == 0 && tid == 0)
    atomicAdd(&tally[0], 1ull);
  if (tid < n) {
    const int q = entry[p0 + tid];
    rows_s[tid] = GATED ? q / k : p0 + tid;
    ent_s[tid] = q;
    wt_s[tid] = GATED ? 0.f : weight[q];
  }
  __syncthreads();
  const size_t wbase = (size_t)e * K * M;
  const int tf = tid % 16, te = tid / 16;   // features 4 tf.., entries 4 te..
  float acc[GATED ? 2 : 1][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kF32K) {
    for (int i = tid; i < kF32K * kBN; i += kF32Threads) {
      const int r = i / kF32K, kk = i % kF32K;   // along a row of src
      xs[kk][r] = r < n && k0 + kk < K ? src[(size_t)rows_s[r] * K + k0 + kk]
                                       : 0.f;
    }
    for (int i = tid; i < kF32K * kBM; i += kF32Threads) {
      const int kk = i / kBM, f = i % kBM;       // along a row of weights
      const bool in = k0 + kk < K && mt * kBM + f < M;
      const size_t at = wbase + (size_t)(k0 + kk) * M + mt * kBM + f;
      ws[0][kk][f] = in ? w0[at] : 0.f;
      if constexpr (GATED) ws[1][kk][f] = in ? w1[at] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32K; ++kk) {
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = xs[kk][4 * te + j];
#pragma unroll
      for (int a = 0; a < (GATED ? 2 : 1); ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = ws[a][kk][4 * tf + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[a][i][j] = fmaf(w, x[j], acc[a][i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = mt * kBM + 4 * tf + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 4 * te + j;
      if (col >= n || row >= M) continue;
      if constexpr (GATED) {
        const float g = acc[0][i][j], u = acc[1][i][j];
        out[(size_t)(p0 + col) * M + row] = g / (1.f + expf(-g)) * u;
      } else {
        out[(size_t)ent_s[col] * M + row] = acc[0][i][j] * wt_s[col];
      }
    }
  }
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

// The tensor map of stacked weights (E, K, M) bf16 as (M, K, E): a box of
// 64 output features (one 128-byte swizzled row) x 64 of the reduction of
// one expert; past M or K the hardware fills zeros.
bool weight_map(CUtensorMap* map, const void* ptr, int E, int K, int M) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)M, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)M * 2, (cuuint64_t)K * M * 2};
  const cuuint32_t box[3] = {kBM, kBK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool GATED>
cudaError_t launch(const CUtensorMap& a0, const CUtensorMap& a1,
                   const void* src, const int* entry, const int* offsets,
                   const int* tiles, const float* weight, void* out,
                   unsigned long long* tally, int E, int k, int K, int M,
                   int max_tiles, cudaStream_t stream) {
  constexpr int smem = Layout<GATED>::kEnd + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      moe_experts_kernel<GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(max_tiles, (M + kBM - 1) / kBM);
  moe_experts_kernel<GATED><<<grid, kThreads, smem, stream>>>(
      a0, a1, (const __nv_bfloat16*)src, entry, offsets, tiles, weight, out,
      tally, E, k, K, M);
  return cudaGetLastError();
}

template <bool GATED>
cudaError_t launch_f32(const void* w0, const void* w1, const void* src,
                       const int* entry, const int* offsets, const int* tiles,
                       const float* weight, void* out,
                       unsigned long long* tally, int E, int k, int K, int M,
                       int max_tiles, cudaStream_t stream) {
  const dim3 grid(max_tiles, (M + kBM - 1) / kBM);
  moe_experts_f32_kernel<GATED><<<grid, kF32Threads, 0, stream>>>(
      (const float*)w0, (const float*)w1, (const float*)src, entry, offsets,
      tiles, weight, (float*)out, tally, E, k, K, M);
  return cudaGetLastError();
}

}  // namespace

// dtype 1: hf (T, d), w_gate/w_up (E, d, ff), w_down (E, ff, d) bf16, act
// (T*k, ff) bf16 scratch, d and ff multiples of 8 and every pointer 16-byte
// aligned; dtype 0: all of them float32, act float32. entry (T*k,), offsets
// and tiles (E + 1,) int32 (tiles[e]: expert e's first tile of 64 sorted
// entries; tiles[E] all of them, at most max_tiles); weight (T*k,) float32;
// out (T*k, d) float32; tally (2,) uint64, added to.
extern "C" int moe_experts_launch(const void* hf, const void* w_gate,
                                  const void* w_up, const void* w_down,
                                  const void* entry, const void* offsets,
                                  const void* tiles, const void* weight,
                                  void* act, void* out, void* tally,
                                  int dtype, int E, int k, int d, int ff,
                                  int max_tiles, void* stream) {
  if (E < 1 || k < 1 || d < 1 || ff < 1 || max_tiles < 1 ||
      max_tiles > 2147483647 / 2 || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && (d % 8 != 0 || ff % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto ent = static_cast<const int*>(entry);
  auto off = static_cast<const int*>(offsets);
  auto til = static_cast<const int*>(tiles);
  auto wt = static_cast<const float*>(weight);
  auto ta = static_cast<unsigned long long*>(tally);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32<true>(w_gate, w_up, hf, ent, off, til, nullptr, act, ta,
                           E, k, d, ff, max_tiles, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_f32<false>(w_down, w_down, act, ent, off, til, wt,
                                  out, nullptr, E, k, ff, d, max_tiles, s);
  }
  CUtensorMap tm_g, tm_u, tm_d;
  if (!weight_map(&tm_g, w_gate, E, d, ff) ||
      !weight_map(&tm_u, w_up, E, d, ff) ||
      !weight_map(&tm_d, w_down, E, ff, d))
    return (int)cudaErrorInvalidValue;
  err = launch<true>(tm_g, tm_u, hf, ent, off, til, nullptr, act, ta, E, k, d,
                     ff, max_tiles, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<false>(tm_d, tm_d, act, ent, off, til, wt, out, nullptr,
                            E, k, ff, d, max_tiles, s);
}
