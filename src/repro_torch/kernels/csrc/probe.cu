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
// What bounds it: bytes. w1 is d x hid float32 (3584 x 512 = 7.3 MB at
// gemma2-9b width) against 2*B*d*hid flops, at most 8 a byte at B = 16,
// so the call has to move w1 once, from every SM at once, and little
// else. The tensor cores are not used: TF32 would not hold 1e-5, and at
// B <= 16 the CUDA cores' float32 rate keeps pace with the bytes. One
// launch does it all (the wrapper's plan, probe.py plan(), sizes it):
//
// 1. Tiles. The grid is (cluster, clusters) with clusters of (cluster,
//    1, 1): a cluster takes blocks of 32 hid columns (block blockIdx.y,
//    then every clusters-th after it), each of its CTAs a d slice of
//    dslice rows (npass slices a CTA, one after the other, only where d
//    is too long for the cluster's shared memory). A CTA takes more than
//    half an SM's shared memory, so no two share an SM. The plan takes
//    the largest cluster of which the card holds a cluster a column block
//    at once (cudaOccupancyMaxActiveClusters, probe_active_clusters), so
//    that w1 streams in one wave; the grid never holds more clusters
//    than the card does at once.
// 2. Stream. Each thread first asks for its share of the tap slice (16
//    bytes a load where the shape allows); then warp 0 asks for the CTA's
//    whole tile: one TMA copy (a 32 x 128 box of a 2D tensor map of w1,
//    16 KB) per stage of 128 rows, each completing its own mbarrier
//    (4-byte cp.async by every thread where hid % 4 != 0, which TMA
//    cannot stride). The threads stage the tap transposed in shared
//    memory and compute each stage as it lands. The tile stays resident,
//    so a second row tile (B > 16) reads no w1 byte again.
// 3. FMAs. A thread owns 4 tap rows x 4 columns (one float4 of w1) of
//    float32 accumulators and takes 16 rows of each stage (RT = 16 tap
//    rows), or 4 (RT = 4, for B <= 4, where 4 d groups share a warp and
//    meet by shuffles); the warps' partial sums meet in shared memory.
// 4. The d reduction in the cluster. Each CTA stores its partial h of
//    tap row r into the shared memory of the CTA that owns the row (r %
//    cluster), in the slot of its rank (st.shared::cluster); after one
//    cluster barrier each CTA sums its rows' slots in rank order, adds b1
//    and applies the ReLU (only then: the d sum is whole), and forms the
//    row's k partial logits from its 32 columns and their rows of w2
//    (staged in shared memory at the start), written to the call's
//    scratch.
// 5. The cross-cluster sum and the filter. The launch is cooperative
//    and the CTAs meet at a grid barrier (cg::this_grid().sync(); it
//    needs no zeroed memory, and the whole grid is resident at once).
//    Then the grid's warps take a row each: a row's warp sums its partial
//    logits over the column blocks in block order (lane = bin), adds b2
//    and does the softmax, the prior (T staged at the start; the first
//    row's prior formed while the cluster met) and the posterior.
//
// Every sum is taken in a fixed order (no float atomics), so two calls
// on the same inputs agree bit for bit; nothing lives past a call, so
// calls on two streams do not meet. Precision: float32 throughout,
// within 1e-5 of the plain version (sums over d and hid in another
// order).
//
// What is left: at decode sizes the call takes several times its byte
// bound. The launch, the requests' issue, the tap's round trip before the
// first FMA, the cluster barrier, the grid barrier and the filter's round
// trips lie one after the other on the call's path (PERF.md has their
// times). Clusters of 7 or 8 CTAs fit only 15 at a time at one CTA an
// SM, so at hid 512 the plan takes clusters of 6 on 96 SMs.
//
// Plain C interface for ctypes; the entries return a CUDA error code.

#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up
                    // in libcuda at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                 // hid columns of a cluster
constexpr int kColGroups = kCols / 4;     // float4 columns of a row
constexpr int kStageRows = 128;           // w1 rows of a stage (one TMA box)
constexpr int kStageBytes = kStageRows * kCols * 4;
constexpr int kMaxCluster = 8;
constexpr int kMaxBins = 32;
constexpr int kTapVecs = 8;               // 16-byte tap loads a thread holds
constexpr int kTapRegs = 32;              // or scalar ones
constexpr size_t kMaxSmem = 232448;       // 227 KB, a CTA's most
constexpr size_t kOnePerSm = 120 * 1024;  // more than half an SM's

// Dynamic shared memory of a CTA: per stage the w1 rows, the tap rows
// (RT floats each) and an mbarrier; then the warps' partial sums, the
// partial h received from the cluster, the cluster's rows of w2 and b1, T
// and b2; at least kOnePerSm. Mirrored by probe.py.
constexpr size_t smem_bytes(int rt, int stages) {
  const size_t n =
      (size_t)stages * (kStageBytes + kStageRows * rt * 4 + 8) +
      (size_t)rt * kCols * 4 * (kWarps + kMaxCluster) +
      kCols * (kMaxBins + 1) * 4 + kMaxBins * (kMaxBins + 1) * 4;
  return n > kOnePerSm ? n : kOnePerSm;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 4-byte cp.async; src_bytes = 0 writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4z(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes) : "memory");
}

// A box of the 2D tensor map at (column x, row y) into shared memory,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
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

// Start a load of one slice's tile, w1 rows [d0, d0 + rows) and columns
// [j0, j0 + 32), stage s holding tile rows [128 s, 128 s + 128). With TMA
// (tma, one arrival a phase) the lanes of warp 0 ask for every stage at
// once, rows and columns past w1 read as zeros; otherwise every thread
// (kThreads arrivals a phase) copies 4 floats a stage by 4-byte cp.async,
// zeros past the slice and past hid. Each mbarrier completes one phase a
// load, also past the slice's end.
__device__ __forceinline__ void load_tile(const CUtensorMap* map, bool tma,
                                          const float* __restrict__ w1,
                                          float* w_s, uint32_t bar0,
                                          int stages, int d0, int rows,
                                          int hid, int j0) {
  const int nst = (rows + kStageRows - 1) / kStageRows;
  if (tma) {
    if (threadIdx.x >= 32) return;
    for (int s = threadIdx.x; s < stages; s += 32) {
      const uint32_t bar = bar0 + 8 * s;
      if (s < nst) {
        tc::mbar_expect_tx(bar, kStageBytes);
        tma_box(tc::smem_u32(w_s + s * kStageRows * kCols), map, j0,
                d0 + s * kStageRows, bar);
      } else {
        tc::mbar_arrive(bar);
      }
    }
    return;
  }
  const int c0 = 4 * (threadIdx.x % kColGroups);
  for (int s = 0; s < stages; ++s) {
    const uint32_t bar = bar0 + 8 * s;
    if (s < nst) {
      for (int row = s * kStageRows + threadIdx.x / kColGroups;
           row < (s + 1) * kStageRows; row += kThreads / kColGroups) {
        const float* src = w1 + (size_t)(d0 + row) * hid + j0 + c0;
        const uint32_t dst = tc::smem_u32(w_s + row * kCols + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = row < rows && j0 + c0 + e < hid;
          cp_async4z(dst + 4 * e,
                     ok ? (const void*)(src + e) : (const void*)w1,
                     ok ? 4 : 0);
        }
      }
      tc::cp_async_arrive(bar);
    } else {
      tc::mbar_arrive(bar);
    }
  }
}

// One batch of a thread's share of the transposed tap tile tap_s[dd * RT
// + r] (tap rows r0 + r < r0 + nrows, slice rows dd < rows; zeros
// elsewhere), from element `base` on, held as loaded until the store so
// that the loads are in flight together. With `vec` (d and dslice whole
// 16-byte chunks) a thread loads 16-byte chunks: chunk ci is row ci % RT,
// slice rows V * (ci / RT) ..; otherwise single elements: element idx is
// row idx % RT, slice row idx / RT. Either way a warp's lanes take
// neighbouring rows, so its stores to tap_s fall in distinct banks.
template <typename T, int RT>
struct TapBatch {
  static constexpr int V = 16 / sizeof(T);      // elements of a chunk
  static constexpr int kVecEl = kTapVecs * kThreads * V;
  static constexpr int kScEl = kTapRegs * kThreads;
  uint4 vec[kTapVecs];
  T sc[kTapRegs];

  static __device__ __forceinline__ int step(bool v) {
    return v ? kVecEl : kScEl;
  }

  __device__ __forceinline__ void load(bool v, const T* __restrict__ tap,
                                       int base, int nel, int d, int r0,
                                       int nrows, int d0, int rows) {
    if (v) {
#pragma unroll
      for (int i = 0; i < kTapVecs; ++i) {
        const int ci = base / V + i * kThreads + (int)threadIdx.x;
        const int r = ci % RT, dd = V * (ci / RT);
        if (ci * V < nel && r < nrows && dd < rows)
          vec[i] = *reinterpret_cast<const uint4*>(
              tap + (size_t)(r0 + r) * d + d0 + dd);
        else
          vec[i] = make_uint4(0u, 0u, 0u, 0u);
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < kTapRegs; ++i) {
      const int idx = base + i * kThreads + (int)threadIdx.x;
      const int r = idx % RT, dd = idx / RT;
      if (idx < nel && r < nrows && dd < rows)
        sc[i] = tap[(size_t)(r0 + r) * d + d0 + dd];
      else
        sc[i] = zero<T>();
    }
  }

  __device__ __forceinline__ void store(bool v, float* tap_s, int base,
                                        int nel) const {
    if (v) {
#pragma unroll
      for (int i = 0; i < kTapVecs; ++i) {
        const int ci = base / V + i * kThreads + (int)threadIdx.x;
        const int r = ci % RT, dd = V * (ci / RT);
        if (ci * V >= nel) continue;
        const T* x = reinterpret_cast<const T*>(&vec[i]);
#pragma unroll
        for (int e = 0; e < V; ++e) tap_s[(dd + e) * RT + r] = to_f32(x[e]);
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < kTapRegs; ++i) {
      const int idx = base + i * kThreads + (int)threadIdx.x;
      if (idx < nel) tap_s[idx] = to_f32(sc[i]);
    }
  }
};

// How a CTA's threads share a stage's FMAs. A thread owns 4 tap rows (a
// row group) x 4 columns (a float4): lane = column group + 8 * slot, and
// the slot picks the row group, or (with fewer than 4 row groups) one of
// kSD d groups within the warp. The CTA's kDG = 8 * kSD d groups take the
// stage's 128 rows in turn, kRows each.
template <int RT>
struct Map {
  static constexpr int kRG = RT / 4;
  static constexpr int kSD = 4 / kRG;
  static constexpr int kDG = kWarps * kSD;
  static constexpr int kRows = kStageRows / kDG;
};

__device__ __forceinline__ void row_fma(float (&acc)[4][4], float4 w,
                                        float4 t) {
  const float tr[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[e][0] = fmaf(tr[e], w.x, acc[e][0]);
    acc[e][1] = fmaf(tr[e], w.y, acc[e][1]);
    acc[e][2] = fmaf(tr[e], w.z, acc[e][2]);
    acc[e][3] = fmaf(tr[e], w.w, acc[e][3]);
  }
}

// Address of `local` (this CTA's shared memory) in CTA `rank`'s.
__device__ __forceinline__ uint32_t map_rank(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The prior of row b in lane = bin: T q_prev[b], from the row's previous
// posterior qp (lane = bin) and T staged in t_s.
__device__ __forceinline__ float prior_of(float qp, const float* t_s, int k) {
  const int lane = threadIdx.x % 32;
  float prior = 0.f;
  for (int j = 0; j < k; ++j) {
    const float qj = __shfl_sync(0xffffffffu, qp, j);
    if (lane < k) prior = fmaf(qj, t_s[lane * k + j], prior);
  }
  return prior;
}

// The filter of tap row b by one warp, lane = bin: the column blocks'
// partial logits summed in block order, b2, the softmax, the prior (given
// in `prior` when has_prior, else formed from q_prev and T) and the
// posterior.
__device__ __forceinline__ void filter_row(
    const float* __restrict__ plog, const float* __restrict__ q_prev,
    const float* b2_s, const float* t_s, float* __restrict__ q_new,
    float* __restrict__ p_out, int B, int k, int ncb, int b, bool has_prior,
    float prior) {
  const int lane = threadIdx.x % 32;
  const bool in = lane < k;
  float logit = -INFINITY, qp = 0.f;
  if (in) {
    float sum = 0.f;
#pragma unroll 16
    for (int j = 0; j < ncb; ++j)
      sum += __ldcg(plog + ((size_t)j * B + b) * k + lane);
    if (!has_prior) qp = q_prev[(size_t)b * k + lane];
    logit = sum + b2_s[lane];
  }
  const float m = warp_max(logit);
  const float e = in ? expf(logit - m) : 0.f;
  const float p = e / warp_sum(e);
  if (!has_prior) prior = prior_of(qp, t_s, k);
  const float post = prior * p;
  const float z = warp_sum(post);
  if (in) {
    q_new[(size_t)b * k + lane] = z > 0.f ? post / fmaxf(z, 1e-30f) : prior;
    p_out[(size_t)b * k + lane] = p;
  }
}

// grid (cluster, clusters), clusters of (cluster, 1, 1), kThreads threads,
// smem_bytes(RT, ceil(dslice/128)) of dynamic shared memory, a
// cooperative launch. map: w1 as a 2D tensor map (hid, d) with 32 x 128
// boxes (used where hid % 4 == 0). plog: (ceil(hid/32), B, k) partial
// logits.
template <typename T, int RT>
__global__ void __launch_bounds__(kThreads, 1) probe_update_kernel(
    const __grid_constant__ CUtensorMap map, const T* __restrict__ tap,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ q_prev, const float* __restrict__ Tm,
    float* __restrict__ q_new, float* __restrict__ p_out,
    float* __restrict__ plog, int B, int d, int hid, int k, int dslice,
    int npass) {
  using M = Map<RT>;
  using Tap = TapBatch<T, RT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int cs = gridDim.x, rank = blockIdx.x;    // cluster = grid x
  const int ncb = (hid + kCols - 1) / kCols;
  const int stages = (dslice + kStageRows - 1) / kStageRows;
  float* w_s = reinterpret_cast<float*>(smem);
  float* tap_s = w_s + stages * kStageRows * kCols;
  float* red_s = tap_s + stages * kStageRows * RT;  // then the tile's h
  float* recv = red_s + kWarps * RT * kCols;     // [cluster][RT][32]
  float* w2_s = recv + kMaxCluster * RT * kCols;  // ncols x k
  float* b1_s = w2_s + kCols * kMaxBins;         // ncols
  float* t_s = b1_s + kCols;                     // k x k
  float* b2_s = t_s + kMaxBins * kMaxBins;       // k
  uint64_t* bar_s = reinterpret_cast<uint64_t*>(b2_s + kMaxBins);
  const uint32_t bar0 = tc::smem_u32(bar_s);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cg = lane % kColGroups, slot = lane / kColGroups;
  const int rg = slot / M::kSD, dgrp = warp * M::kSD + slot % M::kSD;
  const bool tma = hid % 4 == 0;
  const bool vec = d % Tap::V == 0 && dslice % Tap::V == 0;
  auto slice_rows = [&](int p, int& d0) {
    d0 = (p * cs + rank) * dslice;
    return max(0, min(dslice, d - d0));
  };
  // a column block's rows of w2 and b1 (waited for after the FMAs)
  auto stage_w2 = [&](int j0, int ncols) {
    for (int i = tid; i < ncols * k; i += kThreads)
      cp_async4z(tc::smem_u32(w2_s + i), w2 + (size_t)j0 * k + i, 4);
    if (tid < ncols) cp_async4z(tc::smem_u32(b1_s + tid), b1 + j0 + tid, 4);
  };

  // the first tap batch, then the w1 boxes, are in flight before anything
  // waits
  int d0_first;
  const int rows_first = slice_rows(0, d0_first);
  Tap tb;
  {
    const int nst = (rows_first + kStageRows - 1) / kStageRows;
    tb.load(vec, tap, 0, nst * kStageRows * RT, d, 0, min(RT, B), d0_first,
            rows_first);
  }
  cluster_arrive_relaxed();     // waited for before the first push
  if (warp == 0) {
    if (lane == 0) {
      for (int s = 0; s < stages; ++s)
        tc::mbar_init(bar0 + 8 * s, tma ? 1 : kThreads);
      tc::fence_barrier_init();
    }
    __syncwarp();
    if (tma) load_tile(&map, true, w1, w_s, bar0, stages, d0_first,
                       rows_first, hid, kCols * blockIdx.y);
  }
  // the row this warp filters after the grid barrier: its previous
  // posterior is read now, its prior formed while the cluster meets
  const int my_row = (blockIdx.y * cs + rank) * kWarps + warp;
  const bool own_row = my_row < B && lane < k;
  const float my_qp = own_row ? q_prev[(size_t)my_row * k + lane] : 0.f;
  float my_prior = 0.f;
  stage_w2(kCols * blockIdx.y, min(kCols, hid - kCols * (int)blockIdx.y));
  for (int i = tid; i < k * k; i += kThreads)
    cp_async4z(tc::smem_u32(t_s + i), Tm + i, 4);
  if (tid < k) cp_async4z(tc::smem_u32(b2_s + tid), b2 + tid, 4);
  if (!tma) {           // every thread arrives: the barriers first
    __syncthreads();
    load_tile(&map, false, w1, w_s, bar0, stages, d0_first, rows_first,
              hid, kCols * blockIdx.y);
  }

  int loads = 1;
  const int nrt = (B + RT - 1) / RT;
  for (int cb = blockIdx.y; cb < ncb; cb += gridDim.y) {
    const bool first_cb = cb == (int)blockIdx.y;
    const int j0 = cb * kCols, ncols = min(kCols, hid - j0);
    for (int rt = 0; rt < nrt; ++rt) {
      const int r0 = rt * RT, nrows = min(RT, B - r0);
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int p = 0; p < npass; ++p) {
        int d0;
        const int rows = slice_rows(p, d0);
        const int nst = (rows + kStageRows - 1) / kStageRows;
        const int nel = nst * kStageRows * RT;
        if (!first_cb || rt > 0 || p > 0) {
          tb.load(vec, tap, 0, nel, d, r0, nrows, d0, rows);
          // a new slice or column block: nobody reads the old tile (nor,
          // for a new block, the old rows of w2 and b1)
          if (npass > 1 || rt == 0) {
            __syncthreads();
            load_tile(&map, tma, w1, w_s, bar0, stages, d0, rows, hid, j0);
            ++loads;
            if (rt == 0 && p == 0) stage_w2(j0, ncols);
          }
        }
        tb.store(vec, tap_s, 0, nel);
        for (int base = Tap::step(vec); base < nel;
             base += Tap::step(vec)) {
          tb.load(vec, tap, base, nel, d, r0, nrows, d0, rows);
          tb.store(vec, tap_s, base, nel);
        }
        __syncthreads();
        // each stage as it lands, kRows rows a thread
        const uint32_t parity = (loads - 1) & 1;
        const float4* w4 = reinterpret_cast<const float4*>(w_s) + cg;
        const float4* t4 = reinterpret_cast<const float4*>(tap_s) + rg;
        for (int s = 0; s < nst; ++s) {
          tc::mbar_wait(bar0 + 8 * s, parity);
#pragma unroll
          for (int i = 0; i < M::kRows; ++i) {
            const int row = s * kStageRows + dgrp + i * M::kDG;
            row_fma(acc, w4[row * kColGroups], t4[row * M::kRG]);
          }
        }
      }
      const bool first = first_cb && rt == 0;
      // the CTA's partial h: a warp's d groups (lanes 8 apart) by
      // shuffles, then the warps in order
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v = acc[r][c];
          if (M::kSD > 1) v += __shfl_xor_sync(0xffffffffu, v, 8);
          if (M::kSD > 2) v += __shfl_xor_sync(0xffffffffu, v, 16);
          acc[r][c] = v;
        }
      if (slot % M::kSD == 0)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<float4*>(red_s + (warp * RT + 4 * rg + e) *
                                     kCols + 4 * cg) =
              make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
      tc::cp_async_wait_all();        // w2_s, b1_s, t_s, b2_s have landed
      __syncthreads();
      // the CTA's partial h of row r goes to the CTA that owns the row (r
      // % cluster), into its slot for this rank; a barrier of the
      // cluster, and each CTA sums its rows' slots in rank order, adds
      // b1, applies ReLU
      cluster_wait();    // every CTA has started, or read its slots
      for (int idx = tid; idx < nrows * kCols; idx += kThreads) {
        float v[kWarps];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v[w] = red_s[w * RT * kCols + idx];
        const float sum = ((v[0] + v[1]) + (v[2] + v[3])) +
                          ((v[4] + v[5]) + (v[6] + v[7]));
        const int r = idx / kCols;
        st_cluster(map_rank(tc::smem_u32(recv + rank * RT * kCols + idx),
                            r % cs),
                   sum);
      }
      cluster_arrive();
      if (first) my_prior = prior_of(my_qp, t_s, k);
      cluster_wait();
      const int mine = rank < nrows ? (nrows - rank + cs - 1) / cs : 0;
      for (int idx = tid; idx < mine * kCols; idx += kThreads) {
        const int r = rank + cs * (idx / kCols), col = idx % kCols;
        float sum = 0.f;
        for (int q = 0; q < cs; ++q) sum += recv[(q * RT + r) * kCols + col];
        red_s[idx] = col < ncols ? fmaxf(sum + b1_s[col], 0.f) : 0.f;
      }
      // read: the next tile may push
      if (rt + 1 < nrt || cb + (int)gridDim.y < ncb) cluster_arrive();
      __syncthreads();
      // the rows' k partial logits of the 32 columns (four interleaved
      // sums, added in a fixed order)
      for (int idx = tid; idx < mine * k; idx += kThreads) {
        const int i = idx / k, c = idx % k;
        const float* h = red_s + i * kCols;
        float lg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (j < ncols) lg[j % 4] = fmaf(h[j], w2_s[j * k + c], lg[j % 4]);
        plog[((size_t)cb * B + r0 + rank + cs * i) * k + c] =
            (lg[0] + lg[1]) + (lg[2] + lg[3]);
      }
    }
  }

  // the partial logits meet at a grid barrier, after which every warp of
  // the grid may filter a row
  cg::this_grid().sync();
  const int step = kWarps * cs * gridDim.y;
  for (int b = my_row; b < B; b += step)
    filter_row(plog, q_prev, b2_s, t_s, q_new, p_out, B, k, ncb, b,
               b == my_row, my_prior);
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

// w1 (d, hid) as the 2D tensor map (hid, d) with 32 x 128 boxes; rows and
// columns past its edges read as zeros.
bool w1_map(CUtensorMap* map, const void* w1, int d, int hid) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)hid, (cuuint64_t)d};
  const cuuint64_t strides[1] = {(cuuint64_t)hid * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kCols, (cuuint32_t)kStageRows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(w1), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A launch of grid `grid` in clusters of (cluster, 1, 1), cooperative
// (the whole grid resident at once, so that it may meet at a grid
// barrier) where `cooperative`; attr holds two attributes.
cudaLaunchConfig_t cluster_config(dim3 grid, int cluster, size_t smem,
                                  cudaStream_t stream, bool cooperative,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cooperative ? 2 : 1;
  return cfg;
}

template <typename T, int RT>
cudaError_t launch(const void* tap, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* q_prev,
                   const void* Tm, void* q_new, void* p, void* scratch, int B,
                   int d, int hid, int k, int cluster, int clusters,
                   int dslice, int npass, cudaStream_t stream) {
  auto kernel = probe_update_kernel<T, RT>;
  const size_t smem =
      smem_bytes(RT, (dslice + kStageRows - 1) / kStageRows);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  CUtensorMap map = {};
  if (hid % 4 == 0 && !w1_map(&map, w1, d, hid))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(cluster, clusters, 1), cluster, smem, stream, true, attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, map, static_cast<const T*>(tap),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(q_prev), static_cast<const float*>(Tm),
      static_cast<float*>(q_new), static_cast<float*>(p),
      static_cast<float*>(scratch), B, d, hid, k, dslice, npass);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// dtype (of the tap): 0 = float32, 1 = bfloat16. The plan (probe.py
// plan()): row_tile 4 or 16, clusters (at most one a column block, no
// more than the card holds at once) of cluster <= 8 CTAs, dslice rows a
// slice, npass slices a CTA (cluster * npass * dslice >= d). scratch:
// (hid / 32 rounded up) * B * k floats. A grid the card cannot hold at
// once is refused (cudaErrorCooperativeLaunchTooLarge).
extern "C" int probe_update_launch(const void* tap, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, const void* q_prev,
                                   const void* T, void* q_new, void* p,
                                   void* scratch, int dtype, int B, int d,
                                   int hid, int k, int row_tile, int cluster,
                                   int clusters, int dslice, int npass,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || d < 1 || hid < 1 || k < 1 || k > kMaxBins || cluster < 1 ||
      cluster > kMaxCluster || clusters < 1 ||
      clusters > (hid + kCols - 1) / kCols || dslice < 1 || npass < 1 ||
      (long long)cluster * npass * dslice < d)
    return (int)cudaErrorInvalidValue;
#define PROBE_LAUNCH(TYPE, RT)                                               \
  return (int)launch<TYPE, RT>(tap, w1, b1, w2, b2, q_prev, T, q_new, p,   \
                               scratch, B, d, hid, k, cluster, clusters,   \
                               dslice, npass, s)
  if (dtype == 0 && row_tile == 4) PROBE_LAUNCH(float, 4);
  if (dtype == 0 && row_tile == 16) PROBE_LAUNCH(float, 16);
  if (dtype == 1 && row_tile == 4) PROBE_LAUNCH(__nv_bfloat16, 4);
  if (dtype == 1 && row_tile == 16) PROBE_LAUNCH(__nv_bfloat16, 16);
#undef PROBE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// How many clusters of 1 to 8 CTAs the current card holds at once at one
// CTA an SM (kOnePerSm bytes of shared memory or more), into out[0..7].
extern "C" int probe_active_clusters(int* out) {
  auto kernel = probe_update_kernel<__nv_bfloat16, 16>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  for (int c = 1; c <= kMaxCluster && e == cudaSuccess; ++c) {
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg =
        cluster_config(dim3(c, 1, 1), c, kOnePerSm, nullptr, false, attr);
    e = cudaOccupancyMaxActiveClusters(out + c - 1, kernel, &cfg);
  }
  return (int)e;
}
