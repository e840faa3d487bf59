// Device code of the flash-decode kernels (one query per sequence), for
// Hopper (sm_90a), and the helpers the other attention kernels share.
//
// decode_kernel<T, KV, HD, GMAX, Rows> attends the G = H/KH query heads of
// one (KV head, sequence) over that sequence's token rows. T is the type of
// the query and the output, KV the type the K/V rows are stored in: T
// itself, or int8_t for an int8 slot cache (below). Where the rows live is
// the only thing the two callers differ in, so it is a template argument:
//   PagedRows (paged_decode_attention.cu) - token n of sequence b sits in
//     slot n % ps of physical page block_table[b][n / ps]; page 0 is the
//     null page and is never read;
//   SlotRows (decode_attention.cu) - token n of sequence b is row
//     b * M + n of a contiguous (B, M) slot cache (a ring when windowed).
// A Rows type provides ntok(qp) (the tokens to consider), staged() and
// stage(b, s) (ints it copies into shared memory first: the block-table
// row) and slot(b, n, s) (the flat index of token n's kpos and K/V row,
// or -1 for none).
//
// Semantics are those of repro_torch/kernels/ref.py: key position kpos is
// valid for a query at q_pos when kpos >= 0 && kpos <= q_pos (&& kpos >
// q_pos - window); scores are scaled by hd^-0.5 after the dot, optionally
// soft-capped, and folded into an online softmax kept in float32; a row
// with nothing valid comes out as 0 (l is clamped at 1e-30, as in the
// reference's NEG_INF = -2^30 semantics).
//
// What bounds it: bytes. Each valid K/V row is read once per (sequence,
// KV head) and serves the G <= 8 query heads of its group: 4*hd*G
// operations for 4*hd bytes (bf16), at most 8 a byte, far below the
// card's ~295 operations-a-byte ridge. So the CUDA cores do the
// arithmetic, all in float32, and the design is about the bytes:
//
// 1. Split over a cluster. The grid is (nsplit, KH, B) with clusters of
//    (nsplit, 1, 1): the CTAs of one cluster share one (KV head, sequence)
//    row. The host picks nsplit (split_count): the largest cluster, up to
//    16 (non-portable sizes allowed), whose B*KH clusters the card holds
//    at once (cudaOccupancyMaxActiveClusters): a second wave cost more on
//    the card than a smaller split saved. The row's candidate tokens
//    [0, ntok(q_pos)) are cut into tiles of kTile; tile t belongs to CTA
//    t % nsplit, so the valid tokens of a row spread over its CTAs
//    wherever they lie (a ring's first 300 slots as well as a full ring).
// 2. Scan, then load only what counts. A CTA reads the kpos of up to kList
//    of its tokens at once (a warp's lanes read one tile's 32 consecutive
//    kpos, one 128-byte transaction; a null page is skipped without reading
//    its kpos, from the block-table row staged in shared memory), takes a
//    ballot of key_valid per warp and writes the flat slot index of every
//    valid token into a list in shared memory, in token order. A masked
//    slot costs its 4-byte kpos and nothing else.
// 3. Stream. Each warp owns every kWarps-th stage of NR listed rows and a
//    ring of kStages shared-memory stages of K and V (up to 8 KB a stage),
//    filled by 16-byte cp.async: stages s+1 and s+2 are in flight while
//    stage s is computed, and no barrier wider than the warp is taken. A
//    warp's lanes form groups of TPR lanes, a group taking one row at a
//    time, 16 bytes a lane, and keeping its own online softmax (m, l, acc)
//    of the G heads in registers, rescaled once a stage. The group's
//    G x RPG partial dots of a stage are summed by a reduce-scatter over
//    its lanes (reduce_scatter), so each lane scales, soft-caps and
//    exponentiates one or a few scores and shuffles them back to all:
//    with every lane repeating every tanhf and expf, the instructions, not
//    the bytes, had set the pace.
// 4. Merge once. A warp merges its groups by shuffles, the CTA its warps
//    through shared memory; then, after cluster.sync(), each CTA reads every
//    CTA's partial (m, l, acc) through distributed shared memory and writes
//    its share of the G*HD outputs, and a second cluster.sync() keeps each
//    CTA's shared memory alive until all have read it. One launch a call,
//    no workspace, no atomics; the result does not depend on scheduling.
//
// int8 K/V (KV = int8_t, slot caches only). Each (token, KV head) row
// carries a float32 scale for K and one for V (k_scale, v_scale: (B, M, KH)),
// and stands for int8 value times scale. The scale factors out of the dot
// and of the weighted sum: s = k_scale * (q . k_int8) before the hd^-0.5
// and the softcap, and p * v_scale weights the V row, while l sums p alone.
// So no element is dequantised: a 16-byte vector is 16 int8 elements (VEC
// and the row bytes follow from sizeof(KV)), a lane converts its int8 to
// float32 and does the same FMAs as for bf16, and the scan, which reads
// each candidate's kpos, reads its two scales beside it and lists them with
// the slot. A row then moves 2 * hd + 8 bytes in place of 4 * hd (bf16).
//
// What is left: the scan and the stream of one CTA do not overlap (a pass
// lists its rows, then loads them); a CTA's first bytes wait for q_pos,
// the block table and kpos in turn, so a short row pays that chain, the
// cluster's two barriers and the launch whatever its bytes; a query group
// of 5 (hymba) runs the instance for 8 heads.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash_decode {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1073741824.0f;  // -2^30
constexpr int kThreads = 128;    // also the block of paged_multi_kernel
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // tokens of a scan tile: one warp's ballot
constexpr int kScan = 8;         // candidate tokens a thread reads a pass
constexpr int kList = kThreads * kScan;  // tokens a pass scans (and lists)
constexpr int kStages = 3;       // a warp's ring of K/V stages
constexpr int kMaxSplit = 16;    // the largest cluster Hopper schedules
static_assert(kScan * kWarps == 32, "one warp scans the per-warp counts");

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

// 16 int8 values, each byte sign-extended by an arithmetic shift.
template <>
__device__ __forceinline__ void to_f32<int8_t>(const uint4& raw, float* out) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = (float)((int)(w[i] << (24 - 8 * j)) >> 24);
}

// N consecutive elements of type T from global memory (16-byte aligned), as
// float32: N / (16 / sizeof(T)) vector loads.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  constexpr int PER = 16 / (int)sizeof(T);
  static_assert(N % PER == 0, "whole vectors");
#pragma unroll
  for (int i = 0; i < N / PER; ++i)
    to_f32<T>(*reinterpret_cast<const uint4*>(p + i * PER), out + i * PER);
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

// 16-byte copy into shared memory; bytes = 0 writes zeros, reads nothing.
__device__ __forceinline__ void async_copy16(void* dst, const void* src,
                                             int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum N values over the TPR lanes of a group (both powers of two; call
// with O = TPR / 2) and scatter the sums: afterwards lane li holds in v[j],
// j < max(N / TPR, 1), the full sum of value scatter_index(li, j). Where
// N < TPR, lanes that differ only in their low bits hold the same sums.
template <int N, int O>
__device__ __forceinline__ void reduce_scatter(float* v, int li) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool up = (li & O) != 0;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const float send = up ? v[k] : v[k + N / 2];
        const float keep = up ? v[k + N / 2] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      reduce_scatter<N / 2, O / 2>(v, li);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      reduce_scatter<1, O / 2>(v, li);
    }
  }
}

// Which of the N values lane li of a group holds in v[j] after
// reduce_scatter (each step keeps the upper half where the lane's bit is
// set).
template <int N, int TPR>
__device__ __forceinline__ int scatter_index(int li, int j) {
  int idx = j, n = N;
#pragma unroll
  for (int o = TPR / 2; o > 0; o /= 2) {
    if (n > 1) {
      if (li & o) idx += n / 2;
      n /= 2;
    }
  }
  return idx;
}

// A lane of the group that holds value idx after reduce_scatter.
__host__ __device__ constexpr int scatter_owner(int idx, int n, int tpr) {
  int lane = 0;
  for (int o = tpr / 2; o > 0 && n > 1; o /= 2, n /= 2)
    if (idx % n >= n / 2) lane |= o;
  return lane;
}

// KV: the type the K/V rows are stored in.
template <typename KV, int HD, int GMAX>
struct Tiling {
  static constexpr int VEC = 16 / sizeof(KV);         // elements per vector
  static constexpr int NV = HD / VEC;                 // vectors per row
  static constexpr int LV = NV > 32 ? NV / 32 : 1;    // vectors per lane
  static constexpr int TPR = NV / LV;                 // lanes per row
  static constexpr int EPL = VEC * LV;                // elements per lane
  static constexpr int RW = 32 / TPR;                 // groups per warp
  static constexpr int ROWB = HD * (int)sizeof(KV);   // bytes of a row
  // rows per group per stage: fewer where the scores of GMAX heads would
  // crowd the registers, and a stage of K and V at most 8 KB
  static constexpr int RPG_REG = GMAX * EPL >= 64 ? 4 : 8;
  static constexpr int RPG_MEM = 4096 / (RW * ROWB) > 0 ? 4096 / (RW * ROWB)
                                                        : 1;
  static constexpr int RPG = RPG_REG < RPG_MEM ? RPG_REG : RPG_MEM;
  static constexpr int NR = RW * RPG;                 // rows per stage
  static constexpr int STAGE = 2 * NR * ROWB;         // bytes: K, then V
  static constexpr int CPL = RPG * LV;                // copies/lane/tensor
  static constexpr int RING = kWarps * kStages * STAGE;
  // after the stream the ring holds each warp's partial (acc, m, l)
  static constexpr int MERGE = kWarps * GMAX * (HD + 2) * 4;
  static_assert(TPR >= 1 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "TPR");
  static_assert(MERGE <= RING, "warp partials fit in the ring");
};

template <typename KV>
constexpr bool kQuantized = sizeof(KV) == 1;  // int8 K/V with scales

// Dynamic shared memory of one CTA: the ring, the CTA's partial (read by
// the cluster), the merges' scratch, the listed rows' scales (int8 K/V), the
// row list, the scan counts and the staged ints.
template <typename KV, int HD, int GMAX>
__host__ __device__ constexpr int smem_floats_after_ring() {
  return GMAX * HD + 2 * GMAX           // pacc, pm, pl
         + 2 * kMaxSplit * GMAX + GMAX  // rm, rl, gl
         + kWarps * GMAX                // wsc
         + (kQuantized<KV> ? 2 * kList : 0);  // lks, lvs
}

template <typename KV, int HD, int GMAX>
__host__ __device__ constexpr size_t smem_bytes(int staged) {
  return (size_t)Tiling<KV, HD, GMAX>::RING +
         4 * (size_t)(smem_floats_after_ring<KV, HD, GMAX>() + kList + 33 +
                      staged);
}

// One CTA per (split, KV head, sequence): grid (nsplit, KH, B), clusters of
// (nsplit, 1, 1), kThreads threads. ksc/vsc: the (B, M, KH) scales of int8
// K/V, read at [slot * KH + kh]; unused (null) otherwise.
template <typename T, typename KV, int HD, int GMAX, typename Rows>
__global__ void __launch_bounds__(kThreads, 2) decode_kernel(
    const T* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ kpos, Rows rows,
    const int* __restrict__ q_pos, T* __restrict__ out, int H, int KH,
    float scale, int window, float softcap) {
  using Tl = Tiling<KV, HD, GMAX>;
  constexpr bool kQuant = kQuantized<KV>;
  constexpr int kSL = kQuant ? kList : 0;  // scales listed beside the rows
  constexpr int VEC = Tl::VEC, NV = Tl::NV, LV = Tl::LV, TPR = Tl::TPR;
  constexpr int EPL = Tl::EPL, RW = Tl::RW, ROWB = Tl::ROWB, RPG = Tl::RPG;
  constexpr int NR = Tl::NR, STAGE = Tl::STAGE, CPL = Tl::CPL;
  constexpr unsigned kAll = 0xffffffffu;

  extern __shared__ __align__(16) unsigned char fd_smem[];
  unsigned char* ring = fd_smem;
  float* pacc = reinterpret_cast<float*>(fd_smem + Tl::RING);  // GMAX x HD
  float* pm = pacc + GMAX * HD;
  float* pl = pm + GMAX;
  float* rm = pl + GMAX;     // kMaxSplit x GMAX: each CTA's m, then scale
  float* rl = rm + kMaxSplit * GMAX;       // kMaxSplit x GMAX: each CTA's l
  float* gl = rl + kMaxSplit * GMAX;       // GMAX: the merged l
  float* wsc = gl + GMAX;                  // kWarps x GMAX: warp scales
  float* lks = wsc + kWarps * GMAX;        // kSL: the listed rows' scales
  float* lvs = lks + kSL;
  int* list = reinterpret_cast<int*>(lvs + kSL);
  int* cnt = list + kList;                 // 32 counts, then the total
  int* staged = cnt + 33;

  const int nsplit = gridDim.x, rank = blockIdx.x;  // cluster = grid x
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int grp = lane / TPR, li = lane % TPR;
  const int qp = q_pos[b];
  T* orow = out + ((size_t)b * H + kh * G) * HD;
  if (qp < 0) {  // inactive row (the whole cluster): zeros, no other reads
    for (int e = rank * kThreads + tid; e < G * HD; e += nsplit * kThreads)
      store_out(orow + e, 0.f);
    return;
  }

  float qr[GMAX][EPL], acc[GMAX][EPL], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int lv = 0; lv < LV; ++lv) {
      if (g < G) {
        load_f32<T, VEC>(
            q + ((size_t)b * H + kh * G + g) * HD + (lv * TPR + li) * VEC,
            qr[g] + lv * VEC);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) qr[g][lv * VEC + j] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < EPL; ++j) acc[g][j] = 0.f;
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  rows.stage(b, staged);
  __syncthreads();
  const int ntok = rows.ntok(qp);
  const int ntiles = (ntok + kTile - 1) / kTile;
  const int ncand =
      rank < ntiles ? (ntiles - rank + nsplit - 1) / nsplit * kTile : 0;
  const KV* kb = k + (size_t)kh * HD;
  const KV* vb = v + (size_t)kh * HD;
  const size_t rstride = (size_t)KH * HD;  // elements from slot to slot
  unsigned char* wring = ring + w * kStages * STAGE;

  for (int c0 = 0; c0 < ncand; c0 += kList) {
    // scan: candidate c of this CTA is token c % kTile of its tile c/kTile
    int slot[kScan], kp[kScan];
    float ks[kQuant ? kScan : 1], vs[kQuant ? kScan : 1];
#pragma unroll
    for (int i = 0; i < kScan; ++i) {
      const int c = c0 + i * kThreads + tid;
      const int n = (rank + c / kTile * nsplit) * kTile + c % kTile;
      slot[i] = c < ncand && n < ntok ? rows.slot(b, n, staged) : -1;
      kp[i] = slot[i] >= 0 ? kpos[slot[i]] : -1;
      if constexpr (kQuant) {  // read beside kpos, not after it
        const size_t si = (size_t)(slot[i] >= 0 ? slot[i] : 0) * KH + kh;
        ks[i] = slot[i] >= 0 ? ksc[si] : 0.f;
        vs[i] = slot[i] >= 0 ? vsc[si] : 0.f;
      }
    }
    unsigned bal[kScan];
#pragma unroll
    for (int i = 0; i < kScan; ++i) {
      bal[i] = __ballot_sync(kAll, key_valid(kp[i], qp, window));
      if (lane == 0) cnt[i * kWarps + w] = __popc(bal[i]);
    }
    __syncthreads();
    if (w == 0) {  // exclusive scan of the 32 counts, in token order
      const int x = cnt[lane];
      int incl = x;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const int y = __shfl_up_sync(kAll, incl, off);
        if (lane >= off) incl += y;
      }
      cnt[lane] = incl - x;
      if (lane == 31) cnt[32] = incl;
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int i = 0; i < kScan; ++i)
      if (bal[i] >> lane & 1u) {
        const int at = cnt[i * kWarps + w] + __popc(bal[i] & below);
        list[at] = slot[i];
        if constexpr (kQuant) {
          lks[at] = ks[i];
          lvs[at] = vs[i];
        }
      }
    __syncthreads();
    const int nv = cnt[32];

    // stream: warp w takes stages w, w + kWarps, ... of NR listed rows
    const int nst =
        nv > w * NR ? (nv - w * NR + kWarps * NR - 1) / (kWarps * NR) : 0;
    auto issue = [&](int s) {
      unsigned char* st = wring + (s % kStages) * STAGE;
      const int row0 = (s * kWarps + w) * NR;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int ch = lane + 32 * j, r = ch / NV, col = ch % NV;
        const bool ok = row0 + r < nv;
        const size_t off =
            (ok ? (size_t)list[row0 + r] * rstride : 0) + col * VEC;
        async_copy16(st + r * ROWB + col * 16, kb + off, ok ? 16 : 0);
        async_copy16(st + (NR + r) * ROWB + col * 16, vb + off, ok ? 16 : 0);
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nst) issue(s);
      async_commit();
    }
    for (int s = 0; s < nst; ++s) {
      if (s + kStages - 1 < nst) issue(s + kStages - 1);
      async_commit();
      async_wait<kStages - 1>();
      __syncwarp();
      const unsigned char* st = wring + (s % kStages) * STAGE;
      const int row0 = (s * kWarps + w) * NR;
      // partial dots of this lane's slice, then each lane's share of the
      // G*RPG sums: the softcap and the exponentials run once per score
      constexpr int N = GMAX * RPG, VPL = N / TPR > 0 ? N / TPR : 1;
      float part[N];
#pragma unroll
      for (int i = 0; i < RPG; ++i) {
        const int r = grp + i * RW;
        float kf[EPL];
#pragma unroll
        for (int lv = 0; lv < LV; ++lv)
          to_f32<KV>(*reinterpret_cast<const uint4*>(
                         st + r * ROWB + (lv * TPR + li) * 16),
                     kf + lv * VEC);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          float d = 0.f;
#pragma unroll
          for (int j = 0; j < EPL; ++j) d = fmaf(qr[g][j], kf[j], d);
          part[g * RPG + i] = d;
        }
      }
      reduce_scatter<N, TPR / 2>(part, li);
      float mine[VPL];
      bool okv[VPL];
      int gv[VPL];
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int idx = scatter_index<N, TPR>(li, j);
        const int row = row0 + grp + idx % RPG * RW;
        gv[j] = idx / RPG;
        okv[j] = gv[j] < G && row < nv;
        float dot = part[j];
        if constexpr (kQuant) dot *= okv[j] ? lks[row] : 0.f;
        mine[j] = okv[j] ? cap_score(dot * scale, softcap) : kNegInf;
      }
      float sc[GMAX][RPG];
#pragma unroll
      for (int idx = 0; idx < N; ++idx)
        sc[idx / RPG][idx % RPG] = __shfl_sync(
            kAll, mine[idx % VPL], grp * TPR + scatter_owner(idx, N, TPR));
      // online softmax of this group's rows, one rescale a stage
      float alpha[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float mx = m[g];
#pragma unroll
        for (int i = 0; i < RPG; ++i) mx = fmaxf(mx, sc[g][i]);
        alpha[g] = expf(m[g] - mx);
        m[g] = mx;
      }
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        float mg = kNegInf;
#pragma unroll
        for (int g = 0; g < GMAX; ++g) mg = g == gv[j] ? m[g] : mg;
        mine[j] = okv[j] ? expf(mine[j] - mg) : 0.f;
      }
#pragma unroll
      for (int idx = 0; idx < N; ++idx)
        sc[idx / RPG][idx % RPG] = __shfl_sync(
            kAll, mine[idx % VPL], grp * TPR + scatter_owner(idx, N, TPR));
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < RPG; ++i) sum += sc[g][i];
        l[g] = l[g] * alpha[g] + sum;
#pragma unroll
        for (int j = 0; j < EPL; ++j) acc[g][j] *= alpha[g];
      }
#pragma unroll
      for (int i = 0; i < RPG; ++i) {
        const int r = grp + i * RW;
        float vf[EPL];
#pragma unroll
        for (int lv = 0; lv < LV; ++lv)
          to_f32<KV>(*reinterpret_cast<const uint4*>(
                         st + (NR + r) * ROWB + (lv * TPR + li) * 16),
                     vf + lv * VEC);
        float vsr = 1.f;  // p * v_scale weights an int8 V row
        if constexpr (kQuant) vsr = row0 + r < nv ? lvs[row0 + r] : 0.f;
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g >= G) break;
          const float wt = kQuant ? sc[g][i] * vsr : sc[g][i];
#pragma unroll
          for (int j = 0; j < EPL; ++j)
            acc[g][j] = fmaf(wt, vf[j], acc[g][j]);
        }
      }
      __syncwarp();  // every lane is done with this stage before its refill
    }
    async_wait<0>();
    __syncthreads();  // the list is rewritten by the next pass
  }

  // merge the warp's groups (lanes TPR apart hold the same columns)
#pragma unroll
  for (int off = TPR; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float mo = __shfl_xor_sync(kAll, m[g], off);
      const float lo = __shfl_xor_sync(kAll, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float a = expf(m[g] - mx), c = expf(mo - mx);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int j = 0; j < EPL; ++j)
        acc[g][j] = acc[g][j] * a + __shfl_xor_sync(kAll, acc[g][j], off) * c;
      m[g] = mx;
    }
  }
  // then the CTA's warps, through the (now idle) ring
  float* wacc = reinterpret_cast<float*>(ring);       // kWarps x GMAX x HD
  float* wm = wacc + kWarps * GMAX * HD;              // kWarps x GMAX
  float* wl = wm + kWarps * GMAX;
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int lv = 0; lv < LV; ++lv)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          wacc[(w * GMAX + g) * HD + (lv * TPR + li) * VEC + j] =
              acc[g][lv * VEC + j];
  }
  if (lane < GMAX) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g == lane) {
        wm[w * GMAX + g] = m[g];
        wl[w * GMAX + g] = l[g];
      }
  }
  __syncthreads();
  if (tid < G) {
    const int g = tid;
    float M = kNegInf;
    for (int x = 0; x < kWarps; ++x) M = fmaxf(M, wm[x * GMAX + g]);
    float L = 0.f;
    for (int x = 0; x < kWarps; ++x) {
      const float s = expf(wm[x * GMAX + g] - M);
      wsc[x * GMAX + g] = s;
      L += wl[x * GMAX + g] * s;
    }
    pm[g] = M;
    pl[g] = L;
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    float sum = 0.f;
#pragma unroll
    for (int x = 0; x < kWarps; ++x)
      sum += wacc[(x * GMAX + g) * HD + d] * wsc[x * GMAX + g];
    if (nsplit == 1)
      store_out(orow + e, sum / fmaxf(pl[g], 1e-30f));
    else
      pacc[e] = sum;
  }
  if (nsplit == 1) return;

  // then the cluster: each CTA writes its share of the G*HD outputs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (tid < nsplit * GMAX) {       // one remote read per (CTA, head)
    const int r = tid / GMAX, g = tid % GMAX;
    rm[tid] = cluster.map_shared_rank(pm, r)[g];
    rl[tid] = cluster.map_shared_rank(pl, r)[g];
  }
  __syncthreads();
  if (tid < G) {
    const int g = tid;
    float M = kNegInf;
    for (int r = 0; r < nsplit; ++r) M = fmaxf(M, rm[r * GMAX + g]);
    float L = 0.f;
    for (int r = 0; r < nsplit; ++r) {
      const float s = expf(rm[r * GMAX + g] - M);
      rm[r * GMAX + g] = s;
      L += rl[r * GMAX + g] * s;
    }
    gl[g] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int e = rank * kThreads + tid; e < G * HD; e += nsplit * kThreads) {
    const int g = e / HD;
    float sum = 0.f;
#pragma unroll 4
    for (int r = 0; r < nsplit; ++r)
      sum += cluster.map_shared_rank(pacc, r)[e] * rm[r * GMAX + g];
    store_out(orow + e, sum / gl[g]);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// What the host needs to size a launch of one instance, found once per
// shared-memory size: the largest cluster the card schedules and, for
// each cluster size, how many such clusters it holds at once.
struct LaunchInfo {
  size_t smem = 0;
  int max_cluster = 0;
  int clusters[kMaxSplit + 1] = {};
};

template <typename Kernel>
cudaError_t launch_info(Kernel kernel, size_t smem, LaunchInfo& info) {
  if (info.smem == smem) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxSplit, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int largest = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxPotentialClusterSize(&largest, kernel, &cfg);
  if (largest > kMaxSplit) largest = kMaxSplit;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int n = 1; n <= largest && e == cudaSuccess; ++n) {
    cfg.gridDim = dim3(n, 1, 1);
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    e = cudaOccupancyMaxActiveClusters(&info.clusters[n], kernel, &cfg);
  }
  if (e != cudaSuccess) return e;
  if (largest < 1 || info.clusters[1] < 1)
    return cudaErrorInvalidConfiguration;
  info.smem = smem;
  info.max_cluster = largest;
  return cudaSuccess;
}

// CTAs per (KV head, sequence): the largest cluster whose B*KH clusters
// the card holds at once (a second wave costs more than a smaller split
// saves), with at least two scan tiles of candidates each.
inline int split_count(const LaunchInfo& info, int B, int KH, int cap) {
  const int by_tokens = (cap + 2 * kTile - 1) / (2 * kTile);
  int n = 1;
  for (int c = 2; c <= info.max_cluster && c <= by_tokens; ++c)
    if (info.clusters[c] >= B * KH) n = c;
  return n;
}

// Launch the instance for GMAX >= G; cap = the tokens a row can hold (M or
// pmax * ps). With split != nullptr, only report the split it would use.
template <typename T, typename KV, int HD, int GMAX, typename Rows>
cudaError_t launch_group(const void* q, const void* k, const void* v,
                         const float* ksc, const float* vsc, const int* kpos,
                         Rows rows, const int* qpos, void* out, int B, int H,
                         int KH, int cap, float scale, int window,
                         float softcap, cudaStream_t stream, int* split) {
  auto kernel = decode_kernel<T, KV, HD, GMAX, Rows>;
  static LaunchInfo info;
  const size_t smem = smem_bytes<KV, HD, GMAX>(rows.staged());
  cudaError_t e = launch_info(kernel, smem, info);
  if (e != cudaSuccess) return e;
  const int nsplit = split_count(info, B, KH, cap);
  if (split != nullptr) {
    *split = nsplit;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, KH, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, (const T*)q, (const KV*)k,
                         (const KV*)v, ksc, vsc, kpos, rows, qpos, (T*)out,
                         H, KH, scale, window, softcap);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Launch the instance for the query group size G = H / KH (at most 8).
// ksc/vsc: the scales of int8 K/V (KV = int8_t), null otherwise.
template <typename T, typename KV, int HD, typename Rows>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const float* ksc, const float* vsc,
                          const int* kpos, Rows rows, const int* qpos,
                          void* out, int B, int H, int KH, int cap,
                          float scale, int window, float softcap,
                          cudaStream_t stream, int* split = nullptr) {
  const int G = H / KH;
#define FD_LAUNCH(GMAX)                                                 \
  return launch_group<T, KV, HD, GMAX, Rows>(q, k, v, ksc, vsc, kpos,   \
                                             rows, qpos, out, B, H, KH, \
                                             cap, scale, window,        \
                                             softcap, stream, split)
  if (G <= 2) FD_LAUNCH(2);
  if (G <= 4) FD_LAUNCH(4);
  FD_LAUNCH(8);
#undef FD_LAUNCH
}

}  // namespace flash_decode
