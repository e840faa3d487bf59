// Tensor-core attention tile for Hopper (sm_90a), shared by the bf16
// kernels of flash_attention.cu and paged_decode_attention.cu.
//
// One block takes up to NWG*64 query rows of one (sequence, KV head): the
// rows are the flattened (position, query head) pairs row = position*G + g
// of that KV head's group, so every K/V tile staged in shared memory
// serves the whole group. The block has NWG consumer warpgroups (64 rows
// each) and one producer warpgroup after them:
//
//   producer  fills a ring of kStages K/V tiles (kBN keys each) in shared
//             memory, ahead of the consumers. Each stage has a "full"
//             mbarrier (the tile has landed) and an "empty" one (every
//             consumer warp is done with it), for its K and V apart.
//             The caller's producer moves the bytes: TMA from one
//             thread for flash_attention, a
//             cp.async gather through the block table by the whole
//             warpgroup for the paged kernel. With two consumer
//             warpgroups the producer gives its registers to them
//             (setmaxnreg, producer_regs and consumer_regs), since an
//             SM's registers are split between its four schedulers and a
//             block of 3 warpgroups otherwise gets only 168 a thread, too
//             few for the accumulators without spills.
//   consumers per key tile, S = Q K^T by wgmma m64n{kBN}k16 with both
//             operands in shared memory (bf16, float32 accumulators in
//             registers); scale, optional softcap (accurate tanhf), the
//             mask, and the online softmax on the accumulator registers
//             in float32 (running max and sum per row, exp2 of scores
//             pre-scaled by log2 e); P rounded to bf16 in registers and
//             O += P V by wgmma m64n{hd}k16 with P as the register A
//             operand and V read in its stored (keys, hd) layout through
//             the transpose bit of its descriptor. Pipelined by one
//             tile (consume): Q K^T of a tile goes with P V of the one
//             before.
//
// Shared memory operands are stored as wgmma's canonical swizzled layouts:
// rows of 128 bytes (64 bf16) with the 128-byte swizzle, or of 64 bytes
// with the 64-byte swizzle at hd 32; a row wider than that is split into
// column chunks of 64 (32) elements, each chunk a [rows x 128 (64) B]
// block, 1024-byte aligned. That is the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B (64B) for a box of 64 (32) x rows, and the
// one the cp.async gather and the Q load write by hand (swz_offset).
//
// A row with no valid key comes out as 0: its probabilities are exactly 0
// and the denominator is floored at 1e-30.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;

// Tiling by head_dim: key tile, ring depth and the swizzled row width.
template <int HD>
struct Cfg {
  static constexpr int kBN = HD == 256 ? 64 : 128;     // keys per tile
  static constexpr int kStages = HD >= 128 ? 2 : 4;    // ring depth
  static constexpr int kRowBytes = HD >= 64 ? 128 : 64;  // swizzle width
  static constexpr int kChunkCols = kRowBytes / 2;     // bf16 per chunk row
  static constexpr int kChunks = HD / kChunkCols;      // column chunks
  static constexpr int kUnits = kRowBytes / 16;        // 16 B units per row
  static constexpr int kTileBytes = kBN * HD * 2;      // one K (or V) tile
  static constexpr int kLayout = kRowBytes == 128 ? 1 : 2;  // descriptor
  static_assert(HD == 32 || HD == 64 || HD == 128 || HD == 256, "head_dim");
};

// Byte offset of 16-byte unit u of row r inside one swizzled chunk.
template <int HD>
__device__ __forceinline__ uint32_t swz_offset(int r, int u) {
  using C = Cfg<HD>;
  const int x = C::kRowBytes == 128 ? (r & 7) : ((r >> 1) & 3);
  return (uint32_t)(r * C::kRowBytes + ((u ^ x) << 4));
}

// Byte offset of the 16-byte vector c (of HD/8) of row r in a swizzled
// [rows x HD] operand.
template <int HD>
__device__ __forceinline__ uint32_t operand_offset(int rows, int r, int c) {
  using C = Cfg<HD>;
  return (uint32_t)((c / C::kUnits) * rows * C::kRowBytes) +
         swz_offset<HD>(r, c % C::kUnits);
}

// ---------------------------------------------------------------------------
// The block's shared memory, from a 1024-byte aligned base:
//   [Q: kRows x HD] [ring: kStages x (K tile, V tile)] [full and empty
//   mbarriers] [the caller's region]
// ---------------------------------------------------------------------------
template <int HD, int NWG>
struct Smem {
  using C = Cfg<HD>;
  static constexpr int kRows = NWG * 64;
  static constexpr int kThreads = (NWG + 1) * 128;  // + the producer
  static constexpr uint32_t kRing = kRows * HD * 2;
  static constexpr uint32_t kStageBytes = 2 * C::kTileBytes;
  static constexpr uint32_t kBars = kRing + C::kStages * kStageBytes;
  static constexpr uint32_t kExtra = kBars + 4 * C::kStages * 8;

  __device__ static uint32_t k_tile(uint32_t base, int stage) {
    return base + kRing + stage * kStageBytes;
  }
  __device__ static uint32_t v_tile(uint32_t base, int stage) {
    return k_tile(base, stage) + C::kTileBytes;
  }
  // mbarriers: the K half (v = 0) or V half (v = 1) of a stage has landed
  // (full) or every consumer warp is done with it (empty)
  __device__ static uint32_t full(uint32_t base, int v, int stage) {
    return base + kBars + 8 * (v * C::kStages + stage);
  }
  __device__ static uint32_t empty(uint32_t base, int v, int stage) {
    return base + kBars + 8 * ((2 + v) * C::kStages + stage);
  }
};

// One thread: the full barriers of K and V expect the producer's
// arrivals, the empty ones one arrival per consumer warp. K and V have
// barriers of their own, so a stage's K is refilled as soon as its scores
// are taken, while its V waits for P V one tile later.
template <int HD, int NWG>
__device__ __forceinline__ void init_barriers(uint32_t base, int k_arrivals,
                                              int v_arrivals) {
  using L = Smem<HD, NWG>;
#pragma unroll
  for (int s = 0; s < Cfg<HD>::kStages; ++s) {
    mbar_init(L::full(base, 0, s), k_arrivals);
    mbar_init(L::full(base, 1, s), v_arrivals);
#pragma unroll
    for (int v = 0; v < 2; ++v) mbar_init(L::empty(base, v, s), NWG * 4);
  }
  fence_barrier_init();
}

// Where the query rows live: row = position*G + g of KV head kh, query
// head kh*G + g, in a (B, L, H, HD) tensor (L = S or T).
struct Rows {
  int b, kh, G, H, L, R, r0;
  __device__ size_t offset(int row, int HD) const {
    return (((size_t)b * L + row / G) * H + kh * G + row % G) * HD;
  }
};

// Consumer warpgroup ``wg`` stages its 64 query rows (zeros past R) into
// the swizzled Q block with 16-byte loads; then its wgmma may read them.
template <int HD, int NWG>
__device__ __forceinline__ void load_q(uint8_t* sm,
                                       const __nv_bfloat16* __restrict__ q,
                                       const Rows& rows, int wg, int tid_wg) {
  constexpr int CH = HD / 8;
  for (int idx = tid_wg; idx < 64 * CH; idx += 128) {
    const int r = idx / CH, c = idx % CH, rb = wg * 64 + r, row = rows.r0 + rb;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows.R)
      val = *reinterpret_cast<const uint4*>(q + rows.offset(row, HD) + c * 8);
    *reinterpret_cast<uint4*>(sm + operand_offset<HD>(NWG * 64, rb, c)) = val;
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
}

// Scale, softcap and mask one S tile (in log2 units), and return each of
// the thread's two rows' max over it.
template <int BN, bool CAP, bool MASK, typename Tiles>
__device__ __forceinline__ void score_tile(float (&s)[BN / 2], float (&mx)[2],
                                           const Tiles& tiles, int c0,
                                           int stage, int quad, float scale,
                                           float softcap) {
  // one multiply before and one after the cap: (s * scale / cap), then
  // tanh * (cap * log2 e); without a cap s * (scale * log2 e)
  const float pre = CAP ? scale / softcap : scale * kLog2e;
  const float post = softcap * kLog2e;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * quad + (i & 1);
    float x = s[i] * pre;
    if (CAP) x = tanhf(x) * post;
    if (MASK && !tiles.valid(c0, stage, col, r)) x = -INFINITY;
    s[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
}

// Issue O += P V for one key tile: P (64 x BN) as the register A operand,
// V (BN x HD) from its ring stage through the MN-major (transpose)
// descriptor; hd 256 takes two wgmma of width 128.
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&o)[HD / 2], const uint32_t (&pa)[Cfg<HD>::kBN / 16][4],
    uint32_t v_addr) {
  using C = Cfg<HD>;
  constexpr int BN = C::kBN, RB = C::kRowBytes;
  constexpr int NPV = HD == 256 ? 128 : HD;           // P V wgmma width
#pragma unroll
  for (int t = 0; t < BN / 16; ++t) {
#pragma unroll
    for (int h = 0; h < HD / NPV; ++h) {
      const uint64_t db = make_desc(
          v_addr + t * 16 * RB + h * (NPV / C::kChunkCols) * BN * RB,
          BN * RB, 8 * RB, C::kLayout);
      wgmma_rs<NPV>(*reinterpret_cast<float(*)[NPV / 2]>(o + h * NPV / 2),
                    pa[t], db);
    }
  }
}

// The consumer warpgroup's loop over the block's ``ntiles`` key tiles.
// ``tiles`` says where tile ``it`` starts (key0), whether this
// warpgroup's rows see any of it (visible; the tiles a warpgroup sees
// are contiguous), whether it needs the elementwise mask (needs_mask,
// of the tile's index and first key) and which (row, key) pairs are
// valid. On return o holds the
// unnormalised output rows and l the thread's partial row sums (both in
// the wgmma accumulator layout).
//
// Software pipelined by one tile: Q K^T of tile i and P V of tile i-1 are
// issued together, and tile i's scores, max and exponentials run on the
// CUDA cores while the tensor cores finish P V; O is rescaled once that
// is done. Tile i's K goes back to the producer once its scores are
// taken (the mask reads the stage's kpos), tile i-1's V after its P V.
// The first and last tiles are peeled off the loop, so that no wgmma is
// issued under a branch inside it (ptxas serialises every wgmma of a
// kernel that has one).
template <int HD, int NWG, typename Tiles>
__device__ __forceinline__ void consume(uint8_t* sm, int wg, int ntiles,
                                        const Tiles& tiles, float scale,
                                        float softcap, float (&o)[HD / 2],
                                        float (&l)[2]) {
  using C = Cfg<HD>;
  using L = Smem<HD, NWG>;
  constexpr int BN = C::kBN, RB = C::kRowBytes, S = C::kStages;
  constexpr int KSTEPS = RB / 32;                      // k16 steps per chunk
  const uint32_t base = smem_u32(sm);
  const uint32_t q_addr = base + wg * 64 * RB;
  const int lane = threadIdx.x % 32, quad = lane & 3;
  float m[2] = {-INFINITY, -INFINITY};
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  uint32_t pa[BN / 16][4];      // the previous tile's P, bf16 pairs

  auto release = [&](int it) {  // a tile these rows do not see
    const int stage = it % S;
    const uint32_t parity = (it / S) & 1;
    mbar_wait(L::full(base, 0, stage), parity);
    mbar_wait(L::full(base, 1, stage), parity);
    if (lane == 0) {
      mbar_arrive(L::empty(base, 0, stage));
      mbar_arrive(L::empty(base, 1, stage));
    }
  };

  // Q K^T of tile it (with P V of tile it-1 when PREV), its softmax, and
  // its P packed into pa for the next step.
  auto step = [&](int it, auto prev_tile) {
    constexpr bool PREV = decltype(prev_tile)::value;
    const int stage = it % S, pstage = (it + S - 1) % S;
    const uint32_t parity = (it / S) & 1, pparity = ((it - 1) / S) & 1;
    mbar_wait(L::full(base, 0, stage), parity);
    fence_proxy_async();        // cp.async's writes, before wgmma reads
    const int c0 = tiles.key0(it);
    const uint32_t k_addr = L::k_tile(base, stage);
    float s[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint32_t off = (ks % KSTEPS) * 32;   // within the row
      const uint64_t da = make_desc(
          q_addr + (ks / KSTEPS) * (NWG * 64 * RB) + off, 16, 8 * RB,
          C::kLayout);
      const uint64_t db = make_desc(k_addr + (ks / KSTEPS) * (BN * RB) + off,
                                    16, 8 * RB, C::kLayout);
      wgmma_ss<BN>(s, da, db, ks > 0);
    }
    wgmma_commit();
    if constexpr (PREV) {
      mbar_wait(L::full(base, 1, pstage), pparity);
      fence_proxy_async();
      issue_pv<HD>(o, pa, L::v_tile(base, pstage));
      wgmma_commit();
      wgmma_wait<1>();          // Q K^T is done; P V may still run
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);

    float mx[2] = {-INFINITY, -INFINITY};
    const bool masked = tiles.needs_mask(it, c0);
    if (softcap != 0.f) {
      if (masked)
        score_tile<BN, true, true>(s, mx, tiles, c0, stage, quad, scale,
                                   softcap);
      else
        score_tile<BN, true, false>(s, mx, tiles, c0, stage, quad, scale,
                                    softcap);
    } else {
      if (masked)
        score_tile<BN, false, true>(s, mx, tiles, c0, stage, quad, scale,
                                    softcap);
      else
        score_tile<BN, false, false>(s, mx, tiles, c0, stage, quad, scale,
                                     softcap);
    }
    if (lane == 0) mbar_arrive(L::empty(base, 0, stage));   // K is done
    float mu[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;   // no valid key yet
      alpha[r] = fast_exp2(m[r] - mu[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = fast_exp2(s[i] - mu[r]);
      sum[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
    if constexpr (PREV) {       // the previous tile's P V is in O
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(L::empty(base, 1, pstage));
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int t = 0; t < BN / 16; ++t) {
      pa[t][0] = pack_bf16(s[8 * t], s[8 * t + 1]);
      pa[t][1] = pack_bf16(s[8 * t + 2], s[8 * t + 3]);
      pa[t][2] = pack_bf16(s[8 * t + 4], s[8 * t + 5]);
      pa[t][3] = pack_bf16(s[8 * t + 6], s[8 * t + 7]);
    }
  };

  int first = 0;
  while (first < ntiles && !tiles.visible(tiles.key0(first))) release(first++);
  int end = first;
  while (end < ntiles && tiles.visible(tiles.key0(end))) ++end;
  if (first < end) {
    step(first, std::false_type{});
    for (int it = first + 1; it < end; ++it) step(it, std::true_type{});
    const int stage = (end - 1) % S;          // the last tile's P V
    mbar_wait(L::full(base, 1, stage), ((end - 1) / S) & 1);
    fence_proxy_async();
    wgmma_fence();
    issue_pv<HD>(o, pa, L::v_tile(base, stage));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(L::empty(base, 1, stage));
  }
  for (int it = end; it < ntiles; ++it) release(it);
}

// Normalise and store the warpgroup's rows (rows past R are not stored).
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           const Rows& rows, int wg,
                                           const float (&o)[HD / 2],
                                           float (&l)[2]) {
  const int lane = threadIdx.x % 32, quad = lane & 3;
  const int warp = (threadIdx.x / 32) % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    const int row = rows.r0 + wg * 64 + 16 * warp + lane / 4 + 8 * r;
    if (row >= rows.R) continue;
    __nv_bfloat16* orow = out + rows.offset(row, HD);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * quad) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

}  // namespace tc
