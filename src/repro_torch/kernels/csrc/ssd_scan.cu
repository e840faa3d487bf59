// Chunked SSD scan (Mamba-2 state-space duality) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/ssd_scan.py: ssd_scan (_ssd_kernel), and adds an
// initial state, which the reference model's chunked scan takes.
//
// Semantics (the plain PyTorch version is repro_torch/kernels/ref.py
// ssd_scan_ref): x (B, L, nh, hp) float32 or bfloat16; dt (B, L, nh)
// float32, post-softplus; A (nh,) float32, negative; Bm/Cm (B, L, N) in x's
// type, shared by the heads (groups = 1); s0 (B, nh, hp, N) float32 or
// null (zeros). Outputs y (B, L, nh, hp) and the final state (B, nh, hp, N),
// both float32. Per chunk of Q positions, with cum the inclusive cumsum of
// dt*A over the chunk and S the (hp, N) state carried from chunk to chunk:
//   intra  y_t  = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//   inter  y_t += exp(cum_t) (C_t S^T)
//   state  S    = exp(cum_Q) S + x^T (B * dt exp(cum_Q - cum))
// exp(cum_t - cum_s) is evaluated only where s <= t: above the diagonal it
// overflows, and inf times the causal mask's zero would be NaN (the Pallas
// kernel's where hides that). The cumsum is taken in order by one thread,
// so a position with dt = 0 adds exactly nothing to it; such a position
// decays by exp(0) = 1 and injects nothing, so it leaves the state exactly
// as it was.
//
// bfloat16: the tensor-core kernel (ssd_scan_tc_kernel). One warpgroup (128
// threads) per (head, row) walks the row's chunks in order. Q is padded to
// a tile of QT = 64 or 128 positions and N to NT = 64 or 128 with
// positions and state columns that contribute exactly zero (x = B = C = 0,
// dt = 0); hp is padded to 64. A chunk's x (QT x 64) and B (QT x NT) and
// 64 rows of C at a time (64 x NT) are staged in shared memory with
// cp.async in wgmma's 128-byte swizzled layout. Per tile of 64 rows t (the
// rows of tile r see positions s < 64 (r + 1)):
//   readout  R = C S_hi^T + C S_lo^T      wgmma m64n64k16, both K-major
//   scores   G = C B^T                    wgmma m64n{64,128}k16, K-major
//   y        = exp(cum_t) R + M x         M = G exp(cum_t - cum_s) dt_s on
//            s <= t, formed on G's accumulator registers in float32 and
//            rounded to bf16 once as the register A operand; x read through
//            the transpose bit of its descriptor (MN-major), as P V in
//            tc_attention.cuh
// and then the state, which lives in float32 in the warpgroup's
// accumulator registers (64 x NT) for the whole row:
//   S = exp(cum_Q) S + (x w)_hi^T B + (x w)_lo^T B
//                         wgmma m64n{NT}k16 onto the decayed state, B
//                         MN-major, w = dt exp(cum_Q - cum)
// and S is written to shared memory as S_hi = bf16(S), S_lo = bf16(S -
// S_hi) for the next chunk's readout. Where N <= 16 only the first k16
// step of N enters the readout and C B^T.
//
// The loads run ahead: the next chunk's x and dt start once the state
// update has read x into registers, its first C tile once the last row
// tile has read C, its B once the update's products are done; a chunk's
// second C tile starts once the first has been read. Below a tile's
// diagonal block the decay factors into a row and a column term, each at
// most 1.
//
// Precision: C, B and x arrive in bf16, so they are exact operands; the
// products are exact and summed in float32. M is rounded once (2^-8 of
// each intra term; the caller rounds y to bf16 right after the call). The
// state and what enters it keep about 16 bits: S and x w pass to the
// tensor cores as hi/lo pairs (2^-16 of each term), and S never passes
// through bf16 itself. chip_smoke.ssd_tc_bound states the bound the card
// is held to.
//
// Occupancy and what bounds it: at QT = NT = 128 a block takes 100 KB of
// shared memory and up to 255 registers a thread, so two share an SM (the
// grid is nh x B blocks: 512 at mamba2-370m's serving shape); at NT = 64
// 60 KB and 168 registers, three (800 blocks at hymba-1.5b's). The
// function moves ~86 MB at both shapes (x, y, the states in and out) for
// 10-15 GFLOP of bf16 products, so the bytes bind. What is left: a block's
// steps still wait on each other (one warpgroup, no warp specialisation),
// and C B^T is computed per head; sharing it across heads is left for a
// profile that shows the tensor cores setting the pace.
//
// float32: the CUDA-core kernel (ssd_scan_kernel), one block per (head,
// row) with the state in shared memory and every product a register-tiled
// float32 loop, held to the plain version within 1e-5.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 512;        // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // rows of C and of the (Q, Q) matrix
constexpr int kMaxQ = 128, kMaxHP = 64, kMaxN = 128;

// acc[r][c] += sum_{k < K} a(i, k) * b(k, j) for row i = warp + kWarps*r
// (< rows) and column j = lane + 32*c (< cols) of a product whose operands
// lie in shared memory. Out-of-range rows and columns accumulate zeros.
template <int RM, int RN, class FA, class FB>
__device__ __forceinline__ void product(float (&acc)[RM][RN], int rows,
                                        int cols, int K, FA a, FB b) {
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RM], bv[RN];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = ty + kWarps * r;
      av[r] = i < rows ? a(i, k) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int j = tx + 32 * c;
      bv[c] = j < cols ? b(k, j) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

size_t smem_floats(int Q, int hp, int N) {
  const int tile = Q < kTile ? Q : kTile;
  return (size_t)Q * hp              // x chunk
         + (size_t)Q * (N + 1)       // B chunk
         + (size_t)hp * (N + 1)      // state
         + (size_t)tile * N          // C tile
         + (size_t)tile * Q          // M tile
         + 4 * (size_t)Q;            // dt, cum, exp(cum), state weights
}

// One block per (head h, row b).
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ x,
                    const float* __restrict__ dt,
                    const float* __restrict__ A,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ s0, float* __restrict__ y,
                    float* __restrict__ s_fin, int L, int nh, int hp, int N,
                    int Q) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;
  const int tile = Q < kTile ? Q : kTile, NP = N + 1;
  float* xs = smem;                  // (Q, hp)
  float* bs = xs + Q * hp;           // (Q, NP)
  float* ss = bs + Q * NP;           // (hp, NP): the carried state
  float* cs = ss + hp * NP;          // (tile, N)
  float* ms = cs + tile * N;         // (tile, Q)
  float* dts = ms + tile * Q;        // (Q,)
  float* cum = dts + Q;              // (Q,)
  float* ecum = cum + Q;             // (Q,) exp(cum)
  float* w = ecum + Q;               // (Q,) dt * exp(cum_Q - cum)
  const float a_h = A[h];
  const size_t sbase = ((size_t)b * nh + h) * hp * N;

  for (int e = tid; e < hp * N; e += kThreads)
    ss[(e / N) * NP + e % N] = s0 ? s0[sbase + e] : 0.f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    __syncthreads();    // the previous chunk is done with xs, bs and w
    for (int e = tid; e < Q * hp; e += kThreads)
      xs[e] = x[(((size_t)b * L + c0 + e / hp) * nh + h) * hp + e % hp];
    for (int e = tid; e < Q * N; e += kThreads)
      bs[(e / N) * NP + e % N] = Bm[((size_t)b * L + c0) * N + e];
    for (int s = tid; s < Q; s += kThreads)
      dts[s] = dt[((size_t)b * L + c0 + s) * nh + h];
    __syncthreads();
    if (tid == 0) {      // inclusive cumsum, in order: positions with
      float run = 0.f;   // dt = 0 past the last token add exactly nothing
      for (int s = 0; s < Q; ++s) {
        run += dts[s] * a_h;
        cum[s] = run;
      }
    }
    __syncthreads();
    const float cq = cum[Q - 1];
    for (int s = tid; s < Q; s += kThreads) {
      ecum[s] = expf(cum[s]);
      w[s] = dts[s] * expf(cq - cum[s]);
    }

    for (int t0 = 0; t0 < Q; t0 += tile) {
      const int rows = min(tile, Q - t0);
      const int span = t0 + rows;      // keys these rows can see
      __syncthreads();   // ecum and w written; the last tile's cs/ms read
      for (int e = tid; e < rows * N; e += kThreads)
        cs[e] = Cm[((size_t)b * L + c0 + t0) * N + e];
      __syncthreads();
      {  // M = (C B^T) * exp(cum_t - cum_s) * dt_s, lower triangle only
        float acc[kTile / kWarps][kMaxQ / 32] = {};
        product(acc, rows, span, N,
                [&](int i, int k) { return cs[i * N + k]; },
                [&](int k, int j) { return bs[j * NP + k]; });
#pragma unroll
        for (int r = 0; r < kTile / kWarps; ++r)
#pragma unroll
          for (int c = 0; c < kMaxQ / 32; ++c) {
            const int i = ty + kWarps * r, j = tx + 32 * c, t = t0 + i;
            if (i < rows && j < span)
              ms[i * Q + j] =
                  j <= t ? acc[r][c] * expf(cum[t] - cum[j]) * dts[j] : 0.f;
          }
      }
      __syncthreads();
      {  // y = M x + exp(cum) (C S^T)
        float intra[kTile / kWarps][kMaxHP / 32] = {};
        float inter[kTile / kWarps][kMaxHP / 32] = {};
        product(intra, rows, hp, span,
                [&](int i, int k) { return ms[i * Q + k]; },
                [&](int k, int j) { return xs[k * hp + j]; });
        product(inter, rows, hp, N,
                [&](int i, int k) { return cs[i * N + k]; },
                [&](int k, int j) { return ss[j * NP + k]; });
#pragma unroll
        for (int r = 0; r < kTile / kWarps; ++r)
#pragma unroll
          for (int c = 0; c < kMaxHP / 32; ++c) {
            const int i = ty + kWarps * r, j = tx + 32 * c;
            if (i < rows && j < hp)
              y[(((size_t)b * L + c0 + t0 + i) * nh + h) * hp + j] =
                  intra[r][c] + ecum[t0 + i] * inter[r][c];
          }
      }
    }

    __syncthreads();     // every reader of the old state is done
    {  // S = exp(cum_Q) S + x^T (B * w); each thread owns its elements
      float acc[kMaxHP / kWarps][kMaxN / 32] = {};
      product(acc, hp, N, Q,
              [&](int i, int k) { return xs[k * hp + i] * w[k]; },
              [&](int k, int j) { return bs[k * NP + j]; });
      const float cd = ecum[Q - 1];
#pragma unroll
      for (int r = 0; r < kMaxHP / kWarps; ++r)
#pragma unroll
        for (int c = 0; c < kMaxN / 32; ++c) {
          const int p = ty + kWarps * r, n = tx + 32 * c;
          if (p < hp && n < N) ss[p * NP + n] = cd * ss[p * NP + n] + acc[r][c];
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < hp * N; e += kThreads)
    s_fin[sbase + e] = ss[(e / N) * NP + e % N];
}

cudaError_t launch_f32(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* s0,
                       void* y, void* s_fin, int B, int L, int nh, int hp,
                       int N, int Q, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Q, hp, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nh, B);
  ssd_scan_kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)s0, (float*)y, (float*)s_fin, L, nh,
      hp, N, Q);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;   // one warpgroup
constexpr int kHP = 64;           // head_dim tile: hp padded with zeros
constexpr float kLog2e = 1.4426950408889634f;

// The state's width in shared memory and registers (N padded to 64 or
// 128) for NK k16 steps of it holding N (1 or 8).
__host__ __device__ constexpr int tile_n(int nk) {
  return nk == 1 ? 64 : 128;
}

// Byte offset of bf16 element (r, c) of a [rows x cols] operand stored as
// column chunks of 64, each [rows x 128 B] with the 128-byte swizzle (the
// layout of tc_attention.cuh's operand_offset).
__device__ __forceinline__ uint32_t sw128(int rows, int r, int c) {
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 +
                    ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2);
}

// Descriptor of k16 step ks of a K-major operand of ``rows`` rows (K along
// the row, split into chunks of 64).
__device__ __forceinline__ uint64_t kmajor(uint32_t addr, int rows, int ks) {
  return tc::make_desc(addr + (ks >> 2) * rows * 128 + (ks & 3) * 32, 16,
                       1024, 1);
}

// Descriptor of k16 step ks (rows 16 ks .. 16 ks + 15) of an MN-major
// operand of ``rows`` rows whose columns are the wgmma's N.
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, int rows, int ks) {
  return tc::make_desc(addr + ks * 16 * 128, rows * 128, 1024, 1);
}

// Row (of 64) and column of this thread's accumulator element i of an
// m64nN wgmma; the register A operand's pair j of k16 step ks holds the
// elements 8 ks + 2 j and 8 ks + 2 j + 1 of that layout.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x / 32 % 4) + threadIdx.x % 32 / 4 +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

// Shared memory of a block, from a 1024-byte aligned base: x (QT x 64),
// B (QT x NT), one 64-row tile of C (64 x NT), S_hi and S_lo (64 x NT),
// all swizzled bf16, then the chunk's dt, cum, exp(cum), state weights w,
// the weights of the positions left of the second row tile and the
// column terms of the diagonal blocks' decay (QT floats each).
template <int QT, int NT>
struct TcLayout {
  static constexpr uint32_t kX = 0;
  static constexpr uint32_t kB = kX + QT * kHP * 2;
  static constexpr uint32_t kC = kB + QT * NT * 2;
  static constexpr uint32_t kHi = kC + 64 * NT * 2;
  static constexpr uint32_t kLo = kHi + kHP * NT * 2;
  static constexpr uint32_t kVec = kLo + kHP * NT * 2;
  static constexpr uint32_t kBytes = kVec + 6 * QT * 4;
};

// Write S as S_hi = bf16(S) and S_lo = bf16(S - S_hi), the K-major B
// operand (rows p, columns n) of the readout.
template <int NT>
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo,
                                            const float (&S)[NT / 2]) {
#pragma unroll
  for (int i = 0; i < NT / 2; i += 2) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(S[i], S[i + 1]);
    const __nv_bfloat162 l2 = __floats2bfloat162_rn(
        S[i] - __low2float(h2), S[i + 1] - __high2float(h2));
    const uint32_t off = sw128(kHP, acc_row(i), acc_col(i));
    *reinterpret_cast<__nv_bfloat162*>(hi + off) = h2;
    *reinterpret_cast<__nv_bfloat162*>(lo + off) = l2;
  }
  tc::fence_proxy_async();
}

// Start staging rows [0, ROWS) x columns [0, COLS) of a bf16 operand whose
// row r starts at src + r * stride (rows >= nrows and columns >= ncols are
// zeros) into the swizzled tile: 16-byte cp.async where the rows are whole
// 16-byte units (vec), else element by element (done on return).
template <int ROWS, int COLS>
__device__ __forceinline__ void stage(uint8_t* tile,
                                      const __nv_bfloat16* __restrict__ src,
                                      size_t stride, int nrows, int ncols,
                                      bool vec) {
  if (vec) {
    const uint32_t dst = tc::smem_u32(tile);
    for (int e = threadIdx.x; e < ROWS * COLS / 8; e += kTcThreads) {
      const int r = e / (COLS / 8), c = e % (COLS / 8) * 8;
      const bool in = r < nrows && c < ncols;
      tc::cp_async16(dst + sw128(ROWS, r, c),
                     in ? src + r * stride + c : src, in ? 16 : 0);
    }
  } else {
    const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
    for (int e = threadIdx.x; e < ROWS * COLS; e += kTcThreads) {
      const int r = e / COLS, c = e % COLS;
      *reinterpret_cast<unsigned short*>(tile + sw128(ROWS, r, c)) =
          r < nrows && c < ncols ? s16[r * stride + c] : (unsigned short)0;
    }
  }
}

// Where a block reads and writes, and its chunk's sizes.
struct TcRow {
  const __nv_bfloat16* x;
  const float* dt;
  const __nv_bfloat16* Bm;
  const __nv_bfloat16* Cm;
  float* y;
  int L, nh, hp, N, Q, h;
  size_t row;                      // b * L: the row's first position
  bool vec_x, vec_b;

  // Start loading chunk c0's x, B and dt, and the 64-row C tile from t0.
  template <int QT, int NT>
  __device__ void load_x_dt(uint8_t* sm, int c0) const {
    using Lay = TcLayout<QT, NT>;
    const size_t r0 = row + c0;
    stage<QT, kHP>(sm + Lay::kX, x + (r0 * nh + h) * hp, (size_t)nh * hp, Q,
                   hp, vec_x);
    float* dts = reinterpret_cast<float*>(sm + Lay::kVec);
    for (int s = threadIdx.x; s < QT; s += kTcThreads) {
      if (s < Q)
        tc::cp_async4(tc::smem_u32(dts + s), dt + (r0 + s) * nh + h);
      else
        dts[s] = 0.f;
    }
  }
  template <int QT, int NT>
  __device__ void load_b(uint8_t* sm, int c0) const {
    stage<QT, NT>(sm + TcLayout<QT, NT>::kB, Bm + (row + c0) * N, N, Q, N,
                  vec_b);
  }
  template <int QT, int NT>
  __device__ void load_c(uint8_t* sm, int c0, int t0) const {
    stage<64, NT>(sm + TcLayout<QT, NT>::kC, Cm + (row + c0 + t0) * N, N,
                  Q - t0, N, vec_b);
  }
};

// One tile of 64 rows t in [64 R, 64 R + 64) of the chunk at c0, with its
// C staged: y = exp(cum_t) (C S^T) + M x, stored for t < Q. The products
// over the state index run over its NK k16 steps that hold N. Once C is
// read, the C tile is refilled: the chunk's second tile, or the next
// chunk's first (none after the last chunk).
template <int QT, int NK, int R>
__device__ __forceinline__ void row_tile(const TcRow& io, uint8_t* sm,
                                         int c0) {
  constexpr int NT = tile_n(NK);
  using Lay = TcLayout<QT, NT>;
  constexpr int KW = 64 * (R + 1);       // positions these rows see
  constexpr int t0 = 64 * R;
  const uint32_t base = tc::smem_u32(sm);
  const float* dts = reinterpret_cast<const float*>(sm + Lay::kVec);
  const float* cum = dts + QT;
  const float* ecum = cum + QT;
  const float* low = ecum + 2 * QT;
  const float* col = low + QT;
  float yv[kHP / 2], g[KW / 2];
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    const uint64_t dc = kmajor(base + Lay::kC, 64, ks);
    tc::wgmma_ss<kHP>(yv, dc, kmajor(base + Lay::kHi, kHP, ks), ks > 0);
    tc::wgmma_ss<kHP>(yv, dc, kmajor(base + Lay::kLo, kHP, ks), 1);
  }
  tc::wgmma_commit();
#pragma unroll
  for (int ks = 0; ks < NK; ++ks)
    tc::wgmma_ss<KW>(g, kmajor(base + Lay::kC, 64, ks),
                     kmajor(base + Lay::kB, QT, ks), ks > 0);
  tc::wgmma_commit();
  tc::wgmma_wait<1>();                   // the readout is done
  tc::fence_regs(yv);
#pragma unroll
  for (int i = 0; i < kHP / 2; ++i) yv[i] *= ecum[t0 + acc_row(i)];
  tc::wgmma_wait<0>();                   // C B^T is done
  tc::fence_regs(g);
  __syncthreads();                       // every warp is done with C
  if (R + 1 < QT / 64)
    io.load_c<QT, NT>(sm, c0, t0 + 64);
  else if (c0 + io.Q < io.L)
    io.load_c<QT, NT>(sm, c0 + io.Q, 0);
  // M = (C B^T) exp(cum_t - cum_s) dt_s where s <= t, rounded to bf16
  // once. Left of the tile's diagonal block (s < t0 <= t) the decay
  // factors as exp(cum_t - cum_t0) exp(cum_t0 - cum_s) dt_s (low[s]), both
  // at most 1 as cum falls along the chunk; on the diagonal block it is
  // 2^(cum_t log2 e - col[s]), col[s] = cum_s log2 e - log2 dt_s.
  const int ta = t0 + acc_row(0);        // this thread's rows ta, ta + 8
  const float cum_t[2] = {cum[ta] * kLog2e, cum[ta + 8] * kLog2e};
  float dec_t[2] = {1.f, 1.f};
  if constexpr (R == 1) {
    dec_t[0] = expf(cum[ta] - cum[t0]);
    dec_t[1] = expf(cum[ta + 8] - cum[t0]);
  }
  uint32_t mf[KW / 16][4];
#pragma unroll
  for (int ks = 0; ks < KW / 16; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 8 * ks + 2 * j, r = j & 1, t = ta + 8 * r;
      const int s = acc_col(i);
      float m0, m1;
      if (16 * ks < t0) {
        m0 = g[i] * dec_t[r] * low[s];
        m1 = g[i + 1] * dec_t[r] * low[s + 1];
      } else {
        m0 = s <= t ? g[i] * tc::fast_exp2(cum_t[r] - col[s]) : 0.f;
        m1 = s + 1 <= t ? g[i + 1] * tc::fast_exp2(cum_t[r] - col[s + 1])
                        : 0.f;
      }
      mf[ks][j] = tc::pack_bf16(m0, m1);
    }
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KW / 16; ++ks)
    tc::wgmma_rs<kHP>(yv, mf[ks], mnmajor(base + Lay::kX, QT, ks));
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
  tc::fence_regs(yv);
  const int hp = io.hp;
  const size_t r0 = io.row + c0;
#pragma unroll
  for (int i = 0; i < kHP / 2; i += 2) {
    const int t = t0 + acc_row(i), p = acc_col(i);
    if (t >= io.Q || p >= hp) continue;
    float* dst = io.y + ((r0 + t) * io.nh + io.h) * hp + p;
    if (hp % 2 == 0) {
      *reinterpret_cast<float2*>(dst) = make_float2(yv[i], yv[i + 1]);
    } else {
      dst[0] = yv[i];
      if (p + 1 < hp) dst[1] = yv[i + 1];
    }
  }
}

// The chunk's vectors from its dt (QT floats a vector, from dts on): the
// inclusive cumsum of dt A, taken in order by one thread, so a position
// with dt = 0 adds exactly nothing; exp(cum); the state weights w =
// dt exp(cum_Q - cum); for QT = 128 the weights dt exp(cum_64 - cum) of
// the positions left of the second row tile; and the diagonal blocks'
// column terms cum log2 e - log2 dt (+inf where dt = 0). Returns cum_Q.
// Every thread of the block calls it.
template <int QT>
__device__ __forceinline__ float chunk_vectors(float* dts, float a_h) {
  float* cum = dts + QT;
  float* ecum = cum + QT;
  float* wv = ecum + QT;
  float* low = wv + QT;
  float* col = low + QT;
  if (threadIdx.x == 0) {                // 16 positions a step
    float run = 0.f;
#pragma unroll
    for (int p0 = 0; p0 < QT; p0 += 16) {
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        const float4 d = *reinterpret_cast<const float4*>(dts + p0 + j);
        v[j] = d.x, v[j + 1] = d.y, v[j + 2] = d.z, v[j + 3] = d.w;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        run += v[j] * a_h;
        v[j] = run;
      }
#pragma unroll
      for (int j = 0; j < 16; j += 4)
        *reinterpret_cast<float4*>(cum + p0 + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  }
  __syncthreads();
  const float cq = cum[QT - 1];          // = cum[Q - 1]: the pad adds 0
  for (int s = threadIdx.x; s < QT; s += kTcThreads) {
    ecum[s] = expf(cum[s]);
    wv[s] = dts[s] * expf(cq - cum[s]);
    if (QT == 128 && s < 64) low[s] = dts[s] * expf(cum[64] - cum[s]);
    col[s] = cum[s] * kLog2e - log2f(dts[s]);
  }
  __syncthreads();
  return cq;
}

// One block per (head h, row b); one warpgroup. Up to 255 registers a
// thread where the state is 128 wide (two blocks an SM, as its shared
// memory allows), 168 where it is 64 wide (three).
template <int QT, int NK>
__global__ void __launch_bounds__(kTcThreads, tile_n(NK) == 128 ? 2 : 3)
    ssd_scan_tc_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const __nv_bfloat16* __restrict__ Bm,
                       const __nv_bfloat16* __restrict__ Cm,
                       const float* __restrict__ s0, float* __restrict__ y,
                       float* __restrict__ s_fin, int L, int nh, int hp,
                       int N, int Q) {
  constexpr int NT = tile_n(NK);
  using Lay = TcLayout<QT, NT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = tc::align1024(smem_raw);
  const uint32_t base = tc::smem_u32(sm);
  float* dts = reinterpret_cast<float*>(sm + Lay::kVec);
  const float* wv = dts + 3 * QT;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a_h = A[h];
  const size_t sbase = ((size_t)b * nh + h) * hp * N;
  const TcRow io{x, dt, Bm, Cm, y, L, nh, hp, N, Q, h, (size_t)b * L,
                 hp % 8 == 0, N % 8 == 0};

  float S[NT / 2];       // the state (64 x NT), float32, for the whole row
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    const int p = acc_row(i), n = acc_col(i);
    S[i] = s0 && p < hp && n < N ? s0[sbase + (size_t)p * N + n] : 0.f;
  }
  store_split<NT>(sm + Lay::kHi, sm + Lay::kLo, S);
  io.load_x_dt<QT, NT>(sm, 0);
  io.load_b<QT, NT>(sm, 0);
  io.load_c<QT, NT>(sm, 0, 0);

  // Each chunk's x, dt, B and first C tile were started during the one
  // before: x and dt once the state update has read them, C once the last
  // row tile has, B once the update's products are done.
  for (int c0 = 0; c0 < L; c0 += Q) {
    const bool more = c0 + Q < L;
    tc::cp_async_wait_all();
    tc::fence_proxy_async();
    __syncthreads();
    const float cq = chunk_vectors<QT>(dts, a_h);   // cum[Q - 1]
    row_tile<QT, NK, 0>(io, sm, c0);
    if constexpr (QT == 128) {
      tc::cp_async_wait_all();           // the second C tile
      tc::fence_proxy_async();
      __syncthreads();
      row_tile<QT, NK, 1>(io, sm, c0);
    }

    // S = exp(cum_Q) S + (x w)^T B, the products accumulated onto the
    // decayed state, with x w split into bf16 hi and lo halves (the
    // register A operand, rows p, k = position s); B MN-major
    uint32_t ah[QT / 16][4], al[QT / 16][4];
#pragma unroll
    for (int ks = 0; ks < QT / 16; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * ks + 2 * j, p = acc_row(i), s = acc_col(i);
        const float v0 = __bfloat162float(*reinterpret_cast<
            const __nv_bfloat16*>(sm + Lay::kX + sw128(QT, s, p))) * wv[s];
        const float v1 = __bfloat162float(*reinterpret_cast<
            const __nv_bfloat16*>(sm + Lay::kX + sw128(QT, s + 1, p))) *
            wv[s + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
        const __nv_bfloat162 l2 = __floats2bfloat162_rn(
            v0 - __low2float(h2), v1 - __high2float(h2));
        ah[ks][j] = *reinterpret_cast<const uint32_t*>(&h2);
        al[ks][j] = *reinterpret_cast<const uint32_t*>(&l2);
      }
    const float cd = expf(cq);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) S[i] *= cd;
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < QT / 16; ++ks) {
      const uint64_t db = mnmajor(base + Lay::kB, QT, ks);
      tc::wgmma_rs<NT>(S, ah[ks], db);
      tc::wgmma_rs<NT>(S, al[ks], db);
    }
    tc::wgmma_commit();
    __syncthreads();                     // x, dt and w are read
    if (more) io.load_x_dt<QT, NT>(sm, c0 + Q);
    tc::wgmma_wait<0>();
    tc::fence_regs(S);
    __syncthreads();                     // every warp's products read B
    if (more) io.load_b<QT, NT>(sm, c0 + Q);
    store_split<NT>(sm + Lay::kHi, sm + Lay::kLo, S);
  }
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    const int p = acc_row(i), n = acc_col(i);
    if (p < hp && n < N) s_fin[sbase + (size_t)p * N + n] = S[i];
  }
}

template <int QT, int NK>
cudaError_t launch_tc(const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, const void* s0,
                      void* y, void* s_fin, int B, int L, int nh, int hp,
                      int N, int Q, cudaStream_t stream) {
  const size_t smem = TcLayout<QT, tile_n(NK)>::kBytes + 1024;  // + align
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_tc_kernel<QT, NK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_tc_kernel<QT, NK><<<dim3(nh, B), kTcThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const float*)dt, (const float*)A,
      (const __nv_bfloat16*)Bm, (const __nv_bfloat16*)Cm, (const float*)s0,
      (float*)y, (float*)s_fin, L, nh, hp, N, Q);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, Bm, Cm): 0 = float32, 1 = bfloat16. 1 <= Q <= 128 dividing
// L; 1 <= hp <= 64; 1 <= N <= 128. s0 may be null. All tensors contiguous
// and 16-byte aligned.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* s0, void* y, void* s_fin,
                               int dtype, int B, int L, int nh, int hp, int N,
                               int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || nh < 1 || Q < 1 || Q > kMaxQ || L < Q || L % Q != 0 ||
      hp < 1 || hp > kMaxHP || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_f32(x, dt, A, Bm, Cm, s0, y, s_fin, B, L, nh, hp, N,
                           Q, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  auto launch = Q <= 64 ? (N <= 16 ? launch_tc<64, 1> : launch_tc<64, 8>)
                        : (N <= 16 ? launch_tc<128, 1> : launch_tc<128, 8>);
  return (int)launch(x, dt, A, Bm, Cm, s0, y, s_fin, B, L, nh, hp, N, Q, s);
}
