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
// kernel's where hides that). A position with dt = 0 decays by exp(0) = 1
// and injects nothing, so it leaves the state exactly as it was.
//
// Layout: one block per (head, row) walks the row's chunks in order and
// carries the float32 state in shared memory, the Pallas kernel's scratch
// carry. Per chunk it loads x (Q, hp) and B (Q, N) once; the (Q, Q) matrix
// and C are taken in tiles of kTile rows, so that at Mamba-2's shape
// (Q = 128, N = 128, hp = 64) x, B, the state, one C tile and one M tile
// fit in 166 KB instead of 256. Every product is a register-tiled loop over
// shared memory (16 warps = rows, lane = columns; B and the state padded
// to N + 1 floats a row so that lanes reading a column hit distinct banks),
// in float32 on the CUDA cores. One block fills an SM's shared memory at
// that shape, so the block brings its own 16 warps to hide the latency of
// shared memory.
//
// What bounds it: at the serving path's shapes the function moves ~86 MB
// (x, y, the states in and out) for ~10 GFLOP, so the bytes bind. This
// first version reads B and C once per head (nh times in all), computes
// the (Q, Q) matrix per head, and keeps one block per (head, row) on an
// SM, so it runs well above that bound; sharing C B^T across heads and
// tensor cores are later work.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;        // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // rows of C and of the (Q, Q) matrix
constexpr int kMaxQ = 128, kMaxHP = 64, kMaxN = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ s0,
                    float* __restrict__ y, float* __restrict__ s_fin, int L,
                    int nh, int hp, int N, int Q) {
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
      xs[e] = to_f32(x[(((size_t)b * L + c0 + e / hp) * nh + h) * hp
                       + e % hp]);
    for (int e = tid; e < Q * N; e += kThreads)
      bs[(e / N) * NP + e % N] = to_f32(Bm[((size_t)b * L + c0) * N + e]);
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
        cs[e] = to_f32(Cm[((size_t)b * L + c0 + t0) * N + e]);
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

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* s0, void* y,
                   void* s_fin, int B, int L, int nh, int hp, int N, int Q,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Q, hp, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nh, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const float*)s0, (float*)y, (float*)s_fin, L, nh, hp, N,
      Q);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, Bm, Cm): 0 = float32, 1 = bfloat16. 1 <= Q <= 128 dividing
// L; 1 <= hp <= 64; 1 <= N <= 128. s0 may be null. All tensors contiguous.
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
    return (int)launch<float>(x, dt, A, Bm, Cm, s0, y, s_fin, B, L, nh, hp,
                              N, Q, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, s0, y, s_fin, B, L,
                                      nh, hp, N, Q, s);
  return (int)cudaErrorInvalidValue;
}
