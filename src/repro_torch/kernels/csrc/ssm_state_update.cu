// Mamba-2 single-token state update for Hopper (sm_90a): decay, update and
// read the float32 SSM state in place, in one pass.
//
// Replaces no Pallas TPU kernel: the reference package's decode update
// (src/repro/models/ssm.py ssm_decode_step) is plain jnp. It was added
// because the plain PyTorch update made about a dozen passes over each
// layer's state a decode step (the einsum's new (B, nh, hp, N) tensor, the
// decay, the add, the einsum read, torch.where against the old state, the
// copy back into the cache), over every row of the batch whether it held
// a token or not. At granite-4.0-h-small's shape (64 rows, 128 heads,
// hp 64, N 128) a layer's state is 268 MB, and those passes set the pace
// of the whole decode megastep.
//
// Semantics (the plain PyTorch version is repro_torch/kernels/ref.py
// ssm_state_update_ref): state (B, nh, hp, N) float32, updated in place;
// x (B, nh, hp), dt (B, nh) post-softplus, A (nh,) negative, Bm/Cm (B, N)
// shared by the heads (groups = 1), D (nh,), all float32; keep (B,) bool.
// For each row b with keep[b] and each head h, with a = exp(dt A):
//   s[p, n] <- a s[p, n] + (dt x[p]) B[n]
//   y[p]     = sum_n s[p, n] C[n] + D x[p]        (with the new s)
// A row with keep[b] false is neither read nor written: its state stays
// as it was, bit for bit, and its y is 0.
//
// What bounds it: each live (row, head) reads and writes its hp x N state
// once (2 x 32 KB at hp 64, N 128) for 5 operations an element, about
// 0.6 operations a byte: the bytes bind, at 3.35 TB/s. The design moves
// each live state byte once each way and nothing for a dead row:
//   - one block per (head, row); a block whose row has keep false writes
//     its zeros of y and returns before it touches the state, so the
//     launch costs a dead row a block's start and no state traffic;
//   - the slab is read as 16-byte vectors along N, neighbouring threads on
//     neighbouring addresses: N / 4 lanes hold one row p of the slab, a
//     warp 128 / N rows at once, a thread up to kMaxVec vectors, all
//     loaded before any is used so that they are in flight together;
//   - a thread's columns n are the same for every row it holds, so its
//     pieces of B and C sit in registers, loaded once; x[p] and the scalars
//     come through the read-only cache;
//   - y's sum over N is a shuffle reduction inside the N / 4 lanes of a
//     row; the new state is stored back over the old, in place.
// At 64 rows and 128 heads the grid holds 8192 blocks of 256 threads, and
// at 6 live rows 768 that carry state, all resident at once on 132 SMs.
//
// Precision: float32 throughout. The update rounds as the plain version
// does (a s and (dt x) B each rounded, then added; no fused multiply-add);
// only the order of y's sum over N differs from the plain einsum.
//
// Shapes: N in {4, 8, 16, 32, 64, 128} (N / 4 lanes a row, a power of two
// up to 32) and hp * N / 4 at most kThreads * kMaxVec (hp 64 at N 128);
// the binding raises on any other.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // the largest block; smaller slabs take fewer
constexpr int kMaxVec = 8;      // 16-byte state vectors a thread at most

// One block per (head h = blockIdx.x, row b = blockIdx.y). L = N / 4 lanes
// hold one row p of the (hp, N) slab; vector i = tid + k * blockDim.x of the
// slab lies in row i / L, columns 4 (i % L) .. 4 (i % L) + 3.
template <int L>
__global__ void __launch_bounds__(kThreads)
    ssm_state_update_kernel(float* __restrict__ state,
                            const float* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ A,
                            const float* __restrict__ Bm,
                            const float* __restrict__ Cm,
                            const float* __restrict__ D,
                            const bool* __restrict__ keep,
                            float* __restrict__ y, int nh, int hp) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int N = 4 * L;
  const size_t bh = (size_t)b * nh + h;
  float* __restrict__ yrow = y + bh * hp;
  if (!keep[b]) {
    for (int p = tid; p < hp; p += blockDim.x) yrow[p] = 0.f;
    return;
  }
  const int vecs = hp * L;                  // 16-byte vectors of the slab
  const int c = tid % L;                    // the same for every k
  float4* __restrict__ slab =
      reinterpret_cast<float4*>(state + bh * hp * N);
  const float* __restrict__ xrow = x + bh * hp;

  float4 s[kMaxVec];
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int i = tid + k * blockDim.x;
    s[k] = i < vecs ? slab[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4 bv = reinterpret_cast<const float4*>(Bm + (size_t)b * N)[c];
  const float4 cv = reinterpret_cast<const float4*>(Cm + (size_t)b * N)[c];
  const float dth = dt[bh];
  const float a = expf(dth * A[h]);
  const float dh = D[h];

#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int i = tid + k * blockDim.x;
    // a whole group of L lanes is in or out of range together (L divides
    // both 32 and vecs), so every lane of a group takes the shuffles below
    if (k * (int)blockDim.x >= vecs) break;
    const bool live = i < vecs;
    const int p = i / L;
    const float xp = live ? __ldg(xrow + p) : 0.f;
    const float dx = __fmul_rn(dth, xp);
    float4 v = s[k];
    v.x = __fadd_rn(__fmul_rn(a, v.x), __fmul_rn(dx, bv.x));
    v.y = __fadd_rn(__fmul_rn(a, v.y), __fmul_rn(dx, bv.y));
    v.z = __fadd_rn(__fmul_rn(a, v.z), __fmul_rn(dx, bv.z));
    v.w = __fadd_rn(__fmul_rn(a, v.w), __fmul_rn(dx, bv.w));
    float acc = v.x * cv.x;
    acc = fmaf(v.y, cv.y, acc);
    acc = fmaf(v.z, cv.z, acc);
    acc = fmaf(v.w, cv.w, acc);
#pragma unroll
    for (int off = L / 2; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (live) {
      slab[i] = v;
      if (c == 0) yrow[p] = __fadd_rn(acc, __fmul_rn(dh, xp));
    }
  }
}

template <int L>
cudaError_t launch(float* state, const float* x, const float* dt,
                   const float* A, const float* Bm, const float* Cm,
                   const float* D, const bool* keep, float* y, int B, int nh,
                   int hp, cudaStream_t stream) {
  const int vecs = hp * L;
  int threads = kThreads;
  if (vecs < kThreads) threads = (vecs + 31) / 32 * 32;
  if (threads < 32) threads = 32;
  ssm_state_update_kernel<L><<<dim3(nh, B), threads, 0, stream>>>(
      state, x, dt, A, Bm, Cm, D, keep, y, nh, hp);
  return cudaGetLastError();
}

}  // namespace

// state (B, nh, hp, N) float32, updated in place; x (B, nh, hp), dt (B, nh),
// A (nh,), Bm/Cm (B, N), D (nh,) float32; keep (B,) bool; y (B, nh, hp)
// float32, written for every row (0 where keep is false).
extern "C" int ssm_state_update_launch(void* state, const void* x,
                                       const void* dt, const void* A,
                                       const void* Bm, const void* Cm,
                                       const void* D, const void* keep,
                                       void* y, int B, int nh, int hp, int N,
                                       void* stream) {
  if (B < 1 || nh < 1 || hp < 1 || N < 4 || N > 128 || N % 4 != 0 ||
      ((N / 4) & (N / 4 - 1)) != 0 || hp * (N / 4) > kThreads * kMaxVec ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<float*>(state);
  auto xs = static_cast<const float*>(x);
  auto dts = static_cast<const float*>(dt);
  auto As = static_cast<const float*>(A);
  auto Bs = static_cast<const float*>(Bm);
  auto Cs = static_cast<const float*>(Cm);
  auto Ds = static_cast<const float*>(D);
  auto ks = static_cast<const bool*>(keep);
  auto ys = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  switch (N / 4) {
    case 1: return (int)launch<1>(st, xs, dts, As, Bs, Cs, Ds, ks, ys, B, nh, hp, s);
    case 2: return (int)launch<2>(st, xs, dts, As, Bs, Cs, Ds, ks, ys, B, nh, hp, s);
    case 4: return (int)launch<4>(st, xs, dts, As, Bs, Cs, Ds, ks, ys, B, nh, hp, s);
    case 8: return (int)launch<8>(st, xs, dts, As, Bs, Cs, Ds, ks, ys, B, nh, hp, s);
    case 16: return (int)launch<16>(st, xs, dts, As, Bs, Cs, Ds, ks, ys, B, nh, hp, s);
    default: return (int)launch<32>(st, xs, dts, As, Bs, Cs, Ds, ks, ys, B, nh, hp, s);
  }
}
