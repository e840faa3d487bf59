// Device code shared by the flash-decode kernels (one query per sequence).
//
// decode_kernel<T, HD, GMAX, Rows> attends the G = H/KH query heads of one
// (KV head, sequence) over that sequence's token rows. Where the rows live
// is the only thing the two callers differ in, so it is a template
// argument:
//   PagedRows (paged_decode_attention.cu) - token n of sequence b sits in
//     slot n % ps of physical page block_table[b][n / ps]; page 0 is the
//     null page and is never loaded;
//   SlotRows (decode_attention.cu) - token n of sequence b is row
//     b * M + n of a contiguous (B, M) slot cache (a ring when windowed).
// A Rows type provides ntok(b, qp) (token rows to walk), live(b, c0, c1)
// (false when a chunk holds nothing to load) and slot(b, n) (the flat
// index of the row's kpos and of its K/V row, or -1 for none).
//
// Semantics are those of repro_torch/kernels/ref.py: key position kpos is
// valid for a query at q_pos when kpos >= 0 && kpos <= q_pos (&& kpos >
// q_pos - window); scores are scaled by hd^-0.5 after the dot, optionally
// soft-capped, and folded into an online softmax kept in float32; a row
// with nothing valid comes out as 0 (l is clamped at 1e-30, as in the
// reference's NEG_INF = -2^30 semantics).
//
// Layout: threads form groups of TPR lanes; a group owns one token row at
// a time, each lane LV 16-byte vectors of it (neighbouring lanes on
// neighbouring addresses), so a block has NGRP rows in flight and issues
// every K and V load of a chunk before using any. At hd 256 a row takes a
// whole warp (two vectors per lane in float32), and the chunk shrinks so
// that each thread keeps at most 8 vectors of K and 8 of V in registers.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash_decode {

constexpr float kNegInf = -1073741824.0f;  // -2^30
constexpr int kThreads = 128;

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

template <typename T, int HD>
struct Tiling {
  static constexpr int VEC = 16 / sizeof(T);          // elements per vector
  static constexpr int NV = HD / VEC;                 // vectors per row
  static constexpr int LV = NV > 32 ? NV / 32 : 1;    // vectors per lane
  static constexpr int TPR = NV / LV;                 // lanes per row
  static constexpr int EPL = VEC * LV;                // elements per lane
  static constexpr int NGRP = kThreads / TPR;         // rows in flight
  static constexpr int CHUNK = HD <= 128 ? 64 : 32 / LV;  // rows per chunk
  static constexpr int TPG = CHUNK / NGRP;            // rows per group
};

// One block per (KV head, sequence): grid (KH, B), kThreads threads.
template <typename T, int HD, int GMAX, typename Rows>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kpos, Rows rows,
    const int* __restrict__ q_pos, T* __restrict__ out, int H, int KH,
    float scale, int window, float softcap) {
  using Tl = Tiling<T, HD>;
  constexpr int VEC = Tl::VEC, LV = Tl::LV, TPR = Tl::TPR, EPL = Tl::EPL;
  constexpr int NGRP = Tl::NGRP, CHUNK = Tl::CHUNK, TPG = Tl::TPG;
  static_assert(TPR >= 1 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "TPR");
  static_assert(TPG >= 1 && CHUNK % NGRP == 0, "chunk");

  __shared__ float s_sm[GMAX][CHUNK];
  __shared__ float p_sm[GMAX][CHUNK];
  __shared__ unsigned char valid_sm[CHUNK];
  __shared__ float alpha_sm[GMAX];
  __shared__ float l_sm[GMAX];
  __shared__ float red[NGRP * HD];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / KH;
  const int tid = threadIdx.x, grp = tid / TPR, li = tid % TPR;
  const int qp = q_pos[b];
  const int ntok = rows.ntok(b, qp);

  float qr[GMAX][EPL];
  float acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int l = 0; l < LV; ++l) {
      if (g < G) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            q + ((size_t)b * H + kh * G + g) * HD + (l * TPR + li) * VEC);
        to_f32<T>(raw, qr[g] + l * VEC);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) qr[g][l * VEC + j] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < EPL; ++j) acc[g][j] = 0.f;
  }
  float m_run = kNegInf, l_run = 0.f;  // owned by thread tid == g < G

  for (int c0 = 0; c0 < ntok; c0 += CHUNK) {
    if (!rows.live(b, c0, min(c0 + CHUNK, ntok))) continue;
    // issue every K and V load of this group's rows before using any
    uint4 kr[TPG][LV], vr[TPG][LV];
    bool ok[TPG];
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      const int n = c0 + grp + i * NGRP;
      ok[i] = false;
#pragma unroll
      for (int l = 0; l < LV; ++l) {
        kr[i][l] = make_uint4(0, 0, 0, 0);
        vr[i][l] = make_uint4(0, 0, 0, 0);
      }
      if (n < ntok) {
        const long long slot = rows.slot(b, n);
        if (slot >= 0 && key_valid(kpos[slot], qp, window)) {
          ok[i] = true;
          const size_t base = ((size_t)slot * KH + kh) * HD;
#pragma unroll
          for (int l = 0; l < LV; ++l) {
            const size_t off = base + (l * TPR + li) * VEC;
            kr[i][l] = *reinterpret_cast<const uint4*>(k + off);
            vr[i][l] = *reinterpret_cast<const uint4*>(v + off);
          }
        }
      }
    }
    // scores: G dot products per row, reduced over the group's lanes
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      float kf[EPL];
#pragma unroll
      for (int l = 0; l < LV; ++l) to_f32<T>(kr[i][l], kf + l * VEC);
      float s[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        s[g] = 0.f;
#pragma unroll
        for (int j = 0; j < EPL; ++j) s[g] = fmaf(qr[g][j], kf[j], s[g]);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
      if (li == 0) {
        const int t = grp + i * NGRP;
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) s_sm[g][t] = ok[i] ? cap_score(s[g] * scale, softcap)
                                        : kNegInf;
        valid_sm[t] = ok[i];
      }
    }
    __syncthreads();
    // online softmax statistics, one thread per query head
    if (tid < G) {
      const int g = tid;
      float mx = m_run;
      for (int t = 0; t < CHUNK; ++t)
        if (valid_sm[t]) mx = fmaxf(mx, s_sm[g][t]);
      float sum = 0.f;
      for (int t = 0; t < CHUNK; ++t) {
        const float p = valid_sm[t] ? expf(s_sm[g][t] - mx) : 0.f;
        p_sm[g][t] = p;
        sum += p;
      }
      const float alpha = expf(m_run - mx);
      l_run = l_run * alpha + sum;
      m_run = mx;
      alpha_sm[g] = alpha;
    }
    __syncthreads();
    // rescale and accumulate P @ V over this group's rows
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float a = alpha_sm[g];
#pragma unroll
        for (int j = 0; j < EPL; ++j) acc[g][j] *= a;
      }
    }
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      if (!ok[i]) continue;
      const int t = grp + i * NGRP;
      float vf[EPL];
#pragma unroll
      for (int l = 0; l < LV; ++l) to_f32<T>(vr[i][l], vf + l * VEC);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float p = p_sm[g][t];
#pragma unroll
          for (int j = 0; j < EPL; ++j) acc[g][j] = fmaf(p, vf[j], acc[g][j]);
        }
      }
    }
  }

  // sum the groups' partial accumulators, one query head at a time
  if (tid < G) l_sm[tid] = l_run;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    __syncthreads();
#pragma unroll
    for (int l = 0; l < LV; ++l)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        red[grp * HD + (l * TPR + li) * VEC + j] = acc[g][l * VEC + j];
    __syncthreads();
    const float l = fmaxf(l_sm[g], 1e-30f);
    for (int d = tid; d < HD; d += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int gi = 0; gi < NGRP; ++gi) sum += red[gi * HD + d];
      store_out(out + ((size_t)b * H + kh * G + g) * HD + d, sum / l);
    }
  }
}

// Launch the instance for the query group size G = H / KH (at most 8).
template <typename T, int HD, typename Rows>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* kpos, Rows rows, const int* qpos,
                          void* out, int B, int H, int KH, float scale,
                          int window, float softcap, cudaStream_t stream) {
  const dim3 grid(KH, B);
  const int G = H / KH;
#define FD_LAUNCH(GMAX)                                                      \
  decode_kernel<T, HD, GMAX, Rows><<<grid, kThreads, 0, stream>>>(          \
      (const T*)q, (const T*)k, (const T*)v, kpos, rows, qpos, (T*)out, H,  \
      KH, scale, window, softcap)
  if (G <= 2)
    FD_LAUNCH(2);
  else if (G <= 4)
    FD_LAUNCH(4);
  else
    FD_LAUNCH(8);
#undef FD_LAUNCH
  return cudaGetLastError();
}

}  // namespace flash_decode
