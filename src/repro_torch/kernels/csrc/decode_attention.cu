// Flash-decode over a contiguous or ring slot KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/decode_attention.py: decode_attention (_dec_kernel)
// -> decode_kernel over SlotRows (flash_decode.cuh, shared with the paged
// kernel).
//
// Semantics (the plain PyTorch version is repro_torch/kernels/ref.py
// decode_attention_ref): q (B, H, hd), one query per sequence; k/v
// (B, M, KH, hd) in q's type (float32 or bfloat16), or int8 with float32
// scales k_scale/v_scale (B, M, KH) (an int8 cache of the model's kv_quant:
// row = int8 values times its scale); kpos (B, M) int32 (-1 = empty slot);
// q_pos (B,) int32 (-1 = inactive row, which comes out as 0). Query head
// h = kh*G + g reads KV head kh. Scores are scaled by hd^-0.5, soft-capped,
// then masked by kpos >= 0 && kpos <= q_pos (&& kpos > q_pos - window when
// a window is set).
//
// Where the rows stop: with window == 0 the model's cache_write puts
// position p in slot p (models/attention.py), so a slot past q_pos holds
// kpos -1 or a position above q_pos and is masked anyway; the kernel walks
// slots 0..q_pos only. A ring (window > 0) puts position p in slot
// p % ring, so every slot is walked. A caller that lays out a window-0
// cache otherwise must not use this kernel.
//
// What bounds it: memory. Decode reads each valid K/V row once per
// (sequence, KV head) and does 4 operations per element per query head,
// far below the card's ~295 operations-a-byte ridge. The design is
// flash_decode.cuh's: each (KV head, sequence) row is split over a
// thread-block cluster, each CTA scans its share of the row's kpos and
// lists the valid slots before loading any K/V row (a ring holding 300
// positions in 4097 slots loads 300 rows, wherever they lie), streams the
// listed rows through a per-warp cp.async ring with no block-wide barrier
// per tile, and the CTAs merge their partial softmax states through
// distributed shared memory: one launch, no workspace.
//
// Plain C interface for ctypes; each entry returns a CUDA error code.

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

// Token rows of a (B, M) slot cache: token n of sequence b is row b*M + n.
struct SlotRows {
  int M, window;
  __host__ __device__ int staged() const { return 0; }
  __device__ void stage(int, int*) const {}
  __device__ int ntok(int qp) const {
    return window != 0 ? M : min(qp + 1, M);
  }
  __device__ int slot(int b, int n, const int*) const { return b * M + n; }
};

// Launch (split == nullptr) or report the CTAs per row it would use.
// kv_int8: K/V are int8 with the scales ksc/vsc; else they are q's type.
int dispatch(const void* q, const void* k, const void* v, const float* ksc,
             const float* vsc, const void* kpos, const void* q_pos,
             void* out, int dtype, int kv_int8, int B, int H, int KH, int hd,
             int M, float scale, int window, float softcap, cudaStream_t s,
             int* split) {
  const int* kp = static_cast<const int*>(kpos);
  const int* qp = static_cast<const int*>(q_pos);
  const SlotRows rows{M, window};
  if (H % KH != 0 || H / KH > 8) return (int)cudaErrorInvalidValue;
#define DEC(T, KV, HD)                                                   \
  return (int)launch_decode<T, KV, HD>(q, k, v, ksc, vsc, kp, rows, qp, \
                                       out, B, H, KH, M, scale, window, \
                                       softcap, s, split)
#define DEC_HD(T, KV)                   \
  {                                     \
    if (hd == 32) DEC(T, KV, 32);       \
    if (hd == 64) DEC(T, KV, 64);       \
    if (hd == 128) DEC(T, KV, 128);     \
    if (hd == 256) DEC(T, KV, 256);     \
  }
  if (dtype == 0 && !kv_int8) DEC_HD(float, float)
  if (dtype == 1 && !kv_int8) DEC_HD(__nv_bfloat16, __nv_bfloat16)
  if (dtype == 0 && kv_int8) DEC_HD(float, int8_t)
  if (dtype == 1 && kv_int8) DEC_HD(__nv_bfloat16, int8_t)
#undef DEC_HD
#undef DEC
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). head_dim in {32, 64,
// 128, 256}; H/KH <= 8. Shapes as above; all tensors contiguous.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kpos,
                                       const void* q_pos, void* out,
                                       int dtype, int B, int H, int KH,
                                       int hd, int M, float scale, int window,
                                       float softcap, void* stream) {
  return dispatch(q, k, v, nullptr, nullptr, kpos, q_pos, out, dtype, 0, B,
                  H, KH, hd, M, scale, window, softcap,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The same over an int8 cache: k/v int8, k_scale/v_scale float32 (B, M, KH);
// dtype (0 = float32, 1 = bfloat16) is that of q and out.
extern "C" int decode_attention_int8_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* kpos, const void* q_pos, void* out,
    int dtype, int B, int H, int KH, int hd, int M, float scale, int window,
    float softcap, void* stream) {
  return dispatch(q, k, v, static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale), kpos, q_pos, out,
                  dtype, 1, B, H, KH, hd, M, scale, window, softcap,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The CTAs per (KV head, sequence) that a launch would use for these sizes
// (>= 1), or a negative CUDA error code. dtype: q's code as above, plus 2
// for int8 K/V (decode_attention_int8_launch).
extern "C" int decode_attention_split(int dtype, int B, int H, int KH,
                                      int hd, int M) {
  int split = 0;
  const int err = dispatch(nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, dtype & 1, dtype >> 1,
                           B, H, KH, hd, M, 1.f, 0, 0.f, nullptr, &split);
  return err != 0 ? -err : split;
}
