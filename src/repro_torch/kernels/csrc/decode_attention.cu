// Flash-decode over a contiguous or ring slot KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/decode_attention.py: decode_attention (_dec_kernel)
// -> decode_kernel over SlotRows (flash_decode.cuh, shared with the paged
// kernel).
//
// Semantics (the plain PyTorch version is repro_torch/kernels/ref.py
// decode_attention_ref): q (B, H, hd), one query per sequence; k/v
// (B, M, KH, hd) float32 or bfloat16; kpos (B, M) int32 (-1 = empty slot);
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
// (sequence, KV head) and does 4 flops per element per query head, far
// below the card's ~295 flops/byte ridge. One block per (KV head,
// sequence) serves the whole query group from one stream of the rows;
// loads are 16 bytes per thread on neighbouring addresses, a chunk's K
// and V loads are all issued before use, and masked rows are never loaded
// (only their 4-byte kpos is read). Splitting one sequence over several
// blocks (flash-decoding) is left for later work.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

// Token rows of a (B, M) slot cache: token n of sequence b is row b*M + n.
struct SlotRows {
  int M, window;
  __device__ int ntok(int, int qp) const {
    return window != 0 ? M : min(qp + 1, M);
  }
  __device__ bool live(int, int, int) const { return true; }
  __device__ long long slot(int b, int n) const {
    return (long long)b * M + n;
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim in {32, 64, 128, 256}; H/KH
// <= 8. Shapes as above; all tensors contiguous.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kpos,
                                       const void* q_pos, void* out,
                                       int dtype, int B, int H, int KH,
                                       int hd, int M, float scale, int window,
                                       float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kp = static_cast<const int*>(kpos);
  const int* qp = static_cast<const int*>(q_pos);
  const SlotRows rows{M, window};
  if (H % KH != 0 || H / KH > 8) return (int)cudaErrorInvalidValue;
#define DEC(T, HD)                                                        \
  return (int)launch_decode<T, HD>(q, k, v, kp, rows, qp, out, B, H, KH, \
                                   scale, window, softcap, s)
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
