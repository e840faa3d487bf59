"""ctypes binding of the full-sequence flash-attention CUDA kernel.

The kernel (``csrc/flash_attention.cu``) replaces the reference package's
Pallas TPU kernel ``flash_attention``: blocked causal or non-causal
attention over whole sequences, GQA by head mapping, sliding window and
logit softcap, with fully masked key tiles skipped. ``flash_attention``
checks its tensors, allocates the output with ``torch.empty``, launches
on the current CUDA stream, raises if the launch was refused, and counts
the launch in ``build.launches``. The library builds at the first launch
(see ``build.py``). Shapes and semantics are those of
``ref.flash_attention_ref``: keys at positions >= S never count, also
without ``causal``.

The kernel is chosen by dtype: bfloat16 runs on the tensor cores (wgmma
with bf16 operands and float32 accumulators, P rounded to bf16 before
P V, K/V brought in by TMA through a ring of shared-memory stages);
float32 runs the CUDA-core kernel, which holds the plain version to
1e-5. A bfloat16 input the tensor-core kernel cannot take raises; it
never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import score_scale

_HEAD_DIMS = (32, 64, 128, 256)
_lib = None


def _library():
    global _lib
    if _lib is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _lib = build.bind("flash_attention", {
            "flash_attention_launch":
                [ptr] * 4 + [i32] * 6 + [f32, i32, i32, f32, ptr]})
    return _lib


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None):
    """Launch the kernel. q: (B,S,H,hd); k/v: (B,S,KH,hd) -> (B,S,H,hd) in
    q's dtype; scores scaled by ``scale`` (None: hd**-0.5)."""
    build.check_on_card(q.device, q=q, k=k, v=v)
    if q.dtype not in build.DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k/v dtypes {k.dtype}/{v.dtype} != q dtype {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, k {tuple(k.shape)}")
    B, S, H, hd = q.shape
    KH = k.shape[2]
    if k.shape != (B, S, KH, hd) or v.shape != k.shape:
        raise ValueError("inconsistent shapes: q %s, k/v %s/%s" % (
            tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported {_HEAD_DIMS}")
    if S < 1 or H % KH or H // KH > 8:
        raise ValueError(f"need S >= 1 and num_heads {H} 1-8 times "
                         f"num_kv_heads {KH}")
    out = torch.empty_like(q)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        build.DTYPE_CODE[q.dtype], B, S, H, KH, hd,
        score_scale(scale, hd), int(causal),
        int(window), float(softcap), stream)
    build.raise_on(err, "flash_attention")
    build.launches["flash_attention"] += 1
    return out
