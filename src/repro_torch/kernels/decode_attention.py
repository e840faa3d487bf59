"""ctypes binding of the slot-cache flash-decode CUDA kernel.

The kernel (``csrc/decode_attention.cu``) replaces the reference package's
Pallas TPU kernel ``decode_attention``: one query per sequence over a
contiguous or ring (sliding-window) slot cache with explicit per-slot
positions. ``decode_attention`` checks its tensors, allocates the output
with ``torch.empty``, launches on the current CUDA stream, raises if the
launch was refused, and counts the launch in ``build.launches``. The
library builds at the first launch (see ``build.py``). Shapes and
semantics are those of ``ref.decode_attention_ref``; with ``window=0``
the kernel reads slots ``0..q_pos`` only, which is exact for caches
written by ``models.attention.cache_write`` (position p in slot p). An
int8 cache (the model's ``kv_quant``) comes with its float32 scales and
launches the same kernel body with int8 K/V rows
(``decode_attention_int8_launch``); its launches are counted apart, as
``decode_attention_int8``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import score_scale

_HEAD_DIMS = (32, 64, 128, 256)
#: token rows (B * M) the kernel can index: it computes b * M + n in an int
_MAX_ROWS = 2 ** 31 - 1

_lib = None


def _library():
    global _lib
    if _lib is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _lib = build.bind("decode_attention", {
            "decode_attention_launch":
                [ptr] * 6 + [i32] * 6 + [f32, i32, f32, ptr],
            "decode_attention_int8_launch":
                [ptr] * 8 + [i32] * 6 + [f32, i32, f32, ptr]})
    return _lib


def _check_scales(k, k_scale, v_scale):
    """An int8 cache's scales: float32 (B, M, KH), contiguous, on k's
    device and 4-byte aligned (they are read one at a time)."""
    if k_scale is None or v_scale is None:
        raise TypeError("int8 k/v need k_scale and v_scale")
    build.check_on_card(k.device, align=4, k_scale=k_scale, v_scale=v_scale)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
        if t.shape != k.shape[:3]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(k.shape[:3])}")


def decode_attention(q, k, v, kpos, q_pos, *, window: int = 0,
                     softcap: float = 0.0, k_scale=None, v_scale=None,
                     scale: float | None = None):
    """Launch the kernel. q: (B,H,hd); k/v: (B,M,KH,hd) in q's dtype, or
    int8 with k_scale/v_scale (B,M,KH) float32; kpos: (B,M) int32; q_pos:
    (B,) int32 -> (B,H,hd) in q's dtype; scores scaled by ``scale``
    (None: hd**-0.5)."""
    build.check_on_card(q.device, q=q, k=k, v=v)
    # kpos and q_pos are read one int at a time: a layer's kpos row of a
    # stacked cache may start 4 bytes past a 16-byte boundary
    build.check_on_card(q.device, align=4, kpos=kpos, q_pos=q_pos)
    if q.dtype not in build.DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    int8 = k.dtype == torch.int8
    if int8:
        if v.dtype != torch.int8:
            raise TypeError(f"k is int8 but v is {v.dtype}")
        _check_scales(k, k_scale, v_scale)
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k/v dtypes {k.dtype}/{v.dtype} != q dtype {q.dtype}")
    elif k_scale is not None or v_scale is not None:
        raise TypeError("k_scale/v_scale go with int8 k/v only")
    if kpos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("kpos and q_pos must be int32")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, k {tuple(k.shape)}")
    B, H, hd = q.shape
    M, KH = k.shape[1], k.shape[2]
    if (k.shape != (B, M, KH, hd) or v.shape != k.shape
            or kpos.shape != (B, M) or q_pos.shape != (B,)):
        raise ValueError("inconsistent shapes: q %s, k/v %s/%s, kpos %s, "
                         "q_pos %s" % (tuple(q.shape), tuple(k.shape),
                                       tuple(v.shape), tuple(kpos.shape),
                                       tuple(q_pos.shape)))
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported {_HEAD_DIMS}")
    if H % KH or H // KH > 8:
        raise ValueError(f"num_heads {H} must be 1-8 times num_kv_heads {KH}")
    if B * M > _MAX_ROWS:
        raise ValueError(f"{B} x {M} token rows: the kernel indexes them "
                         f"with an int (at most {_MAX_ROWS})")
    out = torch.empty_like(q)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sizes = (build.DTYPE_CODE[q.dtype], B, H, KH, hd, M,
             score_scale(scale, hd),
             int(window), float(softcap), stream)
    if int8:
        name = "decode_attention_int8"
        err = lib.decode_attention_int8_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), kpos.data_ptr(), q_pos.data_ptr(),
            out.data_ptr(), *sizes)
    else:
        name = "decode_attention"
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), *sizes)
    build.raise_on(err, name)
    build.launches[name] += 1
    return out
