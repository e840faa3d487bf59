"""ctypes binding of the paged flash-decode CUDA kernels.

The kernels (``csrc/paged_decode_attention.cu``) replace the reference
package's Pallas TPU kernels ``paged_decode_attention`` and
``paged_decode_attention_multi``. Each function here checks its tensors,
allocates the output with ``torch.empty``, launches on the current CUDA
stream, raises if the launch was refused, and counts the launch in
``build.launches``. The library builds at the first launch (see
``build.py``).
Shapes and semantics are those of ``ref.py``.

``paged_decode_attention_multi`` chooses its kernel by dtype: bfloat16
runs on the tensor cores (wgmma, P rounded to bf16 before P V, K/V
gathered through the block table by cp.async into a ring of
shared-memory stages, key tiles no row can see skipped before they are
loaded); float32 runs the CUDA-core kernel, which holds the plain
version to 1e-5. Neither falls back to the other.
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
        _lib = build.bind("paged_decode_attention", {
            "paged_decode_attention_launch":
                [ptr] * 7 + [i32] * 7 + [f32, i32, f32, ptr],
            "paged_decode_attention_multi_launch":
                [ptr] * 7 + [i32] * 8 + [f32, i32, f32, ptr]})
    return _lib


def _check(q, k_pages, v_pages, kpos_pages, block_table, q_pos, q_ndim):
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                   kpos_pages=kpos_pages, block_table=block_table,
                   q_pos=q_pos)
    build.check_on_card(q.device, **tensors)
    if q.dtype not in build.DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    for name in ("k_pages", "v_pages"):
        if tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} dtype {tensors[name].dtype} != q dtype")
    for name in ("kpos_pages", "block_table", "q_pos"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    if q.dim() != q_ndim or k_pages.dim() != 4:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, "
                         f"k_pages {tuple(k_pages.shape)}")
    P, ps, KH, hd = k_pages.shape
    B, H = q.shape[0], q.shape[-2]
    if (q.shape[-1] != hd or v_pages.shape != k_pages.shape
            or kpos_pages.shape != (P, ps) or block_table.dim() != 2
            or block_table.shape[0] != B or q_pos.shape != q.shape[:-2]):
        raise ValueError("inconsistent shapes: q %s, k/v_pages %s/%s, "
                         "kpos_pages %s, block_table %s, q_pos %s" % (
                             tuple(q.shape), tuple(k_pages.shape),
                             tuple(v_pages.shape), tuple(kpos_pages.shape),
                             tuple(block_table.shape), tuple(q_pos.shape)))
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported {_HEAD_DIMS}")
    if H % KH:
        raise ValueError(f"num_heads {H} must divide by num_kv_heads {KH}")
    return B, H, KH, hd, ps, block_table.shape[1]


def paged_decode_attention(q, k_pages, v_pages, kpos_pages, block_table,
                           q_pos, *, window: int = 0, softcap: float = 0.0,
                           scale: float | None = None):
    """Launch the single-query kernel. q: (B,H,hd) -> (B,H,hd) in q's dtype;
    scores scaled by ``scale`` (None: hd**-0.5)."""
    B, H, KH, hd, ps, pmax = _check(q, k_pages, v_pages, kpos_pages,
                                    block_table, q_pos, 3)
    if H // KH > 8:
        raise ValueError(f"query group size {H // KH} > 8 not supported")
    out = torch.empty_like(q)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_decode_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        kpos_pages.data_ptr(), block_table.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), build.DTYPE_CODE[q.dtype], B, H, KH, hd, ps, pmax,
        score_scale(scale, hd), int(window), float(softcap), stream)
    build.raise_on(err, "paged_decode_attention")
    build.launches["paged_decode_attention"] += 1
    return out


def paged_decode_attention_multi(q, k_pages, v_pages, kpos_pages,
                                 block_table, q_pos, *, window: int = 0,
                                 softcap: float = 0.0,
                                 scale: float | None = None):
    """Launch the multi-query kernel. q: (B,T,H,hd); q_pos: (B,T)."""
    B, H, KH, hd, ps, pmax = _check(q, k_pages, v_pages, kpos_pages,
                                    block_table, q_pos, 4)
    T = q.shape[1]
    out = torch.empty_like(q)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_decode_attention_multi_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        kpos_pages.data_ptr(), block_table.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), build.DTYPE_CODE[q.dtype], B, T, H, KH, hd, ps, pmax,
        score_scale(scale, hd), int(window), float(softcap), stream)
    build.raise_on(err, "paged_decode_attention_multi")
    build.launches["paged_decode_attention_multi"] += 1
    return out
