"""ctypes binding of the chunked SSD scan CUDA kernel (Mamba-2).

The kernel (``csrc/ssd_scan.cu``) replaces the reference package's Pallas
TPU kernel ``ssd_scan``: the chunked state-space scan, the (hp, N) float32
state carried from chunk to chunk, plus an initial state. ``ssd_scan``
checks its tensors, allocates the outputs with ``torch.empty``, launches on
the current CUDA stream, raises if the launch was refused, and counts the
launch in ``build.launches``. The library builds at the first launch (see
``build.py``). Shapes and semantics are those of ``ref.ssd_scan_ref``.
There is no gradient: an input that requires one raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128
_lib = None


def _library():
    global _lib
    if _lib is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        _lib = build.bind("ssd_scan", {
            "ssd_scan_launch": [ptr] * 8 + [i32] * 7 + [ptr]})
    return _lib


def ssd_scan(x, dt, A, Bm, Cm, init_state=None, *, chunk: int):
    """Launch the kernel. x: (B,L,nh,hp) float32 or bfloat16; dt: (B,L,nh)
    float32; A: (nh,) float32; Bm/Cm: (B,L,N) in x's dtype; init_state:
    (B,nh,hp,N) float32 or None. Returns (y (B,L,nh,hp), final state
    (B,nh,hp,N)), both float32."""
    ins = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm)
    if init_state is not None:
        ins["init_state"] = init_state
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins.values()):
        raise NotImplementedError("ssd_scan has no gradient on the card yet")
    build.check_on_card(x.device, **ins)
    if x.dtype not in build.DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not supported (float32, bfloat16)")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"Bm/Cm dtypes {Bm.dtype}/{Cm.dtype} != x dtype "
                        f"{x.dtype}")
    f32 = [n for n in ("dt", "A", "init_state")
           if n in ins and ins[n].dtype != torch.float32]
    if f32:
        raise TypeError(f"{', '.join(f32)} must be float32")
    if x.dim() != 4:
        raise ValueError(f"x must be (B,L,nh,hp), not {tuple(x.shape)}")
    B, L, nh, hp = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (B, L, nh) or A.shape != (nh,) or Bm.shape != (B, L, N)
            or Cm.shape != Bm.shape or (init_state is not None
                                        and init_state.shape != (B, nh, hp, N))):
        raise ValueError("inconsistent shapes: x %s, dt %s, A %s, Bm %s, "
                         "Cm %s" % tuple(tuple(t.shape)
                                         for t in (x, dt, A, Bm, Cm)))
    if not (1 <= chunk <= MAX_CHUNK and L % chunk == 0):
        raise ValueError(f"chunk {chunk} must be 1-{MAX_CHUNK} and divide "
                         f"L={L}")
    if not (hp <= MAX_HEAD_DIM and N <= MAX_STATE):
        raise ValueError(f"head_dim {hp} (at most {MAX_HEAD_DIM}) or state "
                         f"{N} (at most {MAX_STATE}) not supported")
    y = torch.empty((B, L, nh, hp), dtype=torch.float32, device=x.device)
    s_fin = torch.empty((B, nh, hp, N), dtype=torch.float32, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), s_fin.data_ptr(), build.DTYPE_CODE[x.dtype], B, L, nh,
        hp, N, chunk, stream)
    build.raise_on(err, "ssd_scan")
    build.launches["ssd_scan"] += 1
    return y, s_fin
