"""ctypes binding of the fused TRAIL probe CUDA kernel.

The kernel (``csrc/probe.cu``) replaces the reference package's Pallas TPU
kernel ``probe_update``: the probe MLP, its softmax and one Bayes-filter
step in one call. ``probe_update`` checks its tensors, allocates the
outputs and the split-d scratch with ``torch.empty``, launches on the
current CUDA stream, raises if the launch was refused, and counts the
launch in ``build.launches``. Shapes and semantics are those of
``ref.probe_update_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_SMS = 132            # H100 SXM streaming multiprocessors
_MAX_DSLICE = 256     # tap rows of a d slice held in shared memory
_lib = None


def _library():
    global _lib
    if _lib is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        _lib = build.bind("probe", {
            "probe_update_launch": [ptr] * 10 + [i32] * 7 + [ptr]})
    return _lib


def split_d(B: int, d: int, hid: int) -> tuple[int, int]:
    """(nsplit, dslice): how the first pass cuts d so that its grid of
    (hid/32) x (B/16) x nsplit blocks covers two blocks per SM, with a d
    slice of 64 to 256 rows."""
    tiles = -(-hid // 32) * -(-B // 16)
    nsplit = max(-(-d // _MAX_DSLICE),
                 min(-(-d // 64), -(-2 * _SMS // tiles)))
    dslice = -(-d // nsplit)
    return -(-d // dslice), dslice


def probe_update(tap, w1, b1, w2, b2, q_prev, T):
    """Launch the kernel. tap: (B,d) float32/bfloat16; w1: (d,hid); b1:
    (hid,); w2: (hid,k); b2: (k,); q_prev: (B,k); T: (k,k), all float32.
    Returns (q_new (B,k), p (B,k)) in float32."""
    build.check_on_card(tap.device, tap=tap, w1=w1, b1=b1, w2=w2, b2=b2,
                        q_prev=q_prev, T=T)
    if tap.dtype not in build.DTYPE_CODE:
        raise TypeError(f"tap dtype {tap.dtype} not supported "
                        "(float32, bfloat16)")
    for name, t in dict(w1=w1, b1=b1, w2=w2, b2=b2, q_prev=q_prev,
                        T=T).items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
    if tap.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("tap, w1 and w2 must be matrices")
    B, d = tap.shape
    hid, k = w2.shape
    if (w1.shape != (d, hid) or b1.shape != (hid,) or b2.shape != (k,)
            or q_prev.shape != (B, k) or T.shape != (k, k)):
        raise ValueError("inconsistent shapes: tap %s, w1 %s, b1 %s, w2 %s, "
                         "b2 %s, q_prev %s, T %s" % tuple(
                             tuple(t.shape) for t in (tap, w1, b1, w2, b2,
                                                      q_prev, T)))
    if not (B >= 1 and 1 <= k <= 32 and 1 <= hid <= 8192):
        raise ValueError(f"unsupported sizes B={B}, hid={hid}, k={k} "
                         "(B >= 1, hid <= 8192, k <= 32)")
    nsplit, dslice = split_d(B, d, hid)
    dev = tap.device
    q_new = torch.empty((B, k), dtype=torch.float32, device=dev)
    p = torch.empty((B, k), dtype=torch.float32, device=dev)
    partial = torch.empty((nsplit, B, hid), dtype=torch.float32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.probe_update_launch(
        tap.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), q_prev.data_ptr(), T.data_ptr(), q_new.data_ptr(),
        p.data_ptr(), partial.data_ptr(), build.DTYPE_CODE[tap.dtype], B, d,
        hid, k, nsplit, dslice, stream)
    build.raise_on(err, "probe_update")
    build.launches["probe_update"] += 1
    return q_new, p
