"""ctypes binding of the grouped expert MLPs CUDA kernel (dropless MoE).

The kernel (``csrc/moe_experts.cu``) replaces no Pallas kernel: the
reference's experts (``repro.models.moe.moe_mlp``) are batched matmuls
over an (E, C, d) dispatch buffer, left to XLA. It runs each expert's
gated-SiLU MLP over the entries routed to it, sorted by expert, and reads
no weight of an expert that no entry routes to. ``moe_experts`` checks its
tensors, computes each expert's first tile of 64 entries on the device,
allocates the scratch and the output with ``torch.empty``, launches the
two kernels (gate+up, down) on the current CUDA stream, raises if a
launch was refused, and counts the call once in ``build.launches``. The
library builds at the first call (see ``build.py``). Shapes and semantics
are those of ``ref.moe_experts_ref``; rows of ``out`` whose entries are
not live are not written. Nothing is read back to the host, so a CUDA
graph may capture the call.

``tally(device)`` is the kernel's count on that device, two int64 added
to on the device: experts whose weights a call read, and E for each call
(``metrics.counters.take_expert_reads`` reads and resets it).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: entries a tile of the kernel (its wgmma N)
TILE = 64
_lib = None
_tally: dict = {}


def _library():
    global _lib
    if _lib is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        _lib = build.bind("moe_experts", {
            "moe_experts_launch": [ptr] * 11 + [i32] * 6 + [ptr]})
    return _lib


def tally(device) -> torch.Tensor:
    """The (2,) int64 count the kernel adds to on ``device``: experts read,
    and E a call. Allocated at the first call on the device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _tally:
        _tally[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return _tally[device]


def max_tiles(n_tokens: int, k: int, E: int) -> int:
    """The most tiles of ``TILE`` entries the experts can take over
    ``n_tokens`` tokens of ``k`` entries: each expert's last tile may be
    partly filled."""
    P = n_tokens * k
    return -(-P // TILE) + min(E, P)


def moe_experts(hf, w_gate, w_up, w_down, entry, offsets, weight, k: int):
    """Launch the kernels. hf: (T,d) bf16 or float32; w_gate/w_up:
    (E,d,ff) and w_down: (E,ff,d) in hf's dtype; entry: (T*k,) int32, the entries sorted by
    expert; offsets: (E+1,) int32, each expert's first sorted position
    (offsets[E] the live entries); weight: (T*k,) float32. Returns out
    (T*k, d) float32, written on the rows of live entries."""
    if hf.dtype not in build.DTYPE_CODE:
        raise TypeError(f"hf dtype {hf.dtype} not supported (float32, "
                        f"bfloat16)")
    bf16 = hf.dtype == torch.bfloat16
    build.check_on_card(hf.device, align=16 if bf16 else 4, hf=hf,
                        w_gate=w_gate, w_up=w_up, w_down=w_down)
    build.check_on_card(hf.device, align=4, entry=entry, offsets=offsets,
                        weight=weight)
    other = [n for n, t in (("w_gate", w_gate), ("w_up", w_up),
                            ("w_down", w_down)) if t.dtype != hf.dtype]
    if other:
        raise TypeError(f"{', '.join(other)} must be {hf.dtype}, hf's dtype")
    for name, t, dt in (("entry", entry, torch.int32),
                        ("offsets", offsets, torch.int32),
                        ("weight", weight, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, not {t.dtype}")
    T, d = hf.shape
    E, _, ff = w_gate.shape
    if (w_gate.shape != (E, d, ff) or w_up.shape != (E, d, ff)
            or w_down.shape != (E, ff, d) or entry.shape != (T * k,)
            or offsets.shape != (E + 1,) or weight.shape != (T * k,)):
        raise ValueError("inconsistent shapes: hf %s, w_gate %s, w_up %s, "
                         "w_down %s, entry %s, offsets %s, weight %s (k %d)"
                         % (*(tuple(t.shape) for t in (
                             hf, w_gate, w_up, w_down, entry, offsets,
                             weight)), k))
    if (bf16 and (d % 8 or ff % 8)) or T * k >= 2 ** 30:
        raise ValueError(f"d {d} and ff {ff} must be multiples of 8 in "
                         f"bfloat16, and T * k below 2**30 ({T} x {k})")
    dev = hf.device
    per_expert = (offsets[1:] - offsets[:-1] + TILE - 1) // TILE
    tiles = torch.cat([offsets[:1] * 0,
                       torch.cumsum(per_expert, 0, dtype=torch.int32)])
    act = torch.empty((T * k, ff), dtype=hf.dtype, device=dev)
    out = torch.empty((T * k, d), dtype=torch.float32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.moe_experts_launch(
        hf.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        entry.data_ptr(), offsets.data_ptr(), tiles.data_ptr(),
        weight.data_ptr(), act.data_ptr(), out.data_ptr(),
        tally(dev).data_ptr(), build.DTYPE_CODE[hf.dtype], E, k, d, ff,
        max_tiles(T, k, E), stream)
    build.raise_on(err, "moe_experts")
    build.launches["moe_experts"] += 1
    return out
