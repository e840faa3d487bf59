"""ctypes binding of the fused TRAIL probe CUDA kernel.

The kernel (``csrc/probe.cu``) replaces the reference package's Pallas TPU
kernel ``probe_update``: the probe MLP, its softmax and one Bayes-filter
step in one launch. ``plan`` sizes the launch from the clusters the card
holds at once (``active_clusters``, asked once per device);
``probe_update`` checks its tensors, allocates the outputs and the call's
scratch in one ``torch.empty``, launches on the current CUDA stream,
raises if the launch was refused, and counts the launch in
``build.launches``. Shapes and semantics are those of
``ref.probe_update_ref``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

MAX_SMEM = 232448         # shared memory a CTA may take (227 KB)
MAX_CLUSTER = 8           # the portable cluster size
COLS = 32                 # hid columns of a cluster
STAGE_ROWS = 128          # w1 rows of a pipeline stage (one TMA box)
MIN_ROWS = 32             # the fewest d rows a CTA of a cluster takes
WARPS = 8                 # warps of a CTA
MAX_BINS = 32             # the most bins (k) a call takes
ONE_PER_SM = 120 * 1024   # shared memory that keeps a CTA alone on its SM
ALIGN = 8                 # slice rows come in 16-byte tap chunks
_lib = None


def _library():
    global _lib
    if _lib is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        _lib = build.bind("probe", {
            "probe_update_launch": [ptr] * 10 + [i32] * 10 + [ptr],
            "probe_active_clusters": [ptr]})
    return _lib


class Plan(NamedTuple):
    """How one call is cut (``plan``): row tiles of ``row_tile`` tap rows;
    ``col_blocks`` blocks of 32 hid columns, taken by ``clusters``
    clusters of ``cluster`` CTAs (cluster ``c`` takes blocks ``c, c +
    clusters, ...``); CTA ``q`` of a cluster takes the d slices ``p *
    cluster + q`` for ``p < npass``, slice ``s`` being rows ``[s *
    dslice, (s + 1) * dslice)`` cut at d; ``smem`` bytes of shared memory
    a CTA; ``scratch`` floats of partial logits."""
    row_tile: int
    cluster: int
    clusters: int
    dslice: int
    npass: int
    col_blocks: int
    smem: int
    scratch: int


def smem_bytes(row_tile: int, dslice: int) -> int:
    """A CTA's shared memory (``probe.cu`` ``smem_bytes``): per stage of 128
    rows the w1 rows, the tap rows and an mbarrier; the warps' partial
    sums, the partial h received from the cluster, the cluster's rows of
    w2 and b1, T and b2; at least ONE_PER_SM."""
    stages = -(-dslice // STAGE_ROWS)
    n = (stages * (STAGE_ROWS * COLS * 4 + STAGE_ROWS * row_tile * 4 + 8)
         + row_tile * COLS * 4 * (WARPS + MAX_CLUSTER)
         + COLS * (MAX_BINS + 1) * 4 + MAX_BINS * (MAX_BINS + 1) * 4)
    return max(n, ONE_PER_SM)


@functools.lru_cache(maxsize=256)
def plan(B: int, d: int, hid: int, k: int, active: tuple[int, ...]) -> Plan:
    """Cut a call so that one wave of CTAs, one an SM, streams w1 once:
    the largest cluster (up to 8 CTAs over d, at least 32 rows a slice)
    of which the card holds one a column block of 32 hid columns at once
    (``active[c - 1]`` clusters of c CTAs, ``active_clusters``), each
    CTA's tile resident in its shared memory; where d is too long for
    that, each CTA takes npass slices in turn. Slices are whole 8-row
    chunks where d allows, so the tap loads 16 bytes at a time. The grid
    never holds more clusters than the card does at once (the launch is
    cooperative); where there are more column blocks, a cluster takes
    several in turn."""
    row_tile = 16 if B > 4 else 4
    col_blocks = -(-hid // COLS)
    cluster = max([c for c, n in enumerate(active[:MAX_CLUSTER], 1)
                   if n >= col_blocks] + [1])
    cluster = max(1, min(cluster, MAX_CLUSTER, -(-d // MIN_ROWS)))
    max_rows = STAGE_ROWS
    while smem_bytes(row_tile, max_rows + STAGE_ROWS) <= MAX_SMEM:
        max_rows += STAGE_ROWS
    npass = -(-d // (cluster * max_rows))
    dslice = -(-d // (cluster * npass))
    if d % ALIGN == 0:
        dslice = -(-dslice // ALIGN) * ALIGN
    if npass == 1:
        cluster = -(-d // dslice)           # no empty slice
    return Plan(row_tile, cluster, min(col_blocks, active[cluster - 1]),
                dslice, npass, col_blocks, smem_bytes(row_tile, dslice),
                col_blocks * B * k)


@functools.lru_cache(maxsize=None)
def active_clusters(device: int) -> tuple[int, ...]:
    """How many clusters of 1 to 8 CTAs, one CTA an SM, CUDA device
    ``device`` holds at once (``cudaOccupancyMaxActiveClusters``)."""
    out = (ctypes.c_int * MAX_CLUSTER)()
    with torch.cuda.device(device):
        build.raise_on(_library().probe_active_clusters(out),
                       "probe_active_clusters")
    return tuple(out)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


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
    if not (B >= 1 and d >= 1 and 1 <= k <= 32 and 1 <= hid <= 8192):
        raise ValueError(f"unsupported sizes B={B}, d={d}, hid={hid}, k={k} "
                         "(B, d >= 1, hid <= 8192, k <= 32)")
    pl = plan(B, d, hid, k, active_clusters(tap.device.index))
    # one buffer: q_new, p and the scratch, each on a 16-byte boundary
    n = _round4(B * k)
    buf = torch.empty(2 * n + pl.scratch, dtype=torch.float32,
                      device=tap.device)
    q_new, p = buf[:B * k].view(B, k), buf[n:n + B * k].view(B, k)
    stream = torch.cuda.current_stream(tap.device).cuda_stream
    err = _library().probe_update_launch(
        tap.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), q_prev.data_ptr(), T.data_ptr(), q_new.data_ptr(),
        p.data_ptr(), buf[2 * n:].data_ptr(), build.DTYPE_CODE[tap.dtype], B,
        d, hid, k, pl.row_tile, pl.cluster, pl.clusters, pl.dslice,
        pl.npass, stream)
    build.raise_on(err, "probe_update")
    build.launches["probe_update"] += 1
    return q_new, p

