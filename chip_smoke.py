#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card, end to end, and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-decode CSRC_DIR [CSRC_DIR ...]
    python3 chip_smoke.py --compare-ssd CSRC_DIR [CSRC_DIR ...]
    python3 chip_smoke.py --compare-probe CSRC_DIR [CSRC_DIR ...]

The other forms only time the single-query decode kernels
(``compare_decode``), ``ssd_scan`` (``compare_ssd_builds``) or
``probe_update`` (``compare_probe_builds``) built from each kernel source
directory, in turns, for instance a parent commit's
``src/repro_torch/kernels/csrc`` beside this one's.

Phases, in order (any failure exits non-zero; nothing is passed over):

1. report the device (name, count, ``nvidia-smi`` name and power limit);
   with no CUDA device, fail;
2. build every CUDA kernel from the sources in this checkout (one ``nvcc``
   per source, all at once), print the build time and what ptxas reports,
   and count the ``HGMMA`` (wgmma) instructions ``cuobjdump -sass`` finds
   in the ``flash_attention``, ``paged_decode_attention`` and
   ``ssd_scan`` libraries (none fails: their bf16 kernels run on the
   tensor cores);
3. hold each kernel against its plain PyTorch version on the card, float32
   and bfloat16, with inactive (q_pos = -1) rows and a logit softcap:
   the paged kernels at the shapes of ``granite-3-8b``, ``trail-llama``
   and ``gemma2-9b`` (head_dim 256) with scrambled block tables and null
   pages; ``decode_attention`` at the shapes of ``gemma2-9b`` (a 4608-slot
   cache, and a wrapped 4096-slot ring with window 4096), ``gemma3-1b``
   (one KV head, window 512), ``granite-3-8b`` and ``hymba-1.5b`` (25/5
   heads of 64, a 1025-slot ring with window 1024); both single-query
   kernels also at the edges of their split over a thread-block cluster
   (B=1, where the split is largest; rows of 1 and ps - 1 tokens, one
   scan tile and one round of tiles over the split; every valid key in
   one CTA; 256-page tables; a window edge inside a tile; inactive rows),
   each case logging the split its launch used; the multi-query kernel
   also with pages of 8 and in a prefill batch whose every row tile is
   inactive but two sequences'; ``probe_update`` at ``gemma2-9b`` width
   (1, 16, 17 and 64 rows, bfloat16 and float32 taps), at the d of
   ``granite-3-8b`` (4096) and ``trail-llama`` (768), at d 200 and 201
   (the tap read element by element), hid 48 and 50 (4-byte copies in
   place of TMA), k 1 and 32, d 20000 (three slices a CTA) and hid 8192
   (256 column blocks on the 132 clusters of one CTA the card holds at
   once, two blocks a cluster), each with a row
   whose posterior sums to 0 (the prior fallback; not with one bin), two
   calls on the same inputs bit-equal and calls in flight on two streams
   equal to one call; ``ssd_scan`` at
   the shapes of ``tests/test_kernels.py``, at hp 33 and N 13 (rows of
   odd byte length), of ``mamba2-370m`` (16 x 256,
   32 heads of 64, state 128, chunk 128) and ``hymba-1.5b`` (50 heads,
   state 16) and at the L=8 bucket, all from a nonzero initial state,
   plus rows whose tail has dt = 0 (their state equals the shorter
   scan's) and a scan in two halves (equal to one scan). Tolerances, per
   element: float32 |kernel - plain| <= 1e-5; bfloat16 at most 2e-2 and
   at most one bf16 rounding of the output, 2**-7 * |plain| + 1e-4 (both
   versions compute in float32 and round once), except for the two
   tensor-core attention kernels (``flash_attention`` and
   ``paged_decode_attention_multi`` in bf16), which round P to bf16
   before P V and are held to ``tc_attention_bound``; probe outputs
   (probabilities, always float32) 1e-5, as float32 sums over 3584 and
   512 terms are taken in another order; ``ssd_scan``'s outputs (float32
   for either input type): float32 inputs 1e-5 of the output's scale,
   max(1, max |plain|), as its sums over up to 128 terms are taken in
   another order; bf16 inputs run on the tensor cores, which round M to
   bf16 and pass the state and x w as bf16 hi/lo pairs, and are held to
   ``ssd_tc_bound`` per element;
4. time each kernel at its path's shapes with CUDA events, beside its
   plain version, the least time the card could take (its bound) and one
   PyTorch library call computing the same function as a yardstick
   (``scaled_dot_product_attention`` with the same mask; none exists for
   ``probe_update``, whose w1 fits in L2, so it is timed with L2 flushed
   before every call, at 16 rows and 1, beside the launch floor (an
   empty kernel launched as the call is: cooperative, on its grid,
   clusters and shared memory) and the clusters the card holds at once,
   which the plan reads; nor for ``ssd_scan``); the single-query decode
   kernels and their library call as CUDA graphs of 30 calls (at the
   serves' shapes a call takes less device time than its wrapper takes
   on the host), also at the shapes the serves launch most: the gemma2-9b
   and hymba-1.5b local rings holding 300 positions and granite's
   28-page tables holding about 300 tokens; ``ssd_scan`` at a prefill
   chunk's shape of mamba2-370m and hymba-1.5b and at the tap harvest's
   (mamba2-370m, 8 x 512 from a zero state);
5. hold the model on the card against the same weights on the CPU in
   float32: ``granite-smoke`` (paged), ``gemma2-smoke`` (contiguous and
   paged), ``mamba2-smoke`` and ``hymba-smoke`` (contiguous and
   paged), two prefill chunks (24 and 20 tokens, so the rings of 16
   wrap; one row padded in the first) and a megastep with an inactive
   row: greedy tokens equal, logits within 1e-4;
6. serve ``granite-3-8b`` at full width (40 layers, random weights from a
   seed) through ``run_policy(mode="real", kv_layout="paged",
   policy="trail", probe_interval=4)`` with the probe predictor; step a
   short second run checking ``lengths == _kv_written``; then
   (``phase_cluster``) drive ``repro_torch.cluster.Router`` over 2 real
   paged replicas of that same model (each its own pool, seed and probe
   predictor) with the same 12 requests three times: colocated jspw (both
   replicas served, both paged kernels launched), 1 prefill + 1 decode
   replica (12 handoffs, each payload bit-equal to the source pool's
   pages just before export and the destination's just after import),
   and jspw with replica 1 crashed at half the colocated run's virtual
   makespan (goodput 1.0, a retry, the crashed pool's ``pkpos`` all -1
   once its resets are flushed); each with 12 of 12 finished and no page
   used at the drain, its host wall, dispatch counts, engine steps, peak
   memory and launches logged; then the reference's migration test on
   ``granite-smoke`` in float32 on the card (the migrated request's
   greedy tokens equal the unmigrated run's and the CPU's); profile one
   decode megastep and one prefill chunk;
7. serve ``gemma2-9b`` at full width and depth (42 layers, random weights
   from seed 0) through ``run_policy(mode="real", kv_layout="contig",
   ...)``: 12 requests, two with prompts past the 4096-token window so the
   local layers' rings wrap; check that every request finished, that
   ``decode_attention`` ran 42 times per decode step and that nothing is
   NaN; then step a short paged run on the same model (global layers
   through the paged kernels, local layers through ``decode_attention``)
   checking ``lengths == _kv_written`` after every step;
8. drive ``launch.steps.make_serve_step`` on ``gemma2-9b`` for 8 steps
   after a prefill: each step's fused probe (``probe_update``) against
   its plain version on the same tap, predicted lengths finite; then
   profile one more step (its wall and device time);
9. profile one ``gemma2-9b`` decode megastep and one prefill chunk;
10. ``flash_attention`` (the training and profiling forwards): checked in
    phase 3 against its plain version, float32 and bfloat16, at the
    shapes of ``tests/test_kernels.py``, non-causal at S=200, and at the
    path's shapes (trail-llama 8x512 with 12/4 heads, granite 8x512 with
    32/8 heads, a gemma2-9b local layer at S=4608 with window 4096 and
    softcap 50, a gemma3-1b local layer with window 512, hymba-1.5b's
    25/5 heads with window 1024 at S=1500, and granite's heads at S=777,
    neither a multiple of the key tile), plus the
    ``FlashAttention`` Function's gradients against plain autograd;
    timed in phase 4 at the trail-llama, granite and gemma2 shapes
    (library yardstick: ``scaled_dot_product_attention(is_causal=True,
    enable_gqa=True)``, no softcap or window);
11. hold the training path on the card against the CPU in float32 on
    ``trail-llama-smoke`` and ``gemma2-smoke`` (S=64, so the window of 16
    binds): ``forward_train`` loss and tap, every parameter's gradient,
    and one ``train_lm`` step;
12. profile ``granite-3-8b`` at full width and depth on its served model:
    harvest 4 batches of 8 x 512 tokens of tap embeddings with
    ``harvest_probe_data`` and train a probe on them (printed, not gated:
    the weights are random);
13. one ``gemma2-9b`` ``forward_train`` at B=1, S=4608 (past the 4096-token
    window) under inference mode: 42 launches, a finite loss;
14. train ``trail-llama`` at full width (12 layers, d_model 768) through
    ``python -m repro_torch.launch.train``'s ``main`` for ``TRAIN_STEPS``
    steps of 8 x 512 tokens: the last logged loss below 0.7 x the first
    (the reference's own test factor), 24 ``flash_attention`` launches per
    step (12 layers, and 12 again in the remat recompute), the ``--ckpt``
    file read back with ``load_npz``; then harvest its taps, check
    ``forward_all_taps``, train the probe (its MAE below the
    uniform prior's), serve 12 requests with that probe under
    ``policy="trail"``, and profile one train step;
15. serve ``mamba2-370m`` at full width and depth (48 SSM layers, random
    weights from seed 0) through ``run_policy(mode="real",
    kv_layout="contig", ...)``: 12 requests, two with prompts of about
    4000 tokens that carry the state over 16 chunks; check that every
    request finished, that ``ssd_scan`` ran 48 times per prefill chunk
    and that nothing is NaN; profile one decode megastep and one
    prefill chunk; harvest 8 batches of 8 x 512 tap embeddings;
16. the same for ``hymba-1.5b`` (32 hybrid layers: 1024-token windowed
    attention beside the SSM), two prompts past the window so the rings
    wrap: ``ssd_scan`` 32 times per prefill chunk, ``decode_attention``
    32 times per decode step.
17. train the SSM stacks on the card through ``models.ssm.SSDScan``
    (the ``ssd_scan`` kernel forward, the plain version's backward):
    ``mamba2-smoke`` and ``hymba-smoke`` in float32, ``forward_train``
    loss and every parameter's gradient against the CPU on the same
    masters (1e-5 relative; 1e-5 plus 1e-4 of the leaf's largest), with
    ``ssd_scan`` (and hymba's ``flash_attention``) launched; then
    ``mamba2-370m`` at full width and depth for ``SSM_TRAIN_STEPS`` steps
    of 8 x 512 through ``launch.train.main``: the last logged loss below
    0.7 x the first, ``ssd_scan`` twice a layer a step (forward and remat
    recompute); then profile one such train step and time one layer's
    ``SSDScan`` there, the kernel forward against the plain backward;
18. serve through the entry point, ``repro_torch.launch.serve.main``, in
    process (``SERVE_CLI_RUNS``): ``granite-3-8b --real --n 12`` under
    the contiguous layout (``decode_attention``) writing
    ``--metrics-out`` (it must parse, and the run's event log must pass
    ``check_invariants``), the same under ``--kv-layout paged`` (both
    paged kernels), and ``mamba2-370m --real --n 12`` (``ssd_scan``):
    12 of 12 finished each, the host wall of each run printed.

Every kernel launch count is set to 0 just before a path is driven and
read just after it; launches made to compare a kernel with its plain
version do not count. The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. The engine's own latencies come from
its cost model (a TPU v5e preset) and are not printed as card times: the
serve phases report host wall time around work that ends in
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM memory rate
PEAK_OPS = {"bfloat16": 989e12,     # dense bf16 tensor-core rate
            "float32": 67e12}       # float32 outside the tensor cores
TOL = {"float32": 1e-5, "bfloat16": 2e-2}        # max |kernel - plain|
ROUNDING = {"float32": None, "bfloat16": (2.0 ** -7, 1e-4)}   # (rel, abs)
TC_KERNELS = ("flash_attention", "paged_decode_attention_multi")  # bf16: wgmma
PORT_KERNELS = (r"flash_attention_(tc_)?kernel|paged_multi_(tc_)?kernel|"
                r"decode_kernel|probe_update_kernel|"
                r"ssd_scan_(tc_)?kernel")
PROBE_TOL = 1e-5
PAGED_ARGS = ("q", "k_pages", "v_pages", "kpos_pages", "block_table", "q_pos")
SLOT_ARGS = ("q", "k", "v", "kpos", "q_pos")
TRAIN_STEPS = 40                    # trail-llama steps of 8 x 512 tokens
PROBE_EPOCHS = 8                    # the paper's 30, cut for time
SSM_TRAIN_STEPS = 40                # mamba2-370m steps of 8 x 512 tokens


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# kernel inputs, bounds and timing
# ---------------------------------------------------------------------------

def paged_case(torch, *, B, T, H, KH, hd, ps, pmax, dtype, seed,
               inactive=(), all_active=False, lengths=None):
    """Random page pool with scrambled block tables (on the card).

    Each row holds a random length (or ``lengths[b]``); its pages are a
    random permutation of the pool, unused table entries point at null
    page 0 (kpos -1). Query positions are the T trailing positions of each
    row (earlier than 0 -> -1); rows listed in ``inactive`` get q_pos = -1
    throughout. ``all_active`` gives every row the full table instead.
    """
    import numpy as np
    rng = np.random.default_rng(seed)
    P = 1 + B * pmax
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    tdt = getattr(torch, dtype)
    q = torch.randn((B, T, H, hd), generator=g, device=dev).to(tdt)
    k = torch.randn((P, ps, KH, hd), generator=g, device=dev).to(tdt)
    v = torch.randn((P, ps, KH, hd), generator=g, device=dev).to(tdt)
    if all_active:
        lengths = np.full(B, pmax * ps)
    elif lengths is None:
        lengths = rng.integers(1, pmax * ps, size=B)
    lengths = np.asarray(lengths)
    bt = np.zeros((B, pmax), np.int32)
    kpos = np.full((P, ps), -1, np.int32)
    perm = rng.permutation(np.arange(1, P))
    pi = 0
    for b in range(B):
        for lp in range(-(-int(lengths[b]) // ps)):
            pid = int(perm[pi])
            pi += 1
            bt[b, lp] = pid
            n = min(ps, int(lengths[b]) - lp * ps)
            kpos[pid, :n] = np.arange(lp * ps, lp * ps + n)
    q_pos = (lengths - 1)[:, None] - np.arange(T - 1, -1, -1)[None]
    q_pos = np.where(q_pos >= 0, q_pos, -1).astype(np.int32)
    q_pos[list(inactive)] = -1
    return dict(q=q, k_pages=k, v_pages=v,
                kpos_pages=torch.from_numpy(kpos).to(dev),
                block_table=torch.from_numpy(bt).to(dev),
                q_pos=torch.from_numpy(q_pos).to(dev))


def slot_case(torch, *, B, H, KH, hd, M, window, dtype, seed, inactive=(),
              lengths=None):
    """Random slot cache laid out as ``cache_write`` lays it out (on the
    card). Without a window, position p sits in slot p; with one the M
    slots are a ring holding each row's last M positions at slot p % M,
    so a row longer than M has wrapped and its positions are out of slot
    order. Row lengths are random (up to 3M for a ring) unless given;
    q_pos is each row's last position, -1 for rows in ``inactive``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    tdt = getattr(torch, dtype)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(tdt)
    k = torch.randn((B, M, KH, hd), generator=g, device=dev).to(tdt)
    v = torch.randn((B, M, KH, hd), generator=g, device=dev).to(tdt)
    if lengths is None:
        lengths = rng.integers(1, 3 * M if window else M, size=B)
    kpos = np.full((B, M), -1, np.int32)
    for b, n in enumerate(lengths):
        pos = np.arange(max(0, int(n) - M), int(n))
        kpos[b, pos % M if window else pos] = pos
    q_pos = (np.asarray(lengths) - 1).astype(np.int32)
    q_pos[list(inactive)] = -1
    return dict(q=q, k=k, v=v, kpos=torch.from_numpy(kpos).to(dev),
                q_pos=torch.from_numpy(q_pos).to(dev))


def probe_case(torch, *, B, d, hid, k, tap_dtype, seed, fallback=False):
    """Probe weights at the reference init scales, a tap and a previous
    posterior (on the card). With ``fallback`` row 0's prior and probe
    distribution do not overlap: its tap is scaled up (by powers of 10)
    until the probe puts all its mass on one bin (every other exponential
    underflows to 0), and its previous posterior sits on the bin half the
    bins away, so prior * p sums to 0 there and the filter falls back to
    the prior. The other rows keep ordinary distributions."""
    from repro_torch.config import ProbeConfig
    from repro_torch.core.predictor import apply_probe
    from repro_torch.core.smoothing import transition_matrix
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32
    w = dict(w1=torch.randn((d, hid), generator=g, device=dev) * d ** -0.5,
             b1=0.1 * torch.randn((hid,), generator=g, device=dev),
             w2=torch.randn((hid, k), generator=g, device=dev) * hid ** -0.5,
             b2=0.1 * torch.randn((k,), generator=g, device=dev))
    tap = torch.randn((B, d), generator=g, device=dev)
    q_prev = torch.softmax(torch.randn((B, k), generator=g, device=dev), -1)
    T = torch.as_tensor(transition_matrix(ProbeConfig(num_bins=k)),
                        dtype=f32, device=dev)
    tap = tap.to(getattr(torch, tap_dtype))
    if fallback:        # scale until every other bin underflows
        row = tap[:1]
        while True:
            row = row * 10.0
            p = torch.softmax(apply_probe(w, row), dim=-1)[0]
            j = (int(p.argmax()) + k // 2) % k
            if float((p * T[:, j]).sum()) == 0.0:
                break
        tap[0] = row[0]
        q_prev[0] = 0.0
        q_prev[0, j] = 1.0
    return dict(tap=tap, **w, q_prev=q_prev, T=T)


def bound_ms(nbytes: float, ops: float, dtype: str):
    """Least card time: the larger of bytes over the memory rate and
    operations over the peak rate of the input type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def paged_bound(case, dtype):
    """Bytes: each input read once (the K/V/kpos of the pages the block
    tables reference, q, the tables, q_pos) and the output written once.
    Operations: 4*hd (QK^T and PV) per (query head, key) pair that the
    position mask lets through (kpos >= 0 and kpos <= q_pos; no window)."""
    q, k, bt, qp = (case["q"], case["k_pages"], case["block_table"],
                    case["q_pos"])
    B, T, H, hd = q.shape
    ps, KH = k.shape[1], k.shape[2]
    el = q.element_size()
    pages = int((bt != 0).sum())
    nbytes = (pages * ps * (2 * KH * hd * el + 4) + 2 * q.numel() * el
              + bt.numel() * 4 + qp.numel() * 4)
    kpos = case["kpos_pages"][bt.long()].reshape(B, 1, -1)      # (B,1,M)
    pairs = int(((kpos >= 0) & (kpos <= qp.reshape(B, T, 1))).sum())
    return bound_ms(nbytes, 4 * hd * H * pairs, dtype)


def slot_bound(case, window, dtype):
    """Bytes: q and q_pos, the kpos of the slots the function must look at
    (a ring: all M; without a window: slots 0..q_pos, where cache_write
    puts every position a query can see), the K and V rows the mask lets
    through, read once each, and the output written once. Operations:
    4*hd per (query head, valid key) pair."""
    q, k, kpos, qp = case["q"], case["k"], case["kpos"], case["q_pos"]
    B, H, hd = q.shape
    M, KH = k.shape[1], k.shape[2]
    el = q.element_size()
    valid = (kpos >= 0) & (kpos <= qp[:, None])
    if window:
        valid &= kpos > qp[:, None] - window
    looked = B * M if window else int((qp + 1).clamp(0, M).sum())
    rows = int(valid.sum())
    nbytes = rows * 2 * KH * hd * el + looked * 4 + 2 * q.numel() * el + B * 4
    return bound_ms(nbytes, 4 * hd * H * rows, dtype)


def probe_bound(case):
    """Bytes: every input read once (w1 dominates) and both outputs
    written once. Operations: 2*B*d*hid + 2*B*hid*k for the two products,
    at the float32 rate of the card's CUDA cores (w1 is float32)."""
    tap, w1, w2 = case["tap"], case["w1"], case["w2"]
    B, d = tap.shape
    hid, k = w2.shape
    nbytes = (sum(t.numel() * t.element_size() for t in case.values())
              + 2 * B * k * 4)
    return bound_ms(nbytes, 2 * B * d * hid + 2 * B * hid * k, "float32")


def flash_case(torch, *, B, S, H, KH, hd, dtype, seed):
    """q (B,S,H,hd), k/v (B,S,KH,hd): standard normal draws made with numpy
    from ``seed`` (as ``tests/test_torch_kernels.py`` makes them), cast to
    ``dtype`` on the card."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to("cuda").to(tdt)
            for shape in ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd))]


def flash_bound(q, k, window, dtype):
    """Bytes: q, k and v read once and the output written once. Operations:
    4*hd (QK^T and PV) per (query head, key) pair that the causal (and
    window) mask lets through."""
    B, S, H, hd = q.shape
    el = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * el
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    return bound_ms(nbytes, 4 * hd * H * B * pairs, dtype)


def flash_library_call(q, k, v):
    """One ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
    on (B, H, S, hd) copies made outside the timed call: the yardstick
    (never used by the port). It has no softcap or window, so it times
    the plain causal attention."""
    import torch.nn.functional as F
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                  enable_gqa=True)


def time_ms(torch, fn, iters=30, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(torch, fn, iters=30, warmup=3):
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    and replayed between two events, so no host work sits between the
    calls (a decode call at the serves' shapes takes less device time
    than its wrapper takes on the host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def time_cold_ms(torch, fn, iters=30, warmup=3):
    """Mean time of one call with the 50 MB L2 flushed before each (a 256
    MB write between calls, outside the timed events)."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def paged_library_call(torch, case):
    """One ``scaled_dot_product_attention`` over the gathered cache with the
    same position mask: the yardstick (never used by the port)."""
    import torch.nn.functional as F
    q, k, v = case["q"], case["k_pages"], case["v_pages"]
    bt, qp = case["block_table"].long(), case["q_pos"]
    B, T, H, hd = q.shape
    KH = k.shape[2]
    kg = k[bt].reshape(B, -1, KH, hd).repeat_interleave(H // KH, dim=2)
    vg = v[bt].reshape(B, -1, KH, hd).repeat_interleave(H // KH, dim=2)
    kpos = case["kpos_pages"][bt].reshape(B, -1)
    mask = ((kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qp[:, :, None]))
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, kg, vg))
    mask = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)


def slot_library_call(case, window):
    """``scaled_dot_product_attention`` over the slot cache with the same
    mask (one query per row, K/V heads repeated for the query groups
    outside the timed call). SDPA has no softcap; it times the same
    attention without one."""
    import torch.nn.functional as F
    q, k, v, kpos, qp = (case[n] for n in SLOT_ARGS)
    B, H, hd = q.shape
    KH = k.shape[2]
    kh, vh = (x.repeat_interleave(H // KH, dim=2).transpose(1, 2).contiguous()
              for x in (k, v))
    valid = (kpos >= 0) & (kpos <= qp[:, None])
    if window:
        valid &= kpos > qp[:, None] - window
    qh = q[:, :, None]
    mask = valid[:, None, None]
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)


def ssd_case(torch, *, B, L, nh, hp, N, dtype, seed, decay):
    """x (B,L,nh,hp), dt (B,L,nh) post-softplus, A (nh,) negative, Bm/Cm
    (B,L,N) and an initial state (B,nh,hp,N), drawn with numpy as
    ``tests/test_torch_kernels.py`` draws them; x, Bm and Cm cast to
    ``dtype`` on the card. ``decay`` scales A (small: the state carries
    across chunks)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    f = np.float32
    arrays = dict(
        x=rng.standard_normal((B, L, nh, hp)).astype(f),
        dt=np.log1p(np.exp(rng.standard_normal((B, L, nh)))).astype(f),
        A=(-np.exp(rng.standard_normal(nh) * 0.3) * decay).astype(f),
        Bm=rng.standard_normal((B, L, N)).astype(f),
        Cm=rng.standard_normal((B, L, N)).astype(f),
        init_state=(0.5 * rng.standard_normal((B, nh, hp, N))).astype(f))
    case = {k: torch.from_numpy(a).to("cuda") for k, a in arrays.items()}
    for k in ("x", "Bm", "Cm"):
        case[k] = case[k].to(getattr(torch, dtype))
    return case


def ssd_bound(case, chunk, dtype):
    """Bytes: x, dt, A, Bm, Cm and the initial state read once, y and the
    final state (float32) written once. Operations per (row, head, chunk
    of Q): 2*N and 2*hp per (t, s <= t) pair for C B^T and M x, 2*N*hp per
    position for the readout from the state and again for its update."""
    x, Bm = case["x"], case["Bm"]
    B, L, nh, hp = x.shape
    N = Bm.shape[-1]
    nbytes = (sum(t.numel() * t.element_size() for t in case.values())
              + 4 * (x.numel() + B * nh * hp * N))
    pairs = chunk * (chunk + 1) // 2
    ops = B * nh * (L // chunk) * (2 * pairs * (N + hp)
                                   + 4 * chunk * N * hp)
    return bound_ms(nbytes, ops, dtype)


def compare_ssd(label, got, want, parts=("y", "state"), bounds=None):
    """``ssd_scan``'s outputs (y, final state) against its plain version.
    Without ``bounds`` (float32, or a kernel against itself): max
    |kernel - plain| within 1e-5 of max(1, max |plain|). With ``bounds``
    (bf16 on the tensor cores), every element within its part's
    ``ssd_tc_bound``. Returns the max absolute error."""
    worst = 0.0
    for k, (part, a, b) in enumerate(zip(parts, got, want)):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"ssd_scan {part}: {a.dtype}{tuple(a.shape)} vs "
                 f"{b.dtype}{tuple(b.shape)}")
        diff = (a - b).abs()
        err = float(diff.max())
        scale = max(1.0, float(b.abs().max()))
        if bounds is None:
            ok, what = err <= 1e-5 * scale, "tol 1e-5 of scale"
        else:
            over = int((diff > bounds[k]).sum())
            ok, what = over == 0, f"{over} element(s) past ssd_tc_bound"
        log(f"[check] {'ssd_scan ' + part:30s} {label}: max|kernel-plain|="
            f"{err:.3e} of scale {scale:.1f} ({what})")
        if not ok:
            fail(f"ssd_scan {part} disagrees with its plain version "
                 f"({label}): {err} of scale {scale}, {what}")
        worst = max(worst, err)
    return worst


def ssd_tc_bound(plain_y, plain_s, mag_y, mag_s):
    """Per-element bounds on |kernel - plain| for the bf16 results of the
    tensor-core ``ssd_scan``: (the bound on y, the bound on the final
    state).

    ``mag_y`` and ``mag_s`` are A_y and A_s, the plain version's y and
    final state on (|x|, dt, A, |Bm|, |Cm|, |s0|): each term of the true
    sums is at most the matching term of that run. The kernel rounds M =
    (C B^T) exp(cum_t - cum_s) dt_s to bf16 once, which moves each intra
    term of y by at most 2^-8 of itself, so y by at most 2^-8 A_y; the
    state S (in the readout) and x w (in the state update) pass to the
    tensor cores as bf16 pairs hi = bf16(v), lo = bf16(v - hi), which move
    each of their terms by at most 2^-16 of itself, carried chunk to
    chunk with the same decay as the terms. So y within 2^-7 A_y (twice
    M's rounding, the margin covering the split's share) and the state
    within 2^-14 A_s (four times the split's), each plus 1e-5 of the
    output's scale max(1, max |plain|) for float32 sums taken in another
    order. C, B and x arrive in bf16 and are exact operands."""
    def scale(t):
        return 1e-5 * max(1.0, float(t.abs().max()))
    return (2.0 ** -7 * mag_y.float() + scale(plain_y),
            2.0 ** -14 * mag_s.float() + scale(plain_s))


def ssd_magnitudes(ref, case, chunk):
    """A_y and A_s of ``ssd_tc_bound``: the plain version on |x|, |Bm|,
    |Cm| and |s0| (dt and A as they are)."""
    mag = {k: (v.abs() if k in ("x", "Bm", "Cm", "init_state") else v)
           for k, v in case.items()}
    return ref.ssd_scan_ref(**mag, chunk=chunk)


def tc_attention_bound(plain, magnitude):
    """Per-element bound on |kernel - plain| for a bf16 result of the
    tensor-core attention kernels: 2**-7 * A + 2**-7 * |plain| + 1e-4.

    ``magnitude`` is A, the plain version run on |v| (float32): sum_j p_j
    |v_j| / l, the size of the terms that P multiplies. The kernel rounds
    P to bf16 before P V, as every flash attention on tensor cores does,
    and that moves each term p_j v_j by at most 2**-8 of itself, so the
    output by at most 2**-8 * A; the second factor of 2 is the margin for
    the online rescaling, a denominator summed from the unrounded P, and
    float32 sums taken in another order. 2**-7 * |plain| + 1e-4 is the
    one rounding of the output to bf16 that the other kernels are held
    to. Where the plain value cancels to near 0, A keeps the bound at the
    size of what was summed."""
    return (2.0 ** -7 * magnitude.float() + 2.0 ** -7 * plain.float().abs()
            + 1e-4)


def compare(name, label, got, want, dtype, magnitude=None):
    """Max |kernel - plain| and the elements past the per-element bound;
    fails on a dtype or shape mismatch or a disagreement. The bound is one
    bf16 rounding of the output, or, for the tensor-core kernels' bf16
    results, ``tc_attention_bound`` with ``magnitude``."""
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{name}: {got.dtype}{tuple(got.shape)} vs "
             f"{want.dtype}{tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    over, what = 0, "one rounding"
    if dtype == "bfloat16" and name in TC_KERNELS:
        if magnitude is None:
            fail(f"{name}: a bf16 check needs the magnitude of its terms")
        over = int((diff > tc_attention_bound(want, magnitude)).sum())
        what = "the P-rounding bound"
    elif ROUNDING[dtype] is not None:
        rel, atol = ROUNDING[dtype]
        over = int((diff > rel * want.float().abs() + atol).sum())
    log(f"[check] {name:30s} {label}: max|kernel-plain|={err:.3e} "
        f"(tol {TOL[dtype]:.0e}), {over} element(s) past {what}")
    if not err <= TOL[dtype] or over:
        fail(f"{name} disagrees with its plain version ({label}): {err}, "
             f"{over} element(s) past {what}")
    return err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, count, card


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build_all(build.SOURCES)
    log(f"[build] {len(build.SOURCES)} source(s) in "
        f"{time.perf_counter() - t0:.1f} s -> {build.BUILD_DIR}")
    for name, report in reports.items():
        for kernel, usage in ptxas_usage(report):
            log(f"[build] {name}: {kernel}: {usage}")
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    for name in ("flash_attention", "paged_decode_attention", "ssd_scan"):
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build.library_path(name))],
                              capture_output=True, text=True, check=True)
        n = len(re.findall(r"\bHGMMA\.", sass.stdout))
        log(f"[build] {name}: {n} HGMMA instruction(s) in its SASS")
        if n == 0:
            fail(f"{name}: no wgmma (HGMMA) in its SASS")


def ptxas_usage(report: str):
    """(kernel instance, "registers; spills") per entry function of an
    ``nvcc -Xptxas -v`` report."""
    kernel, spills = None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"\d+([a-z_]+_kernel)", mangled)
            args = (["bf16"] if "__nv_bfloat16" in mangled else
                    ["f32"] if re.search(r"_kernelIf", mangled) else [])
            args += re.findall(r"Li(\d+)E", mangled)
            args += [r for r in ("PagedRows", "SlotRows") if r in mangled]
            kernel = (f"{base.group(1) if base else mangled}"
                      f"<{', '.join(args)}>")
        elif kernel and "spill" in line:
            spills = line.split(":", 1)[-1].strip()
        elif kernel and "registers" in line:
            yield kernel, f"{line.split(':', 1)[-1].strip()}; {spills}"
            kernel = None


PAGED_SHAPES = {  # (H, KH, hd) of the served architectures
    "granite-3-8b": (32, 8, 128),
    "trail-llama": (12, 4, 64),
    "gemma2-9b": (16, 8, 256),
}

SLOT_CASES = [  # arch, H, KH, hd, M, window, softcap
    ("gemma2-9b global", 16, 8, 256, 4608, 0, 50.0),
    ("gemma2-9b local", 16, 8, 256, 4096, 4096, 50.0),
    ("gemma3-1b local", 4, 1, 256, 512, 512, 0.0),
    ("granite-3-8b", 32, 8, 128, 448, 0, 0.0),
    ("hymba-1.5b local", 25, 5, 64, 1025, 1024, 0.0),
]


FLASH_CASES = [  # label, B, S, H, KH, hd, window, softcap, causal
    ("sweep", 2, 64, 4, 2, 32, 0, 0.0, True),
    ("sweep MQA ragged", 1, 100, 4, 1, 64, 0, 0.0, True),
    ("sweep MHA window", 2, 128, 8, 8, 32, 32, 0.0, True),
    ("sweep softcap", 1, 96, 4, 2, 32, 0, 50.0, True),
    ("sweep window+softcap", 2, 80, 4, 2, 32, 24, 30.0, True),
    ("non-causal S=200", 1, 200, 4, 2, 64, 0, 0.0, False),
    ("trail-llama", 8, 512, 12, 4, 64, 0, 0.0, True),
    ("granite-3-8b", 8, 512, 32, 8, 128, 0, 0.0, True),
    ("gemma2-9b local", 1, 4608, 16, 8, 256, 4096, 50.0, True),
    ("gemma3-1b local", 2, 1024, 4, 1, 256, 512, 0.0, True),
    ("hymba-1.5b local", 2, 1500, 25, 5, 64, 1024, 0.0, True),
    ("granite ragged S", 2, 777, 32, 8, 128, 0, 0.0, True),
]

SSD_CASES = [  # label, B, L, nh, hp, N, chunk, decay of A
    ("sweep", 2, 64, 4, 32, 16, 16, 1.0),
    ("sweep", 1, 128, 2, 64, 32, 32, 1.0),
    ("sweep", 2, 96, 3, 32, 8, 32, 1.0),
    ("odd widths", 2, 64, 3, 33, 13, 32, 1.0),    # rows of odd byte length
    ("mamba2-370m", 16, 256, 32, 64, 128, 128, 0.05),
    ("hymba-1.5b", 16, 256, 50, 64, 16, 128, 0.05),
    ("L=8 bucket", 16, 8, 32, 64, 128, 8, 0.05),
]

SSD_TIMED = {  # label: B, L, nh, N, from an initial state (bf16, hp 64)
    "ssd_scan[mamba2-370m]": (16, 256, 32, 128, True),
    "ssd_scan[hymba-1.5b]": (16, 256, 50, 16, True),
    "ssd_scan[mamba2-370m,harvest]": (8, 512, 32, 128, False),
}

FLASH_TIMED = {  # arch: B, S, H, KH, hd, window, softcap (bf16)
    "trail-llama": (8, 512, 12, 4, 64, 0, 0.0),
    "granite-3-8b": (8, 512, 32, 8, 128, 0, 0.0),
    "gemma2-9b local": (1, 4608, 16, 8, 256, 4096, 50.0),
}


def phase_check_flash(torch):
    """``flash_attention`` against its plain version on the same inputs,
    and the ``FlashAttention`` Function's dq, dk, dv against plain
    autograd. Returns the worst bf16 error at the trail-llama shape (the
    one its row in the JSON line times)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models.attention import FlashAttention
    worst = 0.0
    for i, (label, B, S, H, KH, hd, window, cap, causal) in enumerate(
            FLASH_CASES):
        for dtype in ("float32", "bfloat16"):
            # seed 0 for the non-causal case: the inputs of
            # test_flash_attention_non_causal_never_counts_padding
            q, k, v = flash_case(torch, B=B, S=S, H=H, KH=KH, hd=hd,
                                 dtype=dtype, seed=0 if not causal else i)
            got = fa.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=cap)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, softcap=cap)
            mag = ref.flash_attention_ref(q.float(), k.float(),
                                          v.float().abs(), causal=causal,
                                          window=window, softcap=cap)
            torch.cuda.synchronize()
            err = compare("flash_attention",
                          f"{label:20s} {dtype:8s} B={B} S={S} H={H} "
                          f"KH={KH} hd={hd} window={window} "
                          f"softcap={cap:2.0f} causal={causal}",
                          got, want, dtype, mag)
            if label == "trail-llama" and dtype == "bfloat16":
                worst = err
            del q, k, v, got, want, mag
    for dtype, (B, S, H, KH, hd, window, cap) in (
            ("float32", (2, 300, 12, 4, 64, 0, 0.0)),
            ("bfloat16", (2, 512, 16, 8, 256, 128, 50.0))):
        q, k, v = flash_case(torch, B=B, S=S, H=H, KH=KH, hd=hd, dtype=dtype,
                             seed=S)
        dout = torch.randn_like(q)
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(FlashAttention.apply(*ins, window, cap),
                                  ins, dout)
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(ref.flash_attention_ref(
            *ins, window=window, softcap=cap), ins, dout)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            compare("FlashAttention." + name,
                    f"B={B} S={S} H={H} KH={KH} hd={hd} window={window} "
                    f"softcap={cap:2.0f} {dtype}", a, b, dtype)
    return worst


def phase_check_ssd(torch):
    """``ssd_scan`` against its plain version from an initial state, both
    input types (bf16 to ``ssd_tc_bound``, float32 to 1e-5 of scale);
    rows whose tail has dt = 0 end in the shorter scan's state (within
    the bound of the plain one's, bit for bit the kernel's); a scan in two
    halves equals one within 1e-5. Returns the worst error at
    mamba2-370m's bf16 shape (the one its row in the JSON line times)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd
    worst = 0.0
    for i, (label, B, L, nh, hp, N, chunk, decay) in enumerate(SSD_CASES):
        for dtype in ("float32", "bfloat16"):
            case = ssd_case(torch, B=B, L=L, nh=nh, hp=hp, N=N, dtype=dtype,
                            seed=i, decay=decay)
            got = ssd.ssd_scan(**case, chunk=chunk)
            want = ref.ssd_scan_ref(**case, chunk=chunk)
            bounds = (ssd_tc_bound(*want, *ssd_magnitudes(ref, case, chunk))
                      if dtype == "bfloat16" else None)
            torch.cuda.synchronize()
            err = compare_ssd(f"{label:12s} {dtype:8s} B={B} L={L} nh={nh} "
                              f"hp={hp} N={N} chunk={chunk}", got, want,
                              bounds=bounds)
            if label == "mamba2-370m" and dtype == "bfloat16":
                worst = err
            del case, got, want, bounds
    # mamba2's shape: rows 0-3 idle (dt = 0) from position 128 (a whole
    # chunk), rows 4-7 from position 100; their states against the scan of
    # the positions before (bit for bit against the kernel's: dt = 0 adds
    # exactly nothing to the in-order cumsum or to the state)
    case = ssd_case(torch, B=16, L=256, nh=32, hp=64, N=128,
                    dtype="bfloat16", seed=20, decay=0.05)
    case["dt"][:4, 128:] = 0.0
    case["dt"][4:8, 100:] = 0.0
    _, s = ssd.ssd_scan(**case, chunk=128)
    for rows, n in ((slice(0, 4), 128), (slice(4, 8), 100)):
        part = {k: (v[rows, :n].contiguous() if k != "A" else v)
                for k, v in case.items() if k != "init_state"}
        part["init_state"] = case["init_state"][rows].contiguous()
        _, s_short = ssd.ssd_scan(**part, chunk=n)
        y_plain, s_plain = ref.ssd_scan_ref(**part, chunk=n)
        _, bound = ssd_tc_bound(y_plain, s_plain,
                                *ssd_magnitudes(ref, part, n))
        torch.cuda.synchronize()
        compare_ssd(f"rows idle from {n} vs the {n}-position scan",
                    (s[rows],), (s_plain,), parts=("state",),
                    bounds=(bound,))
        same = bool(torch.equal(s[rows], s_short))
        log(f"[check] ssd_scan idle tail from {n}: state bit-equal to the "
            f"kernel's {n}-position scan: {same}")
        if not same:
            fail(f"ssd_scan: positions with dt = 0 from {n} on changed the "
                 f"state")
    # a scan in two halves, the second from the first's final state
    y, s = ssd.ssd_scan(**case, chunk=128)
    first = {k: (v[:, :128].contiguous() if v.dim() > 1 and k != "init_state"
                 else v) for k, v in case.items()}
    second = {k: (v[:, 128:].contiguous() if v.dim() > 1 and k != "init_state"
                  else v) for k, v in case.items()}
    y1, second["init_state"] = ssd.ssd_scan(**first, chunk=128)
    y2, s2 = ssd.ssd_scan(**second, chunk=128)
    torch.cuda.synchronize()
    compare_ssd("two halves vs one scan", (torch.cat([y1, y2], 1), s2),
                (y, s))
    return worst


def check_multi(paged, ref, args, cap):
    """The multi-query kernel, its plain version, and the plain version on
    |v| in float32 (the magnitude ``tc_attention_bound`` takes)."""
    got = paged.paged_decode_attention_multi(*args, softcap=cap)
    want = ref.paged_decode_attention_multi_ref(*args, softcap=cap)
    q, k, v = (a.float() for a in args[:3])
    mag = ref.paged_decode_attention_multi_ref(q, k, v.abs(), *args[3:],
                                               softcap=cap)
    return got, want, mag


PROBE_CASES = [  # label, B, d, hid, k, tap dtype, fallback
    ("gemma2-9b", 16, 3584, 512, 10, "bfloat16", True),
    ("gemma2-9b", 16, 3584, 512, 10, "float32", True),
    ("gemma2-9b", 1, 3584, 512, 10, "bfloat16", True),
    ("gemma2-9b", 1, 3584, 512, 10, "float32", True),
    ("gemma2-9b", 17, 3584, 512, 10, "bfloat16", True),
    ("gemma2-9b", 64, 3584, 512, 10, "float32", True),
    ("granite-3-8b", 16, 4096, 512, 10, "bfloat16", True),
    ("trail-llama", 16, 768, 512, 10, "bfloat16", True),
    ("odd d", 16, 200, 512, 10, "float32", True),
    ("odd d", 16, 201, 512, 10, "bfloat16", True),   # element-wise tap
    ("hid 48", 16, 3584, 48, 10, "bfloat16", True),
    ("hid 50", 5, 768, 50, 10, "float32", True),     # 4-byte copies
    ("k 1", 16, 3584, 512, 1, "bfloat16", False),    # p = 1: no fallback
    ("k 32", 16, 3584, 512, 32, "float32", True),
    ("d 20000", 17, 20000, 64, 10, "bfloat16", True),  # 3 slices a CTA
    ("hid 8192", 6, 1600, 8192, 10, "float32", True),  # 256 blocks, 132 CTAs
]


def phase_check(torch):
    """Every kernel against its plain version on the same inputs; returns
    the worst error of each at the shapes its row in the JSON line times."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import paged_decode_attention as paged
    from repro_torch.kernels import probe, ref
    worst = dict.fromkeys(("paged_decode_attention",
                           "paged_decode_attention_multi",
                           "decode_attention", "probe_update"), 0.0)
    seed = 0
    for arch, (H, KH, hd) in PAGED_SHAPES.items():
        for dtype in ("float32", "bfloat16"):
            for T, cap in ((1, 0.0), (1, 50.0), (8, 0.0), (8, 50.0),
                           (256, 0.0)):
                seed += 1
                case = paged_case(torch, B=16, T=T, H=H, KH=KH, hd=hd, ps=16,
                                  pmax=64, dtype=dtype, seed=seed,
                                  inactive=(3, 11))
                args = [case[n] for n in PAGED_ARGS]
                if T == 1:
                    name = "paged_decode_attention"
                    args[0], args[5] = args[0][:, 0].contiguous(), \
                        args[5][:, 0].contiguous()
                    got = paged.paged_decode_attention(*args, softcap=cap)
                    want = ref.paged_decode_attention_ref(*args, softcap=cap)
                    mag = None
                else:
                    name = "paged_decode_attention_multi"
                    got, want, mag = check_multi(paged, ref, args, cap)
                torch.cuda.synchronize()
                err = compare(name, f"{arch:13s} {dtype:8s} T={T:3d} "
                              f"softcap={cap:4.0f}", got, want, dtype, mag)
                if float(got[[3, 11]].float().abs().max()) != 0.0:
                    fail(f"{name}: inactive rows are not zero")
                if dtype == "bfloat16" and arch == "granite-3-8b":
                    worst[name] = max(worst[name], err)
    # the multi-query kernel at pages of 8, and in a prefill batch whose
    # row tiles are all inactive but two sequences' (the serve's chunks)
    for arch, T, ps, pmax, inactive in (
            ("granite-3-8b", 64, 8, 128, (3, 11)),
            ("gemma2-9b", 32, 8, 96, (3, 11)),
            ("granite-3-8b", 256, 16, 64,
             tuple(b for b in range(16) if b not in (0, 9))),
            ("trail-llama", 256, 16, 64,
             tuple(b for b in range(16) if b not in (5, 6)))):
        H, KH, hd = PAGED_SHAPES[arch]
        for dtype in ("float32", "bfloat16"):
            seed += 1
            case = paged_case(torch, B=16, T=T, H=H, KH=KH, hd=hd, ps=ps,
                              pmax=pmax, dtype=dtype, seed=seed,
                              inactive=inactive)
            args = [case[n] for n in PAGED_ARGS]
            got, want, mag = check_multi(paged, ref, args, 50.0)
            torch.cuda.synchronize()
            compare("paged_decode_attention_multi",
                    f"{arch:13s} {dtype:8s} T={T:3d} ps={ps} "
                    f"{16 - len(inactive):2d}/16 sequences active",
                    got, want, dtype, mag)
            if float(got[list(inactive)].float().abs().max()) != 0.0:
                fail("paged_decode_attention_multi: inactive rows are not "
                     "zero")
    for arch, H, KH, hd, M, window, cap in SLOT_CASES:
        for dtype in ("float32", "bfloat16"):
            seed += 1
            case = slot_case(torch, B=16, H=H, KH=KH, hd=hd, M=M,
                             window=window, dtype=dtype, seed=seed,
                             inactive=(3, 11))
            args = [case[n] for n in SLOT_ARGS]
            got = dec.decode_attention(*args, window=window, softcap=cap)
            want = ref.decode_attention_ref(*args, window=window,
                                            softcap=cap)
            torch.cuda.synchronize()
            wrapped = int((case["q_pos"] >= M).sum())
            err = compare("decode_attention",
                          f"{arch:17s} {dtype:8s} M={M} window={window} "
                          f"softcap={cap:2.0f} ({wrapped} rows wrapped)",
                          got, want, dtype)
            if float(got[[3, 11]].float().abs().max()) != 0.0:
                fail("decode_attention: inactive rows are not zero")
            if window and not wrapped:
                fail("decode_attention: no ring row wrapped")
            if dtype == "bfloat16" and arch.startswith("gemma2"):
                worst["decode_attention"] = max(worst["decode_attention"], err)
    for label, B, d, hid, k, tap_dtype, fallback in PROBE_CASES:
        seed += 1
        case = probe_case(torch, B=B, d=d, hid=hid, k=k, tap_dtype=tap_dtype,
                          seed=seed, fallback=fallback)
        got = probe.probe_update(*case.values())
        want = ref.probe_update_ref(*case.values())
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        prior = case["q_prev"][0] @ case["T"].T
        fell_back = bool(torch.allclose(got[0][0], prior, atol=PROBE_TOL))
        pl = probe.plan(B, d, hid, k, probe.active_clusters(0))
        log(f"[check] {'probe_update':30s} {label:12s} B={B:2d} d={d:5d} "
            f"hid={hid:3d} k={k:2d} tap {tap_dtype:8s} ({pl.clusters} "
            f"clusters of {pl.cluster} for {pl.col_blocks} column blocks, "
            f"{pl.npass} x {pl.dslice} rows a CTA): max|kernel-plain| q_new {errs[0]:.3e}, p "
            f"{errs[1]:.3e} (tol {PROBE_TOL:.0e}); row 0 fell back to its "
            f"prior: {fell_back}")
        if max(errs) > PROBE_TOL or (fallback and not fell_back):
            fail(f"probe_update disagrees with its plain version: {errs}, "
                 f"fallback {fell_back}")
        if (label, B, tap_dtype) == ("gemma2-9b", 16, "bfloat16"):
            worst["probe_update"] = max(errs)
    check_probe_repeats(torch, probe)
    return worst


def check_probe_repeats(torch, probe):
    """Two calls on the same inputs agree bit for bit, and calls in flight
    on two streams at once (four on each, alternating) equal one call."""
    args = list(probe_case(torch, B=16, d=3584, hid=512, k=10,
                           tap_dtype="bfloat16", seed=77).values())
    one = probe.probe_update(*args)
    two = probe.probe_update(*args)
    main = torch.cuda.current_stream()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = []
    for s in streams:
        s.wait_stream(main)
    for _ in range(4):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(probe.probe_update(*args))
    torch.cuda.synchronize()
    same = [all(torch.equal(a, b) for a, b in zip(one, out))
            for out in (two, *outs)]
    log(f"[check] {'probe_update':30s} gemma2-9b B=16 bf16 tap: a second "
        f"call bit-equal: {same[0]}; 8 calls on two streams equal to one "
        f"call: {sum(same[1:])}/8")
    if not all(same):
        fail("probe_update: repeated or concurrent calls disagree")


def decode_split(kernel, dtype, **shape):
    """The CTAs per (KV head, sequence) row that ``kernel``
    (``decode_attention`` or ``paged_decode_attention``) launches for these
    sizes: its C library's ``<kernel>_split`` entry, which sizes the
    cluster exactly as the launch does. Fails on a CUDA error."""
    import ctypes
    from repro_torch.kernels import build
    names = (("B", "H", "KH", "hd", "M") if kernel == "decode_attention"
             else ("B", "H", "KH", "hd", "ps", "pmax"))
    entry = f"{kernel}_split"
    lib = build.bind(kernel, {entry: [ctypes.c_int] * (1 + len(names))})
    n = getattr(lib, entry)(1 if dtype == "bfloat16" else 0,
                            *(shape[k] for k in names))
    if n < 1:
        fail(f"{entry}: CUDA error {-n}")
    return n


# Edges of the split over a cluster: (label, arch, B, ps, pmax, lengths,
# window, softcap, inactive rows). "edges" = rows of 1 and ps - 1 tokens,
# one scan tile (32) and one more token, one round of tiles over the split
# (32 * nsplit) and either side of it, then full rows (the last
# inactive). A row of at most 32 tokens, or a window of 16, puts every
# valid key in one CTA's tiles.
PAGED_EDGES = [
    ("B=1 full table", "granite-3-8b", 1, 16, 64, [1024], 0, 0.0, ()),
    ("B=1 hd 256", "gemma2-9b", 1, 16, 64, [1000], 0, 50.0, ()),
    ("edges", "granite-3-8b", 9, 16, 64, "edges", 0, 0.0, (8,)),
    ("edges ps=8", "trail-llama", 9, 8, 96, "edges", 0, 0.0, (8,)),
    ("pmax=256", "granite-3-8b", 4, 16, 256, [4096, 4095, 3001, 17], 0, 0.0,
     ()),
    ("window 200, edge inside a tile", "gemma2-9b", 4, 16, 64,
     [1000, 700, 333, 90], 200, 50.0, ()),
    ("window 16, keys in one CTA", "granite-3-8b", 4, 16, 64,
     [1000, 700, 40, 3], 16, 0.0, (3,)),
]

# The same for the slot cache: (label, H, KH, hd, M, window, softcap, B,
# lengths, inactive rows).
SLOT_EDGES = [
    ("B=1 gemma2-9b ring, full", 16, 8, 256, 4097, 4096, 50.0, 1, [6000],
     ()),
    ("B=1 gemma2-9b global", 16, 8, 256, 4609, 0, 50.0, 1, [4000], ()),
    ("B=1 gemma3-1b ring", 4, 1, 256, 512, 512, 0.0, 1, [700], ()),
    ("gemma2-9b global edges", 16, 8, 256, 4609, 0, 50.0, 9, "edges", (8,)),
    ("hymba-1.5b ring-300", 25, 5, 64, 1025, 1024, 0.0, 16,
     [300] * 13 + [20, 1500, 2000], (3,)),
    ("ring, keys in one CTA", 25, 5, 64, 1025, 1024, 0.0, 4, [20, 1, 32, 33],
     ()),
    ("ring window 1000, edge inside a tile", 16, 8, 256, 1025, 1000, 50.0, 4,
     [3000, 1030, 1011, 500], ()),
]


def edge_lengths(nsplit, ps, B, full):
    """Row lengths at the edges of a split of ``nsplit`` CTAs, then full
    rows up to B."""
    edges = [1, ps - 1, 32, 33, 32 * nsplit - 1, 32 * nsplit,
             32 * nsplit + 1]
    return [min(n, full) for n in edges + [full] * B][:B]


def phase_check_split(torch):
    """``decode_attention`` and ``paged_decode_attention`` at the edges of
    their split over a thread-block cluster, float32 (1e-5) and bfloat16
    (one rounding), inactive rows exactly 0. B=1 takes the largest split;
    each case logs the split its launch used."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import paged_decode_attention as paged
    from repro_torch.kernels import ref
    seed = 700
    largest = 0
    for label, arch, B, ps, pmax, lengths, window, cap, inactive in \
            PAGED_EDGES:
        H, KH, hd = PAGED_SHAPES[arch]
        for dtype in ("float32", "bfloat16"):
            seed += 1
            ns = decode_split("paged_decode_attention", dtype, B=B, H=H,
                              KH=KH, hd=hd, ps=ps, pmax=pmax)
            largest = max(largest, ns)
            lens = (edge_lengths(ns, ps, B, pmax * ps) if lengths == "edges"
                    else lengths)
            case = paged_case(torch, B=B, T=1, H=H, KH=KH, hd=hd, ps=ps,
                              pmax=pmax, dtype=dtype, seed=seed,
                              inactive=inactive, lengths=lens)
            args = [case[n] for n in PAGED_ARGS]
            args[0], args[5] = args[0][:, 0].contiguous(), \
                args[5][:, 0].contiguous()
            got = paged.paged_decode_attention(*args, window=window,
                                               softcap=cap)
            want = ref.paged_decode_attention_ref(*args, window=window,
                                                  softcap=cap)
            torch.cuda.synchronize()
            compare("paged_decode_attention",
                    f"{label:30s} {arch} {dtype:8s} B={B} split={ns} "
                    f"lengths={list(lens)[:8]}", got, want, dtype)
            if inactive and float(got[list(inactive)].float().abs().max()):
                fail("paged_decode_attention: inactive rows are not zero")
    for label, H, KH, hd, M, window, cap, B, lengths, inactive in SLOT_EDGES:
        for dtype in ("float32", "bfloat16"):
            seed += 1
            ns = decode_split("decode_attention", dtype, B=B, H=H, KH=KH,
                              hd=hd, M=M)
            largest = max(largest, ns)
            lens = (edge_lengths(ns, 16, B, M) if lengths == "edges"
                    else lengths)
            case = slot_case(torch, B=B, H=H, KH=KH, hd=hd, M=M,
                             window=window, dtype=dtype, seed=seed,
                             inactive=inactive, lengths=lens)
            args = [case[n] for n in SLOT_ARGS]
            got = dec.decode_attention(*args, window=window, softcap=cap)
            want = ref.decode_attention_ref(*args, window=window,
                                            softcap=cap)
            torch.cuda.synchronize()
            compare("decode_attention",
                    f"{label:30s} {dtype:8s} B={B} split={ns} "
                    f"lengths={list(lens)[:8]}", got, want, dtype)
            if inactive and float(got[list(inactive)].float().abs().max()):
                fail("decode_attention: inactive rows are not zero")
    log(f"[check] the largest split launched: {largest} CTAs per cluster")
    if largest < 2:
        fail("no case split a row over a cluster")


# The single-query decode rows of phase 4 (bf16, B=16): (label, kind,
# spec). Paged specs are (arch, pmax, serve): full 16-token pages, or the
# granite serve's tables of 28 pages holding about 300 tokens a row. Slot
# specs are (H, KH, hd, M, window, softcap, row length): a gemma2-9b local
# layer's full, wrapped ring; a global layer's 4609-slot row (4608 + the
# sink) holding 300-token contexts, as in the serve phase; and the local
# rings of the gemma2-9b and hymba-1.5b serves, 300 positions in each.
DECODE_TIMED = [
    ("paged_decode_attention[granite-3-8b,T=1]", "paged",
     ("granite-3-8b", 64, False)),
    ("paged_decode_attention[gemma2-9b,T=1]", "paged",
     ("gemma2-9b", 64, False)),
    ("paged_decode_attention[granite-3-8b,serve]", "paged",
     ("granite-3-8b", 28, True)),
    ("decode_attention[gemma2-9b,ring]", "slot",
     (16, 8, 256, 4097, 4096, 50.0, 6000)),
    ("decode_attention[gemma2-9b,global]", "slot",
     (16, 8, 256, 4609, 0, 50.0, 300)),
    ("decode_attention[gemma2-9b,ring-300]", "slot",
     (16, 8, 256, 4097, 4096, 50.0, 300)),
    ("decode_attention[hymba-1.5b,ring-300]", "slot",
     (25, 5, 64, 1025, 1024, 0.0, 300)),
]


def decode_timed_case(torch, kind, spec, with_split=True):
    """Inputs of a DECODE_TIMED row: (wrapper arguments, window, softcap,
    shape text, library call, bound); the text names the split the launch
    uses (``with_split``)."""
    import numpy as np
    if kind == "paged":
        arch, pmax, serve = spec
        H, KH, hd = PAGED_SHAPES[arch]
        lengths = (np.random.default_rng(5).integers(280, 321, size=16)
                   if serve else None)
        case = paged_case(torch, B=16, T=1, H=H, KH=KH, hd=hd, ps=16,
                          pmax=pmax, dtype="bfloat16", seed=101,
                          all_active=not serve, lengths=lengths)
        args = [case[n] for n in PAGED_ARGS]
        args[0], args[5] = args[0][:, 0].contiguous(), \
            args[5][:, 0].contiguous()
        shape = f"B=16 H={H} KH={KH} hd={hd} ps=16 pmax={pmax} bf16"
        if serve:
            shape += f" lengths {lengths.min()}-{lengths.max()}"
        if with_split:
            shape += " split=%d" % decode_split(
                "paged_decode_attention", "bfloat16", B=16, H=H, KH=KH,
                hd=hd, ps=16, pmax=pmax)
        return (args, 0, 0.0, shape, paged_library_call(torch, case),
                paged_bound(case, "bfloat16"))
    H, KH, hd, M, window, cap, length = spec
    case = slot_case(torch, B=16, H=H, KH=KH, hd=hd, M=M, window=window,
                     dtype="bfloat16", seed=7, lengths=[length] * 16)
    shape = (f"B=16 H={H} KH={KH} hd={hd} M={M} window={window} "
             f"softcap={cap:2.0f} bf16, {length} positions a row")
    if with_split:
        shape += " split=%d" % decode_split(
            "decode_attention", "bfloat16", B=16, H=H, KH=KH, hd=hd, M=M)
    return ([case[n] for n in SLOT_ARGS], window, cap, shape,
            slot_library_call(case, window),
            slot_bound(case, window, "bfloat16"))


def build_entries(dirs, sig):
    """Build ``<name>.cu`` for each name of ``sig`` from each kernel source
    directory (``build_libraries``) and return, per directory, each
    name's ``<name>_launch`` entry with the C argument types ``sig``
    gives."""
    return [{name: c_entry(libs[name], f"{name}_launch", argtypes)
             for name, argtypes in sig.items()}
            for libs in build_libraries(dirs, sig)]


def c_entry(lib, entry, argtypes):
    """``entry`` of a ctypes library, declared with ``argtypes`` and an int
    result (a CUDA error code)."""
    import ctypes
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def build_libraries(dirs, names, flags=(), into="compare"):
    """Build ``<name>.cu`` for each of ``names`` from each kernel source
    directory (one ``nvcc`` each, all at once, with the package's flags
    and ``flags``, into ``build/<into>/<i>``) and return, per directory,
    each name's loaded library."""
    import ctypes
    from repro_torch.kernels import build
    outs = [build.BUILD_DIR.parent / into / str(i)
            for i in range(len(dirs))]
    jobs = []
    for d, out in zip(dirs, outs):
        out.mkdir(parents=True, exist_ok=True)
        for name in names:
            cmd = [build.nvcc(), *build.NVCC_FLAGS, *flags, "-o",
                   str(out / f"{name}.so"), str(Path(d) / f"{name}.cu")]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for cmd, proc in jobs:
        report, _ = proc.communicate()
        if proc.returncode:
            fail(f"{' '.join(cmd)} failed:\n{report}")
        for kernel, usage in ptxas_usage(report):
            log(f"[build] {cmd[-1]}: {kernel}: {usage}")
    return [{name: ctypes.CDLL(str(out / f"{name}.so")) for name in names}
            for out in outs]


def compare_decode(torch, dirs):
    """``--compare-decode DIR ...``: build ``decode_attention.cu`` and
    ``paged_decode_attention.cu`` from each kernel source directory DIR
    (``src/repro_torch/kernels/csrc`` of this checkout or of another one,
    say the parent commit's from ``git archive``; their C entries are the
    same) and time their single-query entries at the DECODE_TIMED shapes
    in turns (first to last, then last to first), each as a CUDA graph of
    30 calls, beside the library call. Each build's result is first held
    against the plain version."""
    import ctypes
    from repro_torch.kernels import ref
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entries = build_entries(dirs, {
        "decode_attention": [ptr] * 6 + [i32] * 6 + [f32, i32, f32, ptr],
        "paged_decode_attention":
            [ptr] * 7 + [i32] * 7 + [f32, i32, f32, ptr]})
    for label, kind, spec in DECODE_TIMED:
        args, window, cap, shape, lib, (b_ms, by) = decode_timed_case(
            torch, kind, spec, with_split=False)
        q = args[0]
        B, H, hd = q.shape
        out = torch.empty_like(q)
        name = "paged_decode_attention" if kind == "paged" else \
            "decode_attention"
        if kind == "paged":
            ps, KH = args[1].shape[1], args[1].shape[2]
            sizes = (B, H, KH, hd, ps, args[4].shape[1])
            want = ref.paged_decode_attention_ref(*args)
        else:
            sizes = (B, H, args[1].shape[2], hd, args[1].shape[1])
            want = ref.decode_attention_ref(*args, window=window,
                                            softcap=cap)
        fns = []
        for d, entry in zip(dirs, entries):
            def launch(fn=entry[name]):
                err = fn(*(a.data_ptr() for a in args), out.data_ptr(), 1,
                         *sizes, hd ** -0.5, window, cap,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    fail(f"{label} ({d}): CUDA error {err}")
            launch()
            torch.cuda.synchronize()
            compare(name, f"{label} ({d})", out, want, "bfloat16")
            fns.append(launch)
        times = [[] for _ in fns]
        for i in [*range(len(fns)), *reversed(range(len(fns)))]:
            times[i].append(time_graph_ms(torch, fns[i]))
        lib_ms = time_graph_ms(torch, lib, iters=10)
        log(f"[compare] {label} {shape}: " + "; ".join(
            f"{d}: {min(t):.4f} ms ({100 * b_ms / min(t):.1f}% of bound)"
            for d, t in zip(dirs, times))
            + f"; library {lib_ms:.4f} ms; bound {b_ms:.4f} ms ({by})")


def ssd_timed_case(torch, spec):
    """Inputs (bf16) and shape text of an SSD_TIMED row."""
    B, L, nh, N, carried = spec
    case = ssd_case(torch, B=B, L=L, nh=nh, hp=64, N=N, dtype="bfloat16",
                    seed=12, decay=0.05)
    if not carried:
        del case["init_state"]
    return case, (f"B={B} L={L} nh={nh} hp=64 N={N} chunk=128 bf16, "
                  + ("initial state" if carried else "zero initial state"))


def compare_ssd_builds(torch, dirs):
    """``--compare-ssd DIR ...``: build ``ssd_scan.cu`` from each kernel
    source directory DIR (this checkout's or, say, the parent commit's
    from ``git archive``; the C entry is the same) and time it at the
    SSD_TIMED shapes in turns (first to last, then last to first), each
    build first held against the plain version (``ssd_tc_bound``)."""
    import ctypes
    from repro_torch.kernels import ref
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    entries = build_entries(dirs, {"ssd_scan": [ptr] * 8 + [i32] * 7 + [ptr]})
    for label, spec in SSD_TIMED.items():
        case, shape = ssd_timed_case(torch, spec)
        x = case["x"]
        B, L, nh, hp = x.shape
        N = case["Bm"].shape[-1]
        y = torch.empty((B, L, nh, hp), dtype=torch.float32, device="cuda")
        s_fin = torch.empty((B, nh, hp, N), dtype=torch.float32,
                            device="cuda")
        s0 = case.get("init_state")
        want = ref.ssd_scan_ref(**case, chunk=128)
        bounds = ssd_tc_bound(*want, *ssd_magnitudes(ref, case, 128))
        fns = []
        for d, entry in zip(dirs, entries):
            def launch(fn=entry["ssd_scan"], d=d):
                err = fn(*(case[k].data_ptr() for k in
                           ("x", "dt", "A", "Bm", "Cm")),
                         None if s0 is None else s0.data_ptr(),
                         y.data_ptr(), s_fin.data_ptr(), 1, B, L, nh, hp, N,
                         128, torch.cuda.current_stream().cuda_stream)
                if err:
                    fail(f"{label} ({d}): CUDA error {err}")
            launch()
            torch.cuda.synchronize()
            compare_ssd(f"{label} ({d})", (y, s_fin), want, bounds=bounds)
            fns.append(launch)
        times = [[] for _ in fns]
        for i in [*range(len(fns)), *reversed(range(len(fns)))]:
            times[i].append(time_ms(torch, fns[i]))
        b_ms, by = ssd_bound(case, 128, "bfloat16")
        log(f"[compare] {label} {shape}: " + "; ".join(
            f"{d}: {min(t):.4f} ms ({100 * b_ms / min(t):.1f}% of bound)"
            for d, t in zip(dirs, times))
            + f"; bound {b_ms:.4f} ms ({by})")
        del case, y, s_fin, want, bounds


PROBE_TIMED = {"probe_update[gemma2-9b]": 16,  # label: rows (d 3584)
               "probe_update[gemma2-9b,B=1]": 1}


def probe_floor(torch, probe):
    """The floor under a timed ``probe_update`` call (gemma2-9b width, 16
    rows), timed as the calls are (L2 flushed): an empty kernel launched
    as the call is (cooperative, on its grid, clusters and shared
    memory)."""
    import ctypes
    from repro_torch.kernels import build
    active = probe.active_clusters(0)
    pl = probe.plan(16, 3584, 512, 10, active)
    floor = c_entry(build.load("probe"), "probe_floor_launch",
                    [ctypes.c_int] * 3 + [ctypes.c_void_p])

    def launch():
        err = floor(pl.cluster, pl.clusters, pl.smem,
                    torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"probe_floor_launch: CUDA error {err}")
    ms = time_cold_ms(torch, launch)
    log(f"[time] {'probe_update launch floor':40s} {pl.cluster} x "
        f"{pl.clusters} CTAs in clusters of {pl.cluster}, {pl.smem} B of "
        f"shared memory each, L2 flushed: an empty cooperative kernel "
        f"{ms:.4f} ms; clusters of 1-8 CTAs the card holds at once at one "
        f"CTA an SM: {active}")
    return ms


def parent_split_d(B: int, d: int, hid: int) -> tuple[int, int]:
    """(nsplit, dslice) of the two-kernel ``probe.cu`` (commit 6bb40c9 and
    before), a copy of its wrapper's ``split_d``: how its first pass cut
    d, which sizes its scratch of nsplit x B x hid floats."""
    tiles = -(-hid // 32) * -(-B // 16)
    nsplit = max(-(-d // 256), min(-(-d // 64), -(-2 * 132 // tiles)))
    dslice = -(-d // nsplit)
    return -(-d // dslice), dslice


def compare_probe_builds(torch, dirs):
    """``--compare-probe DIR ...``: build ``probe.cu`` from each kernel
    source directory DIR (this checkout's, or the parent commit's from
    ``git archive``: a source with ``probe_hidden_kernel`` is the
    two-kernel version of 6bb40c9 and before, whose C entry takes
    ``parent_split_d``'s cut and its scratch) and time it at the
    PROBE_TIMED shapes in turns (first to last, then last to first) with
    L2 flushed before each call, each build first held to PROBE_TOL
    against the plain version; a build of this checkout's kind with row
    tiles of 4 at B=1 is also timed with row tiles of 16. Then the
    launch floor and the phases of this checkout's kernel
    (``probe_phases``)."""
    import ctypes
    from repro_torch.kernels import probe, ref
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build_libraries(dirs, ["probe"])
    d, hid, k = 3584, 512, 10
    for label, B in PROBE_TIMED.items():
        case = probe_case(torch, B=B, d=d, hid=hid, k=k,
                          tap_dtype="bfloat16", seed=9)
        args = list(case.values())
        want = ref.probe_update_ref(*args)
        pl = probe.plan(B, d, hid, k, probe.active_clusters(0))
        builds = []
        for src, lib in zip(dirs, libs):
            text = (Path(src) / "probe.cu").read_text()
            if "probe_hidden_kernel" in text:
                cut = parent_split_d(B, d, hid)
                builds.append((src, lib, cut, cut[0] * B * hid))
                continue
            cut = (pl.row_tile, pl.cluster, pl.clusters, pl.dslice, pl.npass)
            builds.append((src, lib, cut, pl.scratch))
            if pl.row_tile != 16:
                builds.append((f"{src} (row tiles of 16)", lib,
                               (16,) + cut[1:], pl.scratch))
        fns = []
        for src, lib, cut, size in builds:
            q_new = torch.empty((B, k), dtype=torch.float32, device="cuda")
            p = torch.empty_like(q_new)
            scratch = torch.empty(size, device="cuda")
            fn = c_entry(lib["probe"], "probe_update_launch",
                         [ptr] * 10 + [i32] * (5 + len(cut)) + [ptr])

            def launch(fn=fn, q_new=q_new, p=p, scratch=scratch, cut=cut,
                       src=src):
                err = fn(*(a.data_ptr() for a in args), q_new.data_ptr(),
                         p.data_ptr(), scratch.data_ptr(), 1, B, d, hid, k,
                         *cut, torch.cuda.current_stream().cuda_stream)
                if err:
                    fail(f"{label} ({src}): CUDA error {err}")
                return q_new, p
            got = launch()
            torch.cuda.synchronize()
            errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
            log(f"[check] {label} ({src}): max|kernel-plain| q_new "
                f"{errs[0]:.3e}, p {errs[1]:.3e} (tol {PROBE_TOL:.0e})")
            if max(errs) > PROBE_TOL:
                fail(f"{label} ({src}) disagrees with its plain version")
            fns.append(launch)
        times = [[] for _ in fns]
        for i in [*range(len(fns)), *reversed(range(len(fns)))]:
            times[i].append(time_cold_ms(torch, fns[i]))
        b_ms, by = probe_bound(case)
        log(f"[compare] {label} B={B} d={d} hid={hid} k={k} bf16 tap, L2 "
            "flushed: " + "; ".join(
                f"{b[0]}: {min(t):.4f} ms ({100 * b_ms / min(t):.1f}% of "
                f"bound)" for b, t in zip(builds, times))
            + f"; bound {b_ms:.4f} ms ({by})")
    probe_floor(torch, probe)
    probe_phases(torch, probe)


PROBE_PHASES = ("start", "requests issued", "tap staged", "w1 multiplied",
                "cluster barrier", "partial logits", "grid barrier",
                "filtered")


def probe_phases(torch, probe, calls=20):
    """Where a ``probe_update`` call's time goes: this checkout's
    ``probe.cu`` built with ``-DPROBE_STAMPS`` (every CTA stamps the
    global timer at each phase) at the PROBE_TIMED shapes, ``calls``
    calls after one warm-up, L2 flushed before each. Per phase: the median
    over CTAs of its stamp less the call's first start ("filtered": the
    latest, when the call's last row is done), then the median over
    calls, in microseconds. The launch comes before the first stamp."""
    import ctypes
    import numpy as np
    from repro_torch.kernels import build, ref
    lib = build_libraries([build.CSRC], ["probe"], ("-DPROBE_STAMPS",),
                          "stamps")[0]["probe"]
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    launch = c_entry(lib, "probe_update_launch", [ptr] * 10 + [i32] * 10
                     + [ptr])
    take = c_entry(lib, "probe_take_stamps", [ptr, i32])
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    d, hid, k = 3584, 512, 10
    for label, B in PROBE_TIMED.items():
        args = list(probe_case(torch, B=B, d=d, hid=hid, k=k,
                               tap_dtype="bfloat16", seed=9).values())
        pl = probe.plan(B, d, hid, k, probe.active_clusters(0))
        out = [torch.empty(n, device="cuda") for n in (B * k, B * k,
                                                       pl.scratch)]
        ctas = pl.cluster * pl.clusters
        host = (ctypes.c_ulonglong * (ctas * len(PROBE_PHASES)))()
        runs = []
        for i in range(calls + 1):
            flush.zero_()
            err = launch(*(a.data_ptr() for a in args),
                         *(t.data_ptr() for t in out), 1, B, d, hid, k,
                         pl.row_tile, pl.cluster, pl.clusters, pl.dslice,
                         pl.npass, torch.cuda.current_stream().cuda_stream)
            err = err or take(host, len(host))
            if err:
                fail(f"{label} (stamped build): CUDA error {err}")
            st = np.array(host, dtype=np.int64).reshape(ctas, -1)
            if i:
                t = (st - st[:, :1].min()) / 1e3
                runs.append([np.median(t[:, j]) for j in range(len(t[0]) - 1)]
                            + [t[:, -1].max()])
        want = ref.probe_update_ref(*args)
        errs = [float((a.view(B, k) - b).abs().max())
                for a, b in zip(out, want)]
        if max(errs) > PROBE_TOL:
            fail(f"{label} (stamped build) disagrees with its plain version")
        log(f"[phases] {label} B={B} bf16 tap, L2 flushed, {ctas} CTAs, "
            f"median of {calls} calls, us from the first CTA's start: "
            + "; ".join(f"{n} {m:.2f}" for n, m in
                        zip(PROBE_PHASES, np.median(runs, axis=0))))


def phase_time(torch):
    """Time each kernel at its path's shapes (bfloat16) beside its plain
    version, its bound and its library yardstick."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import paged_decode_attention as paged
    from repro_torch.kernels import probe, ref
    rows = {}

    def row(label, shape, kfn, pfn, lib, bound, plain_iters=20,
            timer=time_ms, plain_timer=None):
        plain_ms = (plain_timer or timer)(torch, pfn, iters=plain_iters)
        ms = timer(torch, kfn)
        library_ms = timer(torch, lib, iters=10) if lib else None
        ms2 = timer(torch, kfn)             # kernel, plain, ..., kernel
        b_ms, by = bound
        lib_s = (f"{library_ms:.4f} ms (kernel/library "
                 f"{min(ms, ms2) / library_ms:.2f})" if lib else "none")
        log(f"[time] {label:40s} {shape}: kernel {ms:.4f} / {ms2:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library {lib_s}, bound {b_ms:.4f} ms "
            f"({by}), {100 * b_ms / min(ms, ms2):.1f}% of bound")
        rows[label] = dict(ms=min(ms, ms2), plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=b_ms, bound_by=by)

    for label, kind, spec in DECODE_TIMED:
        args, window, cap, shape, lib, bound = decode_timed_case(torch, kind,
                                                                 spec)
        if kind == "paged":
            kfn = lambda: paged.paged_decode_attention(*args)  # noqa: E731
            pfn = lambda: ref.paged_decode_attention_ref(*args)  # noqa: E731
        else:
            kfn = lambda: dec.decode_attention(  # noqa: E731
                *args, window=window, softcap=cap)
            pfn = lambda: ref.decode_attention_ref(  # noqa: E731
                *args, window=window, softcap=cap)
        row(label, shape, kfn, pfn, lib, bound, timer=time_graph_ms,
            plain_timer=time_ms)

    for arch, T in (("granite-3-8b", 8), ("granite-3-8b", 256),
                    ("gemma2-9b", 8)):
        H, KH, hd = PAGED_SHAPES[arch]
        case = paged_case(torch, B=16, T=T, H=H, KH=KH, hd=hd, ps=16,
                          pmax=64, dtype="bfloat16", seed=100 + T,
                          all_active=True)
        args = [case[n] for n in PAGED_ARGS]
        row(f"paged_decode_attention_multi[{arch},T={T}]",
            f"B=16 H={H} KH={KH} hd={hd} ps=16 pmax=64 bf16",
            lambda: paged.paged_decode_attention_multi(*args),
            lambda: ref.paged_decode_attention_multi_ref(*args),
            paged_library_call(torch, case), paged_bound(case, "bfloat16"),
            plain_iters=5 if T == 256 else 20)

    from repro_torch.kernels import flash_attention as fa
    for arch, (B, S, H, KH, hd, window, cap) in FLASH_TIMED.items():
        q, k, v = flash_case(torch, B=B, S=S, H=H, KH=KH, hd=hd,
                             dtype="bfloat16", seed=11)
        row(f"flash_attention[{arch}]", f"B={B} S={S} H={H} KH={KH} "
            f"hd={hd} window={window} softcap={cap:2.0f} causal bf16",
            lambda: fa.flash_attention(q, k, v, window=window, softcap=cap),
            lambda: ref.flash_attention_ref(q, k, v, window=window,
                                            softcap=cap),
            flash_library_call(q, k, v), flash_bound(q, k, window,
                                                     "bfloat16"),
            plain_iters=3 if S > 1024 else 10)
        del q, k, v

    for label, B in PROBE_TIMED.items():
        case = probe_case(torch, B=B, d=3584, hid=512, k=10,
                          tap_dtype="bfloat16", seed=9)
        args = list(case.values())
        row(label, f"B={B} d=3584 hid=512 k=10 bf16 tap, L2 flushed",
            lambda: probe.probe_update(*args),
            lambda: ref.probe_update_ref(*args), None, probe_bound(case),
            timer=time_cold_ms)
    probe_floor(torch, probe)

    # ssd_scan: one prefill chunk of a full slot batch from a carried
    # state, and one tap-harvest forward (8 x 512) from zeros
    from repro_torch.kernels import ssd_scan as ssd
    for label, spec in SSD_TIMED.items():
        case, shape = ssd_timed_case(torch, spec)
        row(label, shape, lambda: ssd.ssd_scan(**case, chunk=128),
            lambda: ref.ssd_scan_ref(**case, chunk=128), None,
            ssd_bound(case, 128, "bfloat16"), plain_iters=5)
        del case
    return rows


def _model_pair(arch, seed):
    """The float32 smoke model on the card and the same weights on the CPU."""
    from repro_torch.config import get_smoke_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    gpu = Model(cfg, device="cuda").init(seed=seed)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    return cfg, gpu, cpu


def phase_reference(torch):
    """Smoke configs in float32: the model on the card (kernels) against
    the same weights on the CPU (plain versions). gemma2-smoke's and
    hymba-smoke's window is 16: the prompts (24 tokens, then 20 more) wrap
    the rings in a chunk. Row 1 of the first chunk is padded and row 3
    sits out the megastep, so the SSM configs also check that padding and
    inactive rows leave the recurrent state alone on both devices."""
    for arch, layout in (("granite-3-8b", "paged"), ("gemma2-9b", "contig"),
                         ("gemma2-9b", "paged"), ("mamba2-370m", "contig"),
                         ("mamba2-370m", "paged"), ("hymba-1.5b", "contig"),
                         ("hymba-1.5b", "paged")):
        cfg, gpu, cpu = _model_pair(arch, seed=7)
        g = torch.Generator().manual_seed(7)
        chunks = [torch.randint(1, cfg.vocab_size, (4, w), generator=g,
                                dtype=torch.int32) for w in (24, 20)]
        pages = torch.randperm(16, generator=g, dtype=torch.int32) + 1
        valid = torch.ones((4, 24), dtype=torch.bool)
        valid[1, 20:] = False
        budget = torch.tensor([6, 3, 6, 0], dtype=torch.int32)
        out = {}
        for dev, m in (("cuda", gpu), ("cpu", cpu)):
            cache = m.init_cache(4, 64, kv_layout=layout, page_size=16)
            if layout == "paged":       # scrambled pages, 4 per row
                cache["block_table"].copy_(pages.reshape(4, 4))
            logits, cache, tap_sum, _ = m.prefill_chunk(
                cache, chunks[0].to(dev), valid.to(dev))
            logits, cache, _, _ = m.prefill_chunk(cache, chunks[1].to(dev))
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            toks, cache, probs, n = m.decode_multi(
                cache, tok, budget=budget.to(dev), k=6)
            out[dev] = [x.cpu() for x in (logits, tap_sum, toks, probs, n)]
        torch.cuda.synchronize()
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(out["cuda"], out["cpu"])]
        log(f"[reference] {cfg.name} f32 {layout}, card vs CPU: logits "
            f"{errs[0]:.2e}, tap_sum {errs[1]:.2e}, probe probs "
            f"{errs[3]:.2e}, tokens equal "
            f"{bool(torch.equal(out['cuda'][2], out['cpu'][2]))}, n_emitted "
            f"{out['cuda'][4].tolist()}")
        if not (errs[0] <= 1e-4 and errs[1] <= 1e-3 and errs[3] <= 1e-4):
            fail(f"{cfg.name} on the card disagrees with the CPU: {errs}")
        if errs[2] != 0 or errs[4] != 0:
            fail(f"{cfg.name}: greedy tokens on the card differ from the CPU")


def phase_reference_train(torch):
    """The training path in float32 on the card (``flash_attention``)
    against the same weights on the CPU (its plain version):
    ``forward_train`` loss and tap, every parameter's gradient and one
    ``train_lm`` step, on trail-llama-smoke and gemma2-smoke at S=64 (the
    window of 16 binds). Tolerances: loss 1e-5 relative, tap 1e-4,
    gradients 1e-6 plus 1e-4 of the largest of their leaf (float32 sums
    taken in another order on the card), weights after the step 1e-5
    where the gradient is at least 1e-6: AdamW's first step moves a
    weight by lr * g / (|g| + 1e-8), which turns the last bits of a
    gradient near 1e-8 into a visible difference; those elements are
    counted, not compared."""
    from torch.func import functional_call
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import DataConfig, batches
    from repro_torch.training.train import train_lm
    for arch in ("trail-llama", "gemma2-9b"):
        cfg, gpu, cpu = _model_pair(arch, seed=11)
        dc = DataConfig(vocab=cfg.vocab_size, seq_len=64, batch=4,
                        prompt_mean=8, max_out=32, seed=11)
        batch = next(batches(dc, 1))
        ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=10)
        out = {}
        for dev, m in (("cuda", gpu), ("cpu", cpu)):
            masters = {k: v.detach().clone().float()
                       for k, v in gpu.state_dict().items()}
            masters = {k: v.to(dev) for k, v in masters.items()}
            live = {k: v.clone().requires_grad_() for k, v in masters.items()}
            tb = {k: torch.from_numpy(batch[k]).to(dev)
                  for k in ("tokens", "labels")}
            loss, aux = functional_call(m, live, (tb,))
            grads = torch.autograd.grad(loss, list(live.values()),
                                        allow_unused=True)
            stepped, _, hist = train_lm(m, masters, batches(dc, 1), ocfg, 1)
            out[dev] = (float(loss.detach()), aux["tap"].detach().cpu(),
                        {k: None if g is None else g.cpu()
                         for k, g in zip(live, grads)},
                        {k: v.cpu() for k, v in stepped.items()},
                        hist[0]["loss"])
        torch.cuda.synchronize()
        (gl, gt, gg, gs, gh), (cl, ct, cg, cs, ch) = out["cuda"], out["cpu"]
        tap_err = float((gt - ct).abs().max())
        grad_ok, grad_err = True, 0.0
        for a, b in zip(gg.values(), cg.values()):
            if (a is None) != (b is None):
                fail(f"{cfg.name}: a gradient exists on one device only")
            if a is not None:
                e = float((a - b).abs().max())
                grad_err = max(grad_err, e)
                grad_ok &= e <= 1e-6 + 1e-4 * float(b.abs().max())
        step_err, ill = 0.0, 0
        for k in cs:
            keep = (torch.ones_like(cs[k], dtype=torch.bool) if cg[k] is None
                    else cg[k].abs() >= 1e-6)
            ill += int((~keep).sum())
            if keep.any():
                step_err = max(step_err, float(
                    (gs[k] - cs[k]).abs()[keep].max()))
        log(f"[reference-train] {cfg.name} f32 S=64, card vs CPU: loss "
            f"{gl:.6f} vs {cl:.6f}, tap {tap_err:.2e}, gradients of "
            f"{len(gg)} parameters within {grad_err:.2e} "
            f"({sum(g is None for g in gg.values())} without one: the "
            f"probe), one train_lm step: loss {gh:.6f} vs {ch:.6f}, weights "
            f"within {step_err:.2e} ({ill} elements with |g| < 1e-6 not "
            f"compared)")
        if not (abs(gl - cl) <= 1e-5 * abs(cl) and tap_err <= 1e-4
                and grad_ok and abs(gh - ch) <= 1e-5 * abs(ch)
                and step_err <= 1e-5):
            fail(f"{cfg.name}: the training path on the card disagrees with "
                 f"the CPU")


def _requests(cfg, n, seed, long_prompts=()):
    """``n`` synthetic requests (prompts 130-375 tokens, outputs 8-64),
    plus one request per entry of ``long_prompts`` with a prompt of that
    many tokens, arriving among the others."""
    import numpy as np
    from repro_torch.serving.request import Request
    from repro_torch.serving.workload import WorkloadConfig, generate
    wc = WorkloadConfig(n_requests=n, request_rate=50.0, seed=seed,
                        vocab=cfg.vocab_size, prompt_mean=256.0,
                        prompt_sigma=0.3, out_median=32.0, out_sigma=0.5,
                        max_out=64, min_out=8)
    reqs = generate(wc)
    rng = np.random.default_rng(seed)
    for i, n_tok in enumerate(long_prompts):
        reqs.append(Request(
            rid=n + i, arrival=reqs[2 + 3 * i].arrival + 1e-3,
            prompt=rng.integers(1, cfg.vocab_size, n_tok).tolist(),
            max_new_tokens=wc.max_out,
            true_out_len=int(rng.integers(wc.min_out, wc.max_out + 1))))
    return reqs


def _max_len(reqs):
    return 16 * -(-max(len(r.prompt) + r.max_new_tokens + 1
                       for r in reqs) // 16)


def _check_requests(torch, cfg, reqs):
    """Every request finished with its tokens, in the vocabulary, and its
    probe posterior and predicted length are finite."""
    for r in reqs:
        if not r.done or len(r.generated) != min(r.true_out_len,
                                                 r.max_new_tokens):
            fail(f"rid {r.rid} did not finish with its tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            fail(f"rid {r.rid}: token out of range")
        if not (torch.isfinite(torch.as_tensor(r.posterior)).all()
                and torch.isfinite(torch.tensor(r.entry.pred_remaining))):
            fail(f"rid {r.rid}: non-finite probe posterior or prediction")


def _check_cache_finite(torch, cache):
    for key, run in cache.items():
        if key.startswith("run_"):
            for sub in run:
                for leaf in ("pk", "pv", "k", "v", "ssm_state", "conv_buf"):
                    if leaf in sub and not torch.isfinite(sub[leaf]).all():
                        fail(f"non-finite values in the cache ({key} "
                             f"{leaf})")


def _stepped_run(torch, cfg, model, reqs, knobs, pred):
    """Drive an engine by hand: the device lengths must equal each live
    request's materialized KV after every step."""
    from repro_torch.serving.engine import Engine, EngineConfig
    eng = Engine(cfg, EngineConfig(policy="trail", prefill_chunk=256,
                                   **knobs),
                 predictor=pred, model=model, device="cuda")
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        eng.pool.flush_resets()     # recycled slots' resets, as the next
        lengths = eng.pool.cache["lengths"].cpu().tolist()   # step would
        for r in reqs:
            if r.slot >= 0 and not r.done:
                written = getattr(r, "_kv_written", 0)
                if lengths[r.slot] != written:
                    fail(f"lengths != _kv_written for rid {r.rid}: "
                         f"{lengths[r.slot]} vs {written}")
    _check_requests(torch, cfg, reqs)
    _check_cache_finite(torch, eng.pool.cache)
    return steps


def _serve(torch, cfg, model, reqs, knobs, pred):
    """One ``run_policy`` over ``reqs`` with every launch count at 0 just
    before and read just after; checks that every request finished with
    finite predictions. Returns (launches, decode steps, prefill
    chunks)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import run_policy
    steps = [0, 0]
    decode_step, prefill_chunk = model.decode_step, model.prefill_chunk

    def counted(*args, **kwargs):
        steps[0] += 1
        return decode_step(*args, **kwargs)

    def counted_prefill(*args, **kwargs):
        steps[1] += 1
        return prefill_chunk(*args, **kwargs)

    # run_policy serves copies of the requests: the predictor's hooks see
    # them, with the probe's inputs and outputs, which must be finite
    served = {}

    def watch(hook):
        def watched(r, *args):
            out = hook(r, *args)
            served[r.rid] = r
            if not (math.isfinite(out) and all(
                    torch.isfinite(torch.as_tensor(a)).all() for a in args)):
                fail(f"rid {r.rid}: non-finite probe input or prediction")
            return out
        return watched

    model.decode_step, model.prefill_chunk = counted, counted_prefill
    pred.on_prefill, pred.on_token = (watch(pred.on_prefill),
                                      watch(pred.on_token))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    stats = run_policy(cfg, "trail", reqs, predictor=pred, model=model,
                       device="cuda", **knobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    del model.decode_step, model.prefill_chunk, pred.on_prefill, \
        pred.on_token
    peak = torch.cuda.max_memory_allocated()
    out_tokens = sum(r.true_out_len for r in reqs)
    s = stats.summary()
    log(f"[serve] run_policy(trail, real, {knobs['kv_layout']}, "
        f"probe_interval={knobs['probe_interval']}): "
        f"{len(stats.latencies)}/{len(reqs)} finished, {s['iterations']} "
        f"engine steps, {steps[0]} decode steps, {steps[1]} prefill "
        f"chunks, {s['preemptions']} "
        f"preemptions, {s['prefilled_tokens']} prefilled tokens, "
        f"{out_tokens} generated tokens")
    log(f"[serve] wall {wall:.3f} s (host clock, ends in synchronize), "
        f"{out_tokens / wall:.1f} generated tokens/s, "
        f"{(out_tokens + s['prefilled_tokens']) / wall:.1f} tokens/s with "
        f"prefill, max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"[serve] kernel launches on the main path: {launches}")
    if len(stats.latencies) != len(reqs) or len(served) != len(reqs):
        fail("not every request finished")
    _check_requests(torch, cfg, served.values())
    return launches, steps[0], steps[1]


def _load(torch, arch):
    from repro_torch.config import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    ssm = (f", SSM {nh} heads of {cfg.ssm_head_dim}, state "
           f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}" if cfg.ssm_state else "")
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, window {cfg.sliding_window}"
        f"{ssm}; {n_params / 1e9:.2f} B params (matmul weights bf16) "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    return cfg, model, _probe(cfg, model)


def _describe(reqs, max_len):
    log(f"[serve] {len(reqs)} requests, prompts "
        f"{sorted(len(r.prompt) for r in reqs)} tokens, outputs "
        f"{min(r.true_out_len for r in reqs)}-"
        f"{max(r.true_out_len for r in reqs)} tokens; max_len {max_len}")


def phase_serve_granite(torch):
    cfg, model, pred = _load(torch, "granite-3-8b")
    reqs = _requests(cfg, 12, 0)
    max_len = _max_len(reqs)
    knobs = dict(mode="real", kv_layout="paged", probe_interval=4,
                 max_batch=16, max_len=max_len, page_size=16)
    _describe(reqs, max_len)
    launches, *_ = _serve(torch, cfg, model, reqs, knobs, pred)
    for name in ("paged_decode_attention", "paged_decode_attention_multi"):
        if launches[name] <= 0:
            fail(f"kernel {name} never launched on the main path")
    steps = _stepped_run(torch, cfg, model, _requests(cfg, 5, 1), knobs, pred)
    log(f"[serve] stepped run: 5 requests in {steps} steps, lengths == "
        f"_kv_written after every step, tokens in range, posteriors and KV "
        f"pool finite")
    phase_cluster(torch, cfg, model, knobs)
    gc.collect()
    torch.cuda.empty_cache()
    cache = model.init_cache(16, 448, kv_layout="paged", page_size=16)
    cache["block_table"].copy_(torch.arange(
        1, 1 + 16 * 28, dtype=torch.int32, device="cuda").reshape(16, 28))
    phase_profile(torch, model, cache)
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    # 4 batches: the probe trainer is exercised at full width without
    # pushing the whole run much past 300 s on a slow host
    phase_harvest(torch, cfg, model, n_batches=4, seed=2, gate=False)
    return launches


def _probe(cfg, model):
    from repro_torch.serving.predictors import ProbePredictor
    return ProbePredictor(cfg.probe, probe_params=model.probe,
                          embed_table=model.embed)


def _cluster_run(torch, label, cfg, model, knobs, rc, faults=None,
                 prefill=0, hook=None):
    """One ``Router.run`` of ``_requests(cfg, 12, 0)`` over ``rc.n_replicas``
    real paged replicas sharing ``model`` (each its own pool, seed and
    probe predictor; the first ``prefill`` are ``prefill_only``), the
    router's size predictor a probe predictor of its own. Every launch
    count is 0 just before and read just after. ``hook(replicas)`` may
    wrap replica methods and returns the seconds they spent checking.
    Checks 12 of 12 finished with tokens in range and finite predictions
    and no page used at the drain. Returns (stats, launches, replicas)."""
    from repro_torch.cluster import Router
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine, EngineConfig
    reqs = _requests(cfg, 12, 0)
    replicas = [Engine(cfg, EngineConfig(policy="trail", seed=i,
                                         prefill_only=i < prefill, **knobs),
                       predictor=_probe(cfg, model), model=model,
                       device="cuda")
                for i in range(rc.n_replicas)]
    checking = hook(replicas) if hook else (lambda: 0.0)
    router = Router(replicas, rc, size_predictor=_probe(cfg, model),
                    faults=faults)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    stats = router.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    s = stats.summary()
    steps = [r["iterations"] for r in stats.replica_summaries]
    log(f"[cluster] {label}: {s['finished']}/12 finished, dispatch counts "
        f"{s['dispatch_counts']}, engine steps {steps}, handoffs "
        f"{s['handoffs']} ({s['handoff_pages']} pages), crashes "
        f"{s['replica_crashes']}, retries {s['retries']}, lost {s['lost']}, "
        f"virtual makespan {s['makespan']:.3f} s")
    log(f"[cluster] {label}: wall {wall:.3f} s (host clock, ends in "
        f"synchronize; {checking():.3f} s of it in the phase's own checks), "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, used pages "
        f"at the drain {stats.leaked_pages}")
    log(f"[cluster] {label}: kernel launches {launches}")
    if s["finished"] != 12 or len(stats.latencies) != 12:
        fail(f"cluster {label}: {s['finished']} of 12 finished")
    _check_requests(torch, cfg, reqs)
    if any(stats.leaked_pages):
        fail(f"cluster {label}: pages still used at the drain "
             f"{stats.leaked_pages}")
    return stats, launches, replicas


def _page_leaves(torch, pool, pids):
    """Every paged leaf of ``pool`` at physical pages ``pids``, on the
    host: ``{(run, sub, leaf): tensor}``."""
    idx = torch.tensor(pids, dtype=torch.long, device=pool.device)
    return {(key, j, leaf): sub[leaf].index_select(1, idx).cpu()
            for key, run in pool.cache.items() if key.startswith("run_")
            for j, sub in enumerate(run) if "pkpos" in sub
            for leaf in ("pk", "pv", "pkpos")}


def _payload_leaves(handoff, n):
    return {(key, j, leaf): pay[leaf][:, :n]
            for key, run in handoff.payload.items()
            for j, pay in enumerate(run) if pay is not None
            for leaf in ("pk", "pv", "pkpos")}


def _bit_equal(torch, a, b) -> bool:
    """Same keys, dtypes, shapes and bytes."""
    return a.keys() == b.keys() and bool(a) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and torch.equal(a[k].contiguous().view(-1).view(torch.uint8),
                        b[k].contiguous().view(-1).view(torch.uint8))
        for k in a)


def _handoff_checks(torch, moved):
    """Wrap the prefill replica's ``export_request`` and the decode
    replica's ``import_request`` (on the instances only): each payload
    must equal the source pool's pages just before export and the
    destination pool's just after import, bit for bit. ``moved`` collects
    (pages, payload bytes, export seconds, import seconds) per handoff,
    each call's host wall ending in a synchronize."""
    spent = [0.0]

    def hook(replicas):
        src, dst = replicas

        def export_request(rid, _orig=src.export_request):
            t0 = time.perf_counter()
            src.pool.flush_resets()
            before = _page_leaves(torch, src.pool,
                                  src.blocks.block_table(rid))
            spent[0] += time.perf_counter() - t0
            t_export = time.perf_counter()
            h = _orig(rid)
            torch.cuda.synchronize()
            t_export = time.perf_counter() - t_export
            if h.payload is None:
                fail(f"handoff of rid {rid}: no page payload")
            t0 = time.perf_counter()
            shipped = _payload_leaves(h, None)
            if not _bit_equal(torch, shipped, before):
                fail(f"handoff of rid {rid}: the payload differs from the "
                     f"source pages")
            moved.append([h.n_pages, sum(t.numel() * t.element_size()
                                         for t in shipped.values()),
                          t_export, 0.0])
            spent[0] += time.perf_counter() - t0
            return h

        def import_request(h, t=None, _orig=dst.import_request):
            t0 = time.perf_counter()
            kv = _orig(h, t=t)
            torch.cuda.synchronize()
            moved[-1][3] = time.perf_counter() - t0
            t0 = time.perf_counter()
            pids = dst.blocks.block_table(h.req.rid)
            if kv <= 0 or not _bit_equal(
                    torch, _payload_leaves(h, len(pids)),
                    _page_leaves(torch, dst.pool, pids)):
                fail(f"handoff of rid {h.req.rid}: the destination pages "
                     f"differ from the payload ({kv} tokens resumed)")
            spent[0] += time.perf_counter() - t0
            return kv

        src.export_request = export_request
        dst.import_request = import_request
        return lambda: spent[0]

    return hook


def phase_cluster(torch, cfg, model, serve_knobs):
    """The cluster router over 2 real paged replicas of the served
    ``granite-3-8b`` (one ``Model`` shared, as the reference's migration
    test shares its parameters), 12 requests each time: colocated jspw,
    1 prefill + 1 decode with every handoff's pages checked bit for bit
    across export and import, and jspw with replica 1 crashed at half the
    colocated run's virtual makespan; then the float32 migration parity
    of ``granite-smoke`` on the card against its unmigrated run and the
    CPU's."""
    from repro_torch.cluster import RouterConfig
    from repro_torch.cluster.faults import parse_chaos
    t_phase = time.perf_counter()
    knobs = serve_knobs         # the same 12 requests, hence max_len
    paged = ("paged_decode_attention", "paged_decode_attention_multi")

    stats, launches, replicas = _cluster_run(
        torch, "colocated", cfg, model, knobs,
        RouterConfig(n_replicas=2, policy="jspw"))
    if min(stats.dispatch_counts) <= 0:
        fail(f"colocated: a replica received no request "
             f"{stats.dispatch_counts}")
    for name in paged:
        if launches[name] <= 0:
            fail(f"colocated: kernel {name} never launched")
    makespan = stats.makespan
    del replicas

    moved = []
    stats, launches, replicas = _cluster_run(
        torch, "disaggregated 1P+1D", cfg, model, knobs,
        RouterConfig(n_replicas=2, policy="jspw", prefill_replicas=1),
        prefill=1, hook=_handoff_checks(torch, moved))
    if stats.n_handoffs != 12 or stats.handoff_pages <= 0 \
            or len(moved) != 12:
        fail(f"disaggregated: {stats.n_handoffs} handoffs of "
             f"{stats.handoff_pages} pages ({len(moved)} checked)")
    for name in paged:
        if launches[name] <= 0:
            fail(f"disaggregated: kernel {name} never launched")
    nbytes = [b for _, b, _, _ in moved]
    t_out = sum(m[2] for m in moved)
    t_in = sum(m[3] for m in moved)
    log(f"[cluster] disaggregated: 12 handoffs, "
        f"{sum(m[0] for m in moved)} pages, payload "
        f"{min(nbytes) / 2**20:.2f}-{max(nbytes) / 2**20:.2f} MiB a "
        f"handoff ({sum(nbytes) / 2**20:.1f} MiB in all), each bit-equal "
        f"to the source pages before export and the destination pages "
        f"after import; export_request {t_out:.3f} s in all "
        f"({sum(nbytes) / t_out / 1e9:.2f} GB/s device to host), "
        f"import_request {t_in:.3f} s ({sum(nbytes) / t_in / 1e9:.2f} GB/s "
        f"host to device), host clock")
    del replicas

    t_crash = makespan / 2
    stats, launches, replicas = _cluster_run(
        torch, f"crash:1@{t_crash:.6f}", cfg, model, knobs,
        RouterConfig(n_replicas=2, policy="jspw"),
        faults=parse_chaos(f"crash:1@{t_crash}", seed=0))
    s = stats.summary()
    if not (s["goodput"] == 1.0 and s["lost"] == 0
            and s["replica_crashes"] == 1 and s["retries"] >= 1):
        fail(f"crash: goodput {s['goodput']}, lost {s['lost']}, crashes "
             f"{s['replica_crashes']}, retries {s['retries']}")
    dead = replicas[1].pool
    dead.flush_resets()
    live = [int((sub["pkpos"] != -1).sum()) for key, run in
            dead.cache.items() if key.startswith("run_") for sub in run]
    if any(live) or dead.slot_of:
        fail(f"crash: the crashed replica's pool still holds KV ({live} "
             f"live positions, slots {dead.slot_of})")
    log(f"[cluster] crash: after the crashed replica's resets are flushed "
        f"every page of its pool has pkpos == -1")
    del replicas
    gc.collect()
    torch.cuda.empty_cache()
    phase_migration_parity(torch)
    log(f"[cluster] phase_cluster took {time.perf_counter() - t_phase:.1f} "
        f"s in all (host clock)")


def phase_migration_parity(torch):
    """The reference's real-mode migration test on ``granite-smoke`` in
    float32 on the card: a request exported mid-decode from one paged
    engine and imported into another emits the unmigrated run's greedy
    tokens, which equal the same weights' run on the CPU."""
    import copy
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.workload import WorkloadConfig, generate
    cfg, gpu, cpu = _model_pair("granite-3-8b", seed=0)
    reqs = generate(WorkloadConfig(
        n_requests=4, request_rate=50.0, seed=2, vocab=cfg.vocab_size,
        prompt_mean=6.0, out_median=8.0, max_out=12, split_streams=True))

    def make(model, device, seed):
        return Engine(cfg, EngineConfig(
            policy="trail", max_batch=3, mode="real", kv_layout="paged",
            page_size=8, max_len=64, seed=seed),
            predictor=_probe(cfg, model), model=model, device=device)

    def drain(engines, into):
        for eng in engines:
            while eng.has_work():
                for r in eng.step().completed:
                    into[r.rid] = list(r.generated)
        return into

    want = {}
    for key, device, model in (("card", "cuda", gpu), ("host", "cpu", cpu)):
        eng = make(model, device, 0)
        for r in copy.deepcopy(reqs):
            eng.submit(r)
        want[key] = drain([eng], {})
    a, b = make(gpu, "cuda", 0), make(gpu, "cuda", 1)
    for r in copy.deepcopy(reqs):
        a.submit(r)
    target = None
    for _ in range(200):
        a.step()
        live = [r for r in a._pool_reqs.values()
                if not r.done and r.generated]
        if live:
            target = max(live, key=lambda r: len(r.generated))
            break
    if target is None:
        fail("migration parity: no request reached decode")
    pre = len(target.generated)
    h = a.export_request(target.rid)
    if h.payload is None or b.import_request(h, t=a.now) <= 0:
        fail("migration parity: no KV shipped or resumed")
    got = drain([a, b], {})
    log(f"[cluster] {cfg.name} f32 migration on the card: rid {target.rid} "
        f"moved after {pre} of {len(want['card'][target.rid])} tokens with "
        f"{h.n_pages} pages; tokens equal to the unmigrated run "
        f"{got == want['card']}, unmigrated equal to the CPU's "
        f"{want['card'] == want['host']}")
    if got != want["card"] or want["card"] != want["host"] \
            or len(want["card"][target.rid]) <= pre:
        fail("migration parity: migrated tokens differ from the unmigrated "
             "run or the card's from the CPU's")
    if a.blocks.used_pages() or b.blocks.used_pages():
        fail("migration parity: pages left in use")


def phase_harvest(torch, cfg, model, *, n_batches, seed, gate):
    """Profile the served model's taps (``harvest_taps``) and train a probe
    on them; its MAE against the uniform prior's is gated only where the
    weights are trained. Returns the probe."""
    import numpy as np
    from repro_torch.core.bins import bin_means
    from repro_torch.training.train import (ProbeTrainConfig, probe_mae,
                                            train_probe)
    taps, rem = harvest_taps(torch, cfg, model, n_batches=n_batches,
                             seed=seed)
    t0 = time.perf_counter()
    pp, hist = train_probe(taps, rem, cfg.probe, cfg.d_model,
                           ProbeTrainConfig(epochs=PROBE_EPOCHS),
                           device="cuda")
    wall = time.perf_counter() - t0
    mae = probe_mae(pp, taps, rem, cfg.probe)
    uniform = float(np.mean(np.abs(np.mean(bin_means(cfg.probe)) - rem)))
    log(f"[probe] {cfg.name}: train_probe {PROBE_EPOCHS} epochs of "
        f"{taps.shape[0] // 32} steps in {wall:.3f} s: loss "
        f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, accuracy "
        f"{hist[-1]['acc']:.3f}; MAE {mae:.2f} tokens against the uniform "
        f"prior's {uniform:.2f}")
    if gate and not mae < uniform:
        fail(f"{cfg.name}: the trained probe's MAE {mae} is not below the "
             f"uniform prior's {uniform}")
    return pp


def harvest_taps(torch, cfg, model, *, n_batches, seed):
    """``harvest_probe_data`` on the served model: one ``forward_train`` of
    8 x 512 tokens per batch under inference mode, ``flash_attention`` in
    every attention layer and ``ssd_scan`` in every SSM layer, each
    launched once per layer and batch. Returns (taps, remaining)."""
    import numpy as np
    from repro_torch.config import KIND_HYBRID, KIND_SSM
    from repro_torch.kernels import ops
    from repro_torch.training.data import DataConfig, harvest_probe_data
    dc = DataConfig(vocab=cfg.vocab_size, seq_len=512, batch=8, max_out=448,
                    seed=seed)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    taps, rem = harvest_probe_data(model, dc, n_batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kinds = cfg.layer_kinds
    want = {"flash_attention": n_batches * sum(k != KIND_SSM for k in kinds),
            "ssd_scan": n_batches * sum(k in (KIND_SSM, KIND_HYBRID)
                                        for k in kinds)}
    launches = {k: ops.launches[k] for k in want}
    log(f"[profile-taps] {cfg.name}: harvest_probe_data over {n_batches} "
        f"batches of 8 x 512 tokens: {taps.shape[0]} taps of width "
        f"{taps.shape[1]} in {wall:.3f} s (host clock, ends in "
        f"synchronize), {n_batches * 8 * 512 / wall:.0f} tokens/s; "
        f"launches {launches}")
    if launches != want:
        fail(f"harvest launched {launches} for {n_batches} forwards of "
             f"{cfg.num_layers} layers, not {want}")
    if not np.isfinite(taps).all():
        fail(f"{cfg.name}: non-finite tap embeddings")
    return taps, rem


def phase_long_forward(torch, cfg, model):
    """One ``forward_train`` at B=1, S=4608 (past the 4096-token window)
    under inference mode: one ``flash_attention`` launch per layer."""
    from repro_torch.kernels import ops
    S = 4608
    g = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(1, cfg.vocab_size, (1, S), generator=g,
                           device="cuda", dtype=torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        loss, aux = model.forward_train({"tokens": tokens, "labels": labels})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches["flash_attention"]
    log(f"[long-forward] {cfg.name} forward_train B=1 S={S}: loss "
        f"{float(loss):.4f} over {int(aux['n_tok'])} labels, wall {wall:.3f} "
        f"s, flash_attention launches {launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != cfg.num_layers:
        fail(f"long forward launched flash_attention {launches} times")
    if not (math.isfinite(float(loss)) and torch.isfinite(aux["tap"]).all()):
        fail("long forward: non-finite loss or tap")


def phase_train(torch):
    """Train trail-llama at full width through the launcher's ``main``, then
    profile its taps, train the probe on them, serve with that probe and
    profile one train step. Returns the training run's launch counts."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import load_npz, params_from_jax
    from repro_torch.serving.predictors import ProbePredictor
    args = ["--arch", "trail-llama", "--steps", str(TRAIN_STEPS), "--batch",
            "8", "--seq", "512", "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "trail-llama.npz")
        printed = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            model, params, hist = launch_train.main(args + ["--ckpt", ckpt])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
        for line in printed.getvalue().splitlines():
            log(f"[train]   {line}")
        cfg = model.cfg
        restored = params_from_jax(cfg, load_npz(ckpt)["params"])
    n_params = sum(v.numel() for v in params.values())
    tokens = TRAIN_STEPS * 8 * 512
    log(f"[train] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
        f"{n_params / 1e6:.1f} M params; {TRAIN_STEPS} steps of 8 x 512 in "
        f"{wall:.3f} s (host clock, init included): {1e3 * wall / TRAIN_STEPS:.1f} "
        f"ms per step, {tokens / wall:.0f} tokens/s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; flash_attention launches "
        f"{launches['flash_attention']} "
        f"({launches['flash_attention'] / TRAIN_STEPS:g} per step)")
    first, last = hist[0]["loss"], hist[-1]["loss"]
    log(f"[train] logged loss {first:.4f} (step 0) -> {last:.4f} (step "
        f"{hist[-1]['step']}): {last / first:.3f} of the first")
    if not last < 0.7 * first:
        fail(f"trail-llama's loss did not fall below 0.7 x its first: "
             f"{first} -> {last}")
    if launches["flash_attention"] != 2 * cfg.num_layers * TRAIN_STEPS:
        fail(f"flash_attention launched {launches['flash_attention']} times "
             f"in {TRAIN_STEPS} steps, not {2 * cfg.num_layers} per step")
    if any(not torch.equal(restored[k], params[k].cpu()) for k in params):
        fail("the --ckpt checkpoint does not read back to the trained weights")
    log(f"[train] --ckpt read back with load_npz: {len(restored)} tensors "
        f"equal to the trained masters")

    pp = phase_harvest(torch, cfg, model, n_batches=8, seed=1, gate=True)
    dc_tokens = torch.randint(1, cfg.vocab_size, (2, 512), device="cuda")
    ops.reset_launches()
    with torch.inference_mode():
        taps = model.forward_all_taps({"tokens": dc_tokens})
        _, aux = model.forward_train({"tokens": dc_tokens,
                                      "labels": dc_tokens})
    all_taps = ops.launches["flash_attention"]
    log(f"[profile-taps] forward_all_taps {tuple(taps.shape)}: layer "
        f"{cfg.probe.tap_layer} equals forward_train's tap "
        f"{bool(torch.equal(taps[cfg.probe.tap_layer], aux['tap']))}; "
        f"flash_attention launches {all_taps} (both passes)")
    if (not torch.equal(taps[cfg.probe.tap_layer], aux["tap"])
            or all_taps != 2 * cfg.num_layers):
        fail("forward_all_taps disagrees with forward_train")

    with torch.no_grad():
        for name, value in pp.items():
            model.probe[name].copy_(value)
    pred = ProbePredictor(cfg.probe, probe_params=model.probe,
                          embed_table=model.embed)
    reqs = _requests(cfg, 12, 0)
    max_len = _max_len(reqs)
    _describe(reqs, max_len)
    knobs = dict(mode="real", kv_layout="contig", probe_interval=4,
                 max_batch=16, max_len=max_len, page_size=16)
    served, *_ = _serve(torch, cfg, model, reqs, knobs, pred)
    if served["decode_attention"] <= 0:
        fail("decode_attention never launched serving the trained model")

    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import DataConfig, batches
    from repro_torch.training.train import make_train_step
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=4, total_steps=TRAIN_STEPS)
    step = make_train_step(model, ocfg)
    state = opt.init(ocfg, params)
    batch = next(batches(DataConfig(vocab=cfg.vocab_size, seq_len=512,
                                    batch=8, max_out=448, seed=9), 1))
    batch = {k: torch.from_numpy(np.asarray(batch[k])).to("cuda")
             for k in ("tokens", "labels")}
    _profile(torch, cfg.name, "train step 8 x 512",
             lambda: step(params, state, batch))
    return launches


def phase_serve_gemma2(torch, cfg, model, pred):
    """gemma2-9b at full width and depth: the contiguous serve, then a
    stepped paged run on the same model."""
    reqs = _requests(cfg, 10, 0, long_prompts=(4200, 4400))
    max_len = _max_len(reqs)
    knobs = dict(mode="real", kv_layout="contig", probe_interval=4,
                 max_batch=16, max_len=max_len, page_size=16)
    _describe(reqs, max_len)
    launches, steps, _ = _serve(torch, cfg, model, reqs, knobs, pred)
    if launches["decode_attention"] != cfg.num_layers * steps or not steps:
        fail(f"decode_attention ran {launches['decode_attention']} times "
             f"for {steps} decode steps of {cfg.num_layers} layers")
    log(f"[serve] decode_attention ran {cfg.num_layers} x {steps} times; "
        f"rings of {cfg.sliding_window} slots wrapped by the prompts of "
        f"{[len(r.prompt) for r in reqs if len(r.prompt) > 4096]} tokens")
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.kernels import ops
    reqs2 = _requests(cfg, 4, 1)
    paged = dict(knobs, kv_layout="paged", max_len=_max_len(reqs2))
    ops.reset_launches()
    steps = _stepped_run(torch, cfg, model, reqs2, paged, pred)
    paged_launches = dict(ops.launches)
    log(f"[serve] stepped paged run: 4 requests in {steps} steps, lengths "
        f"== _kv_written after every step, tokens in range, posteriors and "
        f"KV finite; launches {paged_launches}")
    for name in ("paged_decode_attention", "paged_decode_attention_multi",
                 "decode_attention"):
        if paged_launches[name] <= 0:
            fail(f"kernel {name} never launched on the paged gemma2 path")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_ssm(torch, arch, long_prompts):
    """An SSM or hybrid config at full width and depth: the contiguous
    serve of 12 requests (two with the given long prompts), every prefill
    chunk through ``ssd_scan`` in every SSM layer and every decode step
    through ``decode_attention`` in every attention layer; then a profile
    of one decode megastep and one prefill chunk, and the tap harvest (no
    probe is trained on it: the weights are random, and the probe trainer
    runs on granite's and trail-llama's taps). Returns the serve's
    launches."""
    from repro_torch.config import KIND_HYBRID, KIND_SSM
    cfg, model, pred = _load(torch, arch)
    reqs = _requests(cfg, 10, 0, long_prompts=long_prompts)
    max_len = _max_len(reqs)
    knobs = dict(mode="real", kv_layout="contig", probe_interval=4,
                 max_batch=16, max_len=max_len, page_size=16)
    _describe(reqs, max_len)
    launches, steps, chunks = _serve(torch, cfg, model, reqs, knobs, pred)
    n_ssm = sum(k in (KIND_SSM, KIND_HYBRID) for k in cfg.layer_kinds)
    n_attn = sum(k != KIND_SSM for k in cfg.layer_kinds)
    log(f"[serve] ssd_scan ran {launches['ssd_scan']} times in {chunks} "
        f"prefill chunks of {n_ssm} SSM layers; decode_attention "
        f"{launches['decode_attention']} times in {steps} decode steps of "
        f"{n_attn} attention layers")
    if not chunks or launches["ssd_scan"] != n_ssm * chunks:
        fail(f"ssd_scan ran {launches['ssd_scan']} times for {chunks} "
             f"prefill chunks of {n_ssm} SSM layers")
    if launches["decode_attention"] != n_attn * steps:
        fail(f"decode_attention ran {launches['decode_attention']} times "
             f"for {steps} decode steps of {n_attn} attention layers")
    gc.collect()
    torch.cuda.empty_cache()
    cache = model.init_cache(16, 1024)
    phase_profile(torch, model, cache)
    _check_cache_finite(torch, cache)
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    harvest_taps(torch, cfg, model, n_batches=8, seed=2)
    return launches


def phase_train_ssm(torch):
    """SSM training on the card, through ``models.ssm.SSDScan`` (the
    ``ssd_scan`` kernel forward, the plain version's backward).

    (a) ``mamba2-smoke`` and ``hymba-smoke`` in float32: one
    ``forward_train`` with the gradient of every parameter on the card and
    on the CPU from the same masters; loss within 1e-5 relative, each
    gradient within 1e-5 plus 1e-4 of its leaf's largest (the tolerance of
    ``tests/test_torch_training.py``); ``ssd_scan`` (and for hymba
    ``flash_attention``) launched in the card's run.
    (b) ``mamba2-370m`` at full width and depth trained ``SSM_TRAIN_STEPS``
    steps of 8 x 512 through ``launch.train.main``: the last logged loss
    below 0.7 of the first, ``ssd_scan`` launched twice a layer a step
    (the forward and the remat recompute). Returns (b)'s launches."""
    from torch.func import functional_call
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.training.data import DataConfig, batches
    for arch, kernels in (("mamba2-370m", ("ssd_scan",)),
                          ("hymba-1.5b", ("ssd_scan", "flash_attention"))):
        cfg, gpu, cpu = _model_pair(arch, seed=13)
        dc = DataConfig(vocab=cfg.vocab_size, seq_len=64, batch=4,
                        prompt_mean=8, max_out=32, seed=13)
        batch = next(batches(dc, 1))
        masters = {k: v.detach().clone().float()
                   for k, v in cpu.state_dict().items()}
        out = {}
        for dev, m in (("cuda", gpu), ("cpu", cpu)):
            live = {k: v.to(dev, copy=True).requires_grad_()
                    for k, v in masters.items()}
            tb = {k: torch.from_numpy(batch[k]).to(dev)
                  for k in ("tokens", "labels")}
            ops.reset_launches()
            loss, _ = functional_call(m, live, (tb,))
            grads = torch.autograd.grad(loss, list(live.values()),
                                        allow_unused=True)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = dict(ops.launches)
            out[dev] = (float(loss.detach()),
                        [None if g is None else g.cpu() for g in grads])
        (gl, gg), (cl, cg) = out["cuda"], out["cpu"]
        worst, ok = 0.0, True
        for name, a, b in zip(masters, gg, cg):
            if (a is None) != (b is None):
                fail(f"{cfg.name}: the gradient of {name} exists on one "
                     f"device only")
            if a is not None:
                e = float((a - b).abs().max())
                worst = max(worst, e)
                ok &= e <= 1e-5 + 1e-4 * float(b.abs().max())
        log(f"[train-ssm] {cfg.name} f32 4 x 64, card vs CPU: loss "
            f"{gl:.6f} vs {cl:.6f}, gradients of {len(masters)} parameters "
            f"within {worst:.2e} ({sum(g is None for g in gg)} without one: "
            f"the probe); launches {launches}")
        if not (abs(gl - cl) <= 1e-5 * abs(cl) and ok):
            fail(f"{cfg.name}: the SSM training path on the card disagrees "
                 f"with the CPU")
        for name in kernels:
            if launches[name] <= 0:
                fail(f"{cfg.name}: {name} never launched in forward_train")
        del gpu, cpu
        gc.collect()
        torch.cuda.empty_cache()

    args = ["--arch", "mamba2-370m", "--steps", str(SSM_TRAIN_STEPS),
            "--batch", "8", "--seq", "512", "--device", "cuda"]
    printed = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        model, params, hist = launch_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    for line in printed.getvalue().splitlines():
        log(f"[train-ssm]   {line}")
    cfg = model.cfg
    n_params = sum(v.numel() for v in params.values())
    tokens = SSM_TRAIN_STEPS * 8 * 512
    per_step = launches["ssd_scan"] / SSM_TRAIN_STEPS
    log(f"[train-ssm] {cfg.name}: {cfg.num_layers} SSM layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.2f} B params (bf16 matmuls, "
        f"AdamW float32 masters); {SSM_TRAIN_STEPS} steps of 8 x 512 in "
        f"{wall:.3f} s (host clock, init included): "
        f"{1e3 * wall / SSM_TRAIN_STEPS:.1f} ms per step, "
        f"{tokens / wall:.0f} tokens/s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; ssd_scan launches {launches['ssd_scan']} "
        f"({per_step:g} per step: {cfg.num_layers} forward + "
        f"{cfg.num_layers} remat recompute)")
    first, last = hist[0]["loss"], hist[-1]["loss"]
    log(f"[train-ssm] logged loss {first:.4f} (step 0) -> {last:.4f} (step "
        f"{hist[-1]['step']}): {last / first:.3f} of the first")
    if not last < 0.7 * first:
        fail(f"{cfg.name}'s loss did not fall below 0.7 x its first: "
             f"{first} -> {last}")
    if launches["ssd_scan"] != 2 * cfg.num_layers * SSM_TRAIN_STEPS:
        fail(f"ssd_scan launched {launches['ssd_scan']} times in "
             f"{SSM_TRAIN_STEPS} steps, not {2 * cfg.num_layers} per step")

    import numpy as np
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train import make_train_step
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=4,
                           total_steps=SSM_TRAIN_STEPS)
    step = make_train_step(model, ocfg)
    state = opt.init(ocfg, params)
    batch = next(batches(DataConfig(vocab=cfg.vocab_size, seq_len=512,
                                    batch=8, max_out=448, seed=9), 1))
    batch = {k: torch.from_numpy(np.asarray(batch[k])).to("cuda")
             for k in ("tokens", "labels")}
    _profile(torch, cfg.name, "train step 8 x 512",
             lambda: step(params, state, batch))
    del model, params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    ssd_train_split(torch, cfg)
    return launches


def ssd_train_split(torch, cfg):
    """One layer's ``SSDScan`` at the train step's shape (bf16 x, B and C;
    8 x 512; a zero initial state), CUDA events around 10 calls each: the
    kernel forward against the plain version's backward, with the
    gradients of every input taken as the train step takes them."""
    from repro_torch.models.ssm import SSDScan, ssm_dims
    _, nh, _ = ssm_dims(cfg)
    hp, N, B, L = cfg.ssm_head_dim, cfg.ssm_groups * cfg.ssm_state, 8, 512
    g = torch.Generator(device="cuda").manual_seed(5)

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    leaves = [draw(B, L, nh, hp).bfloat16(),
              torch.nn.functional.softplus(draw(B, L, nh) - 2.0),
              -torch.exp(draw(nh)), draw(B, L, N).bfloat16(),
              draw(B, L, N).bfloat16()]
    leaves = [t.requires_grad_() for t in leaves]
    y, s = SSDScan.apply(*leaves, None, cfg.ssm_chunk)
    dy, ds = torch.randn_like(y), torch.zeros_like(s)
    fwd_ms = time_ms(torch, lambda: SSDScan.apply(*leaves, None,
                                                  cfg.ssm_chunk), iters=10)
    bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        (y, s), leaves, (dy, ds), retain_graph=True), iters=10)
    log(f"[train-ssm] one layer's SSDScan at 8 x 512 ({nh} heads of {hp}, "
        f"state {N}, chunk {cfg.ssm_chunk}, bf16): kernel forward "
        f"{fwd_ms:.4f} ms, plain backward {bwd_ms:.4f} ms; a step's "
        f"{cfg.num_layers} layers: forward and remat recompute "
        f"{2 * cfg.num_layers * fwd_ms:.3f} ms, backward "
        f"{cfg.num_layers * bwd_ms:.3f} ms of device time")


SERVE_CLI_RUNS = (  # label, argv, kernels the run must launch
    ("granite-3-8b contig",
     ["--arch", "granite-3-8b", "--real", "--n", "12", "--seed", "0",
      "--metrics-out", str(ROOT / "build" / "serve_cli_metrics.json")],
     ("decode_attention",)),
    ("granite-3-8b paged",
     ["--arch", "granite-3-8b", "--real", "--n", "12", "--seed", "0",
      "--kv-layout", "paged"],
     ("paged_decode_attention", "paged_decode_attention_multi")),
    ("mamba2-370m",
     ["--arch", "mamba2-370m", "--real", "--n", "12", "--seed", "0"],
     ("ssd_scan",)),
)


def phase_serve_cli(torch):
    """The serving entry point, ``python -m repro_torch.launch.serve``'s
    ``main``, in-process on the card at full width and depth: each run of
    ``SERVE_CLI_RUNS`` must finish 12 of 12 requests and launch its
    kernels; the first writes ``--metrics-out``, which must parse, and its
    event log must pass ``check_invariants``. The JSON's latencies are the
    cost model's (TPU v5e preset), so only the host wall is a card
    number."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.metrics import check_invariants
    (ROOT / "build").mkdir(exist_ok=True)
    for label, argv, kernels in SERVE_CLI_RUNS:
        printed = io.StringIO()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            stats, event_log = serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        text = printed.getvalue()
        summary = json.loads(text[:text.index("\n}") + 2])
        log(f"[serve-cli] {label}: {len(stats.latencies)}/12 finished in "
            f"{summary['iterations']} engine steps, wall {wall:.3f} s (host "
            f"clock, model init included, ends in synchronize); launches "
            f"{launches}")
        if len(stats.latencies) != 12:
            fail(f"serve CLI {label}: {len(stats.latencies)} of 12 finished")
        for name in kernels:
            if launches[name] <= 0:
                fail(f"serve CLI {label}: {name} never launched")
        if "--metrics-out" in argv:
            path = Path(argv[argv.index("--metrics-out") + 1])
            report = json.loads(path.read_text())
            check_invariants(event_log)
            log(f"[serve-cli] {label}: {path.name} parses "
                f"({report['requests']['finished']} finished), "
                f"{len(event_log)} events pass check_invariants")
        del stats, event_log
        gc.collect()
        torch.cuda.empty_cache()


def phase_serve_step(torch, cfg, model):
    """``make_serve_step`` for 8 steps after a 300-token prefill of 16 rows:
    each fused probe call against its plain version on the same tap."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps
    seen = []
    fused = ops.probe_update

    def spy(*args):
        out = fused(*args)
        seen.append((args, out))
        return out

    B, k = 16, cfg.probe.num_bins
    cache = model.init_cache(B, 512)
    g = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(1, cfg.vocab_size, (B, 300), generator=g,
                           device="cuda", dtype=torch.int32)
    logits, cache, _, _ = steps.make_prefill_step(model)(cache, tokens)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    q = torch.full((B, k), 1.0 / k, device="cuda")
    serve_step = steps.make_serve_step(model)
    ops.probe_update = spy
    ops.reset_launches()
    try:
        for _ in range(8):
            nxt, cache, q, pred = serve_step(cache, tok, q)
            if not torch.isfinite(pred).all() or not torch.isfinite(q).all():
                fail("serve_step: non-finite posterior or predicted length")
            tok = nxt[:, None]
        torch.cuda.synchronize()
    finally:
        ops.probe_update = fused
    launches = dict(ops.launches)
    worst = 0.0
    for args, out in seen:
        want = ref.probe_update_ref(*args)
        worst = max(worst, *(float((a - b).abs().max())
                             for a, b in zip(out, want)))
    log(f"[serve-step] {cfg.name}: 8 fused serve steps, B={B}: "
        f"{len(seen)} probe_update calls, max|kernel-plain| {worst:.3e} "
        f"(tol {PROBE_TOL:.0e}); launches {launches}; predicted remaining "
        f"{[round(x, 2) for x in pred[:4].tolist()]}")
    if len(seen) != 8 or worst > PROBE_TOL:
        fail("serve_step's fused probe disagrees with its plain version")
    if (launches["probe_update"] != 8
            or launches["decode_attention"] != 8 * cfg.num_layers):
        fail(f"serve_step launches {launches}")
    _profile(torch, cfg.name, f"fused serve step, B={B}",
             lambda: serve_step(cache, tok, q))
    return launches, cache


def phase_profile(torch, model, cache):
    """Where a step's time goes: one decode megastep (k=4, 16 rows at ~300
    tokens of context) and one prefill chunk (256 wide, 2 of 16 rows
    active) of a served model, on ``cache`` (16 rows, empty). Wall time is
    the median of three runs on the host clock, without the profiler; one
    run under ``torch.profiler`` then gives the device busy time (the sum
    of the kernels' durations, one stream) and the kernels that take it.
    Busy over wall is the device's busy share; the rest of the wall time
    the device sits idle."""
    B, dev = 16, "cuda"
    name = model.cfg.name
    g = torch.Generator(device=dev).manual_seed(3)
    vocab = model.cfg.vocab_size
    tokens = torch.randint(1, vocab, (B, 300), generator=g, device=dev,
                           dtype=torch.int32)
    logits, cache, _, _ = model.prefill_chunk(cache, tokens)
    last = logits.argmax(-1).to(torch.int32)[:, None]
    chunk = torch.randint(1, vocab, (B, 256), generator=g, device=dev,
                          dtype=torch.int32)
    valid = torch.zeros((B, 256), dtype=torch.bool, device=dev)
    valid[:2, :100] = True
    cases = {"decode megastep k=4, B=16":
             lambda: model.decode_multi(cache, last, k=4),
             "prefill chunk 16x256, 2 rows active":
             lambda: model.prefill_chunk(cache, chunk, valid)}
    for label, fn in cases.items():
        _profile(torch, name, label, fn)


def _profile(torch, name, label, fn):
    """Wall time of ``fn`` (the median of three runs on the host clock,
    without the profiler, after a warm run), then one run under
    ``torch.profiler``: the device busy time (the sum of the kernels'
    durations, one stream), the kernel launches and the kernels that take
    the time (the six largest, and every kernel of this repository)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()                                    # warm
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e6 * (time.perf_counter() - t0))
    wall_us = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"[profile] {name} {label}: wall {wall_us / 1e3:.3f} ms; the "
            f"profiler saw no device events (busy share not measured)")
        return
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us()
    busy = sum(by_name.values())
    log(f"[profile] {name} {label}: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
        f"{len(kernels)} kernel launches")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for i, (kname, us) in enumerate(ranked):    # the top 6 and our kernels
        if i < 6 or re.search(PORT_KERNELS, kname):
            log(f"[profile]   {100 * us / busy:5.1f}% {us / 1e3:8.3f} ms "
                f"{kname[:90]}")


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    t_start = time.perf_counter()
    name, count, card = phase_device(torch)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script: {e}")
    if sys.argv[1:2] == ["--compare-decode"]:
        compare_decode(torch, sys.argv[2:])
        return
    if sys.argv[1:2] == ["--compare-ssd"]:
        compare_ssd_builds(torch, sys.argv[2:])
        return
    if sys.argv[1:2] == ["--compare-probe"]:
        compare_probe_builds(torch, sys.argv[2:])
        return
    phase_build()
    worst = phase_check(torch)
    worst["flash_attention"] = phase_check_flash(torch)
    worst["ssd_scan"] = phase_check_ssd(torch)
    phase_check_split(torch)
    rows = phase_time(torch)
    phase_reference(torch)
    phase_reference_train(torch)
    granite = phase_serve_granite(torch)
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, pred = _load(torch, "gemma2-9b")
    gemma2 = phase_serve_gemma2(torch, cfg, model, pred)
    step_launches, cache = phase_serve_step(torch, cfg, model)
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    phase_profile(torch, model, model.init_cache(16, 1024))
    gc.collect()
    torch.cuda.empty_cache()
    phase_long_forward(torch, cfg, model)
    del cfg, model, pred
    gc.collect()
    torch.cuda.empty_cache()
    trained = phase_train(torch)
    gc.collect()
    torch.cuda.empty_cache()
    mamba2 = phase_serve_ssm(torch, "mamba2-370m", (4000, 4100))
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_ssm(torch, "hymba-1.5b", (1500, 2000))
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_ssm(torch)
    phase_serve_cli(torch)

    kernels = []
    for kname, label, source, replaces, launches in (
            ("paged_decode_attention",
             "paged_decode_attention[granite-3-8b,T=1]",
             "paged_decode_attention.cu",
             "paged_decode_attention.py:87", granite),
            ("paged_decode_attention_multi",
             "paged_decode_attention_multi[granite-3-8b,T=256]",
             "paged_decode_attention.cu",
             "paged_decode_attention.py:179", granite),
            ("decode_attention", "decode_attention[gemma2-9b,ring]",
             "decode_attention.cu", "decode_attention.py:71", gemma2),
            ("probe_update", "probe_update[gemma2-9b]", "probe.cu",
             "probe.py:55", step_launches),
            ("flash_attention", "flash_attention[trail-llama]",
             "flash_attention.cu", "flash_attention.py:84", trained),
            ("ssd_scan", "ssd_scan[mamba2-370m]", "ssd_scan.cu",
             "ssd_scan.py:70", mamba2)):
        row = rows[label]
        kernels.append(dict(
            name=kname, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}",
            replaces=f"src/repro/kernels/{replaces}",
            launches=launches[kname], max_abs_err=worst[kname],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
