#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card, end to end, and check it.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero; nothing is passed over):

1. report the device (name, count, ``nvidia-smi`` name and power limit);
   with no CUDA device, fail;
2. build every CUDA kernel from the sources in this checkout (one ``nvcc``
   per source, all at once), print the build time and what ptxas reports,
   and count the ``HGMMA`` (wgmma) instructions ``cuobjdump -sass`` finds
   in the ``flash_attention``, ``paged_decode_attention``, ``ssd_scan``
   and ``moe_experts`` libraries (none fails: their bf16 kernels run on
   the tensor cores);
3. hold each kernel against its plain PyTorch version on the card, float32
   and bfloat16, with inactive (q_pos = -1) rows and a logit softcap:
   the paged kernels at the shapes of ``granite-3-8b``, ``trail-llama``
   and ``gemma2-9b`` (head_dim 256), ``olmoe-1b-7b`` (16/16 heads of
   128) and ``paligemma-3b`` (8 query heads over one KV head of 256;
   the multi-query kernel also at T = 512, a 256-row prefix before a
   256-token chunk) with scrambled block tables and null pages;
   ``decode_attention`` at the shapes of ``gemma2-9b`` (a 4608-slot
   cache, and a wrapped 4096-slot ring with window 4096), ``gemma3-1b``
   (one KV head, window 512), ``granite-3-8b`` and ``hymba-1.5b`` (25/5
   heads of 64, a 1025-slot ring with window 1024), ``whisper-tiny`` (6/6
   heads of 64) and ``olmoe-1b-7b`` (16/16 heads of 128), both 449
   slots, and ``paligemma-3b`` (8/1 heads of 256, 577 slots); over int8
   caches (K/V quantised by the model's ``_quantize``, with their
   scales), with float32 and bf16 queries, at the shapes of
   ``qwen1.5-32b`` (40/40 heads of 128, 449 slots), ``granite-3-8b``,
   a wrapped ``gemma2-9b`` ring (window 4096, softcap 50), ``gemma3-1b``,
   ``whisper-tiny`` and head_dim 32, each logging its split; both
   single-query
   kernels also at the edges of their split over a thread-block cluster
   (B=1, where the split is largest; rows of 1 and ps - 1 tokens, one
   scan tile and one round of tiles over the split; every valid key in
   one CTA; 256-page tables; a window edge inside a tile; inactive rows),
   each case logging the split its launch used (``decode_attention`` also
   over int8 caches); the multi-query kernel
   also with pages of 8 and in a prefill batch whose every row tile is
   inactive but two sequences'; ``probe_update`` at ``gemma2-9b`` width
   (1, 16, 17 and 64 rows, bfloat16 and float32 taps), at the d of
   ``granite-3-8b`` (4096) and ``trail-llama`` (768), at d 200 and 201
   (the tap read element by element), hid 48 and 50 (4-byte copies in
   place of TMA), k 1 and 32, d 20000 (three slices a CTA) and hid 8192
   (256 column blocks on the 132 clusters of one CTA the card holds at
   once, two blocks a cluster), at 128 rows (``decode_32k``'s batch) at
   the widths of ``gemma3-1b``, ``hymba-1.5b``, ``mamba2-370m`` and
   ``whisper-tiny``, each with a row
   whose posterior sums to 0 (the prior fallback; not with one bin), two
   calls on the same inputs bit-equal and calls in flight on two streams
   equal to one call; ``ssd_scan`` at
   the shapes of ``tests/test_kernels.py``, at hp 33 and N 13 (rows of
   odd byte length), of ``mamba2-370m`` (16 x 256,
   32 heads of 64, state 128, chunk 128) and ``hymba-1.5b`` (50 heads,
   state 16) and at the L=8 bucket, all from a nonzero initial state,
   plus rows whose tail has dt = 0 (their state equals the shorter
   scan's) and a scan in two halves (equal to one scan);
   ``ssm_state_update`` (``phase_ssm_update``) at the decode shapes of
   ``granite-4.0-h-small`` (64 rows, 128 heads of 64, state 128; all
   rows live and 6 of 64), ``mamba2-370m`` and ``hymba-1.5b`` (state 16),
   inactive rows' state bit for bit and their y 0, live rows' state
   within 1e-6 and y within 1e-5 of scale (y's sum over N in another
   order), then timed as CUDA graphs of 30 calls beside its bound (the
   live rows' state read and written once) and the plain version;
   ``moe_experts`` (``phase_moe_experts``) at the MoE layers of
   ``granite-4.0-h-small`` (72 experts of 768, top 10) and
   ``olmoe-1b-7b`` (64 of 1024, top 8), dropless, in bf16: decode over
   64 rows with 1, 6 and 64 live (and 3 or 14), a 64 x 64 prefill chunk
   holding 100 tokens and a full 16 x 256 one, the live entries within
   2e-2 of scale of the plain version, the experts-read tally equal to
   the experts the live tokens route to; ``moe_mlp`` with the live mask
   with dead positions exactly 0, live ones within 2e-2 of the sort
   dispatch over the live tokens alone, no host sync, and a captured
   graph's replay bit-equal to the eager call; timed beside its bound
   (the hit experts' weights read once), the plain version and the three
   ``torch.bmm`` over the sort dispatch's dense buffer.
   Tolerances, per
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
   before every call, at 16 rows and 1; nor for ``ssd_scan``); the
   single-query decode kernels and their library call as CUDA graphs of
   30 calls (at the serves' shapes a call takes less device time than
   its wrapper takes on the host), also at the shapes the serves launch
   most: the gemma2-9b and hymba-1.5b local rings holding 300 positions,
   granite's and olmoe's 28-page tables holding about 300 tokens,
   whisper's and olmoe's 449-slot rows holding 300, and qwen1.5-32b's
   int8 449-slot rows holding 300 (its library yardstick is SDPA over a
   bf16 copy of the same cache, twice the bytes); the multi-query kernel
   and ``flash_attention`` also at paligemma-3b's prefix shape (G = 8,
   hd 256, 512 rows); ``ssd_scan`` at a prefill chunk's shape of
   mamba2-370m and hymba-1.5b and at the tap harvest's (mamba2-370m, 8 x
   512 from a zero state);
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
   greedy tokens equal the unmigrated run's and the CPU's);
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
   its plain version on the same tap, predicted lengths finite;
9. ``flash_attention`` (the training and profiling forwards): checked in
   phase 3 against its plain version, float32 and bfloat16, at the
   shapes of ``tests/test_kernels.py``, non-causal at S=200, and at the
   path's shapes (trail-llama 8x512 with 12/4 heads, granite 8x512 with
   32/8 heads, a gemma2-9b local layer at S=4608 with window 4096 and
   softcap 50, a gemma3-1b local layer with window 512, hymba-1.5b's
   25/5 heads with window 1024 at S=1500, and granite's heads at S=777,
   neither a multiple of the key tile, and the whisper-tiny encoder's
   non-causal 16 x 1500 with 6/6 heads of 64), plus the
   ``FlashAttention`` Function's gradients against plain autograd
   (causal, and non-causal as in the encoder); timed in phase 4 at the
   trail-llama, granite, gemma2 and whisper encoder shapes (library
   yardstick: ``scaled_dot_product_attention(is_causal=...,
   enable_gqa=True)``, no softcap or window);
10. hold the training path on the card against the CPU in float32 on
    ``trail-llama-smoke`` and ``gemma2-smoke`` (S=64, so the window of 16
    binds): ``forward_train`` loss and tap, every parameter's gradient,
    and one ``train_lm`` step;
11. profile ``granite-3-8b`` at full width and depth on its served model:
    harvest 4 batches of 8 x 512 tokens of tap embeddings with
    ``harvest_probe_data`` and train a probe on them (printed, not gated:
    the weights are random);
12. one ``gemma2-9b`` ``forward_train`` at B=1, S=4608 (past the 4096-token
    window) under inference mode: 42 launches, a finite loss;
13. train ``trail-llama`` at full width (12 layers, d_model 768) through
    ``python -m repro_torch.launch.train``'s ``main`` for ``TRAIN_STEPS``
    steps of 8 x 512 tokens: the last logged loss below 0.7 x the first
    (the reference's own test factor), 24 ``flash_attention`` launches per
    step (12 layers, and 12 again in the remat recompute), the ``--ckpt``
    file read back with ``load_npz``; then harvest its taps, check
    ``forward_all_taps``, train the probe (its MAE below the
    uniform prior's), and serve 12 requests with that probe under
    ``policy="trail"``;
14. serve ``mamba2-370m`` at full width and depth (48 SSM layers, random
    weights from seed 0) through ``run_policy(mode="real",
    kv_layout="contig", ...)``: 12 requests, two with prompts of about
    4000 tokens that carry the state over 16 chunks; check that every
    request finished, that ``ssd_scan`` ran 48 times per prefill chunk
    and ``ssm_state_update`` 48 times per decode step, and that nothing
    is NaN; harvest 8 batches of 8 x 512 tap embeddings;
15. the same for ``hymba-1.5b`` (32 hybrid layers: 1024-token windowed
    attention beside the SSM), two prompts past the window so the rings
    wrap: ``ssd_scan`` 32 times per prefill chunk, ``decode_attention``
    and ``ssm_state_update`` 32 times each per decode step.
16. train the SSM stacks on the card through ``models.ssm.SSDScan``
    (the ``ssd_scan`` kernel forward, the plain version's backward):
    ``mamba2-smoke`` and ``hymba-smoke`` in float32, ``forward_train``
    loss and every parameter's gradient against the CPU on the same
    masters (1e-5 relative; 1e-5 plus 1e-4 of the leaf's largest), with
    ``ssd_scan`` (and hymba's ``flash_attention``) launched; then
    ``mamba2-370m`` at full width and depth for ``SSM_TRAIN_STEPS`` steps
    of 8 x 512 through ``launch.train.main``: the last logged loss below
    0.7 x the first, ``ssd_scan`` twice a layer a step (forward and remat
    recompute); then time one layer's ``SSDScan`` at that step's shape,
    the kernel forward against the plain backward;
17. serve through the entry point, ``repro_torch.launch.serve.main``, in
    process (``SERVE_CLI_RUNS``): ``granite-3-8b --real --n 12`` under
    the contiguous layout (``decode_attention``) writing
    ``--metrics-out`` (it must parse, and the run's event log must pass
    ``check_invariants``), the same under ``--kv-layout paged`` (both
    paged kernels), and ``mamba2-370m --real --n 12`` (``ssd_scan``):
    12 of 12 finished each, the host wall of each run printed;
18. ``phase_serve_whisper``: ``whisper-tiny`` at full width and depth (4
    encoder and 4 decoder layers, 1500 frames): in float32 on the card
    against the CPU, under the contiguous and the paged layout,
    ``prefill_chunk(enc_embeds=...)`` over 16 x 1500
    frames (the encoder's non-causal ``flash_attention``, the cross
    caches; ``encode`` and ``build_cross_cache`` alone give the same
    caches bit for bit) and 8 decode steps, tokens equal and logits
    within 1e-4; the 12 requests of phase 6 served contiguous and paged
    with bf16 weights (``decode_attention``, then the paged kernels; the
    decoder reads zeroed cross caches, as the reference engine's does);
    one ``forward_train`` and backward
    with frame embeddings at 8 x 448 (4 non-causal launches in the
    encoder, 8 causal in the decoder with its remat recompute);
19. ``phase_serve_moe``: ``olmoe-1b-7b`` at full width and depth (16
    layers, 64 experts top 8): the 12 requests served paged (both paged
    kernels) and contiguous (``decode_attention``), ``moe_mlp`` at a
    decode step's and a prefill chunk's shape under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), and
    ``olmoe-smoke`` in float32 against the CPU (phase 5's check,
    contiguous and paged);
20. ``phase_prefix``: ``paligemma-3b`` at full width and depth (18
    layers, 8/1 heads of 256, 256 prefix positions): the 12 requests
    served paged and contiguous (text only, as the reference engine
    serves it); ``prefill_chunk`` with a seeded 4 x 256 bf16 prefix before
    a 256-token chunk, then 4 decode steps, under both layouts (the
    multi-query kernel at T = 512, G = 8); one ``forward_train`` with
    ``prefix_embeds`` at 4 x (256 + 256) through ``flash_attention``;
    ``paligemma-smoke`` in float32 with a prefix, card against CPU,
    under both layouts;
21. ``phase_serve_qwen_int8``: ``qwen-smoke`` in float32 with
    ``kv_quant`` on the card against the CPU (phase 5's check; the int8
    payloads compared too), then ``qwen1.5-32b`` with ``kv_quant=True``
    at full width and depth (64 layers, d_model 5120, 40/40 heads of
    128; 68.5 GiB of weights): the 12 requests served contiguous with 16
    rows, every decode step through the int8 ``decode_attention``, peak
    memory and the cache's int8 and bf16 bytes logged;
22. ``phase_dryrun``: the dry run for one H100
    (``repro_torch.launch.dryrun``, on meta tensors, in a process a CPU)
    over every architecture and input shape, a line each (fit,
    predicted peak, bounding term; no case may fail); then every decode
    case whose predicted peak fits in 90% of the card's memory runs its
    serve step on the card at the shape's B and S with a full cache
    (random bf16 K/V, every position written): one warm-up and 3 timed
    steps, the measured peak against the predicted (the ratio logged,
    not gated), the step against the H100 byte bound, the launches
    (``decode_attention`` once a step per attention layer, ``probe_update``
    once a step), finite logits; in one more step every kind of
    ``decode_attention`` call (each global and ring layer length, at
    the case's B) and the ``probe_update`` call are recorded and held
    against their plain versions on the same inputs; and one global
    layer is timed beside its plain version, SDPA and its bound over the
    full 524289-slot row of ``gemma3-1b`` at ``long_500k`` and the
    32769-slot rows of ``whisper-tiny`` at ``decode_32k``. A case that
    fits by the dry run and runs out of memory fails.

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
import itertools
import json
import math
import random
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
              lengths=None, int8=False):
    """Random slot cache laid out as ``cache_write`` lays it out (on the
    card). Without a window, position p sits in slot p; with one the M
    slots are a ring holding each row's last M positions at slot p % M,
    so a row longer than M has wrapped and its positions are out of slot
    order. Row lengths are random (up to 3M for a ring) unless given;
    q_pos is each row's last position, -1 for rows in ``inactive``.
    ``int8``: K/V quantised by the model's ``_quantize`` (int8 values and
    their float32 scales ``k_scale``/``v_scale``, as a ``kv_quant`` cache
    holds them); q stays in ``dtype``."""
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
    case = dict(q=q, k=k, v=v, kpos=torch.from_numpy(kpos).to(dev),
                q_pos=torch.from_numpy(q_pos).to(dev))
    if int8:
        from repro_torch.models.attention import _quantize
        case["k"], case["k_scale"] = _quantize(k)
        case["v"], case["v_scale"] = _quantize(v)
    return case


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
    through, read once each (an int8 row with its two float32 scales),
    and the output written once. Operations: 4*hd per (query head, valid
    key) pair."""
    q, k, kpos, qp = case["q"], case["k"], case["kpos"], case["q_pos"]
    B, H, hd = q.shape
    M, KH = k.shape[1], k.shape[2]
    el = q.element_size()
    row = 2 * KH * (hd * k.element_size() + 4 * ("k_scale" in case))
    valid = (kpos >= 0) & (kpos <= qp[:, None])
    if window:
        valid &= kpos > qp[:, None] - window
    looked = B * M if window else int((qp + 1).clamp(0, M).sum())
    rows = int(valid.sum())
    nbytes = rows * row + looked * 4 + 2 * q.numel() * el + B * 4
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


def flash_bound(q, k, window, dtype, causal=True):
    """Bytes: q, k and v read once and the output written once. Operations:
    4*hd (QK^T and PV) per (query head, key) pair that the causal (and
    window) mask lets through; all S*S pairs without ``causal``."""
    B, S, H, hd = q.shape
    el = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * el
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    if not causal:
        pairs = S * min(S, window) if window else S * S
    return bound_ms(nbytes, 4 * hd * H * B * pairs, dtype)


def flash_library_call(q, k, v, causal=True):
    """One ``scaled_dot_product_attention(is_causal=causal,
    enable_gqa=True)`` on (B, H, S, hd) copies made outside the timed
    call: the yardstick (never used by the port). It has no softcap or
    window, so it times the plain (causal or not) attention."""
    import torch.nn.functional as F
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                  is_causal=causal,
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
    attention without one. It takes no int8: an int8 cache is
    dequantised into a copy in q's dtype first, outside the timed call,
    so it reads twice the bytes the kernel does (bf16)."""
    import torch.nn.functional as F
    q, k, v, kpos, qp = (case[n] for n in SLOT_ARGS)
    if "k_scale" in case:
        from repro_torch.models.attention import dequantize
        k = dequantize(k, case["k_scale"]).to(q.dtype)
        v = dequantize(v, case["v_scale"]).to(q.dtype)
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
    for name in ("flash_attention", "paged_decode_attention", "ssd_scan",
                 "moe_experts"):
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
            if re.search(r"_kernelI(f|13__nv_bfloat16)a", mangled):
                args.append("int8 K/V")
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
    "olmoe-1b-7b": (16, 16, 128),
    "paligemma-3b": (8, 1, 256),        # MQA: 8 query heads over one
}

SLOT_CASES = [  # arch, H, KH, hd, M, window, softcap
    ("gemma2-9b global", 16, 8, 256, 4608, 0, 50.0),
    ("gemma2-9b local", 16, 8, 256, 4096, 4096, 50.0),
    ("gemma3-1b local", 4, 1, 256, 512, 512, 0.0),
    ("granite-3-8b", 32, 8, 128, 448, 0, 0.0),
    ("hymba-1.5b local", 25, 5, 64, 1025, 1024, 0.0),
    ("whisper-tiny", 6, 6, 64, 449, 0, 0.0),
    ("olmoe-1b-7b", 16, 16, 128, 449, 0, 0.0),
    ("paligemma-3b", 8, 1, 256, 577, 0, 0.0),
]

SLOT_INT8_CASES = [  # the int8 cache of kv_quant: arch, H, KH, hd, M, window,
    ("qwen1.5-32b", 40, 40, 128, 449, 0, 0.0),                 # softcap
    ("granite-3-8b", 32, 8, 128, 448, 0, 0.0),
    ("gemma2-9b local", 16, 8, 256, 4096, 4096, 50.0),
    ("gemma3-1b local", 4, 1, 256, 512, 512, 0.0),
    ("whisper-tiny", 6, 6, 64, 449, 0, 0.0),
    ("head_dim 32", 4, 4, 32, 200, 0, 0.0),
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
    ("whisper-tiny encoder", 16, 1500, 6, 6, 64, 0, 0.0, False),
    ("paligemma-3b prefix", 4, 512, 8, 1, 256, 0, 0.0, True),
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

FLASH_TIMED = {  # arch: B, S, H, KH, hd, window, softcap, causal (bf16)
    "trail-llama": (8, 512, 12, 4, 64, 0, 0.0, True),
    "granite-3-8b": (8, 512, 32, 8, 128, 0, 0.0, True),
    "gemma2-9b local": (1, 4608, 16, 8, 256, 4096, 50.0, True),
    "whisper-tiny encoder": (16, 1500, 6, 6, 64, 0, 0.0, False),
    "paligemma-3b prefix": (4, 512, 8, 1, 256, 0, 0.0, True),
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
            # seed 0 for the non-causal cases: the S=200 case's are the
            # inputs of test_flash_attention_non_causal_never_counts_padding
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
    for dtype, (B, S, H, KH, hd, window, cap, causal) in (
            ("float32", (2, 300, 12, 4, 64, 0, 0.0, True)),
            ("bfloat16", (2, 512, 16, 8, 256, 128, 50.0, True)),
            ("float32", (2, 300, 6, 6, 64, 0, 0.0, False))):  # the encoder
        q, k, v = flash_case(torch, B=B, S=S, H=H, KH=KH, hd=hd, dtype=dtype,
                             seed=S)
        dout = torch.randn_like(q)
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(
            FlashAttention.apply(*ins, window, cap, causal), ins, dout)
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(ref.flash_attention_ref(
            *ins, causal=causal, window=window, softcap=cap), ins, dout)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            compare("FlashAttention." + name,
                    f"B={B} S={S} H={H} KH={KH} hd={hd} window={window} "
                    f"softcap={cap:2.0f} causal={causal} {dtype}", a, b,
                    dtype)
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


SSM_UPDATE_CASES = [  # label, B, nh, hp, N, live rows (decode shapes)
    ("granite-4.0-h-small", 64, 128, 64, 128, 64),
    ("granite-4.0-h-small", 64, 128, 64, 128, 6),
    ("mamba2-370m", 16, 32, 64, 128, 11),
    ("hymba-1.5b", 16, 50, 64, 16, 11),
]


def ssm_update_case(torch, *, B, nh, hp, N, live, seed):
    """Inputs of one Mamba-2 decode update on the card, float32: state
    (B, nh, hp, N), x, dt post-softplus, A negative, Bm/Cm, D, and keep
    True on ``live`` rows spread over the batch."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    keep = torch.zeros(B, dtype=torch.bool, device="cuda")
    keep[torch.randperm(B, generator=g, device="cuda")[:live]] = True
    return dict(state=0.5 * randn(B, nh, hp, N), x=randn(B, nh, hp),
                dt=torch.nn.functional.softplus(randn(B, nh)),
                A=-torch.exp(0.3 * randn(nh)), Bm=randn(B, N),
                Cm=randn(B, N), D=randn(nh), keep=keep)


def ssm_update_bound(case):
    """Bytes: each live row's state read and written once, its x, dt, B
    and C read, keep, A and D read, y written for every row; 5 float32
    operations a live state element."""
    B, nh, hp, N = case["state"].shape
    live = int(case["keep"].sum())
    nbytes = 4 * (live * nh * (2 * hp * N + hp + 1) + 2 * live * N
                  + B * nh * hp + 2 * nh) + B
    return bound_ms(nbytes, 5 * live * nh * hp * N, "float32")


def phase_ssm_update(torch):
    """``ssm_state_update`` against its plain version at the decode shapes
    of ``SSM_UPDATE_CASES``: inactive rows' state bit for bit and their y
    0, live rows' state within 1e-6 and y within 1e-5 of scale; then each
    case timed as CUDA graphs of 30 calls (kernel, plain, kernel) beside
    its bound. Returns (the worst error at granite-4.0-h-small's shape
    with every row live, that case's timing row)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_state_update as upd
    worst, first = 0.0, None
    for i, (label, B, nh, hp, N, live) in enumerate(SSM_UPDATE_CASES):
        case = ssm_update_case(torch, B=B, nh=nh, hp=hp, N=N, live=live,
                               seed=40 + i)
        keep = case["keep"]
        before = case["state"].clone()
        args = dict(case, state=before.clone())
        got = upd.ssm_state_update(**case)
        want = ref.ssm_state_update_ref(**args)
        torch.cuda.synchronize()
        dead = ~keep
        if not (torch.equal(case["state"][dead], before[dead])
                and bool((got[dead] == 0).all())):
            fail(f"ssm_state_update {label}: an inactive row's state moved "
                 f"or its y is not 0")
        errs = [float((a[keep] - b[keep]).abs().max())
                / max(1.0, float(b[keep].abs().max()))
                for a, b in ((case["state"], args["state"]), (got, want))]
        shape = f"B={B} ({live} live) nh={nh} hp={hp} N={N} float32"
        log(f"[check] {'ssm_state_update':30s} {label} {shape}: "
            f"|kernel-plain| / scale: state {errs[0]:.3e} (tol 1e-6), y "
            f"{errs[1]:.3e} (tol 1e-5); inactive rows bit-equal")
        if errs[0] > 1e-6 or errs[1] > 1e-5:
            fail(f"ssm_state_update disagrees with its plain version "
                 f"({label}, {shape}): {errs}")
        if i == 0:
            worst = max(errs)
        ms = time_graph_ms(torch, lambda: upd.ssm_state_update(**case))
        plain_ms = time_ms(torch, lambda: ref.ssm_state_update_ref(**case),
                           iters=5)
        ms2 = time_graph_ms(torch, lambda: upd.ssm_state_update(**case))
        b_ms, by = ssm_update_bound(case)
        log(f"[time] {'ssm_state_update[' + label + ']':40s} {shape}: "
            f"kernel {ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library none, bound {b_ms:.4f} ms ({by}), "
            f"{100 * b_ms / min(ms, ms2):.1f}% of bound")
        if first is None:
            first = dict(ms=min(ms, ms2), plain_ms=plain_ms, library_ms=None,
                         bound_ms=b_ms, bound_by=by)
        del case, args, before, got, want
    return worst, first


#: the dropless MoE layers of the benchmark's cells: arch, capacity factor
MOE_MODELS = {"granite-4.0-h-small": ("granite-4.0-h-small", 7.2),
              "olmoe-1b-7b": ("olmoe-1b-7b", 8.0)}
MOE_CASES = [  # model, rows, positions a row, tokens that hold one, timed,
    # dtype of the hidden states and the experts
    ("granite-4.0-h-small", 64, 1, 1, False, "bfloat16"),
    ("granite-4.0-h-small", 64, 1, 3, True, "bfloat16"),
    ("granite-4.0-h-small", 64, 1, 6, True, "bfloat16"),
    ("granite-4.0-h-small", 64, 1, 64, False, "bfloat16"),
    ("granite-4.0-h-small", 64, 64, 100, True, "bfloat16"),
    ("granite-4.0-h-small", 16, 256, 4096, False, "bfloat16"),
    ("olmoe-1b-7b", 64, 1, 1, False, "bfloat16"),
    ("olmoe-1b-7b", 64, 1, 6, False, "bfloat16"),
    ("olmoe-1b-7b", 64, 1, 14, True, "bfloat16"),
    ("olmoe-1b-7b", 64, 1, 64, False, "bfloat16"),
    ("olmoe-1b-7b", 64, 64, 100, True, "bfloat16"),
    ("olmoe-1b-7b", 16, 256, 4096, False, "bfloat16"),
    ("olmoe-1b-7b", 64, 1, 14, False, "float32"),
    ("olmoe-1b-7b", 64, 64, 100, False, "float32"),
]
#: |kernel - plain| over the largest |plain| of the live entries' rows, by
#: dtype: in bf16 the two round the activation once each, from float32 sums
#: taken in another order, so an element a rounding apart can differ by one
#: bf16 step; in float32 only the order of the sums differs
MOE_TOL = {"bfloat16": 2e-3, "float32": 1e-5}


def moe_mutants(torch, args):
    """The plain version with a fault the kernel could make, for the
    error a wrong kernel reads against ``MOE_TOL``: the last 64 of the
    gate+up reduction dropped (a K stage), the last 64 of the down
    reduction dropped, and every entry run through the next expert."""
    from repro_torch.kernels import ref
    hf, wg, wu, wd, *rest = args

    def cut(w):
        w = w.clone()
        w[:, -64:] = 0
        return w

    return {"gate+up K stage": ref.moe_experts_ref(hf, cut(wg), cut(wu), wd,
                                                    *rest),
            "down K stage": ref.moe_experts_ref(hf, wg, wu, cut(wd), *rest),
            "next expert": ref.moe_experts_ref(
                hf, *(torch.roll(w, 1, dims=0) for w in (wg, wu, wd)),
                *rest)}


def moe_layer(torch, arch, seed):
    """(config, weights) of one MoE layer at full width on the card: the
    router float32 N(0, 1/d), the experts bf16 N(0, 1/fan_in); without
    granite-4.0-h's shared expert, which the routed path leaves alone."""
    import types
    from repro_torch.config import get_config
    name, cf = MOE_MODELS[arch]
    cfg = dataclasses.replace(get_config(name), capacity_factor=cf,
                              shared_expert_ff=0)
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape, fan_in, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda")
                * fan_in ** -0.5).to(dtype)

    p = types.SimpleNamespace(
        moe_router=draw(d, E, fan_in=d, dtype=torch.float32),
        moe_w_gate=draw(E, d, ff, fan_in=d), moe_w_up=draw(E, d, ff, fan_in=d),
        moe_w_down=draw(E, ff, d, fan_in=ff))
    return cfg, p


def moe_case(torch, cfg, B, S, n_live, seed):
    """Hidden states (B, S, d) bf16 and the live mask: at S = 1 ``n_live``
    rows spread over the batch, else every third row holding a prefix of
    S/4 to S positions (seeded), until ``n_live`` tokens are placed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn((B, S, cfg.d_model), generator=g,
                    device="cuda").to(torch.bfloat16)
    live = torch.zeros((B, S), dtype=torch.bool, device="cuda")
    if S == 1:
        live[torch.randperm(B, generator=g, device="cuda")[:n_live], 0] = True
        return h, live
    rng = random.Random(seed)
    left, rows = n_live, [b for s in range(3) for b in range(s, B, 3)]
    for b in rows:
        n = min(left, S if n_live == B * S else rng.randint(S // 4, S))
        live[b, :n] = True
        left -= n
        if not left:
            break
    return h, live


def moe_bound(cfg, hit, n_entries):
    """Bytes: the hit experts' three weight matrices read once, each live
    entry's token row read and its float32 output row written, its
    activation row written and read back; operations: the three products
    over the live entries."""
    d, ff = cfg.d_model, cfg.d_ff
    nbytes = hit * 3 * d * ff * 2 + n_entries * (2 * d + 4 * d + 4 * ff)
    return bound_ms(nbytes, 6 * n_entries * d * ff, "bfloat16")


def phase_moe_experts(torch):
    """``moe_experts`` (the grouped expert kernel of a dropless MoE call)
    against its plain version at the decode and prefill shapes of
    ``MOE_CASES`` (granite-4.0-h-small and olmoe-1b-7b at full width,
    bf16, and olmoe's float32 body): live entries' rows within
    ``MOE_TOL`` of their largest value, where each of ``moe_mutants``
    must read above it; then ``moe_mlp`` with
    the live mask: dead positions exactly 0, live ones within 2e-2 of the
    sort dispatch over the live tokens alone; no host sync under
    ``torch.cuda.set_sync_debug_mode("error")``; a captured CUDA graph's
    replay bit-equal to the eager call; the launch count and the
    experts-read tally against a host count. The timed cases run as CUDA
    graphs of 30 calls (kernel, plain, kernel) beside their bound (the hit
    experts' weight bytes), the plain version and the three ``torch.bmm``
    over the sort dispatch's dense (E, C, d) buffer. Returns (the worst
    error, the first timed case's row)."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import moe_experts as kmoe
    from repro_torch.models import moe as moe_mod
    worst, first, layers = 0.0, None, {}
    # one side stream for every case: each new stream that runs a matmul
    # keeps a cuBLAS workspace of its own for the rest of the process
    side = torch.cuda.Stream()
    for i, (arch, B, S, n_live, timed, dtype) in enumerate(MOE_CASES):
        if (arch, dtype) not in layers:
            layers.clear()
            gc.collect()
            torch.cuda.empty_cache()
            cfg, p = moe_layer(torch, arch, 60)
            for name in ("moe_w_gate", "moe_w_up", "moe_w_down"):
                setattr(p, name, getattr(p, name).to(getattr(torch, dtype)))
            layers[arch, dtype] = cfg, p
        cfg, p = layers[arch, dtype]
        E, k = cfg.num_experts, cfg.experts_per_token
        h, live = moe_case(torch, cfg, B, S, n_live, seed=70 + i)
        h = h.to(getattr(torch, dtype))
        T = B * S
        hf, lf = h.reshape(T, -1), live.reshape(T)
        top_p, top_i, _ = moe_mod.route(cfg, p.moe_router, hf)
        entry, offsets = moe_mod.group(cfg, top_i, lf)
        weight = top_p.reshape(-1)
        args = (hf, p.moe_w_gate, p.moe_w_up, p.moe_w_down, entry, offsets,
                weight, k)
        tally = kmoe.tally(h.device)
        tally.zero_()
        before = build.launches["moe_experts"]
        got = kmoe.moe_experts(*args)
        torch.cuda.synchronize()
        read, offered = tally.tolist()
        hit = len(set(top_i[lf].flatten().tolist()))
        if build.launches["moe_experts"] != before + 1 or (read, offered) \
                != (hit, E):
            fail(f"moe_experts {arch} {B}x{S}: launches "
                 f"{build.launches['moe_experts'] - before}, tally "
                 f"{read}/{offered} against {hit} hit experts of {E}")
        want = ref.moe_experts_ref(*args)
        rows = entry[:int(offsets[E])].long()
        scale = float(want[rows].abs().max())

        def rel(a):
            return float((a[rows] - want[rows]).abs().max()) / scale

        err, tol = rel(got), MOE_TOL[dtype]
        worst = max(worst, err)
        shape = (f"{arch} {B}x{S} {dtype}, {n_live} live, {hit} of {E} "
                 f"experts hit, top {k}, d {cfg.d_model}, ff {cfg.d_ff}")
        wrong = {name: rel(y) for name, y in moe_mutants(torch, args).items()}
        log(f"[check] {'moe_experts':30s} {shape}: |kernel-plain| / "
            f"max|plain| {err:.3e} (tol {tol:g}; max|plain| {scale:.4g}); "
            f"a wrong kernel: " + ", ".join(f"{n} {v:.3e}"
                                            for n, v in wrong.items())
            + f"; tally {read}/{offered}")
        if not err <= tol:
            fail(f"moe_experts disagrees with its plain version ({shape}): "
                 f"{err}")
        if not min(wrong.values()) > tol:
            fail(f"moe_experts' tolerance {tol} passes a wrong kernel "
                 f"({shape}): {wrong}")

        torch.cuda.set_sync_debug_mode("error")
        try:
            y, _ = moe_mod.moe_mlp(cfg, p, h, live=live)
        except RuntimeError as e:
            fail(f"moe_mlp synchronised with the host at {B} x {S}: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        old, _ = moe_mod.moe_tokens(cfg, p, hf[lf])
        dead_zero = bool((y[~live] == 0).all())
        gap = float((y[live].float() - old.float()).abs().max()) / max(
            1.0, float(old.float().abs().max()))
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            moe_mod.moe_mlp(cfg, p, h, live=live)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gy, _ = moe_mod.moe_mlp(cfg, p, h, live=live)
        graph.replay()
        torch.cuda.synchronize()
        same = torch.equal(gy, y)
        del graph
        log(f"[check] {'moe_mlp(live)':30s} {shape}: dead positions 0 "
            f"{dead_zero}, |live - sort dispatch of the live tokens| / "
            f"scale {gap:.3e} (tol 2e-2), graph replay bit-equal {same}, "
            f"no host sync")
        if not (dead_zero and gap <= 2e-2 and same):
            fail(f"moe_mlp with a live mask ({shape}): dead 0 {dead_zero}, "
                 f"gap {gap}, graph equal {same}")
        if timed:
            ms = time_graph_ms(torch, lambda: kmoe.moe_experts(*args))
            plain_ms = time_ms(torch, lambda: ref.moe_experts_ref(*args),
                               iters=3, warmup=1)
            xe = hf.new_zeros((E, moe_mod.expert_capacity(cfg, T),
                               cfg.d_model))
            lib_ms = time_graph_ms(torch, lambda: moe_mod.experts(p, xe),
                                   iters=10, warmup=2)
            del xe
            ms2 = time_graph_ms(torch, lambda: kmoe.moe_experts(*args))
            b_ms, by = moe_bound(cfg, hit, int(offsets[E]))
            log(f"[time] {'moe_experts[' + arch + ']':40s} {shape}: kernel "
                f"{ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"(3 bmm over the dense buffer) {lib_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({by}), {100 * b_ms / min(ms, ms2):.1f}% of "
                f"bound")
            if first is None:
                first = dict(ms=min(ms, ms2), plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=by)
        del h, live, got, want, y, old, gy
    layers.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return worst, first


def check_slot(torch, dec, ref, case, window, cap, dtype, label):
    """``decode_attention`` on a ``slot_case`` (an int8 one with its scales)
    against its plain version; returns (max error, the kernel's output).
    An int8 case is named ``decode_attention_int8``."""
    args = [case[n] for n in SLOT_ARGS]
    scales = {n: case[n] for n in ("k_scale", "v_scale") if n in case}
    got = dec.decode_attention(*args, window=window, softcap=cap, **scales)
    want = ref.decode_attention_ref(*args, window=window, softcap=cap,
                                    **scales)
    torch.cuda.synchronize()
    name = "decode_attention_int8" if scales else "decode_attention"
    return compare(name, label, got, want, dtype), got


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
    ("gemma3-1b", 128, 1152, 512, 10, "bfloat16", True),   # decode_32k rows
    ("hymba-1.5b", 128, 1600, 512, 10, "bfloat16", True),
    ("mamba2-370m", 128, 1024, 512, 10, "bfloat16", True),
    ("whisper-tiny", 128, 384, 512, 10, "float32", True),
]


def phase_check(torch):
    """Every kernel against its plain version on the same inputs; returns
    the worst error of each at the shapes its row in the JSON line times."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import paged_decode_attention as paged
    from repro_torch.kernels import probe, ref
    worst = dict.fromkeys(("paged_decode_attention",
                           "paged_decode_attention_multi",
                           "decode_attention", "decode_attention_int8",
                           "probe_update"), 0.0)
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
             tuple(b for b in range(16) if b not in (5, 6))),
            ("paligemma-3b", 512, 16, 64, (3, 11))):   # prefix + chunk
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
    for int8, cases in ((False, SLOT_CASES), (True, SLOT_INT8_CASES)):
        for arch, H, KH, hd, M, window, cap in cases:
            for dtype in ("float32", "bfloat16"):
                seed += 1
                case = slot_case(torch, B=16, H=H, KH=KH, hd=hd, M=M,
                                 window=window, dtype=dtype, seed=seed,
                                 inactive=(3, 11), int8=int8)
                wrapped = int((case["q_pos"] >= M).sum())
                label = (f"{arch:17s} {dtype:8s} M={M} window={window} "
                         f"softcap={cap:2.0f} ({wrapped} rows wrapped)")
                if int8:
                    label = f"{label} int8 K/V, split=%d" % decode_split(
                        "decode_attention", dtype, int8=True, B=16, H=H,
                        KH=KH, hd=hd, M=M)
                err, got = check_slot(torch, dec, ref, case, window, cap,
                                      dtype, label)
                if float(got[[3, 11]].float().abs().max()) != 0.0:
                    fail("decode_attention: inactive rows are not zero")
                if window and not wrapped:
                    fail("decode_attention: no ring row wrapped")
                if dtype == "bfloat16" and arch.startswith(
                        "qwen" if int8 else "gemma2"):
                    name = "decode_attention_int8" if int8 else \
                        "decode_attention"
                    worst[name] = max(worst[name], err)
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


def decode_split(kernel, dtype, int8=False, **shape):
    """The CTAs per (KV head, sequence) row that ``kernel``
    (``decode_attention`` or ``paged_decode_attention``) launches for these
    sizes: its C library's ``<kernel>_split`` entry, which sizes the
    cluster exactly as the launch does (``int8``: over an int8 slot
    cache). Fails on a CUDA error."""
    import ctypes
    from repro_torch.kernels import build
    names = (("B", "H", "KH", "hd", "M") if kernel == "decode_attention"
             else ("B", "H", "KH", "hd", "ps", "pmax"))
    entry = f"{kernel}_split"
    lib = build.bind(kernel, {entry: [ctypes.c_int] * (1 + len(names))})
    n = getattr(lib, entry)((1 if dtype == "bfloat16" else 0) + 2 * int8,
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
    (one rounding), ``decode_attention`` also over int8 caches with either
    query type, inactive rows exactly 0. B=1 takes the largest split; each
    case logs the split its launch used."""
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
        for dtype, int8 in (("float32", False), ("bfloat16", False),
                            ("float32", True), ("bfloat16", True)):
            seed += 1
            ns = decode_split("decode_attention", dtype, int8=int8, B=B, H=H,
                              KH=KH, hd=hd, M=M)
            largest = max(largest, ns)
            lens = (edge_lengths(ns, 16, B, M) if lengths == "edges"
                    else lengths)
            case = slot_case(torch, B=B, H=H, KH=KH, hd=hd, M=M,
                             window=window, dtype=dtype, seed=seed,
                             inactive=inactive, lengths=lens, int8=int8)
            _, got = check_slot(
                torch, dec, ref, case, window, cap, dtype,
                f"{label:30s} {dtype:8s}{' int8 K/V' * int8} B={B} "
                f"split={ns} lengths={list(lens)[:8]}")
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
    ("paged_decode_attention[olmoe-1b-7b,serve]", "paged",
     ("olmoe-1b-7b", 28, True)),
    ("decode_attention[olmoe-1b-7b,serve]", "slot",
     (16, 16, 128, 449, 0, 0.0, 300)),
    ("decode_attention[whisper-tiny,serve]", "slot",
     (6, 6, 64, 449, 0, 0.0, 300)),
    ("decode_attention_int8[qwen1.5-32b,serve]", "slot_int8",
     (40, 40, 128, 449, 0, 0.0, 300)),
]


def decode_timed_case(torch, kind, spec):
    """Inputs of a DECODE_TIMED row: (wrapper arguments, window, softcap,
    shape text, library call, bound); the text names the split the launch
    uses."""
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
        shape += " split=%d" % decode_split(
            "paged_decode_attention", "bfloat16", B=16, H=H, KH=KH, hd=hd,
            ps=16, pmax=pmax)
        return (args, 0, 0.0, shape, paged_library_call(torch, case),
                paged_bound(case, "bfloat16"))
    H, KH, hd, M, window, cap, length = spec
    int8 = kind == "slot_int8"
    case = slot_case(torch, B=16, H=H, KH=KH, hd=hd, M=M, window=window,
                     dtype="bfloat16", seed=7, lengths=[length] * 16,
                     int8=int8)
    shape = (f"B=16 H={H} KH={KH} hd={hd} M={M} window={window} "
             f"softcap={cap:2.0f} bf16{' q, int8 K/V' * int8}, {length} "
             f"positions a row")
    shape += " split=%d" % decode_split(
        "decode_attention", "bfloat16", int8=int8, B=16, H=H, KH=KH, hd=hd,
        M=M)
    args = [case[n] for n in SLOT_ARGS]
    if int8:
        args += [case["k_scale"], case["v_scale"]]
    return (args, window, cap, shape, slot_library_call(case, window),
            slot_bound(case, window, "bfloat16"))


def ssd_timed_case(torch, spec):
    """Inputs (bf16) and shape text of an SSD_TIMED row."""
    B, L, nh, N, carried = spec
    case = ssd_case(torch, B=B, L=L, nh=nh, hp=64, N=N, dtype="bfloat16",
                    seed=12, decay=0.05)
    if not carried:
        del case["init_state"]
    return case, (f"B={B} L={L} nh={nh} hp=64 N={N} chunk=128 bf16, "
                  + ("initial state" if carried else "zero initial state"))


PROBE_TIMED = {"probe_update[gemma2-9b]": 16,  # label: rows (d 3584)
               "probe_update[gemma2-9b,B=1]": 1}


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
            scales = dict(zip(("k_scale", "v_scale"), args[5:]))
            kfn = lambda: dec.decode_attention(  # noqa: E731
                *args[:5], window=window, softcap=cap, **scales)
            pfn = lambda: ref.decode_attention_ref(  # noqa: E731
                *args[:5], window=window, softcap=cap, **scales)
        row(label, shape, kfn, pfn, lib, bound, timer=time_graph_ms,
            plain_timer=time_ms)

    for arch, T in (("granite-3-8b", 8), ("granite-3-8b", 256),
                    ("gemma2-9b", 8), ("olmoe-1b-7b", 256),
                    ("paligemma-3b", 512)):
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
            plain_iters=5 if T >= 256 else 20)

    from repro_torch.kernels import flash_attention as fa
    for arch, (B, S, H, KH, hd, window, cap, causal) in FLASH_TIMED.items():
        q, k, v = flash_case(torch, B=B, S=S, H=H, KH=KH, hd=hd,
                             dtype="bfloat16", seed=11)
        row(f"flash_attention[{arch}]", f"B={B} S={S} H={H} KH={KH} "
            f"hd={hd} window={window} softcap={cap:2.0f} "
            f"{'causal' if causal else 'non-causal'} bf16",
            lambda: fa.flash_attention(q, k, v, causal=causal, window=window,
                                       softcap=cap),
            lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window, softcap=cap),
            flash_library_call(q, k, v, causal),
            flash_bound(q, k, window, "bfloat16", causal),
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


def _model_pair(arch, seed, kv_quant=False):
    """The float32 smoke model on the card and the same weights on the CPU
    (``kv_quant``: with int8 slot caches)."""
    from repro_torch.config import get_smoke_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              kv_quant=kv_quant)
    gpu = Model(cfg, device="cuda").init(seed=seed)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    return cfg, gpu, cpu


REFERENCE_CASES = (("granite-3-8b", "paged"), ("gemma2-9b", "contig"),
                   ("gemma2-9b", "paged"), ("mamba2-370m", "contig"),
                   ("mamba2-370m", "paged"), ("hymba-1.5b", "contig"),
                   ("hymba-1.5b", "paged"))


def _int8_payloads(torch, cache):
    """The int8 K/V leaves of a ``kv_quant`` cache, on the CPU."""
    return [sub[leaf].cpu() for key, run in cache.items()
            if key.startswith("run_") for sub in run if "k_scale" in sub
            for leaf in ("k", "v")]


def phase_reference(torch, cases=REFERENCE_CASES, kv_quant=False):
    """Smoke configs in float32: the model on the card (kernels) against
    the same weights on the CPU (plain versions). gemma2-smoke's and
    hymba-smoke's window is 16: the prompts (24 tokens, then 20 more) wrap
    the rings in a chunk. Row 1 of the first chunk is padded and row 3
    sits out the megastep, so the SSM configs also check that padding and
    inactive rows leave the recurrent state alone on both devices, and
    olmoe-smoke (``phase_serve_moe``) that its padded and idle rows take
    expert capacity alike on both.

    ``kv_quant``: int8 slot caches. The card's float32 K/V differ from
    the CPU's in their last bits, so a value on a rounding tie may be
    stored one int8 step apart; the int8 payloads are compared, and where
    any element differs the logits and probe outputs are held to 1e-3
    (one step moves them by up to ~6e-4 at smoke size) in place of 1e-4.
    Greedy tokens stay exactly equal."""
    for arch, layout in cases:
        cfg, gpu, cpu = _model_pair(arch, seed=7, kv_quant=kv_quant)
        g = torch.Generator().manual_seed(7)
        chunks = [torch.randint(1, cfg.vocab_size, (4, w), generator=g,
                                dtype=torch.int32) for w in (24, 20)]
        pages = torch.randperm(16, generator=g, dtype=torch.int32) + 1
        valid = torch.ones((4, 24), dtype=torch.bool)
        valid[1, 20:] = False
        budget = torch.tensor([6, 3, 6, 0], dtype=torch.int32)
        out, payloads = {}, {}
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
            payloads[dev] = _int8_payloads(torch, cache)
        torch.cuda.synchronize()
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(out["cuda"], out["cpu"])]
        apart = sum(int((a != b).sum())
                    for a, b in zip(payloads["cuda"], payloads["cpu"]))
        tol = 1e-4 if apart == 0 else 1e-3
        quant = (f", int8 payloads: {apart} of "
                 f"{sum(a.numel() for a in payloads['cpu'])} element(s) "
                 f"one step apart (tol {tol:.0e})" if kv_quant else "")
        log(f"[reference] {cfg.name} f32 {layout}, card vs CPU: logits "
            f"{errs[0]:.2e}, tap_sum {errs[1]:.2e}, probe probs "
            f"{errs[3]:.2e}, tokens equal "
            f"{bool(torch.equal(out['cuda'][2], out['cpu'][2]))}, n_emitted "
            f"{out['cuda'][4].tolist()}{quant}")
        if kv_quant and not payloads["cpu"]:
            fail(f"{cfg.name}: kv_quant left no int8 cache")
        if any(int((a.int() - b.int()).abs().max()) > 1
               for a, b in zip(payloads["cuda"], payloads["cpu"])):
            fail(f"{cfg.name}: int8 payloads more than one step apart")
        if not (errs[0] <= tol and errs[1] <= 1e-3 and errs[3] <= tol):
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
    decode_multi, prefill_chunk = model.decode_multi, model.prefill_chunk

    def counted(*args, **kwargs):
        # a megastep is k decode steps, replayed from a CUDA graph after
        # its first call: count them here, not in decode_step's Python
        steps[0] += kwargs.get("k", 1)
        return decode_multi(*args, **kwargs)

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

    model.decode_multi, model.prefill_chunk = counted, counted_prefill
    pred.on_prefill, pred.on_token = (watch(pred.on_prefill),
                                      watch(pred.on_token))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    model.decode_graph.counts.take()
    t0 = time.perf_counter()
    stats = run_policy(cfg, "trail", reqs, predictor=pred, model=model,
                       device="cuda", **knobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    graph = model.decode_graph.counts.take()
    del model.decode_multi, model.prefill_chunk, pred.on_prefill, \
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
    log(f"[serve] decode megasteps: {graph['captures']} captured as a CUDA "
        f"graph, {graph['replays']} replayed from one")
    if len(stats.latencies) != len(reqs) or len(served) != len(reqs):
        fail("not every request finished")
    _check_requests(torch, cfg, served.values())
    return launches, steps[0], steps[1]


def _load(torch, arch, **fields):
    """The full-size ``arch`` on the card, random weights from seed 0, with
    the config ``fields`` replaced (``kv_quant=True``: int8 slot caches),
    and its probe predictor."""
    from repro_torch.config import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch), **fields)
    free = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    ssm = (f", SSM {nh} heads of {cfg.ssm_head_dim}, state "
           f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}" if cfg.ssm_state else "")
    if cfg.num_experts:
        ssm += (f", {cfg.num_experts} experts top {cfg.experts_per_token} "
                f"(capacity factor {cfg.capacity_factor})")
    if cfg.num_encoder_layers:
        ssm += (f", encoder {cfg.num_encoder_layers} layers over "
                f"{cfg.encoder_seq} frames")
    if cfg.num_prefix_tokens:
        ssm += f", {cfg.num_prefix_tokens} prefix positions"
    if cfg.kv_quant:
        ssm += ", int8 KV cache (kv_quant)"
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, window {cfg.sliding_window}"
        f"{ssm}; {n_params / 1e9:.2f} B params (matmul weights bf16) "
        f"initialised in {time.perf_counter() - t0:.1f} s, {free / 2**30:.2f} "
        f"GiB of device memory free before")
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
    model.decode_graph.counts.take()
    t0 = time.perf_counter()
    stats = router.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    graph = model.decode_graph.counts.take()
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
    log(f"[cluster] {label}: kernel launches {launches}; decode "
        f"megasteps {graph['captures']} captured as a CUDA graph (the "
        f"replicas share one model and its one graph), {graph['replays']} "
        f"replayed")
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
    profile its taps, train the probe on them and serve with that probe.
    Returns the training run's launch counts."""
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
    through ``decode_attention`` in every attention layer; then the tap
    harvest (no probe is trained on it: the weights are random, and the
    probe trainer runs on granite's and trail-llama's taps). Returns the
    serve's launches."""
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
        f"prefill chunks of {n_ssm} SSM layers; ssm_state_update "
        f"{launches['ssm_state_update']} times and decode_attention "
        f"{launches['decode_attention']} times in {steps} decode steps of "
        f"{n_ssm} SSM and {n_attn} attention layers")
    if not chunks or launches["ssd_scan"] != n_ssm * chunks:
        fail(f"ssd_scan ran {launches['ssd_scan']} times for {chunks} "
             f"prefill chunks of {n_ssm} SSM layers")
    if not steps or launches["ssm_state_update"] != n_ssm * steps:
        fail(f"ssm_state_update ran {launches['ssm_state_update']} times "
             f"for {steps} decode steps of {n_ssm} SSM layers")
    if launches["decode_attention"] != n_attn * steps:
        fail(f"decode_attention ran {launches['decode_attention']} times "
             f"for {steps} decode steps of {n_attn} attention layers")
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
    del model, params
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


WHISPER_ROWS = 16          # encoder rows of phase_serve_whisper's parity


def phase_serve_whisper(torch):
    """whisper-tiny at full width and depth (4 encoder and 4 decoder
    layers, d_model 384, 6/6 heads of 64, 1500 frames, vocab 51865).

    (a) float32 on the card against the same weights on the CPU, under
    the contiguous and then the paged layout (self-attention K/V in pages,
    the cross caches per slot beside them):
    ``prefill_chunk(enc_embeds=...)`` over 16 x 1500 frames made with numpy
    (seed 0), which encodes them (``flash_attention`` non-causal on the
    card) and fills the cross caches, one row padded; then a megastep of
    8 decode steps with an inactive row. Greedy tokens equal; logits,
    probe posteriors and the cross caches within 1e-4. ``encode`` and
    ``build_cross_cache`` called alone on the card give the prefill's
    cross caches bit for bit.
    (b) serve granite's 12 requests through ``run_policy(mode="real",
    policy="trail", probe_interval=4, max_batch=16)`` with bf16 matmul
    weights, contiguous and then paged (no page retention, as in the
    reference); the engine passes no frame embeddings (as the
    reference's), so the decoder reads the zeroed cross caches of
    ``init_cache``: 12 of 12 finished each, ``decode_attention`` and then
    both paged kernels launched.
    (c) one ``forward_train`` and backward with frame embeddings at 8 x
    448 tokens on float32 masters: ``flash_attention`` non-causal once
    per encoder layer, causal twice per decoder layer (the remat
    recompute), a finite loss and gradients.
    Returns the serve's launches."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    cfg = get_config("whisper-tiny")
    f32 = dataclasses.replace(cfg, dtype="float32")
    gpu = Model(f32, device="cuda").init(seed=1)
    cpu = Model(f32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(0)
    B = WHISPER_ROWS
    enc = torch.from_numpy(rng.standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (B, 32)).astype(np.int32))
    valid = torch.ones((B, 32), dtype=torch.bool)
    valid[1, 20:] = False
    active = torch.ones(B, dtype=torch.bool)
    active[3] = False
    # (layout, launches a decode step per layer: the self-attention kernel)
    for layout, step_kernel in (("contig", "decode_attention"),
                                ("paged", "paged_decode_attention")):
        out, walls = {}, {}
        for where, m in (("card", gpu), ("CPU", cpu)):
            dev = m.device
            cache = m.init_cache(B, 64, kv_layout=layout, page_size=16)
            if layout == "paged":           # each row's 4 pages in order
                cache["block_table"].copy_(torch.arange(
                    1, 1 + 4 * B, dtype=torch.int32).reshape(B, 4))
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            logits, cache, _, _ = m.prefill_chunk(
                cache, tokens.to(dev), valid.to(dev), enc_embeds=enc.to(dev))
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            toks, cache, probs, _ = m.decode_multi(cache, tok,
                                                   active.to(dev), k=8)
            torch.cuda.synchronize()
            walls[where] = time.perf_counter() - t0
            sub = cache["run_0"][0]
            out[where] = [x.cpu() for x in (logits, probs, sub["ck"],
                                            sub["cv"], toks)]
            if where == "card":
                launches = dict(ops.launches)
                with torch.no_grad():
                    alone = gpu.build_cross_cache(gpu.init_cache(B, 64),
                                                  gpu.encode(enc.to(dev)))
                if not (torch.equal(alone["run_0"][0]["ck"], sub["ck"])
                        and torch.equal(alone["run_0"][0]["cv"],
                                        sub["cv"])):
                    fail("whisper-tiny: encode + build_cross_cache differ "
                         "from prefill_chunk(enc_embeds=...)'s cross caches")
                del alone
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(out["card"][:4], out["CPU"][:4])]
        same = bool(torch.equal(out["card"][4], out["CPU"][4]))
        log(f"[whisper] f32 {layout} card vs CPU, {B} x {cfg.encoder_seq} "
            f"frames, a 32-token chunk and 8 decode steps: logits "
            f"{errs[0]:.2e}, probe probs {errs[1]:.2e}, ck {errs[2]:.2e}, "
            f"cv {errs[3]:.2e}, tokens equal {same}; wall card "
            f"{walls['card']:.2f} s, CPU {walls['CPU']:.2f} s; card "
            f"launches {launches}")
        if max(errs) > 1e-4 or not same:
            fail(f"whisper-tiny {layout} on the card disagrees with the "
                 f"CPU: {errs}, tokens equal {same}")
        if launches["flash_attention"] != cfg.num_encoder_layers:
            fail("whisper-tiny: the encoder did not run flash_attention once "
                 "a layer")
        if launches[step_kernel] != 8 * cfg.num_layers:
            fail(f"whisper-tiny {layout}: {step_kernel} did not run once a "
                 f"layer a step")
        if (layout == "paged"
                and launches["paged_decode_attention_multi"]
                != cfg.num_layers):
            fail("whisper-tiny paged: the prefill chunk did not run "
                 "paged_decode_attention_multi once a layer")
        del out, cache
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()

    cfg, model, pred = _load(torch, "whisper-tiny")
    reqs = _requests(cfg, 12, 0)
    max_len = _max_len(reqs)
    _describe(reqs, max_len)
    served = {}
    for layout, kernels in (("contig", ("decode_attention",)),
                            ("paged", ("paged_decode_attention",
                                       "paged_decode_attention_multi"))):
        knobs = dict(mode="real", kv_layout=layout, probe_interval=4,
                     max_batch=16, max_len=max_len, page_size=16)
        served[layout], *_ = _serve(torch, cfg, model, reqs, knobs, pred)
        for name in kernels:
            if served[layout][name] <= 0:
                fail(f"kernel {name} never launched on whisper's {layout} "
                     f"path")
    launches = served["contig"]

    masters = model.init_params(seed=0)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (8, 448)))
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    batch = {"tokens": tokens.cuda(), "labels": labels.cuda(),
             "enc_embeds": torch.from_numpy(rng.standard_normal(
                 (8, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).cuda()}
    calls = {True: 0, False: 0}
    real = ops.flash_attention

    def counted(q, k, v, *, causal=True, **kw):
        calls[causal] += 1
        return real(q, k, v, causal=causal, **kw)

    live = {k: v.requires_grad_() for k, v in masters.items()}
    ops.flash_attention = counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        loss, aux = torch.func.functional_call(model, live, (batch,))
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ops.flash_attention = real
    train = dict(ops.launches)
    finite = all(g is None or bool(torch.isfinite(g).all()) for g in grads)
    log(f"[whisper] forward_train + backward, 8 x 448 tokens over 8 x "
        f"{cfg.encoder_seq} frames: loss {float(loss.detach()):.4f}, "
        f"gradients finite {finite}, wall {wall:.3f} s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"flash_attention non-causal {calls[False]}, causal {calls[True]} "
        f"(launches {train})")
    if not (math.isfinite(float(loss.detach())) and finite):
        fail("whisper-tiny: non-finite training loss or gradient")
    if (calls[False] != cfg.num_encoder_layers
            or calls[True] != 2 * cfg.num_layers
            or train["flash_attention"] != sum(calls.values())):
        fail(f"whisper-tiny training: flash_attention calls {calls}, "
             f"launches {train}")
    return launches


def phase_serve_moe(torch):
    """olmoe-1b-7b at full width and depth (16 layers, d_model 2048, 16/16
    heads of 128, 64 experts top 8 with d_ff 1024, vocab 50304; random
    weights from seed 0, matmul weights in bf16) at its benchmark's
    dropless capacity factor (``MOE_MODELS``): serve granite's 12
    requests paged (both paged kernels) and contiguous
    (``decode_attention``), 12 of 12 each, every call of every MoE layer,
    decode step or prefill chunk, through ``moe_experts``; check that
    ``moe_mlp`` makes no host synchronisation
    (``torch.cuda.set_sync_debug_mode("error")``) at a decode step's and a
    prefill chunk's shape, with and without the live mask; then
    olmoe-smoke in float32 on the card against the CPU
    (``phase_reference``; at its capacity factor of 1.25 a call of 4
    tokens or fewer is dropless, so the kernel's float32 body runs).
    Returns the launches of the two serves."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import MOE_KINDS
    cfg, model, pred = _load(torch, "olmoe-1b-7b",
                             capacity_factor=MOE_MODELS["olmoe-1b-7b"][1])
    n_moe = sum(k in MOE_KINDS for k in cfg.layer_kinds)
    reqs = _requests(cfg, 12, 0)
    max_len = _max_len(reqs)
    _describe(reqs, max_len)
    served = {}
    for layout, kernels in (("paged", ("paged_decode_attention",
                                       "paged_decode_attention_multi")),
                            ("contig", ("decode_attention",))):
        knobs = dict(mode="real", kv_layout=layout, probe_interval=4,
                     max_batch=16, max_len=max_len, page_size=16)
        served[layout], steps, chunks = _serve(torch, cfg, model, reqs,
                                               knobs, pred)
        for name in kernels:
            if served[layout][name] <= 0:
                fail(f"kernel {name} never launched on olmoe's {layout} "
                     f"path")
        ran = served[layout]["moe_experts"]
        log(f"[serve] moe_experts ran {ran} times in {steps} decode steps "
            f"and {chunks} prefill chunks of {n_moe} MoE layers")
        if not steps or not chunks or ran != n_moe * (steps + chunks):
            fail(f"moe_experts ran {ran} times for {steps} decode steps and "
                 f"{chunks} prefill chunks of {n_moe} MoE layers on olmoe's "
                 f"{layout} path")
        gc.collect()
        torch.cuda.empty_cache()

    g = torch.Generator(device="cuda").manual_seed(4)
    for (B, S), masked in itertools.product(((16, 1), (16, 256)),
                                            (False, True)):
        h = torch.randn(B, S, cfg.d_model, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        live = torch.rand(B, S, generator=g, device="cuda") < 0.5 \
            if masked else None
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe_mod.moe_mlp(cfg, model.layers[0], h, live=live)
        except RuntimeError as e:
            fail(f"moe_mlp synchronised with the host at {B} x {S}: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ok = bool(torch.isfinite(y).all()) and math.isfinite(float(aux))
        log(f"[moe] moe_mlp at {B} x {S} tokens (capacity "
            f"{moe_mod.expert_capacity(cfg, B * S)} an expert, live mask "
            f"{masked}): no host sync under set_sync_debug_mode('error'), "
            f"finite {ok}")
        if not ok:
            fail("moe_mlp: non-finite output")

    del model, pred
    gc.collect()
    torch.cuda.empty_cache()
    phase_reference(torch, (("olmoe-1b-7b", "paged"),
                            ("olmoe-1b-7b", "contig")))
    return served


def phase_serve_qwen_int8(torch):
    """qwen1.5-32b with ``kv_quant=True`` at full width and depth (64
    layers, d_model 5120, 40/40 heads of 128, d_ff 27392, vocab 152064;
    random weights from seed 0, matmul weights bf16, the embedding and
    unembedding float32): 68.5 GiB of weights, so only an int8 cache
    leaves room for 16 rows and a prefill chunk's transients.

    First ``qwen-smoke`` in float32 with ``kv_quant`` on the card against
    the CPU (``phase_reference``); then granite's 12 requests served
    contiguous (``probe_interval=4``, ``max_batch=16``): 12 of 12, every
    decode step through the int8 ``decode_attention`` (64 launches a
    step, no float launch), peak memory and the cache's bytes in int8
    against bf16 at the run's ``max_len`` logged. Returns the serve's
    launches."""
    from repro_torch.serving.kv_cache import bytes_for_context
    phase_reference(torch, (("qwen1.5-32b", "contig"),), kv_quant=True)
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, pred = _load(torch, "qwen1.5-32b", kv_quant=True)
    reqs = _requests(cfg, 12, 0)
    max_len = _max_len(reqs)
    _describe(reqs, max_len)
    rows = 16
    q8 = bytes_for_context(cfg, max_len)
    bf = bytes_for_context(dataclasses.replace(cfg, kv_quant=False), max_len)
    log(f"[qwen-int8] KV bytes a request at max_len {max_len}: int8 "
        f"{q8 / 2**20:.2f} MiB, bf16 {bf / 2**20:.2f} MiB; {rows} rows: "
        f"{rows * q8 / 2**30:.2f} GiB against {rows * bf / 2**30:.2f} GiB; "
        f"weights {sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30:.2f} GiB, "
        f"card {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}"
        f" GiB")
    knobs = dict(mode="real", kv_layout="contig", probe_interval=4,
                 max_batch=rows, max_len=max_len)
    launches, steps, chunks = _serve(torch, cfg, model, reqs, knobs, pred)
    log(f"[qwen-int8] served {rows} rows at most; decode_attention over "
        f"int8 launched {launches['decode_attention_int8']} times in "
        f"{steps} decode steps ({cfg.num_layers} layers)")
    if launches["decode_attention_int8"] <= 0:
        fail("kernel decode_attention (int8) never launched on qwen's path")
    if (launches["decode_attention_int8"] != cfg.num_layers * steps
            or launches["decode_attention"]):
        fail(f"qwen1.5-32b int8: decode launches {launches} for {steps} "
             f"steps")
    del model, pred
    gc.collect()
    torch.cuda.empty_cache()
    return launches


PREFIX_ROWS = 4         # rows of phase_prefix's prefix chunk and training


def _prefix_chunk(torch, model, kv_layout, prefix, tokens, steps):
    """``prefill_chunk(prefix_embeds=...)`` then ``steps`` greedy decode
    steps under ``kv_layout`` (paged: each row's pages in order), on the
    model's device; returns (first logits, decode logits, tokens, launch
    counts of the run)."""
    from repro_torch.kernels import ops
    B = tokens.shape[0]
    T = prefix.shape[1] + tokens.shape[1] + steps
    cache = model.init_cache(B, T, kv_layout=kv_layout, page_size=16)
    if kv_layout == "paged":
        n = cache["block_table"].shape[1]
        cache["block_table"].copy_(torch.arange(
            1, 1 + B * n, dtype=torch.int32).reshape(B, n))
    dev = model.device
    torch.cuda.synchronize()
    ops.reset_launches()
    first, cache, _, _ = model.prefill_chunk(cache, tokens.to(dev),
                                             prefix_embeds=prefix.to(dev))
    tok = first.argmax(-1).to(torch.int32)[:, None]
    toks = [tok]
    for _ in range(steps):
        logits, cache, _, _ = model.decode_step(cache, tok)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
    torch.cuda.synchronize()
    return (first.cpu(), logits.cpu(), torch.cat(toks, 1).cpu(),
            dict(ops.launches))


def phase_prefix(torch):
    """paligemma-3b at full width and depth (18 layers, d_model 2048, 8
    query heads over one KV head of 256, 256 prefix positions, vocab
    257216; random weights from seed 0).

    (a) granite's 12 requests served paged and contiguous: the engine
    passes no prefix embeddings (as the reference's), so the served model
    is text only; 12 of 12, the paged kernels, then ``decode_attention``,
    launched. (b) ``prefill_chunk`` with a seeded 256-row bf16 prefix
    before a 256-token chunk (T = 512 rows a sequence in the multi-query
    kernel, G = 8 over one KV head of 256), then 4 decode steps, under
    both layouts: finite logits, every layer's kernels launched. (c) one
    ``forward_train`` with ``prefix_embeds`` at 4 x (256 + 256) under
    inference mode: one ``flash_attention`` launch a layer at S = 512, a
    finite loss over 4 x 255 labels. (d) ``paligemma-smoke`` in float32
    with a 16-row prefix on the card against the CPU under both layouts:
    logits within 1e-4, greedy tokens equal. Returns the launches of the
    two serves."""
    import numpy as np
    from repro_torch.kernels import ops
    cfg, model, pred = _load(torch, "paligemma-3b")
    reqs = _requests(cfg, 12, 0)
    max_len = _max_len(reqs)
    _describe(reqs, max_len)
    served = {}
    for layout, kernels in (("paged", ("paged_decode_attention",
                                       "paged_decode_attention_multi")),
                            ("contig", ("decode_attention",))):
        knobs = dict(mode="real", kv_layout=layout, probe_interval=4,
                     max_batch=16, max_len=max_len, page_size=16)
        served[layout], *_ = _serve(torch, cfg, model, reqs, knobs, pred)
        for name in kernels:
            if served[layout][name] <= 0:
                fail(f"kernel {name} never launched on paligemma's {layout} "
                     f"path")
        gc.collect()
        torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    B, P = PREFIX_ROWS, cfg.num_prefix_tokens
    prefix = torch.from_numpy(rng.standard_normal(
        (B, P, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, 256)))
    for layout, want in (("paged", {"paged_decode_attention_multi": 1,
                                    "paged_decode_attention": 4}),
                         ("contig", {"decode_attention": 4})):
        t0 = time.perf_counter()
        first, last, toks, launched = _prefix_chunk(torch, model, layout,
                                                    prefix, tokens, 4)
        wall = time.perf_counter() - t0
        log(f"[prefix] {cfg.name} {layout}: prefill_chunk with a {B} x {P} "
            f"bf16 prefix before {B} x 256 tokens, then 4 decode steps: "
            f"wall {wall:.3f} s, logits finite "
            f"{bool(torch.isfinite(first).all() and torch.isfinite(last).all())}"
            f", tokens {toks[0].tolist()}, launches {launched}")
        if not (torch.isfinite(first).all() and torch.isfinite(last).all()):
            fail(f"{cfg.name} {layout}: non-finite logits after a prefix")
        for name, per_layer in want.items():
            if launched[name] != per_layer * cfg.num_layers:
                fail(f"{cfg.name} {layout} prefix chunk: {name} launched "
                     f"{launched[name]} times")
        gc.collect()
        torch.cuda.empty_cache()

    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    batch = {"tokens": tokens.cuda(), "labels": labels.cuda(),
             "prefix_embeds": prefix.cuda()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        loss, aux = model.forward_train(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash = ops.launches["flash_attention"]
    log(f"[prefix] {cfg.name} forward_train {B} x ({P} + 256) with "
        f"prefix_embeds: loss {float(loss):.4f} over {int(aux['n_tok'])} "
        f"labels, tap {tuple(aux['tap'].shape)}, wall {wall:.3f} s, "
        f"flash_attention launches {flash}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if flash != cfg.num_layers or int(aux["n_tok"]) != B * 255:
        fail(f"{cfg.name} forward_train with a prefix: {flash} flash "
             f"launches, {int(aux['n_tok'])} labels")
    if not (math.isfinite(float(loss)) and torch.isfinite(aux["tap"]).all()):
        fail(f"{cfg.name} forward_train with a prefix: non-finite")
    del model, pred, batch, aux
    gc.collect()
    torch.cuda.empty_cache()

    _, gpu, cpu = _model_pair("paligemma-3b", seed=3)
    scfg = gpu.cfg
    prefix = torch.from_numpy(rng.standard_normal(
        (3, scfg.num_prefix_tokens, scfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(1, scfg.vocab_size, (3, 24)))
    for layout in ("paged", "contig"):
        card = _prefix_chunk(torch, gpu, layout, prefix, tokens, 6)
        host = _prefix_chunk(torch, cpu, layout, prefix, tokens, 6)
        errs = [float((a - b).abs().max()) for a, b in zip(card[:2],
                                                           host[:2])]
        same = bool(torch.equal(card[2], host[2]))
        log(f"[prefix] {scfg.name} f32 {layout} with a 3 x "
            f"{scfg.num_prefix_tokens} prefix, card vs CPU: logits "
            f"{errs[0]:.2e} (prefill), {errs[1]:.2e} (6th decode step), "
            f"tokens equal {same}")
        if max(errs) > 1e-4 or not same:
            fail(f"{scfg.name} {layout} with a prefix: the card disagrees "
                 f"with the CPU: {errs}, tokens equal {same}")
    return served


DRYRUN_FIT = 0.9       # share of the card's memory a decode case must fit
DRYRUN_STEPS = 3       # timed serve steps per card case, after one warm-up
DRYRUN_TIMED = (("gemma3-1b", "long_500k"),    # cases whose global layer is
                ("whisper-tiny", "decode_32k"))  # timed beside SDPA
DRYRUN_KERNELS = ("decode_attention", "probe_update")


def _fill_cache(torch, cache, S, seed):
    """A contiguous cache as after S - 1 tokens of every row: each slot
    layer's K/V (and cross K/V) random bf16, its ``kpos`` the positions
    the row holds (a global row 0..S-2 at slot p, a ring its last M
    positions at slot p % M; the sink slot -1), ``lengths`` S - 1. SSM
    states stay zero, as after a reset: their size is the same either
    way."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_tok = S - 1
    for key, subs in cache.items():
        if not key.startswith("run_"):
            continue
        for sub in subs:
            for name, leaf in sub.items():
                if name == "kpos":
                    M = leaf.shape[2] - 1
                    pos = torch.arange(max(0, n_tok - M), n_tok,
                                       dtype=torch.int32, device="cuda")
                    leaf.fill_(-1)
                    leaf[:, :, pos % M] = pos
                elif name in ("k", "v", "ck", "cv"):
                    leaf.normal_(generator=g)
    cache["lengths"].fill_(n_tok)


@contextlib.contextmanager
def recorded_calls(ops, names):
    """Within the block each call of ``ops.<name>`` for ``names`` runs as
    before, and the first call of each kind (the name, the shapes of its
    tensors, its other options: a global and a ring layer are two kinds)
    is kept with its result. Yields the dict kind -> (args, kwargs,
    result)."""
    calls = {}
    saved = {n: getattr(ops, n) for n in names}

    def kind(x):
        return tuple(x.shape) if hasattr(x, "shape") else x

    def recorder(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            key = (name, tuple(map(kind, args)),
                   tuple((k, kind(v)) for k, v in sorted(kwargs.items())))
            calls.setdefault(key, (args, kwargs, out))
            return out
        return call

    for name, fn in saved.items():
        setattr(ops, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def check_recorded(ref, calls, label):
    """Each recorded kernel call (``recorded_calls``) against its plain
    version on the same inputs: ``decode_attention`` by ``compare`` (one
    rounding of the output), ``probe_update`` within ``PROBE_TOL``."""
    for (name, _, _), (args, kwargs, got) in calls.items():
        if name == "decode_attention":
            want = ref.decode_attention_ref(*args, **kwargs)
            B, M = args[1].shape[:2]
            window = kwargs["window"]
            compare(name, f"{label} B={B}, {M} slots"
                    + (f", window {window}" if window else "")
                    + f", max|plain| {float(want.abs().max()):.2e}", got,
                    want, str(got.dtype).removeprefix("torch."))
        else:
            want = ref.probe_update_ref(*args, **kwargs)
            errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
            B, d = args[0].shape
            log(f"[check] {name:30s} {label} B={B} d={d}: max|kernel-plain| "
                f"q_new {errs[0]:.3e}, p {errs[1]:.3e} (tol {PROBE_TOL:.0e})")
            if max(errs) > PROBE_TOL:
                fail(f"{name} disagrees with its plain version ({label}, "
                     f"B={B}): {errs}")
        del want


def time_global_layer(torch, cfg, calls, label, S):
    """One global layer's recorded ``decode_attention`` call over its full
    S + 1-slot rows, timed with CUDA events: kernel, plain version,
    ``scaled_dot_product_attention`` with the same mask
    (``slot_library_call``), kernel again, beside its bound."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref
    rows = [c for (name, _, _), c in calls.items()
            if name == "decode_attention" and c[0][1].shape[1] == S + 1]
    if not rows:
        fail(f"{label}: no global layer of {S + 1} slots was recorded")
    args, kwargs, _ = rows[0]
    case = dict(zip(SLOT_ARGS, args))
    B = args[0].shape[0]
    b_ms, by = slot_bound(case, kwargs["window"], "bfloat16")
    ms = time_ms(torch, lambda: dec.decode_attention(*args, **kwargs))
    plain_ms = time_ms(torch, lambda: ref.decode_attention_ref(
        *args, **kwargs), iters=3, warmup=1)
    lib = slot_library_call(case, kwargs["window"])
    library_ms = time_ms(torch, lib, iters=10)
    del lib
    ms2 = time_ms(torch, lambda: dec.decode_attention(*args, **kwargs))
    split = decode_split("decode_attention", "bfloat16", B=B,
                         H=cfg.num_heads, KH=cfg.num_kv_heads,
                         hd=cfg.head_dim, M=S + 1)
    log(f"[time] decode_attention {label}, {S + 1} slots, B={B}: kernel "
        f"{ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms (kernel/library "
        f"{min(ms, ms2) / library_ms:.2f}), bound {b_ms:.4f} ms ({by}), "
        f"{100 * b_ms / min(ms, ms2):.1f}% of it; split {split} CTAs a "
        f"(row, KV head), {B * cfg.num_kv_heads} rows")


def dryrun_card_case(torch, rep, seed=0):
    """One decode case the dry run says fits, on the card: the model with
    random weights, its cache full (``_fill_cache``), ``make_serve_step``
    once to warm up and ``DRYRUN_STEPS`` timed steps (``lengths`` reset to
    S - 1 before each, so every step reads its whole context); the peak
    against the prediction, the step against the H100 ``memory_s``
    bound, the launches; then one more step whose ``DRYRUN_KERNELS``
    calls are recorded, each kind held against its plain version on the
    same inputs (every layer kind of ``decode_attention`` at the case's B
    and row length, and ``probe_update`` at its B), and one
    ``decode_step`` for the logits. For the ``DRYRUN_TIMED`` cases one
    global layer is timed (``time_global_layer``). Returns a summary."""
    from repro_torch.config import INPUT_SHAPES, KIND_SSM, get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.model import Model
    arch, shape = rep["arch"], rep["shape"]
    cfg = get_config(arch)
    B, S = INPUT_SHAPES[shape].global_batch, INPUT_SHAPES[shape].seq_len
    k = cfg.probe.num_bins
    try:
        model = Model(cfg, device="cuda").init(seed=seed)
        cache = model.init_cache(B, S)
        _fill_cache(torch, cache, S, seed)
        g = torch.Generator(device="cuda").manual_seed(seed)
        tokens = torch.randint(1, cfg.vocab_size, (B, 1), generator=g,
                               device="cuda", dtype=torch.int32)
        q_prev = torch.full((B, k), 1.0 / k, device="cuda")
        step = make_serve_step(model)

        def one_step():
            cache["lengths"].fill_(S - 1)
            return step(cache, tokens, q_prev)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        times = []
        for _ in range(1 + DRYRUN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, q_new, pred = one_step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        launches = dict(ops.launches)
        with recorded_calls(ops, DRYRUN_KERNELS) as calls:
            one_step()
        cache["lengths"].fill_(S - 1)
        logits = model.decode_step(cache, tokens)[0]
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        fail(f"dry run: {arch} {shape} fits by the dry run but ran out of "
             f"memory on the card: {e}")
    if not (torch.isfinite(logits).all() and torch.isfinite(q_new).all()
            and torch.isfinite(pred).all()):
        fail(f"dry run: {arch} {shape}: non-finite logits or posterior")
    n_attn = sum(kind != KIND_SSM for kind in cfg.layer_kinds)
    steps = 1 + DRYRUN_STEPS
    if (launches["decode_attention"] != n_attn * steps
            or launches["probe_update"] != steps):
        fail(f"dry run: {arch} {shape}: launches {launches} in {steps} "
             f"serve steps ({n_attn} attention layers)")
    kinds = sorted((name, c[0][1].shape[1] if name == "decode_attention"
                    else None) for (name, _, _), c in calls.items())
    if len({name for name, _ in kinds}) != (1 + (n_attn > 0)):
        fail(f"dry run: {arch} {shape}: recorded kernel calls {kinds}")
    predicted = rep["memory"]["peak_per_device_gb"] * 1e9
    bound = rep["roofline"]["memory_s"] * 1e3
    ms = sorted(times[1:])[len(times[1:]) // 2]
    log(f"[dryrun-card] {arch} {shape} B={B} S={S}: peak predicted "
        f"{predicted / 2**30:.3f} GiB, measured {peak / 2**30:.3f} GiB "
        f"(ratio {peak / predicted:.3f}); step {ms:.3f} ms (median of "
        f"{DRYRUN_STEPS}; {', '.join(f'{t:.3f}' for t in times[1:])}; "
        f"warm-up {times[0]:.1f}) against the H100 memory_s bound "
        f"{bound:.3f} ms (share {bound / ms:.3f}); launches in {steps} steps: "
        f"decode_attention {launches['decode_attention']}, probe_update "
        f"{launches['probe_update']}")
    check_recorded(ref, calls, f"{arch} {shape}")
    if (arch, shape) in DRYRUN_TIMED:
        time_global_layer(torch, cfg, calls, f"{arch} {shape}", S)
    del model, cache, logits, calls
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=arch, shape=shape, predicted=predicted, peak=peak,
                ms=ms, bound_ms=bound)


def phase_dryrun(torch):
    """The dry run for one H100 (``repro_torch.launch.dryrun``, in a
    process a CPU on meta tensors) over every architecture and
    input shape: a line per case, none may fail. Then every decode case
    whose predicted peak fits in ``DRYRUN_FIT`` of the card's memory runs
    on the card (``dryrun_card_case``). Prefill and train cases stay
    meta-only, as in the reference."""
    from repro_torch.config import ARCH_IDS, INPUT_SHAPES
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    reports = dryrun.run_cases([(a, s) for a in ARCH_IDS
                                for s in INPUT_SHAPES], "h100")
    for rep in reports:
        log(f"[dryrun] {dryrun.summary(rep)}")
    failed = [f"{r['arch']} {r['shape']}" for r in reports if "error" in r]
    if failed:
        fail(f"dry run: {len(failed)} case(s) failed: {failed}")
    t_meta = time.perf_counter() - t0
    room = DRYRUN_FIT * torch.cuda.get_device_properties(0).total_memory
    fits = [r for r in reports if r["mode"] == "decode" and "memory" in r
            and r["memory"]["peak_per_device_gb"] * 1e9 <= room]
    log(f"[dryrun] {len(reports)} cases in {t_meta:.1f} s on meta; "
        f"{len(fits)} decode cases fit {room / 2**30:.2f} GiB: "
        f"{[(r['arch'], r['shape']) for r in fits]}")
    if not fits:
        fail("dry run: no decode case fits the card")
    run = {(r["arch"], r["shape"]) for r in fits}
    if not set(DRYRUN_TIMED) <= run:
        fail(f"dry run: the timed cases {DRYRUN_TIMED} do not all fit")
    for rep in fits:
        dryrun_card_case(torch, rep)
    log(f"[dryrun] phase took {time.perf_counter() - t0:.1f} s "
        f"({t_meta:.1f} s on meta)")


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
    return launches


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
    phase_build()
    worst = phase_check(torch)
    worst["flash_attention"] = phase_check_flash(torch)
    worst["ssd_scan"] = phase_check_ssd(torch)
    worst["ssm_state_update"], ssm_update_row = phase_ssm_update(torch)
    worst["moe_experts"], moe_row = phase_moe_experts(torch)
    phase_check_split(torch)
    rows = phase_time(torch)
    phase_reference(torch)
    phase_reference_train(torch)
    granite = phase_serve_granite(torch)
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, pred = _load(torch, "gemma2-9b")
    gemma2 = phase_serve_gemma2(torch, cfg, model, pred)
    step_launches = phase_serve_step(torch, cfg, model)
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
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_whisper(torch)
    gc.collect()
    torch.cuda.empty_cache()
    moe_served = phase_serve_moe(torch)
    gc.collect()
    torch.cuda.empty_cache()
    phase_prefix(torch)
    gc.collect()
    torch.cuda.empty_cache()
    qwen = phase_serve_qwen_int8(torch)
    gc.collect()
    torch.cuda.empty_cache()
    phase_dryrun(torch)

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
            ("decode_attention_int8",
             "decode_attention_int8[qwen1.5-32b,serve]",
             "decode_attention.cu", "decode_attention.py:71", qwen),
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
    kernels.append(dict(
        name="ssm_state_update", route="cuda",
        source="src/repro_torch/kernels/csrc/ssm_state_update.cu",
        replaces=None, launches=mamba2["ssm_state_update"],
        max_abs_err=worst["ssm_state_update"], **ssm_update_row))
    kernels.append(dict(
        name="moe_experts", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_experts.cu",
        replaces=None, launches=moe_served["paged"]["moe_experts"],
        max_abs_err=worst["moe_experts"], **moe_row))
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
