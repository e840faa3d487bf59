#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card, end to end, and check it.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero; nothing is passed over):

1. report the device (name, count, ``nvidia-smi`` name and power limit);
   with no CUDA device, fail;
2. build every CUDA kernel from the sources in this checkout (one ``nvcc``
   per source, all at once) and print what ptxas reports;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes of ``granite-3-8b`` and ``trail-llama`` in float32 and
   bfloat16, with scrambled block tables, null pages, inactive
   (q_pos = -1) rows and a logit softcap. Tolerances, per element:
   float32 |kernel - plain| <= 1e-5; bfloat16 at most 2e-2 and at most
   one bf16 rounding of the output, 2**-7 * |plain| + 1e-4 (both versions
   compute in float32 and round once);
4. time each kernel at the serving path's shapes with CUDA events, beside
   its plain version, the least time the card could take (its bound) and
   one PyTorch library call computing the same attention as a yardstick;
5. hold the model on the card against the same weights on the CPU
   (``granite-smoke`` in float32: greedy tokens equal, logits within 1e-4);
6. serve ``granite-3-8b`` at full width (40 layers, random weights from a
   seed) through ``run_policy(mode="real", kv_layout="paged",
   policy="trail", probe_interval=4)`` with the probe predictor, with
   every kernel launch count set to 0 just before and read just after;
   check that every request finished, both kernels ran, and nothing is
   NaN; then step a short second run and check ``lengths == _kv_written``
   after every engine step;
7. profile one decode megastep and one prefill chunk of the served model
   (device busy share and the kernels that take the time).

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. The engine's own latencies come from
its cost model (a TPU v5e preset) and are not printed as card times: the
serve phase reports host wall time around work that ends in
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM memory rate
PEAK_OPS = {"bfloat16": 989e12,     # dense bf16 tensor-core rate
            "float32": 67e12}       # float32 outside the tensor cores
TOL = {"float32": 1e-5, "bfloat16": 2e-2}        # max |kernel - plain|
ROUNDING = {"float32": None, "bfloat16": (2.0 ** -7, 1e-4)}   # (rel, abs)


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# kernel inputs, bound and timing
# ---------------------------------------------------------------------------

def paged_case(torch, *, B, T, H, KH, hd, ps, pmax, dtype, seed,
               inactive=(), all_active=False):
    """Random page pool with scrambled block tables (on the card).

    Each row holds a random length; its pages are a random permutation of
    the pool, unused table entries point at null page 0 (kpos -1). Query
    positions are the T trailing positions of each row (earlier than 0 ->
    -1); rows listed in ``inactive`` get q_pos = -1 throughout.
    ``all_active`` gives every row the full table instead.
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
    else:
        lengths = rng.integers(1, pmax * ps, size=B)
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


def bound(case, dtype):
    """Least card time for one call: (ms, "bytes" or "operations").

    Bytes: each input read once (the K/V/kpos of the pages the block
    tables reference, q, the tables, q_pos) and the output written once.
    Operations: 4*hd (QK^T and PV) per (query head, key) pair that the
    function computes: each query against each key of its row that the
    mask lets it see (kpos >= 0 and kpos <= q_pos; no window here), at the
    peak rate of the input type.
    """
    q, k, bt, qp = (case["q"], case["k_pages"], case["block_table"],
                    case["q_pos"])
    B, T, H, hd = q.shape
    ps, KH = k.shape[1], k.shape[2]
    el = q.element_size()
    pages = int((bt != 0).sum())
    nbytes = (pages * ps * (2 * KH * hd * el + 4) + 2 * q.numel() * el
              + bt.numel() * 4 + qp.numel() * 4)
    kpos = case["kpos_pages"][bt.long()].reshape(B, 1, -1)      # (B,1,M)
    qp = qp.reshape(B, T, 1)
    pairs = int(((kpos >= 0) & (kpos <= qp)).sum())
    ops = 4 * hd * H * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


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


def library_call(torch, case):
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


def ptxas_usage(report: str):
    """(kernel instance, "registers; spills") per entry function of an
    ``nvcc -Xptxas -v`` report."""
    import re
    kernel, spills = None, ""
    for line in report.splitlines():
        m = re.search(r"\d(paged_[a-z_]+_kernel)I(\w*?)EE+v", line)
        if m and "Compiling entry function" in line:
            args = re.findall(r"__nv_bfloat16|^f|\d+(?=E)",
                              m.group(2).replace("Li", "") + "E")
            args = [{"__nv_bfloat16": "bf16", "f": "f32"}.get(a, a)
                    for a in args]
            kernel = f"{m.group(1)}<{', '.join(args)}>"
        elif kernel and "spill" in line:
            spills = line.split(":", 1)[-1].strip()
        elif kernel and "registers" in line:
            yield kernel, f"{line.split(':', 1)[-1].strip()}; {spills}"
            kernel = None


SHAPES = {  # (H, KH, hd) of the two served architectures
    "granite-3-8b": (32, 8, 128),
    "trail-llama": (12, 4, 64),
}


def phase_check(torch):
    """Kernel vs plain version on the same inputs; returns max errors."""
    from repro_torch.kernels import paged_decode_attention as kern
    from repro_torch.kernels import ref
    worst = {"paged_decode_attention": 0.0,
             "paged_decode_attention_multi": 0.0}
    seed = 0
    for arch, (H, KH, hd) in SHAPES.items():
        for dtype in ("float32", "bfloat16"):
            for T, cap in ((1, 0.0), (1, 50.0), (8, 0.0), (8, 50.0),
                           (256, 0.0)):
                seed += 1
                case = paged_case(torch, B=16, T=T, H=H, KH=KH, hd=hd, ps=16,
                                  pmax=64, dtype=dtype, seed=seed,
                                  inactive=(3, 11))
                args = [case[n] for n in ("q", "k_pages", "v_pages",
                                          "kpos_pages", "block_table",
                                          "q_pos")]
                if T == 1:
                    name = "paged_decode_attention"
                    args[0], args[5] = args[0][:, 0].contiguous(), \
                        args[5][:, 0].contiguous()
                    got = kern.paged_decode_attention(*args, softcap=cap)
                    want = ref.paged_decode_attention_ref(*args, softcap=cap)
                else:
                    name = "paged_decode_attention_multi"
                    got = kern.paged_decode_attention_multi(*args,
                                                            softcap=cap)
                    want = ref.paged_decode_attention_multi_ref(*args,
                                                                softcap=cap)
                torch.cuda.synchronize()
                if got.dtype != want.dtype or got.shape != want.shape:
                    fail(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                         f"{want.dtype}{tuple(want.shape)}")
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                over = 0
                if ROUNDING[dtype] is not None:
                    rel, atol = ROUNDING[dtype]
                    over = int((diff > rel * want.float().abs() + atol).sum())
                zero_rows = float(got[[3, 11]].float().abs().max())
                log(f"[check] {name:30s} {arch:13s} {dtype:8s} T={T:3d} "
                    f"softcap={cap:4.0f}: max|kernel-plain|={err:.3e} "
                    f"(tol {TOL[dtype]:.0e}), {over} element(s) past one "
                    f"rounding; inactive rows max|.|={zero_rows:.1e}")
                if not err <= TOL[dtype] or over:
                    fail(f"{name} disagrees with its plain version: {err}, "
                         f"{over} element(s) past one bf16 rounding")
                if zero_rows != 0.0:
                    fail(f"{name}: inactive rows are not zero")
                if dtype == "bfloat16" and arch == "granite-3-8b":
                    worst[name] = max(worst[name], err)
    return worst


def phase_time(torch, worst):
    """Time each kernel at the serving path's granite shapes (bfloat16)."""
    from repro_torch.kernels import paged_decode_attention as kern
    from repro_torch.kernels import ref
    H, KH, hd = SHAPES["granite-3-8b"]
    rows = {}
    for name, T in (("paged_decode_attention", 1),
                    ("paged_decode_attention_multi", 8),
                    ("paged_decode_attention_multi", 256)):
        case = paged_case(torch, B=16, T=T, H=H, KH=KH, hd=hd, ps=16,
                          pmax=64, dtype="bfloat16", seed=100 + T,
                          all_active=True)
        args = [case[n] for n in ("q", "k_pages", "v_pages", "kpos_pages",
                                  "block_table", "q_pos")]
        if T == 1:
            args[0], args[5] = args[0][:, 0].contiguous(), \
                args[5][:, 0].contiguous()
            kfn = lambda: kern.paged_decode_attention(*args)  # noqa: E731
            pfn = lambda: ref.paged_decode_attention_ref(*args)  # noqa: E731
        else:
            kfn = lambda: kern.paged_decode_attention_multi(*args)  # noqa: E731
            pfn = lambda: ref.paged_decode_attention_multi_ref(*args)  # noqa: E731
        lib = library_call(torch, case)
        plain_ms = time_ms(torch, pfn, iters=5 if T == 256 else 20)
        ms = time_ms(torch, kfn)
        library_ms = time_ms(torch, lib, iters=10)
        ms2 = time_ms(torch, kfn)           # kernel, plain, ..., kernel
        bound_ms, by = bound(case, "bfloat16")
        label = f"{name}[T={T}]"
        log(f"[time] {label:36s} B=16 H=32 KH=8 hd=128 ps=16 pmax=64 bf16: "
            f"kernel {ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
            f"{100 * bound_ms / min(ms, ms2):.1f}% of bound")
        rows[label] = dict(ms=min(ms, ms2), plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=by)
    return rows


def phase_reference(torch):
    """granite-smoke in float32: the model on the card (kernels) against
    the same weights on the CPU (plain versions)."""
    from repro_torch.config import get_smoke_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"),
                              dtype="float32")
    gpu = Model(cfg, device="cuda").init(seed=7)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(1, cfg.vocab_size, (4, 24), generator=g,
                           dtype=torch.int32)
    valid = torch.ones((4, 24), dtype=torch.bool)
    valid[1, 20:] = False
    budget = torch.tensor([6, 3, 6, 0], dtype=torch.int32)
    out = {}
    for dev, m in (("cuda", gpu), ("cpu", cpu)):
        cache = m.init_cache(4, 64, page_size=16)
        table = torch.zeros_like(cache["block_table"])
        table[:, :2] = torch.tensor([[5, 2], [9, 1], [4, 12], [7, 3]])
        cache["block_table"].copy_(table)
        logits, cache, tap_sum, _ = m.prefill_chunk(cache, tokens.to(dev),
                                                    valid.to(dev))
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        toks, cache, probs, n = m.decode_multi(cache, tok, budget=budget.to(dev),
                                               k=6)
        out[dev] = [x.cpu() for x in (logits, tap_sum, toks, probs, n)]
    torch.cuda.synchronize()
    errs = [float((a.float() - b.float()).abs().max())
            for a, b in zip(out["cuda"], out["cpu"])]
    log(f"[reference] granite-smoke f32, card vs CPU: logits {errs[0]:.2e}, "
        f"tap_sum {errs[1]:.2e}, probe probs {errs[3]:.2e}, tokens equal "
        f"{bool(torch.equal(out['cuda'][2], out['cpu'][2]))}, n_emitted "
        f"{out['cuda'][4].tolist()}")
    if not (errs[0] <= 1e-4 and errs[1] <= 1e-3 and errs[3] <= 1e-4):
        fail(f"model on the card disagrees with the CPU: {errs}")
    if errs[2] != 0 or errs[4] != 0:
        fail("greedy tokens on the card differ from the CPU")


def phase_serve(torch):
    from repro_torch.config import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine, EngineConfig, run_policy
    from repro_torch.serving.predictors import ProbePredictor
    from repro_torch.serving.workload import WorkloadConfig, generate
    cfg = get_config("granite-3-8b")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; {n_params / 1e9:.2f} B params "
        f"(matmul weights bf16) initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    wc = WorkloadConfig(n_requests=12, request_rate=50.0, seed=0,
                        vocab=cfg.vocab_size, prompt_mean=256.0,
                        prompt_sigma=0.3, out_median=32.0, out_sigma=0.5,
                        max_out=64, min_out=8)
    reqs = generate(wc)
    max_len = 16 * -(-max(len(r.prompt) + r.max_new_tokens + 1
                          for r in reqs) // 16)
    knobs = dict(mode="real", kv_layout="paged", probe_interval=4,
                 max_batch=16, max_len=max_len, page_size=16)
    log(f"[serve] {len(reqs)} requests, prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, outputs "
        f"{min(r.true_out_len for r in reqs)}-"
        f"{max(r.true_out_len for r in reqs)} tokens; max_len {max_len}")
    pred = ProbePredictor(cfg.probe, probe_params=model.probe,
                          embed_table=model.embed)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    stats = run_policy(cfg, "trail", reqs, predictor=pred, model=model,
                       device="cuda", **knobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    out_tokens = sum(r.true_out_len for r in reqs)
    s = stats.summary()
    log(f"[serve] run_policy(trail, real, paged, probe_interval=4): "
        f"{len(stats.latencies)}/{len(reqs)} finished, {s['iterations']} "
        f"engine steps, {s['preemptions']} preemptions, "
        f"{s['prefilled_tokens']} prefilled tokens, {out_tokens} generated "
        f"tokens")
    log(f"[serve] wall {wall:.3f} s (host clock, ends in synchronize), "
        f"{out_tokens / wall:.1f} generated tokens/s, "
        f"{(out_tokens + s['prefilled_tokens']) / wall:.1f} tokens/s with "
        f"prefill, max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"[serve] kernel launches on the main path: {launches}")
    if len(stats.latencies) != len(reqs):
        fail("not every request finished")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} never launched on the main path")

    # a second, short run stepped by hand: the device lengths must equal
    # each live request's materialized KV after every step, and nothing
    # the model produced may be NaN
    reqs2 = generate(dataclasses.replace(wc, n_requests=5, seed=1))
    eng = Engine(cfg, EngineConfig(policy="trail", prefill_chunk=256, **knobs),
                 predictor=pred, model=model, device="cuda")
    for r in reqs2:
        eng.submit(r)
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        eng.pool.flush_resets()     # recycled slots' resets, as the next
        lengths = eng.pool.cache["lengths"].cpu().tolist()   # step would
        for r in reqs2:
            if r.slot >= 0 and not r.done:
                written = getattr(r, "_kv_written", 0)
                if lengths[r.slot] != written:
                    fail(f"lengths != _kv_written for rid {r.rid}: "
                         f"{lengths[r.slot]} vs {written}")
    for r in reqs2:
        if not r.done or len(r.generated) != min(r.true_out_len,
                                                 r.max_new_tokens):
            fail(f"rid {r.rid} did not finish with its tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            fail(f"rid {r.rid}: token out of range")
        if not torch.isfinite(torch.as_tensor(r.posterior)).all():
            fail(f"rid {r.rid}: non-finite probe posterior")
    for key, run in eng.pool.cache.items():
        if key.startswith("run_"):
            for sub in run:
                for leaf in ("pk", "pv"):
                    if not torch.isfinite(sub[leaf]).all():
                        fail(f"non-finite values in the KV pool ({key})")
    log(f"[serve] stepped run: {len(reqs2)} requests in {steps} steps, "
        f"lengths == _kv_written after every step, tokens in range, "
        f"posteriors and KV pool finite")
    return launches, model


def phase_profile(torch, model):
    """Where a step's time goes: one decode megastep (k=4, 16 rows at ~300
    tokens of context) and one prefill chunk (256 wide, 2 of 16 rows
    active) of the served model. Wall time is the median of three runs on
    the host clock, without the profiler; one run under ``torch.profiler``
    then gives the device busy time (the sum of the kernels' durations, one
    stream) and the kernels that take it. Busy over wall is the device's
    busy share; the rest of the wall time the device sits idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B, dev = 16, "cuda"
    cache = model.init_cache(B, 448, page_size=16)
    cache["block_table"].copy_(torch.arange(
        1, 1 + B * 28, dtype=torch.int32, device=dev).reshape(B, 28))
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
            log(f"[profile] {label}: wall {wall_us / 1e3:.3f} ms; the "
                f"profiler saw no device events (busy share not measured)")
            continue
        by_name: dict[str, float] = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
        busy = sum(by_name.values())
        log(f"[profile] {label}: wall {wall_us / 1e3:.3f} ms, device busy "
            f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
            f"{len(kernels)} kernel launches")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            log(f"[profile]   {100 * us / busy:5.1f}% {us / 1e3:8.3f} ms "
                f"{name[:90]}")


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
    rows = phase_time(torch, worst)
    phase_reference(torch)
    launches, model = phase_serve(torch)
    phase_profile(torch, model)

    kernels = []
    for kname, label, line in (
            ("paged_decode_attention", "paged_decode_attention[T=1]", 87),
            ("paged_decode_attention_multi",
             "paged_decode_attention_multi[T=256]", 179)):
        row = rows[label]
        kernels.append(dict(
            name=kname, route="cuda",
            source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            replaces=f"src/repro/kernels/paged_decode_attention.py:{line}",
            launches=launches[kname], max_abs_err=worst[kname],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
