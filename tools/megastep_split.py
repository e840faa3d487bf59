"""Split one decode megastep of a benchmark cell by the program's detail
spans, and time it as the engine runs it.

    python3 tools/megastep_split.py --workload NAME --seed N [--live 6 16]

from the root of a checkout, on a machine with the card the cell asks for.
It sets up the cell as ``bench/run.py`` does (weights from ``--seed``,
model, engine, warm-up), then for each ``--live`` count submits that many
requests (prompts of 44 random tokens, the traffic's median, and outputs
long enough to outlast the measurement) and steps the engine until every
one of them decodes. Then:

- ``graph_ms``: ``--steps`` megasteps as the engine runs them (replayed
  from the CUDA graph), each timed with CUDA events around
  ``decode_multi``; the median and every reading;
- ``split_ms``: one megastep run eagerly (``Model._megastep``, which the
  graph captures) under ``torch.profiler`` with the detail spans on; the
  device time of each activity goes to the innermost span open at the
  runtime call that started it (the profiler's correlation ids), summed
  by span name; ``busy_ms`` the union of those activities, ``activities``
  their number, ``launches`` the kernel bindings' counts;
- ``experts_read``: the grouped MoE kernel's tally
  (``metrics.counters.take_expert_reads``) over the prefill chunks that
  took the requests in (``prefill_chunk``) and over the replayed
  megasteps (``megastep``): the experts whose weights were read, E a
  call, and their ratio (``share``); nothing where no call ran it.

Each ``--live`` count prints one JSON line.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "bench"))

if __name__ == "__main__":
    import run  # noqa: F401  the entry's caches and path, before torch

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

import devtrace  # noqa: E402
import harness  # noqa: E402
import spantrace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PROMPT = 44


def _reads(counts: dict) -> dict:
    return {**counts, "share": (counts["read"] / counts["offered"]
                                if counts["offered"] else None)}


def _submit(run, n: int, rng) -> dict:
    """Submit ``n`` requests and step until each decodes; returns the
    experts-read tally of the prefill chunks that took them in."""
    from repro_torch.metrics import counters
    from repro_torch.serving.request import Request
    eng, model = run.eng, run.model
    out = 2 * eng.ecfg.probe_interval * 64
    reqs = []
    for i in range(n):
        r = Request(rid=10_000 + i, arrival=eng.now,
                    prompt=[rng.randrange(1, run.vocab)
                            for _ in range(PROMPT)],
                    true_out_len=out, max_new_tokens=out)
        eng.submit(r)
        reqs.append(r)
    orig = model.prefill_chunk
    prefill = {"read": 0, "offered": 0}

    def counted(*a, **k):
        counters.take_expert_reads()
        res = orig(*a, **k)
        for key, v in counters.take_expert_reads().items():
            prefill[key] += v
        return res

    model.prefill_chunk = counted
    try:
        while not all(len(r.generated) > eng.ecfg.probe_interval
                      for r in reqs):
            eng.step()
    finally:
        del model.prefill_chunk
    return _reads(prefill)


def _graph_ms(run, steps: int) -> list:
    model, eng = run.model, run.eng
    orig = model.decode_multi
    times = []

    def timed(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(*a, **k)
        e1.record()
        times.append((e0, e1))
        return out

    model.decode_multi = timed
    try:
        for _ in range(steps):
            eng.step()
    finally:
        del model.decode_multi
    torch.cuda.synchronize()
    return [e0.elapsed_time(e1) for e0, e1 in times]


def _split(run) -> dict:
    from repro_torch.kernels import build
    from repro_torch.metrics import spans
    model, eng = run.model, run.eng

    def eager(cache, tokens, active=None, budget=None, *, k=1, eos_id=-1):
        # the range ends once the device has run what the megastep launched
        with torch.profiler.record_function("bench.step"):
            out = model._megastep(cache, tokens, active, budget, k, eos_id)
            torch.cuda.synchronize()
        return out

    model.decode_multi = eager
    before = dict(build.launches)
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    spans.set_level(spans.DETAIL)
    try:
        with prof:
            eng.step()
            torch.cuda.synchronize()
    finally:
        spans.set_level(spans.OFF)
        spans.take()
        del model.decode_multi
    launches = {n: c - before[n] for n, c in build.launches.items()
                if c != before[n]}
    tl = spantrace.SpanTimeline(prof)
    segs = tl._segments()
    seg_starts = [a for a, _, _ in segs]
    owner = {}
    for t, c in tl.calls:
        i = bisect.bisect_right(seg_starts, t) - 1
        if i >= 0 and t < segs[i][1]:
            owner[c] = segs[i][2]
    split: dict[str, float] = {}
    mine = []
    for (_, a, b), c in zip(tl.device, tl.device_corr):
        name = owner.get(c)
        if name is None:
            continue
        split[name] = split.get(name, 0.0) + 1e3 * (b - a)
        mine.append((a, b))
    busy = sum(b - a for a, b in devtrace._union(mine))
    return {"split_ms": dict(sorted(split.items(), key=lambda kv: -kv[1])),
            "busy_ms": 1e3 * busy, "activities": len(mine),
            "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--live", type=int, nargs="+", default=[6])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    run = harness.Run(cell, args.seed, 51.0, False, time.perf_counter())
    run.setup()
    rng = random.Random(f"{args.seed}:split")
    from repro_torch.metrics import counters
    for live in args.live:
        prefill = _submit(run, live, rng)
        counters.take_expert_reads()
        graph = _graph_ms(run, args.steps)
        megastep = _reads(counters.take_expert_reads())
        line = {"workload": args.workload, "seed": args.seed, "live": live,
                "graph_ms": statistics.median(graph),
                "graph_ms_all": graph, **_split(run),
                "experts_read": {"prefill_chunk": prefill,
                                 "megastep": megastep},
                "device": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        run.new_engine()
    run.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
