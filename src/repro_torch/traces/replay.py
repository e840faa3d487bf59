"""Open-loop trace replay: turn a `Trace` into engine/router arrivals.

Two pieces:

* `requests_from_trace` materializes `Request` objects — deterministic
  prompt token content from the replay seed, arrival times rescaled by
  the `ReplayConfig` time-warp / rate-scale knobs. Same trace + same
  config → byte-identical requests, which is what makes replayed
  metrics reproducible bit-for-bit.
* `replay` drives a single `Engine` (or a cluster `Router`) through the
  arrival stream **open-loop**: arrivals are submitted in virtual time
  regardless of completions — a saturated engine falls behind rather
  than back-pressuring the trace, exactly how production load arrives.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from repro_torch.serving.request import Request
from repro_torch.traces.schema import Trace


@dataclass(frozen=True)
class ReplayConfig:
    """Knobs shaping one replay of a trace.

    Attributes:
        rate_scale: arrival-rate multiplier — inter-arrival gaps divide
            by it, preserving the trace's burst structure while sweeping
            load (the benchmark's x-axis).
        time_warp: uniform playback-speed multiplier applied to the
            whole time axis. Mathematically it composes with
            ``rate_scale`` (both divide timestamps); keep it at 1.0 for
            load sweeps and use it for coarse fast-forward of very long
            traces.
        limit: replay only the first N records (None = all).
        max_prompt: prompt-length clip in tokens (trace outliers would
            otherwise dwarf every cache budget).
        max_output: output-length clip in tokens.
        seed: drives prompt token content (not lengths or arrivals —
            those come from the trace).
        vocab: vocabulary for the synthesized prompt token ids.
    """

    rate_scale: float = 1.0
    time_warp: float = 1.0
    limit: int | None = None
    max_prompt: int = 2048
    max_output: int = 512
    seed: int = 0
    vocab: int = 32000


def requests_from_trace(trace: Trace,
                        rcfg: ReplayConfig = ReplayConfig()) -> list[Request]:
    """Materialize a trace into arrival-sorted `Request` objects.

    Token content is synthesized from one dedicated RNG stream keyed on
    ``rcfg.seed`` (the trace only records lengths), so identical
    (trace, config) pairs produce identical requests — including across
    processes (string seeding hashes via sha512, not PYTHONHASHSEED).
    """
    if rcfg.rate_scale <= 0 or rcfg.time_warp <= 0:
        raise ValueError("rate_scale and time_warp must be positive")
    tok_rng = random.Random(f"{rcfg.seed}:trace-content")
    scale = rcfg.rate_scale * rcfg.time_warp
    records = trace.records[:rcfg.limit]
    reqs = []
    for rid, rec in enumerate(records):
        plen = max(1, min(rec.prompt_tokens, rcfg.max_prompt))
        olen = max(1, min(rec.output_tokens, rcfg.max_output))
        prompt = [tok_rng.randrange(1, rcfg.vocab) for _ in range(plen)]
        reqs.append(Request(rid=rid, arrival=rec.arrival / scale,
                            prompt=prompt, true_out_len=olen,
                            max_new_tokens=rcfg.max_output,
                            tenant=rec.tenant))
    return reqs


def replay(target, requests: list[Request]):
    """Feed an arrival stream open-loop and drive the target to drain.

    Both targets implement open-loop virtual-time feeding already — the
    `Router` dispatches each arrival once the replica clocks reach it,
    and the `Engine` gates admission of submitted arrivals on its own
    clock — so this function delegates to their canonical ``run()`` loops
    rather than re-implementing (and risking drift from) them. Arrivals
    land at their trace timestamps regardless of completions; a
    saturated target falls behind instead of back-pressuring the trace.

    Args:
        target: an `Engine` (incremental ``submit()``/``step()`` API) or
            a cluster `Router` over N replica engines.
        requests: arrival-sorted `Request` objects (from
            `requests_from_trace` or any workload generator).

    Returns:
        The target's stats object — `EngineStats` for an engine,
        `ClusterStats` for a router.
    """
    return target.run(requests)
