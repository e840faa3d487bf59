"""Workload generation: Alpaca-like request streams and a scenario library.

The Alpaca dataset (the paper's workload) is not available offline, so we
generate a synthetic stream whose *shape* matches its published statistics:
right-skewed prompt lengths (median ≈ 40 tokens; the paper's profiled prompt
tensor is [1, 44, 4096]) and right-skewed output lengths clipped to the
paper's 512-token prediction range (lognormal; most responses < 100 tokens,
a long tail up to 512 — the regime where SRPT-style policies shine).

Arrival processes:

* ``poisson`` — homogeneous Poisson at ``request_rate`` (the paper's
  Figures 5-6 setting).
* ``burst``   — everything at t=0 (the paper's Figure 7).
* ``mmpp``    — 2-state Markov-modulated Poisson (bursty on/off traffic):
  a high-rate ON state and a low-rate OFF state with exponential dwell
  times, normalized so the long-run mean rate equals ``request_rate``.
* ``diurnal`` — non-homogeneous Poisson with a sinusoidal rate curve
  (thinning), mean rate ``request_rate``.

Multi-tenant mixes can go beyond one shared process: when every
`TenantSpec` carries a positive ``rate``, each tenant drives its *own*
arrival process (its own seeded stream, optionally its own process kind
via ``TenantSpec.arrival``) and the per-tenant streams superpose into
the request stream — bursty code traffic over steady chat, say. The
``tenant-arrivals`` scenario is the packaged example.

Named presets combining arrivals with length mixes live in ``SCENARIOS``
and are built with `scenario_config` — reachable from ``launch/serve.py
--scenario`` and ``benchmarks/cluster_curves.py``. Recorded traces are a
scenario source too: ``scenario_config("trace:<path>", ...)`` (or
``trace:sample`` for the bundled fixture) replays arrivals and
prompt/output lengths from an Azure-LLM-inference-style trace through
``repro_torch.traces`` instead of synthesizing them.

RNG streams: historically one ``random.Random(seed)`` drove arrivals,
lengths, *and* prompt-token content, so any arrival-process change
(toggling ``burst``, or an arrival distribution that consumes a
data-dependent number of draws, like MMPP) reshuffled every length and
content draw. With ``split_streams=True`` (the default for every scenario
preset) arrivals, lengths, tenant assignment, and token content each draw
from an independent stream seeded from ``seed`` — the job-size sequence
is invariant under arrival-process and rate changes. The legacy coupled
stream remains the ``WorkloadConfig`` default so experiment JSONs
produced by earlier revisions stay reproducible.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, replace

from repro_torch.serving.request import Request


@dataclass(frozen=True)
class TenantSpec:
    """One tenant in a multi-tenant mix.

    Attributes:
        name: tenant tag stamped onto each generated `Request`.
        weight: sampling weight (normalized over the mix).
        prompt_mean: lognormal location for prompt lengths (tokens).
        prompt_sigma: lognormal sigma for prompt lengths.
        out_median: lognormal median for output lengths (tokens).
        out_sigma: lognormal sigma for output lengths.
        prefix_len: length (tokens) of the tenant's fixed system prompt,
            prepended to every request of the tenant. All requests of one
            tenant share the same prefix token content (drawn once from a
            dedicated RNG stream), so cross-request KV prefix caching can
            serve it after the first prefill. 0 = no shared prefix.
        rate: per-tenant mean arrival rate (req/s). When any tenant in
            the mix sets a positive rate, *every* tenant must: each then
            drives its own independent arrival process (seeded from
            ``{seed}:arrivals:{name}``) and the streams superpose —
            ``weight`` is ignored, the rates set the mix. 0 (the
            default) keeps the legacy single-stream draw where one
            shared arrival process tags requests by ``weight``.
        arrival: per-tenant arrival process (``poisson`` | ``burst`` |
            ``mmpp`` | ``diurnal``); only read in rate-driven mode.
            Empty = inherit the workload-level ``arrival``.
    """

    name: str
    weight: float
    prompt_mean: float = 44.0
    prompt_sigma: float = 0.6
    out_median: float = 48.0
    out_sigma: float = 1.0
    prefix_len: int = 0
    rate: float = 0.0
    arrival: str = ""


@dataclass(frozen=True)
class WorkloadConfig:
    """Parameters for one synthetic request stream.

    Attributes:
        n_requests: number of requests to generate.
        request_rate: long-run mean arrival rate (req/s) for every
            arrival process except ``burst``.
        burst: legacy flag — everything arrives at t=0 (same as
            ``arrival="burst"``; kept for config compatibility).
        arrival: arrival process — ``poisson`` | ``burst`` | ``mmpp`` |
            ``diurnal`` (see module docstring).
        prompt_mean: lognormal location for prompt lengths (tokens).
        prompt_sigma: lognormal sigma for prompt lengths.
        out_median: lognormal median of output lengths (tokens).
        out_sigma: lognormal sigma of output lengths.
        max_out: output-length clip — the paper's 512-token range.
        min_out: lower output-length clip.
        vocab: vocabulary size for random prompt-token content.
        seed: master seed (all streams derive from it).
        split_streams: draw arrivals / lengths / tenants / content from
            independent per-purpose streams (see module docstring). Off
            by default for byte-compatibility with old experiments.
        mmpp_burst_factor: ON-state rate multiplier (mmpp). The OFF rate
            is derived so the long-run mean equals ``request_rate``;
            requires ``mmpp_duty * mmpp_burst_factor <= 1``.
        mmpp_duty: long-run fraction of time spent in the ON state.
        mmpp_cycle: mean ON+OFF cycle length in seconds.
        diurnal_amp: relative amplitude of the sinusoidal rate curve
            (0 = flat Poisson, 1 = rate touches zero at the trough).
        diurnal_period: period of the rate curve in seconds.
        tenants: optional `TenantSpec` mix; empty = single-tenant using
            the top-level length parameters.
        prefix_len: single-tenant shared system-prompt length in tokens
            (per-tenant prefixes come from ``TenantSpec.prefix_len``).
            Requires ``split_streams=True``.
        prefix_hit: probability that a request with a shared prefix
            actually carries the *tenant's* prefix; misses get a fresh
            random prefix of the same length (so footprints match but the
            KV cache cannot serve it) — the hit-rate dial for prefix-cache
            benchmarks.
        trace: replay a recorded trace instead of synthesizing arrivals
            and lengths: a ``.jsonl``/``.csv`` path, or ``sample`` for
            the bundled Azure-style fixture (see ``repro_torch.traces``).
            When set, ``n_requests`` caps the replayed records, ``seed``
            and ``vocab`` drive prompt token content, and the arrival /
            length knobs above are ignored (they come from the trace).
        trace_rate_scale: arrival-rate multiplier for trace replay
            (inter-arrival gaps divide by it; burst structure is kept).
        trace_target_rate: when positive, replay at this mean arrival
            rate (req/s): the rate-scale is derived from the loaded
            trace's native rate at generation time. Ignored when a
            non-default ``trace_rate_scale`` is set — an explicit scale
            wins.
        trace_time_warp: uniform playback-speed multiplier for trace
            replay (see `repro_torch.traces.ReplayConfig`).
        predictor: length-prediction strategy spec the scenario
            recommends (``name[:key=value,...]``, see
            `repro_torch.serving.predictors.STRATEGIES`). Workload
            generation itself never reads it — it rides the config so
            scenario presets and ``scenario_config(..., predictor=...)``
            overrides reach the engine/cluster launchers
            (``launch/serve.py`` uses it when ``--predictor`` is not
            given). Empty = the engine's legacy default.
    """

    n_requests: int = 256
    request_rate: float = 14.0       # the paper's Figure 5 operating point
    burst: bool = False
    arrival: str = "poisson"         # poisson | burst | mmpp | diurnal
    prompt_mean: float = 44.0        # tokens (paper's profiling shape)
    prompt_sigma: float = 0.6        # lognormal sigma
    out_median: float = 48.0
    out_sigma: float = 1.0
    max_out: int = 512
    min_out: int = 1
    vocab: int = 32000
    seed: int = 0
    split_streams: bool = False
    mmpp_burst_factor: float = 3.0
    mmpp_duty: float = 0.25
    mmpp_cycle: float = 8.0
    diurnal_amp: float = 0.8
    diurnal_period: float = 60.0
    tenants: tuple = ()
    prefix_len: int = 0
    prefix_hit: float = 1.0
    trace: str = ""
    trace_rate_scale: float = 1.0
    trace_target_rate: float = 0.0
    trace_time_warp: float = 1.0
    predictor: str = ""


def sample_output_length(rng: random.Random, wc,
                         spec: TenantSpec | None = None) -> int:
    """Draw one lognormal output length, clipped to [min_out, max_out]."""
    med = spec.out_median if spec is not None else wc.out_median
    sig = spec.out_sigma if spec is not None else wc.out_sigma
    v = rng.lognormvariate(math.log(med), sig)
    return max(wc.min_out, min(int(v), wc.max_out))


def sample_prompt_length(rng: random.Random, wc,
                         spec: TenantSpec | None = None) -> int:
    """Draw one lognormal prompt length, clipped to [4, 2048]."""
    mean = spec.prompt_mean if spec is not None else wc.prompt_mean
    sig = spec.prompt_sigma if spec is not None else wc.prompt_sigma
    v = rng.lognormvariate(math.log(mean), sig)
    return max(4, min(int(v), 2048))


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------

def _poisson_arrivals(rng: random.Random, wc: WorkloadConfig) -> list[float]:
    t, out = 0.0, []
    for _ in range(wc.n_requests):
        t += rng.expovariate(wc.request_rate)
        out.append(t)
    return out


def _mmpp_arrivals(rng: random.Random, wc: WorkloadConfig) -> list[float]:
    """2-state MMPP: exponential ON/OFF dwells, mean rate = request_rate.

    Memorylessness makes discard-and-redraw at state switches exact: an
    exponential inter-arrival that crosses the switch time is simply
    abandoned and redrawn at the new state's rate.
    """
    duty, fb = wc.mmpp_duty, wc.mmpp_burst_factor
    if duty * fb > 1.0:
        raise ValueError("mmpp_duty * mmpp_burst_factor must be <= 1 "
                         "(OFF-state rate would be negative)")
    rate_on = wc.request_rate * fb
    rate_off = wc.request_rate * (1.0 - duty * fb) / (1.0 - duty)
    mean_on = duty * wc.mmpp_cycle
    mean_off = (1.0 - duty) * wc.mmpp_cycle
    t, on, out = 0.0, True, []
    t_switch = rng.expovariate(1.0 / mean_on)
    while len(out) < wc.n_requests:
        rate = rate_on if on else rate_off
        dt = rng.expovariate(rate) if rate > 0 else float("inf")
        if t + dt < t_switch:
            t += dt
            out.append(t)
        else:
            t = t_switch
            on = not on
            t_switch = t + rng.expovariate(
                1.0 / (mean_on if on else mean_off))
    return out


def _diurnal_arrivals(rng: random.Random, wc: WorkloadConfig) -> list[float]:
    """Non-homogeneous Poisson via thinning against the peak rate."""
    base, amp, period = wc.request_rate, wc.diurnal_amp, wc.diurnal_period
    rate_max = base * (1.0 + amp)
    t, out = 0.0, []
    while len(out) < wc.n_requests:
        t += rng.expovariate(rate_max)
        rate_t = base * (1.0 + amp * math.sin(2.0 * math.pi * t / period))
        if rng.random() * rate_max < rate_t:
            out.append(t)
    return out


_ARRIVALS = {"poisson": _poisson_arrivals, "mmpp": _mmpp_arrivals,
             "diurnal": _diurnal_arrivals}


def _pick_tenant(rng: random.Random, wc: WorkloadConfig) -> TenantSpec | None:
    if not wc.tenants:
        return None
    total = sum(s.weight for s in wc.tenants)
    u = rng.random() * total
    acc = 0.0
    for spec in wc.tenants:
        acc += spec.weight
        if u < acc:
            return spec
    return wc.tenants[-1]


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def _generate_legacy(wc: WorkloadConfig, burst: bool) -> list[Request]:
    """The original coupled-RNG generation path.

    Arrivals, lengths and content share one stream; kept byte-identical
    so old experiment JSONs reproduce.
    """
    rng = random.Random(wc.seed)
    t = 0.0
    reqs = []
    for rid in range(wc.n_requests):
        if not burst:
            t += rng.expovariate(wc.request_rate)
        plen = sample_prompt_length(rng, wc)
        olen = sample_output_length(rng, wc)
        prompt = [rng.randrange(1, wc.vocab) for _ in range(plen)]
        reqs.append(Request(rid=rid, arrival=t if not burst else 0.0,
                            prompt=prompt, true_out_len=olen,
                            max_new_tokens=wc.max_out))
    return reqs


def generate(wc: WorkloadConfig) -> list[Request]:
    """Generate the request stream described by ``wc``.

    With ``split_streams=False`` and a plain poisson/burst arrival this is
    the legacy coupled-RNG generator (byte-identical to earlier
    revisions). Every other combination uses four independent streams
    derived from ``wc.seed`` — ``arrivals``, ``lengths``, ``tenants`` and
    ``content`` — so the job-size sequence is invariant under
    ``request_rate`` (and arrival-process) changes. Tenant mixes whose
    specs carry positive ``rate`` values switch to rate-driven
    superposition (`_generate_per_tenant`): per-tenant arrival processes
    on per-tenant streams.
    """
    if wc.trace:
        return _generate_from_trace(wc)
    arrival = "burst" if wc.burst else wc.arrival
    if arrival not in ("poisson", "burst", "mmpp", "diurnal"):
        raise ValueError(f"unknown arrival process {wc.arrival!r}")
    has_prefix = wc.prefix_len > 0 or any(
        s.prefix_len > 0 for s in wc.tenants)
    if not wc.split_streams and arrival in ("poisson", "burst"):
        if wc.tenants:
            raise ValueError("tenant mixes require split_streams=True")
        if has_prefix:
            raise ValueError("shared prefixes require split_streams=True")
        return _generate_legacy(wc, burst=arrival == "burst")
    if any(s.rate > 0 for s in wc.tenants):
        return _generate_per_tenant(wc, arrival)

    # string seeding is deterministic across processes (hashed via sha512
    # by random.seed, not PYTHONHASHSEED)
    arr_rng = random.Random(f"{wc.seed}:arrivals")
    len_rng = random.Random(f"{wc.seed}:lengths")
    ten_rng = random.Random(f"{wc.seed}:tenants")
    tok_rng = random.Random(f"{wc.seed}:content")

    if arrival == "burst":
        arrivals = [0.0] * wc.n_requests
    else:
        arrivals = _ARRIVALS[arrival](arr_rng, wc)

    # shared system prompts: one fixed token sequence per tenant, drawn
    # from a stream keyed on the tenant name so the content is stable
    # under any change to the mix, rates, or arrival process. The hit
    # dial draws from its own stream for the same invariance.
    hit_rng = random.Random(f"{wc.seed}:prefixhit") if has_prefix else None
    prefixes: dict[str, list[int]] = {}

    def _shared_prefix(name: str, plen: int) -> list[int]:
        if name not in prefixes:
            rng = random.Random(f"{wc.seed}:prefix:{name}")
            prefixes[name] = [rng.randrange(1, wc.vocab)
                              for _ in range(plen)]
        return prefixes[name]

    reqs = []
    for rid, t in enumerate(arrivals):
        spec = _pick_tenant(ten_rng, wc)
        plen = sample_prompt_length(len_rng, wc, spec)
        olen = sample_output_length(len_rng, wc, spec)
        prompt = [tok_rng.randrange(1, wc.vocab) for _ in range(plen)]
        pre_len = spec.prefix_len if spec is not None else wc.prefix_len
        if pre_len > 0:
            if hit_rng.random() < wc.prefix_hit:
                prompt = _shared_prefix(spec.name if spec else "",
                                        pre_len) + prompt
            else:       # miss: same footprint, unshareable content
                prompt = [tok_rng.randrange(1, wc.vocab)
                          for _ in range(pre_len)] + prompt
        reqs.append(Request(rid=rid, arrival=t, prompt=prompt,
                            true_out_len=olen, max_new_tokens=wc.max_out,
                            tenant=spec.name if spec else ""))
    return reqs


def _generate_per_tenant(wc: WorkloadConfig,
                         default_arrival: str) -> list[Request]:
    """Rate-driven multi-tenant generation: superposed arrival processes.

    Every tenant drives its own arrival process on its own RNG stream
    (``{seed}:arrivals:{name}``) at its own ``rate``; the per-tenant
    streams merge in time order (name-tiebroken) and truncate to
    ``n_requests``. Lengths, token content, and prefix-hit draws also
    come from per-tenant streams, so changing one tenant's rate or
    arrival process cannot reshuffle any other tenant's requests — the
    per-tenant extension of the ``split_streams`` invariance.
    """
    if not wc.split_streams:
        raise ValueError("tenant mixes require split_streams=True")
    bad = [s.name for s in wc.tenants if s.rate <= 0]
    if bad:
        raise ValueError("per-tenant arrival mode needs a positive rate "
                         f"for every tenant; missing: {bad} (either give "
                         "all tenants rates or none)")
    merged: list[tuple[float, str, TenantSpec]] = []
    for spec in wc.tenants:
        proc = spec.arrival or default_arrival
        if proc == "burst":
            arrivals = [0.0] * wc.n_requests
        elif proc in _ARRIVALS:
            rng = random.Random(f"{wc.seed}:arrivals:{spec.name}")
            arrivals = _ARRIVALS[proc](rng, replace(wc,
                                                    request_rate=spec.rate))
        else:
            raise ValueError(f"unknown arrival process {proc!r} "
                             f"for tenant {spec.name!r}")
        merged.extend((t, spec.name, spec) for t in arrivals)
    # superposition: each tenant over-generates n_requests arrivals; the
    # merge keeps the earliest n_requests overall. Within one tenant the
    # merged order equals its arrival order, so the i-th surviving
    # request of a tenant always consumes that tenant's i-th
    # length/content draw no matter how the streams interleave.
    merged.sort(key=lambda x: (x[0], x[1]))
    merged = merged[:wc.n_requests]

    len_rngs = {s.name: random.Random(f"{wc.seed}:lengths:{s.name}")
                for s in wc.tenants}
    tok_rngs = {s.name: random.Random(f"{wc.seed}:content:{s.name}")
                for s in wc.tenants}
    hit_rngs = {s.name: random.Random(f"{wc.seed}:prefixhit:{s.name}")
                for s in wc.tenants}
    prefixes: dict[str, list[int]] = {}

    def _shared_prefix(name: str, plen: int) -> list[int]:
        if name not in prefixes:
            rng = random.Random(f"{wc.seed}:prefix:{name}")
            prefixes[name] = [rng.randrange(1, wc.vocab)
                              for _ in range(plen)]
        return prefixes[name]

    reqs = []
    for rid, (t, name, spec) in enumerate(merged):
        plen = sample_prompt_length(len_rngs[name], wc, spec)
        olen = sample_output_length(len_rngs[name], wc, spec)
        prompt = [tok_rngs[name].randrange(1, wc.vocab)
                  for _ in range(plen)]
        if spec.prefix_len > 0:
            if hit_rngs[name].random() < wc.prefix_hit:
                prompt = _shared_prefix(name, spec.prefix_len) + prompt
            else:       # miss: same footprint, unshareable content
                prompt = [tok_rngs[name].randrange(1, wc.vocab)
                          for _ in range(spec.prefix_len)] + prompt
        reqs.append(Request(rid=rid, arrival=t, prompt=prompt,
                            true_out_len=olen, max_new_tokens=wc.max_out,
                            tenant=name))
    return reqs


def _generate_from_trace(wc: WorkloadConfig) -> list[Request]:
    """Trace-backed generation: load + replay-materialize.

    The traces package is imported lazily so the workload module stays
    importable without it. The trace is parsed exactly once; a
    ``trace_target_rate`` converts into a rate-scale against the loaded
    trace's native mean rate here, unless an explicit non-default
    ``trace_rate_scale`` was given.
    """
    from repro_torch.traces import (ReplayConfig, load_trace,
                                    requests_from_trace)
    trace = load_trace(wc.trace, limit=wc.n_requests or None)
    scale = wc.trace_rate_scale
    if wc.trace_target_rate > 0 and scale == 1.0 and trace.mean_rate > 0:
        scale = wc.trace_target_rate / trace.mean_rate
    rcfg = ReplayConfig(rate_scale=scale,
                        time_warp=wc.trace_time_warp,
                        limit=wc.n_requests or None,
                        max_output=wc.max_out, seed=wc.seed,
                        vocab=wc.vocab)
    return requests_from_trace(trace, rcfg)


# ---------------------------------------------------------------------------
# scenario library
# ---------------------------------------------------------------------------

#: Named presets: scenario name -> WorkloadConfig field overrides. All
#: presets use split RNG streams so job sizes are rate-invariant.
SCENARIOS: dict[str, dict] = {
    # the paper's settings
    "poisson": dict(arrival="poisson"),
    "burst": dict(arrival="burst"),
    # bursty on/off traffic: 3x rate spikes a quarter of the time
    "bursty": dict(arrival="mmpp", mmpp_burst_factor=3.0, mmpp_duty=0.25,
                   mmpp_cycle=8.0),
    # slow sinusoidal load curve (compressed diurnal cycle)
    "diurnal": dict(arrival="diurnal", diurnal_amp=0.8, diurnal_period=60.0),
    # chat-heavy multi-tenant mix: interactive chat, code completion with
    # longer prompts/outputs, and a small batch-summarization tenant with
    # big prompts and short outputs
    "multi-tenant": dict(arrival="poisson", tenants=(
        TenantSpec("chat", 0.6, prompt_mean=44.0, out_median=48.0),
        TenantSpec("code", 0.3, prompt_mean=120.0, prompt_sigma=0.5,
                   out_median=128.0, out_sigma=0.8),
        TenantSpec("summarize", 0.1, prompt_mean=400.0, prompt_sigma=0.4,
                   out_median=24.0, out_sigma=0.5),
    )),
    # long-context-heavy: big prompts, moderate outputs — stresses KV
    # memory and chunked prefill rather than decode
    "long-context": dict(arrival="poisson", prompt_mean=400.0,
                         prompt_sigma=0.8, out_median=96.0),
    # rate-driven multi-tenant mix: each tenant owns an independent
    # arrival process (steady chat, bursty code spikes, diurnal batch
    # summarization) and the streams superpose. Rates below are
    # *relative* shares — scenario_config rescales them so their sum
    # equals the requested aggregate request_rate.
    "tenant-arrivals": dict(arrival="poisson", tenants=(
        TenantSpec("chat", 0.6, prompt_mean=44.0, out_median=48.0,
                   rate=6.0, arrival="poisson"),
        TenantSpec("code", 0.3, prompt_mean=120.0, prompt_sigma=0.5,
                   out_median=128.0, out_sigma=0.8,
                   rate=3.0, arrival="mmpp"),
        TenantSpec("summarize", 0.1, prompt_mean=400.0, prompt_sigma=0.4,
                   out_median=24.0, out_sigma=0.5,
                   rate=1.0, arrival="diurnal"),
    )),
    # multi-tenant mix where every tenant carries a fixed system prompt
    # (RAG preamble / tool schema / style rules): the cross-request
    # prefix-cache scenario. Prefix lengths are page-aligned (multiples
    # of 16) so a full prefix hit links cleanly; dial the hit rate with
    # scenario_config("shared-prefix", ..., prefix_hit=0.5).
    "shared-prefix": dict(arrival="poisson", tenants=(
        TenantSpec("chat", 0.6, prompt_mean=44.0, out_median=48.0,
                   prefix_len=192),
        TenantSpec("code", 0.3, prompt_mean=120.0, prompt_sigma=0.5,
                   out_median=128.0, out_sigma=0.8, prefix_len=384),
        TenantSpec("summarize", 0.1, prompt_mean=400.0, prompt_sigma=0.4,
                   out_median=24.0, out_sigma=0.5, prefix_len=96),
    )),
}


def scenario_config(name: str, *, n_requests: int, request_rate: float,
                    seed: int = 0, vocab: int = 32000,
                    **overrides) -> WorkloadConfig:
    """Build the `WorkloadConfig` for a named scenario preset.

    Args:
        name: a key of ``SCENARIOS``, or a trace source of the form
            ``trace:<path>`` (``trace:sample`` replays the bundled
            Azure-style fixture). Trace sources take their arrivals and
            lengths from the trace itself; ``request_rate``, when
            positive, is interpreted as a target mean arrival rate and
            converted into the replay rate-scale (pass
            ``trace_rate_scale=...`` explicitly to override, with
            ``request_rate=0`` replaying the native rate).
        n_requests: number of requests (for traces: a replay cap).
        request_rate: long-run mean arrival rate (req/s).
        seed: master RNG seed.
        vocab: vocabulary size for prompt content.
        **overrides: any further `WorkloadConfig` field overrides.

    Returns:
        A frozen `WorkloadConfig` with ``split_streams=True``.
    """
    if name.startswith("trace:"):
        source = name[len("trace:"):] or "sample"
        # the rate target resolves against the trace's native rate at
        # generation time (one parse), unless an explicit scale override
        # is given — see WorkloadConfig.trace_target_rate
        target = (request_rate
                  if "trace_rate_scale" not in overrides else 0.0)
        wc = WorkloadConfig(n_requests=n_requests,
                            request_rate=request_rate, seed=seed,
                            vocab=vocab, split_streams=True, trace=source,
                            trace_target_rate=target)
        return replace(wc, **overrides) if overrides else wc
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"choose from {sorted(SCENARIOS)} or 'trace:<path>'")
    wc = WorkloadConfig(n_requests=n_requests, request_rate=request_rate,
                        seed=seed, vocab=vocab, split_streams=True,
                        **SCENARIOS[name])
    if overrides:
        wc = replace(wc, **overrides)
    # rate-driven tenant mixes carry *relative* rates in the preset;
    # rescale so the superposed aggregate equals request_rate (an
    # explicit tenants= override passes through untouched)
    if ("tenants" not in overrides and request_rate > 0
            and any(s.rate > 0 for s in wc.tenants)):
        total = sum(s.rate for s in wc.tenants)
        wc = replace(wc, tenants=tuple(
            replace(s, rate=s.rate * request_rate / total)
            for s in wc.tenants))
    return wc
