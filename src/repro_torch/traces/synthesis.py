"""Synthetic trace synthesis with per-tenant correlated length marginals.

The synthetic scenario library (`serving/workload.py`) draws prompt and
output lengths *independently*, but real traces correlate them — long
contexts beget long answers in chat, and RAG tenants pair huge prompts
with terse outputs (negative correlation). Prediction-based schedulers
are sensitive to exactly this structure (Mitzenmacher & Shahout 2025),
so the trace subsystem can synthesize it directly:

* **Gaussian copula** (default): per tenant, draw correlated standard
  normals ``(z_p, z_o)`` with correlation ρ and push them through the
  lognormal marginals ``exp(μ + σ z)`` — with lognormal marginals the
  copula is exact and Pearson-in-log = ρ.
* **rank shuffle**: draw both marginals independently, then reorder the
  output column so its ranks follow a ρ-correlated latent — keeps the
  marginals *exactly* as drawn (any distribution), at the cost of only
  rank-level (Spearman) correlation control.

Arrivals are homogeneous Poisson at the configured mean rate with
tenant choice by weight. Everything derives from one seed — the bundled
``data/azure_llm_sample.jsonl`` fixture is `sample_trace()` written to
disk, and `tests/test_traces.py` re-generates it to prove the checked-in
bytes match the code.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.traces.schema import Trace, TraceRecord, normalize


@dataclass(frozen=True)
class TenantTraceSpec:
    """Length-distribution spec for one tenant in a synthesized trace.

    Attributes:
        name: tenant tag stamped onto the records.
        weight: sampling weight (normalized over the mix).
        prompt_median: lognormal median prompt length (tokens).
        prompt_sigma: lognormal sigma of prompt lengths.
        out_median: lognormal median output length (tokens).
        out_sigma: lognormal sigma of output lengths.
        rho: prompt/output correlation in copula space (-1..1).
    """

    name: str
    weight: float = 1.0
    prompt_median: float = 44.0
    prompt_sigma: float = 0.6
    out_median: float = 48.0
    out_sigma: float = 1.0
    rho: float = 0.0


@dataclass(frozen=True)
class SynthesisConfig:
    """Parameters for one synthesized trace.

    Attributes:
        n_requests: number of records.
        mean_rate: Poisson arrival rate (req/s).
        tenants: the tenant mix (at least one spec).
        method: ``copula`` | ``rank-shuffle`` (see module docstring).
        max_prompt: prompt-length clip (tokens).
        max_output: output-length clip (tokens).
        seed: master seed; every draw derives from it.
    """

    n_requests: int = 300
    mean_rate: float = 0.5
    tenants: tuple = (TenantTraceSpec("default"),)
    method: str = "copula"
    max_prompt: int = 2048
    max_output: int = 512
    seed: int = 0


def _correlated_normals(rng: np.random.Generator, n: int,
                        rho: float) -> tuple[np.ndarray, np.ndarray]:
    """n draws of (z1, z2) standard normals with correlation rho."""
    z1 = rng.standard_normal(n)
    z2 = rho * z1 + np.sqrt(max(1.0 - rho * rho, 0.0)) \
        * rng.standard_normal(n)
    return z1, z2


def _lengths_copula(rng, spec: TenantTraceSpec, n: int):
    z_p, z_o = _correlated_normals(rng, n, spec.rho)
    prompts = np.exp(np.log(spec.prompt_median) + spec.prompt_sigma * z_p)
    outs = np.exp(np.log(spec.out_median) + spec.out_sigma * z_o)
    return prompts, outs


def _lengths_rank_shuffle(rng, spec: TenantTraceSpec, n: int):
    prompts = rng.lognormal(np.log(spec.prompt_median), spec.prompt_sigma, n)
    outs = rng.lognormal(np.log(spec.out_median), spec.out_sigma, n)
    # reorder the independently-drawn outputs so their ranks follow a
    # rho-correlated latent: marginals stay exactly as drawn
    z_p, z_latent = _correlated_normals(rng, n, spec.rho)
    order_p = np.argsort(np.argsort(prompts))       # rank of each prompt
    # give row i the output whose rank matches the latent's rank at the
    # same prompt-rank position
    latent_by_prompt_rank = z_latent[np.argsort(z_p)]
    out_rank_for_prompt_rank = np.argsort(np.argsort(latent_by_prompt_rank))
    outs_sorted = np.sort(outs)
    return prompts, outs_sorted[out_rank_for_prompt_rank[order_p]]


def synthesize(sc: SynthesisConfig) -> Trace:
    """Generate one trace from a `SynthesisConfig` (deterministic in seed)."""
    if not sc.tenants:
        raise ValueError("at least one TenantTraceSpec is required")
    if sc.method not in ("copula", "rank-shuffle"):
        raise ValueError(f"unknown synthesis method {sc.method!r}")
    arr_rng = np.random.default_rng([sc.seed, 1])
    ten_rng = np.random.default_rng([sc.seed, 2])

    arrivals = np.cumsum(arr_rng.exponential(1.0 / sc.mean_rate,
                                             sc.n_requests))
    weights = np.asarray([t.weight for t in sc.tenants], np.float64)
    tenant_idx = ten_rng.choice(len(sc.tenants), size=sc.n_requests,
                                p=weights / weights.sum())

    # per-tenant length streams, drawn in one vectorized block each so
    # a tenant's joint distribution is independent of the others' counts
    records: list[TraceRecord] = []
    lengths_fn = (_lengths_copula if sc.method == "copula"
                  else _lengths_rank_shuffle)
    for ti, spec in enumerate(sc.tenants):
        rows = np.flatnonzero(tenant_idx == ti)
        if not len(rows):
            continue
        len_rng = np.random.default_rng([sc.seed, 3, ti])
        prompts, outs = lengths_fn(len_rng, spec, len(rows))
        prompts = np.clip(prompts.astype(np.int64), 1, sc.max_prompt)
        outs = np.clip(outs.astype(np.int64), 1, sc.max_output)
        for j, row in enumerate(rows):
            records.append(TraceRecord(
                arrival=round(float(arrivals[row]), 6),
                prompt_tokens=int(prompts[j]),
                output_tokens=int(outs[j]),
                tenant=spec.name))
    return normalize(
        records, name=f"synth-{sc.method}-{sc.seed}",
        meta={"synthesis": {"method": sc.method, "seed": sc.seed,
                            "mean_rate": sc.mean_rate,
                            "n_requests": sc.n_requests}})


#: The bundled fixture's mix: chat (long-begets-long, ρ=0.6), code
#: (moderate coupling), and a RAG-like tenant whose huge prompts pair
#: with short outputs (ρ=-0.5) — the correlation pattern that flips
#: policy rankings between mean and tail.
SAMPLE_CONFIG = SynthesisConfig(
    n_requests=300,
    mean_rate=0.5,
    tenants=(
        TenantTraceSpec("chat", 0.55, prompt_median=44.0, prompt_sigma=0.6,
                        out_median=48.0, out_sigma=0.9, rho=0.6),
        TenantTraceSpec("code", 0.3, prompt_median=120.0, prompt_sigma=0.5,
                        out_median=96.0, out_sigma=0.8, rho=0.4),
        TenantTraceSpec("rag", 0.15, prompt_median=380.0, prompt_sigma=0.4,
                        out_median=28.0, out_sigma=0.6, rho=-0.5),
    ),
    method="copula",
    seed=2026,
)

def sample_trace() -> Trace:
    """Regenerate the bundled sample trace from `SAMPLE_CONFIG`.

    `tests/test_traces.py` asserts this matches the checked-in JSONL
    byte-for-byte, so the fixture can always be audited/regenerated.
    """
    return synthesize(SAMPLE_CONFIG)
