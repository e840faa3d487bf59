"""Trace schema: the normalized form every trace source reduces to.

A trace is a sequence of `TraceRecord`s — (arrival, prompt_tokens,
output_tokens, tenant) — matching the public Azure LLM inference trace
shape (TIMESTAMP / ContextTokens / GeneratedTokens). Loaders normalize
arbitrary column namings and time bases into this one schema so the
replay, synthesis, and benchmarks never see source quirks.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class TraceRecord:
    """One request observation from a serving trace.

    Attributes:
        arrival: arrival time in seconds from the trace start (the
            loaders rebase so the first arrival is 0.0).
        prompt_tokens: prompt / context length in tokens.
        output_tokens: generated / output length in tokens.
        tenant: optional workload tag (empty for single-stream traces).
    """

    arrival: float
    prompt_tokens: int
    output_tokens: int
    tenant: str = ""

    def as_dict(self) -> dict:
        """JSONL-record form (the bundled fixture's on-disk schema)."""
        d = {"ts": self.arrival, "context_tokens": self.prompt_tokens,
             "generated_tokens": self.output_tokens}
        if self.tenant:
            d["tenant"] = self.tenant
        return d


@dataclass
class Trace:
    """A normalized request trace plus its provenance metadata.

    Attributes:
        records: arrival-sorted `TraceRecord`s, rebased to start at 0.
        name: source identifier (file stem or synthesis tag).
        meta: free-form provenance (source path, synthesis config, ...).
    """

    records: list[TraceRecord]
    name: str = "trace"
    meta: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.records)

    @property
    def duration(self) -> float:
        """Span from first to last arrival, in seconds."""
        if not self.records:
            return 0.0
        return self.records[-1].arrival - self.records[0].arrival

    @property
    def mean_rate(self) -> float:
        """Long-run mean arrival rate (req/s) over the trace span."""
        if len(self.records) < 2 or self.duration <= 0:
            return 0.0
        return (len(self.records) - 1) / self.duration

    def stats(self) -> dict:
        """Shape summary: counts, rate, and length means (for artifacts)."""
        n = len(self.records)
        if not n:
            return {"n": 0}
        return {
            "n": n,
            "duration_s": self.duration,
            "mean_rate": self.mean_rate,
            "mean_prompt_tokens":
                sum(r.prompt_tokens for r in self.records) / n,
            "mean_output_tokens":
                sum(r.output_tokens for r in self.records) / n,
            "tenants": sorted({r.tenant for r in self.records if r.tenant}),
        }


def normalize(records: list[TraceRecord], name: str = "trace",
              meta: dict | None = None) -> Trace:
    """Sort by arrival, rebase to t=0, and wrap into a `Trace`.

    Records with non-positive lengths are clamped to 1 token — zero
    -length rows occur in real exports (failed requests) and would
    otherwise wedge the engine's finish condition.
    """
    recs = sorted(records, key=lambda r: r.arrival)
    t0 = recs[0].arrival if recs else 0.0
    recs = [TraceRecord(arrival=r.arrival - t0,
                        prompt_tokens=max(int(r.prompt_tokens), 1),
                        output_tokens=max(int(r.output_tokens), 1),
                        tenant=r.tenant)
            for r in recs]
    return Trace(records=recs, name=name, meta=dict(meta or {}))
