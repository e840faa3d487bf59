"""Trace ingestion: JSONL / CSV loaders for Azure-LLM-inference-style traces.

Both loaders normalize flexible column/key namings into the `Trace`
schema (see `schema.py`):

* timestamps — ``ts`` | ``TIMESTAMP`` | ``arrival`` | ``time`` —
  float seconds or ISO-8601 datetimes (the Azure export format);
* prompt length — ``context_tokens`` | ``ContextTokens`` |
  ``prompt_tokens`` | ``input_tokens``;
* output length — ``generated_tokens`` | ``GeneratedTokens`` |
  ``output_tokens``;
* tenant — ``tenant`` | ``app`` | ``user`` (optional).

The bundled anonymized sample trace (`sample_trace_path()`) is a
synthetic Azure-shaped fixture generated by `synthesis.synthesize`
(three tenants, correlated prompt/output lengths) and checked into the
package so benchmarks and CI replay an identical byte stream everywhere.
"""

from __future__ import annotations

import csv
import json
import os
import warnings
from datetime import datetime, timezone

from repro_torch.traces.schema import Trace, TraceRecord, normalize

_TS_KEYS = ("ts", "timestamp", "arrival", "time")
_PROMPT_KEYS = ("context_tokens", "contexttokens", "prompt_tokens",
                "input_tokens")
_OUTPUT_KEYS = ("generated_tokens", "generatedtokens", "output_tokens")
_TENANT_KEYS = ("tenant", "app", "user")

#: The bundled fixture's package-relative location.
_SAMPLE_REL = os.path.join("data", "azure_llm_sample.jsonl")


def sample_trace_path() -> str:
    """Absolute path of the bundled anonymized sample trace fixture."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        _SAMPLE_REL)


def _parse_ts(v) -> float:
    """Seconds from a float/int or an ISO-8601 datetime string.

    Timezone-naive stamps are pinned to UTC: ``datetime.timestamp()``
    would otherwise apply the *host's* local timezone, so the same trace
    could yield different inter-arrival gaps (and event orderings across
    a DST transition) on differently-configured machines — breaking the
    cross-machine replay-determinism guarantee.
    """
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    try:
        return float(s)
    except ValueError:
        dt = datetime.fromisoformat(s.replace("Z", "+00:00"))
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return dt.timestamp()


def _pick(lowered: dict, keys: tuple, what: str, default=None):
    """First matching key from an already case-normalized row dict."""
    for k in keys:
        if k in lowered and lowered[k] not in ("", None):
            return lowered[k]
    if default is not None:
        return default
    raise ValueError(f"trace row missing a {what} column "
                     f"(tried {keys}): {sorted(lowered)}")


def _row_to_record(row: dict) -> TraceRecord:
    if not isinstance(row, dict):
        raise ValueError(
            "trace rows must be objects (one per JSONL line / CSV row), "
            f"got {type(row).__name__}; a whole-file JSON array is not "
            "JSONL — write one record per line")
    # lowercase the keys once; every field lookup shares the result
    lowered = {str(k).strip().lower(): v for k, v in row.items()}
    return TraceRecord(
        arrival=_parse_ts(_pick(lowered, _TS_KEYS, "timestamp")),
        prompt_tokens=int(float(_pick(lowered, _PROMPT_KEYS,
                                      "prompt-length"))),
        output_tokens=int(float(_pick(lowered, _OUTPUT_KEYS,
                                      "output-length"))),
        tenant=str(_pick(lowered, _TENANT_KEYS, "tenant", default="")))


def _limited(trace: Trace, limit: int | None) -> Trace:
    """Keep the ``limit`` *earliest* records — applied after normalize()
    sorts, so an unsorted export truncates by arrival time, never by
    file row order (which would also mis-rebase the time axis)."""
    if limit is not None:
        trace.records = trace.records[:limit]
    return trace


def _skip_or_raise(skipped: int, strict: bool) -> int:
    """Shared non-strict row-error policy: re-raise under ``strict``,
    otherwise count the row as skipped."""
    if strict:
        raise
    return skipped + 1


def _finish(records, path: str, skipped: int, limit: int | None) -> Trace:
    """Shared loader tail: warn about (and record) skipped rows, then
    normalize + truncate. The ``skipped_rows`` meta key is only added
    when rows were actually dropped, so strict loads (and clean
    non-strict loads) produce byte-identical traces to before."""
    meta = {"source": path}
    if skipped:
        meta["skipped_rows"] = skipped
        warnings.warn(f"{path}: skipped {skipped} malformed trace row(s) "
                      "(strict=False)", stacklevel=3)
    return _limited(normalize(records, name=_stem(path), meta=meta), limit)


def load_jsonl(path: str, limit: int | None = None, *,
               strict: bool = True) -> Trace:
    """Load a JSONL trace (one record object per line; blank lines ok).

    ``limit`` keeps the earliest records by timestamp (the whole file is
    parsed first — rows may arrive unsorted). ``strict=False`` skips
    malformed rows (bad JSON, missing/unparseable columns) instead of
    raising, emitting one counted warning; the skip count also lands in
    ``trace.meta["skipped_rows"]``. A whole-file JSON array is a format
    error, not a row error — it raises in either mode.
    """
    records = []
    skipped = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if not records and not skipped and line.startswith("["):
                raise ValueError(
                    f"{path} is a JSON array, not JSONL — this loader "
                    "expects one record object per line")
            try:
                records.append(_row_to_record(json.loads(line)))
            except ValueError:
                skipped = _skip_or_raise(skipped, strict)
    return _finish(records, path, skipped, limit)


def load_csv(path: str, limit: int | None = None, *,
             strict: bool = True) -> Trace:
    """Load a CSV trace with a header row (the Azure export format).

    ``limit`` keeps the earliest records by timestamp (the whole file is
    parsed first — rows may arrive unsorted). ``strict=False`` skips
    malformed rows with one counted warning (see `load_jsonl`).
    """
    records = []
    skipped = 0
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            try:
                records.append(_row_to_record(row))
            except ValueError:
                skipped = _skip_or_raise(skipped, strict)
    return _finish(records, path, skipped, limit)


def load_trace(path: str, limit: int | None = None, *,
               strict: bool = True) -> Trace:
    """Load a trace by path, dispatching on extension.

    ``"sample"`` (or an empty string) resolves to the bundled fixture;
    ``.jsonl``/``.json`` load as JSONL, ``.csv`` as CSV.
    ``strict=False`` skips malformed rows instead of raising.
    """
    if path in ("", "sample"):
        path = sample_trace_path()
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jsonl", ".json"):
        return load_jsonl(path, limit=limit, strict=strict)
    if ext == ".csv":
        return load_csv(path, limit=limit, strict=strict)
    raise ValueError(f"unknown trace format {ext!r} for {path!r} "
                     "(expected .jsonl/.json/.csv)")


def save_jsonl(trace: Trace, path: str) -> None:
    """Write a trace as JSONL (the bundled fixture's format)."""
    with open(path, "w") as f:
        for r in trace.records:
            f.write(json.dumps(r.as_dict(), sort_keys=True) + "\n")


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]
