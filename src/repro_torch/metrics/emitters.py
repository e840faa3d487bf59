"""Shared JSON / markdown emitters for metrics reports.

Every benchmark writes its distribution metrics through these two
functions so artifact formatting cannot drift between benchmarks, and
so the replay-determinism guarantee ("same trace + seed → byte-identical
metrics JSON") has a single canonical byte representation to pin.
"""

from __future__ import annotations

import json

#: Metric sections a rollup report may carry, in canonical row order —
#: the single source of truth shared with benchmarks/make_tables.py.
METRIC_ROWS = ("ttft", "tbt", "completion", "slowdown",
               "latency_per_token")

#: Summary columns every metric section carries (mean + the
#: streaming layer's DEFAULT_PERCENTILES), in canonical column order.
SUMMARY_COLS = ("mean", "p50", "p90", "p99")


def report_json(report: dict) -> str:
    """Canonical JSON bytes for a rollup report (sorted keys, 1-indent).

    This is the representation the determinism tests compare — always
    serialize reports through here, never ad-hoc ``json.dumps`` calls.
    """
    return json.dumps(report, indent=1, sort_keys=True)


def _fmt(v: float) -> str:
    return f"{v:.4g}"


def report_markdown(report: dict, title: str = "") -> str:
    """Render a rollup report as a GitHub-markdown table.

    One row per metric (TTFT, TBT, completion, slowdown when present,
    per-token latency) with mean / p50 / p90 / p99 columns, followed by
    a compact SLO-attainment line per metric and the counters.
    """
    lines = []
    if title:
        lines.append(f"### {title}")
        lines.append("")
    cols = SUMMARY_COLS
    lines.append("| metric (s) | " + " | ".join(cols) + " | n |")
    lines.append("|---|" + "---|" * (len(cols) + 1))
    for key in METRIC_ROWS:
        s = report.get(key)
        if not s or not s.get("n"):
            continue
        row = " | ".join(_fmt(s.get(c, 0.0)) for c in cols)
        lines.append(f"| {key} | {row} | {s['n']} |")
    slo = report.get("slo_attainment", {})
    for key, curve in slo.items():
        if not curve:
            continue
        pts = ", ".join(f"{c['attainment']:.0%}@{c['slo_s']:g}s"
                        for c in curve)
        lines.append("")
        lines.append(f"SLO attainment ({key}): {pts}")
    counters = report.get("counters")
    if counters:
        lines.append("")
        lines.append("Counters: " + ", ".join(
            f"{k}={_fmt(v)}" for k, v in sorted(counters.items())))
    req = report.get("requests")
    if req:
        lines.append("")
        lines.append(f"Requests: {req['finished']}/{req['arrived']} "
                     f"finished, {req['output_tokens']:g} output tokens.")
    return "\n".join(lines)
