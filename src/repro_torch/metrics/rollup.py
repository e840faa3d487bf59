"""Roll a per-request event log up into distribution-level metrics.

`rollup()` consumes an `EventLog` (one engine's, or a cluster merge) and
produces the benchmark-facing report: per-metric mean + exact
p50/p90/p99 for TTFT, TBT (inter-token latency), completion time,
slowdown, and per-token normalized latency; SLO-attainment curves over
fixed threshold grids; and preemption / swap / prefix-cache counters.

Metric definitions (all in engine-clock seconds):

* **TTFT**  — first token time minus arrival.
* **TBT**   — gap between consecutive output tokens of one request,
  *excluding* the TTFT gap. A decode megastep materializes k tokens at
  one timestamp; their shared inter-step gap is split evenly across the
  k tokens (and extra tokens inside the *first* token event count a
  0-gap — they reached the stream in the same flush).
* **completion** — finish minus arrival.
* **slowdown** — completion divided by the request's ideal isolated
  service time (supplied via ``service_times``, e.g. from
  `CostModel.ideal_service_time`); omitted when no estimate is given.
* **latency_per_token** — completion divided by output length (the
  learning-to-rank literature's normalized latency).
"""

from __future__ import annotations

from repro_torch.metrics.events import EventLog
from repro_torch.metrics.streaming import (DEFAULT_PERCENTILES,
                                           StreamingQuantiles)

#: Default SLO threshold grids (seconds). Fixed — not data-derived — so
#: attainment curves are comparable across policies, seeds, and runs.
DEFAULT_SLOS: dict[str, tuple] = {
    "ttft": (0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0),
    "tbt": (0.05, 0.1, 0.2, 0.5, 1.0, 2.0),
    "completion": (5.0, 15.0, 30.0, 60.0, 120.0, 300.0),
}


def _attainment_curve(acc: StreamingQuantiles, slos) -> list[dict]:
    return [{"slo_s": float(s), "attainment": acc.attainment(s)}
            for s in slos]


def ideal_service_times(cost_model, requests) -> dict[int, float]:
    """rid → isolated completion time, the slowdown denominator.

    The single definition shared by the serve CLI and the benchmarks —
    evaluated through `CostModel.ideal_service_time` so the slowdown
    metric can never drift between emitters.
    """
    return {r.rid: cost_model.ideal_service_time(len(r.prompt),
                                                 r.true_out_len)
            for r in requests}


def rollup(log: EventLog, *, service_times: dict[int, float] | None = None,
           slos: dict[str, tuple] | None = None,
           percentiles=DEFAULT_PERCENTILES,
           tenants: dict[int, str] | None = None) -> dict:
    """Aggregate an event log into the benchmark-facing metrics report.

    Args:
        log: the captured event stream (`Engine(event_log=...)`).
        service_times: optional rid → ideal isolated service time
            (seconds); enables the ``slowdown`` distribution.
        slos: per-metric SLO threshold grids; defaults to `DEFAULT_SLOS`.
            Keys: ``ttft`` | ``tbt`` | ``completion``.
        percentiles: which percentiles each summary carries.
        tenants: optional rid → tenant label; when given, the report
            gains a ``per_tenant`` section with per-tenant TTFT and
            completion summaries (the per-tenant p99 split that makes
            cross-tenant starvation visible). Absent by default so
            existing reports keep their exact structure.

    Returns:
        A JSON-ready dict: ``requests`` (arrived/finished counts),
        per-metric summaries, ``slo_attainment`` curves, and counters
        (including the tail-facing ``max_wait_s`` — the worst
        first-token wait observed, charging still-waiting requests up
        to the log's last event — and ``preemptions_per_request``).
        Deterministic: identical logs yield byte-identical
        ``json.dumps(..., sort_keys=True)`` output.
    """
    slos = {**DEFAULT_SLOS, **(slos or {})}
    ttft = StreamingQuantiles()
    tbt = StreamingQuantiles()
    completion = StreamingQuantiles()
    slowdown = StreamingQuantiles()
    per_token = StreamingQuantiles()
    n_arrived = n_finished = 0
    n_cancelled = n_timeouts = n_shed = n_retries = 0
    replica_downs = 0
    preemptions = 0
    handoffs = 0
    handoff_pages = 0.0
    swap_bytes = 0.0
    prefix_hit_tokens = 0.0
    total_tokens = 0.0
    max_wait = 0.0
    t_end = 0.0
    unstarted_arrivals: list[float] = []
    by_tenant: dict[str, dict[str, StreamingQuantiles]] = {}

    for rid, evs in sorted(log.per_request().items()):
        arrival = first_tok = finish = None
        cancelled = False
        tok_events: list[tuple[float, int]] = []
        for e in evs:
            if e.kind == "arrival" and arrival is None:
                arrival = e.t
            elif e.kind == "first_token" and first_tok is None:
                first_tok = e.t
            elif e.kind == "tokens":
                tok_events.append((e.t, int(e.value)))
                total_tokens += e.value
            elif e.kind == "finish" and finish is None:
                finish = e.t
            elif e.kind == "preempt":
                preemptions += 1
            elif e.kind == "swap":
                swap_bytes += e.value
            elif e.kind == "prefix_hit":
                prefix_hit_tokens += e.value
            elif e.kind in ("cancel", "timeout", "shed"):
                if not cancelled:           # one terminal cancel per rid
                    cancelled = True
                    n_cancelled += 1
                    if e.kind == "timeout":
                        n_timeouts += 1
                    elif e.kind == "shed":
                        n_shed += 1
            elif e.kind == "retry":
                n_retries += 1
            elif e.kind == "replica_down":
                replica_downs += 1
            elif e.kind == "handoff":
                handoffs += 1
                handoff_pages += e.value
        if evs:
            t_end = max(t_end, max(e.t for e in evs))
        tenant = tenants.get(rid) if tenants else None
        if arrival is not None:
            n_arrived += 1
            if first_tok is not None:
                # TTFT is determined at the first token — record it even
                # for in-flight requests, or a mid-run rollup would drop
                # exactly the long-stuck started-but-unfinished tail and
                # flatter the TTFT distribution
                ttft.add(first_tok - arrival)
                max_wait = max(max_wait, first_tok - arrival)
                if tenant is not None:
                    by_tenant.setdefault(tenant, {
                        "ttft": StreamingQuantiles(),
                        "completion": StreamingQuantiles(),
                    })["ttft"].add(first_tok - arrival)
            else:
                # never started: charge its wait up to the log's last
                # event (resolved once t_end is final, after the loop)
                unstarted_arrivals.append(arrival)
        if finish is None or arrival is None:
            continue                    # unfinished: TTFT + counters only
        n_finished += 1
        lat = finish - arrival
        completion.add(lat)
        if tenant is not None:
            by_tenant.setdefault(tenant, {
                "ttft": StreamingQuantiles(),
                "completion": StreamingQuantiles(),
            })["completion"].add(lat)
        out_len = sum(n for _, n in tok_events)
        if out_len > 0:
            per_token.add(lat / out_len)
        if service_times and rid in service_times and service_times[rid] > 0:
            slowdown.add(lat / service_times[rid])
        # inter-token gaps: megastep events spread their gap over their
        # k tokens; the first event's extra tokens landed in one flush
        prev_t = None
        for t, n in tok_events:
            if n <= 0:
                continue
            if prev_t is None:
                if n > 1:
                    tbt.extend([0.0] * (n - 1))
            else:
                tbt.extend([(t - prev_t) / n] * n)
            prev_t = t

    report = {
        "requests": {"arrived": n_arrived, "finished": n_finished,
                     "cancelled": n_cancelled,
                     # goodput: fraction of arrived requests actually
                     # served to completion — cancelled/timed-out/shed/
                     # lost requests all count against it
                     "goodput": (n_finished / n_arrived
                                 if n_arrived else 0.0),
                     "output_tokens": total_tokens},
        "ttft": ttft.summary(percentiles),
        "tbt": tbt.summary(percentiles),
        "completion": completion.summary(percentiles),
        "latency_per_token": per_token.summary(percentiles),
        "slo_attainment": {
            "ttft": _attainment_curve(ttft, slos["ttft"]),
            "tbt": _attainment_curve(tbt, slos["tbt"]),
            "completion": _attainment_curve(completion, slos["completion"]),
        },
        "counters": {"preemptions": preemptions,
                     "preemptions_per_request": (preemptions / n_arrived
                                                 if n_arrived else 0.0),
                     "max_wait_s": max(
                         [max_wait] + [t_end - a
                                       for a in unstarted_arrivals]),
                     "swap_bytes": swap_bytes,
                     "prefix_hit_tokens": prefix_hit_tokens,
                     "cancelled": n_cancelled,
                     "timeouts": n_timeouts,
                     "shed": n_shed,
                     "retries": n_retries,
                     "replica_downs": replica_downs,
                     "handoffs": handoffs,
                     "handoff_pages": handoff_pages},
    }
    if len(slowdown):
        report["slowdown"] = slowdown.summary(percentiles)
    if tenants is not None:
        report["per_tenant"] = {
            tenant: {"ttft": accs["ttft"].summary(percentiles),
                     "completion": accs["completion"].summary(percentiles)}
            for tenant, accs in sorted(by_tenant.items())
        }
    return report
