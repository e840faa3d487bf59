"""First-class metrics layer: per-request event logs and rollups.

Submodules:

* ``events``    — `EventLog`: the per-request event stream (arrival /
  admit / first-token / tokens / finish / preempt / swap timestamps)
  captured by `Engine.step()` and merged across cluster replicas.
* ``streaming`` — `StreamingQuantiles`: an exact, mergeable percentile
  accumulator (validated against ``numpy.percentile``).
* ``rollup``    — `rollup()`: turn an event log into TTFT / TBT /
  completion-time / slowdown distributions (mean + p50/p90/p99),
  SLO-attainment curves, and preemption/swap counters.
* ``emitters``  — shared JSON and markdown-table emitters used by every
  benchmark artifact.
* ``spans``     — host spans inside the engine, the model and the kernel
  bindings, on the clock of the events' ``wall`` stamps (off unless
  switched on; the port's own, with no counterpart in the reference).
* ``counters``  — `GraphCounts`: a model's decode megasteps captured as
  a CUDA graph and replayed from one (the port's own).

The rest is a copy of the reference package's ``metrics`` (pure Python
and numpy): the same event stream rolls up into the same report, byte for
byte.
"""

from repro_torch.metrics.emitters import report_json, report_markdown
from repro_torch.metrics.events import Event, EventLog, check_invariants
from repro_torch.metrics.rollup import (DEFAULT_SLOS, ideal_service_times,
                                        rollup)
from repro_torch.metrics.streaming import StreamingQuantiles

__all__ = [
    "Event",
    "EventLog",
    "StreamingQuantiles",
    "check_invariants",
    "ideal_service_times",
    "rollup",
    "report_json",
    "report_markdown",
    "DEFAULT_SLOS",
]
