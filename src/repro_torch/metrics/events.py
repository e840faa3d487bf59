"""Per-request event log captured from the engine's step stream.

One `Event` is a timestamped lifecycle transition of one request; an
`EventLog` is the append-only stream one engine (or one merged cluster)
produced. The engine emits events inside ``Engine.step()`` — observation
only, never control flow — so enabling the log cannot change scheduling
results (``tests/test_metrics.py`` pins this byte-for-byte).

Event kinds (``Event.kind``):

* ``arrival``     — the request entered the engine's pool (t = its
  arrival timestamp, which may precede the emitting step's clock).
* ``admit``       — the scheduler moved it WAITING/PREEMPTED → RUNNING.
* ``first_token`` — the first output token materialized.
* ``tokens``      — ``value`` output tokens materialized at time t (one
  event per decode megastep; sim mode emits value=1 per step).
* ``finish``      — the request completed.
* ``preempt``     — the scheduler preempted it (``value`` = preemption
  count so far).
* ``swap``        — KV bytes crossed the device↔host DMA link
  (``value`` = bytes; covers swap-out and swap-in).
* ``prefix_hit``  — prompt tokens served from the KV prefix cache at
  admission (``value`` = tokens).

In real mode the engine also stamps each event with ``wall``, the
``time.perf_counter_ns()`` reading when it was emitted: the clock of
`repro_torch.metrics.spans`, so a request's events lie on the timeline of
the spans of the steps that served it. ``t`` stays the engine's clock.
Sim mode leaves ``wall`` unset, and an event without it is the
reference's, in `Event.as_dict` too.

Resilience kinds (the failure/overload layer):

* ``cancel``       — the request was cancelled explicitly
  (`Engine.cancel`); its KV footprint is fully released.
* ``timeout``      — cancelled because its completion or TTFT deadline
  expired (checked at megastep boundaries on the engine clock).
* ``shed``         — cancelled by predicted-work load shedding: the
  engine's predicted backlog exceeded the shed watermark and this was
  among the worst-ranked waiting requests (or it was refused at
  admission under admission control).
* ``retry``        — the router re-dispatched the request to a surviving
  replica after a fault (``value`` = retry count so far); a fresh
  ``arrival`` event follows on the new replica.
* ``replica_down`` / ``replica_up`` — a replica crashed / recovered
  (``rid`` = -1, ``value`` = replica index; emitted by the router).

Disaggregation kinds (the prefill/decode split):

* ``handoff``     — the request's paged KV was exported from this
  replica for migration to another (``value`` = pages shipped; 0 means
  the destination re-prefills). Emitted on the source; the request's
  later events continue on the destination replica — the merged-log
  per-request ordering still holds because import time is never earlier
  than export time.
"""

from __future__ import annotations

from dataclasses import dataclass

#: Every kind an `Event` may carry, in lifecycle order.
EVENT_KINDS = ("arrival", "admit", "first_token", "tokens", "finish",
               "preempt", "swap", "prefix_hit",
               "cancel", "timeout", "shed", "retry",
               "replica_down", "replica_up", "handoff")

#: The cancellation-reason kinds a terminal cancel event may carry.
CANCEL_KINDS = ("cancel", "timeout", "shed")

#: Kinds that occur at most once per request, in their required order.
_ORDERED_ONCE = ("arrival", "first_token", "finish")


@dataclass(frozen=True)
class Event:
    """One timestamped request-lifecycle transition.

    Attributes:
        t: engine-clock timestamp in seconds (sim clock in sim mode).
        rid: the request id.
        kind: one of `EVENT_KINDS`.
        value: kind-specific payload (tokens emitted, bytes swapped,
            preemption count); 0.0 where meaningless.
        wall: ``perf_counter_ns()`` when the event was emitted (real
            mode), or None.
    """

    t: float
    rid: int
    kind: str
    value: float = 0.0
    wall: int | None = None

    def as_dict(self) -> dict:
        """JSON-friendly form (stable key order for deterministic dumps);
        ``wall`` only where it is set."""
        d = {"t": self.t, "rid": self.rid, "kind": self.kind,
             "value": self.value}
        if self.wall is not None:
            d["wall"] = self.wall
        return d


class EventLog:
    """Append-only stream of request events from one engine (or merged).

    The engine holds a reference and calls `emit()` from inside
    ``step()``; the cluster router merges its replicas' logs with
    `merge()` (re-sorted by timestamp — per-request ordering survives
    because a request lives on exactly one replica).
    """

    def __init__(self):
        self.events: list[Event] = []

    def __len__(self) -> int:
        return len(self.events)

    def emit(self, t: float, rid: int, kind: str, value: float = 0.0,
             wall: int | None = None):
        """Append one event (no validation on the hot path)."""
        self.events.append(Event(float(t), rid, kind, float(value), wall))

    def clear(self):
        """Drop all events (the engine's ``run()`` reset)."""
        self.events.clear()

    def merge(self, other: "EventLog") -> "EventLog":
        """Fold another log into this one, keeping global time order."""
        self.events = EventLog.merge_all([self, other]).events
        return self

    @classmethod
    def merge_all(cls, logs) -> "EventLog":
        """Merge any number of logs with one concatenate-and-sort.

        The single home of the deterministic merge key —
        ``(t, rid, emission index)`` — so pairwise `merge` and the
        cluster router's N-replica merge can never diverge. Ties across
        logs resolve by log order, within a log by emission order.
        """
        combined = [(e.t, e.rid, i, e) for i, e in enumerate(
            e for log in logs for e in log.events)]
        combined.sort(key=lambda x: (x[0], x[1], x[2]))
        merged = cls()
        merged.events = [e for _, _, _, e in combined]
        return merged

    def per_request(self) -> dict[int, list[Event]]:
        """Group events by rid, preserving emission order within each."""
        out: dict[int, list[Event]] = {}
        for e in self.events:
            out.setdefault(e.rid, []).append(e)
        return out

    def as_dicts(self) -> list[dict]:
        """The whole stream as JSON-friendly dicts."""
        return [e.as_dict() for e in self.events]


def check_invariants(log: EventLog) -> None:
    """Raise ``AssertionError`` on any broken per-request invariant.

    Enforced per request: timestamps are non-decreasing in emission
    order; ``arrival <= admit <= first_token <= finish``; TTFT never
    exceeds completion time; a finished request has a first token and
    at least one ``tokens`` event; token events never precede admission.

    Violations are raised explicitly (never via the ``assert``
    statement), so the benchmarks' pre-artifact gates stay armed under
    ``python -O``.
    """
    def _require(cond: bool, msg: str):
        """Explicit raise — immune to python -O assert stripping."""
        if not cond:
            raise AssertionError(msg)

    for rid, evs in log.per_request().items():
        times = [e.t for e in evs]
        _require(all(a <= b for a, b in zip(times, times[1:])),
                 f"rid {rid}: non-monotone event timestamps {times}")
        first: dict[str, float] = {}
        for e in evs:
            first.setdefault(e.kind, e.t)
        order = [first[k] for k in _ORDERED_ONCE if k in first]
        _require(all(a <= b for a, b in zip(order, order[1:])),
                 f"rid {rid}: lifecycle out of order {first}")
        if "admit" in first:
            _require(first.get("arrival", first["admit"]) <= first["admit"],
                     f"rid {rid}: admitted before arrival")
        if "finish" in first:
            _require("first_token" in first,
                     f"rid {rid}: finished w/o token")
            _require("tokens" in first,
                     f"rid {rid}: finished w/o tokens event")
            arr = first.get("arrival", 0.0)
            ttft = first["first_token"] - arr
            completion = first["finish"] - arr
            _require(ttft <= completion + 1e-12,
                     f"rid {rid}: TTFT {ttft} > completion {completion}")
        if "tokens" in first and "admit" in first:
            _require(first["admit"] <= first["tokens"],
                     f"rid {rid}: tokens before admission")
        cancelled = [k for k in CANCEL_KINDS if k in first]
        if cancelled:
            _require("finish" not in first,
                     f"rid {rid}: both cancelled ({cancelled}) and finished")
            if "arrival" in first:
                _require(first["arrival"] <= min(first[k]
                                                 for k in cancelled),
                         f"rid {rid}: cancelled before arrival")
