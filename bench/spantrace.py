"""A traced run of one cell with the program's own spans switched on.

    python3 bench/spantrace.py --workload NAME --seed N --seconds S

from the root of a checkout, on a machine with the card the cell asks for.
It is ``bench/run.py --trace 1`` (the same set-up, traffic, profiled steps,
checks and result line) with the spans of ``repro_torch.metrics.spans``
switched on: the engine's on every step, the model's, the MoE layer's and
the kernel bindings' on the profiled steps alone, and an ``EventLog`` on
the engine, whose real-mode events carry ``wall`` stamps on the spans'
clock. The line gains ``spans``: the metrics of `READERS`, and the checks
of the spans against the profiler (`span_checks`). The profiled steps'
idle gaps (``breakdown.idle_gaps``) are then named by the innermost
program span open over them, the program's annotations on the device
being no device activity (`SpanTimeline`).
"""

from __future__ import annotations

if __name__ == "__main__":
    import run  # noqa: F401  the entry's caches and path, before torch

import bisect
import heapq
import json
import sys

import devtrace
import harness
import stats


labels = devtrace.labels


def _events(prof):
    """(name, on device, start s, end s, correlation id or 0) of every
    profiled event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        corr = e.correlation_id() if hasattr(e, "correlation_id") else 0
        out.append((e.name(), "cuda" in str(e.device_type()).lower(), start,
                    start + e.duration_ns() * 1e-9, corr))
    return out


class SpanTimeline(devtrace.Timeline):
    """``devtrace.Timeline`` over the harness's labels and the program's
    spans, with the activities each range launched: matched through the
    correlation id the profiler gives both a runtime call (``cu*``) and
    the activity it started."""

    def __init__(self, prof):
        names = set(labels())
        ev = _events(prof)
        steps = sorted((a, b) for n, d, a, b, _ in ev
                       if not d and n == "bench.step")
        self.steps = steps
        lo, hi = (steps[0][0], steps[-1][1]) if steps else (0.0, 0.0)
        self.start, self.end = lo, hi
        dev = [(n, a, b, c) for n, d, a, b, c in ev
               if d and n not in names and b > lo and a < hi]
        self.device = [(n, a, b) for n, a, b, _ in dev]
        self.device_corr = [c for *_, c in dev]
        self.ranges = [(n, a, b) for n, d, a, b, _ in ev
                       if not d and n in names and b > lo and a < hi]
        #: (start s, correlation id) of each runtime call on the host
        self.calls = sorted((a, c) for n, d, a, _, c in ev
                            if not d and c and n.startswith("cu"))
        self.busy = devtrace._union([(max(a, lo), min(b, hi))
                                     for _, a, b in self.device])

    def _segments(self):
        """The labelled host ranges flattened into non-overlapping
        segments, each named by the innermost range over it: of the ranges
        open at the segment's middle, the one that opened last (the later
        in the profiler's order on a tie). A sweep, as detail spans put
        thousands of ranges in a profile."""
        bounds = sorted({t for _, a, b in self.ranges for t in (a, b)})
        opening = sorted((x, i) for i, (_, x, _) in enumerate(self.ranges))
        open_, k, segs = [], 0, []      # heap of (-start, -index, end, name)
        for a, b in zip(bounds, bounds[1:]):
            mid = 0.5 * (a + b)
            while k < len(opening) and opening[k][0] <= mid:
                x, i = opening[k]
                n, _, y = self.ranges[i]
                heapq.heappush(open_, (-x, -i, y, n))
                k += 1
            while open_ and open_[0][2] <= mid:     # closed before mid
                heapq.heappop(open_)
            if open_:
                segs.append((a, b, open_[0][3]))
        return segs

    def starts(self, label: str) -> list[float]:
        """Start times, in order, of the host ranges named ``label``."""
        return sorted(a for n, a, _ in self.ranges if n == label)

    def launched_in(self, label: str) -> tuple[list[str], int]:
        """(the names of the device activities that runtime calls made
        inside host ranges named ``label`` started, the number of such
        ranges)."""
        spans = sorted((a, b) for n, a, b in self.ranges if n == label)
        starts = [a for a, _ in spans]
        ids = set()
        for t, c in self.calls:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < spans[i][1]:
                ids.add(c)
        return ([n for (n, _, _), c in zip(self.device, self.device_corr)
                 if c in ids], len(spans))


# -- the metrics the spans give ------------------------------------------
# Three are the benchmark's own readers (``metrics/``), which a traced run
# of ``run.py`` reports too.
#: the device calls and the waits for their outputs inside engine.step
DEVICE_PARTS = harness.metric_module("engine.host_ms_per_step").DEVICE_PARTS


def launches_per_megastep(rec):
    """Device activities (kernels, copies, fills) per decode megastep in
    the profiled steps: every activity a runtime call made inside the
    program's engine.decode range started, over the number of such
    ranges."""
    tl = rec.timeline
    if tl is None:
        return None
    names, n = tl.launched_in("engine.decode")
    return len(names) / n if n else None


def queue_wait_p90_s(rec):
    """90th percentile over the measured requests of the wait for
    admission: the ``wall`` stamp of a request's first ``admit`` less that
    of its ``arrival`` in the engine's pool, in seconds; a request never
    admitted ranks last at the time it had waited when the run stopped."""
    if not rec.waits:
        return None
    return stats.tail([w for w, _ in rec.waits],
                      [so_far for _, so_far in rec.waits], 90)


#: name, unit and reader of each metric the spans give
READERS = (
    ("model.decode_host_ms_per_megastep", "ms",
     harness.reader("model.decode_host_ms_per_megastep")),
    ("model.launches_per_megastep", "launches", launches_per_megastep),
    ("engine.fetch_wait_ms_per_step", "ms",
     harness.reader("engine.fetch_wait_ms_per_step")),
    ("engine.host_ms_per_step", "ms",
     harness.reader("engine.host_ms_per_step")),
    ("sched.queue_wait_p90_s", "s", queue_wait_p90_s),
)


class SpanRun(harness.Run):
    """A traced ``harness.Run`` with the program's spans switched on around
    each ``Engine.step``: ``CLOCK`` on every step, ``DETAIL`` on the
    profiled ones. Each step keeps the totals its spans took
    (``Step.spans``) and the launches each binding counted
    (``Step.launches``), as in every run; the record keeps each measured
    request's wait for admission (``Record.waits``)."""

    def __init__(self, cell, seed: int, seconds: float, t_start: float,
                 **kw):
        from repro_torch.metrics import spans
        super().__init__(cell, seed, seconds, True, t_start, **kw)
        self.sp = spans
        self.offset_ns = None

    def new_engine(self):
        from repro_torch.metrics import EventLog
        super().new_engine()
        self.eng.events = EventLog()

    def span_level(self, s) -> int:
        sp = self.sp
        if s is not None and s.profiled:
            if self.offset_ns is None:
                self.offset_ns = sp.clock_offset_ns()
            return sp.DETAIL
        return sp.CLOCK

    def record(self):
        prof, self.prof = self.prof, None   # the timeline is built below
        rec = super().record()
        self.prof = prof
        rec.timeline = SpanTimeline(prof) if prof is not None else None
        rec.waits = self._waits()
        return rec

    def _waits(self) -> list:
        """Each measured request's wait for admission on the spans' clock:
        from its ``arrival`` event to its first ``admit``, in seconds; a
        request never admitted has None and the time it had waited when
        the run stopped."""
        stop_ns = round((self.t0 + self.t_stop) * 1e9)
        first: dict[tuple, int] = {}
        for e in self.eng.events.events:
            first.setdefault((e.rid, e.kind), e.wall)
        out = []
        for it in self.measured:
            a = first.get((it.idx, "arrival"))
            b = first.get((it.idx, "admit"))
            if a is not None:
                out.append((None if b is None else (b - a) * 1e-9,
                            (stop_ns - a) * 1e-9))
        return out

    def execute(self) -> dict:
        line = super().execute()
        rec = self.rec
        got = {}
        for name, unit, read in READERS:
            v = read(rec)
            if v is not None:
                got[name] = {"value": v, "unit": unit}
        line["spans"] = {"metrics": got, **self.span_checks(rec)}
        return line

    def span_checks(self, rec) -> dict:
        """What the spans are held to: the mean ``engine.step`` of the
        unprofiled window steps beside the sum of its parts; the offset
        from the spans' clock to the profiler's, read as the profiler
        started, and for each profiled step the start of its
        ``engine.step`` range on the profiler's clock less the span's own
        stamp moved by that offset (microseconds); the ``decode_kernel``
        launches the trace finds inside ``engine.decode`` beside those the
        paged binding counted in the same steps; the share of the profiled
        idle seconds that no span below ``engine.decode`` names; and the
        unprofiled steps' mean host seconds."""
        out = {}
        steps = [s for s in rec.steps if "engine.step" in s.spans]
        if steps:
            out["step_ms_mean"] = 1e-6 * sum(
                s.spans["engine.step"]["total_ns"] for s in steps) / len(steps)
            out["parts_ms_mean"] = 1e-6 * sum(
                s.spans.get(p, {}).get("total_ns", 0)
                for s in steps for p in DEVICE_PARTS) / len(steps)
            out["step_s_mean_unprofiled"] = (sum(s.wall for s in steps)
                                             / len(steps))
        tl = rec.timeline
        traced = [s for s in rec.traced if "engine.step" in s.spans]
        starts = tl.starts("engine.step") if tl is not None else []
        if self.offset_ns is not None and traced and starts:
            off = self.offset_ns
            out["span_clock"] = {
                "offset_ns": off,
                "residual_us": [1e6 * min(
                    (r - (s.spans["engine.step"]["first_ns"] + off) * 1e-9
                     for r in starts), key=abs) for s in traced]}
            names, _ = tl.launched_in("engine.decode")
            out["decode_kernel_launches"] = {
                "trace": sum("decode_kernel" in n for n in names),
                "binding": sum(s.launches.get("paged_decode_attention", 0)
                               for s in traced)}
        if tl is not None:
            gaps = dict(tl.idle_gaps(k=10**6))
            idle = sum(gaps.values())
            if idle > 0:
                out["idle_unnamed_in_decode"] = (
                    (gaps.get("engine.decode", 0.0)
                     + gaps.get("model.decode_multi", 0.0)) / idle)
        return out


def main(argv=None) -> int:
    import argparse

    import run
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(run.ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    line = SpanRun(cell, args.seed, args.seconds, run.T_START).execute()
    bad = harness.blocked_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    print("\n".join(harness.check_lines(line)), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
