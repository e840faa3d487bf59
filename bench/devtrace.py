"""The device timeline of a traced run, read from ``torch.profiler``.

``Timeline`` keeps, for the profiled steps only, every device activity
(kernels, copies, fills) and the host ranges the harness labels with
``torch.profiler.record_function``, on the profiler's clock in seconds.
The program's spans (``repro_torch.metrics.spans.NAMES``) open such ranges
too; the profiler mirrors every range on the device as an annotation,
which `labels` keeps from counting as device activity.
From them: the seconds the device was busy (the union of its activities),
the device time of kernels by name, and the idle gaps between activities,
each named by the innermost labelled host range it falls in.
"""

from __future__ import annotations

import bisect

#: host ranges the harness labels (the profiler mirrors each on the device
#: timeline as an annotation, which is no device activity)
LABELS = ("sched.select_batch", "predictor.initial", "predictor.on_prefill",
          "predictor.on_token", "model.prefill_chunk", "model.decode_multi",
          "engine.device_step", "bench.step")


def labels() -> tuple:
    """Every labelled host range: the harness's and the program's spans."""
    from repro_torch.metrics import spans
    return LABELS + spans.NAMES


def _events(prof):
    """(name, on device, start s, end s) of every profiled event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        out.append((e.name(), "cuda" in str(e.device_type()).lower(), start,
                    start + e.duration_ns() * 1e-9))
    return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap(merged, a: float, b: float) -> float:
    """Length of [a, b] that sorted, disjoint intervals cover."""
    i = max(bisect.bisect_right([x for x, _ in merged], a) - 1, 0)
    tot = 0.0
    while i < len(merged) and merged[i][0] < b:
        x, y = merged[i]
        tot += max(0.0, min(y, b) - max(x, a))
        i += 1
    return tot


def short_name(name: str) -> str:
    """A kernel's name without its argument list."""
    return name.split("(", 1)[0][:120]


class Timeline:
    """Device activity and labelled host ranges of the profiled steps."""

    def __init__(self, prof):
        ev = _events(prof)
        names = set(labels())
        steps = sorted((a, b) for n, d, a, b in ev
                       if not d and n == "bench.step")
        self.steps = steps
        if steps:
            lo, hi = steps[0][0], steps[-1][1]
        else:
            lo = hi = 0.0
        self.start, self.end = lo, hi
        self.device = [(n, a, b) for n, d, a, b in ev
                       if d and n not in names and b > lo and a < hi]
        self.ranges = [(n, a, b) for n, d, a, b in ev
                       if not d and n in names and b > lo and a < hi]
        self.busy = _union([(max(a, lo), min(b, hi))
                            for _, a, b in self.device])

    @property
    def window_s(self) -> float:
        """Length of the traced window: the profiled steps, end to end."""
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        """Seconds in which some activity ran on the device."""
        return sum(b - a for a, b in self.busy)

    def busy_in_steps(self) -> tuple[float, float]:
        """(device-busy seconds inside the steps, the steps' seconds)."""
        span = sum(b - a for a, b in self.steps)
        return sum(_overlap(self.busy, a, b) for a, b in self.steps), span

    def kernel_s(self, substrings) -> float | None:
        """Summed device time of kernels whose name holds any of the
        substrings; None where no such kernel ran."""
        hits = [b - a for n, a, b in self.device
                if any(s in n for s in substrings)]
        return sum(hits) if hits else None

    def top_ops(self, k: int = 10) -> list:
        """The k device operations that took most time: [name, seconds]."""
        tot: dict[str, float] = {}
        for n, a, b in self.device:
            tot[short_name(n)] = tot.get(short_name(n), 0.0) + (b - a)
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])
                [:k]]

    def _segments(self):
        """The labelled host ranges flattened into non-overlapping
        segments, each named by the innermost range over it."""
        bounds = sorted({t for _, a, b in self.ranges for t in (a, b)})
        segs = []
        for a, b in zip(bounds, bounds[1:]):
            mid = 0.5 * (a + b)
            inner = None
            for n, x, y in self.ranges:
                if x <= mid < y and (inner is None or x >= inner[1]):
                    inner = (n, x)
            if inner is not None:
                segs.append((a, b, inner[0]))
        return segs

    def idle_gaps(self, k: int = 10) -> list:
        """Device idle time inside the traced window, by the innermost
        labelled host range that was running: the k longest [name,
        seconds] totals ("harness" where no range was open)."""
        gaps, t = [], self.start
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        segs = self._segments()
        tot: dict[str, float] = {}
        i = 0
        for a, b in gaps:           # both sorted: one sweep
            while i < len(segs) and segs[i][1] <= a:
                i += 1
            covered, j = 0.0, i
            while j < len(segs) and segs[j][0] < b:
                x, y, n = segs[j]
                o = max(0.0, min(y, b) - max(x, a))
                if o:
                    tot[n] = tot.get(n, 0.0) + o
                    covered += o
                j += 1
            if b - a > covered:
                tot["harness"] = tot.get("harness", 0.0) + (b - a - covered)
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])
                [:k]]

    def idle_share(self) -> float | None:
        """Percent of the profiled steps' time with no device activity."""
        if not self.steps:
            return None
        busy, span = self.busy_in_steps()
        return 100.0 * (1.0 - busy / span) if span > 0 else None
