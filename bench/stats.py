"""Percentiles and means over a run's requests.

The percentile is the one ``repro_torch/metrics/streaming.py`` takes
(``numpy.percentile``'s default: linear between the two closest ranks). A
request that failed (never finished by the end of the drain) has no time of
its own: it is given the time it had waited when the run stopped, a lower
bound, and sorts after every request that finished, so it misses any limit
a percentile sets.
"""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """q-th percentile (q in [0, 100]) of values already in rank order,
    linear between the two closest ranks."""
    if not values:
        raise ValueError("no values")
    pos = q / 100.0 * (len(values) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(values) - 1)
    return values[lo] + (pos - lo) * (values[hi] - values[lo])


def ranked(done: list, waited: list[float]) -> list[float]:
    """Each request's time in rank order: finished requests (``done`` not
    None) by their time, then failed ones at the time they had waited."""
    ok = sorted(t for t in done if t is not None)
    bad = sorted(w for t, w in zip(done, waited) if t is None)
    return ok + bad


def tail(done: list, waited: list[float], q: float) -> float:
    """The q-th percentile of the requests' times, failures last."""
    return percentile(ranked(done, waited), q)


def mean(done: list, waited: list[float]) -> float:
    """Mean time, a failed request counted at the time it had waited."""
    vals = [t if t is not None else w for t, w in zip(done, waited)]
    return sum(vals) / len(vals)
