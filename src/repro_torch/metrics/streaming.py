"""Exact, mergeable percentile accumulators for the metrics rollup.

Benchmark-scale request counts (10^2..10^6) fit comfortably in memory,
so approximation sketches (t-digest, P²) would trade accuracy for
nothing here: `StreamingQuantiles` keeps every sample in an amortized
-growth flat buffer and answers percentile queries *exactly*, matching
``numpy.percentile(..., method="linear")`` bit-for-bit
(``tests/test_metrics.py`` pins this against random samples). The
streaming part is the API: O(1) amortized `add()`, mergeable across
cluster replicas, and deterministic summaries independent of insertion
order.
"""

from __future__ import annotations

import numpy as np

#: The tail percentiles every benchmark reports.
DEFAULT_PERCENTILES = (50.0, 90.0, 99.0)


class StreamingQuantiles:
    """Exact percentile accumulator over a growing sample stream.

    Samples append into a pre-sized numpy buffer (doubling growth);
    queries sort a copy on demand and cache the sorted view until the
    next mutation. Summaries are a function of the sample *multiset*
    only — insertion and merge order never change a digit, which the
    replay-determinism guarantee relies on.
    """

    __slots__ = ("_buf", "_n", "_sorted")

    def __init__(self, values=None):
        self._buf = np.empty(64, np.float64)
        self._n = 0
        self._sorted = None
        if values is not None:
            self.extend(values)

    def __len__(self) -> int:
        return self._n

    def _grow(self, need: int):
        cap = len(self._buf)
        if self._n + need <= cap:
            return
        while cap < self._n + need:
            cap *= 2
        buf = np.empty(cap, np.float64)
        buf[:self._n] = self._buf[:self._n]
        self._buf = buf

    def add(self, x: float):
        """Append one sample (O(1) amortized)."""
        self._grow(1)
        self._buf[self._n] = x
        self._n += 1
        self._sorted = None

    def extend(self, xs):
        """Append a batch of samples."""
        xs = np.asarray(list(xs) if not isinstance(xs, np.ndarray) else xs,
                        np.float64)
        self._grow(len(xs))
        self._buf[self._n:self._n + len(xs)] = xs
        self._n += len(xs)
        self._sorted = None

    def merge(self, other: "StreamingQuantiles") -> "StreamingQuantiles":
        """Fold another accumulator's samples into this one."""
        self.extend(other.values())
        return self

    def values(self) -> np.ndarray:
        """The raw samples seen so far (insertion order)."""
        return self._buf[:self._n].copy()

    def _view(self) -> np.ndarray:
        if self._sorted is None:
            self._sorted = np.sort(self._buf[:self._n])
        return self._sorted

    def percentile(self, q: float) -> float:
        """Exact q-th percentile (numpy ``method="linear"``); 0 if empty."""
        if self._n == 0:
            return 0.0
        return float(np.percentile(self._view(), q))

    def mean(self) -> float:
        """Sample mean (0 if empty). Computed over the *sorted* view so
        the result is insertion/merge-order invariant bit-for-bit (numpy
        pairwise summation is order-sensitive in the last ulp)."""
        return float(np.mean(self._view())) if self._n else 0.0

    def attainment(self, threshold: float) -> float:
        """Fraction of samples <= threshold (SLO attainment); 0 if empty."""
        if self._n == 0:
            return 0.0
        return float(np.searchsorted(self._view(), threshold, side="right")
                     / self._n)

    def summary(self, percentiles=DEFAULT_PERCENTILES) -> dict:
        """Mean / min / max plus the requested percentiles as one dict."""
        if self._n == 0:
            out = {"n": 0, "mean": 0.0, "min": 0.0, "max": 0.0}
            out.update({f"p{_plabel(q)}": 0.0 for q in percentiles})
            return out
        v = self._view()
        out = {"n": self._n, "mean": self.mean(),
               "min": float(v[0]), "max": float(v[-1])}
        for q in percentiles:
            out[f"p{_plabel(q)}"] = float(np.percentile(v, q))
        return out


def _plabel(q: float) -> str:
    """Percentile label: 50.0 -> "50", 99.9 -> "99.9"."""
    return f"{q:g}"
