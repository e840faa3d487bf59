"""Traffic from a mix file and a seed: when each request is due, its prompt
and its output length.

The length and arrival arithmetic follows ``repro_torch/serving/workload.py``
(prompts and outputs lognormal with the mix's median as the location
``log(median)``, truncated to an integer and clipped; Poisson gaps;
everything at once for a batch; the 2-state MMPP with its ON rate
``rate * burst_factor`` and an OFF rate that keeps the long-run mean). The
draws differ in one respect: every seed gets the same set of sizes and, for
Poisson traffic, the same set of gaps, in another order. Sizes are the
distribution's quantiles at (i + 0.5) / n, gaps the exponential's, scaled
so that a phase's gaps add up to its length. A seed then changes which
request gets which size, when it is due within its phase and what its
tokens are, but not how much work a phase holds, so runs on different
seeds measure the same load.

A run has up to three phases. ``fill`` (``fill_s`` seconds before the
window) fills the batch and is not measured; ``window`` (the run's
``--seconds``) holds the measured requests; ``tail`` (``drain_s``) keeps
arrivals coming at the same rate while the measured requests finish. A
``burst`` mix puts ``requests`` requests at the window's opening and has
no other phase.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

PHASES = ("fill", "window", "tail")


@dataclass
class Item:
    """One scheduled request."""

    idx: int                 # position in the schedule (due order)
    due: float               # seconds after the schedule starts
    prompt: list[int]
    out_len: int
    phase: str               # fill | window | tail

    @property
    def measured(self) -> bool:
        """Requests due inside the window are the measured ones."""
        return self.phase == "window"


def lognormal_sizes(n: int, spec: dict) -> list[int]:
    """The n stratified quantiles of a lognormal with median
    ``spec["median"]`` and ``spec["sigma"]``, truncated to integers and
    clipped to [``min``, ``max``] as workload.py clips its draws."""
    nd = NormalDist()
    mu, sig = math.log(spec["median"]), spec["sigma"]
    return [max(spec["min"], min(int(math.exp(mu + sig * nd.inv_cdf(
        (i + 0.5) / n))), spec["max"])) for i in range(n)]


def poisson_gaps(n: int, length: float) -> list[float]:
    """n stratified exponential gaps, scaled to add up to ``length``."""
    gaps = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    scale = length / sum(gaps)
    return [g * scale for g in gaps]


def mmpp_times(mix: dict, horizon: float) -> list[float]:
    """Arrival times of the mix's 2-state MMPP up to ``horizon``, drawn as
    workload.py draws them from one fixed stream, the same for every
    seed."""
    m = mix["mmpp"]
    rate, duty, fb = mix["rate"], m["duty"], m["burst_factor"]
    if duty * fb > 1.0:
        raise ValueError("mmpp duty * burst_factor must be <= 1")
    rate_on = rate * fb
    rate_off = rate * (1.0 - duty * fb) / (1.0 - duty)
    mean_on, mean_off = duty * m["cycle_s"], (1.0 - duty) * m["cycle_s"]
    rng = random.Random("mmpp:arrivals")
    t, on, out = 0.0, True, []
    t_switch = rng.expovariate(1.0 / mean_on)
    while True:
        r = rate_on if on else rate_off
        dt = rng.expovariate(r) if r > 0 else float("inf")
        if t + dt < t_switch:
            t += dt
            if t > horizon:
                return out
            out.append(t)
        else:
            t = t_switch
            on = not on
            t_switch = t + rng.expovariate(1.0 / (mean_on if on else
                                                 mean_off))


def phase_spans(mix: dict, seconds: float) -> dict[str, tuple[float, float]]:
    """(start, end) of each phase, in seconds after the schedule starts."""
    if mix["arrival"] == "burst":
        return {"window": (0.0, float(seconds))}
    fill, tail = float(mix["fill_s"]), float(mix["drain_s"])
    return {"fill": (0.0, fill), "window": (fill, fill + seconds),
            "tail": (fill + seconds, fill + seconds + tail)}


def _due_times(mix: dict, spans: dict, seed: int) -> dict[str, list[float]]:
    kind = mix["arrival"]
    if kind == "burst":
        return {"window": [0.0] * int(mix["requests"])}
    if kind == "poisson":
        out = {}
        for ph, (a, b) in spans.items():
            n = max(1, round(mix["rate"] * (b - a)))
            gaps = poisson_gaps(n, b - a)
            random.Random(f"{seed}:gaps:{ph}").shuffle(gaps)
            # the phase's last request falls on its end, so every phase
            # holds exactly n requests and ends where the next begins
            out[ph] = list(a + np.cumsum(gaps))
        return out
    if kind == "mmpp":
        times = mmpp_times(mix, max(b for _, b in spans.values()))
        return {ph: [t for t in times if a < t <= b]
                for ph, (a, b) in spans.items()}
    raise ValueError(f"unknown arrival process {kind!r}")


def schedule(mix: dict, seed: int, seconds: float, vocab: int) -> list[Item]:
    """Every request of one run, in due order."""
    spans = phase_spans(mix, seconds)
    dues = _due_times(mix, spans, seed)
    tok = np.random.default_rng([seed & (2**64 - 1), 7])
    items: list[Item] = []
    for ph in PHASES:
        if ph not in dues:
            continue
        n = len(dues[ph])
        plens = lognormal_sizes(n, mix["prompt"])
        olens = lognormal_sizes(n, mix["output"])
        random.Random(f"{seed}:prompt:{ph}").shuffle(plens)
        random.Random(f"{seed}:output:{ph}").shuffle(olens)
        for due, plen, olen in zip(dues[ph], plens, olens):
            prompt = tok.integers(1, vocab, size=plen).tolist()
            items.append(Item(len(items), float(due), prompt, olen, ph))
    items.sort(key=lambda it: (it.due, it.idx))
    for i, it in enumerate(items):
        it.idx = i
    return items
