"""Deterministic fault injection for the cluster layer.

A `FaultSchedule` is a seeded, immutable description of what goes wrong
and when — replica crashes (with optional recovery), slowdown/straggler
windows, and transient submit failures. The `Router` consults it every
loop iteration (step-level health checks) and reacts: crashed replicas
are drained and their unfinished requests redispatched to survivors
with capped exponential backoff under a retry budget; stragglers are
excluded from dispatch while degraded; flaky submits redirect the
arrival to another replica (also charged against the retry budget).

Everything is driven by *virtual* time (the replicas' simulated clocks)
and a seeded RNG, so a chaos run is exactly reproducible: same schedule
+ same seed + same trace => byte-identical results.

The CLI encodes a schedule as a comma-separated ``--chaos`` spec,
parsed by `parse_chaos`::

    crash:R@T            replica R dies at time T (never recovers)
    crash:R@T-U          ...and recovers, empty, at time U
    slow:R@T-U*F         replica R runs F x slower in [T, U)
    flaky:R@T-U%P        submits to R fail w.p. P in [T, U)

e.g. ``--chaos crash:1@30,slow:0@10-20*4``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

#: recover_at value meaning "never recovers".
NEVER = math.inf


@dataclass(frozen=True)
class ReplicaCrash:
    """One replica failure: dead from ``at`` until ``recover_at``.

    Attributes:
        replica: index of the replica that fails.
        at: virtual time of the crash (enforced at the first megastep
            boundary at or after it).
        recover_at: virtual time the replica rejoins, empty (KV pool
            reclaimed, no requests); `NEVER` (the default) = permanent.
    """

    replica: int
    at: float
    recover_at: float = NEVER

    def __post_init__(self):
        if self.recover_at <= self.at:
            raise ValueError(
                f"recover_at {self.recover_at} must be after at {self.at}")


@dataclass(frozen=True)
class SlowdownWindow:
    """A straggler window: ``replica`` runs ``factor`` x slower.

    In ``[start, end)`` megastep times dilate; the router also excludes
    the replica from dispatch while degraded.
    """

    replica: int
    start: float
    end: float
    factor: float = 4.0

    def __post_init__(self):
        if self.factor <= 0:
            raise ValueError(f"slowdown factor must be positive: "
                             f"{self.factor}")
        if self.end <= self.start:
            raise ValueError(f"empty slowdown window [{self.start}, "
                             f"{self.end})")


@dataclass(frozen=True)
class FlakySubmit:
    """Transient submit failures on one replica.

    A dispatch to ``replica`` during ``[start, end)`` fails with
    probability ``fail_rate`` (seeded draw); the router retries the
    arrival elsewhere.
    """

    replica: int
    start: float
    end: float
    fail_rate: float = 0.5

    def __post_init__(self):
        if not 0.0 <= self.fail_rate <= 1.0:
            raise ValueError(f"fail_rate must be in [0, 1]: "
                             f"{self.fail_rate}")
        if self.end <= self.start:
            raise ValueError(f"empty flaky window [{self.start}, "
                             f"{self.end})")


@dataclass(frozen=True)
class FaultSchedule:
    """The full, immutable chaos plan for one cluster run.

    Attributes:
        crashes: `ReplicaCrash` tuple (at most one per replica — a
            crash-recover-crash sequence is not modeled).
        slowdowns: `SlowdownWindow` tuple (overlapping windows on one
            replica multiply).
        flaky: `FlakySubmit` tuple.
        seed: seed for the transient-failure draws (the router builds
            its RNG from it, so submit-failure outcomes are independent
            of every engine/workload stream).
    """

    crashes: tuple = ()
    slowdowns: tuple = ()
    flaky: tuple = ()
    seed: int = 0

    def __post_init__(self):
        seen = set()
        for c in self.crashes:
            if c.replica in seen:
                raise ValueError(
                    f"replica {c.replica} has multiple crash entries")
            seen.add(c.replica)

    def crash_for(self, replica: int) -> ReplicaCrash | None:
        """The crash entry for ``replica``, or None."""
        for c in self.crashes:
            if c.replica == replica:
                return c
        return None

    def slow_factor(self, replica: int, t: float) -> float:
        """Combined slowdown for ``replica`` at ``t`` (1.0 = healthy).

        Overlapping windows multiply.
        """
        f = 1.0
        for w in self.slowdowns:
            if w.replica == replica and w.start <= t < w.end:
                f *= w.factor
        return f

    def degraded(self, replica: int, t: float) -> bool:
        """True while ``replica`` is inside any slowdown window.

        The router excludes degraded replicas from dispatch.
        """
        return self.slow_factor(replica, t) != 1.0

    def flaky_rate(self, replica: int, t: float) -> float:
        """Submit-failure probability for ``replica`` at time ``t``.

        Independent windows compose: fail if any window fails.
        """
        ok = 1.0
        for w in self.flaky:
            if w.replica == replica and w.start <= t < w.end:
                ok *= 1.0 - w.fail_rate
        return 1.0 - ok


def parse_chaos(spec: str, seed: int = 0) -> FaultSchedule:
    """Parse a ``--chaos`` CLI spec into a `FaultSchedule`.

    Grammar (comma-separated entries)::

        crash:R@T | crash:R@T-U | slow:R@T-U*F | flaky:R@T-U%P

    Raises ValueError with a one-line actionable message on any
    malformed entry (the serve CLI surfaces it as an exit-2 error).
    """
    crashes: list[ReplicaCrash] = []
    slowdowns: list[SlowdownWindow] = []
    flaky: list[FlakySubmit] = []
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        try:
            kind, rest = entry.split(":", 1)
            rep_s, when = rest.split("@", 1)
            rep = int(rep_s)
            if kind == "crash":
                if "-" in when:
                    at_s, rec_s = when.split("-", 1)
                    crashes.append(ReplicaCrash(rep, float(at_s),
                                                float(rec_s)))
                else:
                    crashes.append(ReplicaCrash(rep, float(when)))
            elif kind == "slow":
                window, factor_s = when.split("*", 1)
                start_s, end_s = window.split("-", 1)
                slowdowns.append(SlowdownWindow(rep, float(start_s),
                                                float(end_s),
                                                float(factor_s)))
            elif kind == "flaky":
                window, rate_s = when.split("%", 1)
                start_s, end_s = window.split("-", 1)
                flaky.append(FlakySubmit(rep, float(start_s), float(end_s),
                                         float(rate_s)))
            else:
                raise ValueError(f"unknown fault kind {kind!r}")
        except ValueError as e:
            raise ValueError(
                f"bad --chaos entry {entry!r}: {e} (expected "
                "crash:R@T[-U], slow:R@T-U*F, or flaky:R@T-U%P)") from e
    return FaultSchedule(crashes=tuple(crashes), slowdowns=tuple(slowdowns),
                         flaky=tuple(flaky), seed=seed)


__all__ = ["FaultSchedule", "ReplicaCrash", "SlowdownWindow", "FlakySubmit",
           "parse_chaos", "NEVER"]
