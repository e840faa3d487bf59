"""Discrete-event M/G/1 simulator for SPRPT with limited preemption.

Paper Appendix D, with age-proportional memory tracking.

Single server, Poisson(lam) arrivals, Exp(1) service times, predictions
either perfect or exponential around the true size. Policies:

  fcfs / sjf (non-preemptive) / spjf (same as sjf) / srpt (C=inf ~ C=1 in
  paper notation: always preemptable) / sprpt-lp (preemption only while
  age < C * r).

Rank dynamics make event-driven simulation exact: between events the served
job's rank (r - a) only decreases, so preemption can only happen at arrival
or completion instants.

Memory model (Appendix D): a started-but-unfinished job holds memory equal
to its age (service received so far); we track the time series of total
memory and report peak and mean, plus mean/median response times.

A copy of the reference package's ``core/simulation.py`` (pure Python).
"""

from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass, field


@dataclass
class SimJob:
    """One job in the M/G/1 token-level simulation."""

    jid: int
    arrival: float
    size: float
    pred: float
    served: float = 0.0
    done_at: float = -1.0

    def remaining(self) -> float:
        """True remaining service (size minus served)."""
        return self.size - self.served

    def pred_remaining(self) -> float:
        """Predicted remaining service (rank signal)."""
        # NOTE: unclamped, matching the analyzed rank r - a (an overrun job's
        # rank keeps falling, so it keeps its priority rather than ties at 0).
        return self.pred - self.served


@dataclass
class SimResult:
    """Aggregates of one simulate() run (response times, memory)."""

    mean_response: float
    median_response: float
    peak_memory: float
    mean_memory: float
    n_jobs: int
    preemptions: int
    responses: list[float] = field(default_factory=list)


def _rank(job: SimJob, policy: str, C: float) -> float:
    """Policy rank (lower = served first); Appendix C rank functions."""
    if policy == "fcfs":
        return job.arrival
    if policy in ("sjf", "spjf"):
        return job.pred
    if policy == "srpt":
        return job.pred_remaining()
    if policy == "sprpt-lp":
        if job.served >= C * job.pred and job.served > 0:
            return float("-inf")            # non-preemptable once past a0
        return job.pred_remaining()
    raise ValueError(policy)


def simulate(policy: str, lam: float, *, C: float = 0.8, n_jobs: int = 20000,
             prediction: str = "exponential", seed: int = 0,
             warmup_frac: float = 0.1) -> SimResult:
    """Event-driven M/G/1 simulation of one scheduling policy."""
    rng = random.Random(seed)
    # pre-generate arrivals
    jobs: list[SimJob] = []
    t = 0.0
    for j in range(n_jobs):
        t += rng.expovariate(lam)
        size = rng.expovariate(1.0)
        if prediction == "perfect":
            pred = size
        elif prediction == "exponential":
            pred = rng.expovariate(1.0 / size) if size > 0 else 0.0
        else:
            raise ValueError(prediction)
        jobs.append(SimJob(j, t, size, pred))

    # event loop
    now = 0.0
    idx = 0                      # next arrival index
    system: list[SimJob] = []    # jobs in system (waiting or served)
    current: SimJob | None = None
    responses = []
    preemptions = 0
    mem_area = 0.0               # integral of memory over time
    peak_mem = 0.0
    last_t = 0.0
    non_preempt = policy in ("fcfs", "sjf", "spjf")

    def memory() -> float:
        """Held state: served work across jobs in system (Appendix D)."""
        return sum(j.served for j in system)

    def pick() -> SimJob | None:
        """Next job to serve under the policy rank (FCFS tiebreak)."""
        if not system:
            return None
        if non_preempt and current in system:
            return current
        return min(system, key=lambda j: (_rank(j, policy, C), j.arrival))

    while idx < n_jobs or system:
        next_arrival = jobs[idx].arrival if idx < n_jobs else math.inf
        if current is not None:
            completion = now + current.remaining()
        else:
            completion = math.inf
        t_next = min(next_arrival, completion)

        # integrate memory over [now, t_next]; served job's age grows linearly
        dt = t_next - now
        m0 = memory()
        m1 = m0 + (dt if current is not None else 0.0)
        mem_area += (m0 + m1) / 2.0 * dt
        peak_mem = max(peak_mem, m1)
        if current is not None:
            current.served += dt
        now = t_next

        if completion <= next_arrival and current is not None:
            current.served = current.size
            current.done_at = now
            system.remove(current)
            responses.append(now - current.arrival)
            current = None
        else:
            system.append(jobs[idx])
            idx += 1
        prev = current
        current = pick()
        if prev is not None and current is not prev and prev in system:
            preemptions += 1
        last_t = now

    # drop warmup
    k = int(len(responses) * warmup_frac)
    rs = sorted(responses[k:])
    mean_r = sum(rs) / max(len(rs), 1)
    med_r = rs[len(rs) // 2] if rs else 0.0
    return SimResult(mean_response=mean_r, median_response=med_r,
                     peak_memory=peak_mem,
                     mean_memory=mem_area / max(last_t, 1e-9),
                     n_jobs=len(rs), preemptions=preemptions,
                     responses=rs)


def sweep(policy: str, lams, *, C: float = 0.8, n_jobs: int = 20000,
          prediction: str = "exponential", seed: int = 0):
    """simulate() across arrival rates; returns {lam: SimResult}."""
    return {lam: simulate(policy, lam, C=C, n_jobs=n_jobs,
                          prediction=prediction, seed=seed) for lam in lams}
