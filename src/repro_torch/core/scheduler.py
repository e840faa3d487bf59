"""SPRPT with limited preemption (paper Section 3.3) + baseline policies.

Rank function (Appendix C):

    rank(x, r, a) = r - a   if a < a0 = floor(C * r0)
                    -inf    otherwise  (non-preemptable: pinned to the batch)

where r0 is the *initial* prediction (prompt-phase probe) that fixes the
preemption budget, and the live rank uses the refined per-iteration
prediction when available (TRAIL) or r0 - a (TRAIL-BERT).

The scheduler is iteration-level: it is consulted after every decode
iteration and returns the set of requests to run next, subject to a batch
slot limit and a KV-memory budget.  Memory accounting is delegated to a
``bytes_fn(entry) -> int`` callback so the engine can supply the arch-aware
cost (dense KV grows with age; SSM state is O(1); sliding-window caches
clamp at the window — see DESIGN.md section 4).

Tail-aware extensions (both off by default; zero knobs are byte-identical):

* **Rank aging** (``age_boost`` > 0): the prediction-based ranks
  (trail / srpt / trail-bert / rank) subtract ``age_boost`` rank units
  per second a request has been in the system *beyond an* ``age_delay``
  *grace window*:

      aged rank = rank - age_boost * max(waited - age_delay, 0)

  Inside the window ordering is pure SRPT (the mean-optimal regime);
  past it a request's rank falls linearly without bound, so it cannot
  starve behind an endless stream of shorter arrivals (cf. the
  max-waiting-time starvation prevention of "Efficient LLM Scheduling
  by Learning to Rank", arXiv:2408.15792). The hinge matters: a boost
  applied uniformly from arrival shifts every queued rank at the same
  rate, so *relative* order between two waiting entries never changes
  — only the hinge lets a starving request actually catch up.
  Algebraically, once entries i and j are both past the grace window,
  i outranks j as soon as
  ``waited_i - waited_j > (base_i - base_j) / age_boost`` — the boost
  is a dial from pure SRPT ordering (0) toward FCFS (∞), which is
  exactly the direction the completion-p99 inversion on correlated
  traces calls for.
* **Deadline-aware limited preemption** (``deadline_slack`` > 0): the
  paper's C-limit makes a request non-preemptable after ``floor(C*r0)``
  *served tokens*; the deadline-slack rule generalizes it to wall-clock
  urgency — a RUNNING request whose absolute deadline
  (`SchedEntry.deadline_at`) is within ``deadline_slack`` seconds is
  pinned (rank -inf) under every preemptive policy, so near-deadline
  work is never descheduled into a discard-and-recompute it cannot
  afford.

Policies:
  fcfs        — arrival order, never preempt (vanilla vLLM)
  sjf         — shortest *initial* prediction first among waiting;
                running jobs are never preempted (vLLM-SJF_BERT)
  srpt        — SPRPT, unlimited preemption (TRAIL with C=1)
  trail       — SPRPT-LP with refined predictions (the paper's system)
  trail-bert  — SPRPT-LP with static prompt-only predictions
  rank        — learning-to-rank (Fu et al., arXiv:2408.15792): order
                the queue by an ordinal score with NO magnitude
                semantics (a rank-only predictor's output). Unlimited
                preemption like srpt, but — unlike every
                prediction-based policy above — the score is never used
                arithmetically: no preemption budget a0 (that needs
                floor(C*r0) in tokens) and no megastep lookahead
                pinning (that compares pred_remaining to a token
                count). With scores that are any strictly monotone
                transform of true remaining length, the selected batch
                is identical to srpt's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum

NEG_INF = float("-inf")

POLICIES = ("fcfs", "sjf", "srpt", "trail", "trail-bert", "mlfq", "rank")

#: Policies whose ranks are ordinal only — select_batch never interprets
#: rank values as token counts for these (no lookahead pinning).
ORDINAL_POLICIES = ("mlfq", "rank")

#: Policies whose ranks age with waiting time under ``age_boost`` (the
#: prediction-ordered ones; fcfs is already arrival-ordered, sjf/mlfq are
#: the fixed related-work baselines).
AGED_POLICIES = ("trail", "srpt", "trail-bert", "rank")

# FastServe-style MLFQ (Wu et al. 2023, the paper's related-work baseline):
# priority queues by quantum thresholds on served tokens; a request demotes
# one level each time it exhausts its quantum. Prediction-free.
MLFQ_QUANTA = (16, 64, 256, 1024)


def mlfq_level(age: int) -> int:
    """MLFQ priority level for a job that has been served ``age`` tokens."""
    served = 0
    for lvl, q in enumerate(MLFQ_QUANTA):
        served += q
        if age < served:
            return lvl
    return len(MLFQ_QUANTA)


class ReqState(Enum):
    """Request lifecycle states the scheduler distinguishes."""

    WAITING = "waiting"      # never started (no cache footprint)
    RUNNING = "running"      # in the current batch
    PREEMPTED = "preempted"  # started, kicked out, cache discarded
    FINISHED = "finished"
    CANCELLED = "cancelled"  # terminated early (user cancel / deadline /
                             # load shed); cache fully released. Terminal
                             # like FINISHED: ``select_batch`` lists the
                             # live states explicitly, so cancelled
                             # entries can never be scheduled again.


@dataclass
class SchedEntry:
    """Host-side scheduling metadata for one request."""

    rid: int
    arrival: float
    prompt_len: int
    r0: float = 0.0               # initial predicted output length
    pred_remaining: float = 0.0   # refined predicted remaining length
    age: int = 0                  # output tokens generated so far
    c_limit: float = 0.8          # the paper's C
    state: ReqState = ReqState.WAITING
    prefill_done: int = 0         # chunked-prefill progress (tokens)
    prefill_left: float = 0.0     # remaining prefill work (tokens) counted
                                  # into prediction-based ranks; the engine
                                  # populates it only when cross-request
                                  # prefix caching is on (a cached prefix
                                  # shrinks remaining work, so SRPT-style
                                  # ranks must see prefill too). Default 0
                                  # keeps ranks byte-identical.
    finish_len: int = 0           # ground-truth output length (oracle/sim)
    preemptions: int = 0
    first_token_time: float = -1.0
    finish_time: float = -1.0
    deadline_at: float = 0.0      # absolute completion deadline on the
                                  # engine clock (arrival + deadline_s);
                                  # 0 = none. Drives the deadline-slack
                                  # non-preemption rule in rank().

    @property
    def a0(self) -> int:
        """The preemption budget floor(C * r0) (paper Section 3.3)."""
        return math.floor(self.c_limit * max(self.r0, 0.0))

    @property
    def preemptable(self) -> bool:
        """True while the request is within its preemption budget."""
        return self.age < self.a0

    def rank(self, policy: str, *, now: float = 0.0, age_boost: float = 0.0,
             age_delay: float = 0.0, deadline_slack: float = 0.0) -> float:
        """Policy rank (lower runs first; -inf = pinned to the batch).

        The tail-aware knobs default to zero, where the returned value is
        byte-identical to the pre-aging scheduler (both terms are gated,
        not merely multiplied by zero):

        Args:
            policy: the scheduling policy (see `POLICIES`).
            now: the engine clock — only read when a knob is active.
            age_boost: rank units subtracted per second waited beyond the
                grace window (`AGED_POLICIES` only); starvation-free for
                any value > 0.
            age_delay: grace window in seconds before aging starts —
                ordering stays pure SRPT inside it. Only read when
                ``age_boost`` > 0.
            deadline_slack: a RUNNING request whose ``deadline_at`` is
                within this many seconds is pinned (-inf) under every
                preemptive policy — deadline-aware limited preemption.
        """
        if (deadline_slack > 0.0 and policy not in ("fcfs", "sjf")
                and self.deadline_at > 0.0
                and self.state is ReqState.RUNNING
                and self.deadline_at - now <= deadline_slack):
            return NEG_INF           # pinned: inside the deadline slack
        if policy == "fcfs":
            return self.arrival
        if policy == "sjf":
            return self.r0
        if policy == "mlfq":
            return float(mlfq_level(self.age))     # FCFS tiebreak inside level
        if policy == "rank":
            # ordinal score straight from a rank-only predictor: compared,
            # never added/subtracted between entries — prefill_left (a
            # token count) cannot fold into a scale-free score. Aging
            # still applies below: the boost defines the starvation bound
            # in score units per second, a property of the dial rather
            # than of the score's magnitude semantics.
            r = self.pred_remaining
        # prediction-based remaining-time ranks; prefill_left folds the
        # (cache-aware) remaining prefill work into "remaining time" so a
        # request whose prompt prefix is already resident ranks ahead of
        # an equal-output request that still owes its whole prefill
        elif policy == "trail-bert":
            r = self.r0 - self.age + self.prefill_left
        elif policy in ("trail", "srpt"):
            r = self.pred_remaining + self.prefill_left
        else:
            raise ValueError(f"unknown policy {policy!r}")
        if (policy in ("trail", "trail-bert")
                and self.state is ReqState.RUNNING and not self.preemptable):
            return NEG_INF           # pinned: past the preemption budget
        if age_boost > 0.0:
            # rank aging: past the grace window the rank falls linearly
            # with waiting time, so any request eventually undercuts any
            # finite rank (inside the window ordering stays pure SRPT)
            r -= age_boost * max(now - self.arrival - age_delay, 0.0)
        return r


@dataclass
class Decision:
    """One ``select_batch`` outcome: who runs, who yields, who starts."""

    scheduled: list[int] = field(default_factory=list)   # rids to run
    preempted: list[int] = field(default_factory=list)   # rids kicked out
    admitted: list[int] = field(default_factory=list)    # rids newly started


def select_batch(entries: dict[int, SchedEntry], *, policy: str,
                 max_batch: int, mem_budget: int, bytes_fn,
                 lookahead: int = 1, now: float = 0.0,
                 age_boost: float = 0.0, age_delay: float = 0.0,
                 deadline_slack: float = 0.0) -> Decision:
    """Pick the next iteration's batch.

    ``lookahead`` is the number of decode tokens every scheduled row will
    generate before the scheduler is consulted again (1 for the per-token
    loop; k for the engine's k-token decode megasteps). The caller's
    ``bytes_fn`` should account for that growth (context + lookahead), and
    with lookahead > 1 the prediction-based policies additionally pin any
    RUNNING job whose predicted remaining length fits inside the upcoming
    megastep: preempting a job that would have finished within k tokens
    discards nearly-complete work for at most k tokens of relief. With the
    default lookahead=1 the decision is exactly the per-token one.

    ``now`` / ``age_boost`` / ``age_delay`` / ``deadline_slack`` are the
    tail-aware knobs forwarded into `SchedEntry.rank` (see the module
    docstring); at their zero defaults every decision is byte-identical
    to the pre-aging scheduler.

    Invariants (tested by hypothesis):
      * non-preemptable RUNNING jobs are always scheduled (policy != fcfs/sjf
        handles this via rank -inf; fcfs/sjf never preempt at all);
      * |scheduled| <= max_batch and sum(bytes) <= mem_budget (pinned jobs
        may alone exceed the budget only if they were admitted when it fit);
      * no WAITING job is scheduled while a strictly lower-rank candidate
        with room is left out (greedy by rank, FCFS tiebreak);
      * with ``age_boost`` > 0 an unpinned WAITING entry past the grace
        window that has waited ``(max_base - min_base) / age_boost``
        longer than every competitor outranks them all — waiting time is
        bounded (no starvation);
      * with ``deadline_slack`` > 0 a RUNNING entry inside its slack
        window is never preempted.
    """
    live = [e for e in entries.values()
            if e.state in (ReqState.WAITING, ReqState.RUNNING,
                           ReqState.PREEMPTED)]
    if policy in ("fcfs", "sjf"):
        # running jobs are immovable; waiting sorted by policy rank
        running = sorted((e for e in live if e.state is ReqState.RUNNING),
                         key=lambda e: e.arrival)
        waiting = sorted((e for e in live if e.state is not ReqState.RUNNING),
                         key=lambda e: (e.rank(policy), e.arrival))
        ordered = running + waiting
        must_keep = set(e.rid for e in running)
    else:
        ranks = {e.rid: e.rank(policy, now=now, age_boost=age_boost,
                               age_delay=age_delay,
                               deadline_slack=deadline_slack)
                 for e in live}
        ordered = sorted(live, key=lambda e: (ranks[e.rid], e.arrival))
        # pinned = every RUNNING entry whose rank collapsed to -inf:
        # past its C-limit preemption budget (trail/trail-bert) or inside
        # its deadline-slack window (any preemptive policy). For
        # srpt/mlfq/rank with the slack knob off this set is empty —
        # unlimited preemption, exactly the legacy behavior.
        must_keep = set(e.rid for e in live
                        if e.state is ReqState.RUNNING
                        and ranks[e.rid] == NEG_INF)
        if lookahead > 1 and policy not in ORDINAL_POLICIES:
            # mlfq has no predictions; rank scores are not token counts
            # megastep lookahead: about-to-finish jobs ride out the megastep
            must_keep |= set(
                e.rid for e in live
                if e.state is ReqState.RUNNING
                and e.pred_remaining <= lookahead)
            # lookahead-pinned jobs keep their normal (finite) rank, so
            # unlike -inf-ranked non-preemptables they would not sort
            # first: move every pinned entry to the front (stable) so
            # pinned slots/bytes are claimed before any admission — else
            # a better-ranked WAITING job could take the last slot and
            # the forced pin would oversubscribe max_batch / the pool
            ordered = ([e for e in ordered if e.rid in must_keep]
                       + [e for e in ordered if e.rid not in must_keep])

    decision = Decision()
    used_mem = 0
    used_slots = 0
    for e in ordered:
        cost = bytes_fn(e)
        pinned = e.rid in must_keep
        if not pinned and (used_slots + 1 > max_batch
                           or used_mem + cost > mem_budget):
            continue
        decision.scheduled.append(e.rid)
        used_slots += 1
        used_mem += cost
    sched = set(decision.scheduled)
    for e in live:
        if e.state is ReqState.RUNNING and e.rid not in sched:
            decision.preempted.append(e.rid)
        if e.state is not ReqState.RUNNING and e.rid in sched:
            decision.admitted.append(e.rid)
    return decision
