"""Cluster router: dispatch streaming arrivals across N replica engines.

Each replica is a full `Engine` (its own SPRPT-LP scheduler, KV
accounting, and virtual clock) driven through the incremental
``submit()``/``step()`` API. The router runs a virtual-time event loop:

* a pending arrival is dispatched once every busy replica's clock has
  reached its arrival time (so the routing decision observes replica
  state *at* — never before — the arrival);
* otherwise the replica furthest behind in virtual time executes one
  engine step, advancing the cluster frontier.

Dispatch policies (``RouterConfig.policy``):

* ``round-robin`` — cyclic, state-blind (the baseline).
* ``jsq``         — join-shortest-queue by unfinished request count.
* ``pow2``        — power-of-two-choices: sample two replicas, join the
                    shorter queue (Mitzenmacher's classic load balancer).
* ``jspw``        — join-shortest-predicted-work over each replica's live
                    TRAIL per-token remaining-length predictions plus
                    remaining prefill work (`Engine.backlog`). This is the
                    paper's probe signal lifted to the cluster layer (cf.
                    proxy-model routing, arXiv:2404.08509). Because every
                    replica schedules with SPRPT internally, longer jobs
                    yield to a new arrival — so when the router has a
                    ``size_predictor`` (prompt-only r0 estimate, the
                    paper's BERT/probe signal), each replica's predictions
                    are truncated at the arrival's own size estimate:
                    join-shortest *interfering* predicted work. Without a
                    size predictor the raw backlog sum is used (the
                    FCFS-replica signal). Backlog ties break on KV
                    headroom (`Engine.kv_headroom`): a replica near its
                    memory budget pays future preemptions for every
                    long-context request it accepts.
* ``prefix-affinity`` — join the replica whose KV prefix cache holds the
                    longest prefix of the arrival's prompt
                    (`Engine.cached_prefix_tokens`): the linked pages
                    skip prefill compute entirely and shrink the shared
                    footprint. Replicas tying on affinity (including the
                    0-hit case) fall back to the full ``jspw`` rule, so
                    with prefix caching disabled the policy degrades to
                    exactly ``jspw``.

Prefill/decode disaggregation (``RouterConfig.prefill_replicas`` = P > 0):
replicas ``[0, P)`` run ``prefill_only`` engines and the rest decode.
Arrivals (and failover retries) dispatch into the prefill pool under the
configured policy; each completed prefill is exported as a `KVHandoff`
(paged KV pages, one batched host-bounce per request) and shipped to the
decode replica with the least predicted work *including in-flight
handoffs* (transfer-aware JSPW). The transfer charges
`CostModel.kv_transfer_time` as delayed availability on the router's
virtual clock — decode megasteps keep running underneath, so shipping
overlaps compute instead of stalling the batch. With P = 0 (default) the
loop is byte-identical to the colocated router.

Resilience (optional, via a
`repro_torch.cluster.faults.FaultSchedule`): the router health-checks
the fleet at every loop boundary — crashed replicas are drained (their paged KV fully reclaimed) and their unfinished
requests redispatched to survivors with capped exponential backoff under
a per-request retry budget; straggler replicas are excluded from
dispatch while degraded; transient submit failures fail over to another
replica at the same instant. Retried requests keep their original
arrival timestamp, so completion latency and TTFT stay user-perceived.
Without a schedule the loop is byte-identical to the fault-free path.

A copy of the reference ``repro.cluster.router`` over the port's
`Engine`. `Router` takes engines the caller built, real-mode ones
included: several replicas may share one ``Model`` on the card, each with
its own paged pool and predictor, and a disaggregated pair ships KV pages
through `PagedSlotPool.export_pages`/`import_pages`. `run_cluster` builds
sim-mode engines only, as in the reference.
"""

from __future__ import annotations

import copy
import heapq
import random
from dataclasses import dataclass, field

import numpy as np

from repro_torch.cluster.faults import NEVER, FaultSchedule
from repro_torch.core.scheduler import SchedEntry
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.request import Request

#: Dispatch policies understood by `Router`.
ROUTER_POLICIES = ("round-robin", "jsq", "pow2", "jspw", "prefix-affinity")


@dataclass
class RouterConfig:
    """Cluster-level knobs.

    Attributes:
        n_replicas: number of replica engines.
        policy: dispatch policy — one of `ROUTER_POLICIES`.
        seed: RNG seed for the ``pow2`` replica sampler (dispatch is
            deterministic given the seed and the arrival stream).
        backlog_unit: ``tokens`` (raw predicted-token backlog, the
            default) | ``seconds`` (tokens ÷ each replica's
            `CostModel.decode_token_rate`, via `Engine.backlog_seconds`).
            Seconds is the unit that stays meaningful once replicas run
            on heterogeneous hardware; with identical replicas the two
            units rank identically, so `jspw` dispatch is unchanged.
        max_retries: failover retry budget per request — how many times
            a request drained from a crashed replica (or bounced by a
            transient submit failure) is redispatched before it is
            declared lost.
        retry_backoff_s: base of the capped exponential backoff between
            failover redispatches (the k-th retry waits
            ``min(retry_backoff_s * 2**(k-1), retry_backoff_cap_s)``).
        retry_backoff_cap_s: the backoff cap.
        prefill_replicas: disaggregated topology — the first P replicas
            are a prefill pool (``EngineConfig.prefill_only``) and the
            remaining ``n_replicas - P`` a decode pool; completed
            prefills ship their paged KV prefill→decode as `KVHandoff`
            batches. 0 (the default) keeps every replica colocated,
            byte-identical to the pre-disaggregation router.
    """

    n_replicas: int = 2
    policy: str = "round-robin"
    seed: int = 0
    backlog_unit: str = "tokens"
    max_retries: int = 2
    retry_backoff_s: float = 0.5
    retry_backoff_cap_s: float = 8.0
    prefill_replicas: int = 0


@dataclass
class ClusterStats:
    """Aggregated results of one cluster run.

    Attributes:
        latencies: completion times (finish - arrival) across all replicas.
        ttfts: time-to-first-token across all replicas.
        dispatch_counts: requests dispatched per replica.
        replica_summaries: each replica's `EngineStats.summary()` dict.
        makespan: max replica virtual clock at drain.
        event_log: the replicas' metrics-layer event streams merged into
            one time-ordered `repro_torch.metrics.EventLog` (None unless
            the replicas were built with event logs). Feed it to
            `repro_torch.metrics.rollup` for cluster-wide
            TTFT/TBT/completion percentiles and SLO attainment.
        n_requests: arrival-stream size (the goodput denominator).
        n_retries: failover redispatches performed across the run.
        n_lost: requests dropped after exhausting the retry budget.
        n_crashes: replica crash events applied.
        n_handoffs: prefill→decode KV handoffs delivered (disagg mode).
        handoff_pages: KV pages shipped across all handoffs.
        leaked_pages: per-replica ``BlockManager.used_pages()`` at drain
            — all zeros on a clean run (the zero-leak invariant the
            disagg benchmark gates on; contig replicas report 0).
    """

    latencies: list = field(default_factory=list)
    ttfts: list = field(default_factory=list)
    dispatch_counts: list = field(default_factory=list)
    replica_summaries: list = field(default_factory=list)
    makespan: float = 0.0
    event_log: object = None
    n_requests: int = 0
    n_retries: int = 0
    n_lost: int = 0
    n_crashes: int = 0
    n_handoffs: int = 0
    handoff_pages: int = 0
    leaked_pages: list = field(default_factory=list)

    def summary(self) -> dict:
        """Aggregate cluster metrics into the benchmark-facing dict."""
        lat = sorted(self.latencies)
        tt = sorted(self.ttfts)
        return {
            "mean_latency": float(np.mean(lat)) if lat else 0.0,
            "median_latency": lat[len(lat) // 2] if lat else 0.0,
            "p99_latency": lat[int(len(lat) * 0.99)] if lat else 0.0,
            "mean_ttft": float(np.mean(tt)) if tt else 0.0,
            "median_ttft": tt[len(tt) // 2] if tt else 0.0,
            "finished": len(lat),
            "dispatch_counts": list(self.dispatch_counts),
            "preemptions": sum(s["preemptions"]
                               for s in self.replica_summaries),
            "peak_batch": max((s["peak_batch"]
                               for s in self.replica_summaries), default=0),
            "prefilled_tokens": sum(s.get("prefilled_tokens", 0)
                                    for s in self.replica_summaries),
            "prefix_hit_tokens": sum(s.get("prefix_hit_tokens", 0)
                                     for s in self.replica_summaries),
            "predictor_time_s": sum(s.get("predictor_time_s", 0.0)
                                    for s in self.replica_summaries),
            "predictor_calls": sum(s.get("predictor_calls", 0)
                                   for s in self.replica_summaries),
            "makespan": self.makespan,
            "retries": self.n_retries,
            "lost": self.n_lost,
            "replica_crashes": self.n_crashes,
            "cancelled": sum(s.get("cancelled", 0)
                             for s in self.replica_summaries),
            "timeouts": sum(s.get("timeouts", 0)
                            for s in self.replica_summaries),
            "shed": sum(s.get("shed", 0)
                        for s in self.replica_summaries),
            "handoffs": self.n_handoffs,
            "handoff_pages": self.handoff_pages,
            "leaked_pages": sum(self.leaked_pages),
            # served-to-completion fraction of the arrival stream —
            # crashes, sheds, timeouts, and lost requests all count
            # against it
            "goodput": (len(lat) / self.n_requests
                        if self.n_requests else 0.0),
        }


class Router:
    """Dispatches a request stream across replica engines in virtual time.

    The router owns nothing about scheduling *within* a replica — that is
    the engine's SPRPT-LP job. It only decides *which* replica an arrival
    joins, then keeps all replica clocks loosely synchronized by always
    stepping the laggard.
    """

    def __init__(self, replicas: list[Engine], rc: RouterConfig,
                 size_predictor=None, faults: FaultSchedule | None = None,
                 event_log=None):
        """Wrap pre-built replica engines under one dispatch policy.

        Args:
            replicas: the engines (length must equal ``rc.n_replicas``).
            rc: cluster-level configuration.
            size_predictor: optional predictor whose ``initial(req)``
                gives a prompt-only output-length estimate for ``jspw``
                truncation (see module docstring). It must be a separate
                instance from any replica's predictor so router draws
                never perturb engine prediction streams.
            faults: optional `FaultSchedule` — deterministic crash /
                straggler / flaky-submit injection; None (the default)
                runs fault-free with zero overhead in the loop.
            event_log: optional router-owned
                `repro_torch.metrics.EventLog`
                for cluster-level events (``replica_down`` /
                ``replica_up`` / ``retry`` / lost-request ``cancel``);
                merged into `merged_event_log()`.
        """
        if rc.policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {rc.policy!r}; "
                             f"choose from {ROUTER_POLICIES}")
        if rc.backlog_unit not in ("tokens", "seconds"):
            raise ValueError(f"unknown backlog_unit {rc.backlog_unit!r}; "
                             "choose 'tokens' or 'seconds'")
        if len(replicas) != rc.n_replicas:
            raise ValueError(f"{len(replicas)} replicas != "
                             f"n_replicas={rc.n_replicas}")
        if rc.prefill_replicas:
            if not 0 < rc.prefill_replicas < rc.n_replicas:
                raise ValueError(
                    f"prefill_replicas={rc.prefill_replicas} must leave "
                    f"at least one decode replica (n={rc.n_replicas})")
            for i, eng in enumerate(replicas):
                if bool(eng.ecfg.prefill_only) != (i < rc.prefill_replicas):
                    raise ValueError(
                        f"disagg topology: replicas[:{rc.prefill_replicas}]"
                        f" must be prefill_only and the rest decode "
                        f"(replica {i} mismatched)")
        for c in (faults.crashes if faults is not None else ()):
            if not 0 <= c.replica < rc.n_replicas:
                raise ValueError(f"fault schedule names replica "
                                 f"{c.replica} (cluster has "
                                 f"{rc.n_replicas})")
        self.replicas = replicas
        self.rc = rc
        self.size_predictor = size_predictor
        self.faults = faults
        self.events = event_log
        self._rr_next = 0
        self._rng = random.Random(rc.seed)
        # dedicated stream for transient-submit draws: fault outcomes
        # must not perturb the pow2 sampler (and vice versa)
        self._fault_rng = random.Random(faults.seed if faults is not None
                                        else 0)
        self._alive = [True] * rc.n_replicas
        self._crashed = [False] * rc.n_replicas   # crash already applied
        self._retryq: list[tuple[float, int, Request]] = []
        self._retry_seq = 0
        # in-flight KV handoffs: (t_ready, seq, dst, pred_tokens, handoff)
        self._handoffq: list[tuple] = []
        self._handoff_seq = 0
        self._inflight: dict[int, float] = {}   # dst -> queued pred tokens
        self.n_retries = 0
        self.n_lost = 0
        self.n_crashes = 0
        self.n_handoffs = 0
        self.handoff_pages = 0
        self.dispatch_counts = [0] * rc.n_replicas
        self.dispatch_log: list[tuple[int, int]] = []   # (rid, replica)

    # -- dispatch policies ------------------------------------------------
    def _queue_key(self, i: int) -> tuple:
        return (self.replicas[i].queue_len(), i)

    def _candidates(self, t: float, exclude=()) -> list[int]:
        """Replica indices eligible for dispatch at time ``t``.

        Alive, not excluded, and (fault mode) not inside a straggler
        window — unless every alive replica is degraded, in which case
        slow beats nowhere. In a disaggregated topology arrivals (and
        retries) only ever dispatch into the prefill pool.
        """
        pool = (range(self.rc.prefill_replicas)
                if self.rc.prefill_replicas else range(len(self.replicas)))
        alive = [i for i in pool
                 if self._alive[i] and i not in exclude]
        if self.faults is None:
            return alive
        healthy = [i for i in alive if not self.faults.degraded(i, t)]
        return healthy or alive

    def _pick(self, req: Request, cands: list[int] | None = None) -> int:
        """Choose the replica index for one arrival (policy decision).

        ``cands`` restricts the choice (fault mode: alive, non-degraded
        replicas); None = all replicas, and every policy below reduces
        exactly to its pre-resilience behavior in that case.
        """
        pol = self.rc.policy
        n = len(self.replicas)
        if cands is None:
            cands = list(range(n))
        if pol == "round-robin":
            # cyclic over the eligible set: advance the cursor until it
            # lands on a candidate (identical to the legacy cyclic scan
            # when every replica is eligible)
            for _ in range(n):
                i = self._rr_next
                self._rr_next = (self._rr_next + 1) % n
                if i in cands:
                    return i
            return cands[0]
        if pol == "jsq":
            return min(cands, key=self._queue_key)
        if pol == "pow2":
            if len(cands) == 1:
                return cands[0]
            # full fleet keeps the legacy range(n) draw so fault-free
            # dispatch streams stay byte-identical
            pool = range(n) if len(cands) == n else cands
            a, b = self._rng.sample(pool, 2)
            return min(a, b, key=self._queue_key)
        # the size estimate is drawn once per dispatch (predictor streams
        # are stateful), shared by every replica's key below
        r_hat = (self.size_predictor.initial(req)
                 if self.size_predictor is not None else None)
        if pol == "prefix-affinity":
            # longest cached prompt prefix wins; ties (notably 0-hit
            # everywhere, or caching disabled) fall back to jspw
            hits = {i: self.replicas[i].cached_prefix_tokens(req.prompt)
                    for i in cands}
            best = max(hits.values())
            tied = [i for i in cands if hits[i] == best]
            return min(tied, key=lambda i: self._jspw_key(i, r_hat))
        # jspw: live predicted-work backlog — truncated at the arrival's
        # own size estimate when available (SRPT-interfering work) — with
        # KV headroom, queue length, then index as tie-breaks
        return min(cands, key=lambda i: self._jspw_key(i, r_hat))

    def _jspw_key(self, i: int, r_hat: float | None) -> tuple:
        """The jspw ordering for one replica.

        Predicted interfering work (in ``rc.backlog_unit`` units —
        estimated seconds divide tokens by the replica's own service
        rate, the heterogeneous-hardware form), then (on ties) most KV
        headroom, shortest queue, lowest index.
        """
        eng = self.replicas[i]
        work = (eng.backlog_seconds(truncate=r_hat)
                if self.rc.backlog_unit == "seconds"
                else eng.backlog(truncate=r_hat))
        return (work, -eng.kv_headroom(), eng.queue_len(), i)

    # -- disaggregation: prefill→decode KV handoffs -----------------------
    def _decode_key(self, i: int, r_hat: float | None) -> tuple:
        """Transfer-aware jspw for the decode pool.

        `_jspw_key` plus the predicted tokens of handoffs already queued
        toward replica ``i`` but not yet imported — without them, every
        handoff in one drain pass would pile onto the same
        momentarily-idle replica.
        """
        eng = self.replicas[i]
        inflight = self._inflight.get(i, 0.0)
        if self.rc.backlog_unit == "seconds":
            work = (eng.backlog_seconds(truncate=r_hat)
                    + inflight / eng.cost.decode_token_rate())
        else:
            work = eng.backlog(truncate=r_hat) + inflight
        return (work, -eng.kv_headroom(), eng.queue_len(), i)

    def _pick_decode(self, handoff, t: float) -> int:
        """Choose the decode replica for one handoff.

        Alive, preferring non-degraded; -1 when the decode pool is
        entirely down.
        """
        cands = [i for i in range(self.rc.prefill_replicas,
                                  len(self.replicas)) if self._alive[i]]
        if self.faults is not None:
            healthy = [i for i in cands
                       if not self.faults.degraded(i, t)]
            cands = healthy or cands
        if not cands:
            return -1
        return min(cands, key=lambda i: self._decode_key(
            i, handoff.pred_tokens))

    def _drain_handoffs(self):
        """Export parked prefill-complete requests toward decode.

        Runs at every loop boundary (before the busy scan), so a prefill
        replica holding only parked work is drained rather than stalling
        the virtual-time frontier.
        """
        for i in range(self.rc.prefill_replicas):
            eng = self.replicas[i]
            if not self._alive[i]:
                continue
            for rid in eng.handoff_ready():
                h = eng.export_request(rid)
                j = self._pick_decode(h, eng.now)
                if j < 0:
                    # decode pool entirely down: failover (progress lost,
                    # re-dispatches into the prefill pool after backoff)
                    self._requeue(h.req, eng.now)
                    continue
                t_ready = eng.now + eng.cost.kv_transfer_time(h.nbytes)
                work = h.pred_tokens or 0.0
                self._inflight[j] = self._inflight.get(j, 0.0) + work
                heapq.heappush(self._handoffq,
                               (t_ready, self._handoff_seq, j, work, h))
                self._handoff_seq += 1
                self.n_handoffs += 1
                self.handoff_pages += h.n_pages

    def _deliver_handoff(self):
        """Pop the due handoff and import it on its destination.

        A destination that crashed while the transfer was in flight
        sends the request through the normal failover path instead.
        """
        t_r, _, j, work, h = heapq.heappop(self._handoffq)
        self._inflight[j] = self._inflight.get(j, 0.0) - work
        if self._alive[j]:
            self.replicas[j].import_request(h, t=t_r)
            self.dispatch_counts[j] += 1
            self.dispatch_log.append((h.req.rid, j))
        else:
            self._requeue(h.req, t_r)

    def dispatch(self, req: Request, t: float | None = None) -> int:
        """Route one arrival to a replica and submit it there.

        In fault mode the pick is restricted to alive, non-degraded
        replicas and the submit may transiently fail (seeded draw);
        failures charge the retry budget and fail over to another
        replica immediately when one exists, else requeue with backoff.
        Returns the replica index, or -1 if the request could not be
        placed (requeued or lost).
        """
        t = req.arrival if t is None else t
        tried: set[int] = set()
        while True:
            cands = self._candidates(t, exclude=tried)
            if not cands:
                self._defer_or_drop(req, t)
                return -1
            i = self._pick(req, cands if (self.faults is not None
                                          or len(cands)
                                          != len(self.replicas))
                           else None)
            if (self.faults is not None and self._fault_rng.random()
                    < self.faults.flaky_rate(i, t)):
                # transient submit failure: fail over to another replica
                # (same instant), charged against the retry budget
                tried.add(i)
                if not self._charge_retry(req, t):
                    return -1
                continue
            self.replicas[i].submit(req)
            self.dispatch_counts[i] += 1
            self.dispatch_log.append((req.rid, i))
            return i

    # -- fault machinery --------------------------------------------------
    def _apply_faults(self, t_ref: float):
        """Step-level health check at cluster time ``t_ref``.

        Applies due crashes (drain + requeue the dead replica's
        requests) and due recoveries. A busy replica crashes at its
        first megastep boundary at/after the scheduled time; an idle
        one when the cluster frontier passes it.
        """
        if self.faults is None:
            return
        for i, eng in enumerate(self.replicas):
            c = self.faults.crash_for(i)
            if c is None:
                continue
            if (self._alive[i] and not self._crashed[i]
                    and c.at <= max(eng.now, t_ref)):
                t_c = max(eng.now, c.at)
                self._crashed[i] = True
                self._alive[i] = False
                self.n_crashes += 1
                drained = eng.crash(t_c)
                if self.events is not None:
                    self.events.emit(t_c, -1, "replica_down", i)
                for req in drained:
                    self._requeue(req, t_c)
            elif (self._crashed[i] and not self._alive[i]
                    and c.recover_at <= t_ref):
                self._alive[i] = True
                eng.revive(c.recover_at)
                if self.events is not None:
                    self.events.emit(c.recover_at, -1, "replica_up", i)

    def _charge_retry(self, req: Request, t_fail: float) -> bool:
        """Spend one retry.

        False when the budget is exhausted (the request is dropped and
        counted lost).
        """
        if req.retries >= self.rc.max_retries:
            self.n_lost += 1
            if self.events is not None:
                # the arrival may never have reached any engine's log;
                # emit it (rollup dedups per-rid) so goodput sees the
                # loss, then the terminal cancel
                self.events.emit(req.arrival, req.rid, "arrival")
                self.events.emit(max(t_fail, req.arrival), req.rid,
                                 "cancel")
            return False
        req.retries += 1
        self.n_retries += 1
        if self.events is not None:
            self.events.emit(max(t_fail, req.arrival), req.rid, "retry",
                             req.retries)
        return True

    def _requeue(self, req: Request, t_fail: float):
        """Failover path: reset progress and requeue with backoff.

        Capped exponential backoff; the original arrival is preserved,
        so completion latency stays user-perceived.
        """
        if not self._charge_retry(req, t_fail):
            return
        backoff = min(self.rc.retry_backoff_s * 2 ** (req.retries - 1),
                      self.rc.retry_backoff_cap_s)
        self._reset_for_retry(req)
        heapq.heappush(self._retryq,
                       (t_fail + backoff, self._retry_seq, req))
        self._retry_seq += 1

    @staticmethod
    def _reset_for_retry(req: Request):
        """Wipe engine-side progress for a clean re-prefill.

        The survivor re-prefills from scratch (its prefix cache makes
        that cheap for warm prompts). The original ``arrival`` and any
        already-streamed first-token time are kept — metrics stay
        user-perceived.
        """
        req.generated = []
        req.entry = SchedEntry(rid=req.rid, arrival=req.arrival,
                               prompt_len=len(req.prompt))
        req.posterior = None
        req.tap_sum = None
        req.tap_cnt = 0
        req.slot = -1
        req.finish_time = -1.0

    def _defer_or_drop(self, req: Request, t: float):
        """Handle an arrival with no eligible replica.

        Waits for the next scheduled recovery when one exists (not
        charged as a retry), else the request is lost.
        """
        recoveries = []
        if self.faults is not None:
            for i in range(len(self.replicas)):
                if self._alive[i]:
                    continue
                c = self.faults.crash_for(i)
                if c is not None and c.recover_at != NEVER:
                    recoveries.append(c.recover_at)
        t_rec = min((r for r in recoveries if r > t), default=None)
        if t_rec is not None:
            heapq.heappush(self._retryq, (t_rec, self._retry_seq, req))
            self._retry_seq += 1
            return
        self.n_lost += 1
        if self.events is not None:
            self.events.emit(req.arrival, req.rid, "arrival")
            self.events.emit(max(t, req.arrival), req.rid, "cancel")

    # -- virtual-time event loop ------------------------------------------
    def run(self, requests: list[Request]) -> ClusterStats:
        """Drive the whole arrival stream to completion.

        Arrivals (original stream merged with failover retries) are
        consumed in time order; between dispatches, the busy replica
        with the smallest virtual clock steps, with due faults applied
        at every boundary. The loop ends when every alive replica is
        drained and no arrival or retry remains.
        """
        pending = sorted(requests, key=lambda r: r.arrival)
        q = 0
        while True:
            if self.rc.prefill_replicas:
                # export parked prefills first: a prefill replica whose
                # every request is parked would otherwise pin the
                # frontier forever (it has work but its clock is idle)
                self._drain_handoffs()
            busy = [e for i, e in enumerate(self.replicas)
                    if self._alive[i] and e.has_work()]
            # next event: original arrival vs. failover retry vs. due
            # KV handoff (delivered with priority on ties — the import
            # must land before a same-instant routing decision observes
            # the destination)
            t_arr = pending[q].arrival if q < len(pending) else None
            t_rty = self._retryq[0][0] if self._retryq else None
            t_hnd = self._handoffq[0][0] if self._handoffq else None
            t_next = min((t for t in (t_arr, t_rty, t_hnd)
                          if t is not None), default=None)
            if t_next is not None:
                frontier = min((e.now for e in busy), default=t_next)
                if t_next <= frontier:
                    # cluster time has reached the arrival: fire any
                    # fault due by now (idle replicas included) before
                    # the routing decision observes the fleet
                    self._apply_faults(t_next)
                    if t_hnd is not None and t_hnd <= t_next:
                        self._deliver_handoff()
                        continue
                    if t_rty is not None and (t_arr is None
                                              or t_rty <= t_arr):
                        _, _, req = heapq.heappop(self._retryq)
                    else:
                        req = pending[q]
                        q += 1
                    self.dispatch(req, t_next)
                    continue
            if not busy:
                break
            lag = min(busy, key=lambda e: e.now)
            if self.faults is not None:
                self._apply_faults(lag.now)
                if not lag.alive:       # the laggard just crashed
                    continue
                idx = self.replicas.index(lag)
                lag.set_slowdown(self.faults.slow_factor(idx, lag.now))
            lag.step()

        stats = ClusterStats(dispatch_counts=list(self.dispatch_counts),
                             n_requests=len(requests),
                             n_retries=self.n_retries,
                             n_lost=self.n_lost,
                             n_crashes=self.n_crashes,
                             n_handoffs=self.n_handoffs,
                             handoff_pages=self.handoff_pages,
                             leaked_pages=[
                                 eng.blocks.used_pages()
                                 if eng.blocks is not None else 0
                                 for eng in self.replicas])
        for eng in self.replicas:
            stats.latencies.extend(eng.stats.latencies)
            stats.ttfts.extend(eng.stats.ttfts)
            stats.replica_summaries.append(eng.stats.summary())
            stats.makespan = max(stats.makespan, eng.now)
        stats.event_log = self.merged_event_log()
        return stats

    def merged_event_log(self):
        """Merge the replicas' event logs into one time-ordered log.

        Returns None when no replica records events. Per-request event
        ordering survives the merge because each request lives on
        exactly one replica. Delegates to ``EventLog.merge_all`` — one
        concatenate-and-sort over all replicas instead of a re-sort per
        pairwise merge, with the merge key defined in exactly one place.
        """
        logs = [eng.events for eng in self.replicas
                if getattr(eng, "events", None) is not None]
        if self.events is not None and len(self.events):
            logs.append(self.events)
        if not logs:
            return None
        from repro_torch.metrics.events import EventLog
        return EventLog.merge_all(logs)


def run_cluster(cfg, requests, *, router_policy: str = "round-robin",
                n_replicas: int = 2, seed: int = 0,
                predictor_factory=None, size_predictor=None,
                record_events: bool = False,
                backlog_unit: str = "tokens",
                faults: FaultSchedule | None = None,
                max_retries: int = 2,
                prefill_replicas: int = 0,
                **engine_kwargs) -> ClusterStats:
    """Serve ``requests`` on an N-replica cluster (the `run_policy` twin).

    Args:
        cfg: the `ModelConfig` every replica serves.
        requests: the shared arrival stream (deep-copied, as in
            ``run_policy``).
        router_policy: one of `ROUTER_POLICIES`.
        n_replicas: replica count.
        seed: base seed; replica i uses ``seed + i`` so sim-mode RNG and
            oracle-probe noise streams are independent across replicas.
        predictor_factory: optional ``f(replica_index) -> PredictorBase``;
            default gives each replica its own oracle predictor.
        size_predictor: router-side prompt-only size estimator for the
            ``jspw`` policy. Defaults to a fresh `OraclePredictor` on a
            dedicated seed (sim mode's stand-in for the paper's
            prompt-phase probe); pass a `ProbePredictor` in real mode.
        record_events: give each replica a metrics-layer `EventLog`; the
            merged stream lands in ``ClusterStats.event_log``.
        backlog_unit: ``tokens`` | ``seconds`` — see `RouterConfig`.
        faults: optional `FaultSchedule` (or a ``--chaos`` spec via
            `repro_torch.cluster.faults.parse_chaos`) — deterministic
            replica crash / straggler / flaky-submit injection with
            router failover. None (the default) is byte-identical to the
            pre-resilience fault-free path.
        max_retries: per-request failover retry budget (see
            `RouterConfig`).
        prefill_replicas: first ``P`` replicas become a dedicated
            prefill pool (``prefill_only=True`` engines); the rest
            decode. 0 (the default) is the byte-identical colocated
            path. Requires a paged KV layout so finished prefills can
            ship their pages.
        **engine_kwargs: forwarded to `EngineConfig` (policy, c_limit,
            max_batch, mem_budget, kv_layout, predictor, ...). A
            ``predictor`` strategy spec selects every replica's
            length-prediction strategy (each replica builds its own
            instance on its own seed) *and* the router's default
            ``size_predictor``, so dispatch and scheduling see the same
            prediction quality. Rank-only strategies provide no
            magnitudes: the router then uses the raw (prior-based)
            backlog with no truncation.

    Returns:
        The aggregated `ClusterStats`.
    """
    if record_events:
        from repro_torch.metrics.events import EventLog
    replicas = []
    for i in range(n_replicas):
        kw = dict(engine_kwargs)
        if prefill_replicas and i < prefill_replicas:
            kw["prefill_only"] = True
        ecfg = EngineConfig(seed=seed + i, **kw)
        pred = predictor_factory(i) if predictor_factory else None
        replicas.append(Engine(cfg, ecfg, predictor=pred,
                               event_log=EventLog() if record_events
                               else None))
    if size_predictor is None and router_policy in ("jspw",
                                                    "prefix-affinity"):
        spec = engine_kwargs.get("predictor", "")
        if spec:
            from repro_torch.serving.predictors import make_predictor
            cand = make_predictor(spec, cfg.probe, seed=seed + 4242)
            # ordinal scores cannot truncate a token backlog — rank-only
            # routing falls back to the raw prior-based backlog sum
            if getattr(cand, "provides_magnitude", True):
                size_predictor = cand
        else:
            from repro_torch.serving.predictors import OraclePredictor
            size_predictor = OraclePredictor(cfg.probe, seed=seed + 4242)
    router = Router(replicas, RouterConfig(n_replicas=n_replicas,
                                           policy=router_policy, seed=seed,
                                           backlog_unit=backlog_unit,
                                           max_retries=max_retries,
                                           prefill_replicas=prefill_replicas),
                    size_predictor=size_predictor, faults=faults,
                    event_log=EventLog() if record_events else None)
    return router.run(copy.deepcopy(requests))
