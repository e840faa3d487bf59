"""Iteration-level serving engine (the paper's system, Figure 1).

A copy of the reference ``repro.serving.engine`` host state machine, sim
mode included; real mode drives the PyTorch model over its KV caches.

One engine iteration =
  1. admit new arrivals into the request pool (initial prompt-only
     prediction fixes r0 and the preemption budget a0 = floor(C*r0));
  2. run the SPRPT-LP scheduler over running+waiting+preempted requests
     under the slot/memory budget (Section 3.3); apply preemptions
     (discard-and-recompute: slot released, cache invalidated);
  3. chunked prefill for scheduled-but-unprefilled requests (shared
     per-iteration token budget, rank order);
  4. one decode MEGASTEP for every scheduled prefilled request: k =
     probe_interval fused decode+probe steps stay resident on device
     (on-device greedy sampling, KV written in place), with the probe
     fused into every step; Bayesian-refine predictions (Section 3.1) at
     each k-token probe boundary;
  5. advance the clock: real wall time, or the roofline cost model
     (see costmodel.py).

Two execution modes:
  * real  — the PyTorch model (``repro_torch.models.model.Model``)
            actually prefills/decodes on a fixed slot pool, over the
            contiguous or the paged KV layout (static shapes, updated in
            place); probe predictions are real probe outputs. Generation
            ends at the oracle length or EOS/max_new. The decode hot path
            runs in megasteps: scheduler, page allocation and cost model
            are consulted once per k tokens, and the host round-trip is
            O(B*k) token ids + probe posteriors (never O(B*vocab) logits).
            The engine clock stays the cost model's (a TPU v5e preset by
            default): its latencies are not times measured on the card.
  * sim   — no device math; oracle-noise probe statistics; paper-scale
            models under the cost model (Figures 5-7 reproduction). Sim
            stays a per-token loop: probe_interval only throttles
            refinement there, so scheduling semantics are unchanged.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.scheduler import Decision, ReqState, SchedEntry, select_batch
from repro_torch.serving.costmodel import CostModel, HardwareSpec
from repro_torch.serving.kv_cache import (BlockManager, PagedSlotPool,
                                          SlotPool, bytes_for_context,
                                          page_bytes,
                                          paged_bytes_for_context,
                                          pages_for_tokens,
                                          supports_page_retention)
from repro_torch.serving.predictors import (OraclePredictor, PredictorBase,
                                      make_predictor)
from repro_torch.serving.request import Request


@dataclass
class EngineConfig:
    """Knobs for one serving engine (one replica in cluster mode).

    Attributes:
        policy: scheduling policy — ``fcfs`` | ``sjf`` | ``srpt`` |
            ``trail`` | ``trail-bert`` | ``mlfq`` (see core/scheduler.py).
        c_limit: the paper's C — preemption budget fraction; a request is
            preemptable only for its first ``floor(C * r0)`` output tokens.
        max_batch: batch slot count (max concurrently running requests).
        mem_budget: KV-cache byte budget enforced at admission time.
        prefill_chunk: per-iteration chunked-prefill token budget shared by
            all prefilling requests in rank order.
        max_len: cache capacity per sequence, in tokens.
        probe_interval: refine predictions every k-th token (paper Sec 6);
            in real mode also the decode megastep length — k tokens per
            row stay on device between scheduling points.
        oom_mode: ``discard`` (paper's discard-and-recompute) | ``swap``
            (KV to host over DMA; sim-mode cost study only).
        kv_layout: ``contig`` (slot cache) | ``paged`` (block-table pages;
            preemption frees / retains / swaps at page granularity).
        page_size: tokens per KV page (paged layout only).
        prefix_cache: share identical KV prefixes across requests (paged
            layout, pure global-attention archs only): admission links
            the longest content-hash-matched page chain instead of
            prefilling it, ranks and admission bytes charge only uncached
            work, and finished requests' prompt pages stay warm in a
            reusable LRU pool. Off by default — disabled results are
            byte-identical to the pre-prefix-cache engine.
        predictor: length-prediction strategy spec
            (``name[:key=value,...]``, see
            `repro_torch.serving.predictors.STRATEGIES`), e.g.
            ``"noisy-oracle:sigma=0.5"``. Empty (the default) keeps the
            legacy sim-mode `OraclePredictor` — byte-identical to
            pre-strategy-layer engines. An explicitly passed predictor
            instance always wins over this spec. Rank-only strategies
            (``provides_magnitude == False``) require an ordinal
            scheduling policy (``rank`` / ``fcfs`` / ``mlfq``).
        mode: ``sim`` (cost-model clock, oracle-noise probe) | ``real``
            (the model actually prefills/decodes).
        hardware: roofline constants that drive the simulated clock.
        seed: seed for the engine's decode-token RNG (sim mode).
        deadline_s: default per-request completion deadline (seconds
            after arrival, engine clock); expired requests are cancelled
            with reason ``timeout`` at the next megastep boundary. 0 =
            no deadline. A request's own ``deadline_s`` overrides it.
        ttft_deadline_s: default first-token budget (seconds after
            arrival); a request still waiting for its first token past
            it is cancelled with reason ``timeout``. 0 = none.
        shed_watermark: predicted-backlog watermark in tokens (the TRAIL
            signal `Engine.backlog` already computes). While the live
            backlog exceeds it, the worst-ranked WAITING requests are
            shed (cancelled with reason ``shed``) at megastep
            boundaries. 0 (the default) disables shedding — results are
            byte-identical to the pre-resilience engine.
        admission_control: with ``shed_watermark`` set, refuse arrivals
            at admission time while the live backlog is over the
            watermark (reject-at-the-door instead of shedding queued
            work). Refused requests emit ``arrival`` + ``shed`` and
            never enter the pool.
        age_boost: rank-aging boost — rank units (predicted tokens for
            the magnitude policies) subtracted per second a request has
            been in the system beyond the ``age_delay_s`` grace window,
            for trail / srpt / trail-bert / rank. Any value > 0 bounds
            waiting time (no starvation); larger values dial the
            post-window ordering from pure SRPT toward FCFS, buying
            completion-p99 at a small mean cost. 0 (the default) keeps
            ranks byte-identical to the un-aged scheduler.
        age_delay_s: rank-aging grace window in seconds — ordering stays
            pure SRPT for requests that have waited less than this; only
            the excess wait is boosted. Read only when ``age_boost`` >
            0. 0 ages from arrival, which preserves *relative* order
            between any two queued requests (both fall at the same
            rate): a real starvation rescue wants a window around the
            tolerable-wait budget.
        deadline_slack_s: deadline-aware limited preemption — a RUNNING
            request whose completion deadline (per-request or engine
            ``deadline_s``) is within this many seconds is pinned into
            the batch (never preempted) under every preemptive policy,
            generalizing the paper's served-token C-limit to wall-clock
            urgency. 0 (the default) = off; no effect on requests
            without a deadline.
        prefill_only: disaggregated-prefill role. The engine runs
            chunked prefill only: a request whose prefill completes is
            *parked* (slot released, KV pages retained — no preemption
            is booked) instead of decoding, and surfaces in
            ``handoff_ready()`` for the router to ``export_request()``
            to a decode replica. Requires ``kv_layout='paged'`` on a
            page-retention arch (the handoff ships retained pages).
            Off by default — the engine is byte-identical without it.
    """

    policy: str = "trail"           # fcfs | sjf | srpt | trail | trail-bert
                                    # | mlfq | rank
    c_limit: float = 0.8            # the paper's C
    max_batch: int = 16             # slot count
    mem_budget: int = 1 << 62       # cache bytes budget
    prefill_chunk: int = 256        # per-iteration prefill token budget
    max_len: int = 1024             # cache slots per sequence
    probe_interval: int = 1         # refine every k-th token (paper Sec 6
                                    # future work; k>1 cuts probe cost k x).
                                    # real mode: also the decode MEGASTEP
                                    # length — k tokens per row stay on
                                    # device between scheduling points
    oom_mode: str = "discard"       # "discard" (paper's choice: recompute)
                                    # | "swap" (KV to host; sim mode only)
    kv_layout: str = "contig"       # "contig" (slot cache) | "paged"
                                    # (block-table pages; preemption frees /
                                    #  retains / swaps at page granularity)
    page_size: int = 16             # tokens per KV page (paged layout)
    prefix_cache: bool = False      # share identical KV prefixes across
                                    # requests (paged layout only)
    predictor: str = ""             # strategy spec "name[:k=v,...]"; empty
                                    # = legacy OraclePredictor default
    mode: str = "sim"               # "sim" | "real"
    hardware: HardwareSpec = field(default_factory=HardwareSpec)
    seed: int = 0
    deadline_s: float = 0.0         # default completion deadline (0 = none)
    ttft_deadline_s: float = 0.0    # default first-token budget (0 = none)
    shed_watermark: float = 0.0     # predicted-backlog shed threshold in
                                    # tokens (0 = shedding off)
    admission_control: bool = False  # refuse (vs queue) arrivals while the
                                     # backlog is over the watermark
    age_boost: float = 0.0          # rank-aging boost (rank units/second
                                    # waited past the grace window;
                                    # 0 = aging off)
    age_delay_s: float = 0.0        # rank-aging grace window (seconds)
    deadline_slack_s: float = 0.0   # deadline-slack non-preemption window
                                    # in seconds (0 = off)
    prefill_only: bool = False      # disaggregated-prefill role: park
                                    # finished prefills for KV handoff
                                    # instead of decoding (paged +
                                    # page-retention archs only)


@dataclass
class EngineStats:
    """Counters accumulated over an engine run (or a `step()` stream)."""

    latencies: list = field(default_factory=list)
    ttfts: list = field(default_factory=list)
    n_preemptions: int = 0
    recomputed_tokens: int = 0
    swapped_bytes: int = 0
    peak_mem_bytes: int = 0
    peak_batch: int = 0
    iterations: int = 0
    sim_time: float = 0.0
    prefilled_tokens: int = 0       # prefill tokens actually computed
    prefix_hit_tokens: int = 0      # prompt tokens served from the cache
    predictor_time_s: float = 0.0   # clock charged for predictor work
    predictor_calls: int = 0        # predictor invocations booked
    n_cancelled: int = 0            # total cancellations (any reason)
    n_timeouts: int = 0             # ...of which deadline/TTFT expiries
    n_shed: int = 0                 # ...of which load-shedding drops

    def summary(self) -> dict:
        """Aggregate the counters into the benchmark-facing dict."""
        lat = sorted(self.latencies)
        tt = sorted(self.ttfts)
        med = lambda v: v[len(v) // 2] if v else 0.0
        return {
            "mean_latency": float(np.mean(lat)) if lat else 0.0,
            "median_latency": med(lat),
            "mean_ttft": float(np.mean(tt)) if tt else 0.0,
            "median_ttft": med(tt),
            "p99_latency": lat[int(len(lat) * 0.99)] if lat else 0.0,
            "preemptions": self.n_preemptions,
            "recomputed_tokens": self.recomputed_tokens,
            "swapped_gb": self.swapped_bytes / 1e9,
            "peak_mem_gb": self.peak_mem_bytes / 1e9,
            "iterations": self.iterations,
            "peak_batch": self.peak_batch,
            "makespan": self.sim_time,
            "prefilled_tokens": self.prefilled_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "predictor_time_s": self.predictor_time_s,
            "predictor_calls": self.predictor_calls,
            "cancelled": self.n_cancelled,
            "timeouts": self.n_timeouts,
            "shed": self.n_shed,
        }


class StepResult:
    """Outcome of one `Engine.step()` call.

    Attributes:
        completed: requests that reached FINISHED during this step.
        now: the engine's virtual clock after the step.
        backlog: predicted remaining work (tokens) still queued/running —
            the join-shortest-predicted-work routing signal. Computed
            lazily on first access (an O(live requests) pass), so the
            batch ``run()`` loop, which never reads it, pays nothing.
        ran: False for idle steps (clock jump to the next arrival, or a
            fully drained engine); no device/sim work was performed.
        kv_headroom: free-page fraction of the KV pool after the step
            (1.0 = empty pool / effectively unlimited budget, 0.0 = full)
            — the routing-under-memory-pressure signal: dispatching a
            long-context arrival to a replica near its budget triggers
            avoidable preemptions, so `jspw` tie-breaks on it.
        events: the metrics-layer `Event`s this step emitted (arrival /
            admit / first-token / tokens / finish / preempt / swap);
            empty unless the engine was built with an ``event_log``.
    """

    __slots__ = ("completed", "now", "ran", "kv_headroom", "events",
                 "_backlog_fn", "_backlog")

    def __init__(self, completed=None, now=0.0, ran=False, backlog_fn=None,
                 kv_headroom=1.0, events=()):
        self.completed = completed if completed is not None else []
        self.now = now
        self.ran = ran
        self.kv_headroom = kv_headroom
        self.events = list(events)
        self._backlog_fn = backlog_fn
        self._backlog = None

    @property
    def backlog(self) -> float:
        """Predicted-work backlog at the end of the step (lazy, cached)."""
        if self._backlog is None:
            self._backlog = self._backlog_fn() if self._backlog_fn else 0.0
        return self._backlog


@dataclass
class KVHandoff:
    """One exported request's migration package (KV-page shipping).

    Produced by `Engine.export_request` on the source replica and
    consumed by `Engine.import_request` on the destination; the router
    charges `CostModel.kv_transfer_time(nbytes)` as delayed availability
    in between. The `Request` object travels whole, so arrival,
    first_token_time, generated tokens and the live prediction state all
    survive the migration.

    Attributes:
        req: the request (entry/arrival/first_token_time intact).
        kv_tokens: materialized prefix tokens shipped; 0 means the
            destination re-prefills from scratch.
        n_pages: KV pages on the wire (the transfer-size unit).
        nbytes: page bytes on the wire (``n_pages * page_bytes``).
        payload: real mode only — the host-side page payload gathered by
            `PagedSlotPool.export_pages` (one batched copy); None in sim
            mode, where the descriptor is the whole transfer.
        pred_tokens: predicted remaining decode tokens at export, or
            None under a rank-only predictor (ordinal score — the
            router must not read it as work).
        src_now: source replica clock at export (the transfer starts
            here).
    """

    req: Request
    kv_tokens: int = 0
    n_pages: int = 0
    nbytes: int = 0
    payload: object = None
    pred_tokens: float | None = None
    src_now: float = 0.0


class Engine:
    """Iteration-level serving engine (one replica).

    Two entry styles share one state machine:

    * batch — ``run(requests)`` drives the whole trace to completion
      (the original API; byte-identical results).
    * incremental — ``submit(req)`` enqueues an arrival at any time and
      ``step()`` executes exactly one engine iteration (one decode
      megastep + prefill chunk), returning a `StepResult`. The cluster
      `Router` uses this to interleave N replicas in virtual time.
    """

    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig,
                 predictor: PredictorBase | None = None,
                 model=None, event_log=None, device="cuda"):
        """Build one engine.

        Args:
            cfg: the model/architecture configuration it serves.
            ecfg: engine knobs (see `EngineConfig`).
            predictor: remaining-length predictor instance; overrides
                any ``ecfg.predictor`` strategy spec. Default: the spec
                (built via `make_predictor`) when given, else the
                legacy sim-mode `OraclePredictor`.
            model: the ``repro_torch.models.model.Model`` (real mode
                only); it carries its parameters.
            event_log: optional `repro_torch.metrics.EventLog`; when
                given the engine records per-request lifecycle events
                (arrival / admit / first-token / tokens / finish /
                preempt / swap) into it during ``step()``. Pure
                observation — results are byte-identical with or
                without a log.
            device: where real mode runs (``cuda`` unless the caller
                asks for ``cpu``); the model must live there.
        """
        self.cfg = cfg
        self.ecfg = ecfg
        self.events = event_log
        if predictor is not None:
            self.predictor = predictor
        elif ecfg.predictor:
            self.predictor = make_predictor(ecfg.predictor, cfg.probe,
                                            seed=ecfg.seed)
        else:
            self.predictor = OraclePredictor(cfg.probe, seed=ecfg.seed)
        # rank-only strategies emit ordinal scores, not token counts:
        # magnitude-consuming policies (preemption budget a0, megastep
        # lookahead, remaining-work ranks) would misread them
        self._magnitude = getattr(self.predictor, "provides_magnitude", True)
        if not self._magnitude and ecfg.policy not in ("rank", "fcfs",
                                                       "sjf", "mlfq"):
            raise ValueError(
                f"predictor provides ordinal ranks, not magnitudes; "
                f"policy {ecfg.policy!r} consumes token-count predictions "
                f"— use policy='rank' (or a prediction-free baseline)")
        self.paged = ecfg.kv_layout == "paged"
        if ecfg.kv_layout not in ("contig", "paged"):
            raise ValueError(f"unknown kv_layout {ecfg.kv_layout!r}")
        self.prefix_cache = ecfg.prefix_cache
        if self.prefix_cache:
            if not self.paged:
                raise ValueError("prefix_cache requires kv_layout='paged'")
            if not supports_page_retention(cfg):
                raise ValueError(
                    "prefix_cache requires a pure global-attention arch: "
                    "only there is the whole per-token state page-resident "
                    "and position-consistent across requests")
        self.cost = CostModel(cfg, ecfg.hardware,
                              page_size=ecfg.page_size if self.paged else 0)
        self.model = model
        self.pool: SlotPool | None = None
        self.blocks: BlockManager | None = None
        self._retain = self.paged and supports_page_retention(cfg)
        if ecfg.prefill_only and not self._retain:
            raise ValueError(
                "prefill_only requires kv_layout='paged' on a "
                "page-retention arch: the KV handoff ships retained pages")
        self._page_bytes = page_bytes(cfg, ecfg.page_size)
        self._swap_pending_s = 0.0
        if ecfg.oom_mode == "swap" and ecfg.mode == "real":
            raise ValueError("swap OOM mode is a cost-model study (sim only);"
                             " the real engine uses the paper's"
                             " discard-and-recompute")
        # megastep length: real mode decodes k = probe_interval tokens per
        # row per engine iteration without host round-trips; sim mode stays
        # per-token (probe_interval only throttles refinement there).
        self._k = max(1, ecfg.probe_interval) if ecfg.mode == "real" else 1
        if ecfg.mode == "real":
            if model is None:
                raise ValueError("real mode needs a model")
            if model.device.type != torch.device(device).type:
                raise ValueError(f"the model lives on {model.device}, not "
                                 f"on the engine's device {device!r}")
            if self.paged:
                self.pool = PagedSlotPool(model, ecfg.max_batch, ecfg.max_len,
                                          page_size=ecfg.page_size,
                                          retain=self._retain,
                                          prefix_cache=self.prefix_cache)
                self.blocks = self.pool.blocks
            else:
                self.pool = SlotPool(model, ecfg.max_batch, ecfg.max_len)
        elif self.paged:
            # sim mode: unbounded id space — capacity pressure is enforced
            # in bytes against mem_budget by the reclamation loop. The
            # warm prefix pool is itself capped at budget-equivalent
            # pages (or a large fixed cap under an effectively unlimited
            # budget) so index/LRU bookkeeping cannot grow with every
            # unique prompt ever served; admission charges hits at full
            # bytes, so used pages stay budget-bounded independently.
            cap = None
            if self.prefix_cache:
                cap = (ecfg.mem_budget // max(self._page_bytes, 1)
                       if ecfg.mem_budget < (1 << 60) else 1 << 20)
            self.blocks = BlockManager(0, ecfg.page_size,
                                       prefix_cache=self.prefix_cache,
                                       reusable_cap=cap)
        self._rng = np.random.default_rng(ecfg.seed)
        self._token_rate = None     # lazy decode_token_rate() cache
        self.alive = True           # cleared by crash(); router health
        self._slowdown = 1.0        # straggler time-dilation factor
        # resilience fast-path gate: the deadline scan only runs when a
        # deadline is actually configured (engine default or any
        # submitted request), so default runs pay nothing
        self._deadlines = ecfg.deadline_s > 0 or ecfg.ttft_deadline_s > 0
        self._reset_stream()

    def _reset_stream(self):
        """(Re)initialize the incremental-loop state.

        Empty request pool, clock at zero, fresh stats. Called by
        ``__init__`` and ``run()``.
        """
        self.stats = EngineStats()
        self._pending: list[Request] = []       # sorted by arrival
        self._p_idx = 0                         # next pending to admit
        self._subs: dict[int, object] = {}      # rid -> on_token callback
        self._pool_reqs: dict[int, Request] = {}
        self._entries: dict[int, SchedEntry] = {}
        self._now = 0.0
        self._r0_sum = 0.0                      # running mean of initial
        self._r0_cnt = 0                        # predictions (backlog prior)
        self._prefix_hint: dict[int, int] = {}  # rid -> prospective hit
        self._hint_gen: dict[int, int] = {}     # index_gen the hint saw
        self._parked: set[int] = set()          # prefill-complete rids
                                                # awaiting KV handoff
        self._last_mem = 0                      # bytes at last step end
        self._wall0 = time.perf_counter()
        if self.events is not None:
            self.events.clear()

    def _bytes_for(self, context_len: int) -> int:
        if self.paged:
            return paged_bytes_for_context(self.cfg, context_len,
                                           self.ecfg.page_size)
        return bytes_for_context(self.cfg, context_len)

    def _match_tokens(self, req) -> list[int]:
        """Prompt tokens eligible for prefix matching.

        Everything except the final token, which decode always consumes
        fresh — so a full hit still leaves the request one decode step of
        work and shared pages are never written by the sharer.
        """
        return req.prompt[:max(len(req.prompt) - 1, 0)]

    def _sync_prefill_left(self, req, hint: int = 0):
        """Refresh the entry's rank-visible remaining prefill work.

        Prefix-cache mode only: what is still uncached and unprefilled.
        ``hint`` discounts a WAITING request's prospective cache hit.
        """
        req.entry.prefill_left = float(max(
            req.context_len - 1 - req.entry.prefill_done - hint, 0))

    def kv_headroom(self) -> float:
        """Free fraction of the KV capacity (1.0 = empty, 0.0 = full).

        Real-mode paged pools report the free-page fraction of the
        physical pool (`BlockManager.free_pages()`); sim-mode engines
        report the unused fraction of ``mem_budget`` as of the last step
        (1.0 under an effectively unlimited budget).
        """
        if self.blocks is not None and self.blocks.bounded:
            return self.blocks.free_pages() / max(self.blocks.num_pages, 1)
        budget = self.ecfg.mem_budget
        if budget >= (1 << 60):
            return 1.0
        return max(0.0, 1.0 - self._last_mem / budget)

    # ------------------------------------------------------------------
    # incremental API: submit / step / accessors
    # ------------------------------------------------------------------
    @property
    def now(self) -> float:
        """The engine's virtual clock (seconds; sim-clock in sim mode)."""
        return self._now

    def has_work(self) -> bool:
        """True while any submitted request has not yet finished."""
        return self._p_idx < len(self._pending) or any(
            e.state is not ReqState.FINISHED for e in self._entries.values())

    def queue_len(self) -> int:
        """Number of unfinished requests known to this engine.

        Counts admitted-but-unfinished requests plus submitted arrivals
        not yet admitted — the join-shortest-queue routing signal.
        """
        n = sum(1 for e in self._entries.values()
                if e.state is not ReqState.FINISHED)
        return n + (len(self._pending) - self._p_idx)

    def backlog(self, truncate: float | None = None,
                include_pending: bool = True) -> float:
        """Predicted remaining work, in tokens, across unfinished requests.

        For admitted requests this is the live TRAIL prediction
        (``pred_remaining``, refined every probe boundary) plus the
        remaining prefill tokens. Submitted-but-unadmitted arrivals have
        no probe output yet, so they are charged their prompt length plus
        a workload-adaptive prior: the running mean of the initial
        predictions seen so far (falling back to ``max_len / 2``, the same
        uninformative prior `ProbePredictor.initial` uses). A fixed large
        prior would swamp the live-prediction signal during bursts and
        collapse join-shortest-predicted-work into round-robin.

        Args:
            truncate: if given, each job's predicted remaining tokens are
                clipped to this value before summing. With SPRPT inside
                every replica, the work a new job actually waits behind is
                the work *shorter than itself* — longer jobs yield to it —
                so the router truncates at the incoming job's own size
                estimate (SRPT-interfering work) instead of summing raw
                backlog, which is the right signal only for FCFS replicas.
                Under rank aging (``age_boost`` > 0) a queued job j also
                interferes once its aged rank
                ``r_j - boost*max(waited_j - age_delay_s, 0)`` beats the
                arrival's ``truncate``, so each admitted job's clip rises
                by that same hinge term — at boost=0 this is exactly the
                legacy cap.
            include_pending: charge submitted-but-unadmitted arrivals
                too (the default). The shedding/admission-control paths
                pass False — overload decisions at time t must not count
                work that has not arrived yet.
        """
        cap = float("inf") if truncate is None else truncate
        boost = self.ecfg.age_boost
        prior = (self._r0_sum / self._r0_cnt if self._r0_cnt
                 else self.predictor.pc.max_len / 2.0)
        tot = 0.0
        for rid, e in self._entries.items():
            if e.state is ReqState.FINISHED:
                continue
            req = self._pool_reqs[rid]
            cap_e = cap
            if boost > 0.0 and truncate is not None:
                cap_e = cap + boost * max(
                    self._now - e.arrival - self.ecfg.age_delay_s, 0.0)
            if self._magnitude:
                tot += min(max(e.pred_remaining, 0.0), cap_e)
            else:
                # rank-only: scores are not token counts — charge the
                # uninformative prior, decayed by tokens already served
                tot += min(max(prior - e.age, 0.0), cap_e)
            hint = (self._prefix_hint.get(rid, 0)
                    if self.prefix_cache and e.state is ReqState.WAITING
                    else 0)
            tot += max(req.context_len - 1 - e.prefill_done - hint, 0)
        if include_pending:
            for req in self._pending[self._p_idx:]:
                tot += len(req.prompt) + min(prior, cap)
        return tot

    def backlog_seconds(self, truncate: float | None = None) -> float:
        """`backlog()` normalized into estimated seconds of replica work.

        Predicted remaining tokens divide by this replica's decode rate
        (`CostModel.decode_token_rate`, a function of its `HardwareSpec`)
        — the unit the router needs once replicas stop being identical:
        5k tokens queued on a 2x-faster replica is *less* wait, which a
        token-count comparison cannot see. ``truncate`` stays in tokens
        (the arrival's size estimate), applied before conversion. With
        identical replicas the conversion is one shared positive scale,
        so `jspw` dispatch decisions are unchanged — the router's
        ``backlog_unit="seconds"`` flag relies on exactly that.
        """
        rate = self._token_rate
        if rate is None:
            rate = self._token_rate = self.cost.decode_token_rate()
        return self.backlog(truncate=truncate) / rate

    def cached_prefix_tokens(self, prompt) -> int:
        """Longest prompt prefix (tokens) resident in the prefix cache.

        The router's ``prefix-affinity`` signal. Zero when prefix caching
        is off. Pure lookup: no refcounts or LRU moves.
        """
        if not self.prefix_cache:
            return 0
        return self.blocks.match_len(prompt[:max(len(prompt) - 1, 0)])

    def submit(self, req: Request):
        """Enqueue one arrival, admitted once the clock reaches it.

        Arrivals may be submitted in any order, but never
        earlier than an already-admitted arrival (the router's virtual-time
        frontier guarantees this).
        """
        if req.deadline_s > 0 or req.ttft_deadline_s > 0:
            self._deadlines = True
        i = bisect.bisect_right(self._pending, req.arrival,
                                lo=self._p_idx, key=lambda r: r.arrival)
        self._pending.insert(i, req)

    def on_token(self, rid: int, cb) -> None:
        """Subscribe a per-request streaming callback.

        ``cb(t, kind, value)`` fires synchronously from inside ``step()``
        (or ``cancel()``) whenever request ``rid`` emits ``first_token``,
        ``tokens`` (value = tokens this megastep), ``finish``, or a
        terminal cancel kind (``cancel`` / ``timeout`` / ``shed``), in
        emission order. This is the O(1) hook the serving front door uses
        instead of re-scanning ``StepResult.events`` every megastep. One
        callback per rid — a second call replaces the first — and the
        subscription is dropped automatically after a terminal kind
        (detach earlier with :meth:`off_token`). Works with or without an
        attached EventLog; engines with no subscribers skip the dispatch
        entirely, so default runs are unchanged.
        """
        self._subs[rid] = cb

    def off_token(self, rid: int) -> None:
        """Drop the :meth:`on_token` callback for ``rid`` (idempotent)."""
        self._subs.pop(rid, None)

    def _notify(self, t: float, rid: int, kind: str, value: float = 0.0):
        """Dispatch one stream event to the rid's subscriber, if any.

        Terminal kinds (``finish`` and the cancel kinds) auto-unsubscribe
        before the callback runs, so a raising callback cannot leak its
        subscription and a terminal event is delivered at most once.
        """
        cb = self._subs.get(rid)
        if cb is None:
            return
        if kind in ("finish", "cancel", "timeout", "shed"):
            del self._subs[rid]
        cb(t, kind, value)

    def _admit_arrivals(self, t: float):
        ecfg = self.ecfg
        gate = ecfg.admission_control and ecfg.shed_watermark > 0.0
        while (self._p_idx < len(self._pending)
               and self._pending[self._p_idx].arrival <= t):
            req = self._pending[self._p_idx]
            if (gate and self.backlog(include_pending=False)
                    > ecfg.shed_watermark):
                # admission control: the door is shut while live backlog
                # exceeds the watermark — the arrival is observed, then
                # immediately shed (never enters pool or scheduler)
                self._p_idx += 1
                req.entry.state = ReqState.CANCELLED
                req.cancel_reason = "shed"
                self.stats.n_cancelled += 1
                self.stats.n_shed += 1
                if self.events is not None:
                    self.events.emit(req.arrival, req.rid, "arrival")
                    self.events.emit(max(t, req.arrival), req.rid, "shed")
                if self._subs:
                    self._notify(max(t, req.arrival), req.rid, "shed")
                continue
            r0 = self.predictor.initial(req)
            req.entry.r0 = r0
            req.entry.pred_remaining = r0
            req.entry.c_limit = ecfg.c_limit
            req.entry.finish_len = req.true_out_len
            dl = req.deadline_s or ecfg.deadline_s
            if dl > 0:
                # absolute deadline on the engine clock: feeds both the
                # expiry scan and the deadline-slack non-preemption rule
                req.entry.deadline_at = req.arrival + dl
            if self._magnitude:
                # ordinal scores must not pollute the token-count prior
                self._r0_sum += r0
                self._r0_cnt += 1
            if self.prefix_cache:
                # prospective hit: lets the scheduler's ranks and the
                # backlog signal see the cached prefix before admission
                hint = self.blocks.match_len(self._match_tokens(req))
                self._prefix_hint[req.rid] = hint
                self._hint_gen[req.rid] = self.blocks.index_gen
                self._sync_prefill_left(req, hint)
            self._pool_reqs[req.rid] = req
            self._entries[req.rid] = req.entry
            self._p_idx += 1
            if self.events is not None:
                self.events.emit(req.arrival, req.rid, "arrival")

    def step(self) -> StepResult:
        """Execute one engine iteration (one megastep) and return it.

        Admits due arrivals, consults the scheduler once, runs one prefill
        chunk + one decode megastep, and advances the clock. If no request
        is live the clock jumps to the next pending arrival (an idle step,
        ``ran=False``); a drained engine returns immediately.
        """
        ecfg = self.ecfg
        stats = self.stats
        pool_reqs = self._pool_reqs
        entries = self._entries
        now = self._now
        ev = self.events
        ev_mark = len(ev) if ev is not None else 0

        self._admit_arrivals(now)
        # resilience checks run at megastep boundaries, before the
        # scheduler sees the pool; both are gated so the default engine
        # (no deadlines, no watermark) takes neither branch
        if self._deadlines:
            self._expire_deadlines(now)
        if ecfg.shed_watermark > 0.0:
            self._shed_overload()
        if ecfg.prefill_only:
            # disaggregated-prefill role: a request whose prefill is
            # complete parks for KV handoff instead of decoding. Parking
            # is not a preemption (no stats/events) — the request simply
            # leaves the schedulable set with its pages retained, where
            # it stays evictable under memory pressure until the router
            # exports it.
            for r in pool_reqs.values():
                if (not r.done and r.rid not in self._parked
                        and r.entry.prefill_done >= r.context_len - 1):
                    if r.entry.state is ReqState.RUNNING:
                        self._suspend(r)
                    self._parked.add(r.rid)
        live = [r for r in pool_reqs.values()
                if not r.done and r.rid not in self._parked]
        if not live:
            if self._p_idx < len(self._pending):
                # idle: jump to next arrival
                self._now = self._pending[self._p_idx].arrival
            return StepResult(now=self._now, backlog_fn=self.backlog,
                              kv_headroom=self.kv_headroom(),
                              events=ev.events[ev_mark:] if ev is not None
                              else ())

        # admission charges each candidate's bytes at the END of the
        # upcoming megastep (context + k), so a k-token megastep can
        # never outgrow the budget mid-flight. A prefix-cache hit is NOT
        # discounted here: linking flips warm (refcount-zero) pages into
        # used pages, so the budget must cover them or resident memory
        # could exceed what the mirrored physical pool holds. The cached
        # win is charged where it belongs — zero prefill compute
        # (costmodel) and a smaller remaining-work rank (prefill_left) —
        # while the *memory* saving of sharing shows up in the
        # unique-page accounting (shared pages counted once).
        sched_entries = entries
        if self._parked:
            sched_entries = {rid: e for rid, e in entries.items()
                             if rid not in self._parked}
        decision = select_batch(
            sched_entries, policy=ecfg.policy, max_batch=ecfg.max_batch,
            mem_budget=ecfg.mem_budget,
            bytes_fn=lambda e: self._bytes_for(
                pool_reqs[e.rid].context_len + self._k),
            lookahead=self._k, now=now, age_boost=ecfg.age_boost,
            age_delay=ecfg.age_delay_s,
            deadline_slack=ecfg.deadline_slack_s)

        self._apply_preemptions(decision, pool_reqs, stats)
        if self.paged:
            # page-granular memory pressure: suspended (preempted but
            # resident) pages yield before any admitted request starts
            self._reclaim_pages(decision, pool_reqs, entries, stats)
        self._apply_admissions(decision, pool_reqs, stats)

        # Prefill covers context_len - 1 tokens; the final known token is
        # always consumed by decode_step (which emits the next one). This
        # keeps fresh and preemption-resumed requests on one code path.
        sched = [pool_reqs[rid] for rid in decision.scheduled]
        prefilling = [r for r in sched
                      if r.entry.prefill_done < r.context_len - 1]
        decoding = [r for r in sched
                    if r.entry.prefill_done >= r.context_len - 1]

        if not sched:
            if self._p_idx < len(self._pending):
                self._now = max(now, self._pending[self._p_idx].arrival)
                return StepResult(now=self._now, backlog_fn=self.backlog,
                                  kv_headroom=self.kv_headroom(),
                                  events=ev.events[ev_mark:]
                                  if ev is not None else ())
            raise RuntimeError(
                "scheduler deadlock: nothing fits the memory budget")
        stats.peak_batch = max(stats.peak_batch, len(sched))

        # ---- chunked prefill (shared token budget, rank order) --------
        budget = ecfg.prefill_chunk
        pf_plan: list[tuple[Request, int]] = []
        for r in prefilling:
            if budget <= 0:
                break
            todo = (r.context_len - 1) - r.entry.prefill_done
            take = min(todo, budget)
            pf_plan.append((r, take))
            budget -= take

        if self.paged:
            # allocate pages ahead of the writes this iteration performs
            # (decode rows pre-reserve their whole megastep budget: the
            # block table is frozen while the k steps run on device)
            for r, take in pf_plan:
                self._ensure_pages(r, r.entry.prefill_done + take, entries)
            for r in decoding:
                self._ensure_pages(
                    r, r.context_len + self._row_budget(r) - 1, entries)
        if self.prefix_cache:
            # COW guard: any shared page covering a position about to be
            # written is replaced by a private copy first (a no-op in the
            # standard flow — shared pages are full and writes land past
            # them — but it makes the immutability invariant enforced)
            make_writable = (self.pool.make_writable if self.pool is not None
                             else self.blocks.make_writable)
            for r, _take in pf_plan:
                make_writable(r.rid, r.entry.prefill_done)
            for r in decoding:
                make_writable(r.rid, max(r.context_len - 1, 0))

        # capture per-row decode contexts before tokens are appended:
        # the cost model charges context c+1..c+n for a row emitting n
        dec_ctxs = [r.context_len + 1 for r in decoding]
        if ecfg.mode == "real":
            emitted = self._device_step(pf_plan, decoding)
        else:
            emitted = self._sim_step(pf_plan, decoding)

        # ---- bookkeeping / clock -------------------------------------
        pf_tokens = sum(t for _, t in pf_plan)
        pf_ctx = max((r.context_len for r, _ in pf_plan), default=0)
        dt = self.cost.megastep_time(
            dec_ctxs, [emitted.get(r.rid, 0) for r in decoding],
            pf_tokens, pf_ctx)
        dt += self._swap_pending_s              # DMA stalls the batch
        self._swap_pending_s = 0.0
        # externally-priced predictor work (BERT-sized prompt models,
        # ELIS proxy re-predictions) charged this step stalls the clock;
        # zero-flop strategies (recycled probe, analysis oracles) add
        # exactly 0.0 — legacy results stay byte-identical
        pred_flops = self.predictor.take_cost_flops()
        if pred_flops:
            pred_s = self.cost.predictor_time(pred_flops)
            dt += pred_s
            stats.predictor_time_s += pred_s
        stats.predictor_calls = self.predictor.cost_calls
        if self._slowdown != 1.0:
            # straggler fault injection: the replica's hardware runs
            # slower, dilating the whole megastep (compute, DMA stalls,
            # predictor work). 1.0 — the default — leaves the clock
            # byte-identical to the pre-resilience engine.
            dt *= self._slowdown
        now_next = now + dt
        completed: list[Request] = []
        for r, take in pf_plan:
            r.entry.prefill_done += take
            # tokens actually materialized in the cache (never credited
            # past what was written: a mid-prefill preemption must not
            # mark unwritten positions as retained). The prefilled_tokens
            # stat counts only the newly materialized portion: a decoded
            # row re-enters the prefill classification to catch
            # prefill_done up to its grown context, but those positions
            # were already KV-written by decode and are not fresh prefill
            # work.
            kv_before = getattr(r, "_kv_written", 0)
            stats.prefilled_tokens += max(r.entry.prefill_done - kv_before, 0)
            r._kv_written = max(kv_before, r.entry.prefill_done)
        for r in decoding:
            n = emitted.get(r.rid, 0)
            r._kv_written = max(getattr(r, "_kv_written", 0),
                                r.context_len - 1)
            r.entry.age += n
            if r.first_token_time < 0 and n > 0:
                r.first_token_time = now_next
                if ev is not None:
                    ev.emit(now_next, r.rid, "first_token")
                if self._subs:
                    self._notify(now_next, r.rid, "first_token")
            if ev is not None and n > 0:
                ev.emit(now_next, r.rid, "tokens", n)
            if self._subs and n > 0:
                self._notify(now_next, r.rid, "tokens", float(n))
            if (len(r.generated) >= r.true_out_len
                    or len(r.generated) >= r.max_new_tokens):
                r.entry.state = ReqState.FINISHED
                r.finish_time = now_next
                stats.latencies.append(r.latency())
                stats.ttfts.append(r.ttft())
                completed.append(r)
                if ev is not None:
                    ev.emit(now_next, r.rid, "finish")
                if self._subs:
                    self._notify(now_next, r.rid, "finish")
                if self.prefix_cache:
                    # publish the finished request's prompt pages before
                    # release parks them in the reusable pool
                    self._register_prompt(r)
                if self.pool is not None:
                    self.pool.release(r.rid)
                elif r.slot >= 0:
                    r.slot = -1
                if self.blocks is not None and self.pool is None:
                    # sim mode only: real-mode release() freed the pages
                    self.blocks.free_request(r.rid)

        if self.blocks is not None:
            for rid in decision.scheduled:
                r = pool_reqs[rid]
                if not r.done:
                    self.blocks.note_cached(
                        rid, getattr(r, "_kv_written", 0))
                    if self.prefix_cache:
                        self._register_prompt(r)
        if self.prefix_cache:
            gen = self.blocks.index_gen
            for r in pool_reqs.values():
                if r.done:
                    continue
                if r.entry.state is ReqState.WAITING:
                    # refresh the prospective hit only when the index
                    # actually changed (generation-gated): match_prefix
                    # is O(prompt pages) and a long WAITING queue would
                    # otherwise pay it every step for nothing
                    if self._hint_gen.get(r.rid) != gen:
                        self._prefix_hint[r.rid] = self.blocks.match_len(
                            self._match_tokens(r))
                        self._hint_gen[r.rid] = gen
                    self._sync_prefill_left(
                        r, self._prefix_hint.get(r.rid, 0))
                else:
                    self._sync_prefill_left(r)

        if self.prefix_cache:
            # page-accurate under sharing: each physical page counts once
            # however many block tables reference it, and reusable cache
            # pages (refcount zero) are reclaimable, hence free
            mem = self.cost.resident_page_bytes(self.blocks.used_pages())
        else:
            mem = sum(self._bytes_for(pool_reqs[rid].context_len)
                      for rid in decision.scheduled)
            if self.blocks is not None:
                mem += self._page_bytes * sum(
                    self.blocks.resident_pages(e.rid)
                    for e in entries.values()
                    if e.state is ReqState.PREEMPTED)
        stats.peak_mem_bytes = max(stats.peak_mem_bytes, mem)
        self._last_mem = mem
        stats.iterations += 1
        self._now = now_next
        stats.sim_time = (self._now if ecfg.mode == "sim"
                          else time.perf_counter() - self._wall0)
        return StepResult(completed=completed, now=self._now,
                          backlog_fn=self.backlog, ran=True,
                          kv_headroom=self.kv_headroom(),
                          events=ev.events[ev_mark:] if ev is not None
                          else ())

    # ------------------------------------------------------------------
    def run(self, requests: list[Request]) -> EngineStats:
        """Drive a whole request trace to completion (the batch API).

        Reimplemented on top of ``submit()``/``step()``: results are
        byte-identical to the original monolithic loop. Resets any prior
        incremental state — an engine is either batch- or step-driven.
        """
        if self.ecfg.prefill_only:
            raise ValueError(
                "prefill_only engines never decode, so run() cannot "
                "drain: drive them incrementally (submit/step + "
                "export_request), e.g. via run_cluster(prefill_replicas=N)")
        self._reset_stream()
        for req in sorted(requests, key=lambda r: r.arrival):
            self.submit(req)
        while self.has_work():
            self.step()
        stats = self.stats
        stats.sim_time = (self._now if self.ecfg.mode == "sim"
                          else time.perf_counter() - self._wall0)
        return stats

    # ------------------------------------------------------------------
    # resilience: cancellation, deadlines, load shedding, fault hooks
    # ------------------------------------------------------------------
    def cancel(self, rid: int, reason: str = "cancel") -> bool:
        """Cancel one request in any state; returns True if it was live.

        Works for WAITING / RUNNING / PREEMPTED (suspended) requests, in
        prefill or decode, and for submitted-but-unadmitted arrivals.
        The KV footprint is released through the normal refcount paths:
        shared prefix pages are deregistered (they stay with their other
        owners or park warm in the reusable pool), host-swapped pages
        are reclaimed, and real-mode slots/pages queue device resets.
        The entry leaves scheduler state and backlog accounting
        entirely, so a cancelled request can never be scheduled again.

        Args:
            rid: the request id.
            reason: ``cancel`` (explicit) | ``timeout`` (deadline
                expiry) | ``shed`` (load shedding) — doubles as the
                emitted event kind.

        Returns:
            True if the request existed and was still unfinished; False
            for unknown, already-finished, or already-cancelled rids
            (cancellation is idempotent).
        """
        if reason not in ("cancel", "timeout", "shed"):
            raise ValueError(f"unknown cancel reason {reason!r}")
        # still queued behind the arrival frontier? (submitted, unadmitted)
        for i in range(self._p_idx, len(self._pending)):
            if self._pending[i].rid == rid:
                req = self._pending.pop(i)
                req.entry.state = ReqState.CANCELLED
                req.cancel_reason = reason
                self._book_cancel(reason)
                if self.events is not None:
                    # the arrival was never admitted, so its arrival
                    # event is emitted here — goodput counts it
                    self.events.emit(req.arrival, rid, "arrival")
                    self.events.emit(max(self._now, req.arrival), rid,
                                     reason)
                if self._subs:
                    self._notify(max(self._now, req.arrival), rid, reason)
                return True
        req = self._pool_reqs.get(rid)
        if req is None or req.done:
            return False
        # release the KV footprint through the standard machinery
        if self.pool is not None:
            if rid in self.pool.slot_of:        # RUNNING on a device slot
                if self.paged:
                    self.pool.release(rid, retain=False)
                else:
                    self.pool.release(rid)
            elif self.paged:
                # suspended: retained/host pages but no slot — free via
                # the block manager (resets queue for flush_resets)
                self.blocks.free_request(rid)
        elif self.blocks is not None:           # sim-mode paged
            self.blocks.free_request(rid)
        req.slot = -1
        req._swapped = False                    # host copy abandoned
        req._kv_written = 0
        self._prefix_hint.pop(rid, None)
        self._hint_gen.pop(rid, None)
        req.entry.state = ReqState.CANCELLED
        req.cancel_reason = reason
        # out of scheduler state and backlog/queue accounting
        self._parked.discard(rid)
        del self._entries[rid]
        del self._pool_reqs[rid]
        self._book_cancel(reason)
        if self.events is not None:
            self.events.emit(self._now, rid, reason)
        if self._subs:
            self._notify(self._now, rid, reason)
        return True

    def _book_cancel(self, reason: str):
        self.stats.n_cancelled += 1
        if reason == "timeout":
            self.stats.n_timeouts += 1
        elif reason == "shed":
            self.stats.n_shed += 1

    def _expire_deadlines(self, now: float):
        """Cancel requests whose completion/TTFT budget has expired.

        Runs at megastep boundaries on the engine clock (a deadline that
        expires mid-megastep is enforced at the next boundary). A
        request-level deadline overrides the engine default; 0 = none.
        """
        ecfg = self.ecfg
        for rid in [r.rid for r in self._pool_reqs.values() if not r.done]:
            req = self._pool_reqs[rid]
            dl = req.deadline_s or ecfg.deadline_s
            if dl > 0 and now - req.arrival > dl:
                self.cancel(rid, reason="timeout")
                continue
            tdl = req.ttft_deadline_s or ecfg.ttft_deadline_s
            if (tdl > 0 and req.first_token_time < 0
                    and now - req.arrival > tdl):
                self.cancel(rid, reason="timeout")

    def _shed_overload(self):
        """Shed worst-ranked WAITING requests while over the watermark.

        Shedding cancels with reason ``shed`` until the predicted backlog
        fits again.

        Only never-started requests are shed — dropping RUNNING or
        suspended work would discard compute already spent. The victim
        order is the scheduler's own rank, worst first (latest arrival
        breaks ties), so with a magnitude predictor the longest
        predicted jobs go first — exactly the jobs SRPT would have
        served last anyway. Rank aging folds in here too: a long job
        that has already waited out most of its starvation bound ranks
        better than a fresh one, so shedding under ``age_boost`` > 0
        prefers the newest long work over the most-starved.
        """
        wm = self.ecfg.shed_watermark
        policy = self.ecfg.policy
        boost = self.ecfg.age_boost
        while self.backlog(include_pending=False) > wm:
            waiting = [e for e in self._entries.values()
                       if e.state is ReqState.WAITING]
            if not waiting:
                break           # backlog is all in-flight work: keep it
            victim = max(waiting,
                         key=lambda e: (e.rank(policy, now=self._now,
                                               age_boost=boost,
                                               age_delay=self.ecfg
                                               .age_delay_s),
                                        e.arrival))
            self.cancel(victim.rid, reason="shed")

    def crash(self, t: float | None = None) -> list[Request]:
        """Kill this replica: reclaim every page/slot, drop all state.

        Models a replica failure for the router's fault injection. All
        unfinished requests (admitted and still-pending) are returned so
        the router can redispatch them to survivors; the entire KV
        footprint is reclaimed through the standard release paths (the
        BlockManager ends with ``used_pages() == 0`` — the zero-leak
        invariant the resilience benchmark enforces). No per-request
        events are emitted here — the router records ``replica_down``
        and per-request ``retry`` events.

        Args:
            t: fault time; the clock advances to it if ahead (events the
               replica already emitted stay in its past).

        Returns:
            The unfinished `Request` objects, in arrival order.
        """
        if t is not None:
            self._now = max(self._now, t)
        lost = [r for r in self._pool_reqs.values() if not r.done]
        lost += self._pending[self._p_idx:]
        if self.pool is not None:
            for rid in list(self.pool.slot_of):
                if self.paged:
                    self.pool.release(rid, retain=False)
                else:
                    self.pool.release(rid)
        if self.blocks is not None:
            for rid in list(self.blocks.pages):
                self.blocks.free_request(rid)
            for rid in list(self.blocks.host_pages):
                self.blocks.free_request(rid)
        for r in lost:
            r.slot = -1
            r._swapped = False
            r._kv_written = 0
            r._reg_pages = 0
        self._pending = []
        self._p_idx = 0
        self._pool_reqs = {}
        self._entries = {}
        self._prefix_hint = {}
        self._hint_gen = {}
        self._parked = set()
        self.alive = False
        return sorted(lost, key=lambda r: r.arrival)

    def revive(self, t: float):
        """Bring a crashed replica back (empty) at time ``t``."""
        self.alive = True
        self._now = max(self._now, t)

    def set_slowdown(self, factor: float):
        """Set the straggler time-dilation factor (1.0 = healthy)."""
        if factor <= 0:
            raise ValueError(f"slowdown factor must be positive: {factor}")
        self._slowdown = factor

    # ------------------------------------------------------------------
    # disaggregation: KV handoff export/import (doubles as suspended-
    # request migration between any two paged engines)
    # ------------------------------------------------------------------
    def _suspend(self, req: Request):
        """Take a RUNNING request off its slot for parking/export.

        The handoff/migration twin of the scheduler's preemption path,
        minus the preemption bookkeeping (no preempt event, no ``n_preemptions``: parking a
        finished prefill is not a scheduling decision). Page-retention
        archs keep the KV resident; everything else discards it (the
        destination re-prefills).
        """
        rid = req.rid
        req.entry.state = ReqState.PREEMPTED
        if self._retain:
            cached = getattr(req, "_kv_written", 0)
            if self.pool is not None:   # real pool is max_len-bounded
                cached = min(cached, self.ecfg.max_len)
            self.blocks.ensure(rid, cached)
            self.blocks.note_cached(rid, cached)
        else:
            req.entry.prefill_done = 0
            req._kv_written = 0
            if self.blocks is not None and self.pool is None:
                self.blocks.free_request(rid)
        if self.pool is not None:
            if self.paged:
                self.pool.release(rid, retain=self._retain)
            else:
                self.pool.release(rid)
        req.slot = -1

    def handoff_ready(self) -> list[int]:
        """Rids parked for export, oldest arrival first.

        Parked means prefill complete on a ``prefill_only`` engine, slot
        released, pages retained. Always empty on non-disaggregated
        engines.
        """
        return sorted(self._parked,
                      key=lambda rid: (self._entries[rid].arrival, rid))

    def export_request(self, rid: int) -> KVHandoff:
        """Detach one unfinished request for migration to another engine.

        Valid in any live state (WAITING / RUNNING / PREEMPTED —
        RUNNING requests are suspended first), so it serves both the
        disaggregation handoff and generic suspended-request migration.
        On a page-retention engine the materialized KV prefix ships:
        sim mode ships the descriptor only, real mode additionally
        gathers the page payload in one batched device->host copy.
        The source side then releases everything through the standard
        refcount paths — shared prefix pages stay with their other
        owners, and a drained source ends with ``used_pages() == 0``
        (the zero-leak invariant the disagg benchmark gates on).

        Returns the `KVHandoff`; the request is gone from this engine.
        """
        req = self._pool_reqs.get(rid)
        if req is None or req.done:
            raise ValueError(f"rid {rid} is not exportable")
        if req.entry.state is ReqState.RUNNING:
            self._suspend(req)
        kv_tokens = n_pages = 0
        payload = None
        if self.blocks is not None and self._retain:
            # real mode ships only device-resident pages (host-swapped
            # tails have no gatherable payload); sim descriptors cover
            # the whole cached prefix, host pages included
            cached = (self.blocks.resident_tokens(rid)
                      if self.pool is not None
                      else self.blocks.cached_tokens.get(rid, 0))
            kv_tokens = min(cached, max(req.context_len - 1, 0))
            if self.pool is not None and kv_tokens > 0:
                payload = self.pool.export_pages(rid)
            snap = self.blocks.export_request(rid)
            if kv_tokens > 0:
                n_pages = snap["resident_pages"] + snap["host_pages"]
        elif self.blocks is not None:
            self.blocks.free_request(rid)
        req.slot = -1
        req._swapped = False
        self._parked.discard(rid)
        self._prefix_hint.pop(rid, None)
        self._hint_gen.pop(rid, None)
        del self._entries[rid]
        del self._pool_reqs[rid]
        if self.events is not None:
            self.events.emit(self._now, rid, "handoff", n_pages)
        pred = req.entry.pred_remaining if self._magnitude else None
        return KVHandoff(req=req, kv_tokens=kv_tokens, n_pages=n_pages,
                         nbytes=n_pages * self._page_bytes,
                         payload=payload, pred_tokens=pred,
                         src_now=self._now)

    def import_request(self, handoff: KVHandoff,
                       t: float | None = None) -> int:
        """Adopt a migrated request; returns the KV tokens resumed.

        The request enters the pool directly (its arrival is in the
        past by construction — the transfer only ever delays it), with
        arrival, first_token_time, generated tokens and prediction
        state preserved. Shipped KV lands as retained pages, so the
        normal copy-on-admit resume path re-links it at the next
        scheduling point with zero recompute; if the pool cannot hold
        the import (or the engine cannot retain pages) the request
        falls back to WAITING and re-prefills from scratch — correct
        either way, since greedy decode over re-computed KV is
        byte-identical.

        Args:
            handoff: the package from `export_request`.
            t: availability time on this engine's clock (dispatch time
                plus `CostModel.kv_transfer_time`); the clock advances
                to it if behind.
        """
        req = handoff.req
        rid = req.rid
        if rid in self._pool_reqs or rid in self._entries:
            raise ValueError(f"rid {rid} already present on this engine")
        if t is not None:
            self._now = max(self._now, t)
        entry = req.entry
        kv = 0
        if handoff.kv_tokens > 0 and self.blocks is not None and self._retain:
            want = min(handoff.kv_tokens, max(req.context_len - 1, 0))
            if self.pool is not None:
                if self.pool.import_pages(rid, min(want, self.ecfg.max_len),
                                          handoff.payload):
                    kv = min(want, self.ecfg.max_len)
            elif self.blocks.import_request(rid, want):
                kv = want
        entry.state = ReqState.PREEMPTED if kv > 0 else ReqState.WAITING
        entry.prefill_done = min(entry.prefill_done, kv)
        entry.c_limit = self.ecfg.c_limit
        entry.prefill_left = 0.0    # rank-visible only under prefix_cache
        if self.prefix_cache:
            self._sync_prefill_left(req)
        req._kv_written = kv
        req._swapped = False
        req.slot = -1
        if self._magnitude and handoff.pred_tokens is not None:
            # fold the migrant's prediction into the backlog prior, as
            # admission would have
            self._r0_sum += entry.r0
            self._r0_cnt += 1
        if (entry.deadline_at > 0 or req.ttft_deadline_s > 0
                or self.ecfg.ttft_deadline_s > 0):
            self._deadlines = True
        self._pool_reqs[rid] = req
        self._entries[rid] = entry
        return kv

    # ------------------------------------------------------------------
    def _apply_preemptions(self, decision: Decision, pool_reqs, stats):
        for rid in decision.preempted:
            req = pool_reqs[rid]
            req.entry.state = ReqState.PREEMPTED
            req.entry.preemptions += 1
            stats.n_preemptions += 1
            if self.events is not None:
                self.events.emit(self._now, rid, "preempt",
                                 req.entry.preemptions)
            if self._retain:
                # paged: pages stay resident ("suspended"); the reclamation
                # loop evicts/swaps them tail-first only under real memory
                # pressure, and resume accounting charges exactly the
                # evicted tokens. No recompute is booked here.
                cached = getattr(req, "_kv_written", 0)
                if self.pool is not None:       # real pool is max_len-bounded
                    cached = min(cached, self.ecfg.max_len)
                self.blocks.ensure(rid, cached)
                self.blocks.note_cached(rid, cached)
            elif self.ecfg.oom_mode == "swap":
                # KV moves to host; prefill progress is kept but the
                # DMA stalls the whole batch (paper Section 3.3 discussion)
                nbytes = self._bytes_for(req.context_len)
                stats.swapped_bytes += nbytes
                self._swap_pending_s += nbytes / self.ecfg.hardware.dma_bw
                req._swapped = True
                if self.events is not None:
                    self.events.emit(self._now, rid, "swap", nbytes)
                if self.blocks is not None:
                    # the whole cache is on host now; its device pages are
                    # free (swap-in is charged once at re-admission)
                    self.blocks.free_request(rid)
            else:
                # discard-and-recompute: cache gone, re-prefill everything
                stats.recomputed_tokens += req.entry.prefill_done
                req.entry.prefill_done = 0
                req._kv_written = 0     # nothing materialized any more: the
                                        # re-prefill is fresh compute and
                                        # counts as prefilled work again
                if self.blocks is not None and self.pool is None:
                    # sim mode only: in real mode pool.release() below frees
                    # the pages itself (and queues their device reset)
                    self.blocks.free_request(rid)
            if self.pool is not None:
                if self.paged:
                    self.pool.release(rid, retain=self._retain)
                else:
                    self.pool.release(rid)
            req.slot = -1

    def _register_prompt(self, req):
        """Publish ``req``'s fully-written prompt pages to the hash index.

        A per-request watermark skips the (O(prompt pages) hashing) walk
        once everything registerable has been offered — the ratchet only
        moves forward, so a rare eviction of already-offered pages just
        forgoes re-registration, never corrupts the index.
        """
        written = min(getattr(req, "_kv_written", 0), len(req.prompt))
        pages = written // self.ecfg.page_size
        if pages > getattr(req, "_reg_pages", 0):
            self.blocks.register_prefix(req.rid, req.prompt, written)
            req._reg_pages = pages

    def _apply_admissions(self, decision: Decision, pool_reqs, stats):
        for rid in decision.admitted:
            req = pool_reqs[rid]
            was_preempted = req.entry.state is ReqState.PREEMPTED
            req.entry.state = ReqState.RUNNING
            if self.events is not None:
                self.events.emit(self._now, rid, "admit")
            if (self.prefix_cache and not was_preempted
                    and req.entry.prefill_done == 0
                    and not self.blocks.pages.get(rid)):
                # link the longest cached prefix: block-table writes only,
                # no prefill compute; the costmodel is charged just for
                # the uncached tokens because prefill starts at the hit
                hit = self.blocks.link_prefix(rid, self._match_tokens(req))
                if hit:
                    stats.prefix_hit_tokens += hit
                    req.entry.prefill_done = hit
                    req._kv_written = hit
                    if self.events is not None:
                        self.events.emit(self._now, rid, "prefix_hit", hit)
                self._prefix_hint.pop(rid, None)
                self._hint_gen.pop(rid, None)
                self._sync_prefill_left(req)
            if getattr(req, "_swapped", False):     # swap back in (whole seq)
                nbytes = self._bytes_for(req.context_len)
                stats.swapped_bytes += nbytes
                self._swap_pending_s += nbytes / self.ecfg.hardware.dma_bw
                req._swapped = False
                if self.events is not None:
                    self.events.emit(self._now, rid, "swap", nbytes)
            if self._retain and was_preempted:
                n_host = self.blocks.host_pages.get(rid, 0)
                if n_host:                          # page-granular swap-in
                    nbytes = n_host * self._page_bytes
                    stats.swapped_bytes += nbytes
                    self._swap_pending_s += nbytes / self.ecfg.hardware.dma_bw
                    self.blocks.swap_in(rid)
                    if self.events is not None:
                        self.events.emit(self._now, rid, "swap", nbytes)
                # copy-on-admit: retained prefix re-links (block-table
                # write); only the evicted tail is ever recomputed
                retained = min(self.blocks.resume(rid),
                               max(req.context_len - 1, 0))
                lost = req.entry.prefill_done - retained
                if lost > 0:
                    stats.recomputed_tokens += lost
                req.entry.prefill_done = retained
                req._kv_written = retained
            if self.pool is not None:
                req.slot = self.pool.assign(rid)

    # ------------------------------------------------------------------
    # paged-layout memory management
    # ------------------------------------------------------------------
    def _suspended(self, entries, exclude=()):
        return [e for e in entries.values()
                if e.state is ReqState.PREEMPTED and e.rid not in exclude
                and self.blocks.resident_pages(e.rid) > 0]

    def _victim_key(self, e):
        """Eviction-victim ordering key.

        Prefer victims that can actually
        yield memory (an unshared tail page — shared pages free nothing
        and would force recompute for their other owners), then the
        least-urgent prediction. Without sharing every resident victim
        has an unshared tail, so the order is unchanged.
        """
        return (min(self.blocks.unshared_tail_pages(e.rid), 1),
                e.pred_remaining, e.rid)

    def _reclaim_pages(self, decision: Decision, pool_reqs, entries, stats):
        """Evict or swap out suspended pages until the budget fits.

        Tail-first from the least-urgent victim, until scheduled +
        suspended bytes fit.
        """
        sched = set(decision.scheduled)
        susp = self._suspended(entries, exclude=sched)
        if self.prefix_cache:
            # unique-page accounting: per-request byte sums would charge a
            # shared prefix once per owner and trigger evictions the real
            # footprint never required. Project end-of-megastep usage as
            # pages held now (each counted once) plus the growth scheduled
            # rows still need; a WAITING row's prospective hit counts as
            # growth too — linking flips warm pages into used ones.
            ps = self.ecfg.page_size
            growth = sum(
                max(pages_for_tokens(pool_reqs[rid].context_len + self._k,
                                     ps)
                    - self.blocks.resident_pages(rid), 0)
                for rid in decision.scheduled)
            over = ((self.blocks.used_pages() + growth) * self._page_bytes
                    - self.ecfg.mem_budget)
        else:
            need = sum(self._bytes_for(pool_reqs[rid].context_len + self._k)
                       for rid in decision.scheduled)
            resident = sum(self.blocks.resident_pages(e.rid) for e in susp)
            over = need + resident * self._page_bytes - self.ecfg.mem_budget
        swap = self.ecfg.oom_mode == "swap"
        while over > 0 and susp:
            victim = max(susp, key=self._victim_key)
            n_pages = -(-over // self._page_bytes)       # all we still need
            if swap:
                freed = self.blocks.swap_out_tail(victim.rid, n_pages)
                if freed:
                    nbytes = len(freed) * self._page_bytes
                    stats.swapped_bytes += nbytes
                    self._swap_pending_s += nbytes / self.ecfg.hardware.dma_bw
                    if self.events is not None:
                        self.events.emit(self._now, victim.rid, "swap",
                                         nbytes)
            elif self.pool is not None:
                freed = self.pool.evict_tail(victim.rid, n_pages)
            else:
                freed = self.blocks.evict_tail(victim.rid, n_pages)
            if not freed:
                break
            over -= len(freed) * self._page_bytes
            susp = [e for e in susp if self.blocks.resident_pages(e.rid) > 0]

    def _ensure_pages(self, req, tokens: int, entries):
        """Grow a scheduled request's page list to cover ``tokens``.

        Evicts suspended pages when the (real-mode) physical pool is
        exhausted.
        """
        if self.pool is not None:
            # only the real device pool is max_len-bounded; sim-mode paged
            # accounting must track contexts as far as the contig baseline
            tokens = min(tokens, self.ecfg.max_len)
        exhausted: set[int] = set()     # victims whose tail is all shared
        while True:
            ok = (self.pool.ensure_pages(req.rid, tokens)
                  if self.paged and self.pool is not None
                  else self.blocks.ensure(req.rid, tokens))
            if ok:
                return
            susp = self._suspended(entries, exclude=(req.rid, *exhausted))
            if not susp:
                raise RuntimeError("paged KV pool exhausted: no suspended "
                                   "pages left to evict")
            victim = max(susp, key=self._victim_key)
            shortfall = max(
                1, (-(-tokens // self.ecfg.page_size)
                    - self.blocks.resident_pages(req.rid)
                    - self.blocks.free_pages()))
            if self.pool is not None:
                freed = self.pool.evict_tail(victim.rid, shortfall)
            else:
                freed = self.blocks.evict_tail(victim.rid, shortfall)
            if not freed:
                # every remaining tail page is shared: evicting it frees
                # nothing — move on to the next victim
                exhausted.add(victim.rid)

    def _row_budget(self, r) -> int:
        """Decode tokens this row may emit in the upcoming megastep."""
        rem = min(r.true_out_len, r.max_new_tokens) - len(r.generated)
        return max(1, min(self._k, rem))

    # ------------------------------------------------------------------
    # sim mode: oracle probe statistics, no device math
    # ------------------------------------------------------------------
    def _sim_step(self, pf_plan, decoding):
        for r, take in pf_plan:
            if r.entry.prefill_done + take >= r.context_len - 1:
                pred = self.predictor.on_prefill(r)
                r.entry.pred_remaining = pred
        if decoding:
            # one vectorized draw per iteration (stream-identical to the
            # old per-request scalar draws, ~10x less RNG overhead)
            toks = self._rng.integers(1, self.cfg.vocab_size,
                                      size=len(decoding))
            for r, tok in zip(decoding, toks):
                r.generated.append(int(tok))
                if len(r.generated) % self.ecfg.probe_interval == 0:
                    r.entry.pred_remaining = self.predictor.on_token(r)
                else:   # between probes: predictions age deterministically
                    r.entry.pred_remaining = max(
                        r.entry.pred_remaining - 1.0, 0.0)
        return {r.rid: 1 for r in decoding}

    # ------------------------------------------------------------------
    # real mode: batched device megasteps over the slot pool
    # ------------------------------------------------------------------
    def _device_step(self, pf_plan, decoding) -> dict[int, int]:
        """Dispatch one prefill chunk + one decode megastep.

        Returns the tokens emitted per rid.

        Both device calls are dispatched before any output is fetched, so
        (on an async backend) the host runs the prefill-side probe
        bookkeeping while the k-step decode megastep is still executing.
        The only decode-side host transfer is O(B*k) token ids plus
        O(B*k*num_bins) probe posteriors — never the (B, vocab) logits.
        """
        pool = self.pool
        dev = pool.device
        B = pool.n_slots
        pool.flush_resets()
        # The scheduler's prefill classification runs on prefill_done, which
        # trails _kv_written after a decode megastep (decode writes KV for
        # the tokens it consumes but only the prefill bookkeeping advances
        # prefill_done). Feeding those caught-up positions to the device
        # again would append duplicate KV at cache["lengths"] and desync
        # the device cache from the logical context — so the device call
        # covers only the genuinely unwritten slice of each chunk, keeping
        # lengths == _kv_written at every megastep boundary (the invariant
        # page export/import relies on).
        feed: list[tuple[Request, int, int]] = []
        for r, take in pf_plan:
            done = r.entry.prefill_done
            skip = min(max(getattr(r, "_kv_written", 0) - done, 0), take)
            if take > skip:
                feed.append((r, done + skip, take - skip))
        # every input goes to the device before the first dispatch, so no
        # host-to-device copy waits on a running prefill
        pf_in = dec_in = None
        if feed:
            # bucketize the chunk width (powers of two), as the
            # reference does to bound its recompiles
            need = max(n for _, _, n in feed)
            chunk = 8
            while chunk < need:
                chunk *= 2
            chunk = min(chunk, self.ecfg.prefill_chunk)
            tokens = np.zeros((B, chunk), np.int32)
            valid = np.zeros((B, chunk), bool)
            for r, start, n in feed:
                full = r.prompt + r.generated
                seg = full[start:start + n]
                tokens[r.slot, :len(seg)] = seg
                valid[r.slot, :len(seg)] = True
            pf_in = (torch.from_numpy(tokens).to(dev),
                     torch.from_numpy(valid).to(dev))
        if decoding:
            tokens = np.zeros((B, 1), np.int32)
            active = np.zeros((B,), bool)
            budget = np.zeros((B,), np.int32)
            for r in decoding:
                tokens[r.slot, 0] = (r.generated[-1] if r.generated
                                     else (r.prompt[-1] if r.prompt else 1))
                active[r.slot] = True
                budget[r.slot] = self._row_budget(r)
            dec_in = tuple(torch.from_numpy(x).to(dev)
                           for x in (tokens, active, budget))
        pf_out = dec_out = None
        if pf_in is not None:
            _, _, tap_sum, n_new = self.model.prefill_chunk(
                pool.cache, pf_in[0], valid=pf_in[1])
            pf_out = (tap_sum, n_new)
        if dec_in is not None:
            toks, _, probs, n_emit = self.model.decode_multi(
                pool.cache, *dec_in, k=self._k)
            dec_out = (toks, probs, n_emit)

        if pf_out is not None:
            tap_sum = pf_out[0].cpu().numpy()
            n_new = pf_out[1].cpu().numpy()
            for r, start, n in feed:
                if r.tap_sum is None:
                    r.tap_sum = np.zeros(self.cfg.d_model, np.float32)
                r.tap_sum = r.tap_sum + tap_sum[r.slot]
                r.tap_cnt += int(n_new[r.slot])
                if start + n >= r.context_len - 1:
                    tap_mean = r.tap_sum / max(r.tap_cnt, 1)
                    pred = self.predictor.on_prefill(r, tap_mean)
                    r.entry.pred_remaining = pred
        emitted: dict[int, int] = {}
        if dec_out is not None:
            toks_np, probs_np, n_np = (x.cpu().numpy() for x in dec_out)
            for r in decoding:
                n = int(n_np[r.slot])
                for t in range(n):
                    r.generated.append(int(toks_np[r.slot, t]))
                    if len(r.generated) % self.ecfg.probe_interval == 0:
                        # device-side softmax posterior at the probe boundary
                        r.entry.pred_remaining = self.predictor.on_token(
                            r, probs_np[r.slot, t])
                    else:   # between probes: deterministic aging
                        r.entry.pred_remaining = max(
                            r.entry.pred_remaining - 1.0, 0.0)
                emitted[r.rid] = n
        return emitted


def run_policy(cfg: ModelConfig, policy: str, requests, *, c_limit=0.8,
               max_batch=16, mem_budget=1 << 62, mode="sim",
               predictor=None, model=None, device="cuda",
               hardware: HardwareSpec | None = None, seed=0,
               probe_interval=1, oom_mode="discard", kv_layout="contig",
               page_size=16, max_len=1024,
               prefix_cache=False, event_log=None,
               deadline_s=0.0, ttft_deadline_s=0.0,
               shed_watermark=0.0,
               admission_control=False,
               age_boost=0.0, age_delay_s=0.0,
               deadline_slack_s=0.0) -> EngineStats:
    """One-shot convenience: build an `Engine` and run a request trace.

    The requests are deep-copied and run under the given policy,
    returning the engine's `EngineStats`.
    ``predictor`` accepts either a `PredictorBase` instance or a
    strategy spec string (``"noisy-oracle:sigma=0.5"``, see
    `repro_torch.serving.predictors.make_predictor`); None keeps the
    legacy default. Pass a `repro_torch.metrics.EventLog` as
    ``event_log`` to capture the per-request event stream alongside.
    The resilience knobs (``deadline_s`` / ``ttft_deadline_s`` /
    ``shed_watermark`` / ``admission_control``) and the tail knobs
    (``age_boost`` / ``age_delay_s`` / ``deadline_slack_s``) mirror
    `EngineConfig` and default off. Real mode (``mode="real"``, either
    ``kv_layout``) runs ``model`` on ``device``: ``cuda`` unless the
    caller asks for ``cpu``.
    """
    spec = predictor if isinstance(predictor, str) else ""
    if spec:
        predictor = None
    ecfg = EngineConfig(policy=policy, c_limit=c_limit, max_batch=max_batch,
                        mem_budget=mem_budget, mode=mode, seed=seed,
                        probe_interval=probe_interval, oom_mode=oom_mode,
                        kv_layout=kv_layout, page_size=page_size,
                        max_len=max_len, prefix_cache=prefix_cache,
                        predictor=spec,
                        deadline_s=deadline_s,
                        ttft_deadline_s=ttft_deadline_s,
                        shed_watermark=shed_watermark,
                        admission_control=admission_control,
                        age_boost=age_boost,
                        age_delay_s=age_delay_s,
                        deadline_slack_s=deadline_slack_s,
                        hardware=hardware or HardwareSpec())
    import copy
    reqs = copy.deepcopy(requests)
    eng = Engine(cfg, ecfg, predictor=predictor, model=model,
                 event_log=event_log, device=device)
    return eng.run(reqs)
