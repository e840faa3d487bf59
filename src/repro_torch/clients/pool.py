"""Closed-loop client pools over an in-process engine (virtual time).

A pool of ``n_clients`` simulated users runs against one steppable
`Engine` on the engine's own clock, using the same virtual-time loop the
cluster `Router` uses: the next client action is dispatched once the
engine clock reaches it, otherwise the engine takes one megastep. Every
random draw comes from string-seeded per-client streams (the
``workload.py`` convention), so a fixed seed reproduces the run
byte-for-byte — arrival times, lengths, retries and all — which is what
lets ``benchmarks/serve_live.py`` pin its cells.

User model: think (exponential) → issue → wait for a terminal stream
event → repeat. Requests grouped into sessions draw a longer
``session_gap_s`` think time at session boundaries. A request that ends
in ``timeout`` / ``shed`` / ``cancel`` is retried with exponential
backoff while the retry budget lasts; a request that exhausts the budget
is recorded with outcome ``lost`` and the user moves on to their next
turn (so every pool issues exactly ``n_clients * requests_per_client``
logical requests regardless of outcome).
"""

from __future__ import annotations

import heapq
import random
from dataclasses import dataclass, field

from repro_torch.serving.request import Request
from repro_torch.serving.workload import (
    WorkloadConfig,
    sample_output_length,
    sample_prompt_length,
)

# a logical request ends in exactly one of these
TERMINAL_OUTCOMES = ("finish", "lost")
# terminal stream-event kinds that count against the retry budget
FAIL_KINDS = ("timeout", "shed", "cancel")


@dataclass(frozen=True)
class ClientPoolConfig:
    """Knobs for one closed-loop pool (shared by both runners).

    Attributes:
        n_clients: number of concurrent simulated users.
        requests_per_client: logical requests each user issues in total.
        think_time_s: mean exponential think time between a user's
            requests (0 = reissue immediately).
        session_len: requests per session; after each full session the
            user thinks for ``session_gap_s`` instead of
            ``think_time_s``. 0 disables session structure.
        session_gap_s: mean exponential gap between sessions.
        timeout_s: per-request completion budget, mapped onto
            ``Request.deadline_s`` (in-process) or the HTTP request
            timeout (live). 0 = no timeout.
        max_retries: attempts allowed *after* the first for a failed
            request; exhaustion records the request as ``lost``.
        retry_backoff_s: base retry backoff, doubling per attempt.
        prefix_len: tokens of a pool-shared system prompt prepended to
            every request (drawn once per pool) — the shared-prefix
            workload the prefix cache serves.
        prompt_mean: lognormal location for prompt lengths (tokens).
        prompt_sigma: lognormal sigma for prompt lengths.
        out_median: lognormal median for output lengths (tokens).
        out_sigma: lognormal sigma for output lengths.
        max_out: output-length clip (the paper's 512-token range).
        max_new_tokens: generation cap stamped on each request.
        vocab: vocabulary for random prompt-token content.
        seed: master seed; every stream derives from it by name.
        rid_base: first request id to assign (offset for multi-pool use).
    """

    n_clients: int = 8
    requests_per_client: int = 4
    think_time_s: float = 2.0
    session_len: int = 0
    session_gap_s: float = 0.0
    timeout_s: float = 0.0
    max_retries: int = 0
    retry_backoff_s: float = 1.0
    prefix_len: int = 0
    prompt_mean: float = 44.0
    prompt_sigma: float = 0.6
    out_median: float = 48.0
    out_sigma: float = 1.0
    max_out: int = 512
    max_new_tokens: int = 512
    vocab: int = 32000
    seed: int = 0
    rid_base: int = 0


@dataclass
class ClientRecord:
    """One logical request as one simulated user experienced it.

    Times are on the driving clock (engine-virtual seconds in-process;
    wall seconds scaled by ``time_scale`` for the live runner). A
    retried request keeps one record: ``t_first_issue`` anchors the
    user-perceived completion, ``t_issue`` is the last attempt.
    """

    client: int
    turn: int
    rid: int
    t_first_issue: float
    t_issue: float = 0.0
    t_first_token: float = -1.0
    t_done: float = -1.0
    tokens: int = 0
    retries: int = 0
    outcome: str = ""
    fail_kind: str = ""

    def ttft(self) -> float:
        """First-token latency of the successful attempt (seconds)."""
        return self.t_first_token - self.t_issue

    def completion(self) -> float:
        """User-perceived completion: finish minus first issue (s)."""
        return self.t_done - self.t_first_issue

    def tbt(self) -> float:
        """Mean time between tokens after the first (seconds)."""
        if self.tokens <= 1 or self.t_first_token < 0 or self.t_done < 0:
            return 0.0
        return (self.t_done - self.t_first_token) / (self.tokens - 1)


def _dist(xs: list[float]) -> dict:
    """Summarize a sample as mean/p50/p90/p99 (nearest-rank, 6 dp)."""
    if not xs:
        return {"mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
    s = sorted(xs)

    def pct(q: float) -> float:
        return s[min(len(s) - 1, int(q / 100.0 * len(s)))]

    return {"mean": round(sum(s) / len(s), 6), "p50": round(pct(50), 6),
            "p90": round(pct(90), 6), "p99": round(pct(99), 6)}


@dataclass
class PoolStats:
    """What one pool run produced: per-request records plus totals."""

    records: list[ClientRecord] = field(default_factory=list)
    failures: dict = field(default_factory=dict)
    makespan: float = 0.0

    def summary(self) -> dict:
        """Roll the records up into a JSON-ready closed-loop summary."""
        recs = self.records
        fin = [r for r in recs if r.outcome == "finish"]
        comp = [r.completion() for r in fin]
        ttfts = [r.ttft() for r in fin if r.t_first_token >= 0]
        tbts = [r.tbt() for r in fin if r.tokens > 1]
        return {
            "issued": len(recs),
            "finished": len(fin),
            "lost": sum(1 for r in recs if r.outcome == "lost"),
            "retries": sum(r.retries for r in recs),
            "failures": {k: self.failures[k] for k in sorted(self.failures)},
            "makespan_s": round(self.makespan, 6),
            "goodput_rps": (round(len(fin) / self.makespan, 6)
                            if self.makespan > 0 else 0.0),
            "completion_s": _dist(comp),
            "ttft_s": _dist(ttfts),
            "tbt_s": _dist(tbts),
        }


def pool_workload(cfg: ClientPoolConfig) -> WorkloadConfig:
    """Build the `WorkloadConfig` view of a pool's length distributions.

    Lets both runners reuse ``workload.sample_prompt_length`` /
    ``sample_output_length`` so a closed-loop pool draws lengths from
    the same clipped lognormals as the open-loop scenarios.
    """
    return WorkloadConfig(
        n_requests=0, request_rate=1.0, prompt_mean=cfg.prompt_mean,
        prompt_sigma=cfg.prompt_sigma, out_median=cfg.out_median,
        out_sigma=cfg.out_sigma, max_out=cfg.max_out, vocab=cfg.vocab,
        seed=cfg.seed)


def shared_prefix(cfg: ClientPoolConfig) -> list[int]:
    """Draw the pool's shared system-prompt tokens (empty if disabled)."""
    if cfg.prefix_len <= 0:
        return []
    rng = random.Random(f"{cfg.seed}:pool:prefix")
    return [rng.randrange(cfg.vocab) for _ in range(cfg.prefix_len)]


def client_rngs(cfg: ClientPoolConfig, c: int) -> tuple:
    """Per-client (think, lengths, content) streams, seeded by name.

    Each stream is consumed only by its own client in turn order, so the
    draw sequence — hence the whole pool — is invariant under request
    interleaving and identical between the in-process and live runners.
    """
    return (random.Random(f"{cfg.seed}:client:{c}:think"),
            random.Random(f"{cfg.seed}:client:{c}:lens"),
            random.Random(f"{cfg.seed}:client:{c}:content"))


def think_draw(cfg: ClientPoolConfig, rng: random.Random, turn: int) -> float:
    """Draw the think time before a client's ``turn``-th request.

    Session boundaries (every ``session_len`` turns, including the gap
    before turn 0 of later sessions) draw from ``session_gap_s``.
    """
    mean = cfg.think_time_s
    if (cfg.session_len > 0 and cfg.session_gap_s > 0 and turn > 0
            and turn % cfg.session_len == 0):
        mean = cfg.session_gap_s
    return rng.expovariate(1.0 / mean) if mean > 0 else 0.0


def backoff_s(cfg: ClientPoolConfig, attempt: int) -> float:
    """Exponential backoff before retry ``attempt`` (1-based)."""
    return cfg.retry_backoff_s * (2.0 ** (attempt - 1))


def run_closed_loop(engine, cfg: ClientPoolConfig) -> PoolStats:
    """Drive one engine with a closed-loop pool on its virtual clock.

    Uses `Engine.on_token` for terminal detection (no event-log
    scanning) and the router's dispatch rule: issue the next client
    action once the engine clock reaches it, otherwise megastep. The
    engine must be freshly constructed (or ``_reset_stream()``); the
    caller owns any attached `EventLog`.
    """
    stats = PoolStats()
    wc = pool_workload(cfg)
    prefix = shared_prefix(cfg)
    rngs = [client_rngs(cfg, c) for c in range(cfg.n_clients)]
    heap: list = []   # (t, seq, record) — record.rid < 0 marks a fresh turn
    seq = 0
    next_rid = cfg.rid_base

    def push(t: float, rec: ClientRecord):
        nonlocal seq
        heapq.heappush(heap, (t, seq, rec))
        seq += 1

    def schedule_turn(c: int, turn: int, t_now: float):
        if turn >= cfg.requests_per_client:
            return
        t = t_now + think_draw(cfg, rngs[c][0], turn)
        push(t, ClientRecord(client=c, turn=turn, rid=-1, t_first_issue=t))

    def on_event(t: float, kind: str, value: float, rec: ClientRecord):
        if kind == "first_token":
            rec.t_first_token = t
            return
        if kind == "tokens":
            rec.tokens += int(value)
            return
        if kind == "finish":
            rec.outcome, rec.t_done = "finish", t
            schedule_turn(rec.client, rec.turn + 1, t)
            return
        # timeout / shed / cancel: retry while the budget lasts
        stats.failures[kind] = stats.failures.get(kind, 0) + 1
        rec.fail_kind = kind
        if rec.retries < cfg.max_retries:
            rec.retries += 1
            push(t + backoff_s(cfg, rec.retries), rec)
        else:
            rec.outcome, rec.t_done = "lost", t
            schedule_turn(rec.client, rec.turn + 1, t)

    def issue(t: float, rec: ClientRecord):
        nonlocal next_rid
        c = rec.client
        if rec.rid < 0:                       # first attempt: draw the turn
            _, lens, content = rngs[c]
            p_len = sample_prompt_length(lens, wc)
            rec.tokens = 0
            rec._out_len = sample_output_length(lens, wc)
            rec._body = [content.randrange(cfg.vocab) for _ in range(p_len)]
            stats.records.append(rec)
        rec.rid, next_rid = next_rid, next_rid + 1
        rec.t_issue, rec.t_first_token, rec.tokens = t, -1.0, 0
        req = Request(rec.rid, t, prefix + rec._body,
                      max_new_tokens=cfg.max_new_tokens,
                      true_out_len=rec._out_len, tenant=f"c{c}",
                      deadline_s=cfg.timeout_s)
        engine.on_token(rec.rid,
                        lambda et, kind, v, r=rec: on_event(et, kind, v, r))
        engine.submit(req)

    for c in range(cfg.n_clients):
        schedule_turn(c, 0, 0.0)
    while heap or engine.has_work():
        if heap and (not engine.has_work() or heap[0][0] <= engine.now):
            t, _, rec = heapq.heappop(heap)
            issue(t, rec)
        else:
            engine.step()
    stats.makespan = engine.now
    return stats
