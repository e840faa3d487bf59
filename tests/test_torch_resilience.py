"""Failure and overload resilience in the port against the reference.

``parse_chaos`` accepts and rejects the same specs with the same
messages. Under each chaos kind (crash, crash with recovery, straggler,
flaky submits) a 2-replica jspw ``Router`` gives the reference's dispatch
log, summary and merged event log, and the committed cells
``BENCH_resilience.json`` ``chaos.*`` are rebuilt exactly from port
modules alone, following ``benchmarks/resilience.py``. The engine paths
the router drives (``cancel`` in every state, ``crash``,
``set_slowdown``, ``backlog``, ``backlog_seconds``, ``kv_headroom``,
``cached_prefix_tokens``) read and act as the reference's in lockstep.
The reference's ``test_cancel_any_interleaving_releases_all_pages`` runs
on the port with the page-count identity checked only for bounded block
managers. Real mode, float32 ``trail-llama`` smoke on the CPU: a cancel
and a crash leave the JAX engine's tokens, and a crash returns every page
(``pkpos`` -1 once the resets are flushed).
"""

import copy
import json
from pathlib import Path

import pytest
import torch

from _hypothesis_fallback import given, settings, st
from repro import cluster as jax_cluster
from repro.cluster import faults as jax_faults
from repro.config import get_config
from repro.metrics import EventLog as JaxEventLog
from repro.serving import engine as jax_engine
from repro.serving import predictors as jax_predictors
from repro.serving import workload as jax_workload
from repro_torch import cluster
from repro_torch.cluster import faults
from repro_torch.config import get_config as port_config
from repro_torch.metrics import EventLog, check_invariants, rollup
from repro_torch.serving import engine as port_engine
from repro_torch.serving import predictors as port_predictors
from repro_torch.serving import workload as port_workload
from repro_torch.serving.costmodel import HardwareSpec
from repro_torch.serving.engine import Engine, EngineConfig
from test_torch_engine import models

ROOT = Path(__file__).resolve().parents[1]
CFG = port_config("granite-3-8b")
HW = HardwareSpec(name="compute-bound-2tf", peak_flops=2e12, hbm_bw=819e9,
                  overhead_s=2e-4)
PACKAGES = {"ref": (jax_engine, jax_cluster, jax_faults, jax_workload,
                    JaxEventLog, get_config("granite-3-8b")),
            "port": (port_engine, cluster, faults, port_workload, EventLog,
                     CFG)}
CHAOS_SPECS = {"crash": "crash:1@5", "crash_recover": "crash:1@5-20",
               "straggler": "slow:1@2-12*4", "flaky": "flaky:0@0-8%0.5"}


def workload(wl, cfg, n=40, rate=4.0, seed=0, scenario="bursty"):
    return wl.generate(wl.scenario_config(
        scenario, n_requests=n, request_rate=rate, seed=seed,
        vocab=cfg.vocab_size))


# ---------------------------------------------------------------------------
# fault schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "crash:1@30", "crash:1@30, crash:0@5-12.5, slow:1@10-20*4, "
    "flaky:0@0-10%0.25", "slow:0@1-5*0.5,slow:0@3-9*2", ",crash:2@1e3,",
    "crash:@5", "crash:1", "slow:0@5-1*2", "slow:0@1-5*-1",
    "flaky:0@0-10%1.5", "meteor:0@5", "crash:0@5-2", "crash:x@1",
    "slow:0@1-2", "crash:0@1,crash:0@2", "flaky:1@2-3%", ""])
def test_parse_chaos_equals_the_reference(spec):
    """The same schedule, or the same ValueError message."""
    def parse(mod):
        try:
            return repr(mod.parse_chaos(spec, seed=9))
        except ValueError as e:
            return f"ValueError: {e}"
    got = parse(faults)
    assert got == parse(jax_faults).replace("repro.cluster",
                                            "repro_torch.cluster")


def test_fault_schedule_queries():
    fs = faults.parse_chaos("crash:1@30, crash:0@5-12.5, slow:1@10-20*4, "
                            "flaky:0@0-10%0.25", seed=9)
    assert fs.seed == 9
    assert fs.crash_for(1) == faults.ReplicaCrash(1, 30.0)
    assert fs.crash_for(0) == faults.ReplicaCrash(0, 5.0, 12.5)
    assert fs.crash_for(2) is None
    assert fs.slow_factor(1, 15.0) == 4.0 and fs.slow_factor(1, 25.0) == 1.0
    assert fs.degraded(1, 10.0) and not fs.degraded(1, 20.0)
    assert fs.flaky_rate(0, 5.0) == pytest.approx(0.25)
    assert fs.flaky_rate(0, 10.0) == 0.0
    assert faults.ReplicaCrash(0, 1.0).recover_at == faults.NEVER
    with pytest.raises(ValueError):
        faults.SlowdownWindow(0, 5.0, 5.0)
    with pytest.raises(ValueError):
        faults.FlakySubmit(0, 0.0, 1.0, fail_rate=2.0)
    with pytest.raises(ValueError):
        cluster.Router([Engine(CFG, EngineConfig(seed=i)) for i in range(2)],
                       cluster.RouterConfig(n_replicas=2),
                       faults=faults.parse_chaos("crash:5@1"))


# ---------------------------------------------------------------------------
# chaos runs against the reference, and the committed cells
# ---------------------------------------------------------------------------

def chaos_run(who, spec, reqs_kw, policy="jspw", n=2, hardware=HW,
              max_retries=2, **engine_kw):
    """One fault-injected cluster run of one package: (dispatch log,
    summary, merged events, per-replica used pages)."""
    eng_mod, clu, flt, wl, log_cls, cfg = PACKAGES[who]
    replicas = [eng_mod.Engine(cfg, eng_mod.EngineConfig(
        policy="trail", hardware=hardware, seed=i, **engine_kw),
        event_log=log_cls()) for i in range(n)]
    router = clu.Router(replicas, clu.RouterConfig(
        n_replicas=n, policy=policy, seed=0, max_retries=max_retries),
        faults=flt.parse_chaos(spec, seed=0), event_log=log_cls())
    stats = router.run(workload(wl, cfg, **reqs_kw))
    return (router.dispatch_log, stats.summary(),
            [e.as_dict() for e in stats.event_log.events],
            [e.blocks.used_pages() if e.blocks is not None else 0
             for e in replicas])


@pytest.mark.parametrize("policy", ["jspw", "round-robin", "pow2"])
@pytest.mark.parametrize("kind", list(CHAOS_SPECS))
def test_chaos_run_equals_the_reference(kind, policy):
    reqs_kw = dict(n=50, rate=4.0)
    ref = chaos_run("ref", CHAOS_SPECS[kind], reqs_kw, policy=policy,
                    kv_layout="paged")
    got = chaos_run("port", CHAOS_SPECS[kind], reqs_kw, policy=policy,
                    kv_layout="paged")
    assert got == ref
    log, summary, _, used = got
    assert summary["finished"] == 50 and used == [0, 0]
    if kind.startswith("crash"):
        assert summary["replica_crashes"] == 1 and summary["retries"] > 0


@pytest.mark.parametrize("spec,max_retries", [
    ("crash:0@2-8", 2), ("crash:0@3,slow:1@1-5*3", 2),
    ("flaky:0@0-1e9%1.0,flaky:1@0-1e9%1.0", 1),
    ("crash:0@1,crash:1@2-30", 0)])
def test_losses_and_deferrals_equal_the_reference(spec, max_retries):
    """Exhausted retry budgets, a fleet down until a recovery and a
    contiguous fleet: the same losses, retries and events."""
    ref = chaos_run("ref", spec, dict(n=30, rate=6.0), policy="jsq",
                    max_retries=max_retries)
    got = chaos_run("port", spec, dict(n=30, rate=6.0), policy="jsq",
                    max_retries=max_retries)
    assert got == ref


@pytest.mark.parametrize("kind", list(CHAOS_SPECS))
def test_committed_chaos_cell_rebuilt_exactly(kind):
    """``BENCH_resilience.json`` ``chaos.<kind>``: 120 bursty requests at
    3 req/s on 2 paged jspw replicas under the TPU v5e point."""
    spec = CHAOS_SPECS[kind]
    log, s, events, leaks = chaos_run(
        "port", spec, dict(n=120, rate=3.0), hardware=HardwareSpec(),
        kv_layout="paged")
    merged = EventLog()
    for e in events:
        merged.emit(**e)
    check_invariants(merged)
    got = {"spec": spec, "finished": s["finished"], "goodput": s["goodput"],
           "retries": s["retries"], "lost": s["lost"],
           "replica_crashes": s["replica_crashes"],
           "p99_latency": s["p99_latency"], "makespan": s["makespan"],
           "leaked_pages": sum(leaks)}
    want = json.loads((ROOT / "BENCH_resilience.json").read_text())[
        "grid"][f"chaos.{kind}"]
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_crash_failover_rolls_up():
    stats = cluster.run_cluster(
        CFG, workload(port_workload, CFG, n=50), router_policy="jspw",
        n_replicas=2, seed=0, hardware=HW, record_events=True,
        kv_layout="paged", faults=faults.parse_chaos("crash:1@5", seed=0))
    s = stats.summary()
    assert s["replica_crashes"] == 1 and s["lost"] == 0
    assert s["finished"] == 50 and s["goodput"] == 1.0
    check_invariants(stats.event_log)
    rep = rollup(stats.event_log)
    assert rep["counters"]["replica_downs"] == 1
    assert rep["counters"]["retries"] == s["retries"] > 0
    per = stats.event_log.per_request()
    for rid in {e.rid for e in stats.event_log.events if e.kind == "retry"}:
        assert len({e.t for e in per[rid] if e.kind == "arrival"}) == 1


# ---------------------------------------------------------------------------
# the engine paths the router drives, in lockstep with the reference
# ---------------------------------------------------------------------------

def _readings(eng, probe_prompt):
    return (round(eng.now, 12), eng.queue_len(), eng.has_work(),
            eng.backlog(), eng.backlog(truncate=40.0),
            eng.backlog(include_pending=False), eng.backlog_seconds(),
            eng.backlog_seconds(truncate=40.0), eng.kv_headroom(),
            eng.cached_prefix_tokens(probe_prompt))


@pytest.mark.parametrize("layout", ["contig", "paged"])
def test_engine_paths_read_as_the_reference(layout):
    """Both engines stepped in lockstep under a straggler factor, with a
    cancel of a running, a suspended and a pending request and a crash:
    every router-facing reading, the cancel results, the drained rids and
    the event logs are equal."""
    out = {}
    for who, (eng_mod, _, _, wl, log_cls, cfg) in PACKAGES.items():
        eng = eng_mod.Engine(cfg, eng_mod.EngineConfig(
            policy="trail", seed=0, kv_layout=layout, hardware=HW,
            max_batch=4, mem_budget=1 << 27,
            prefix_cache=layout == "paged"), event_log=log_cls())
        reqs = wl.generate(wl.scenario_config(
            "shared-prefix", n_requests=16, request_rate=8.0, seed=2,
            vocab=cfg.vocab_size))
        probe = reqs[-1].prompt
        for r in reqs:
            eng.submit(r)
        trace, cancelled = [], []
        for step in range(60):
            eng.set_slowdown(3.0 if 5 <= step < 15 else 1.0)
            eng.step()
            trace.append(_readings(eng, probe))
            if step in (8, 12):
                # each package has its own ReqState: compare names
                states = {rid: r.entry.state.name for rid, r in
                          eng._pool_reqs.items() if not r.done}
                want = "RUNNING" if step == 8 else "PREEMPTED"
                rid = min((r for r, s in states.items() if s == want),
                          default=None)
                cancelled.append((rid, eng.cancel(rid) if rid is not None
                                  else None, eng.cancel(10 ** 6)))
            if step == 2:
                cancelled.append(("pending", eng.cancel(reqs[-1].rid,
                                                        "shed")))
        lost = [r.rid for r in eng.crash(eng.now + 1.0)]
        out[who] = (trace, cancelled, lost, eng.stats.summary(),
                    [e.as_dict() for e in eng.events.events],
                    eng.blocks.used_pages() if eng.blocks else 0)
    assert out["port"] == out["ref"]
    trace, cancelled, lost, summary, _, used = out["port"]
    assert lost and used == 0 and summary["cancelled"] >= 2
    assert any(c[1] is True for c in cancelled[1:])
    with pytest.raises(ValueError):
        Engine(CFG, EngineConfig(seed=0)).set_slowdown(0.0)


def test_on_token_callbacks_equal_the_reference():
    """Per-request callback streams, cancels and timeouts included."""
    out = {}
    for who, (eng_mod, _, _, wl, log_cls, cfg) in PACKAGES.items():
        eng = eng_mod.Engine(cfg, eng_mod.EngineConfig(
            policy="trail", seed=0, deadline_s=6.0), event_log=log_cls())
        seen = []
        for r in workload(wl, cfg, n=20, rate=8.0):
            eng.submit(r)
            eng.on_token(r.rid, lambda t, k, v, rid=r.rid:
                         seen.append((rid, t, k, v)))
        eng.step()
        eng.cancel(3)
        eng.cancel(19, "shed")
        while eng.has_work():
            eng.step()
        out[who] = (seen, eng._subs)
    assert out["port"] == out["ref"]
    kinds = {k for _, _, k, _ in out["port"][0]}
    assert {"first_token", "tokens", "finish", "cancel", "shed"} <= kinds


@given(st.lists(st.tuples(st.integers(0, 2), st.integers(0, 9)),
                min_size=1, max_size=60))
@settings(max_examples=25, deadline=None)
def test_cancel_any_interleaving_releases_all_pages(ops):
    """Interleaving steps with cancels, over shared prompt prefixes and a
    budget that swaps: the refcount partition holds throughout, and
    cancelling everything leaves zero used pages."""
    reqs = port_workload.generate(port_workload.WorkloadConfig(
        n_requests=10, request_rate=50.0, seed=7, vocab=CFG.vocab_size,
        split_streams=True, prefix_len=64))
    eng = Engine(CFG, EngineConfig(kv_layout="paged", prefix_cache=True,
                                   policy="trail", seed=1, max_batch=4,
                                   mem_budget=1 << 26))
    for r in reqs:
        eng.submit(r)
    rids = [r.rid for r in reqs]
    for op, k in ops:
        if op == 0:
            eng.step()
        else:
            eng.cancel(rids[k % len(rids)],
                       reason="cancel" if op == 1 else "shed")
        _check_partition(eng.blocks)
    for rid in rids:
        eng.cancel(rid)
    _check_partition(eng.blocks)
    assert eng.blocks.used_pages() == 0 and not eng.has_work()


def _check_partition(bm):
    """Refcounts equal owners; free, reusable and owned are disjoint and,
    in a bounded pool, cover it; reusable pages hold refcount 0."""
    counts = {}
    for ps in bm.pages.values():
        for p in ps:
            counts[p] = counts.get(p, 0) + 1
    for p, c in counts.items():
        assert bm.refcount[p] == c, f"page {p}: refcount != owners"
    free, reusable, used = set(bm.free), set(bm._reusable), set(counts)
    assert len(bm.free) == len(free)
    assert not (free & reusable) and not (free & used)
    assert not (reusable & used)
    if bm.bounded:
        assert len(free) + len(reusable) + len(used) == bm.num_pages
    for p in reusable:
        assert bm.refcount[p] == 0


# ---------------------------------------------------------------------------
# real mode on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.real
def test_real_mode_cancel_and_crash_equal_the_reference():
    """A paged real engine on each side: a running request cancelled after
    the third step, then the replica crashed after the sixth; the same
    tokens so far, the same drained rids, and the port's crashed pool
    holds no page (every ``pkpos`` -1 once the resets are flushed)."""
    cfg, jm, params, pcfg, tm = models("trail-llama")
    wc = dict(n_requests=8, request_rate=3000.0, seed=2, prompt_mean=8.0,
              out_median=10.0, max_out=16, split_streams=True)
    knobs = dict(policy="trail", max_batch=3, mode="real",
                 kv_layout="paged", page_size=8, max_len=64,
                 probe_interval=2, seed=0)
    engines = {
        "ref": jax_engine.Engine(
            cfg, jax_engine.EngineConfig(**knobs),
            predictor=jax_predictors.ProbePredictor(
                cfg.probe, probe_params=params["probe"],
                embed_table=params["embed"]),
            model=jm, params=params),
        "port": Engine(
            pcfg, EngineConfig(**knobs),
            predictor=port_predictors.ProbePredictor(
                pcfg.probe, probe_params=tm.probe, embed_table=tm.embed),
            model=tm, device="cpu")}
    out = {}
    for who, eng in engines.items():
        wl = jax_workload if who == "ref" else port_workload
        reqs = wl.generate(wl.WorkloadConfig(vocab=cfg.vocab_size, **wc))
        for r in reqs:
            eng.submit(r)
        cancelled = None
        for step in range(6):
            eng.step()
            if step == 2:
                running = sorted(rid for rid, r in eng._pool_reqs.items()
                                 if r.entry.state.name == "RUNNING")
                cancelled = (running[0], eng.cancel(running[0]))
        lost = [r.rid for r in eng.crash()]
        out[who] = (cancelled, lost, {r.rid: list(r.generated)
                                      for r in reqs},
                    eng.blocks.used_pages())
    assert out["port"] == out["ref"]
    cancelled, lost, tokens, used = out["port"]
    assert cancelled[1] is True and lost and used == 0
    assert any(tokens.values())
    pool = engines["port"].pool
    assert pool.slot_of == {}
    pool.flush_resets()
    for key, run in pool.cache.items():
        if key.startswith("run_"):
            for sub in run:
                assert torch.all(sub["pkpos"] == -1)
    assert torch.all(pool.cache["lengths"] == 0)
