"""The port's cluster router against the reference's.

Sim mode: the same arrival stream through ``repro.cluster`` and
``repro_torch.cluster`` gives the same ``Router.dispatch_log`` and
``ClusterStats.summary()`` for every policy of ``ROUTER_POLICIES`` at 1,
2 and 4 replicas under both backlog units, and ``run_cluster`` gives the
same summary and merged event log. The committed cells
``BENCH_cluster.json`` ``poisson@0.9.R2.jspw`` and
``BENCH_prefix_cache.json`` ``hit=1.0.prefix-affinity`` are rebuilt
exactly from port modules alone, following ``benchmarks/cluster_curves.py``
and ``benchmarks/prefix_cache.py``. The router's invariants of the
reference's ``test_cluster.py`` and ``test_prefix_cache.py`` hold on the
port. Real mode, float32 ``trail-llama`` smoke on the CPU: a 2-replica
jspw ``Router`` over real port engines dispatches as the reference
``Router`` over real JAX engines does, and every request gets the same
tokens.
"""

import copy
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro import cluster as jax_cluster
from repro.config import get_config
from repro.serving import engine as jax_engine
from repro.serving import predictors as jax_predictors
from repro.serving import workload as jax_workload
from repro_torch import cluster
from repro_torch.config import get_config as port_config
from repro_torch.serving import engine as port_engine
from repro_torch.serving import predictors as port_predictors
from repro_torch.serving import workload as port_workload
from repro_torch.serving.costmodel import HardwareSpec
from repro_torch.serving.engine import Engine, EngineConfig, run_policy
from test_torch_engine import models

ROOT = Path(__file__).resolve().parents[1]
CFG = port_config("granite-3-8b")
HW = HardwareSpec(name="compute-bound-2tf", peak_flops=2e12, hbm_bw=819e9,
                  overhead_s=2e-4)


def workload(n=60, rate=2.0, seed=0, scenario="bursty", **kw):
    return port_workload.generate(port_workload.scenario_config(
        scenario, n_requests=n, request_rate=rate, seed=seed,
        vocab=CFG.vocab_size, **kw))


def both_routers(policy, n_replicas, backlog_unit, reqs_kw, engine_kw,
                 router_seed=13):
    """The same stream through the reference's Router and the port's:
    returns ((dispatch_log, summary) of each)."""
    out = []
    for pkg_engine, pkg_cluster, pkg_pred, pkg_wl, cfg in (
            (jax_engine, jax_cluster, jax_predictors, jax_workload,
             get_config("granite-3-8b")),
            (port_engine, cluster, port_predictors, port_workload, CFG)):
        reqs = pkg_wl.generate(pkg_wl.scenario_config(
            vocab=cfg.vocab_size, **reqs_kw))
        replicas = [pkg_engine.Engine(cfg, pkg_engine.EngineConfig(
            policy="trail", seed=11 + i, hardware=HW, **engine_kw))
            for i in range(n_replicas)]
        router = pkg_cluster.Router(
            replicas, pkg_cluster.RouterConfig(
                n_replicas=n_replicas, policy=policy, seed=router_seed,
                backlog_unit=backlog_unit),
            size_predictor=pkg_pred.OraclePredictor(cfg.probe, seed=99))
        stats = router.run(reqs)
        out.append((router.dispatch_log, stats.summary()))
    return out


# ---------------------------------------------------------------------------
# sim mode: the port's router is the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backlog_unit", ["tokens", "seconds"])
@pytest.mark.parametrize("n_replicas", [1, 2, 4])
@pytest.mark.parametrize("policy", cluster.ROUTER_POLICIES)
def test_router_equals_the_reference(policy, n_replicas, backlog_unit):
    """Dispatch log and summary equal, each policy, fleet size and unit
    (prefix-affinity over warm shared prefixes on paged replicas)."""
    if policy == "prefix-affinity":
        reqs_kw = dict(name="shared-prefix", n_requests=40,
                       request_rate=1.5, seed=3)
        engine_kw = dict(kv_layout="paged", prefix_cache=True)
    else:
        reqs_kw = dict(name="bursty", n_requests=40, request_rate=1.5,
                       seed=6)
        engine_kw = {}
    (ref_log, ref), (got_log, got) = both_routers(
        policy, n_replicas, backlog_unit, reqs_kw, engine_kw)
    assert got_log == ref_log
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert got["finished"] == 40
    if policy == "prefix-affinity":
        assert got["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("knobs", [
    dict(router_policy="jspw", predictor="noisy-oracle:sigma=0.5"),
    dict(router_policy="prefix-affinity", kv_layout="paged",
         prefix_cache=True, predictor="rank-only", policy="rank"),
    dict(router_policy="pow2", max_batch=4, mem_budget=6 * 2 ** 30,
         deadline_s=60.0, shed_watermark=20000.0),
], ids=["noisy-oracle", "rank-only", "pow2-budget"])
def test_run_cluster_equals_the_reference(knobs):
    """``run_cluster`` with predictor strategies (magnitude and rank-only)
    and engine knobs: the same summary and merged event log."""
    kw = dict(dict(policy="trail"), **knobs)
    runs = []
    for run, cfg, wl in ((jax_cluster.run_cluster, get_config("granite-3-8b"),
                          jax_workload),
                         (cluster.run_cluster, CFG, port_workload)):
        reqs = wl.generate(wl.scenario_config(
            "shared-prefix", n_requests=40, request_rate=1.5, seed=4,
            vocab=cfg.vocab_size))
        stats = run(cfg, reqs, n_replicas=3, seed=5, hardware=HW,
                    record_events=True, **kw)
        runs.append((stats.summary(),
                     [e.as_dict() for e in stats.event_log.events]))
    (ref, ref_events), (got, got_events) = runs
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert got_events == ref_events


def _grid_mean(summaries):
    """The averaged grid cell of ``benchmarks/cluster_curves.py``."""
    means = [d["mean_latency"] for d in summaries]
    return {"mean_latency": float(np.mean(means)),
            "p99_latency": float(np.mean([d["p99_latency"]
                                          for d in summaries])),
            "mean_ttft": float(np.mean([d["mean_ttft"] for d in summaries])),
            "finished": int(np.sum([d["finished"] for d in summaries])),
            "per_seed_mean": [float(m) for m in means]}


def test_committed_cluster_cell_rebuilt_exactly():
    """``BENCH_cluster.json`` ``poisson@0.9.R2.jspw``: 300 requests per
    seed, 2 replicas, jspw over the compute-bound point (with the
    benchmark's ``dma_bw``)."""
    hw = dataclasses.replace(HW, dma_bw=32e9)
    got = _grid_mean([cluster.run_cluster(
        CFG, workload(n=300, rate=0.9, seed=s, scenario="poisson"),
        router_policy="jspw", n_replicas=2, policy="trail", seed=5,
        max_batch=16, hardware=hw).summary() for s in (3, 11, 23)])
    want = json.loads((ROOT / "BENCH_cluster.json").read_text())[
        "grid"]["poisson@0.9.R2.jspw"]
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_committed_prefix_cache_cell_rebuilt_exactly():
    """``BENCH_prefix_cache.json`` ``hit=1.0.prefix-affinity``: the
    shared-prefix mix at hit rate 1.0, paged replicas with prefix
    caching, prefix-affinity routing."""
    hw = dataclasses.replace(HW, dma_bw=32e9)
    summaries = [cluster.run_cluster(
        CFG, workload(n=150, rate=0.9, seed=s, scenario="shared-prefix",
                      prefix_hit=1.0),
        router_policy="prefix-affinity", n_replicas=2, policy="trail",
        seed=5, max_batch=16, hardware=hw, kv_layout="paged",
        prefix_cache=True).summary() for s in (3, 11, 23)]
    means = [d["mean_latency"] for d in summaries]
    got = {"mean_latency": float(np.mean(means)),
           "p99_latency": float(np.mean([d["p99_latency"]
                                         for d in summaries])),
           "prefilled_tokens_per_req": float(np.mean(
               [d["prefilled_tokens"] / max(d["finished"], 1)
                for d in summaries])),
           "prefix_hit_tokens_per_req": float(np.mean(
               [d["prefix_hit_tokens"] / max(d["finished"], 1)
                for d in summaries])),
           "finished": int(np.sum([d["finished"] for d in summaries])),
           "per_seed_mean": [float(m) for m in means]}
    want = json.loads((ROOT / "BENCH_prefix_cache.json").read_text())[
        "grid"]["hit=1.0.prefix-affinity"]
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


# ---------------------------------------------------------------------------
# the reference's router invariants, on the port
# ---------------------------------------------------------------------------

def test_run_equals_submit_step_loop():
    reqs = workload(n=40)
    batch = run_policy(CFG, "trail", reqs, mode="sim", seed=1)
    eng = Engine(CFG, EngineConfig(policy="trail", seed=1))
    for r in sorted(copy.deepcopy(reqs), key=lambda r: r.arrival):
        eng.submit(r)
    completed = []
    while eng.has_work():
        completed.extend(eng.step().completed)
    assert len(completed) == len(reqs)
    assert eng.stats.latencies == batch.latencies
    assert eng.now == batch.sim_time


def test_single_replica_cluster_equals_run_policy():
    reqs = workload(n=50, seed=4)
    single = run_policy(CFG, "trail", reqs, mode="sim", seed=5,
                        hardware=HW).summary()
    clus = cluster.run_cluster(CFG, reqs, router_policy="round-robin",
                               n_replicas=1, policy="trail", seed=5,
                               hardware=HW).summary()
    assert clus["mean_latency"] == pytest.approx(single["mean_latency"])
    assert clus["finished"] == len(reqs)


@pytest.mark.parametrize("policy", cluster.ROUTER_POLICIES)
def test_no_replica_exceeds_max_batch(policy):
    s = cluster.run_cluster(CFG, workload(n=60, rate=8.0, seed=8),
                            router_policy=policy, n_replicas=2,
                            policy="trail", seed=9, max_batch=4,
                            hardware=HW)
    assert s.summary()["finished"] == 60
    for summ in s.replica_summaries:
        assert 0 < summ["peak_batch"] <= 4


def test_round_robin_is_cyclic_and_config_is_validated():
    reqs = workload(n=30, seed=12)
    replicas = [Engine(CFG, EngineConfig(policy="trail", seed=i,
                                         hardware=HW)) for i in range(3)]
    router = cluster.Router(replicas, cluster.RouterConfig(
        n_replicas=3, policy="round-robin", seed=0))
    router.run(copy.deepcopy(reqs))
    assert [i for _, i in router.dispatch_log] == \
        [k % 3 for k in range(len(reqs))]
    one = [Engine(CFG, EngineConfig(seed=0))]
    for rc in (cluster.RouterConfig(n_replicas=1, policy="magic"),
               cluster.RouterConfig(n_replicas=2, policy="jsq"),
               cluster.RouterConfig(n_replicas=1, backlog_unit="hours")):
        with pytest.raises(ValueError):
            cluster.Router(one, rc)


def _engine_with_jobs(out_lens, seed):
    eng = Engine(CFG, EngineConfig(policy="trail", seed=seed, hardware=HW),
                 predictor=port_predictors.OraclePredictor(
                     CFG.probe, seed=seed, bert_sigma=1e-6, flip_prob=0.0,
                     temp=1e-3))
    for r, olen in zip(workload(n=len(out_lens), rate=1e9, seed=seed),
                       out_lens):
        r.true_out_len = olen
        r.prompt = r.prompt[:8]
        eng.submit(r)
    eng.step()
    eng.step()
    return eng


def test_jspw_routes_by_live_predictions_and_truncates():
    """Untruncated jspw joins the smaller predicted backlog (jsq would
    not); with a size predictor, work longer than the arrival yields."""
    e_long = _engine_with_jobs([400], seed=1)
    e_short = _engine_with_jobs([30, 30, 30], seed=2)
    assert e_long.backlog() > e_short.backlog()
    req = workload(n=1, rate=1e9, seed=3)[0]
    jspw = cluster.Router([e_long, e_short], cluster.RouterConfig(
        n_replicas=2, policy="jspw", seed=0))
    jsq = cluster.Router([e_long, e_short], cluster.RouterConfig(
        n_replicas=2, policy="jsq", seed=0))
    assert jspw._pick(req) == 1 and jsq._pick(req) == 0
    req.true_out_len = 10
    sized = cluster.Router(
        [e_long, e_short],
        cluster.RouterConfig(n_replicas=2, policy="jspw", seed=0),
        size_predictor=port_predictors.OraclePredictor(
            CFG.probe, seed=5, bert_sigma=1e-6, flip_prob=0.0))
    assert sized._pick(req) == 0


def test_jspw_ties_break_on_headroom():
    e_full = Engine(CFG, EngineConfig(policy="trail", seed=0))
    e_free = Engine(CFG, EngineConfig(policy="trail", seed=1))
    e_full._last_mem, e_full.ecfg.mem_budget = 900, 1000
    e_free._last_mem, e_free.ecfg.mem_budget = 100, 1000
    router = cluster.Router([e_full, e_free], cluster.RouterConfig(
        n_replicas=2, policy="jspw", seed=0))
    assert router._pick(workload(n=1)[0]) == 1


def test_prefix_affinity_joins_warm_replica():
    reqs = port_workload.generate(port_workload.WorkloadConfig(
        n_requests=6, request_rate=1e9, seed=4, vocab=CFG.vocab_size,
        split_streams=True, prefix_len=64))
    warm, cold = (Engine(CFG, EngineConfig(
        policy="trail", kv_layout="paged", prefix_cache=True, seed=s,
        hardware=HW)) for s in (0, 1))
    for r in reqs[:3]:
        warm.submit(r)
    while warm.has_work():
        warm.step()
    probe = reqs[3]
    assert warm.cached_prefix_tokens(probe.prompt) >= 48
    assert cold.cached_prefix_tokens(probe.prompt) == 0
    router = cluster.Router([cold, warm], cluster.RouterConfig(
        n_replicas=2, policy="prefix-affinity", seed=0))
    assert router._pick(probe) == 1
    fresh = copy.deepcopy(probe)
    fresh.prompt = [1] * 80
    jspw = cluster.Router([cold, warm], cluster.RouterConfig(
        n_replicas=2, policy="jspw", seed=0))
    assert router._pick(fresh) == jspw._pick(fresh)


# ---------------------------------------------------------------------------
# real mode: a router over real engines, port against reference
# ---------------------------------------------------------------------------


REAL_WORKLOAD = dict(n_requests=8, request_rate=3000.0, seed=2,
                     prompt_mean=8.0, out_median=8.0, max_out=14,
                     split_streams=True)
REAL_KNOBS = dict(policy="trail", max_batch=3, mode="real",
                  kv_layout="paged", page_size=8, max_len=64,
                  probe_interval=4)


@pytest.mark.real
def test_real_mode_router_equals_the_reference():
    """2 real paged replicas on one shared model, jspw with a probe size
    predictor: the same dispatch log and the same tokens per rid; both
    pools drain to zero pages."""
    cfg, jm, params, pcfg, tm = models("trail-llama")
    jreqs = jax_workload.generate(jax_workload.WorkloadConfig(
        vocab=cfg.vocab_size, **REAL_WORKLOAD))
    preqs = port_workload.generate(port_workload.WorkloadConfig(
        vocab=pcfg.vocab_size, **REAL_WORKLOAD))

    def jax_probe():
        return jax_predictors.ProbePredictor(
            cfg.probe, probe_params=params["probe"],
            embed_table=params["embed"])

    def port_probe():
        return port_predictors.ProbePredictor(
            pcfg.probe, probe_params=tm.probe, embed_table=tm.embed)

    jrouter = jax_cluster.Router(
        [jax_engine.Engine(cfg, jax_engine.EngineConfig(seed=i, **REAL_KNOBS),
                           predictor=jax_probe(), model=jm, params=params)
         for i in range(2)],
        jax_cluster.RouterConfig(n_replicas=2, policy="jspw"),
        size_predictor=jax_probe())
    prouter = cluster.Router(
        [Engine(pcfg, EngineConfig(seed=i, **REAL_KNOBS),
                predictor=port_probe(), model=tm, device="cpu")
         for i in range(2)],
        cluster.RouterConfig(n_replicas=2, policy="jspw"),
        size_predictor=port_probe())
    ref, got = jrouter.run(jreqs), prouter.run(preqs)
    assert prouter.dispatch_log == jrouter.dispatch_log
    assert sorted(set(i for _, i in prouter.dispatch_log)) == [0, 1]
    assert {r.rid: r.generated for r in preqs} == \
        {r.rid: r.generated for r in jreqs}
    assert all(r.done and len(r.generated) == r.true_out_len
               for r in preqs)
    assert got.summary()["finished"] == ref.summary()["finished"] == 8
    assert got.leaked_pages == [0, 0]
