"""Prefill/decode disaggregation in the port against the reference.

Sim mode: a P=1/D=3 ``Router`` and ``run_cluster(prefill_replicas=1)``
give the reference's dispatch log, summary and merged event log; the
engine's export/import primitives hand over the same ``KVHandoff``
descriptors; the committed cell ``BENCH_disagg.json``
``scale=24.0.P=1D=3.jspw`` is rebuilt exactly from port modules alone,
following ``benchmarks/disagg.py``. The reference's
``test_handoff_any_interleaving_conserves_pages`` runs on the port with
the page-count identity checked only for bounded block managers (a
sim-mode engine's is unbounded). Real mode, float32 ``trail-llama`` smoke
on the CPU: the port's export/import moves pages bit for bit, a request
migrated mid-decode resumes the token stream of the unmigrated run (the
JAX engine's as well), and a disaggregated ``Router`` over real port
engines dispatches and generates as the reference's over real JAX
engines.
"""

import copy
import json
from pathlib import Path

import pytest
import torch

from _hypothesis_fallback import given, settings, st
from repro import cluster as jax_cluster
from repro.config import get_config
from repro.metrics import EventLog as JaxEventLog
from repro.serving import engine as jax_engine
from repro.serving import predictors as jax_predictors
from repro.serving import workload as jax_workload
from repro_torch import cluster
from repro_torch.config import get_config as port_config
from repro_torch.metrics import (EventLog, check_invariants,
                                 ideal_service_times, rollup)
from repro_torch.metrics.emitters import METRIC_ROWS, SUMMARY_COLS
from repro_torch.serving import engine as port_engine
from repro_torch.serving import predictors as port_predictors
from repro_torch.serving import workload as port_workload
from repro_torch.serving.costmodel import CostModel, HardwareSpec
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.traces import ReplayConfig, load_trace, requests_from_trace
from test_torch_engine import models

ROOT = Path(__file__).resolve().parents[1]
CFG = port_config("granite-3-8b")
HW = HardwareSpec(name="compute-bound-2tf", peak_flops=2e12, hbm_bw=819e9,
                  overhead_s=2e-4)
PACKAGES = {"ref": (jax_engine, jax_cluster, jax_workload, JaxEventLog,
                    get_config("granite-3-8b")),
            "port": (port_engine, cluster, port_workload, EventLog, CFG)}


def workload(wl, cfg, n=30, rate=4.0, seed=0, scenario="poisson"):
    return wl.generate(wl.scenario_config(
        scenario, n_requests=n, request_rate=rate, seed=seed,
        vocab=cfg.vocab_size))


def _paged_engine(seed=0, prefill_only=False, **kw):
    return Engine(CFG, EngineConfig(policy="trail", kv_layout="paged",
                                    hardware=HW, seed=seed,
                                    prefill_only=prefill_only, **kw))


def _check_partition(bm):
    """The refcount partition: every owned page's refcount equals its
    owners, and free / reusable / owned are disjoint. The three cover the
    pool only where it is bounded (a sim-mode engine's block manager is
    unbounded and allocates ids on demand)."""
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


# ---------------------------------------------------------------------------
# sim mode against the reference
# ---------------------------------------------------------------------------

def test_disagg_router_equals_the_reference():
    """P=1/D=3, jspw into the prefill pool, transfer-aware jspw into the
    decode pool: the same dispatch log (decode imports included), the same
    summary and events; every request hands off once, no page leaks."""
    out = {}
    for eng_mod, clu, wl, log_cls, cfg in PACKAGES.values():
        reqs = workload(wl, cfg, n=40, rate=4.0, scenario="bursty")
        replicas = [eng_mod.Engine(cfg, eng_mod.EngineConfig(
            policy="trail", kv_layout="paged", hardware=HW, seed=i,
            prefill_only=i < 1), event_log=log_cls()) for i in range(4)]
        router = clu.Router(replicas, clu.RouterConfig(
            n_replicas=4, policy="jspw", prefill_replicas=1))
        stats = router.run(reqs)
        out[clu] = (router.dispatch_log, stats.summary(),
                    [e.as_dict() for e in stats.event_log.events])
    assert out[cluster] == out[jax_cluster]
    summary = out[cluster][1]
    assert summary["handoffs"] == 40 and summary["handoff_pages"] > 0
    assert summary["leaked_pages"] == 0 and summary["finished"] == 40


@pytest.mark.parametrize("split", [(1, 3), (2, 2)], ids=["P1D3", "P2D2"])
def test_run_cluster_disagg_equals_the_reference(split):
    p, d = split
    out = {}
    for who, (_, clu, wl, _, cfg) in PACKAGES.items():
        stats = clu.run_cluster(
            cfg, workload(wl, cfg, n=40, rate=6.0, scenario="bursty"),
            router_policy="jspw", n_replicas=p + d, policy="trail",
            kv_layout="paged", hardware=HW, seed=0, prefill_replicas=p,
            record_events=True, backlog_unit="seconds")
        out[who] = (stats.summary(), stats.leaked_pages,
                    [e.as_dict() for e in stats.event_log.events])
    assert out["port"] == out["ref"]
    assert out["port"][0]["handoffs"] == 40


def test_export_import_descriptors_equal_the_reference():
    """A prefill-only source parks every request; each export carries the
    reference's kv_tokens, n_pages, nbytes and predicted work, and the
    destination resumes from it (prefilling at most the last prompt
    token)."""
    out = {}
    for who, (eng_mod, _, wl, _, cfg) in PACKAGES.items():
        src = eng_mod.Engine(cfg, eng_mod.EngineConfig(
            policy="trail", kv_layout="paged", hardware=HW, seed=0,
            prefill_only=True))
        dst = eng_mod.Engine(cfg, eng_mod.EngineConfig(
            policy="trail", kv_layout="paged", hardware=HW, seed=1))
        reqs = workload(wl, cfg, n=4, rate=100.0)
        for r in reqs:
            src.submit(r)
        while len(src.handoff_ready()) < len(reqs):
            src.step()
        handoffs = []
        for rid in list(src.handoff_ready()):
            h = src.export_request(rid)
            handoffs.append((rid, h.kv_tokens, h.n_pages, h.nbytes,
                             h.pred_tokens, h.src_now,
                             dst.import_request(h, t=src.now)))
        while dst.has_work():
            dst.step()
        out[who] = (handoffs, dst.stats.summary(),
                    src.blocks.used_pages(), dst.blocks.used_pages())
    assert out["port"] == out["ref"]
    handoffs, summary, src_used, dst_used = out["port"]
    assert all(kv > 0 and pages > 0 for _, kv, pages, *_ in handoffs)
    assert summary["prefilled_tokens"] <= 4 and src_used == dst_used == 0


def test_committed_disagg_cell_rebuilt_exactly():
    """``BENCH_disagg.json`` ``scale=24.0.P=1D=3.jspw``: the bundled trace
    at rate-scale 24 on 1 prefill + 3 decode replicas under the
    ``tpu-v5e-50tf`` point, rolled up from the merged event log."""
    hw = HardwareSpec(name="tpu-v5e-50tf", peak_flops=50e12)
    reqs = requests_from_trace(load_trace("sample"), ReplayConfig(
        rate_scale=24.0, seed=0, vocab=CFG.vocab_size))
    stats = cluster.run_cluster(CFG, reqs, router_policy="jspw",
                                n_replicas=4, seed=0, policy="trail",
                                kv_layout="paged", hardware=hw,
                                record_events=True, prefill_replicas=1)
    check_invariants(stats.event_log)
    report = rollup(stats.event_log, service_times=ideal_service_times(
        CostModel(CFG, hw, page_size=EngineConfig().page_size), reqs))
    row = {m: {k: report[m][k] for k in SUMMARY_COLS if k in report[m]}
           for m in METRIC_ROWS if report.get(m)}
    row["slo_attainment"] = report["slo_attainment"]
    row["finished"] = report["requests"]["finished"]
    row["preemptions"] = report["counters"]["preemptions"]
    row["handoffs"] = stats.n_handoffs
    row["handoff_pages"] = stats.handoff_pages
    row["leaked_pages"] = sum(stats.leaked_pages)
    want = json.loads((ROOT / "BENCH_disagg.json").read_text())[
        "grid"]["scale=24.0.P=1D=3.jspw"]
    assert json.dumps(row, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


# ---------------------------------------------------------------------------
# the reference's engine and topology checks, on the port
# ---------------------------------------------------------------------------

def test_prefill_only_topology_is_validated():
    with pytest.raises(ValueError):
        Engine(CFG, EngineConfig(kv_layout="contig", prefill_only=True))
    with pytest.raises(ValueError):
        _paged_engine(prefill_only=True).run([])
    with pytest.raises(ValueError):            # P >= n_replicas
        cluster.Router([_paged_engine(i, True) for i in range(2)],
                       cluster.RouterConfig(n_replicas=2, policy="jspw",
                                            prefill_replicas=2))
    with pytest.raises(ValueError):            # pool/flag mismatch
        cluster.Router([_paged_engine(i) for i in range(2)],
                       cluster.RouterConfig(n_replicas=2, policy="jspw",
                                            prefill_replicas=1))


def test_import_rejects_duplicate_rid_and_exports_mid_decode():
    src, dst = _paged_engine(seed=0), _paged_engine(seed=1)
    for r in workload(port_workload, CFG, n=3, rate=100.0):
        src.submit(r)
    target = None
    for _ in range(500):
        src.step()
        live = [r for r in src._pool_reqs.values()
                if not r.done and r.generated]
        if live:
            target = max(live, key=lambda r: len(r.generated))
            break
    assert target is not None
    h = src.export_request(target.rid)
    assert h.kv_tokens > 0
    dst.import_request(h, t=src.now)
    with pytest.raises(ValueError):
        dst.import_request(h)
    while src.has_work():
        src.step()
    done = []
    while dst.has_work():
        done.extend(dst.step().completed)
    assert [r.rid for r in done] == [target.rid]
    assert src.blocks.used_pages() == 0 and dst.blocks.used_pages() == 0


@given(st.lists(st.tuples(st.integers(0, 4), st.integers(0, 9)),
                min_size=1, max_size=60))
@settings(max_examples=25, deadline=None)
def test_handoff_any_interleaving_conserves_pages(ops):
    """Any interleaving of source and destination steps, exports and
    imports, cancels on either side and a source crash keeps both
    partitions intact, and draining both ends with zero used pages."""
    reqs = workload(port_workload, CFG, n=8, rate=50.0, seed=3)
    src = _paged_engine(seed=0, prefill_only=True, max_batch=4)
    dst = _paged_engine(seed=1, max_batch=4)
    for r in copy.deepcopy(reqs):
        src.submit(r)
    rids = [r.rid for r in reqs]
    for op, k in ops:
        if op == 0:
            src.step()
        elif op == 1:
            dst.step()
        elif op == 2:
            ready = src.handoff_ready()
            if ready:
                h = src.export_request(ready[0])
                dst.import_request(h, t=max(src.now, dst.now))
        elif op == 3:
            rid = rids[k % len(rids)]
            src.cancel(rid) or dst.cancel(rid)
        else:
            src.crash()
        _check_partition(src.blocks)
        _check_partition(dst.blocks)
    while src.has_work():
        src.step()
        for rid in list(src.handoff_ready()):
            h = src.export_request(rid)
            dst.import_request(h, t=max(src.now, dst.now))
    while dst.has_work():
        dst.step()
    _check_partition(src.blocks)
    _check_partition(dst.blocks)
    assert src.blocks.used_pages() == 0 and dst.blocks.used_pages() == 0


# ---------------------------------------------------------------------------
# real mode: KV pages moved between two pools on the CPU
# ---------------------------------------------------------------------------


MIGRATION_WORKLOAD = dict(n_requests=4, request_rate=50.0, seed=2,
                          prompt_mean=6.0, out_median=8.0, max_out=12,
                          split_streams=True)
REAL_KNOBS = dict(policy="trail", max_batch=3, mode="real",
                  kv_layout="paged", page_size=8, max_len=64)


def _port_engine(pcfg, tm, seed, **kw):
    return Engine(pcfg, EngineConfig(seed=seed, **dict(REAL_KNOBS, **kw)),
                  predictor=port_predictors.ProbePredictor(
                      pcfg.probe, probe_params=tm.probe,
                      embed_table=tm.embed),
                  model=tm, device="cpu")


def _jax_engine(cfg, jm, params, seed, **kw):
    return jax_engine.Engine(
        cfg, jax_engine.EngineConfig(seed=seed, **dict(REAL_KNOBS, **kw)),
        predictor=jax_predictors.ProbePredictor(
            cfg.probe, probe_params=params["probe"],
            embed_table=params["embed"]),
        model=jm, params=params)


def _pages(pool, pids):
    """Every paged leaf of ``pool`` at physical pages ``pids`` (CPU)."""
    idx = torch.tensor(pids, dtype=torch.long, device=pool.device)
    return {(key, j, leaf): sub[leaf].index_select(1, idx).cpu()
            for key, run in pool.cache.items() if key.startswith("run_")
            for j, sub in enumerate(run) if "pkpos" in sub
            for leaf in ("pk", "pv", "pkpos")}


def _payload(h, n=None):
    return {(key, j, leaf): pay[leaf][:, :n]
            for key, run in h.payload.items()
            for j, pay in enumerate(run) if pay is not None
            for leaf in ("pk", "pv", "pkpos")}


def _bit_equal(a, b):
    assert a.keys() == b.keys() and a
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k].view(-1).view(torch.uint8),
                           b[k].contiguous().view(-1).view(torch.uint8)), k


@pytest.mark.real
def test_real_mode_migration_token_parity():
    """Greedy decode resumed from shipped KV pages emits the unmigrated
    run's tokens, which are the JAX engine's; the payload equals the
    source pages just before export and the destination pages just after
    import, bit for bit."""
    cfg, jm, params, pcfg, tm = models("trail-llama")
    wc = dict(vocab=cfg.vocab_size, **MIGRATION_WORKLOAD)
    jreqs = jax_workload.generate(jax_workload.WorkloadConfig(**wc))
    jbase = _jax_engine(cfg, jm, params, 0)
    for r in jreqs:
        jbase.submit(r)
    while jbase.has_work():
        jbase.step()
    jax_tokens = {r.rid: list(r.generated) for r in jreqs}

    reqs = port_workload.generate(port_workload.WorkloadConfig(**wc))
    base = _port_engine(pcfg, tm, 0)
    for r in copy.deepcopy(reqs):
        base.submit(r)
    want = {}
    while base.has_work():
        for r in base.step().completed:
            want[r.rid] = list(r.generated)
    assert want == jax_tokens

    a, b = _port_engine(pcfg, tm, 0), _port_engine(pcfg, tm, 1)
    for r in copy.deepcopy(reqs):
        a.submit(r)
    target = None
    for _ in range(200):
        a.step()
        live = [r for r in a._pool_reqs.values()
                if not r.done and r.generated]
        if live:
            target = max(live, key=lambda r: len(r.generated))
            break
    assert target is not None and not target.done
    pre = len(target.generated)
    a.pool.flush_resets()
    before = _pages(a.pool, a.blocks.block_table(target.rid))
    h = a.export_request(target.rid)
    assert h.payload is not None
    _bit_equal(_payload(h), before)
    b.import_request(h, t=a.now)
    pids = b.blocks.block_table(target.rid)
    _bit_equal(_payload(h, len(pids)), _pages(b.pool, pids))
    got = {}
    for eng in (a, b):
        while eng.has_work():
            for r in eng.step().completed:
                got[r.rid] = list(r.generated)
    assert got == want
    assert len(want[target.rid]) > pre
    assert a.blocks.used_pages() == 0 and b.blocks.used_pages() == 0


@pytest.mark.real
def test_real_mode_disagg_router_equals_the_reference():
    """1 prefill + 1 decode real paged replica on one shared model: every
    request hands its pages over once, and the dispatch log and the tokens
    per rid are the reference router's over real JAX engines."""
    cfg, jm, params, pcfg, tm = models("trail-llama")
    wc = dict(vocab=cfg.vocab_size, **dict(MIGRATION_WORKLOAD,
                                           n_requests=6,
                                           request_rate=3000.0))
    jreqs = jax_workload.generate(jax_workload.WorkloadConfig(**wc))
    preqs = port_workload.generate(port_workload.WorkloadConfig(**wc))
    rc = dict(n_replicas=2, policy="jspw", prefill_replicas=1)
    jrouter = jax_cluster.Router(
        [_jax_engine(cfg, jm, params, i, prefill_only=i == 0,
                     probe_interval=4) for i in range(2)],
        jax_cluster.RouterConfig(**rc))
    prouter = cluster.Router(
        [_port_engine(pcfg, tm, i, prefill_only=i == 0, probe_interval=4)
         for i in range(2)],
        cluster.RouterConfig(**rc))
    ref, got = jrouter.run(jreqs), prouter.run(preqs)
    assert prouter.dispatch_log == jrouter.dispatch_log
    assert {r.rid: r.generated for r in preqs} == \
        {r.rid: r.generated for r in jreqs}
    s = got.summary()
    assert s["handoffs"] == 6 and s["handoff_pages"] > 0
    assert s["finished"] == ref.summary()["finished"] == 6
    assert got.leaked_pages == [0, 0]
