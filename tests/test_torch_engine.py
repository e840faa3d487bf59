"""The port's serving engine against the JAX engine.

Sim mode: ``EngineStats.summary()`` is equal between ``repro`` and
``repro_torch`` (the host state machine, scheduler, cost model and
predictors are copies). Real mode, float32 smoke configs (trail-llama,
granite, and gemma2 with its sliding-window rings), under the paged and
the contiguous layout: every request generates the same tokens and the
engines book the same preemptions, recomputed and prefilled tokens,
under a memory budget tight enough to preempt. The port's own real-mode
invariants run on the CPU.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.config import get_config, get_smoke_config
from repro.models.model import Model as JaxModel
from repro.serving import engine as jax_engine
from repro.serving import kv_cache as jax_kv
from repro.serving import predictors as jax_predictors
from repro.serving import workload as jax_workload
from repro_torch.config import get_config as port_config
from repro_torch.config import get_smoke_config as port_smoke_config
from repro_torch.models.model import Model, params_from_jax
from repro_torch.serving import engine as port_engine
from repro_torch.serving import kv_cache as port_kv
from repro_torch.serving import predictors as port_predictors
from repro_torch.serving import workload as port_workload


@pytest.mark.parametrize("kv_layout", ["contig", "paged"])
@pytest.mark.parametrize("policy", ["trail", "fcfs", "srpt"])
def test_sim_summaries_are_equal(policy, kv_layout):
    wc = dict(n_requests=40, request_rate=20.0, seed=0, vocab=49155)
    knobs = dict(mode="sim", seed=1, kv_layout=kv_layout,
                 mem_budget=8 * 2 ** 30)
    ref = jax_engine.run_policy(get_config("granite-3-8b"), policy,
                                jax_workload.generate(
                                    jax_workload.WorkloadConfig(**wc)),
                                **knobs).summary()
    got = port_engine.run_policy(port_config("granite-3-8b"), policy,
                                 port_workload.generate(
                                     port_workload.WorkloadConfig(**wc)),
                                 **knobs).summary()
    assert got == ref
    if policy != "fcfs":
        assert ref["preemptions"] > 0       # the budget really binds


@pytest.mark.parametrize("knobs,fires", [
    (dict(oom_mode="swap"), "swapped_gb"),
    (dict(kv_layout="paged", oom_mode="swap", mem_budget=2 ** 29),
     "swapped_gb"),
    (dict(kv_layout="paged", prefix_cache=True), "prefix_hit_tokens"),
    (dict(deadline_s=20.0, ttft_deadline_s=8.0), "timeouts"),
    (dict(shed_watermark=3000.0, admission_control=True), "shed"),
    (dict(age_boost=500.0, age_delay_s=2.0, deadline_slack_s=1.0,
          deadline_s=60.0), "preemptions"),
    (dict(predictor="noisy-oracle:sigma=0.5", probe_interval=4),
     "preemptions"),
])
def test_sim_summaries_are_equal_with_engine_features(knobs, fires):
    """The copied host state machine: swap, prefix sharing, deadlines,
    shedding, rank aging, deadline slack and predictor strategies (each
    case checks that its feature really acted)."""
    wc = dict(n_requests=40, request_rate=30.0, seed=5, vocab=49155,
              split_streams=True, prefix_len=64)
    run = {"mode": "sim", "seed": 2, "mem_budget": 6 * 2 ** 30, **knobs}
    ref = jax_engine.run_policy(get_config("granite-3-8b"), "trail",
                                jax_workload.generate(
                                    jax_workload.WorkloadConfig(**wc)),
                                **run).summary()
    got = port_engine.run_policy(port_config("granite-3-8b"), "trail",
                                 port_workload.generate(
                                     port_workload.WorkloadConfig(**wc)),
                                 **run).summary()
    assert got == ref
    assert ref[fires] > 0


@pytest.mark.parametrize("arch", ["granite-3-8b", "trail-llama",
                                  "qwen1.5-32b", "gemma2-9b",
                                  "mamba2-370m", "hymba-1.5b",
                                  "whisper-tiny"])
def test_byte_accounting_is_equal(arch):
    jc, pc = get_config(arch), port_config(arch)
    for ctx in (1, 17, 300, 4096):
        assert (port_kv.bytes_for_context(pc, ctx)
                == jax_kv.bytes_for_context(jc, ctx))
        assert (port_kv.paged_bytes_for_context(pc, ctx, 16)
                == jax_kv.paged_bytes_for_context(jc, ctx, 16))
    assert port_kv.page_bytes(pc, 16) == jax_kv.page_bytes(jc, 16)
    assert (port_kv.supports_page_retention(pc)
            == jax_kv.supports_page_retention(jc))


@functools.lru_cache(maxsize=None)
def models(arch="trail-llama"):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    pcfg = dataclasses.replace(port_smoke_config(arch), dtype="float32")
    # the reference's plain attention path compiles much faster on the CPU
    # than its Pallas kernels in interpret mode, and computes the same
    jm = JaxModel(cfg, use_kernels=False)
    params = jm.init(jax.random.key(0))
    tm = Model(pcfg, device="cpu")
    tm.load_state_dict(params_from_jax(
        pcfg, jax.tree_util.tree_map(np.asarray, params)))
    return cfg, jm, params, pcfg, tm


WORKLOAD = dict(n_requests=10, request_rate=3000.0, seed=2, prompt_mean=10.0,
                out_median=12.0, max_out=24)


def knobs(cfg, probe_interval, kv_layout="paged"):
    budget = (jax_kv.paged_bytes_for_context(cfg, 24, 8)
              if kv_layout == "paged" else jax_kv.bytes_for_context(cfg, 24))
    return dict(policy="trail", max_batch=2, c_limit=1.0, mode="real",
                kv_layout=kv_layout, probe_interval=probe_interval,
                max_len=48, page_size=8, prefill_chunk=16,
                mem_budget=3 * budget)


@pytest.mark.parametrize("arch,kv_layout,probe_interval", [
    pytest.param("trail-llama", "paged", 1, id="1"),
    pytest.param("trail-llama", "paged", 4, id="4"),
    pytest.param("granite-3-8b", "paged", 4, id="granite-3-8b-paged"),
    pytest.param("granite-3-8b", "contig", 4, id="granite-3-8b-contig"),
    pytest.param("gemma2-9b", "paged", 4, id="gemma2-9b-paged"),
    pytest.param("gemma2-9b", "contig", 4, id="gemma2-9b-contig"),
])
def test_real_mode_matches_jax(arch, kv_layout, probe_interval):
    cfg, jm, params, pcfg, tm = models(arch)
    jreqs = jax_workload.generate(jax_workload.WorkloadConfig(
        vocab=cfg.vocab_size, **WORKLOAD))
    preqs = port_workload.generate(port_workload.WorkloadConfig(
        vocab=cfg.vocab_size, **WORKLOAD))
    kn = knobs(cfg, probe_interval, kv_layout)
    jeng = jax_engine.Engine(
        cfg, jax_engine.EngineConfig(**kn),
        predictor=jax_predictors.ProbePredictor(
            cfg.probe, probe_params=params["probe"],
            embed_table=params["embed"]),
        model=jm, params=params)
    peng = port_engine.Engine(
        pcfg, port_engine.EngineConfig(**kn),
        predictor=port_predictors.ProbePredictor(
            pcfg.probe, probe_params=tm.probe, embed_table=tm.embed),
        model=tm, device="cpu")
    js, ps = jeng.run(jreqs), peng.run(preqs)
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == r.true_out_len for r in preqs)
    assert ps.n_preemptions == js.n_preemptions > 0
    assert ps.recomputed_tokens == js.recomputed_tokens
    assert ps.iterations == js.iterations
    assert ps.prefilled_tokens == js.prefilled_tokens


def test_real_mode_prefix_cache_matches_jax():
    """Shared prompt prefixes link cached pages (copy-on-write guarded)
    under a budget that preempts: same tokens, hits and preemptions."""
    cfg, jm, params, pcfg, tm = models()
    wl = dict(WORKLOAD, n_requests=8, seed=4, out_median=10.0, max_out=16,
              split_streams=True, prefix_len=16)
    kn = dict(policy="trail", max_batch=3, mode="real", kv_layout="paged",
              probe_interval=4, max_len=64, page_size=8, prefill_chunk=32,
              prefix_cache=True,
              mem_budget=3 * jax_kv.paged_bytes_for_context(cfg, 32, 8))
    jreqs = jax_workload.generate(jax_workload.WorkloadConfig(
        vocab=cfg.vocab_size, **wl))
    preqs = port_workload.generate(port_workload.WorkloadConfig(
        vocab=cfg.vocab_size, **wl))
    js = jax_engine.Engine(
        cfg, jax_engine.EngineConfig(**kn),
        predictor=jax_predictors.ProbePredictor(
            cfg.probe, probe_params=params["probe"],
            embed_table=params["embed"]),
        model=jm, params=params).run(jreqs)
    ps = port_engine.Engine(
        pcfg, port_engine.EngineConfig(**kn),
        predictor=port_predictors.ProbePredictor(
            pcfg.probe, probe_params=tm.probe, embed_table=tm.embed),
        model=tm, device="cpu").run(preqs)
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
    assert ps.prefix_hit_tokens == js.prefix_hit_tokens > 0
    assert ps.n_preemptions == js.n_preemptions > 0
    assert ps.prefilled_tokens == js.prefilled_tokens


def test_probe_predictor_matches_jax():
    cfg, jm, params, pcfg, tm = models()
    jp = jax_predictors.ProbePredictor(cfg.probe,
                                       probe_params=params["probe"],
                                       embed_table=params["embed"])
    pp = port_predictors.ProbePredictor(pcfg.probe, probe_params=tm.probe,
                                        embed_table=tm.embed)
    wc = dict(n_requests=3, request_rate=10.0, seed=4, vocab=cfg.vocab_size)
    jr = jax_workload.generate(jax_workload.WorkloadConfig(**wc))
    pr = port_workload.generate(port_workload.WorkloadConfig(**wc))
    rng = np.random.default_rng(0)
    for a, b in zip(jr, pr):
        assert abs(jp.initial(a) - pp.initial(b)) < 1e-4
        tap = rng.standard_normal(cfg.d_model).astype(np.float32)
        assert abs(jp.on_prefill(a, tap) - pp.on_prefill(b, tap)) < 1e-4
        probs = rng.dirichlet(np.ones(cfg.probe.num_bins))
        assert abs(jp.on_token(a, probs) - pp.on_token(b, probs)) < 1e-4
        assert np.abs(np.asarray(a.posterior) - b.posterior).max() < 1e-5


def test_stepped_real_run_keeps_lengths_equal_to_written_kv():
    """After every step each live request's device length equals the KV it
    has materialized (the invariant page export/import relies on)."""
    cfg, _, _, pcfg, tm = models()
    reqs = port_workload.generate(port_workload.WorkloadConfig(
        vocab=cfg.vocab_size, **WORKLOAD))
    eng = port_engine.Engine(
        pcfg, port_engine.EngineConfig(**knobs(cfg, 4)),
        predictor=port_predictors.ProbePredictor(
            pcfg.probe, probe_params=tm.probe, embed_table=tm.embed),
        model=tm, device="cpu")
    for r in reqs:
        eng.submit(r)
    while eng.has_work():
        eng.step()
        eng.pool.flush_resets()
        lengths = eng.pool.cache["lengths"].tolist()
        for r in reqs:
            if r.slot >= 0 and not r.done:
                assert lengths[r.slot] == getattr(r, "_kv_written", 0)
    assert eng.stats.n_preemptions > 0
    assert all(r.done and len(r.generated) == r.true_out_len for r in reqs)
    assert eng.blocks.used_pages() == 0


def test_paged_pool_export_import_and_cow_in_place():
    _, _, _, pcfg, tm = models()
    pool = port_kv.PagedSlotPool(tm, 2, 32, page_size=8, prefix_cache=True)
    run = pool.cache["run_0"][0]
    pool.assign(7)
    assert pool.ensure_pages(7, 20)
    pool.flush_resets()
    pids = pool.blocks.block_table(7)
    assert pool.cache["block_table"][0, :3].tolist() == pids
    before = run["pk"].data_ptr()
    for leaf, val in (("pk", 1.5), ("pv", -2.0)):
        run[leaf][:, pids] = val
    run["pkpos"][:, pids] = torch.arange(24, dtype=torch.int32).reshape(3, 8)
    payload = pool.export_pages(7)
    pool.release(7)
    pool.flush_resets()                     # freed pages: pkpos -> -1
    assert torch.all(run["pkpos"][:, pids] == -1)
    assert pool.import_pages(9, 20, payload)
    new = pool.blocks.block_table(9)
    assert torch.all(run["pk"][:, new] == 1.5)
    assert run["pkpos"][:, new].flatten().tolist() == list(range(24))
    # copy-on-write lands after the resets, in the same tensors
    pool.blocks.refcount[new[0]] += 1
    ops = pool.make_writable(9, 0)
    pool.flush_resets()
    (src, dst), = ops
    assert torch.equal(run["pv"][:, dst], run["pv"][:, src])
    assert run["pk"].data_ptr() == before


def test_real_mode_needs_the_paged_layout_and_the_model_device():
    """Real mode now runs on either layout (the contiguous one is the
    default); the model must live on the engine's device. paligemma's
    model builds (its vision prefix is ported), and its engine, like the
    reference's, serves text only under either layout."""
    _, _, _, pcfg, tm = models()
    eng = port_engine.Engine(pcfg, port_engine.EngineConfig(mode="real"),
                             model=tm, device="cpu")
    assert type(eng.pool) is port_kv.SlotPool
    assert "block_table" not in eng.pool.cache
    with pytest.raises(ValueError):
        port_engine.Engine(pcfg, port_engine.EngineConfig(
            mode="real", kv_layout="paged"), model=tm, device="cuda")
    vlm = Model(port_smoke_config("paligemma-3b"), device="cpu")
    for layout in ("contig", "paged"):
        eng = port_engine.Engine(vlm.cfg, port_engine.EngineConfig(
            mode="real", kv_layout=layout), model=vlm, device="cpu")
        assert eng.pool.cache["lengths"].shape[0] > 0


@pytest.mark.parametrize("kv_layout", ["contig", "paged"])
def test_slot_reset_clears_kpos(kv_layout):
    """A released slot's positions go back to -1 on the next flush (the
    contiguous rows and the rings of windowed layers, under both
    layouts), so its next request never attends over the old K/V; other
    slots keep theirs."""
    _, _, _, pcfg, tm = models("gemma2-9b")
    pool = (port_kv.SlotPool(tm, 3, 32) if kv_layout == "contig" else
            port_kv.PagedSlotPool(tm, 3, 32, page_size=8))
    for rid in (10, 11, 12):
        pool.assign(rid)
        if kv_layout == "paged":
            pool.ensure_pages(rid, 24)
    pool.flush_resets()
    tokens = torch.arange(3 * 24, dtype=torch.int32).reshape(3, 24) % 500 + 1
    tm.prefill_chunk(pool.cache, tokens)
    leaves = [sub for key, run in pool.cache.items()
              if key.startswith("run_") for sub in run if "kpos" in sub]
    assert leaves and all(torch.all(sub["kpos"][:, :, :16] >= 0)
                          for sub in leaves)
    slot = pool.release(11)
    pool.flush_resets()
    assert int(pool.cache["lengths"][slot]) == 0
    for sub in leaves:
        assert torch.all(sub["kpos"][:, slot] == -1)
        others = [s for s in range(3) if s != slot]
        assert torch.all(sub["kpos"][:, others, :16] >= 0)
