"""granite-4.0-h-small on the port: Mamba-2 mixers (``ssm_moe`` layers) and
NoPE attention (``moe`` layers), each followed by the mixture of experts and
a shared expert, with Granite's multipliers, held on the CPU at the
benchmark configuration's smoke sizes against the benchmark's own plain
reference (``bench/models/granite-4.0-h-small.py``, loaded by path) on
seeded random weights (``bench/weights.py``), in float32.

The tolerance: both sides compute in float32 and differ only in the order
of their sums (the chunked SSD scan against the reference's per-position
recurrence, the paged kernels' blocked softmax, matmul splits), about
4e-7 of the largest logit; ``TOL`` leaves twenty times that. Each piece
that sets this model apart, left out of the port alone, reads 0.03 or more.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config import (KIND_MOE, KIND_SSM_MOE, ModelConfig,
                                get_config, get_smoke_config)
from repro_torch.kernels import ref as kref
from repro_torch.metrics import EventLog, spans
from repro_torch.models import layers
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.serving import engine as port_engine
from repro_torch.serving import workload as port_workload
from repro_torch.serving.kv_cache import (bytes_for_context,
                                          paged_bytes_for_context,
                                          ssm_state_bytes,
                                          supports_page_retention)
from repro_torch.serving.predictors import ProbePredictor

BENCH = Path(__file__).resolve().parent.parent / "bench"
NAME = "granite-4.0-h-small"
TOL = 1e-5          # of the largest reference logit (see the docstring)
SEED = 2**31 + 29
PLENS = (23, 19)    # prompts: 16 + 7 and 16 + 3 over two prefill chunks
CHUNK = 16          # the first prefill chunk: two SSD chunks of 8
STEPS = 4           # decode steps after the prompt


@pytest.fixture(scope="module")
def bench():
    """The benchmark's weights module, the model module (by path) and the
    configuration file, with its smoke model computed in float32."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    import weights
    path = BENCH / "models" / f"{NAME}.py"
    spec = importlib.util.spec_from_file_location("granite4h_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    conf = weights.load_config(BENCH, NAME)
    conf["model"] = dict(conf["model"], dtype="float32")
    return weights, mod, conf


@pytest.fixture(scope="module")
def drawn(bench):
    """(port model, the model section, the weights' views, the reference
    class) of the smoke configuration, weights drawn from ``SEED``."""
    weights, mod, conf = bench
    model, w = weights.build(conf, SEED, "cpu", smoke=True,
                             std={**weights.STD, **mod.STD})
    return model, weights.model_section(conf, smoke=True), w.views, \
        mod.Reference


def sequences():
    g = torch.Generator().manual_seed(7)
    return [torch.randint(1, 512, (n + STEPS,), generator=g).tolist()
            for n in PLENS]


def served_logits(model: Model, seqs) -> list:
    """Each row's logits at its prompt's last position and after each of
    ``STEPS`` decode steps fed the sequence's next tokens: two prefill
    chunks, then decode, through the paged cache."""
    B, ps = len(seqs), 8
    cache = model.init_cache(B, 48, kv_layout="paged", page_size=ps)
    pages = cache["block_table"].shape[1]
    for b in range(B):
        cache["block_table"][b] = 1 + b * pages + torch.arange(pages)
    width = max(PLENS) - CHUNK
    toks = torch.zeros((B, width + 1), dtype=torch.long)
    valid = torch.zeros((B, width + 1), dtype=torch.bool)
    for b, (s, n) in enumerate(zip(seqs, PLENS)):
        toks[b, :n - CHUNK] = torch.tensor(s[CHUNK:n])
        valid[b, :n - CHUNK] = True
    first = torch.tensor([s[:CHUNK] for s in seqs])
    model.prefill_chunk(cache, first)
    logits, cache, _, _ = model.prefill_chunk(cache, toks, valid=valid)
    out = [[logits[b]] for b in range(B)]
    for t in range(STEPS):
        nxt = torch.tensor([[s[n + t]] for s, n in zip(seqs, PLENS)])
        logits, cache, _, _ = model.decode_step(cache, nxt)
        for b in range(B):
            out[b].append(logits[b])
    return [torch.stack(o) for o in out]


def reference_logits(drawn, seqs) -> list:
    _, m, views, Reference = drawn
    got = Reference(m, views).run(seqs,
                                  [n - 1 for n in PLENS],
                                  [[] for _ in seqs])
    return [logits for logits, _ in got]


def error(port: list, want: list) -> float:
    """The largest gap over the largest reference logit."""
    scale = max(float(w.abs().max()) for w in want)
    return max(float((p - w).abs().max()) for p, w in zip(port, want)) / \
        scale


def test_prefill_then_decode_through_pages_matches_the_reference(drawn):
    model = drawn[0]
    cfg = model.cfg
    assert set(cfg.layer_kinds) == {KIND_SSM_MOE, KIND_MOE}
    assert cfg.ssm_chunk < CHUNK < min(PLENS)   # state crosses both
    assert (cfg.embed_multiplier, cfg.residual_multiplier,
            cfg.logit_divisor) != (1.0, 1.0, 1.0)
    assert cfg.attn_scale != cfg.head_dim ** -0.5 and cfg.shared_expert_ff
    assert not cfg.use_rope and not cfg.learned_positions
    assert "pos_embed" not in dict(model.named_parameters())
    seqs = sequences()
    assert error(served_logits(model, seqs),
                 reference_logits(drawn, seqs)) <= TOL


#: each piece of the model set back to what the port does without it
DROPPED = {"embed_multiplier": 1.0, "residual_multiplier": 1.0,
           "logit_divisor": 1.0, "attn_scale": 0.0, "shared_expert_ff": 0,
           "use_rope": True}


@pytest.mark.parametrize("field", sorted(DROPPED))
def test_each_piece_left_out_of_the_port_breaks_the_tolerance(drawn, field):
    model = drawn[0]
    cfg = dataclasses.replace(model.cfg, **{field: DROPPED[field]})
    other = Model(cfg, device="cpu")
    missing, unexpected = other.load_state_dict(model.state_dict(),
                                                strict=False)
    assert not missing
    assert all(k.rsplit(".", 1)[-1].startswith("shared_")
               for k in unexpected) and bool(unexpected) == (
        field == "shared_expert_ff")
    seqs = sequences()
    assert error(served_logits(other, seqs),
                 reference_logits(drawn, seqs)) > TOL


def test_the_ports_config_is_the_benchmarks_cut_of_it(bench):
    weights, _, conf = bench
    cut = weights.model_config(NAME, dict(conf["model"], dtype="bfloat16"))
    full = get_config(NAME)
    assert cut == dataclasses.replace(full, source="", num_layers=20,
                                      layer_kinds=full.layer_kinds[:20])
    assert [i for i, k in enumerate(full.layer_kinds) if k == KIND_MOE] == \
        [5, 15, 25, 35]
    assert round(full.param_count() / 1e9, 1) == 32.2
    assert round(cut.param_count() / 1e9, 2) == 16.31
    smoke = weights.model_config("granite-4.0-h-smoke",
                                 weights.model_section(conf, smoke=True))
    assert dataclasses.replace(smoke, dtype="bfloat16") == \
        dataclasses.replace(get_smoke_config(NAME), source="")


def test_pages_for_two_layers_beside_fixed_state_for_eighteen(bench):
    weights, _, conf = bench
    cfg = weights.model_config(NAME, dict(conf["model"], dtype="bfloat16"))
    per_token = 2 * 2 * 8 * 128 * 2          # K and V, 2 layers, bf16
    state = 4 * 128 * 64 * 128 + 4 * 3 * (8192 + 2 * 128)
    assert per_token == 8192 and ssm_state_bytes(cfg) == state == 4295680
    for ctx in (1, 100, 1024):
        assert bytes_for_context(cfg, ctx) == ctx * per_token + 18 * state
        pages = -(-ctx // 16)
        assert paged_bytes_for_context(cfg, ctx, 16) == \
            pages * 16 * per_token + 18 * state
    assert not supports_page_retention(cfg)
    model = Model(cfg, device="meta")
    cache = model.init_cache(64, 1024, kv_layout="paged", page_size=16)
    leaves = [sub for ri in range(len(model.runs))
              for sub in cache[f"run_{ri}"]]
    assert sum(s["pk"].shape[0] for s in leaves if "pk" in s) == 2
    assert sum(s["ssm_state"].shape[0] for s in leaves
               if "ssm_state" in s) == 18
    assert not any("pk" in s and "ssm_state" in s for s in leaves)


def test_a_preempted_request_is_recomputed_and_still_matches(drawn):
    """The real-mode paged engine under TRAIL on the CPU: rows fill, a
    request is preempted, its recurrent state discarded and recomputed,
    and every token served is the reference's greedy choice (a gap to the
    reference's best logit within ``TOL``)."""
    model, m, views, Reference = drawn
    cfg = model.cfg
    reqs = port_workload.generate(port_workload.WorkloadConfig(
        vocab=cfg.vocab_size, n_requests=8, request_rate=3000.0, seed=2,
        prompt_mean=10.0, out_median=12.0, max_out=24))
    ecfg = port_engine.EngineConfig(
        policy="trail", max_batch=2, c_limit=1.0, mode="real",
        kv_layout="paged", probe_interval=4, max_len=64, page_size=8,
        prefill_chunk=16,
        mem_budget=3 * paged_bytes_for_context(cfg, 24, 8))
    assert max(len(r.prompt) + r.true_out_len for r in reqs) <= 64
    log = EventLog()
    eng = port_engine.Engine(
        cfg, ecfg, predictor=ProbePredictor(cfg.probe,
                                            probe_params=model.probe,
                                            embed_table=model.embed),
        model=model, device="cpu", event_log=log)
    for r in reqs:
        eng.submit(r)
    while eng.has_work():
        eng.step()
    assert any(e.kind == "preempt" for e in log.events)
    assert eng.stats.recomputed_tokens > 0
    assert all(r.done and r.generated for r in reqs)
    got = Reference(m, views).run(
        [r.prompt + r.generated[:-1] for r in reqs],
        [len(r.prompt) - 1 for r in reqs], [[] for _ in reqs])
    scale = max(float(lg.abs().max()) for lg, _ in got)
    for r, (logits, _) in zip(reqs, got):
        pick = torch.tensor(r.generated)[:, None]
        gap = logits.max(dim=-1).values - logits.gather(1, pick)[:, 0]
        assert float(gap.max()) <= TOL * scale


def test_spans_of_the_mixers_and_the_shared_expert(drawn):
    model = drawn[0]
    seqs = sequences()
    spans.take()
    spans.set_level(spans.CLOCK)
    try:
        served_logits(model, seqs)
        clock = spans.take()
        spans.set_level(spans.DETAIL)
        served_logits(model, seqs)
        detail = spans.take()
    finally:
        spans.set_level(spans.OFF)
    n_ssm = model.cfg.layer_kinds.count(KIND_SSM_MOE)
    n_moe = model.cfg.num_layers
    # two prefill chunks; the mixers of decode steps open no engine span
    assert set(clock) == {"model.ssm_prefill"}
    assert clock["model.ssm_prefill"]["count"] == 2 * n_ssm
    assert detail["model.ssm"]["count"] == (2 + STEPS) * n_ssm
    assert detail["moe.shared"]["count"] == (2 + STEPS) * n_moe
    assert {"model.ssm", "model.ssm_prefill", "moe.shared"} <= \
        set(spans.NAMES)


# -- the defaults change nothing ---------------------------------------------
class Ops(TorchDispatchMode):
    """The name of every operation dispatched, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def without_the_new_fields(monkeypatch):
    """Put back the formulas the port had before these fields: no
    embedding or logit multiplier, plain residual sums, the MoE without a
    shared expert, scores scaled by head_dim ** -0.5."""
    def embed_tokens(cfg, table, tokens):
        h = table[tokens].to(layers.cdtype(cfg))
        if cfg.embed_scale:
            h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
        return h

    def unembed(cfg, table, h):
        return layers.softcap(h.float() @ table.float().T,
                              cfg.final_logit_softcap)

    moe_with_shared = moe_mod.moe_mlp

    def moe_mlp(cfg, p, h, live=None):
        return moe_with_shared(dataclasses.replace(cfg, shared_expert_ff=0),
                               p, h, live)

    monkeypatch.setattr(model_mod, "embed_tokens", embed_tokens)
    monkeypatch.setattr(model_mod, "unembed", unembed)
    monkeypatch.setattr(tfm, "residual", lambda cfg, h, y: h + y)
    monkeypatch.setattr(moe_mod, "moe_mlp", moe_mlp)
    monkeypatch.setattr(kref, "score_scale", lambda scale, hd: hd ** -0.5)
    monkeypatch.setattr(ModelConfig, "score_scale",
                        property(lambda self: self.head_dim ** -0.5))


def smoke_run(arch: str):
    """(logits of a prefill chunk and two decode steps, the operations
    dispatched) of ``arch``'s smoke model in bfloat16, paged."""
    model = Model(get_smoke_config(arch), device="cpu").init(3)
    seqs = [list(range(5, 5 + n + STEPS)) for n in PLENS]
    with Ops() as ops:
        got = served_logits(model, seqs)
    return got, ops.names


@pytest.mark.parametrize("arch", ["granite-3-8b", "olmoe-1b-7b"])
def test_default_fields_compute_what_the_model_did_without_them(
        arch, monkeypatch):
    cfg = get_smoke_config(arch)
    assert (cfg.embed_multiplier, cfg.residual_multiplier, cfg.logit_divisor,
            cfg.attn_scale, cfg.shared_expert_ff) == (1.0, 1.0, 1.0, 0.0, 0)
    now, now_ops = smoke_run(arch)
    with monkeypatch.context() as mp:
        without_the_new_fields(mp)
        before, before_ops = smoke_run(arch)
    assert now_ops == before_ops
    for a, b in zip(now, before):
        assert a.dtype == torch.float32 and torch.equal(a, b)
