"""A configuration brings its own model as new files, and a traced run
carries the program's spans and launch counts to the readers.

The cells of ``BENCHMARK.json`` take ``reference.Reference``,
``weights.STD`` and ``flops`` themselves; a throwaway cell laid out in a
temporary root (never in ``BENCHMARK.json``) names a model module, a hybrid
of Mamba-2 mixers and attention (``models/mamba2-hybrid.py`` here), and is
rehearsed on the CPU through the harness with that module's reference,
scales and counts."""

import json
import shutil
from types import SimpleNamespace

import check
import flops
import harness
import pytest
import reference
import weights
from test_bench_rehearsal import CHAT, SEED, rehearse

ROOT = harness.HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
HYBRID = "mamba2-hybrid"


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_the_benchmarks_cells_take_the_standard_objects(workload):
    cell = harness.load_cell(ROOT, workload)
    assert "model_module" not in cell.conf
    assert cell.models.Reference is reference.Reference
    assert cell.models.STD is weights.STD
    assert cell.models.work is flops


TINY = {"num_layers": 2, "d_model": 8, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 2, "d_ff": 16, "vocab_size": 10}
STEP = dict(start=0.0, end=1.0, window=True, rows=4, width=8,
            prefill=[(5, 3), (0, 2)], decode=[(9, 2), (3, 1)])


class Timeline:
    steps = [(0.0, 1.0)]

    def kernel_s(self, names):
        return 1e-9


def old_formula(name, m, step):
    """The four readers as they were written before ``Record.work``, with
    ``flops``'s counts spelled out by hand."""
    q, kv = m["num_heads"] * m["head_dim"], m["num_kv_heads"] * m["head_dim"]
    L = m["num_layers"]
    if name == "kernel.decode_attn_roofline":
        nbytes = sum(L * 2 * (2 * (k + t) * kv + 2 * q)
                     for k, n in step.decode for t in range(n))
        return 100.0 * (nbytes / 3.35e12) / 1e-9
    keys = [n * st + n * (n + 1) // 2 for st, n in step.prefill]
    if name == "kernel.prefill_attn_roofline":
        f = sum(4.0 * q * k for k in keys)
        b = sum(2 * (2 * (st + n) * kv + 2 * n * q) for st, n in step.prefill)
        return 100.0 * L * max(f / 989e12, b / 3.35e12) / 1e-9
    d, ff, V = m["d_model"], m["d_ff"], m["vocab_size"]
    trunk = 2.0 * L * (2 * d * q + 2 * d * kv + 3 * d * ff)
    work = sum(n * trunk + 4.0 * q * k * L
               for (_, n), k in zip(step.prefill, keys))
    work += sum(trunk + 2.0 * V * d + 4.0 * q * (k + t) * L
                for k, n in step.decode for t in range(n))
    return 100.0 * work / (1.0 * 989e12)


READERS = ("kernel.decode_attn_roofline", "kernel.prefill_attn_roofline",
           "step_mfu.chat", "step_mfu.batch")


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_the_records_counts(name):
    """With ``flops`` they read what the old formulas read; with another
    counts namespace, what that one counts."""
    step = harness.Step(**STEP, profiled="roofline" in name)
    rec = harness.Record(setup_s=0.0, model=TINY, requests=[], window_s=1.0,
                         window_steps=[step], timeline=Timeline())
    assert rec.work is flops
    read = harness.reader(name)
    base = read(rec)
    assert base == pytest.approx(old_formula(name, TINY, step), rel=1e-12)
    doubled = SimpleNamespace(
        attn_layers=lambda m: 2 * flops.attn_layers(m),
        decode_attn_bytes=lambda m, k: 2 * flops.decode_attn_bytes(m, k),
        prefill_attn_work=flops.prefill_attn_work,
        step_flops=lambda m, p, d: 2 * flops.step_flops(m, p, d))
    rec.work = doubled
    assert read(rec) == pytest.approx(2 * base, rel=1e-12)


def test_per_layer_kinds_from_a_file_make_a_hashable_config():
    m = json.loads(json.dumps(dict(
        TINY, layer_kinds=["ssm", "attn"], family="dense", ssm_state=4,
        probe={"tap_layer": 0, "hidden": 4, "num_bins": 3, "max_len": 8})))
    cfg = weights.model_config("tiny", m)
    assert cfg.layer_kinds == ("ssm", "attn")
    assert isinstance(hash(cfg), int)
    assert weights.frozen({"a": [1, [2, {"b": [3]}]]}) == \
        {"a": (1, (2, {"b": (3,)}))}


def hybrid_root(tmp_path):
    """A checkout with one cell of its own: BENCHMARK.json, and under
    ``bench/`` the configuration (naming the model module, per-layer kinds
    in a JSON list), the module, the traffic and the limits."""
    bench = tmp_path / "bench"
    for d in ("configs", "traffic", "limits", "models"):
        (bench / d).mkdir(parents=True)
    here = harness.HERE
    shutil.copy(here / "tests" / "models" / f"{HYBRID}.py",
                bench / "models" / f"{HYBRID}.py")
    shutil.copy(here / "traffic" / "alpaca-poisson-2.8.json",
                bench / "traffic" / "alpaca-poisson-2.8.json")
    shutil.copy(here / "limits" / "granite-chat-poisson.json",
                bench / "limits" / "hybrid-chat.json")
    conf = weights.load_config(here, "granite-3-8b")
    model = dict(conf["model"], **conf["smoke"], layer_kinds=["ssm", "attn"],
                 ssm_state=16, ssm_expand=2, ssm_head_dim=32, ssm_chunk=16,
                 ssm_conv=4, ssm_groups=1)
    conf.update(name="hybrid-smoke", model_module=HYBRID, model=model,
                smoke={})
    (bench / "configs" / "hybrid-smoke.json").write_text(json.dumps(conf))
    spec = dict(SPEC, configs=[], workloads=[{
        "name": "hybrid-chat", "config": "hybrid-smoke",
        "traffic": "alpaca-poisson-2.8", "chips": 1, "why": "a rehearsal"}])
    for group in ("end_to_end", "per_layer"):
        spec[group] = [dict(m, workloads=["hybrid-chat"])
                       for m in SPEC[group]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


@pytest.fixture
def runs(monkeypatch):
    """Every ``harness.Run`` that executes, in order."""
    got = []
    execute = harness.Run.execute

    def kept(self):
        got.append(self)
        return execute(self)
    monkeypatch.setattr(harness.Run, "execute", kept)
    return got


def test_a_cell_brings_its_reference_scales_and_counts(tmp_path, runs):
    root = hybrid_root(tmp_path)
    line = harness.rehearse("hybrid-chat", SEED, 2.0, trace=True, mix=CHAT,
                            root=root)
    assert line["correct"] is True and line["attempted"] > 0
    assert line["run"]["compared"]["tokens"] > 0
    run = runs[-1]
    models = run.cell.models
    # the module's reference, a subclass with the mixer
    assert issubclass(models.Reference, reference.Reference)
    assert models.Reference is not reference.Reference
    # its scales, merged over the standard ones, drew the weights
    assert models.STD is not weights.STD
    assert set(weights.STD) < set(models.STD)
    assert {k: models.STD[k] for k in weights.STD} == weights.STD
    drawn = run.w.views["layers.0.conv_w"].float()
    assert drawn.std().item() == pytest.approx(
        models.STD["conv_w"](run.m), rel=0.1)
    # its counts, which the readers read through the record
    rec = run.rec
    assert rec.work is models.work and rec.work is not flops
    assert rec.work.attn_layers(rec.model) == 1
    wall = sum(s.wall for s in rec.steps)
    mfu = 100.0 * sum(rec.work.step_flops(rec.model, s.prefill, s.decode)
                      for s in rec.steps) / (wall * flops.PEAK_FLOPS)
    assert line["metrics"]["step_mfu.chat"]["value"] == pytest.approx(mfu)
    # the standard reference cannot run this model, and a reference that
    # leaves the mixer out reads far past the limits
    sample = run.sample()[0]
    with pytest.raises(KeyError):
        check.compare(reference.Reference, run.m, run.w.views, sample,
                      run.probes)

    class NoMixer(models.Reference):
        def _mixer(self, hn, pre):
            return hn.new_zeros(hn.shape)
    far = check.compare(NoMixer, run.m, run.w.views, sample, run.probes)
    assert far["logit_gap"] > run.cell.limits["logit_gap"]["limit"]


def test_the_control_reads_further_on_the_hybrid(tmp_path):
    import calibrate
    cell = harness.load_cell(hybrid_root(tmp_path), "hybrid-chat")
    cell.mix = {**cell.mix, **CHAT}
    run = harness.Run(cell, SEED + 1, 2.0, False, 0.0, device="cpu",
                      smoke=True)
    run.setup()
    run.serve()
    run.release()
    prog = calibrate.readings(run)
    ctl = calibrate.readings(run, quant="fp8")
    assert ctl["tokens"] == prog["tokens"] > 0
    assert ctl["logit_gap"] > prog["logit_gap"]
    assert ctl["probe_gap"] > prog["probe_gap"]


def count_launches(run):
    """Count a launch of the paged kernels at each model call, as the
    bindings do on the card (on the CPU the plain versions count none)."""
    from repro_torch.kernels import build
    for kind, key in (("prefill_chunk", "paged_decode_attention_multi"),
                      ("decode_multi", "paged_decode_attention")):
        orig = getattr(run.model, kind)

        def counted(*a, _orig=orig, _key=key, **k):
            build.launches[_key] += 1
            return _orig(*a, **k)
        setattr(run.model, kind, counted)


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_keeps_each_steps_spans_and_launches(trace, runs):
    """Traced: the engine's spans on the window's steps outside the
    profiler, none on the profiled ones; untraced: none at all. Launches
    on every window step."""
    line = rehearse("granite-chat-poisson", trace=trace,
                    fault=count_launches)
    assert line["correct"] is True
    steps = runs[-1].rec.window_steps
    assert sum(bool(s.launches) for s in steps) > len(steps) // 2
    for s in steps:         # a step without work launches nothing
        assert set(s.launches) <= {"paged_decode_attention",
                                   "paged_decode_attention_multi"}
        assert s.launches.get("paged_decode_attention", 0) == \
            (1 if s.decode else 0)
        assert s.launches.get("paged_decode_attention_multi", 0) >= \
            (1 if s.prefill else 0)
    plain = [s for s in steps if not s.profiled]
    profiled = [s for s in steps if s.profiled]
    if not trace:
        assert not profiled and not any(s.spans for s in steps)
        return
    assert profiled and not any(s.spans for s in profiled)
    for s in plain:
        assert s.spans["engine.step"]["count"] == 1
        assert all(n.startswith("engine.") or n == "model.graph_capture"
                   for n in s.spans)
    for name in ("engine.host_ms_per_step", "engine.fetch_wait_ms_per_step",
                 "model.decode_host_ms_per_megastep"):
        assert line["metrics"][name]["value"] >= 0
