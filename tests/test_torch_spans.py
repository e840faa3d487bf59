"""The program's host spans (``repro_torch.metrics.spans``) and the ``wall``
stamps of real-mode ``EventLog`` events: off, a span is one shared object
and reads no clock; on, it changes nothing the engine computes, its self
times add up to the step, and its names stay clear of the benchmark's own
labels and of the substrings its roofline readers look for."""

import ast
import dataclasses
import importlib.util
import time
from pathlib import Path

import pytest
import torch

from repro_torch.config import get_smoke_config
from repro_torch.kernels import build
from repro_torch.metrics import EventLog
from repro_torch.metrics import spans
from repro_torch.metrics.events import Event
from repro_torch.models.model import Model
from repro_torch.serving import engine as port_engine
from repro_torch.serving import workload as port_workload
from repro_torch.serving.kv_cache import paged_bytes_for_context
from repro_torch.serving.predictors import ProbePredictor

BENCH = Path(__file__).resolve().parent.parent / "bench"


def bench_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernels_read_by(path: Path) -> tuple:
    """The ``KERNELS`` substrings a roofline reader matches kernel names
    against."""
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign)
                and [t.id for t in node.targets] == ["KERNELS"]):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path.name} names no KERNELS")


@pytest.fixture
def level():
    """Set a span level for the test; off again, and the totals dropped,
    after it."""
    spans.take()
    yield spans.set_level
    spans.set_level(spans.OFF)
    spans.take()


def test_off_is_one_shared_object_that_reads_no_clock(level, monkeypatch):
    level(spans.OFF)

    def refuse(*a, **k):
        raise AssertionError("a switched-off span touched a clock or torch")

    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = spans.span("engine.step"), spans.detail("model.attention")
    assert a is b
    with a:
        with b:
            pass
    level(spans.CLOCK)
    assert spans.detail("model.attention") is a
    assert spans.take() == {}


def test_self_times_exclude_what_opens_inside(level):
    level(spans.DETAIL)
    with spans.span("engine.step"):
        for _ in range(2):
            with spans.span("engine.decode"):
                with spans.detail("model.decode_step"):
                    time.sleep(0.002)
        with spans.span("engine.fetch"):
            pass
    got = spans.take()
    assert spans.take() == {}
    assert {n: t["count"] for n, t in got.items()} == {
        "engine.step": 1, "engine.decode": 2, "model.decode_step": 2,
        "engine.fetch": 1}
    step, dec, inner = (got[n] for n in ("engine.step", "engine.decode",
                                         "model.decode_step"))
    assert dec["self_ns"] == dec["total_ns"] - inner["total_ns"]
    assert step["self_ns"] == step["total_ns"] - dec["total_ns"] - \
        got["engine.fetch"]["total_ns"]
    assert sum(t["self_ns"] for t in got.values()) == step["total_ns"]
    assert step["first_ns"] <= dec["first_ns"] <= inner["first_ns"]
    with pytest.raises(ValueError):
        spans.set_level(3)


def test_names_stay_clear_of_the_benchmarks_labels_and_readers():
    devtrace = bench_module(BENCH / "devtrace.py")
    assert len(set(spans.NAMES)) == len(spans.NAMES)
    assert not set(spans.NAMES) & set(devtrace.LABELS)
    assert {f"kernel.{k}" for k in build.launches} <= set(spans.NAMES)
    substrings = [s for p in sorted(BENCH.glob("metrics/*roofline*.py"))
                  for s in kernels_read_by(p)]
    assert substrings
    assert not [n for n in spans.NAMES for s in substrings if s in n]


def serve(arch: str, level: int):
    """A real-mode paged engine over ``arch``'s float32 smoke model on the
    CPU, serving a workload with preemptions at span ``level``: (tokens by
    rid, the event log, the spans each step took, the engine's stats)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = Model(cfg, device="cpu").init(0)
    reqs = port_workload.generate(port_workload.WorkloadConfig(
        vocab=cfg.vocab_size, n_requests=8, request_rate=3000.0, seed=2,
        prompt_mean=10.0, out_median=12.0, max_out=24))
    ecfg = port_engine.EngineConfig(
        policy="trail", max_batch=2, c_limit=1.0, mode="real",
        kv_layout="paged", probe_interval=4, max_len=48, page_size=8,
        prefill_chunk=16,
        mem_budget=3 * paged_bytes_for_context(cfg, 24, 8))
    log = EventLog()
    eng = port_engine.Engine(
        cfg, ecfg, predictor=ProbePredictor(cfg.probe,
                                            probe_params=model.probe,
                                            embed_table=model.embed),
        model=model, device="cpu", event_log=log)
    for r in reqs:
        eng.submit(r)
    spans.set_level(level)
    taken = []
    while eng.has_work():
        eng.step()
        taken.append(spans.take())
    stats = eng.stats.summary()
    del stats["makespan"]           # the host's clock in real mode
    return {r.rid: list(r.generated) for r in reqs}, log, taken, stats


@pytest.mark.parametrize("arch", ["granite-3-8b", "olmoe-1b-7b"])
def test_spans_change_nothing_the_engine_computes(level, arch):
    off = serve(arch, spans.OFF)
    on = serve(arch, spans.DETAIL)
    clock = serve(arch, spans.CLOCK)
    assert not any(off[2]) and all(on[2]) and all(clock[2])
    stream = [[(e.t, e.rid, e.kind, e.value) for e in run[1].events]
              for run in (off, on, clock)]
    assert stream[0] == stream[1] == stream[2]
    assert any(e.kind == "preempt" for e in off[1].events)
    assert off[0] == on[0] == clock[0] and off[3] == on[3] == clock[3]

    for taken in (on[2], clock[2]):
        for t in taken:
            step = t.pop("engine.step")
            # every span opens inside engine.step, and its self times
            # cover the step once
            assert step["count"] == 1
            assert step["self_ns"] + sum(v["self_ns"] for v in t.values()) \
                == step["total_ns"]
    for t in clock[2]:
        assert set(t) <= set(spans.ENGINE)
        # at the engine's level nothing opens inside a device call's
        # enqueue: the fetch is not inside engine.decode
        for name in ("engine.decode", "engine.prefill", "engine.fetch"):
            if name in t:
                assert t[name]["self_ns"] == t[name]["total_ns"]
    kinds = set().union(*on[2])
    assert {"engine.admit", "engine.schedule", "engine.pages", "engine.stage",
            "engine.prefill", "engine.decode", "engine.fetch",
            "engine.tokens", "model.decode_step", "model.embed",
            "model.attention", "model.mlp", "model.head",
            "model.sample"} <= kinds
    moe = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"}
    assert moe <= kinds if arch == "olmoe-1b-7b" else not moe & kinds


def test_wall_stamps_rise_within_a_request_and_sim_mode_keeps_the_dict():
    spans.set_level(spans.OFF)
    _, log, _, _ = serve("granite-3-8b", spans.OFF)
    for rid, evs in log.per_request().items():
        walls = [e.wall for e in evs]
        assert all(isinstance(w, int) for w in walls)
        assert walls == sorted(walls), rid
        assert all(e.as_dict()["wall"] == e.wall for e in evs)

    sim = EventLog()
    port_engine.run_policy(
        get_smoke_config("granite-3-8b"), "trail",
        port_workload.generate(port_workload.WorkloadConfig(
            vocab=1000, n_requests=6, request_rate=50.0, seed=1)),
        event_log=sim)
    assert len(sim) > 0
    for e in sim.events:
        assert e.wall is None
        assert e.as_dict() == {"t": e.t, "rid": e.rid, "kind": e.kind,
                               "value": e.value}
    assert Event(1.0, 3, "admit", 0.0, 17).as_dict() == {
        "t": 1.0, "rid": 3, "kind": "admit", "value": 0.0, "wall": 17}
