"""The benchmark's traced run with the program's spans
(``bench/spantrace.py``, with ``bench/`` put on the path): on hand-made
profiler events, a program span's annotation on the device is no device
activity, an idle gap goes to the innermost host range open over it, the
activities a range launched are found through the correlation ids of the
runtime calls made inside it, and over the harness's labels alone the
timeline reads as ``bench/devtrace.py``'s; the span metrics by hand; and
the span run's engine stepped on the CPU at a chat cell's smoke sizes."""

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.metrics import spans

BENCH = Path(__file__).resolve().parent.parent / "bench"
MS = 1_000_000                      # nanoseconds


@pytest.fixture(scope="module")
def spantrace():
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    import spantrace
    return spantrace


class Event:
    """What the timeline reads of a profiler event; ``corr`` given, also
    its correlation id."""

    def __init__(self, name, device, start_ms, end_ms, corr=None):
        self._name, self._device = name, device
        self._start, self._dur = start_ms * MS, (end_ms - start_ms) * MS
        if corr is not None:
            self.correlation_id = lambda: corr

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._device else "DeviceType.CPU"

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur


def profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


HOST = [("bench.step", 0, 100), ("engine.step", 1, 99),
        ("engine.decode", 10, 90), ("model.decode_multi", 11, 89),
        ("model.decode_step", 12, 50), ("model.attention", 20, 40),
        ("model.decode_step", 50, 88), ("model.attention", 55, 70)]


def test_program_annotations_are_not_busy_and_gaps_go_innermost(spantrace):
    assert set(spans.NAMES) <= set(spantrace.labels())
    evs = [Event(n, False, a, b) for n, a, b in HOST]
    # the device mirrors of two program spans, over every kernel
    evs += [Event("engine.decode", True, 10.5, 95),
            Event("model.attention", True, 21, 41)]
    evs += [Event("gemm", True, 5, 20), Event("decode_kernel", True, 40, 55),
            Event("gemm", True, 70, 80)]
    tl = spantrace.SpanTimeline(profile(evs))
    assert tl.window_s == pytest.approx(0.100)
    assert tl.busy_s == pytest.approx(0.040)
    assert tl.idle_share() == pytest.approx(60.0)
    assert dict(tl.top_ops()) == pytest.approx({"gemm": 0.025,
                                                "decode_kernel": 0.015})
    gaps = dict(tl.idle_gaps(k=20))
    # 20-40 and 55-70 under the two attentions; 80-88 under the second
    # decode step, outside its attention; 88-89 decode_multi; 89-90
    # engine.decode
    assert gaps == pytest.approx({
        "model.attention": 0.035, "model.decode_step": 0.008,
        "model.decode_multi": 0.001, "engine.decode": 0.001,
        "engine.step": 0.004 + 0.009, "bench.step": 0.001 + 0.001})
    assert sum(gaps.values()) == pytest.approx(tl.window_s - tl.busy_s)
    assert tl.starts("model.decode_step") == pytest.approx([0.012, 0.050])


def test_activities_launched_inside_a_range_by_correlation(spantrace):
    evs = [Event(n, False, a, b) for n, a, b in HOST]
    evs += [Event("engine.decode", True, 10.5, 95, corr=900),
            # runtime calls: two inside engine.decode, one before it
            Event("cudaLaunchKernel", False, 30, 31, corr=7),
            Event("cudaLaunchKernelExC", False, 60, 61, corr=8),
            Event("cudaMemcpyAsync", False, 5, 6, corr=9),
            # an operator's own id, which is no runtime call
            Event("aten::mm", False, 29, 32, corr=10),
            Event("gemm", True, 32, 40, corr=7),
            Event("decode_kernel", True, 62, 70, corr=8),
            Event("Memcpy DtoD", True, 7, 8, corr=9),
            Event("fill", True, 33, 34, corr=10)]
    tl = spantrace.SpanTimeline(profile(evs))
    names, n = tl.launched_in("engine.decode")
    assert sorted(names) == ["decode_kernel", "gemm"] and n == 1
    assert tl.launched_in("engine.fetch") == ([], 0)


def test_over_the_harness_labels_it_reads_as_the_benchmarks_timeline(
        spantrace):
    import devtrace
    host = [("bench.step", 0, 100), ("engine.device_step", 5, 60),
            ("model.prefill_chunk", 6, 20), ("model.decode_multi", 20, 59),
            ("predictor.on_token", 62, 70), ("bench.step", 100, 150),
            ("sched.select_batch", 101, 104),
            ("engine.device_step", 104, 140),
            # two ranges opening together: the later one in the profile
            # is the inner one
            ("model.decode_multi", 104, 139), ("model.prefill_chunk", 104,
                                               120)]
    evs = [Event(n, False, a, b) for n, a, b in host]
    evs += [Event(n, True, a + 0.5, b) for n, a, b in host]
    evs += [Event("gemm", True, 10, 25), Event("copy", True, 58, 66),
            Event("gemm", True, 103, 111), Event("fill", True, 130, 131)]
    old = devtrace.Timeline(profile(evs))
    new = spantrace.SpanTimeline(profile(evs))
    assert new.busy_s == pytest.approx(old.busy_s)
    assert new.idle_share() == pytest.approx(old.idle_share())
    assert new.top_ops() == old.top_ops()
    assert new._segments() == old._segments()
    assert dict(new.idle_gaps(k=20)) == pytest.approx(
        dict(old.idle_gaps(k=20)))
    assert dict(new.idle_gaps())["model.prefill_chunk"] == pytest.approx(
        0.004 + 0.009)


def test_span_metrics_by_hand(spantrace):
    import harness

    def step(profiled, **ms):
        s = harness.Step(start=0.0, window=True, profiled=profiled)
        s.spans = {n.replace("_", "."): {"count": c, "total_ns": t * MS}
                   for n, (c, t) in ms.items()}
        return s

    steps = [step(False, engine_step=(1, 100), engine_decode=(1, 80),
                  engine_fetch=(2, 4), engine_prefill=(1, 10)),
             step(False, engine_step=(1, 50), engine_decode=(1, 40),
                  engine_fetch=(1, 2)),
             # a profiled step, which none of them reads
             step(True, engine_step=(1, 900), engine_decode=(1, 800)),
             step(False, engine_step=(1, 20), engine_fetch=(1, 1))]
    rec = harness.Record(setup_s=0.0, model={}, requests=[], window_s=1.0,
                         window_steps=steps)
    rec.waits = [(0.5, 9.0), (None, 3.0), (0.1, 9.0), (0.2, 9.0)]
    got = {n: read(rec) for n, _, read in spantrace.READERS}
    assert got == pytest.approx({
        "model.decode_host_ms_per_megastep": 60.0,
        "model.launches_per_megastep": None,
        "engine.fetch_wait_ms_per_step": 7 / 3,
        "engine.host_ms_per_step": (6 + 8 + 19) / 3,
        # 0.1, 0.2, 0.5, then the request never admitted at 3.0
        "sched.queue_wait_p90_s": 0.5 + 0.7 * 2.5})
    rec.window_steps, rec.waits = [], []
    assert {n: read(rec) for n, _, read in spantrace.READERS} == dict.fromkeys(
        got)


def test_a_span_run_keeps_each_steps_spans_and_the_waits(spantrace):
    """``SpanRun``'s engine on the CPU at the cell's smoke sizes, stepped
    by hand (no open-loop clock): three profiled steps (a row decodes
    every other step) between unprofiled ones, then the readers and
    checks over what it kept."""
    import harness
    import torch
    from repro_torch.serving.request import Request
    cell = harness.load_cell(BENCH.parent, "granite-chat-poisson")
    cell.mix = {**cell.mix, "max_len": 128}
    run = spantrace.SpanRun(cell, 2**31 + 11, 1.0, time.perf_counter(),
                            device="cpu", smoke=True)
    try:
        run.setup()                     # the warm-up's steps keep nothing
        assert spans._level == spans.OFF and spans.take() == {}
        eng, rng = run.eng, np.random.default_rng(0)
        run.t0, run.left_out = time.perf_counter(), 0
        reqs = [Request(rid=i, arrival=eng.now,
                        prompt=rng.integers(1, run.vocab, 12 + 5 * i).tolist(),
                        true_out_len=9, max_new_tokens=9) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        prof, steps = run._profiler(), []
        while eng.has_work():
            s = harness.Step(start=0.0, window=True,
                             profiled=len(steps) in (1, 2, 3))
            if len(steps) == 1:
                prof.start()
            run.cur = s
            with torch.profiler.record_function("bench.step"):
                eng.step()
            run.cur = None
            if len(steps) == 3:
                prof.stop()
            assert spans._level == spans.OFF
            steps.append(s)
        assert len(steps) > 4 and run.left_out == 0
        run.t_stop = time.perf_counter() - run.t0
        run.measured = [SimpleNamespace(idx=r.rid) for r in reqs]
        rec = harness.Record(setup_s=0.0, model={}, requests=[],
                             window_s=1.0, window_steps=steps,
                             timeline=spantrace.SpanTimeline(prof))
        rec.waits = run._waits()
    finally:
        run.release()
    for s in steps:
        assert s.spans["engine.step"]["count"] == 1
        detail = {n for n in s.spans if not n.startswith("engine.")}
        assert s.profiled or not detail
    assert {"model.attention", "model.mlp", "model.decode_step"} <= set(
        ).union(*(s.spans for s in steps[1:4]))
    # every request was admitted, and its wait lies within the run
    assert len(rec.waits) == 3
    assert all(w is not None and 0 <= w <= so_far for w, so_far in rec.waits)
    got = {n: read(rec) for n, _, read in spantrace.READERS}
    assert got["model.decode_host_ms_per_megastep"] > 0
    assert got["engine.host_ms_per_step"] > 0
    assert got["engine.fetch_wait_ms_per_step"] >= 0
    assert got["sched.queue_wait_p90_s"] >= 0
    assert got["model.launches_per_megastep"] == 0      # no device
    checks = run.span_checks(rec)
    assert got["engine.host_ms_per_step"] + checks["parts_ms_mean"] == \
        pytest.approx(checks["step_ms_mean"])
    # the span's stamp, moved by the offset, is where the profiler put it:
    # a wrong offset misses by decades, a loaded CPU by milliseconds
    assert len(checks["span_clock"]["residual_us"]) == 3
    assert max(abs(r) for r in checks["span_clock"]["residual_us"]) < 1e6
    assert checks["decode_kernel_launches"] == {"trace": 0, "binding": 0}
    # the spans below engine.decode name its idle time
    assert checks["idle_unnamed_in_decode"] < 0.1
    names = {n for n, _ in rec.timeline.idle_gaps(k=100)}
    assert {"model.attention", "model.mlp"} <= names
