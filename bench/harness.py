"""One run of one cell: set-up, the open-loop window, the check, the line.

The window drives ``repro_torch.serving.engine.Engine`` in real mode as
``python -m repro_torch.launch.serve --real`` builds it (the configuration
file's ``engine`` settings, the probe predictor over the model's own
probe). The harness owns the wall clock: it submits each request when it
falls due on the schedule (its ``arrival`` is the engine's clock at that
moment, so the next ``step()`` admits it), loops on ``step()``, and stamps
``time.perf_counter()`` when the ``step()`` that emitted a request's first
token, or its last, returns. Every time runs from the request's due time.

The harness sees the program only through wrappers it puts around the
engine's ``step`` (the launches each kernel binding counted,
``kernels.build.launches``, on every step; with ``--trace 1`` the program's
own spans at the engine's level, ``metrics.spans.CLOCK``, on the window's
steps outside the profiler), its ``_device_step`` (the work of each step:
rows prefilled, tokens emitted), the predictor's three hooks (their host
time, and the probe posteriors the predictor receives, which the check
compares), and with ``--trace 1`` around ``Model.prefill_chunk`` and
``Model.decode_multi`` (CUDA events), the module global ``select_batch`` of
the engine (host time), and ``torch.profiler`` over a few steps in the
middle of the window. An untraced run switches no span on.

A configuration file may name a model module (``"model_module": NAME``:
``models/NAME.py`` beside ``configs/``) for an architecture that
``reference.Reference``, ``weights.STD`` and ``flops`` do not describe; see
`Models`.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

import check
import devtrace
import flops
import gen
import reference
import weights

HERE = Path(__file__).resolve().parent
#: top-level modules that no run may load: JAX and the JAX package
BLOCKED = ("jax", "jaxlib", "flax", "repro")
#: steps the profiler records in a traced run
TRACE_STEPS = 6


def blocked_modules() -> list[str]:
    """Blocked top-level names present in ``sys.modules``, compared whole."""
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)}
                  & set(BLOCKED))


def load_module(path: Path, prefix: str):
    """The Python file ``path``, loaded as a module of its own."""
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass(frozen=True)
class Models:
    """What a configuration's model is checked and counted with: the plain
    reference (``Reference``, constructed as ``Reference(m, views,
    quant=None)``, with ``run(seqs, logits_from, tap_at)``), the standard
    deviation of each leaf (``STD``, by the last part of its name, as
    ``weights.STD``), and the operation and byte counts of its work
    (``work``, with ``flops``'s functions)."""

    Reference: type = reference.Reference
    STD: dict = field(default_factory=lambda: weights.STD)
    work: object = flops


def load_models(bench: Path, conf: dict) -> Models:
    """The configuration's `Models`: those of ``models/<model_module>.py``
    under ``bench`` where the file names one, each of ``Reference``,
    ``STD`` (merged over ``weights.STD``) and ``work`` that it exports;
    else ``reference.Reference``, ``weights.STD`` and ``flops`` themselves.
    """
    name = conf.get("model_module")
    if name is None:
        return Models()
    mod = load_module(bench / "models" / f"{name}.py", "bench_model_")
    return Models(Reference=getattr(mod, "Reference", reference.Reference),
                  STD={**weights.STD, **getattr(mod, "STD", {})},
                  work=getattr(mod, "work", flops))


@dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    conf: dict
    mix: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list
    models: Models = field(default_factory=Models)


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` and its files, all
    under ``root/bench``: ``configs/``, ``traffic/``, ``limits/`` and the
    configuration's model module in ``models/``."""
    bench = root / "bench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    w = cells[workload]

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    conf = weights.load_config(bench, w["config"])
    return Cell(
        name=workload,
        conf=conf,
        mix=json.loads((bench / "traffic" / f"{w['traffic']}.json")
                       .read_text()),
        limits=json.loads((bench / "limits" / f"{workload}.json")
                          .read_text()),
        chips=w["chips"],
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)],
        models=load_models(bench, conf))


def metric_module(name: str):
    """The module ``metrics/<name>.py``."""
    return load_module(HERE / "metrics" / f"{name}.py", "metric_")


def reader(name: str):
    """The ``read(rec)`` function of ``metrics/<name>.py``."""
    return metric_module(name).read


@dataclass
class Step:
    """What one ``step()`` that ran did, on the schedule's clock."""

    start: float
    end: float = 0.0
    window: bool = False
    profiled: bool = False
    select_s: float = 0.0
    predictor_s: float = 0.0
    rows: int = 0                     # rows every device call computes
    width: int = 0                    # prefill chunk positions a row
    prefill: list = field(default_factory=list)   # (start, n) a row fed
    decode: list = field(default_factory=list)    # (keys, n emitted) a row
    first_prompt: int = 0             # prompt tokens prefilled first time
    emitted: int = 0
    recomputed: int = 0
    in_system: int = 0                # submitted, not finished, at start
    events: list = field(default_factory=list)    # (kind, start, end)
    prefill_ms: float | None = None
    decode_ms: float | None = None
    spans: dict = field(default_factory=dict)     # spans.take() after it
    launches: dict = field(default_factory=dict)  # per binding, if any

    @property
    def wall(self) -> float:
        """Host seconds the step took."""
        return self.end - self.start


@dataclass
class Record:
    """What the metric readers read."""

    setup_s: float
    model: dict
    requests: list            # measured: (ttft or None, latency or None,
                              # waited when the run stopped)
    window_s: float           # window opening to the end of its last step
    window_steps: list        # every step that started in the window
    timeline: object = None   # devtrace.Timeline of the profiled steps
    work: object = flops      # the model's counts (Models.work)

    @property
    def steps(self) -> list:
        """Window steps outside the profiler (spans and rates)."""
        return [s for s in self.window_steps if not s.profiled]

    @property
    def traced(self) -> list:
        """The profiled steps."""
        return [s for s in self.window_steps if s.profiled]


class Run:
    """One run of a cell (see the module docstring)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 t_start: float, device: str = "cuda", smoke: bool = False,
                 fault=None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.t_start = trace, t_start
        self.device, self.smoke, self.fault = device, smoke, fault
        self.cuda = torch.device(device).type == "cuda"
        self.mix = cell.mix
        self.cur: Step | None = None
        self.eng = self.prof = None
        self.steps: list[Step] = []
        self.rec: Record | None = None
        self.probes: dict[int, list] = {}
        self.hw: dict[int, int] = {}          # prompt high-water marks
        self._restore = []

    # -- set-up ---------------------------------------------------------
    def setup(self):
        """Weights, model, engine, kernels and the cell's shapes warmed."""
        self.model, self.w = weights.build(self.cell.conf, self.seed,
                                           self.device, self.smoke,
                                           self.cell.models.STD)
        self.m = weights.model_section(self.cell.conf, self.smoke)
        self.vocab = self.m["vocab_size"]
        self.new_engine()
        self._warm()
        gc.collect()
        gc.freeze()
        self._sync()
        self.setup_s = time.perf_counter() - self.t_start

    def new_engine(self):
        """A fresh engine over the model, with the harness's wrappers (and
        the fault, if any) in place."""
        from repro_torch.serving import engine as eng_mod
        from repro_torch.serving.predictors import ProbePredictor
        self.release()
        ecfg = eng_mod.EngineConfig(**self.cell.conf["engine"],
                                    max_len=self.mix["max_len"])
        pred = ProbePredictor(self.model.cfg.probe,
                              probe_params=self.model.probe,
                              embed_table=self.model.embed)
        self.eng = eng_mod.Engine(self.model.cfg, ecfg, predictor=pred,
                                  model=self.model, device=self.device)
        self._wrap(eng_mod, pred)
        if self.fault is not None:
            self.fault(self)

    def span_level(self, s: Step | None) -> int:
        """The level of the program's spans over the step ``s`` (None:
        a step outside the schedule, such as the warm-up's): the engine's
        on a traced run's window steps outside the profiler, else off."""
        from repro_torch.metrics import spans
        if self.trace and s is not None and s.window and not s.profiled:
            return spans.CLOCK
        return spans.OFF

    def _wrap(self, eng_mod, pred):
        from repro_torch.kernels import build
        from repro_torch.metrics import spans
        rf = (torch.profiler.record_function if self.trace
              else lambda name: contextlib.nullcontext())
        eng = self.eng
        step = eng.step

        def stepped():
            s = self.cur
            level = self.span_level(s)
            before = dict(build.launches)
            if level:
                spans.take()
                spans.set_level(level)
            try:
                return step()
            finally:
                if level:
                    spans.set_level(spans.OFF)
                    got = spans.take()
                if s is not None:
                    if level:
                        s.spans = got
                    s.launches = {k: n - before[k] for k, n in
                                  build.launches.items() if n != before[k]}

        eng.step = stepped
        dstep = eng._device_step
        chunk_cap = eng.ecfg.prefill_chunk

        def device_step(pf_plan, decoding):
            s = self.cur
            if s is None:
                return dstep(pf_plan, decoding)
            feed = []
            for r, take in pf_plan:     # the rows the device call feeds
                done = r.entry.prefill_done
                skip = min(max(getattr(r, "_kv_written", 0) - done, 0), take)
                if take > skip:
                    feed.append((r, done + skip, take - skip))
            s.rows = eng.pool.n_slots
            if feed:
                need, width = max(n for _, _, n in feed), 8
                while width < need:
                    width *= 2
                s.width = min(width, chunk_cap)
                s.prefill = [(st, n) for _, st, n in feed]
                for r, st, n in feed:
                    top = len(r.prompt) - 1     # decode takes the last one
                    hw = self.hw.get(r.rid, 0)
                    s.first_prompt += max(0, min(st + n, top) - max(st, hw))
                    self.hw[r.rid] = max(hw, min(st + n, top))
            keys = [(r, r.context_len) for r in decoding]
            with rf("engine.device_step"):
                out = dstep(pf_plan, decoding)
            s.decode = [(k, out.get(r.rid, 0)) for r, k in keys]
            s.emitted = sum(n for _, n in s.decode)
            # every decoding row has a budget of at least one token
            self.left_out += sum(1 for _, n in s.decode if n == 0)
            return out

        eng._device_step = device_step

        def hook(name):
            orig = getattr(pred, name)

            def timed(req, *a):
                t = time.perf_counter()
                with rf("predictor." + name):
                    out = orig(req, *a)
                if self.cur is not None:
                    self.cur.predictor_s += time.perf_counter() - t
                if name == "on_token":
                    # the probe read the token before the one just served
                    pos = len(req.prompt) + len(req.generated) - 2
                    self.probes.setdefault(req.rid, []).append(
                        (pos, np.array(a[0], dtype=np.float32)))
                return out
            setattr(pred, name, timed)

        for name in ("initial", "on_prefill", "on_token"):
            hook(name)
        if not self.trace:
            return
        sel = eng_mod.select_batch

        def select(*a, **k):
            t = time.perf_counter()
            with rf("sched.select_batch"):
                out = sel(*a, **k)
            if self.cur is not None:
                self.cur.select_s += time.perf_counter() - t
            return out

        eng_mod.select_batch = select
        self._restore.append(lambda: setattr(eng_mod, "select_batch", sel))
        for kind in ("prefill_chunk", "decode_multi"):
            if kind not in self.model.__dict__:
                self._event_wrap(kind, rf)

    def _event_wrap(self, kind: str, rf):
        orig = getattr(self.model, kind)

        def timed(*a, **k):
            s = self.cur
            if s is None or not self.cuda:
                with rf("model." + kind):
                    return orig(*a, **k)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            with rf("model." + kind):
                out = orig(*a, **k)
            e1.record()
            s.events.append((kind, e0, e1))
            return out
        setattr(self.model, kind, timed)

    def _warm(self):
        """Serve one request per prefill chunk width (8 up to the chunk
        budget), one after another, each into the decode megastep: every
        shape the cell's traffic uses, built and tuned before the window."""
        from repro_torch.serving.request import Request
        eng = self.eng
        cap, max_len = eng.ecfg.prefill_chunk, eng.ecfg.max_len
        k = eng.ecfg.probe_interval
        rng = random.Random(f"{self.seed}:warm")
        width, rid = 8, -1
        prof = None
        while width <= cap:
            plen = min(width + 1, max_len - 2 * k)
            req = Request(rid=rid, arrival=eng.now,
                          prompt=[rng.randrange(1, self.vocab)
                                  for _ in range(plen)],
                          true_out_len=k + 1, max_new_tokens=k + 1)
            eng.submit(req)
            if self.trace and width == cap:
                # the profiler's first start is slow: pay it here
                prof = self._profiler()
                prof.start()
            while not req.done:
                eng.step()
            width, rid = width * 2, rid - 1
        if prof is not None:
            prof.stop()

    def _profiler(self):
        act = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            act.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=act)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    # -- the window -----------------------------------------------------
    def serve(self):
        """Submit on the schedule and step until the run's end: once every
        measured request has finished (open loop), or the finished ones
        hold the tokens the check samples (a batch, whose requests are
        all measured and mostly still queued when the window closes), or
        the drain limit has passed. Only steps that start in the window
        count towards the metrics."""
        from repro_torch.serving.request import Request
        mix, eng = self.mix, self.eng
        items = gen.schedule(mix, self.seed, self.seconds, self.vocab)
        spans = gen.phase_spans(mix, self.seconds)
        w0, w1 = spans["window"]
        burst = mix["arrival"] == "burst"
        stop_by = w1 + mix["drain_s"]
        want = mix["sample"]["tokens"]
        self.items = items
        self.steps, self.probes, self.hw = [], {}, {}
        self.left_out = 0
        self.measured = [it for it in items if it.measured]
        n_meas = len(self.measured)
        self.reqs, self.first, self.fin = {}, {}, {}
        self.late: list[float] = []
        emitted_first: list[int] = []
        finished: list[int] = []
        mid = w0 + 0.5 * (w1 - w0)
        prof, n_prof = None, 0
        meas_done = in_system = nxt = done_tokens = 0
        max_new = mix["output"]["max"]

        def on_token(rid):
            def cb(t, kind, value):
                if kind == "first_token":
                    emitted_first.append(rid)
                elif kind == "finish":
                    finished.append(rid)
            return cb

        t0 = self.t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            while nxt < len(items) and items[nxt].due <= now:
                it = items[nxt]
                req = Request(rid=it.idx, arrival=eng.now, prompt=it.prompt,
                              true_out_len=it.out_len,
                              max_new_tokens=max_new)
                eng.on_token(it.idx, on_token(it.idx))
                eng.submit(req)
                self.reqs[it.idx] = req
                self.late.append(time.perf_counter() - t0 - it.due)
                in_system += 1
                nxt += 1
            if now >= stop_by or (now >= w1 and (
                    meas_done == n_meas or burst and done_tokens >= want)):
                break
            if in_system == 0:
                if nxt >= len(items):
                    break
                time.sleep(max(0.0, items[nxt].due -
                               (time.perf_counter() - t0)))
                continue
            s = Step(start=now, window=w0 <= now < w1)
            if (self.trace and s.window and n_prof < TRACE_STEPS
                    and now >= mid):
                if prof is None:
                    prof = self._profiler()
                    prof.start()
                s.profiled = True
                n_prof += 1
            rc0 = eng.stats.recomputed_tokens
            self.cur = s
            with (torch.profiler.record_function("bench.step")
                  if s.profiled else contextlib.nullcontext()):
                res = eng.step()
            self.cur = None
            if s.profiled and n_prof == TRACE_STEPS:
                self._sync()
                prof.stop()
            s.end = time.perf_counter() - t0
            s.recomputed = eng.stats.recomputed_tokens - rc0
            s.in_system = in_system
            for rid in emitted_first:
                self.first[rid] = s.end
            for rid in finished:
                self.fin[rid] = s.end
                done_tokens += len(self.reqs[rid].generated)
                if self.items[rid].measured:
                    meas_done += 1
            in_system -= len(finished)
            emitted_first.clear()
            finished.clear()
            if res.ran:
                self.steps.append(s)
        self.t_stop = time.perf_counter() - t0
        if prof is not None and n_prof < TRACE_STEPS:
            self._sync()
            prof.stop()
        self.prof = prof
        self._sync()

    # -- after the window -------------------------------------------------
    def record(self) -> Record:
        """The run's record (kept as ``rec``), with the CUDA event spans
        read."""
        for s in self.steps:
            for kind, e0, e1 in s.events:
                ms = e0.elapsed_time(e1)
                if kind == "prefill_chunk":
                    s.prefill_ms = (s.prefill_ms or 0.0) + ms
                else:
                    s.decode_ms = (s.decode_ms or 0.0) + ms
            s.events = []
        reqs = []
        for it in self.measured:
            f, d = self.first.get(it.idx), self.fin.get(it.idx)
            reqs.append((None if f is None else f - it.due,
                         None if d is None else d - it.due,
                         self.t_stop - it.due))
        win = [s for s in self.steps if s.window]
        w0 = gen.phase_spans(self.mix, self.seconds)["window"][0]
        window_s = (max(s.end for s in win) - w0) if win else 0.0
        timeline = devtrace.Timeline(self.prof) if self.prof else None
        self.rec = Record(setup_s=self.setup_s, model=self.m, requests=reqs,
                          window_s=window_s, window_steps=win,
                          timeline=timeline, work=self.cell.models.work)
        return self.rec

    def release(self):
        """Free the program's state (the engine and its caches); the
        weights stay for the reference."""
        for undo in self._restore:
            undo()
        self._restore = []
        self.eng = self.prof = None
        gc.unfreeze()
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def sample(self) -> tuple[list, int, int]:
        """(the sample the check compares, measured requests that never
        finished, finished ones whose tokens are not exactly their
        length). A batch's unfinished requests are still queued, not
        failed."""
        pool = [self.reqs[it.idx] for it in self.measured
                if it.idx in self.fin]
        burst = self.mix["arrival"] == "burst"
        failed = 0 if burst else len(self.measured) - len(pool)
        ok = [r for r in pool
              if len(r.generated) == min(r.true_out_len, r.max_new_tokens)
              and all(0 <= t < self.vocab for t in r.generated)]
        sm = self.mix["sample"]
        return (check.choose(ok, self.seed, sm["tokens"], sm["requests"]),
                failed, len(pool) - len(ok))

    def check(self) -> tuple[dict, dict]:
        """(the checks, each {"value", "limit"}; the sample's sizes):
        every measured request finished (open loop) with exactly its
        tokens, no decoding row of any step emitted nothing, and the
        numbers the cell's limits file names, from the reference on the
        sample."""
        sample, failed, wrong = self.sample()
        checks = {"failed": {"value": failed, "limit": 0},
                  "wrong_length": {"value": wrong, "limit": 0},
                  "rows_left_out": {"value": self.left_out, "limit": 0}}
        seen = {"requests": 0, "tokens": 0, "probes": 0}
        if sample:
            got = check.compare(self.cell.models.Reference, self.m,
                                self.w.views, sample, self.probes)
            seen = {k: got[k] for k in seen}
            for name, lim in self.cell.limits.items():
                checks[name] = {"value": got[name], "limit": lim["limit"]}
        else:               # nothing finished: nothing could be compared
            checks["unsampled"] = {"value": 1, "limit": 0}
        return checks, seen

    def execute(self) -> dict:
        """Set up, serve, read, check: the run's result line."""
        try:
            self.setup()
            self.serve()
            rec = self.record()
        finally:
            for undo in self._restore:
                undo()
            self._restore = []
        peak = (torch.cuda.max_memory_allocated() if self.cuda else 0)
        names = self.cell.per_layer if self.trace else self.cell.end_to_end
        metrics = {}
        for met in names:
            v = reader(met["name"])(rec)
            if v is not None:
                metrics[met["name"]] = {"value": v, "unit": met["unit"]}
        self.release()
        checks, seen = self.check()
        correct = all(c["value"] <= c["limit"] for c in checks.values()) \
            and not (self.mix["arrival"] != "burst" and not self.measured)
        dev = {"platform": "gpu" if self.cuda else "cpu",
               "kind": (torch.cuda.get_device_name(0) if self.cuda
                        else "cpu"),
               "count": 1, "memory_peak_bytes": peak}
        line = {"correct": correct,
                "attempted": len(self.measured),
                "failed": checks["failed"]["value"] +
                checks["wrong_length"]["value"],
                "metrics": metrics, "device": dev}
        tl = rec.timeline
        if self.trace and tl is not None:
            dev["busy_s"] = tl.busy_s
            dev["window_s"] = tl.window_s
            line["breakdown"] = {"device_ops": tl.top_ops(),
                                 "idle_gaps": tl.idle_gaps()}
        late = sorted(self.late) or [0.0]
        win = rec.window_steps
        line["run"] = {"late_p50_s": late[len(late) // 2],
                       "late_max_s": late[-1],
                       "window_steps": len(win),
                       "step_s_mean": (sum(s.wall for s in win) / len(win)
                                       if win else None),
                       "compared": seen}
        line["checks"] = checks
        return line


def check_lines(line: dict) -> list[str]:
    """Each number compared beside its limit, one line each."""
    return [f"check {name}: {c['value']} (limit {c['limit']})"
            for name, c in line["checks"].items()]


def rehearse(workload: str, seed: int, seconds: float, trace: bool = False,
             mix: dict | None = None, fault=None, root: Path = HERE.parent):
    """A run on the CPU at the configuration file's smoke sizes, for
    tests: the harness without its look for a chip. ``mix`` overrides
    keys of the cell's traffic; ``fault`` (a function of the ``Run``)
    breaks the timed path after the engine is built."""
    cell = load_cell(root, workload)
    if mix:
        cell.mix = {**cell.mix, **mix}
    return Run(cell, seed, seconds, trace, time.perf_counter(),
               device="cpu", smoke=True, fault=fault).execute()
