"""Committed sim cells rebuilt from the port's modules alone.

``BENCH_trace_replay.json`` and ``BENCH_tail.json`` were written by the
reference's benchmarks (``benchmarks/trace_replay.py`` and
``benchmarks/tail_curves.py``): the bundled trace replayed open-loop into
one sim engine serving ``granite-3-8b`` under the TPU v5e cost model, and
the event stream rolled up. Each cell below follows that recipe through
``repro_torch`` (traces, engine, metrics) and must equal the committed
JSON exactly; nothing of the reference package is imported, and the
files are only read.
"""

import json
from pathlib import Path

import pytest

from repro_torch.config import get_config
from repro_torch.metrics import (EventLog, check_invariants,
                                 ideal_service_times, rollup)
from repro_torch.metrics.emitters import METRIC_ROWS, SUMMARY_COLS
from repro_torch.serving.costmodel import CostModel, HardwareSpec
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.traces import (ReplayConfig, load_trace, replay,
                                requests_from_trace)

ROOT = Path(__file__).resolve().parents[1]
HW = HardwareSpec()
SEED = 0
TAIL_RECIPE = dict(age_boost=3072.0, age_delay_s=20.5, c_limit=0.2,
                   kv_layout="paged")


def cell(policy: str, rate_scale: float, tail_columns: bool,
         **knobs) -> dict:
    """One (policy, rate-scale) replay, summarised as the benchmarks
    summarise a grid cell (the tail benchmark adds two columns)."""
    cfg = get_config("granite-3-8b")
    reqs = requests_from_trace(load_trace("sample"), ReplayConfig(
        rate_scale=rate_scale, seed=SEED, vocab=cfg.vocab_size))
    log = EventLog()
    eng = Engine(cfg, EngineConfig(policy=policy, hardware=HW, seed=SEED,
                                   **knobs), event_log=log)
    replay(eng, reqs)
    check_invariants(log)
    report = rollup(log, service_times=ideal_service_times(
        CostModel(cfg, HW), reqs))
    row = {}
    for metric in METRIC_ROWS:
        if report.get(metric):
            row[metric] = {k: report[metric][k] for k in SUMMARY_COLS
                           if k in report[metric]}
    row["slo_attainment"] = report["slo_attainment"]
    row["finished"] = report["requests"]["finished"]
    row["preemptions"] = report["counters"]["preemptions"]
    if tail_columns:
        row["max_wait_s"] = report["counters"]["max_wait_s"]
        row["preemptions_per_request"] = \
            report["counters"]["preemptions_per_request"]
    return row


@pytest.mark.parametrize("bench,key,policy,knobs", [
    ("BENCH_trace_replay.json", "scale=24.0.trail", "trail", {}),
    ("BENCH_trace_replay.json", "scale=24.0.fcfs", "fcfs", {}),
    ("BENCH_tail.json", "scale=24.0.trail.tail", "trail", TAIL_RECIPE),
])
def test_committed_cell_rebuilt_exactly(bench, key, policy, knobs):
    committed = json.loads((ROOT / bench).read_text())["grid"][key]
    got = cell(policy, 24.0, bench == "BENCH_tail.json", **knobs)
    assert json.dumps(got, sort_keys=True) == json.dumps(committed,
                                                         sort_keys=True)
