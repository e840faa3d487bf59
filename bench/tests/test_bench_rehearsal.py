"""The harness end to end on the CPU, through its test-only entry
(``harness.rehearse``: the configuration file's smoke sizes, short traffic),
and the command line's refusals. The command line itself never falls back
to the CPU."""

import json
import os
import shutil
import subprocess
import sys

import harness
import pytest
import torch

CHAT = {"rate": 8.0, "fill_s": 1, "drain_s": 20, "max_len": 128,
        "prompt": {"median": 12, "sigma": 0.6, "min": 4, "max": 40},
        "output": {"median": 8, "sigma": 1.0, "min": 1, "max": 40},
        "sample": {"tokens": 60, "requests": 4}}
MIX = {"granite-chat-poisson": CHAT, "olmoe-chat-poisson": CHAT}
SEED = 2**31 + 11


def rehearse(workload, trace=False, fault=None, seconds=2.0, seed=SEED):
    return harness.rehearse(workload, seed, seconds, trace=trace,
                            mix=MIX[workload], fault=fault)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", sorted(MIX))
def test_a_sound_run_is_correct_and_its_line_has_the_schema(workload,
                                                             trace):
    line = rehearse(workload, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    cell = harness.load_cell(harness.HERE.parent, workload)
    assert set(cell.limits) <= set(line["checks"])
    want = {m["name"]: m["unit"]
            for m in (cell.per_layer if trace else cell.end_to_end)}
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name] and isinstance(m["value"], float)
    if not trace:
        assert set(line["metrics"]) == set(want)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    json.dumps(line)


def test_the_command_line_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run")
    root = harness.HERE.parent
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "granite-chat-poisson", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=100)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_the_command_line_needs_the_port(tmp_path):
    root = harness.HERE.parent
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "granite-chat-poisson", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=100, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


DOCS = {"requests": 12, "max_len": 128, "drain_s": 20,
        "prompt": {"median": 60, "sigma": 0.5, "min": 20, "max": 100},
        "output": {"median": 6, "sigma": 0.8, "min": 1, "max": 16},
        "sample": {"tokens": 30, "requests": 4}}


@pytest.mark.parametrize("trace", [False, True])
def test_a_batch_traffic_runs_through_the_harness(trace):
    """No cell sends the batch traffic now (PERF.md section 7); its file
    and the readers of its metrics stay, and run here."""
    import json

    import weights
    bench = harness.HERE
    metrics = {"tokens_per_s": "tokens/s", "setup_s": "s",
               "model.prefill_useful_share": "%", "step_mfu.batch": "%",
               "model.prefill_ms_per_chunk": "ms"}
    mix = json.loads((bench / "traffic" / "azure-code-docs-batch.json")
                     .read_text())
    cell = harness.Cell(
        name="batch", conf=weights.load_config(bench, "granite-3-8b"),
        mix={**mix, **DOCS},
        limits={"logit_gap": {"limit": 0.4},
                "probe_gap_mean": {"limit": 0.032}},
        chips=1, end_to_end=[{"name": n, "unit": u} for n, u in
                             metrics.items() if "." not in n],
        per_layer=[{"name": n, "unit": u} for n, u in metrics.items()
                   if "." in n])
    line = harness.Run(cell, SEED, 2.0, trace, 0.0, device="cpu",
                       smoke=True).execute()
    assert line["correct"] is True and line["attempted"] == 12
    if trace:
        assert line["metrics"]["model.prefill_useful_share"]["value"] > 0
    else:
        assert line["metrics"]["tokens_per_s"]["value"] > 0
