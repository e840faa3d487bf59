"""The cell ``granite4h-chat-bursty`` (configuration ``granite-4.0-h-small``,
which names its model module ``models/granite-4.0-h-small.py``) rehearsed
through the harness on the CPU at the configuration file's smoke sizes,
and the module's counts held against hand arithmetic at the cut's sizes."""

import json

import flops
import harness
import pytest
import reference
import weights
from test_bench_rehearsal import CHAT, SEED

ROOT = harness.HERE.parent
CELL = "granite4h-chat-bursty"
#: the chat rehearsal's short traffic, with the cell's bursty arrivals at
#: a cycle short enough that every window holds bursts and prefills, and a
#: drain long enough for a loaded CPU to finish the measured requests
BURSTY = dict(CHAT, rate=6.0, drain_s=90,
              mmpp={"burst_factor": 2.5, "duty": 0.3, "cycle_s": 1.0})


@pytest.fixture(scope="module")
def cell():
    return harness.load_cell(ROOT, CELL)


def test_the_cell_takes_its_model_module(cell):
    assert cell.conf["model_module"] == "granite-4.0-h-small"
    assert cell.mix["arrival"] == "mmpp"
    models = cell.models
    assert issubclass(models.Reference, reference.Reference)
    assert models.Reference is not reference.Reference
    assert set(weights.STD) < set(models.STD)
    assert models.work is not flops


@pytest.mark.parametrize("trace", [False, True])
def test_a_rehearsal_of_the_cell_is_correct(cell, trace):
    line = harness.rehearse(CELL, SEED, 2.0, trace=trace, mix=BURSTY)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert line["attempted"] > 0
    assert line["run"]["compared"]["tokens"] > 0
    assert set(cell.limits) <= set(line["checks"])
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if trace:
        # every metric of the cell that reads the host or the spans
        for name in ("sched.select_ms_per_step", "sched.recompute_share",
                     "predictor.ms_per_step", "step_mfu.chat",
                     "engine.host_ms_per_step",
                     "model.ssm_prefill_host_ms"):
            assert line["metrics"][name]["value"] >= 0
    else:
        assert set(line["metrics"]) == want


def test_the_counts_are_the_hand_arithmetic(cell):
    m = weights.model_section(cell.conf)
    work = cell.models.work
    d, V, L = 4096, 100352, 20
    assert work.attn_layers(m) == 2
    mixer = d * (2 * 8192 + 2 * 128 + 128) + 8192 * d
    moe = d * 72 + 3 * d * (10 * 768 + 1536)
    attn = 2 * d * 4096 + 2 * d * 1024
    trunk = 2.0 * (18 * mixer + 2 * attn + L * moe) + 18 * 4.0 * 8192 * 128
    # one step: a row prefilling 5 positions from 3, a row emitting 2
    # tokens from 9 keys
    prefill = 5 * trunk + 4.0 * 4096 * (5 * 3 + 15) * 2
    decode = sum(trunk + 2.0 * V * d + 4.0 * 4096 * k * 2 for k in (9, 10))
    assert work.step_flops(m, [(3, 5)], [(9, 2)]) == \
        pytest.approx(prefill + decode, rel=1e-12)
    assert work.decode_attn_bytes(m, 9) == 2 * 2 * (2 * 9 * 1024 + 2 * 4096)
    assert work.prefill_attn_work(m, 3, 5) == flops.prefill_attn_work(m, 3,
                                                                       5)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in spec["configs"]}["granite-4.0-h-small"]
    assert conf["reduced"] == cell.conf["reduced"]
    assert cell.conf["num_hidden_layers"] == m["num_layers"] == L
