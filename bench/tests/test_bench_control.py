"""The control: the reference put in the program's place one precision
lower (float8 e4m3 where the configuration computes in bfloat16) has to
come out not correct under each cell's limits, at the cell's own size on
the card. On the CPU, at the smoke sizes, it has to read further from the
reference than the program does on the same sample."""

import time

import calibrate
import harness
import pytest
import torch
from test_bench_rehearsal import MIX, SEED

ROOT = harness.HERE.parent


def served(workload, seconds, device, smoke, mix=None, seed=SEED):
    cell = harness.load_cell(ROOT, workload)
    if mix:
        cell.mix = {**cell.mix, **mix}
    run = harness.Run(cell, seed, seconds, False, time.perf_counter(),
                      device=device, smoke=smoke)
    run.setup()
    run.serve()
    run.release()
    return cell, run


@pytest.mark.parametrize("workload", sorted(MIX))
def test_the_control_reads_further_than_the_program(workload):
    _, run = served(workload, 2.0, "cpu", True, MIX[workload])
    prog = calibrate.readings(run)
    ctl = calibrate.readings(run, quant="fp8")
    assert ctl["tokens"] == prog["tokens"] > 0
    assert ctl["logit_gap"] > prog["logit_gap"]
    assert ctl["probe_gap"] > prog["probe_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(MIX))
def test_the_control_is_not_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    cell, run = served(workload, 8.0, "cuda", False)
    ctl = calibrate.readings(run, quant="fp8")
    assert any(ctl[name] > lim["limit"]
               for name, lim in cell.limits.items()), ctl
