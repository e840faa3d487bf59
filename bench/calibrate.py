"""Read the numbers a cell's limits are set from: the program's on a dozen
seeds or more, and the control's on some of them.

    python3 bench/calibrate.py --workload NAME --seeds 1 2 ... \
        --control 1 2 3 --seconds 8

One process on the card: the model is built and warmed once; for each seed
the weights are drawn again from it and the cell's traffic runs on a fresh
engine at the cell's own load for a short window, drained as a run drains
it, and the sample a run would compare is compared. On the control seeds
the control (the reference in the program's place, one precision lower:
``check.compare(..., quant="fp8")``) is read on the same sample. One JSON
line a seed. The benchmark's runs do not run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def readings(run, quant=None) -> dict:
    """The readings of the sample a run of this seed compares: the
    program's, or with ``quant`` the control's."""
    import check
    return check.compare(run.cell.models.Reference, run.m, run.w.views,
                         run.sample()[0], run.probes, quant=quant)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    import harness
    cell = harness.load_cell(ROOT, args.workload)
    run = harness.Run(cell, args.seeds[0], args.seconds, False, T_START)
    run.setup()
    for seed in args.seeds:
        t = time.perf_counter()
        run.seed = seed
        run.w.draw(seed)
        run.new_engine()
        run.serve()
        run.release()
        out = {"seed": seed, "measured": len(run.measured),
               "failed": run.sample()[1], "program": readings(run)}
        if seed in args.control:
            out["control"] = readings(run, quant="fp8")
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
