"""Find a chat cell's knee: the highest arrival rate at which the number of
requests waiting does not grow across the window.

    python3 bench/sweep.py --workload NAME --rates 3 4 5 6 --seconds 40

One process on the card: the model is built and warmed once, then each
rate runs the cell's traffic (its fill, then the window; no drain) on a
fresh engine. For each rate it prints one JSON line: the slope of the
requests in the system and of those waiting (neither decoding nor fed a
prompt chunk) over the window, by least squares, in requests per second;
their means; the requests finished per second and the tokens emitted per
second in the window. The benchmark's runs do not run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def slope(ts, ys) -> float:
    """Least-squares slope of ys over ts."""
    n = len(ts)
    mt, my = sum(ts) / n, sum(ys) / n
    var = sum((t - mt) ** 2 for t in ts)
    return sum((t - mt) * (y - my) for t, y in zip(ts, ys)) / var


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import harness
    cell = harness.load_cell(ROOT, args.workload)
    run = harness.Run(cell, args.seed, args.seconds, False, T_START)
    run.setup()
    for rate in args.rates:
        run.mix = {**cell.mix, "rate": rate, "drain_s": 0}
        run.new_engine()
        run.serve()
        win = [s for s in run.steps if s.window]
        ts = [s.end for s in win]
        inside = [s.in_system for s in win]
        waiting = [s.in_system - len(s.decode) - len(s.prefill) for s in win]
        span = win[-1].end - win[0].start
        done = sum(1 for it in run.measured if it.idx in run.fin)
        print(json.dumps({
            "rate": rate, "steps": len(win),
            "in_system_slope": slope(ts, inside),
            "waiting_slope": slope(ts, waiting),
            "in_system_mean": sum(inside) / len(inside),
            "waiting_mean": sum(waiting) / len(waiting),
            "measured": len(run.measured), "measured_done": done,
            "tokens_per_s": sum(s.emitted for s in win) / span,
            "step_s": span / len(win)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
