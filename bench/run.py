"""The benchmark's entry: one run of one cell, its result as the last line.

    python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the chips the cell asks
for. It measures the PyTorch and CUDA port (``src/repro_torch``), never the
JAX package beside it. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``; ``checks`` last: each number compared
with its limit), and the last lines of standard error repeat the checks.
With no CUDA card, too few of them, no port beside it, or JAX loaded in
the process, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / "build" / "bench_cache" / _sub)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "4")
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("no repro_torch beside the benchmark: nothing to measure",
              file=sys.stderr)
        return 2
    import torch

    import harness
    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    line = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                       T_START).execute()
    bad = harness.blocked_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    print("\n".join(harness.check_lines(line)), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
