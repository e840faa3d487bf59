"""A span run of one benchmark cell that also reads the decode megastep's
CUDA-graph counts.

    python3 tools/graph_spanrun.py --workload NAME --seed N --seconds S

from the root of a checkout, on a machine with the card the cell asks for.
It is ``bench/spantrace.py``'s run (the engine's spans on every step, the
detail spans on the profiled ones) with the model's graph counts
(``Model.decode_graph.counts``) taken around every step.
The result line, the last of standard output, gains ``graph``: the
window's steps, those that ran a megastep (an ``engine.decode`` span), the
megasteps of the window that replayed a graph and that captured one, the
``model.graph_capture`` spans in the window, the captures and replays
outside it (set-up, warm-up, fill and drain), the device time of a
prefill chunk and of a megastep (the harness's CUDA events, mean over
the window's steps), and each kernel binding's launches in the window
over its megasteps.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "bench"))

if __name__ == "__main__":
    import run  # noqa: F401  the entry's caches and path, before torch

import json  # noqa: E402

import harness  # noqa: E402
import spantrace  # noqa: E402


class GraphSpanRun(spantrace.SpanRun):
    """``SpanRun`` keeping each step's graph counts (``Step.graph``)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.outside = {"captures": 0, "replays": 0}

    def new_engine(self):
        super().new_engine()
        counts, step = self.model.decode_graph.counts, self.eng.step

        def counted():
            for name, n in counts.take().items():
                self.outside[name] += n
            s = self.cur
            try:
                return step()
            finally:
                got = counts.take()
                if s is not None:
                    s.graph = got
                if s is None or not s.window:
                    for name, n in got.items():
                        self.outside[name] += n

        self.eng.step = counted

    def execute(self) -> dict:
        line = super().execute()
        win = self.rec.window_steps
        decoding = [s for s in win if "engine.decode" in s.spans]
        line["graph"] = {
            "window_steps": len(win),
            "decode_steps": len(decoding),
            "replays": sum(s.graph["replays"] for s in win),
            "captures": sum(s.graph["captures"] for s in win),
            "decode_steps_without_replay": sum(
                s.graph["replays"] < s.spans["engine.decode"]["count"]
                for s in decoding),
            "capture_spans": sum(
                s.spans.get("model.graph_capture", {}).get("count", 0)
                for s in win),
            "outside_window": self.outside,
            "prefill_ms_per_chunk": _mean(s.prefill_ms for s in win),
            "decode_ms_per_megastep": _mean(s.decode_ms for s in win),
            "launches_per_megastep": _per_megastep(win),
        }
        return line


def _per_megastep(steps) -> dict:
    """Each binding's launches in ``steps`` over the megasteps they ran
    (replayed or captured); a binding that the prefill also launches
    counts those launches too."""
    n = sum(s.graph["replays"] + s.graph["captures"] for s in steps)
    total: dict[str, int] = {}
    for s in steps:
        for name, k in s.launches.items():
            total[name] = total.get(name, 0) + k
    return {name: k / n for name, k in sorted(total.items())} if n else {}


def _mean(values):
    """Mean of the values that are not None (None if there are none)."""
    got = [v for v in values if v is not None]
    return sum(got) / len(got) if got else None


def main(argv=None) -> int:
    import argparse

    import run
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(run.ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    line = GraphSpanRun(cell, args.seed, args.seconds, run.T_START).execute()
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    print("\n".join(harness.check_lines(line)), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
