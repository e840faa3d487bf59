"""``python -m repro_torch.launch.serve`` against the reference CLI.

The error cases of the reference's own CLI test, and the refusals of its
cluster and front-door modes (real mode, a contiguous layout under
``--disagg``, chaos without replicas, the door with replicas): exit 2,
``error:`` on stderr with the reference's message, no traceback. Ten sim
runs (single engine, cluster, disaggregated, under a crash, closed loop)
print the same JSON, and write the same ``--metrics-out`` file, as
``python -m repro.launch.serve`` with the same argv (the reference in a
subprocess on the CPU, the port in-process). A real-mode run of
``trail-llama-smoke`` on the CPU finishes every request and prints the
keys the reference's real mode prints.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}

ERRORS = [
    ["--rate-scale", "2.0"],                     # needs --trace
    ["--trace", "sample", "--rate-scale", "0"],  # must be positive
    ["--trace", "/nonexistent/t.jsonl"],         # unreadable path
    ["--trace", "sample", "--scenario", "bursty"],   # a trace has arrivals
    ["--trace", "sample", "--real"],             # sim-only
    ["--policy", "nope"],                        # argparse choice error
    ["--admission-control"],                     # needs watermark
    ["--age-boost", "-1"],                       # negative knob
    ["--deadline", "-1"],                        # negative deadline
    ["--shed-watermark", "-5"],                  # negative watermark
    ["--deadline-slack", "5"],                   # needs --deadline
    ["--predictor", "nope"],                     # unknown strategy
    ["--predictor", "oracle", "--real"],         # sim-only strategies
    ["--link-gbps", "25"],                       # needs --disagg
    ["--port", "8100"],                          # needs --serve
    ["--time-scale", "20"],                      # needs --serve
    ["--think-time", "1.0"],                     # needs --clients
    ["--requests-per-client", "2"],              # needs --clients
    # the reference's refusals in its cluster and front-door modes
    ["--replicas", "2", "--real"],
    ["--disagg", "1:3", "--kv-layout", "contig"],
    ["--chaos", "crash:1@5"],
    ["--chaos", "meteor:0@5", "--replicas", "2"],
    ["--serve", "--real"],
    ["--serve", "--port", "99999"],
    ["--clients", "4", "--replicas", "2"],
    ["--clients", "0"],
]
# the reference CLI's own message for each of those refusals
MESSAGES = {
    "--replicas 2 --real": "cluster mode is sim-only (one device pool)",
    "--disagg 1:3 --kv-layout contig":
        "--disagg requires a paged KV layout (pages are the unit of "
        "handoff); drop --kv-layout contig",
    "--chaos crash:1@5":
        "--chaos requires cluster mode (--replicas >= 2): fault injection "
        "and failover live in the router",
    "--chaos meteor:0@5 --replicas 2":
        "bad --chaos entry 'meteor:0@5': unknown fault kind 'meteor' "
        "(expected crash:R@T[-U], slow:R@T-U*F, or flaky:R@T-U%P)",
    "--serve --real":
        "--serve/--clients run a live closed loop over one sim engine and "
        "conflict with --real (the clients are the workload; GET /metrics "
        "serves the live rollup)",
    "--serve --port 99999": "--port must be in [0, 65535] (0 = OS-assigned)",
    "--clients 4 --replicas 2":
        "--serve/--clients drive a single engine; the cluster router is "
        "not behind the front door yet (drop --replicas)",
    "--clients 0": "--clients must be a positive user count",
}


@pytest.mark.parametrize("argv", ERRORS, ids=" ".join)
def test_invalid_flags_exit_2(argv, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(argv)
    printed = capsys.readouterr()
    err = printed.err
    assert e.value.code == 2 and "error:" in err and "Traceback" not in err
    assert printed.out == ""
    if " ".join(argv) in MESSAGES:
        assert f"error: {MESSAGES[' '.join(argv)]}\n" in err


def test_module_entry_point_exits_2_without_a_traceback():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--replicas",
         "3", "--real"], env=ENV, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 2, out.stderr
    assert "error:" in out.stderr and "Traceback" not in out.stderr
    assert "cluster mode is sim-only" in out.stderr and not out.stdout


def reference_cli(argv):
    out = subprocess.run([sys.executable, "-m", "repro.launch.serve", *argv],
                         env=ENV, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("argv", [
    ["--policy", "fcfs", "--n", "60"],
    ["--scenario", "bursty", "--rate", "40", "--deadline", "120",
     "--shed-watermark", "20000", "--n", "80"],
    ["--trace", "sample", "--rate-scale", "24", "--n", "60",
     "--metrics-out"],
    ["--trace", "sample", "--tail", "--rate-scale", "24", "--n", "60"],
    ["--scenario", "shared-prefix", "--prefix-cache", "--n", "60"],
    ["--scenario", "bursty", "--predictor", "noisy-oracle:sigma=0.5",
     "--age-boost", "256", "--age-delay", "5", "--compute-bound", "--n",
     "60"],
    ["--replicas", "2", "--router", "jspw", "--n", "60"],
    ["--replicas", "4", "--disagg", "1:3", "--kv-layout", "paged",
     "--trace", "sample", "--rate-scale", "24", "--n", "60",
     "--metrics-out"],
    ["--replicas", "2", "--chaos", "crash:1@5", "--kv-layout", "paged",
     "--n", "60"],
    ["--clients", "8"],
], ids=["fcfs", "bursty-shed", "trace-metrics", "trace-tail",
        "prefix-cache", "predictor-aging", "cluster-jspw",
        "disagg-metrics", "chaos-crash", "closed-loop"])
def test_sim_output_equals_the_reference_cli(argv, tmp_path, capsys):
    paths = {}
    if argv[-1] == "--metrics-out":
        paths = {who: str(tmp_path / f"{who}.json")
                 for who in ("ref", "port")}
    want = reference_cli(argv + ([paths["ref"]] if paths else []))
    serve.main(argv + ([paths["port"]] if paths else []))
    got = capsys.readouterr().out
    if paths:       # the markdown table names its file; the rest is equal
        want = want.replace(paths["ref"], "PATH")
        got = got.replace(paths["port"], "PATH")
        assert Path(paths["port"]).read_bytes() == \
            Path(paths["ref"]).read_bytes()
    assert got == want


def test_real_mode_on_the_cpu_finishes_and_prints_the_reference_keys(
        capsys):
    argv = ["--arch", "trail-llama", "--smoke", "--real", "--n", "6"]
    stats, log = serve.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert len(stats.latencies) == 6 and log is None
    assert got["predictor"] == "probe" and got["arch"] == "trail-llama-smoke"
    want = json.loads(reference_cli(argv))
    assert list(got) == list(want)
