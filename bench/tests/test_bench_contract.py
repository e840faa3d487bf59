"""BENCHMARK.json against the benchmark's contract, every file it names,
and the whole-word import rule: no module of the benchmark imports JAX or
the JAX package (``repro``), while ``repro_torch`` is the program."""

import ast
import json
import re
from pathlib import Path

import harness
import pytest

BENCH = Path(harness.__file__).resolve().parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BLOCKED = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(source: str) -> set[str]:
    """Top-level names of every module a source imports (whole names)."""
    out = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".", 1)[0])
    return out


def test_the_import_check_compares_whole_names():
    src = "import repro_torch.models\nfrom repro_torch import config\n" \
          "import jaxtyping\nimport reprolib\n"
    assert not imported_tops(src) & BLOCKED
    assert imported_tops("import repro.serving") & BLOCKED == {"repro"}
    assert imported_tops("from jax import numpy") & BLOCKED == {"jax"}
    assert imported_tops("import flax.linen as nn") & BLOCKED == {"flax"}


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix() for p in BENCH.rglob("*.py")))
def test_no_benchmark_module_imports_jax_or_the_jax_package(path):
    assert not imported_tops((ROOT / path).read_text()) & BLOCKED


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1] == "bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    n = len(SPEC["workloads"])
    assert 1 <= n <= 24 and 1 <= len(SPEC["configs"]) <= 24
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_entry_has_its_keys_and_names():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] == []
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        harness.load_cell(ROOT, w["name"])   # traffic and limits exist
    assert configs == {w["config"] for w in SPEC["workloads"]}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:       # each cell reports what it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for w in SPEC["workloads"]:         # every cell: setup_s, another
        got = [m for m in SPEC["end_to_end"] + SPEC["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert sum(m in SPEC["end_to_end"] for m in got) >= 2
        assert sum(m in SPEC["per_layer"] for m in got) >= 1


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
