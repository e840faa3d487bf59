"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports JAX or anything of the reference ``repro`` package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

# an import statement of jax/jaxlib/repro — `repro_torch` must not match
FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|repro)(?=[.\s,]|$)"
    r"|import_module\(\s*['\"](?:jax|repro)(?=[.'\"])", re.M)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("line,hit", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("from jax import lax", True), ("from repro.config import X", True),
    ("import repro.models", True), ("    from repro import config", True),
    ("from repro_torch.config import X", False),
    ("import repro_torch.kernels", False), ("import jaxtyping", False),
    ('importlib.import_module("repro.configs.x")', True),
    ('importlib.import_module("repro_torch.configs." + m)', False),
])
def test_pattern_tells_the_port_from_the_reference(line, hit):
    assert bool(FORBIDDEN.search(line)) is hit


def test_no_source_names_jax_or_repro():
    offenders = []
    for path in _sources():
        for m in FORBIDDEN.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_every_module_imports_with_jax_and_repro_blocked():
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["repro"] = None        # and so does any `import repro...`
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke                  # importing runs no phase
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not loaded, loaded
print(len(names))
"""
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 70     # every module of the slice
