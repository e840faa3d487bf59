"""Build the CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``<BUILD_DIR>/<name>-<hash>.so``. ``BUILD_DIR`` is ``build/kernels``
at the root of the checkout when the package runs from one (git-ignored);
an installed package builds into ``repro_torch_kernels`` in the
temporary directory, never into the environment it is installed in. The
hash covers the source and the flags, so an edited source builds anew and
an unchanged one is reused. ``build_all`` starts one ``nvcc`` per source
together and waits for all of them.

The sources target Hopper only (``sm_90a``). There is no fallback: a
missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
#: every kernel source of the package (``csrc/<name>.cu``)
SOURCES = ("paged_decode_attention",)


def _build_dir() -> Path:
    src = Path(__file__).resolve().parents[2]
    if src.name == "src" and (src.parent / "pyproject.toml").exists():
        return src.parent / "build" / "kernels"
    return Path(tempfile.gettempdir()) / "repro_torch_kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, out)      # atomic: a concurrent build never sees half a file
    return log


def build_all(names) -> dict[str, str]:
    """Compile every named source not built yet, all ``nvcc``s at once.

    Returns the compiler's report (ptxas registers, shared memory and
    spills) of each source compiled here; empty for one already built.
    """
    jobs = {name: _start(name) for name in names}
    return {name: _finish(name, job) for name, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it first if needed."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
