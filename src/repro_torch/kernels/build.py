"""Build the CUDA kernels with ``nvcc`` at first use, and what every
ctypes binding shares: the launch counts and the checks before a launch.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``<BUILD_DIR>/<name>-<hash>.so``. ``BUILD_DIR`` is ``build/kernels``
at the root of the checkout when the package runs from one (git-ignored);
an installed package builds into ``repro_torch_kernels`` in the
temporary directory, never into the environment it is installed in. The
hash covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source builds anew and an unchanged one is reused.
``build_all`` starts one ``nvcc`` per source together and waits for all
of them.

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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: every kernel source of the package (``csrc/<name>.cu``)
SOURCES = ("paged_decode_attention", "decode_attention", "probe",
           "flash_attention", "ssd_scan", "ssm_state_update", "moe_experts")

#: the ``dtype`` code every C entry takes for its floating inputs
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last ``reset_launches()``, keyed by kernel;
#: each binding adds one where it launches its kernel, and nowhere else
launches = {"paged_decode_attention": 0, "paged_decode_attention_multi": 0,
             "decode_attention": 0, "decode_attention_int8": 0,
             "probe_update": 0, "flash_attention": 0, "ssd_scan": 0,
             "ssm_state_update": 0, "moe_experts": 0}


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
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
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


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu`` and declare each entry's C signature.

    ``signatures`` maps an entry name to its argument types; every entry
    returns a CUDA error code as a C ``int``.
    """
    lib = load(name)
    for entry, argtypes in signatures.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in launches:
        launches[name] = 0


def check_on_card(device, align: int = 16, **tensors) -> None:
    """Raise unless every tensor lies on ``device`` (a CUDA device), is
    contiguous and starts on an ``align``-byte boundary: 16 where a
    kernel reads 16-byte vectors, 4 where it reads one element at a
    time."""
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} must lie on the CUDA device {device}, "
                             f"not {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def raise_on(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
