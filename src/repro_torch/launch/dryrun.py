"""Dry run: for every (architecture x input shape), does the step fit a
device, and which roofline term bounds it (the reference
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        --shape decode_32k [--mesh h100|16x16|2x16x16]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh ...]

It needs no card and no ``nvcc``: every input is a meta tensor
(``launch.steps.input_specs``), which allocates nothing. One JSON report
per case goes to ``--out`` (git-ignored), named
``<arch>_<shape>_<mesh>.json``.

One departure from the reference's flags: ``--mesh`` takes the place of
``--multi-pod``. ``h100`` (the default) is the one card the port runs on;
``16x16`` and ``2x16x16`` are the reference's TPU v5e meshes.

  * ``memory``: the bytes per device of the step's arguments (parameters,
    optimizer state or cache, batch; to train, also the serving weights
    the module holds beside the float32 masters), each leaf over its
    shard count from the sharding rules (``launch.sharding``).
  * ``temp_gb`` (``h100`` only): the peak of the bytes the step makes
    while it runs once on meta, counted by ``Footprint``; a kernel call
    counts its outputs alone, as on the card. ``peak_per_device_gb`` is
    the arguments plus that, and ``fits`` compares it with the chip's
    HBM. On the v5e meshes no step runs (the port has no multi-device
    runtime): the peak is the arguments alone, a lower bound.
  * ``roofline``: the analytic terms of ``launch.analysis`` on the mesh's
    chip (the H100's peaks on ``h100``, the v5e's on its meshes). No
    compiled program exists, so the raw-HLO fields are ``null`` and the
    collective term is 0 (on one card there are no collectives).

A case that raises is reported and counted, and the run exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config import (ARCH_IDS, INPUT_SHAPES, get_config,
                                shape_applies)
from repro_torch.launch import analysis
from repro_torch.launch.mesh import MESHES, Mesh, make_host_mesh, n_chips
from repro_torch.launch.sharding import (batch_specs, cache_specs,
                                         device_bytes, opt_specs, param_specs,
                                         to_shardings)
from repro_torch.launch.steps import (input_specs, make_prefill_step,
                                      make_serve_step, make_train_step_for)
from repro_torch.models.model import Model, params_to_jax

SKIP_MESSAGE = "long_500k needs sub-quadratic attention (DESIGN.md section 5)"


def _tensors(tree):
    """Every tensor of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class Footprint(TorchDispatchMode):
    """The bytes of the storages made while the mode is on, live and at
    their peak.

    Every op's outputs are looked at; a storage not seen before (neither
    one of ``known``'s, the step's arguments, nor one made earlier) is
    counted with its ``nbytes()`` and dropped when it is freed. Meta
    storages all report ``data_ptr() == 0``, so each is keyed by its
    Python object, which lives exactly as long as the storage, and
    ``weakref.finalize`` drops it. In-place ops and views make no new
    storage. A kernel call on meta makes its outputs alone (``ops``), as
    on the card.
    """

    def __init__(self, known=()):
        super().__init__()
        self._seen = {id(t.untyped_storage()) for t in _tensors(known)}
        self.live = 0
        self.peak = 0
        self.output = 0     # set by ``run_step``

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def count(self, out) -> None:
        """Count the storages of ``out``'s tensors not seen before."""
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            weakref.finalize(st, self._free, key, n)
            self.live += n
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.count(out)
        return out


def run_step(model: Model, spec: dict) -> Footprint:
    """Run the step of ``spec["mode"]`` once on ``spec``'s inputs under a
    ``Footprint``; returns it with ``output`` set to the bytes its outputs
    hold at the end."""
    fp = Footprint(known=[spec[k] for k in ("params", "opt", "cache",
                                            "batch") if k in spec])
    batch = spec["batch"]
    with fp:
        if spec["mode"] == "train":
            out = make_train_step_for(model)(spec["params"], spec["opt"],
                                             batch)
        elif spec["mode"] == "prefill":
            frontend = {k: v for k, v in batch.items() if k != "tokens"}
            out = make_prefill_step(model)(spec["cache"], batch["tokens"],
                                           **frontend)
        else:
            out = make_serve_step(model)(spec["cache"], batch["tokens"],
                                         batch["q_prev"])
    fp.output = fp.live
    del out
    return fp


def argument_bytes(cfg, model: Model, spec: dict, mesh: Mesh,
                   kv_shard: str | None = None) -> dict[str, float]:
    """Bytes per device of the step's arguments by category, each leaf
    over its shard count. Parameters (and moments) are sharded in the
    reference's stacked layout, which holds the same bytes as the port's
    per-layer tensors."""
    params = params_to_jax(cfg, spec["params"])
    pspecs = param_specs(params, mesh)
    pshard = to_shardings(pspecs, mesh)
    out = {"params": device_bytes(params, pshard)}
    if spec["mode"] == "train":
        opt = spec["opt"]
        opt_tree = {"step": opt["step"], "mu": params_to_jax(cfg, opt["mu"]),
                    "nu": params_to_jax(cfg, opt["nu"])}
        out["opt"] = device_bytes(
            opt_tree, to_shardings(opt_specs(opt_tree, pspecs), mesh))
        module = params_to_jax(cfg, dict(model.named_parameters()))
        out["module"] = device_bytes(module, pshard)
    else:
        out["cache"] = device_bytes(
            spec["cache"],
            to_shardings(cache_specs(spec["cache"], mesh, kv_shard), mesh))
    out["batch"] = device_bytes(
        spec["batch"], to_shardings(batch_specs(spec["batch"], mesh), mesh))
    return out


def lower_case(arch: str, shape_name: str, mesh: Mesh | None = None,
               kv_shard: str | None = None, kv_quant: bool = False) -> dict:
    """Size one (arch, input-shape) case on ``mesh`` (default: the one
    H100); return its report dict (memory per device, the fit, roofline
    terms, timings)."""
    mesh = mesh or make_host_mesh()
    cfg = get_config(arch)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    shape = INPUT_SHAPES[shape_name]
    base = {"arch": arch, "shape": shape_name, "mesh": mesh.name,
            "mode": shape.mode}
    if not shape_applies(cfg, shape):
        return {**base, "skipped": SKIP_MESSAGE}

    t0 = time.time()
    model = Model(cfg, device="meta")
    spec = input_specs(cfg, shape_name, model)
    args = argument_bytes(cfg, model, spec, mesh, kv_shard)
    argument = sum(args.values())
    t_specs = time.time() - t0

    t0 = time.time()
    temp = output = None
    if n_chips(mesh) == 1:
        fp = run_step(model, spec)
        temp, output = fp.peak, fp.output
    t_step = time.time() - t0
    peak = argument + (temp or 0)

    rl = analysis.Roofline(
        flops_per_device=None, bytes_per_device=None, collective_bytes=0.0,
        n_chips=n_chips(mesh),
        model_flops=analysis.model_flops_estimate(cfg, shape),
        model_bytes_per_device=analysis.model_bytes_estimate(
            cfg, shape, n_chips(mesh)),
        chip=mesh.chip)
    return {
        **base,
        "specs_s": round(t_specs, 2),
        "step_s": round(t_step, 2),
        "memory": {
            "argument_gb": argument / 1e9,
            "by_category_gb": {k: v / 1e9 for k, v in args.items()},
            "output_gb": None if output is None else output / 1e9,
            "temp_gb": None if temp is None else temp / 1e9,
            "alias_gb": 0.0,
            "peak_per_device_gb": peak / 1e9,
            "peak_is_lower_bound": temp is None,
            "hbm_gb": mesh.chip.hbm_bytes / 1e9,
        },
        "fits": peak <= mesh.chip.hbm_bytes,
        "collectives": {},
        "roofline": rl.as_dict(),
    }


def _case(work: tuple) -> dict:
    """One case's report, or its error (a pool worker's unit of work)."""
    arch, shape, mesh_name, kv_shard, kv_quant = work
    try:
        return lower_case(arch, shape, MESHES[mesh_name](), kv_shard=kv_shard,
                          kv_quant=kv_quant)
    except Exception as e:  # noqa: BLE001 -- report and continue
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def run_cases(cases, mesh_name: str = "h100", kv_shard: str | None = None,
              kv_quant: bool = False) -> list[dict]:
    """The reports of ``cases`` ((arch, shape) pairs), in order. Several
    cases run in spawned worker processes, one for each CPU this process
    may use (at most one a case): the step passes of train and prefill
    cases take seconds each on meta."""
    work = [(a, s, mesh_name, kv_shard, kv_quant) for a, s in cases]
    jobs = min(len(work), len(os.sched_getaffinity(0)))
    if jobs <= 1:
        return [_case(w) for w in work]
    with multiprocessing.get_context("spawn").Pool(jobs) as pool:
        return pool.map(_case, work, chunksize=1)


def summary(rep: dict) -> str:
    """One line for a report: skipped, failed, or its peak, fit and
    bounding term."""
    tag = f"{rep['arch']}_{rep['shape']}_{rep['mesh']}"
    if "skipped" in rep:
        return f"[skip] {tag}: {rep['skipped']}"
    if "error" in rep:
        return f"[FAIL] {tag}: {rep['error']}"
    r, m = rep["roofline"], rep["memory"]
    return (f"[ok]  {tag}: mem {m['peak_per_device_gb']:.2f}GB/dev "
            f"({'fits' if rep['fits'] else 'does not fit'} "
            f"{m['hbm_gb']:.0f}GB) compute {r['compute_s']:.2e}s "
            f"memory {r['memory_s']:.2e}s coll {r['collective_s']:.2e}s "
            f"-> {r['bottleneck']} (specs {rep['specs_s']}s step "
            f"{rep['step_s']}s)")


def main(argv=None) -> list[dict]:
    """CLI entry: size the selected (or all) cases, save one JSON each and
    return the reports."""
    ap = argparse.ArgumentParser(
        description="Dry run of every (arch, input shape) on meta tensors. "
                    "--mesh takes the place of the reference's --multi-pod: "
                    "h100 (default, the one card, with a step pass) or the "
                    "reference's TPU v5e meshes 16x16 and 2x16x16 "
                    "(argument bytes and analytic terms only).")
    ap.add_argument("--arch", choices=ARCH_IDS, default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--mesh", choices=list(MESHES), default="h100")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--kv-shard", choices=("seq", "hd"), default=None,
                    help="narrow-KH cache sharding mode (default: "
                         "sharding.KV_SHARD)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache with per-(token,head) scales")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        cases = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        cases = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    reports = run_cases(cases, args.mesh, args.kv_shard, args.kv_quant)
    for rep in reports:
        tag = f"{rep['arch']}_{rep['shape']}_{rep['mesh']}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rep, f, indent=1)
        print(summary(rep))
    failures = sum("error" in rep for rep in reports)
    if failures:
        raise SystemExit(f"{failures} case(s) failed")
    return reports


if __name__ == "__main__":
    main()
