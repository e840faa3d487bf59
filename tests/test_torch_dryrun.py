"""The port's dry run (``repro_torch.launch.dryrun``), its meta-tensor
inputs (``launch.steps.input_specs``) and the kernel wrappers on meta.

``input_specs`` must hold, by category, the bytes of the reference's
``ShapeDtypeStruct``s: parameters, moments and batches exactly (the
serving parameters with the port's matmul weights in the compute dtype,
leaf for leaf the reference's shapes), the cache exactly plus one sink
slot per slot-cache row. The skip rules mirror ``tests/test_system.py``;
``python -m repro_torch.launch.dryrun --arch mamba2-370m --shape
long_500k`` must report one chip, a fit and a peak under 2 GiB on the
H100 (and under 16 GB on the reference's 16x16 mesh). One step pass per
mode runs on meta at a smoke config, and ``Footprint`` is held to the
bytes it must count on a hand-made sequence of ops.
"""

import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro.config import get_config as ref_get_config
from repro.launch.steps import input_specs as ref_input_specs
from repro.models.model import build_model
from repro_torch import config as tconfig
from repro_torch.config import (ARCH_IDS, INPUT_SHAPES, get_config,
                                get_smoke_config, shape_applies)
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.sharding import SINK_LEAVES
from repro_torch.launch.steps import input_specs
from repro_torch.models.layers import cdtype
from repro_torch.models.model import Model, params_to_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
         if shape_applies(get_config(a), INPUT_SHAPES[s])]
#: leaves the port's serving model holds in the compute dtype
MATMUL = {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up",
          "w_down", "b_up", "b_down", "in_proj", "out_proj"}


def _ref_leaves(tree):
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, path + (str(k),)))
    return out


def _ref_bytes(tree):
    return sum(x.size * x.dtype.itemsize for x in _ref_leaves(tree).values())


def _bytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree).values())


@pytest.mark.parametrize("arch,shape", CASES)
def test_input_specs_bytes_equal_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    spec = input_specs(cfg, shape, Model(cfg, device="meta"))
    ref = ref_input_specs(rcfg, shape, build_model(rcfg))
    assert spec.keys() == ref.keys() and spec["mode"] == ref["mode"]
    assert all(t.device.type == "meta" for t in _leaves(
        {k: v for k, v in spec.items() if k != "mode"}).values())
    assert _bytes(spec["batch"]) == _ref_bytes(ref["batch"])
    params = _leaves(params_to_jax(cfg, spec["params"]))
    rparams = _ref_leaves(ref["params"])
    assert params.keys() == rparams.keys()
    for path, t in params.items():
        r = rparams[path]
        assert tuple(t.shape) == tuple(r.shape), path
        held = str(t.dtype).removeprefix("torch.")
        if spec["mode"] == "train" or path[-1] not in MATMUL:
            assert held == r.dtype.name, path
        else:
            assert t.dtype == cdtype(cfg), path
    if spec["mode"] == "train":
        assert _bytes(spec["params"]) == _ref_bytes(ref["params"])
        assert _bytes(spec["opt"]) == _ref_bytes(ref["opt"])
        return
    sink = sum(x.size * x.dtype.itemsize // x.shape[2]
               for p, x in _ref_leaves(ref["cache"]).items()
               if p[-1] in SINK_LEAVES)
    assert _bytes(spec["cache"]) == _ref_bytes(ref["cache"]) + sink


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_long_500k_skip_rules(arch):
    rep = dryrun.lower_case(arch, "long_500k")
    if arch in ("mamba2-370m", "hymba-1.5b", "gemma3-1b", "gemma2-9b"):
        assert "skipped" not in rep
        assert rep["roofline"]["bottleneck"] == "memory"
        assert rep["memory"]["temp_gb"] > 0
    else:
        assert rep["skipped"] == ("long_500k needs sub-quadratic attention "
                                  "(DESIGN.md section 5)")


@pytest.mark.parametrize("mesh,chips,limit", [("h100", 1, 2 * 2 ** 30),
                                              ("16x16", 256, 16e9)])
def test_cli_sizes_mamba2_long_500k(tmp_path, mesh, chips, limit):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-370m", "--shape", "long_500k", "--mesh", mesh, "--out",
         str(tmp_path)],
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[ok]" in out.stdout
    with open(tmp_path / f"mamba2-370m_long_500k_{mesh}.json") as f:
        rep = json.load(f)
    assert rep["roofline"]["n_chips"] == chips and rep["fits"]
    assert 0 < rep["memory"]["peak_per_device_gb"] * 1e9 < limit
    assert rep["memory"]["peak_is_lower_bound"] == (mesh != "h100")
    assert rep["roofline"]["flops_per_device_hlo_raw"] is None


def test_cli_refuses_no_case():
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "mamba2-370m"])


@pytest.mark.parametrize("mode", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", ("trail-llama", "whisper-tiny"))
def test_step_pass_on_meta(arch, mode, monkeypatch):
    """One step of each mode runs on meta at a smoke config."""
    monkeypatch.setitem(tconfig.INPUT_SHAPES, "tiny",
                        tconfig.InputShape("tiny", 64, 2, mode))
    cfg = get_smoke_config(arch)
    model = Model(cfg, device="meta")
    spec = input_specs(cfg, "tiny", model)
    fp = dryrun.run_step(model, spec)
    assert fp.peak > 0 and 0 < fp.output <= fp.peak
    # past the step only what its outputs dropped held is freed: the rest
    # is what the updated arguments hold (a decode step's new ``lengths``)
    assert fp.live <= fp.output


def test_footprint_counts_new_storages():
    a = torch.empty(100, device="meta")                 # 400 B, an argument
    with dryrun.Footprint(known=[a]) as fp:
        b = a + 1                                       # +400
        a.mul_(2)                                       # in place: nothing
        v = b.view(10, 10)                              # a view: nothing
        c = torch.cat([b, b])                           # +800 -> 1200
        del b, v, c                                     # freed -> 0
        d = a.double()                                  # +800
    assert fp.peak == 1200 and fp.live == 800
    del d
    assert fp.live == 0


KERNELS = {
    "decode_attention": lambda m: ops.decode_attention(
        m(2, 8, 16), m(2, 32, 2, 16), m(2, 32, 2, 16),
        m(2, 32, dtype=torch.int32), m(2, dtype=torch.int32), window=8),
    "paged_decode_attention": lambda m: ops.paged_decode_attention(
        m(2, 8, 16), m(5, 4, 2, 16), m(5, 4, 2, 16), m(5, 4, dtype=torch.int32),
        m(2, 3, dtype=torch.int32), m(2, dtype=torch.int32)),
    "paged_decode_attention_multi": lambda m: ops.paged_decode_attention_multi(
        m(2, 3, 8, 16), m(5, 4, 2, 16), m(5, 4, 2, 16),
        m(5, 4, dtype=torch.int32), m(2, 3, dtype=torch.int32),
        m(2, 3, dtype=torch.int32)),
    "probe_update": lambda m: ops.probe_update(
        m(2, 64), m(64, 32, dtype=torch.float32), m(32, dtype=torch.float32),
        m(32, 5, dtype=torch.float32), m(5, dtype=torch.float32),
        m(2, 5, dtype=torch.float32), m(5, 5, dtype=torch.float32)),
    "flash_attention": lambda m: ops.flash_attention(
        m(2, 16, 8, 16), m(2, 16, 2, 16), m(2, 16, 2, 16)),
    "ssd_scan": lambda m: ops.ssd_scan(
        m(2, 16, 4, 8, dtype=torch.float32), m(2, 16, 4, dtype=torch.float32),
        m(4, dtype=torch.float32), m(2, 16, 8, dtype=torch.float32),
        m(2, 16, 8, dtype=torch.float32), chunk=8),
    "ssm_state_update": lambda m: ops.ssm_state_update(
        m(2, 4, 8, 16, dtype=torch.float32), m(2, 4, 8, dtype=torch.float32),
        m(2, 4, dtype=torch.float32), m(4, dtype=torch.float32),
        m(2, 16, dtype=torch.float32), m(2, 16, dtype=torch.float32),
        m(4, dtype=torch.float32), m(2, dtype=torch.bool)),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_ops_on_meta_give_shapes_and_launch_nothing(name):
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    def cpu(*shape, dtype=torch.bfloat16):
        if dtype == torch.int32:
            return torch.zeros(shape, dtype=dtype)
        return torch.randn(shape).to(dtype)

    ops.reset_launches()
    args = []

    def made(*shape, **kw):
        args.append(meta(*shape, **kw))
        return args[-1]

    KERNELS[name](made)             # the inputs, made before the count
    given = iter(args)
    with dryrun.Footprint(known=args) as fp:
        got = KERNELS[name](lambda *shape, **kw: next(given))
    want = KERNELS[name](cpu)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [(t.device.type, t.shape, t.dtype) for t in got] == [
        ("meta", w.shape, w.dtype) for w in want]
    # a kernel allocates its outputs alone
    assert fp.peak == sum(t.untyped_storage().nbytes() for t in got)
    assert not any(ops.launches.values())
    assert "meta" in ops.__doc__ and "nothing runs" in ops.__doc__
