"""The port's sharding rules (``repro_torch.launch.sharding``), meshes and
hints against the reference's ``PartitionSpec``s, leaf by leaf.

The reference decides on shapes from ``jax.eval_shape`` (no devices) on
``jax.sharding.AbstractMesh``es of (16, 16), (2, 16, 16) and (1, 1); the
port on meta tensors (no allocation) on its plain ``Mesh`` descriptions.
Parameters cross in the reference's stacked layout (``params_to_jax``),
caches in the same tree, where each port slot-cache leaf holds one sink
slot more. Two traps are pinned: the expert-FSDP rule counts the bytes of
the whole stack of a run, and the sink slot must not make a ``decode_32k``
row of 32769 slots lose the "model" axis under ``"seq"``.
"""

import dataclasses
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.config import get_config as ref_get_config
from repro.config import get_smoke_config as ref_get_smoke_config
from repro.launch import sharding as ref
from repro.launch.steps import input_specs as ref_input_specs
from repro.models.model import build_model
from repro_torch.config import (ARCH_IDS, INPUT_SHAPES, get_config,
                                get_smoke_config, shape_applies)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding
from repro_torch.launch.steps import input_specs
from repro_torch.models import hints
from repro_torch.models.model import Model, params_to_jax

MESHES = {
    "16x16": (AbstractMesh((16, 16), ("data", "model")),
              mesh_mod.make_production_mesh()),
    "2x16x16": (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                mesh_mod.make_production_mesh(multi_pod=True)),
    "1x1": (AbstractMesh((1, 1), ("data", "model")),
            mesh_mod.make_host_mesh()),
}
SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


def _ref_leaves(spec_tree, shape_tree):
    """{path: spec padded to the leaf's rank} of a reference spec tree."""
    specs = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    shapes = dict(jax.tree_util.tree_flatten_with_path(shape_tree)[0])
    out = {}
    for path, spec in specs:
        ndim = len(shapes[path].shape)
        names = tuple(ref._key_name(k) for k in path)
        out[names] = tuple(spec) + (None,) * (ndim - len(spec))
    return out


def _port_leaves(tree, path=()):
    """{path: leaf} of a port tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not isinstance(
            tree, (sharding.Spec, sharding.Shards)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, path + (str(k),)))
    return out


def _ref_shapes(tree):
    return {tuple(ref._key_name(k) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(reference param ShapeDtypeStructs, port reference-layout tree)."""
    sds = jax.eval_shape(build_model(ref_get_config(arch)).init,
                         jax.random.key(0))
    cfg = get_config(arch)
    tree = params_to_jax(cfg, dict(Model(cfg, device="meta")
                                   .named_parameters()))
    return sds, tree


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh_name):
    amesh, mesh = MESHES[mesh_name]
    sds, tree = _params(arch)
    want = _ref_leaves(ref.param_specs(sds, amesh), sds)
    got = _port_leaves(sharding.param_specs(tree, mesh))
    assert got.keys() == want.keys()
    shapes = _port_leaves(tree)
    assert {p: tuple(t.shape) for p, t in shapes.items()} == _ref_shapes(sds)
    assert got == want


def _caches(arch, shape_name, kv_quant=False):
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    if kv_quant:
        rcfg = dataclasses.replace(rcfg, kv_quant=True)
        cfg = dataclasses.replace(cfg, kv_quant=True)
    shp = INPUT_SHAPES[shape_name]
    B, S = shp.global_batch, shp.seq_len
    rcache = jax.eval_shape(lambda: build_model(rcfg).init_cache(B, S))
    return rcache, Model(cfg, device="meta").init_cache(B, S)


def _check_cache(arch, shape_name, mesh_name, kv_quant=False):
    amesh, mesh = MESHES[mesh_name]
    rcache, cache = _caches(arch, shape_name, kv_quant)
    leaves = _port_leaves(cache)
    rshapes = _ref_shapes(rcache)
    for path, t in leaves.items():         # the sink slot, and only it
        want = list(rshapes[path])
        if path[-1] in sharding.SINK_LEAVES:
            want[2] += 1
        assert tuple(t.shape) == tuple(want), path
    for kv_shard in ("seq", "hd"):
        want = _ref_leaves(ref.cache_specs(rcache, amesh, kv_shard=kv_shard),
                           rcache)
        got = _port_leaves(sharding.cache_specs(cache, mesh,
                                                kv_shard=kv_shard))
        assert got == want, (shape_name, kv_shard)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, mesh_name):
    for shape_name in SERVE_SHAPES:
        if shape_applies(get_config(arch), INPUT_SHAPES[shape_name]):
            _check_cache(arch, shape_name, mesh_name)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ("qwen1.5-32b", "gemma3-1b", "hymba-1.5b"))
def test_int8_cache_specs_equal_reference(arch, mesh_name):
    _check_cache(arch, "decode_32k", mesh_name, kv_quant=True)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    model, rmodel = Model(cfg, device="meta"), build_model(rcfg)
    for shape_name in INPUT_SHAPES:
        if not shape_applies(cfg, INPUT_SHAPES[shape_name]):
            continue
        rbatch = ref_input_specs(rcfg, shape_name, rmodel)["batch"]
        batch = input_specs(cfg, shape_name, model)["batch"]
        for amesh, mesh in MESHES.values():
            want = _ref_leaves(ref.batch_specs(rbatch, amesh), rbatch)
            assert _port_leaves(sharding.batch_specs(batch, mesh)) == want


def test_expert_rule_counts_the_whole_stack():
    """One layer's experts are under ``_EXPERT_FSDP_BYTES`` per model
    shard, a stack of 7 is over. The tap layer 0 is a run of its own, so
    its one-layer stack keeps the small-expert spec and the run of the
    other 7 takes FSDP over "data", as in the reference."""
    changes = dict(num_layers=8, d_model=512, d_ff=1024, num_experts=16,
                   num_heads=4, num_kv_heads=4, head_dim=128, layer_kinds=())
    rcfg = dataclasses.replace(ref_get_smoke_config("olmoe-1b-7b"), **changes)
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), **changes)
    per_layer = cfg.num_experts * cfg.d_model * cfg.d_ff * 4 / 16
    assert per_layer < sharding._EXPERT_FSDP_BYTES < per_layer * 8
    amesh, mesh = MESHES["16x16"]
    sds = jax.eval_shape(build_model(rcfg).init, jax.random.key(0))
    tree = params_to_jax(cfg, dict(Model(cfg, device="meta")
                                   .named_parameters()))
    got = _port_leaves(sharding.param_specs(tree, mesh))
    assert got == _ref_leaves(ref.param_specs(sds, amesh), sds)
    w_gate = [spec for path, spec in got.items() if path[-2:] == ("moe",
                                                                  "w_gate")]
    assert w_gate == [(None, None, None, "model"),
                      (None, "model", "data", None)]


def test_sink_slot_keeps_the_seq_axis():
    """gemma3-1b decode_32k: 1 KV head, so "seq" shards the slots; a row
    holds 32769 slots with its sink, and the rule decides on 32768."""
    rcache, cache = _caches("gemma3-1b", "decode_32k")
    amesh, mesh = MESHES["16x16"]
    specs = _port_leaves(sharding.cache_specs(cache, mesh, kv_shard="seq"))
    leaves = _port_leaves(cache)
    rows = [p for p, t in leaves.items()
            if p[-1] == "k" and t.shape[2] == 32769]
    assert rows
    for p in rows:
        assert specs[p] == (None, "data", "model", None, None)
        assert specs[p[:-1] + ("kpos",)] == (None, "data", "model")
    want = _ref_leaves(ref.cache_specs(rcache, amesh, kv_shard="seq"), rcache)
    assert specs == want


def test_device_bytes_counts_the_sink_whole():
    _, mesh = MESHES["16x16"]
    k = torch.empty((2, 32, 33, 1, 8), dtype=torch.bfloat16, device="meta")
    cache = {"k": k, "lengths": torch.empty(32, dtype=torch.int32,
                                            device="meta")}
    shards = sharding.to_shardings(sharding.cache_specs(cache, mesh), mesh)
    assert shards == {"k": (1, 16, 16, 1, 1), "lengths": (16,)}
    body = 2 * 32 * 32 * 8 * 2 / 256
    sink = 2 * 32 * 1 * 8 * 2 / 16
    assert sharding.device_bytes(cache, shards) == body + sink + 32 * 4 / 16


def test_to_shardings_multiplies_axis_sizes():
    _, mesh = MESHES["2x16x16"]
    spec = sharding.Spec((("pod", "data"), None, "model"))
    assert sharding.to_shardings({"w": spec}, mesh) == {"w": (32, 1, 16)}
    assert sharding.opt_specs({}, {"w": spec})["step"] == ()


def test_meshes_and_hints():
    for name, (amesh, mesh) in MESHES.items():
        assert dict(mesh.shape) == dict(amesh.shape)
        assert mesh_mod.data_axes(mesh) == ref.data_axes(amesh)
        assert mesh_mod.n_chips(mesh) == amesh.size
    assert MESHES["1x1"][1].chip.name == "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_clamp_is_the_reference_spec_rule(mesh_name):
    amesh, mesh = MESHES[mesh_name]
    dp = ref.data_axes(amesh)
    for shape in ((256, 4096), (1, 32768), (48, 7), (32, 16, 8)):
        for want in ((dp, "model"), ("model", "data"), (None, dp),
                     ("model",)):
            expect = tuple(ref._spec_for(shape, amesh, want))
            expect += (None,) * (len(shape) - len(expect))
            assert hints.clamp(shape, want, mesh.shape) == expect
            assert hints.clamp(shape, (hints.BATCH,) + want[1:],
                               mesh.shape)[0] == expect[0] or want[0] != dp
