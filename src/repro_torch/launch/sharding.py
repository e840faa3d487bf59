"""Shape-aware sharding rules for parameters, optimizer state, batches and
caches (the reference ``repro.launch.sharding``), as pure shape logic.

Strategy (the reference's DESIGN.md section 6):
  * weights: tensor-parallel over "model" (heads / d_ff / experts / vocab),
    FSDP over "data" on the other big axis; replicated over "pod";
  * batch/activations: batch dim over ("pod","data");
  * KV caches: batch over data axes, kv-heads over "model" when they are
    wide enough; SSM state heads over "model".

A spec is a ``Spec``: a tuple with one entry per dim, each an axis name, a
tuple of names or ``None``, as a ``PartitionSpec`` reads. Every rule is
clamped to the leaf's shape (``models.hints.clamp``): an axis is used only
if the dim is at least its size and divisible by it. ``to_shardings``
turns a spec tree into each leaf's shard count per dim, and
``device_bytes`` divides each leaf's bytes by them: the dry run's bytes
per device. Nothing here allocates or needs a device.

Two layouts differ from the reference's and are read as it would read
them:
  * ``param_specs`` takes the reference's parameter tree, whose layer runs
    are stacked (``models.model.params_to_jax`` builds it from the port's
    per-layer tensors; stacking meta tensors allocates nothing), so that
    the expert rule counts the bytes of the whole stack, as there.
  * Every port slot cache row holds one sink slot past the reference's
    (``models.attention.init_kv_cache``); ``cache_specs`` decides on the
    reference's slot count, and ``device_bytes`` counts the sink whole on
    every device along the slot dim.
"""

from __future__ import annotations

import math

from repro_torch.launch.mesh import Mesh, data_axes
from repro_torch.models.hints import clamp


class Spec(tuple):
    """One leaf's partition spec (see the module docstring)."""


class Shards(tuple):
    """One leaf's shard count per dim."""


#: slot-cache leaves whose dim 2 ends in the port's sink slot
SINK_LEAVES = ("k", "v", "kpos", "k_scale", "v_scale")


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; a
    ``Spec`` or ``Shards`` is a leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          (Spec, Shards)):
        return type(tree)(_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _fits(dim: int, mesh: Mesh, axis) -> bool:
    """Exact divisibility, as jit in_shardings demand (no GSPMD padding)."""
    return axis is None or clamp((dim,), (axis,), mesh.shape)[0] is not None


def _spec_for(shape, mesh: Mesh, want) -> Spec:
    """Clamp a desired spec to the shape (drop axes that don't fit)."""
    return Spec(clamp(tuple(shape), tuple(want), mesh.shape))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

_EXPERT_FSDP_BYTES = 1e7   # FSDP expert weights over "data" only above this


def _param_rule(path: tuple[str, ...], shape=(), mesh: Mesh | None = None):
    """Desired spec for the *trailing* dims (leading run-stack dim -> None)."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if name in ("embed", "unembed", "pos_embed", "pos"):
        return ("model", "data")
    if parent == "moe" and name in ("w_gate", "w_up", "w_down"):
        # (n, E, d, ff) / (n, E, ff, d): experts over "model"; FSDP the
        # matrix dims over "data" only when a model-shard of the whole
        # stack is big (arctic) -- small-expert archs (olmoe) keep weights
        # whole so the expert matmuls need no per-layer weight collectives.
        n = math.prod(shape)
        model_ways = mesh.shape.get("model", 1) if mesh is not None else 1
        if n * 4 / model_ways > _EXPERT_FSDP_BYTES:
            return ("model", "data", None)
        return ("model",)
    if name == "router":
        return ("data", "model")
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj"):
        return ("data", "model")
    if name in ("wo", "w_down", "out_proj"):
        return ("model", "data")
    if name in ("bq", "bk", "bv", "b_up"):
        return ("model",)
    return (None,)                             # norms, biases, scalars, probe


def param_specs(params, mesh: Mesh):
    """Spec tree for a parameter tree in the reference's (stacked) layout
    (TP + FSDP rules)."""
    def spec(names, leaf):
        """Clamped spec for one parameter leaf."""
        shape = tuple(leaf.shape)
        want = _param_rule(names, shape=shape, mesh=mesh)
        # stacked run params have a leading layer dim: shift rules right
        pad = len(shape) - len(want)
        if pad > 0:
            want = (None,) * pad + want
        return _spec_for(shape, mesh, want)

    return _map(spec, params)


# ---------------------------------------------------------------------------
# Batches / caches / optimizer state
# ---------------------------------------------------------------------------

def batch_specs(batch, mesh: Mesh):
    """Spec tree for batch inputs (batch dim over data axes)."""
    dp = data_axes(mesh)
    return _map(lambda _, leaf: _spec_for(leaf.shape, mesh, (dp,)), batch)


# How to shard KV caches whose head count is too narrow for the "model"
# axis (GQA/MQA): "seq" shards the cache sequence dim (softmax reductions
# over it become per-row all-reduces, the flash-decode pattern); "hd"
# shards head_dim (the QK contraction all-reduces full score tensors per
# layer). "seq" won the reference's hill-climb on granite decode_32k.
KV_SHARD = "seq"


def cache_specs(cache, mesh: Mesh, kv_shard: str | None = None):
    """Spec tree for a contiguous cache (``Model.init_cache(B, S)``, as the
    dry run builds it): K/V over kv-heads, or under ``kv_shard`` (default
    ``KV_SHARD``) the slot dim ("seq") or head_dim ("hd") for narrow-KH
    archs; SSM state heads over "model". Slot-cache leaves are decided on
    the reference's slot count, the row without its sink."""
    if "block_table" in cache:
        raise ValueError("cache_specs takes a contiguous cache, not a paged "
                         "one")
    dp = data_axes(mesh)
    seq_mode = (kv_shard or KV_SHARD) == "seq"

    def spec(names, leaf):
        """Per-cache-leaf spec (kv-heads / seq / head_dim over model)."""
        name = names[-1]
        shape = tuple(leaf.shape)
        if name in SINK_LEAVES:
            shape = shape[:2] + (shape[2] - 1,) + shape[3:]
        if name == "lengths":
            return _spec_for(shape, mesh, (dp,))
        if name in ("k", "v", "ck", "cv"):   # (n, B, M|T, KH, hd)
            if _fits(shape[3], mesh, "model"):
                return _spec_for(shape, mesh, (None, dp, None, "model"))
            if seq_mode:
                return _spec_for(shape, mesh, (None, dp, "model"))
            return _spec_for(shape, mesh, (None, dp, None, None, "model"))
        if name in ("kpos", "k_scale", "v_scale"):   # (n, B, M[, KH])
            if seq_mode:
                return _spec_for(shape, mesh, (None, dp, "model"))
            return _spec_for(shape, mesh, (None, dp))
        if name == "ssm_state":      # (n, B, nh, hp, N)
            return _spec_for(shape, mesh, (None, dp, "model"))
        if name == "conv_buf":       # (n, B, W-1, ch)
            return _spec_for(shape, mesh, (None, dp, None, "model"))
        return _spec_for(shape, mesh, (None,))

    return _map(spec, cache)


def opt_specs(opt, pspecs):
    """Optimizer moments shard exactly like their parameters."""
    del opt
    return {"step": Spec(()), "mu": pspecs, "nu": pspecs}


def to_shardings(spec_tree, mesh: Mesh):
    """Each leaf's shard count per dim: the product of its axes' sizes
    (1 where the dim is not sharded)."""
    sizes = mesh.shape

    def count(ax) -> int:
        if ax is None:
            return 1
        return math.prod(sizes[a] for a in (ax if isinstance(ax, tuple)
                                            else (ax,)))

    return _map(lambda _, spec: Shards(count(ax) for ax in spec), spec_tree)


def device_bytes(tree, shard_tree) -> float:
    """Bytes per device of a tensor tree under its shard counts: each
    leaf's bytes over the product of its counts. A slot-cache leaf's sink
    slot is held whole by every device along the slot dim."""
    total = 0.0

    def add(names, leaf, shards):
        nonlocal total
        size = leaf.element_size()
        shape = tuple(leaf.shape)
        ways = math.prod(shards)
        if names[-1] in SINK_LEAVES:
            body = shape[:2] + (shape[2] - 1,) + shape[3:]
            sink = shape[:2] + (1,) + shape[3:]
            total += (math.prod(body) * size / ways
                      + math.prod(sink) * size * shards[2] / ways)
        else:
            total += math.prod(shape) * size / ways

    def walk(path, node, shards):
        if isinstance(node, dict):
            for k in node:
                walk(path + (str(k),), node[k], shards[k])
        elif isinstance(node, (list, tuple)):
            for i, (n, s) in enumerate(zip(node, shards)):
                walk(path + (str(i),), n, s)
        else:
            add(path, node, shards)

    walk((), tree, shard_tree)
    return total
