"""The sharding hints' spec rule (the reference ``repro.models.hints``).

In the reference, ``hint`` annotates an activation with a sharding
constraint when a mesh is active. The port never sets an ambient mesh (it
runs on one card), so its models give no hints, and only the rule a hint
applies under a mesh is kept, as one pure function, ``clamp``: the token
``BATCH`` resolves to ("pod","data") or ("data",) depending on the mesh's
axes, and an axis is kept for a dim only when the mesh has it and the dim
is at least its size and divisible by it. The sharding rules
(``launch.sharding``) clamp their specs with it.
"""

from __future__ import annotations

from collections.abc import Mapping

BATCH = "__batch__"


def clamp(shape, spec, sizes: Mapping[str, int]) -> tuple:
    """Clamp a desired spec to ``shape`` on a mesh of axis ``sizes``: one
    entry per dim (missing trailing entries are ``None``), each an axis
    name, a tuple of names or ``None``; an entry that does not fit its dim
    becomes ``None``, and a tuple of one name reads as the name, as in a
    ``PartitionSpec``."""
    names = tuple(sizes)
    full = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, full):
        if ax == BATCH:
            ax = ("pod", "data") if "pod" in names else ("data",)
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        if not all(a in names for a in axes):
            out.append(None)
            continue
        size = 1
        for a in axes:
            size *= sizes[a]
        if not (dim >= size and dim % size == 0):
            ax = None
        elif len(axes) == 1:
            ax = axes[0]
        out.append(ax)
    return tuple(out)

