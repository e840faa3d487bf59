"""Device meshes as plain descriptions (the reference ``repro.launch.mesh``).

The port runs on one card and has no multi-device runtime, so a mesh here
is what the sharding rules and the dry run read: axis names, their sizes
and the kind of chip. It holds no devices and needs none.

Single pod: (data=16, model=16) = 256 TPU v5e chips. Multi-pod: (pod=2,
data=16, model=16) = 512 chips -- the pod axis is pure data parallelism.
The host mesh is the one H100 the port runs on, (data=1, model=1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.launch.analysis import H100, TPU_V5E, Chip

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


@dataclass(frozen=True)
class Mesh:
    """A named grid of devices: ``axis_names`` with their ``axis_sizes``,
    all of one ``chip``."""

    name: str
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    chip: Chip

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape`` reads."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Total device count."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's (data, model) single-pod or (pod, data, model)
    multi-pod TPU v5e mesh."""
    if multi_pod:
        return Mesh("2x16x16", ("pod", "data", "model"), MULTI_POD, TPU_V5E)
    return Mesh("16x16", ("data", "model"), SINGLE_POD, TPU_V5E)


def make_host_mesh() -> Mesh:
    """The one card: a 1x1 (data, model) mesh of an H100."""
    return Mesh("h100", ("data", "model"), (1, 1), H100)


MESHES = {"h100": make_host_mesh,
          "16x16": make_production_mesh,
          "2x16x16": lambda: make_production_mesh(multi_pod=True)}


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The batch-sharding axes for this mesh ((pod,data) or (data,))."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def n_chips(mesh: Mesh) -> int:
    """Total device count of a mesh."""
    return mesh.size
