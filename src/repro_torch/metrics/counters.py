"""Counters inside the program: how often a path ran, beside the spans.

`GraphCounts` counts, for one model, the decode megasteps that captured a
CUDA graph and those that replayed one (``models.decode_graph``). Each
``Model`` holds its own (``Model.decode_graph.counts``), so two models in
one process count apart. A counter is a plain integer,
always on: adding to it costs what adding to ``kernels.build.launches``
costs. Nothing here is written out, and nothing the engine reports
(``EngineStats``) reads it.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class GraphCounts:
    """The decode megasteps of one model: ``captures`` ran eagerly and
    captured a graph; ``replays`` replayed one."""

    captures: int = 0
    replays: int = 0

    def take(self) -> dict[str, int]:
        """The counts since the last call, then they start again from 0."""
        out = {"captures": self.captures, "replays": self.replays}
        self.captures = self.replays = 0
        return out
