"""Counters inside the program: how often a path ran, beside the spans.

`GraphCounts` counts, for one model, the decode megasteps that captured a
CUDA graph and those that replayed one (``models.decode_graph``). Each
``Model`` holds its own (``Model.decode_graph.counts``), so two models in
one process count apart. A counter is a plain integer,
always on: adding to it costs what adding to ``kernels.build.launches``
costs. Nothing here is written out, and nothing the engine reports
(``EngineStats``) reads it.

`take_expert_reads` reads the tally that the grouped MoE kernel keeps on
the card (``kernels.moe_experts.tally``): one thread of the kernel adds
to it, so it counts replayed CUDA graphs too, and costs no launch.
Reading it waits for the device.
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


def take_expert_reads(device="cuda") -> dict[str, int]:
    """The grouped MoE kernel's tally on ``device`` since the last call,
    then it starts again from 0: ``read``, the experts whose weights the
    calls read, and ``offered``, E for each call (read / offered is the
    experts-read share). Synchronises with the device."""
    from repro_torch.kernels import moe_experts
    tally = moe_experts.tally(device)
    read, offered = tally.tolist()
    tally.zero_()
    return {"read": read, "offered": offered}
