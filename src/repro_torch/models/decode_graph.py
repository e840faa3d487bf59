"""The decode megastep as one CUDA graph.

On the card, an eager ``Model.decode_multi`` enqueues 9,500-14,600 small
launches a megastep (granite-3-8b and olmoe-1b-7b at 64 rows and k = 4:
the k decode steps of every layer, the probe head, the argmax, the softmax
and the halting logic), and the host takes longer to enqueue them than the
card to run them. `MegastepGraph` captures the whole megastep once as a
``torch.cuda.CUDAGraph`` and replays it on every later call with the same
key: one launch in place of thousands, the same kernels in the same order
on the same data, so the same bits.

A graph reads and writes the addresses it was captured with. Hence:

* The key (`graph_key`) holds B, k, ``eos_id``, the shape and dtype of
  ``tokens``, ``active``, ``budget`` and ``cache["lengths"]``, and the
  identity (address, shape, strides, dtype, device) of every other tensor
  of the cache: pages and ``pkpos``, the block table, slot caches with
  their ``kpos`` and int8 scales, SSM state and conv buffer, cross caches.
  Those are updated in place (or only read), so they stay where they are
  from call to call. A call with another key captures anew; the old graph
  is dropped first, so memory does not grow with recaptures.
* ``tokens``, ``active``, ``budget`` and ``cache["lengths"]`` (which the
  megastep and the prefill reassign rather than update) are copied into
  the graph's own input buffers before each replay.
* After a replay the outputs and the new ``lengths`` are copied out of
  the graph's buffers: the caller holds tensors of its own, as after an
  eager call, and may write ``lengths`` in place (the KV pool's resets).
* The weights are read where they lie: update them in place (``copy_``,
  ``load_state_dict``); a parameter rebound to another tensor after a
  megastep has run on the card is not seen.

A capture runs this call's megastep eagerly on a side stream first (the
warm-up that capture needs: cuBLAS's workspace for that stream, each
kernel library loaded and its launch plan cached) and returns its result;
the capture that follows enqueues nothing. The kernel bindings count the
captured launches in ``kernels.build.launches`` though none ran: the
counts are taken back, and added again at each replay, so that they stay
those of the kernels that ran. The capture is timed by the span
``model.graph_capture``; ``MegastepGraph.counts`` (a
``metrics.counters.GraphCounts``) counts captures and replays.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.metrics.counters import GraphCounts
from repro_torch.metrics.spans import span


def _sig(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


def _ident(t: torch.Tensor) -> tuple:
    return t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device


def _leaves(path: tuple, node, out: list) -> None:
    if isinstance(node, torch.Tensor):
        out.append((path, _ident(node)))
    elif isinstance(node, dict):
        for name, sub in node.items():
            _leaves(path + (name,), sub, out)
    elif isinstance(node, (tuple, list)):
        for i, sub in enumerate(node):
            _leaves(path + (i,), sub, out)


def graph_key(cache: dict, tokens, active, budget, k: int,
              eos_id: int) -> tuple:
    """What a captured megastep is bound to (see the module docstring):
    equal keys replay one graph."""
    leaves: list = []
    for name, node in cache.items():
        if name != "lengths":
            _leaves((name,), node, leaves)
    return (tokens.shape[0], k, eos_id, _sig(tokens), _sig(active),
            _sig(budget), _sig(cache["lengths"]), tuple(leaves))


class MegastepGraph:
    """The captured megastep of one model, with its key, its input and
    output buffers, the launches it makes, and the model's counts of
    captures and replays."""

    def __init__(self):
        self.counts = GraphCounts()
        self.key = None
        self.graph = None
        self.inputs = ()        # tokens, active, budget, lengths
        self.outputs = ()       # tokens, probe probs, n_emitted, lengths
        self.launches: dict[str, int] = {}
        self.stream = None

    def run(self, body, cache: dict, tokens, active, budget, k: int,
            eos_id: int):
        """``body(cache, tokens, active, budget, k, eos_id)`` (the eager
        megastep) through the graph: replayed if the key matches, else run
        once and captured. Returns what ``body`` returns."""
        key = graph_key(cache, tokens, active, budget, k, eos_id)
        if key != self.key:
            with span("model.graph_capture"):
                out = self._capture(key, body, cache,
                                    (tokens, active, budget), k, eos_id)
            self.counts.captures += 1
            return out
        for buf, x in zip(self.inputs, (tokens, active, budget,
                                        cache["lengths"])):
            buf.copy_(x)
        self.graph.replay()
        for name, n in self.launches.items():
            build.launches[name] += n
        self.counts.replays += 1
        toks, probs, emitted, lengths = (t.clone() for t in self.outputs)
        cache["lengths"] = lengths
        return toks, cache, probs, emitted

    def _capture(self, key, body, cache, inputs, k, eos_id):
        self.key = self.graph = None            # drop the old graph first
        self.inputs = self.outputs = ()
        dev = inputs[0].device
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        side, cur = self.stream, torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = body(cache, *inputs, k, eos_id)      # the warm-up
        cur.wait_stream(side)
        lengths = cache["lengths"]
        static = tuple(x.clone() for x in (*inputs, lengths))
        before = dict(build.launches)
        graph = torch.cuda.CUDAGraph()
        try:
            cache["lengths"] = static[3]
            with torch.cuda.graph(graph, stream=side):
                toks, _, probs, emitted = body(cache, *static[:3], k, eos_id)
            outputs = (toks, probs, emitted, cache["lengths"])
        finally:
            cache["lengths"] = lengths
            captured = {n: c - before[n] for n, c in build.launches.items()}
            build.launches.update(before)
        self.key, self.graph = key, graph
        self.inputs, self.outputs = static, outputs
        self.launches = {n: c for n, c in captured.items() if c}
        return out
