"""Decoder blocks and run utilities (``KIND_ATTN`` layers).

A "run" is a maximal stretch of layers of one repeating pattern, split
additionally at the probe tap so the tap always ends a run. The reference
scans each run's stacked parameters; here each layer is its own
``nn.Module`` and the runs only shape the cache, whose per-run leaves are
stacked along a leading layer axis as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import KIND_ATTN, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_norm, cdtype, gated_mlp, pdtype

MAX_PATTERN = 8          # longest repeating block grouped as one run


def _segment_runs(kinds: tuple[str, ...]) -> list[tuple[tuple[str, ...], int]]:
    """Greedy periodic decomposition of one segment into (pattern, n_blocks)."""
    runs: list[tuple[tuple[str, ...], int]] = []
    i = 0
    n = len(kinds)
    while i < n:
        best_p, best_cover = 1, 1
        for p in range(1, min(MAX_PATTERN, n - i) + 1):
            pat = kinds[i:i + p]
            nb = 1
            while kinds[i + nb * p:i + (nb + 1) * p] == pat:
                nb += 1
            cover = nb * p
            # multi-layer patterns must actually repeat, else p=1 runs win
            if cover > best_cover and (p == 1 or nb >= 2):
                best_p, best_cover = p, cover
        nb = best_cover // best_p
        runs.append((tuple(kinds[i:i + best_p]), nb))
        i += best_cover
    return runs


def split_runs(cfg: ModelConfig) -> tuple[tuple[tuple[str, ...], int], ...]:
    """Periodic-pattern runs, split so tap_layer ends a segment."""
    tap = cfg.probe.tap_layer
    seg1 = cfg.layer_kinds[:tap + 1]
    seg2 = cfg.layer_kinds[tap + 1:]
    runs = _segment_runs(seg1)
    if seg2:
        runs += _segment_runs(seg2)
    return tuple(runs)


def run_layers(run) -> int:
    """Total layer count of one (kinds, n_blocks) run."""
    kinds, nb = run
    return len(kinds) * nb


def tap_run_index(cfg: ModelConfig) -> int:
    """Index of the run whose last layer is the probe tap."""
    runs = split_runs(cfg)
    n = 0
    for ri, run in enumerate(runs):
        n += run_layers(run)
        if n - 1 >= cfg.probe.tap_layer:
            return ri
    return len(runs) - 1


def layer_slots(cfg: ModelConfig) -> list[tuple[int, int, int]]:
    """(run, pattern position, block) of every layer, in layer order."""
    slots = []
    for ri, (kinds, nb) in enumerate(split_runs(cfg)):
        for i in range(nb):
            for j in range(len(kinds)):
                slots.append((ri, j, i))
    return slots


class Block(nn.Module):
    """One ``KIND_ATTN`` decoder block: RMSNorm, GQA attention, gated MLP.

    Matmul weights are held in the compute dtype, norm scales in the
    parameter dtype. Parameters are created empty; ``Model.init`` or
    ``load_state_dict`` fills them.
    """

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
        cd, pd = cdtype(cfg), pdtype(cfg)

        def param(*shape, dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.norm1 = param(d, dtype=pd)
        self.wq = param(d, qd, dtype=cd)
        self.wk = param(d, kvd, dtype=cd)
        self.wv = param(d, kvd, dtype=cd)
        self.wo = param(qd, d, dtype=cd)
        if cfg.qkv_bias:
            self.bq = param(qd, dtype=cd)
            self.bk = param(kvd, dtype=cd)
            self.bv = param(kvd, dtype=cd)
        self.norm2 = param(d, dtype=pd)
        self.w_gate = param(d, ff, dtype=cd)
        self.w_up = param(d, ff, dtype=cd)
        self.w_down = param(ff, d, dtype=cd)


def block_cached(cfg: ModelConfig, kind: str, p: Block, h, cache_l, q_pos,
                 block_table):
    """Cached-path block (prefill chunk or decode). Returns (h, cache_l).

    h: (B,S,d); q_pos: (B,S) absolute positions (-1 = inactive slot);
    cache_l holds this layer's paged K/V, updated in place.
    """
    if kind != KIND_ATTN:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    if "pk" not in cache_l:
        raise NotImplementedError("only the paged KV layout is ported")
    hn = apply_norm(cfg, p.norm1, h)
    a, cache_l = attn.self_attention_paged(cfg, p, hn, cache_l, q_pos,
                                           block_table)
    h = h + a
    return h + gated_mlp(apply_norm(cfg, p.norm2, h), p.w_gate, p.w_up,
                         p.w_down), cache_l


def init_run_cache(cfg: ModelConfig, kind: str, n_layers: int,
                   num_pages: int, page_size: int, device="cuda") -> dict:
    """Allocate the paged KV cache of one homogeneous layer run."""
    if kind != KIND_ATTN:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    return attn.init_paged_kv_cache(cfg, num_pages, page_size, n_layers,
                                    device=device)
