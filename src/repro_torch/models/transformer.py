"""Decoder blocks and run utilities (attention, sliding-window attention,
mixture-of-experts, Mamba-2 SSM and hybrid layers, and whisper's
cross-attention).

A "run" is a maximal stretch of layers of one repeating pattern, split
additionally at the probe tap so the tap always ends a run. The reference
scans each run's stacked parameters; here each layer is its own
``nn.Module`` and the runs only shape the cache, whose per-run leaves are
stacked along a leading layer axis as in the reference.
"""

from __future__ import annotations

import types

import torch
from torch import nn

from repro_torch.config import (FAMILY_AUDIO, KIND_ATTN, KIND_HYBRID,
                                KIND_LOCAL, KIND_MOE, KIND_SSM, KIND_SSM_MOE,
                                MOE_KINDS, SSM_KINDS, ModelConfig)
from repro_torch.metrics.spans import detail, span
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_norm, cdtype, gated_mlp,
                                       gelu_mlp, pdtype, residual)

MAX_PATTERN = 8          # longest repeating block grouped as one run
PORTED_KINDS = (KIND_ATTN, KIND_LOCAL, KIND_SSM, KIND_HYBRID, KIND_MOE,
                KIND_SSM_MOE)
CROSS_NAMES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


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


def _kind_window(cfg: ModelConfig, kind: str) -> int:
    """Attention window of a layer kind (0 = global attention); hybrid
    layers' attention heads use the sliding window (hymba's SWA heads)."""
    return cfg.sliding_window if kind in (KIND_LOCAL, KIND_HYBRID) else 0


def _param(*shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _add_ssm_params(m: nn.Module, cfg: ModelConfig, device) -> None:
    """The Mamba-2 mixer's weights, under the reference's names: the two
    projections in the compute dtype (matmul weights); the conv, dt bias,
    D and the gated norm's scale in the parameter dtype and ``A_log`` in
    float32, as the reference uses them."""
    d = cfg.d_model
    d_in, nh, conv_ch = ssm_mod.ssm_dims(cfg)
    cd, pd = cdtype(cfg), pdtype(cfg)
    m.in_proj = _param(d, 2 * d_in + (conv_ch - d_in) + nh, dtype=cd,
                       device=device)
    m.out_proj = _param(d_in, d, dtype=cd, device=device)
    m.conv_w = _param(cfg.ssm_conv, conv_ch, dtype=pd, device=device)
    m.conv_b = _param(conv_ch, dtype=pd, device=device)
    m.dt_bias = _param(nh, dtype=pd, device=device)
    m.A_log = _param(nh, dtype=torch.float32, device=device)
    m.D = _param(nh, dtype=pd, device=device)
    m.norm_scale = _param(d_in, dtype=pd, device=device)


class SSMBlock(nn.Module):
    """One ``KIND_SSM`` block: RMSNorm, then the Mamba-2 mixer (no MLP;
    the mixer has its own gating). Parameters are created empty."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.norm1 = _param(cfg.d_model, dtype=pdtype(cfg), device=device)
        _add_ssm_params(self, cfg, device)


class Block(nn.Module):
    """One decoder block: norm, attention, MLP.

    ``KIND_ATTN`` and ``KIND_LOCAL`` blocks hold the same parameters; a
    local block attends within the config's sliding window. A
    ``KIND_HYBRID`` block (hymba) adds a Mamba-2 mixer that reads the same
    normed input as its windowed attention. A ``KIND_MOE`` block holds the
    router and the stacked experts (``moe_router``, ``moe_w_gate``,
    ``moe_w_up``, ``moe_w_down``) in place of the MLP, and beside them the
    dense MLP under ``cfg.moe_dense_residual`` (arctic) or the shared
    expert under ``cfg.shared_expert_ff`` (``shared_w_gate``,
    ``shared_w_up``, ``shared_w_down``; granite-4.0-h). A
    ``KIND_SSM_MOE`` block (granite-4.0-h) has a Mamba-2 mixer in place of
    attention, then the MoE of a ``KIND_MOE`` block. The audio family
    (whisper) has LayerNorms (a ``<norm>_bias`` beside each scale) and the
    biased GELU MLP (``w_up``, ``b_up``, ``w_down``, ``b_down``); with
    ``cross`` a decoder block adds cross-attention over the encoder
    (``cross_wq`` ... ``cross_wo`` and ``norm_cross``).

    Matmul weights and the biases added to their products are held in the
    compute dtype; norms, the router and the rest in the parameter dtype.
    Parameters are created empty; ``Model.init`` or ``load_state_dict``
    fills them.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", kind=KIND_ATTN,
                 cross: bool = False):
        super().__init__()
        d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
        cd, pd = cdtype(cfg), pdtype(cfg)
        audio = cfg.family == FAMILY_AUDIO

        def param(*shape, dtype):
            return _param(*shape, dtype=dtype, device=device)

        def norm(name):
            setattr(self, name, param(d, dtype=pd))
            if audio:
                setattr(self, name + "_bias", param(d, dtype=pd))

        def projections(prefix):
            for name, shape in (("wq", (d, qd)), ("wk", (d, kvd)),
                                ("wv", (d, kvd)), ("wo", (qd, d))):
                setattr(self, prefix + name, param(*shape, dtype=cd))
            if cfg.qkv_bias:
                for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
                    setattr(self, prefix + name, param(n, dtype=cd))

        norm("norm1")
        if kind != KIND_SSM_MOE:
            projections("")
        norm("norm2")
        if kind in MOE_KINDS:
            E = cfg.num_experts
            self.moe_router = param(d, E, dtype=pd)
            self.moe_w_gate = param(E, d, ff, dtype=cd)
            self.moe_w_up = param(E, d, ff, dtype=cd)
            self.moe_w_down = param(E, ff, d, dtype=cd)
            if cfg.shared_expert_ff:
                sf = cfg.shared_expert_ff
                self.shared_w_gate = param(d, sf, dtype=cd)
                self.shared_w_up = param(d, sf, dtype=cd)
                self.shared_w_down = param(sf, d, dtype=cd)
        if audio:
            self.w_up = param(d, ff, dtype=cd)
            self.b_up = param(ff, dtype=cd)
            self.w_down = param(ff, d, dtype=cd)
            self.b_down = param(d, dtype=cd)
        elif kind not in MOE_KINDS or cfg.moe_dense_residual:
            self.w_gate = param(d, ff, dtype=cd)
            self.w_up = param(d, ff, dtype=cd)
            self.w_down = param(ff, d, dtype=cd)
        if kind in (KIND_HYBRID, KIND_SSM_MOE):
            _add_ssm_params(self, cfg, device)
        if cross:
            projections("cross_")
            norm("norm_cross")


def make_block(cfg: ModelConfig, kind: str, device="cuda",
               cross: bool = False) -> nn.Module:
    """The empty block of a layer kind (``cross``: with cross-attention)."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    if kind == KIND_SSM:
        return SSMBlock(cfg, device)
    return Block(cfg, device, kind=kind, cross=cross)


def norm(cfg: ModelConfig, p, name: str, x):
    """Apply the norm ``name`` of ``p`` (with its ``<name>_bias`` under the
    audio family's LayerNorm)."""
    bias = getattr(p, name + "_bias") if cfg.family == FAMILY_AUDIO else None
    return apply_norm(cfg, getattr(p, name), x, bias)


def mlp(cfg: ModelConfig, p, x):
    """The dense MLP of ``p``: biased GELU for the audio family, gated
    SiLU otherwise."""
    if cfg.family == FAMILY_AUDIO:
        return gelu_mlp(x, p.w_up, p.b_up, p.w_down, p.b_down)
    return gated_mlp(x, p.w_gate, p.w_up, p.w_down)


def cross_weights(p):
    """Block ``p``'s cross-attention projections under their plain names
    (``wq`` ... ``bv``), as ``attention.cross_kv``/``cross_attention``
    take them."""
    return types.SimpleNamespace(**{
        name: getattr(p, "cross_" + name) for name in CROSS_NAMES
        if hasattr(p, "cross_" + name)})


def _mlp_part(cfg: ModelConfig, kind: str, p, h, live=None):
    """Post-attention feed-forward: the dense MLP, or the MoE (with the
    shared expert under ``shared_expert_ff``; plus the dense MLP on the
    same normed input under ``moe_dense_residual``). ``live`` (B,S) marks
    the positions that hold a token (the cached path; None: all), which a
    dropless MoE routes alone. Returns (delta, router aux loss; the number
    0 without MoE, so that the cached path, which drops it, launches
    nothing for it)."""
    hn = norm(cfg, p, "norm2", h)
    if kind in MOE_KINDS:
        y, aux = moe_mod.moe_mlp(cfg, p, hn, live=live)
        if cfg.moe_dense_residual:
            y = y + mlp(cfg, p, hn)
        return y, aux
    return mlp(cfg, p, hn), 0.0


def block_train(cfg: ModelConfig, kind: str, p, h, enc_out=None,
                causal: bool = True):
    """Training-path block (no cache): self-attention over the whole
    sequence (and, in a hybrid block, the SSM mixer on the same normed
    input, averaged with it), cross-attention over ``enc_out`` when it is
    given and the block has it, then the MLP or MoE; an SSM block is the
    mixer alone. h: (B,S,d) -> (h, router aux loss). ``causal`` is off in
    the whisper encoder's blocks. ``p`` is a block or any object holding
    its weights as attributes. Each residual branch is scaled by
    ``cfg.residual_multiplier`` (``layers.residual``)."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    hn = norm(cfg, p, "norm1", h)
    if kind == KIND_SSM:
        return residual(cfg, h, ssm_mod.ssm_forward(cfg, p, hn)[0]), 0.0
    if kind == KIND_SSM_MOE:
        a = ssm_mod.ssm_forward(cfg, p, hn)[0]
    else:
        a = attn.self_attention_full(cfg, p, hn,
                                     window=_kind_window(cfg, kind),
                                     causal=causal)
    if kind == KIND_HYBRID:
        a = 0.5 * (a + ssm_mod.ssm_forward(cfg, p, hn)[0])
    h = residual(cfg, h, a)
    if enc_out is not None and hasattr(p, "cross_wq"):
        cw = cross_weights(p)
        ck, cv = attn.cross_kv(cfg, cw, enc_out)
        h = residual(cfg, h, attn.cross_attention(
            cfg, cw, norm(cfg, p, "norm_cross", h), ck, cv))
    y, aux = _mlp_part(cfg, kind, p, h)
    return residual(cfg, h, y), aux


def _ssm_cached(cfg: ModelConfig, p, hn, cache_l, q_pos, decode: bool):
    """The SSM mixer of one cached layer; its state and conv buffer are
    updated in place. A prefill chunk advances each row by its valid
    tokens only (``ssm_forward`` with ``q_pos``); a decode step updates
    the state of the rows that hold a token in place and leaves inactive
    rows' state and conv buffer as they were. Spans: ``model.ssm``
    (detail) around the mixer, and ``model.ssm_prefill`` (the engine's
    level) around a prefill chunk's."""
    if decode:
        with detail("model.ssm"):
            keep = q_pos[:, 0] >= 0
            y, (_, cb) = ssm_mod.ssm_decode_step(
                cfg, p, hn, cache_l["ssm_state"], cache_l["conv_buf"],
                keep=keep)
            ssm_mod.update_state(cache_l, None, cb, keep=keep)
        return y
    with span("model.ssm_prefill"), detail("model.ssm"):
        y, (st, cb) = ssm_mod.ssm_forward(
            cfg, p, hn, cache_l["ssm_state"], cache_l["conv_buf"],
            q_pos=q_pos)
        ssm_mod.update_state(cache_l, st, cb)
    return y


def block_cached(cfg: ModelConfig, kind: str, p, h, cache_l, q_pos,
                 block_table=None, decode: bool = False):
    """Cached-path block (prefill chunk or decode). Returns (h, cache_l).

    h: (B,S,d); q_pos: (B,S) absolute positions (-1 = inactive slot);
    cache_l holds this layer's state, updated in place: a paged K/V leaf
    set (``pk``/``pv``/``pkpos``, read through ``block_table``) or a slot
    cache (``k``/``v``/``kpos``, a ring for windowed layers), and for SSM
    and hybrid layers ``ssm_state``/``conv_buf``, and for cross-attention
    layers the encoder's ``ck``/``cv`` (read only). ``decode`` (S=1) takes
    the SSM's recurrent step instead of the chunked scan. A dropless MoE
    routes only the positions where q_pos >= 0 (a dead position's routed
    output is 0, which no caller reads); its router aux loss is dropped,
    as the reference's cached path drops it. Each
    residual branch is scaled by ``cfg.residual_multiplier``.
    """
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    if kind in (KIND_SSM, KIND_SSM_MOE):
        hn = norm(cfg, p, "norm1", h)
        h = residual(cfg, h, _ssm_cached(cfg, p, hn, cache_l, q_pos, decode))
        if kind == KIND_SSM:
            return h, cache_l
        with detail("model.mlp"):
            return residual(cfg, h, _mlp_part(cfg, kind, p, h,
                                              q_pos >= 0)[0]), cache_l
    with detail("model.attention"):
        hn = norm(cfg, p, "norm1", h)
        if "pk" in cache_l:
            a, cache_l = attn.self_attention_paged(cfg, p, hn, cache_l,
                                                   q_pos, block_table)
        else:
            a, cache_l = attn.self_attention_cached(
                cfg, p, hn, cache_l, q_pos, window=_kind_window(cfg, kind))
        if kind == KIND_HYBRID:
            a = 0.5 * (a + _ssm_cached(cfg, p, hn, cache_l, q_pos, decode))
        h = residual(cfg, h, a)
        if "ck" in cache_l and hasattr(p, "cross_wq"):
            h = residual(cfg, h, attn.cross_attention(
                cfg, cross_weights(p), norm(cfg, p, "norm_cross", h),
                cache_l["ck"], cache_l["cv"]))
    with detail("model.mlp"):
        return residual(cfg, h, _mlp_part(cfg, kind, p, h,
                                          q_pos >= 0)[0]), cache_l


def init_run_cache(cfg: ModelConfig, kind: str, n_layers: int, batch: int,
                   max_len: int, enc_seq: int = 0, kv_layout: str = "contig",
                   num_pages: int = 0, page_size: int = 0,
                   device="cuda") -> dict:
    """Allocate the cache of one homogeneous layer run: K/V for attention
    layers, SSM state and conv buffer for SSM layers, both for hybrid ones,
    and with cross-attention the encoder's K/V (``ck``/``cv``, (n_layers,
    batch, enc_seq, KH, hd), zeros until ``Model.build_cross_cache`` fills
    them).

    Windowed runs keep their ring slots even under ``kv_layout="paged"``:
    they are already bounded at the window, so paging buys nothing.
    """
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    cache: dict = {}
    window = _kind_window(cfg, kind)
    if kind not in (KIND_SSM, KIND_SSM_MOE):
        if kv_layout == "paged" and not window:
            cache.update(attn.init_paged_kv_cache(
                cfg, num_pages, page_size, n_layers, device=device))
        else:
            cache.update(attn.init_kv_cache(cfg, batch, max_len, n_layers,
                                            window=window, device=device))
    if kind in SSM_KINDS:
        cache.update(ssm_mod.init_ssm_state(cfg, batch, n_layers,
                                            device=device))
    if cfg.cross_attention and enc_seq:
        cache["ck"] = torch.zeros((n_layers, batch, enc_seq, cfg.num_kv_heads,
                                   cfg.head_dim), dtype=cdtype(cfg),
                                  device=device)
        cache["cv"] = torch.zeros_like(cache["ck"])
    return cache
