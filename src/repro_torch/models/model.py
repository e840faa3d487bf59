"""The model: a decoder (GQA attention, Mamba-2 SSM or hybrid layers) with
the fused TRAIL probe.

``Model(cfg, device=...)`` is an ``nn.Module`` with one ``Block`` per layer
and exposes the forward passes of the reference
``repro.models.model.Model``:

  init(seed)                               -> fills the parameters
  init_params(seed)                        -> the same values as a dict of
                                              float32 tensors (training masters)
  forward_train(batch)                     -> (loss, {"aux_loss", "tap", "n_tok"})
  forward_all_taps(batch)                  -> hidden states after every layer
  init_cache(batch, max_len, kv_layout)    -> cache dict ("contig" slot
                                              caches or "paged" KV pool)
  prefill_chunk(cache, tokens, valid)      -> (logits_last, cache, tap_sum, n_new)
  decode_step(cache, tokens, active)       -> (logits, cache, tap, probe_logits)
  decode_multi(cache, tokens, active, budget, k=, eos_id=)
                                           -> (tokens, cache, probe_probs, n_emitted)

The parameters live on the model, so no method takes them; training runs
``forward_train`` (the module's ``forward``) through
``torch.func.functional_call`` with float32 masters in their place. The
cache is updated in place and also returned. Global (``KIND_ATTN``),
sliding-window (``KIND_LOCAL``), Mamba-2 (``KIND_SSM``) and hybrid
(``KIND_HYBRID``) stacks are ported, with learned positions, so the gemma,
mamba2 and hymba configs run; MoE layers, ``kv_quant``, cross-attention
and prefix embeds raise ``NotImplementedError``. The SSM layers' gradient
comes from ``models.ssm.SSDScan``: the scan kernel runs forward, and the
backward differentiates its plain version, on the card as on the CPU.

``params_from_jax`` and ``load_npz`` bring the reference package's weights
across (as numpy arrays or from its ``.npz`` checkpoint format) without
importing JAX; ``params_to_jax`` is the way back.
"""

from __future__ import annotations

import types

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import KIND_HYBRID, KIND_SSM, ModelConfig
from repro_torch.core import predictor
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_norm, embed_tokens, pdtype,
                                       unembed)
from repro_torch.training.checkpoint import load_npz  # noqa: F401 (re-export)

MAX_LEARNED_POS = 32768     # rows of the learned-position table


def _check_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.layer_kinds) - set(tfm.PORTED_KINDS)
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)} are not ported (only "
            f"{', '.join(tfm.PORTED_KINDS)})")
    if cfg.kv_quant:
        raise NotImplementedError(f"{cfg.name}: kv_quant is not ported")
    if cfg.cross_attention or cfg.num_encoder_layers:
        raise NotImplementedError(f"{cfg.name}: cross-attention is not ported")
    if cfg.num_prefix_tokens:
        raise NotImplementedError(f"{cfg.name}: prefix embeds are not ported")
    if cfg.family == "audio":
        raise NotImplementedError(f"{cfg.name}: LayerNorm is not ported")


class Model(nn.Module):
    """Cached forward passes over one ``ModelConfig`` (see module docstring).

    Decode attention (both layouts), paged prefill attention and the SSM
    layers' chunked scan go through ``repro_torch.kernels.ops``: the CUDA
    kernels for tensors on the card, their plain versions on the CPU.
    """

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.runs = tfm.split_runs(cfg)
        self.tap_layer = cfg.probe.tap_layer
        self.slots = tfm.layer_slots(cfg)
        d, V, pd = cfg.d_model, cfg.vocab_size, pdtype(cfg)

        def param(*shape, dtype=torch.float32):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=self.device),
                                requires_grad=False)

        self.embed = param(V, d, dtype=pd)
        if not cfg.tie_embeddings:
            self.unembed = param(V, d, dtype=pd)
        if not cfg.use_rope:        # learned positions
            self.pos_embed = param(MAX_LEARNED_POS, d, dtype=pd)
        self.final_norm = param(d, dtype=pd)
        self.layers = nn.ModuleList(tfm.make_block(cfg, kind, self.device)
                                    for kind in cfg.layer_kinds)
        pc = cfg.probe
        self.probe = nn.ParameterDict({
            "w1": param(d, pc.hidden), "b1": param(pc.hidden),
            "w2": param(pc.hidden, pc.num_bins), "b2": param(pc.num_bins)})

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    def _init_values(self, seed: int):
        """(name, float32 value) of every parameter, drawn in a fixed order
        from one seeded generator on the model's device.

        The distributions are the reference's (``model.py`` init): embedding
        and learned-position rows N(0, 0.02^2); projections N(0, 1/fan_in)
        with ``wo``, ``w_down`` and the SSM's ``out_proj`` at their own
        fan-in; the SSM's ``conv_w`` N(0, 1/W), its ``D`` ones and its
        ``conv_b``, ``dt_bias``, ``A_log`` and ``norm_scale`` zeros; zero
        norm gains and biases; probe weights N(0, 1/fan_in).
        """
        cfg = self.cfg
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = dict(self.named_parameters())

        def normal(name, scale):
            return name, torch.randn(params[name].shape, generator=gen,
                                     dtype=torch.float32, device=dev) * scale

        def zeros(name):
            return name, torch.zeros(params[name].shape, dtype=torch.float32,
                                     device=dev)

        yield normal("embed", 0.02)
        if not cfg.tie_embeddings:
            yield normal("unembed", 0.02)
        if not cfg.use_rope:
            yield normal("pos_embed", 0.02)
        yield zeros("final_norm")
        d, qd, ff = cfg.d_model, cfg.q_dim, cfg.d_ff
        d_in = cfg.ssm_expand * d
        for li, kind in enumerate(cfg.layer_kinds):
            pre = f"layers.{li}."
            yield zeros(pre + "norm1")
            if kind in (KIND_SSM, KIND_HYBRID):
                yield normal(pre + "in_proj", d ** -0.5)
                yield normal(pre + "out_proj", d_in ** -0.5)
                yield normal(pre + "conv_w", cfg.ssm_conv ** -0.5)
                for name in ("conv_b", "dt_bias", "A_log", "norm_scale"):
                    yield zeros(pre + name)
                yield pre + "D", torch.ones(params[pre + "D"].shape,
                                            dtype=torch.float32, device=dev)
            if kind == KIND_SSM:
                continue
            yield zeros(pre + "norm2")
            for w in ("wq", "wk", "wv", "w_gate", "w_up"):
                yield normal(pre + w, d ** -0.5)
            yield normal(pre + "wo", qd ** -0.5)
            yield normal(pre + "w_down", ff ** -0.5)
            if cfg.qkv_bias:
                for b in ("bq", "bk", "bv"):
                    yield zeros(pre + b)
        probe = predictor.init_probe(gen, d, cfg.probe, device=dev)
        for name, value in probe.items():
            yield f"probe.{name}", value

    @torch.no_grad()
    def init(self, seed: int = 0) -> "Model":
        """Fill every parameter from a seeded generator (see
        ``_init_values``); values are drawn in float32 and stored in each
        parameter's dtype. Returns the model."""
        params = dict(self.named_parameters())
        for name, value in self._init_values(seed):
            params[name].copy_(value)
        return self

    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """The values ``init(seed)`` stores, as float32 tensors keyed like
        the state dict: the master weights that training updates."""
        return dict(self._init_values(seed))

    # ------------------------------------------------------------------
    # Training forward (full sequences, no cache)
    # ------------------------------------------------------------------
    def _block_weights(self, li: int):
        """Layer ``li``'s weights as they are now (the masters inside
        ``functional_call``). A checkpointed block is recomputed in the
        backward, after ``functional_call`` has put the module's own
        parameters back, so it is handed the tensors themselves."""
        return types.SimpleNamespace(**dict(
            self.layers[li].named_parameters()))

    def _embed(self, tokens, positions):
        """Token rows in the compute dtype, plus the learned position rows
        (positions clipped to the table) where the config has no RoPE."""
        h = embed_tokens(self.cfg, self.embed, tokens)
        if not self.cfg.use_rope:
            idx = positions.clamp(0, self.pos_embed.shape[0] - 1).long()
            h = h + self.pos_embed[idx].to(h.dtype)
        return h

    def _train_trunk(self, tokens):
        """Yield the hidden state after every layer (B,S,d), train-path
        semantics: causal attention over positions 0..S-1."""
        cfg = self.cfg
        S = tokens.shape[1]
        h = self._embed(tokens, torch.arange(S, device=tokens.device)
                        .expand(tokens.shape))
        remat = cfg.remat and torch.is_grad_enabled()
        for li, kind in enumerate(cfg.layer_kinds):
            w = self._block_weights(li)
            if remat:
                h = checkpoint(tfm.block_train, cfg, kind, w, h,
                               use_reentrant=False)
            else:
                h = tfm.block_train(cfg, kind, w, h)
            yield h

    def forward_train(self, batch: dict):
        """batch: {"tokens": (B,S), "labels": (B,S)} int (labels -1 where no
        loss is taken).

        Returns (loss, {"aux_loss", "tap" (B,S,d), "n_tok"}): the mean
        next-token cross-entropy over labels >= 0, the tap layer's hidden
        state and the number of such labels. With ``cfg.remat`` and grad
        on, each block is recomputed in the backward
        (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
        """
        if set(batch) - {"tokens", "labels"}:
            raise NotImplementedError(
                f"batch keys {sorted(set(batch) - {'tokens', 'labels'})} "
                "(prefix or encoder embeds) are not ported")
        tap = h = None
        for li, h in enumerate(self._train_trunk(batch["tokens"])):
            if li == self.tap_layer:
                tap = h
        h = apply_norm(self.cfg, self.final_norm, h)
        loss, n_tok = _chunked_ce(self.cfg, self._unembed_table(), h,
                                  batch["labels"])
        aux = {"aux_loss": torch.zeros((), device=loss.device), "tap": tap,
               "n_tok": n_tok}
        return loss, aux

    def forward(self, batch: dict):
        """The module call is the training forward (``forward_train``): it
        is what ``torch.func.functional_call`` runs with the masters."""
        return self.forward_train(batch)

    def forward_all_taps(self, batch: dict):
        """Profiling pass (paper Section 3.1: embeddings of every layer):
        the hidden state after every layer, (num_layers, B, S, d), with
        train-path semantics and no loss."""
        return torch.stack(list(self._train_trunk(batch["tokens"])))

    # ------------------------------------------------------------------
    # Cache
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, kv_layout: str = "contig",
                   page_size: int = 16) -> dict:
        """The per-run KV caches of ``batch`` sequences of ``max_len`` tokens.

        ``contig``: one slot row per sequence and layer. ``paged``: the
        global-attention K/V in a shared page pool (1 null page + batch *
        ceil(max_len/page_size) pages) behind a (batch, pages_per_seq)
        block table. Windowed layers keep their ring slots under either.
        """
        if kv_layout not in ("contig", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        cache: dict = {"lengths": torch.zeros(batch, dtype=torch.int32,
                                              device=self.device)}
        num_pages = 0
        if kv_layout == "paged":
            pages_per_seq = -(-max_len // page_size)
            num_pages = 1 + batch * pages_per_seq      # page 0 = null page
            cache["block_table"] = torch.zeros(
                (batch, pages_per_seq), dtype=torch.int32, device=self.device)
        for ri, (kinds, nb) in enumerate(self.runs):
            cache[f"run_{ri}"] = tuple(
                tfm.init_run_cache(self.cfg, kind, nb, batch, max_len,
                                   kv_layout=kv_layout, num_pages=num_pages,
                                   page_size=page_size, device=self.device)
                for kind in kinds)
        return cache

    # ------------------------------------------------------------------
    # Cached forward (chunked prefill; decode is the S=1 case)
    # ------------------------------------------------------------------
    def _trunk(self, cache: dict, h, q_pos, decode: bool = False):
        cfg = self.cfg
        block_table = cache.get("block_table")   # present when some run is paged
        tap = None
        for li, (blk, (ri, j, i)) in enumerate(zip(self.layers, self.slots)):
            sub = cache[f"run_{ri}"][j]
            cache_l = {key: leaf[i] for key, leaf in sub.items()}
            h, _ = tfm.block_cached(cfg, cfg.layer_kinds[li], blk, h, cache_l,
                                    q_pos, block_table, decode=decode)
            if li == self.tap_layer:
                tap = h
        return h, tap

    def _unembed_table(self):
        return self.embed if self.cfg.tie_embeddings else self.unembed

    @torch.no_grad()
    def prefill_chunk(self, cache: dict, tokens, valid=None):
        """Process a chunk of prompt tokens for every active row.

        tokens: (B,C) int; valid: (B,C) bool (contiguous prefixes) or None.
        Returns (next_logits (B,V) f32, cache, tap_sum (B,d) f32,
        n_new (B,) int32).
        """
        cfg = self.cfg
        B, C = tokens.shape
        if valid is None:
            valid = torch.ones((B, C), dtype=torch.bool, device=tokens.device)
        offsets = cache["lengths"]
        q_pos = torch.where(
            valid, offsets[:, None] + torch.arange(C, dtype=torch.int32,
                                                   device=tokens.device), -1)
        h, tap = self._trunk(cache, self._embed(tokens, q_pos), q_pos)
        n_new = valid.sum(dim=1, dtype=torch.int32)
        cache["lengths"] = offsets + n_new

        # next-token logits from the last valid position of each row
        last_idx = (n_new - 1).clamp_min(0).long()
        h_last = h[torch.arange(B, device=h.device), last_idx]
        h_last = apply_norm(cfg, self.final_norm, h_last)
        logits = unembed(cfg, self._unembed_table(), h_last)

        # paper: prompt-phase probe input = mean of prompt-token taps
        tap_sum = (tap.float() * valid[..., None].float()).sum(dim=1)
        return logits, cache, tap_sum, n_new

    def _decode(self, cache: dict, tokens, active):
        """One decode step without the probe: (logits, cache, tap (B,d)).

        Inactive rows (q_pos -1) write no K/V, and their SSM state and conv
        buffer stay as they were: each SSM layer writes ``where(active,
        new, old)`` in place (the reference's ``_mask_recurrent``), on the
        device with no host sync."""
        cfg = self.cfg
        B = tokens.shape[0]
        if active is None:
            active = torch.ones(B, dtype=torch.bool, device=tokens.device)
        lengths = cache["lengths"]
        q_pos = torch.where(active, lengths, -1)[:, None]
        h, tap = self._trunk(cache, self._embed(tokens, q_pos), q_pos,
                             decode=True)
        cache["lengths"] = lengths + active.to(torch.int32)
        hn = apply_norm(cfg, self.final_norm, h[:, 0])
        return unembed(cfg, self._unembed_table(), hn), cache, tap[:, 0]

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens, active=None):
        """One iteration: generate-one-token for every active row.

        tokens: (B,1) int; active: (B,) bool. Fuses the probe classifier.
        Returns (logits (B,V) f32, cache, tap (B,d), probe_logits (B,k)).
        """
        logits, cache, tap = self._decode(cache, tokens, active)
        return logits, cache, tap, predictor.apply_probe(self.probe, tap)

    @torch.no_grad()
    def decode_multi(self, cache: dict, tokens, active=None, budget=None, *,
                     k: int = 1, eos_id: int = -1):
        """Decode megastep: ``k`` fused decode+probe steps with on-device
        greedy sampling and per-row halting, with no host synchronisation.

        tokens: (B,1) int — last known token per row; active: (B,) bool;
        budget: (B,) int — max tokens each row may still emit (rows halt on
        budget exhaustion or, when ``eos_id >= 0``, after emitting EOS;
        halted rows stop writing KV and advancing ``lengths`` exactly like
        inactive rows).

        Returns (tokens (B,k) int32 with -1 past each row's halt point,
        cache, probe_probs (B,k,num_bins) f32, n_emitted (B,) int32).
        """
        B = tokens.shape[0]
        dev = tokens.device
        if active is None:
            active = torch.ones(B, dtype=torch.bool, device=dev)
        if budget is None:
            budget = torch.full((B,), k, dtype=torch.int32, device=dev)
        budget = budget.to(torch.int32).clamp_max(k)
        tok = tokens.to(torch.int32)
        emitted = torch.zeros(B, dtype=torch.int32, device=dev)
        halted = torch.zeros(B, dtype=torch.bool, device=dev)
        toks, probs = [], []
        for _ in range(k):
            act = active & ~halted & (emitted < budget)
            logits, cache, _, probe_logits = self.decode_step(cache, tok, act)
            nxt = logits.argmax(dim=-1).to(torch.int32)
            if eos_id >= 0:
                halted = halted | (act & (nxt == eos_id))
            emitted = emitted + act.to(torch.int32)
            probs.append(torch.softmax(probe_logits.float(), dim=-1))
            toks.append(torch.where(act, nxt, -1))
            tok = torch.where(act, nxt, tok[:, 0])[:, None]
        return torch.stack(toks, 1), cache, torch.stack(probs, 1), emitted


def _ce_chunk(cfg: ModelConfig, table, hc, lc):
    """Masked NLL sum and label count of one sequence chunk."""
    logits = unembed(cfg, table, hc)                       # (B,chunk,V) f32
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc.clamp_min(0).long()[..., None])[..., 0]
    mask = (lc >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def _chunked_ce(cfg: ModelConfig, table, h, labels, chunk: int = 256):
    """Cross-entropy without materializing (B,S,V) logits: a loop over
    sequence chunks (the chunk halves until it divides S, as in the
    reference). With grad on each chunk is recomputed in the backward, so
    the backward holds one chunk's logits at a time. Returns (mean loss
    over labels >= 0, number of such labels)."""
    B, S, _ = h.shape
    while S % chunk:
        chunk //= 2
    nll = torch.zeros((), device=h.device)
    n = torch.zeros((), device=h.device)
    for c0 in range(0, S, chunk):
        args = (cfg, table, h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            nll_c, n_c = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            nll_c, n_c = _ce_chunk(*args)
        nll = nll + nll_c
        n = n + n_c
    return nll / n.clamp_min(1.0), n


# ---------------------------------------------------------------------------
# Weights to and from the reference package
# ---------------------------------------------------------------------------

_ATTN_NAMES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
_MLP_NAMES = ("w_gate", "w_up", "w_down")
_SSM_NAMES = ("in_proj", "out_proj", "conv_w", "conv_b", "dt_bias", "A_log",
              "D", "norm_scale")


def _to_torch(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_jax(cfg: ModelConfig, tree) -> dict[str, torch.Tensor]:
    """Map the reference parameter pytree onto this model's state dict.

    ``tree`` is the reference ``Model.init`` output (or a restored
    checkpoint) with numpy (or torch) leaves. Per-run stacked layer params
    are un-stacked into one entry per layer. The result loads with
    ``model.load_state_dict(...)``, which casts each tensor to the
    parameter's dtype.
    """
    out = {"embed": _to_torch(tree["embed"]),
           "final_norm": _to_torch(tree["final_norm"]["scale"])}
    for name in ("unembed", "pos_embed"):
        if name in tree:
            out[name] = _to_torch(tree[name])
    for li, (ri, j, i) in enumerate(tfm.layer_slots(cfg)):
        p = tree["layers"][ri][j]
        pre = f"layers.{li}."
        out[pre + "norm1"] = _to_torch(p["norm1"]["scale"][i])
        if "attn" in p:
            out[pre + "norm2"] = _to_torch(p["norm2"]["scale"][i])
            for name in _ATTN_NAMES:
                if name in p["attn"]:
                    out[pre + name] = _to_torch(p["attn"][name][i])
            for name in _MLP_NAMES:
                out[pre + name] = _to_torch(p["mlp"][name][i])
        if "ssm" in p:
            for name in _SSM_NAMES:
                out[pre + name] = _to_torch(p["ssm"][name][i])
    for name in ("w1", "b1", "w2", "b2"):
        out[f"probe.{name}"] = _to_torch(tree["probe"][name])
    return out


def params_to_jax(cfg: ModelConfig, params: dict) -> dict:
    """The inverse of ``params_from_jax``: the reference parameter tree
    (the structure of its ``Model.init`` output) from this model's state
    dict or float32 masters. Per-layer entries are stacked back into one
    leaf per run and pattern position; leaves stay torch tensors.
    ``training.checkpoint.save`` writes the tree in the reference's
    ``.npz`` format."""
    tree = {"embed": params["embed"],
            "final_norm": {"scale": params["final_norm"]}}
    for name in ("unembed", "pos_embed"):
        if name in params:
            tree[name] = params[name]
    slots = tfm.layer_slots(cfg)
    layers = []
    for ri, (kinds, _) in enumerate(tfm.split_runs(cfg)):
        sub = []
        for j, kind in enumerate(kinds):
            lis = [li for li, (r, jj, _) in enumerate(slots)
                   if (r, jj) == (ri, j)]          # in block order

            def stack(name, lis=lis):
                return torch.stack([params[f"layers.{li}.{name}"]
                                    for li in lis])
            p = {"norm1": {"scale": stack("norm1")}}
            if kind != KIND_SSM:
                p["attn"] = {name: stack(name) for name in _ATTN_NAMES
                             if f"layers.{lis[0]}.{name}" in params}
                p["norm2"] = {"scale": stack("norm2")}
                p["mlp"] = {name: stack(name) for name in _MLP_NAMES}
            if kind in (KIND_SSM, KIND_HYBRID):
                p["ssm"] = {name: stack(name) for name in _SSM_NAMES}
            sub.append(p)
        layers.append(tuple(sub))
    tree["layers"] = tuple(layers)
    tree["probe"] = {name: params[f"probe.{name}"]
                     for name in ("w1", "b1", "w2", "b2")}
    return tree
