"""The model: a decoder (GQA attention, mixture-of-experts, Mamba-2 SSM or
hybrid layers; with whisper's encoder and cross-attention) with the fused
TRAIL probe.

``Model(cfg, device=...)`` is an ``nn.Module`` with one ``Block`` per layer
and exposes the forward passes of the reference
``repro.models.model.Model``:

  init(seed)                               -> fills the parameters
  init_params(seed)                        -> the same values as a dict of
                                              float32 tensors (training masters)
  forward_train(batch)                     -> (loss, {"aux_loss", "tap", "n_tok"})
  forward_all_taps(batch)                  -> hidden states after every layer
  encode(enc_embeds)                       -> enc_out (encoder-decoder only)
  build_cross_cache(cache, enc_out)        -> cache with each layer's ck/cv
  init_cache(batch, max_len, kv_layout)    -> cache dict ("contig" slot
                                              caches or "paged" KV pool)
  prefill_chunk(cache, tokens, valid, prefix_embeds=, enc_embeds=)
                                           -> (logits_last, cache, tap_sum, n_new)
  decode_step(cache, tokens, active)       -> (logits, cache, tap, probe_logits)
  decode_multi(cache, tokens, active, budget, k=, eos_id=)
                                           -> (tokens, cache, probe_probs, n_emitted)

The parameters live on the model, so no method takes them; training runs
``forward_train`` (the module's ``forward``) through
``torch.func.functional_call`` with float32 masters in their place. The
cache is updated in place and also returned. Global (``KIND_ATTN``),
sliding-window (``KIND_LOCAL``), mixture-of-experts (``KIND_MOE``, with
arctic's dense residual or granite-4.0-h's shared expert), Mamba-2
(``KIND_SSM``), hybrid (``KIND_HYBRID``) and Mamba-2-then-MoE
(``KIND_SSM_MOE``) stacks are ported, with RoPE, learned positions or
none (NoPE), Granite's multipliers, and the
encoder-decoder (whisper: LayerNorm, the biased GELU MLP, a non-causal
encoder through the ``flash_attention`` kernel, cross-attention over its
output, per-slot cross caches beside either KV layout), so every config
runs. ``cfg.kv_quant`` keeps the slot caches in int8 with per-(token, KV
head) scales (decode through the ``decode_attention`` kernel reading
int8; the paged layout refuses it, as the reference's does), and a VLM's
prefix embeddings (paligemma) enter ``forward_train`` and
``prefill_chunk`` through ``prefix_embeds``. The SSM layers'
gradient comes from ``models.ssm.SSDScan``: the scan kernel runs forward,
and the backward differentiates its plain version, on the card as on the
CPU.

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

from repro_torch.config import (FAMILY_AUDIO, KIND_ATTN, KIND_SSM, MOE_KINDS,
                                SSM_KINDS, ModelConfig)
from repro_torch.core import predictor
from repro_torch.metrics.spans import detail
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.decode_graph import MegastepGraph
from repro_torch.models.layers import (apply_norm, cdtype, embed_tokens,
                                       pdtype, unembed)
from repro_torch.training.checkpoint import load_npz  # noqa: F401 (re-export)

MAX_LEARNED_POS = 32768     # rows of the learned-position table


def _check_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.layer_kinds) - set(tfm.PORTED_KINDS)
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)} are not ported (only "
            f"{', '.join(tfm.PORTED_KINDS)})")


class Encoder(nn.Module):
    """Whisper's encoder: learned positions over ``encoder_seq`` frames
    (``pos``), ``num_encoder_layers`` attention blocks without
    cross-attention, and a final norm (``final_norm``, ``final_norm_bias``
    under the audio family's LayerNorm). Parameters are created empty."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        pd = pdtype(cfg)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=pd, device=device),
                                requires_grad=False)

        self.pos = param(cfg.encoder_seq, cfg.d_model)
        self.layers = nn.ModuleList(
            tfm.make_block(cfg, KIND_ATTN, device)
            for _ in range(cfg.num_encoder_layers))
        self.final_norm = param(cfg.d_model)
        if cfg.family == FAMILY_AUDIO:
            self.final_norm_bias = param(cfg.d_model)


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
        if cfg.learned_positions:
            self.pos_embed = param(MAX_LEARNED_POS, d, dtype=pd)
        self.final_norm = param(d, dtype=pd)
        if cfg.family == FAMILY_AUDIO:
            self.final_norm_bias = param(d, dtype=pd)
        self.layers = nn.ModuleList(
            tfm.make_block(cfg, kind, self.device,
                           cross=cfg.cross_attention)
            for kind in cfg.layer_kinds)
        if cfg.num_encoder_layers:
            self.encoder = Encoder(cfg, self.device)
        pc = cfg.probe
        self.probe = nn.ParameterDict({
            "w1": param(d, pc.hidden), "b1": param(pc.hidden),
            "w2": param(pc.hidden, pc.num_bins), "b2": param(pc.num_bins)})
        #: the decode megastep's CUDA graph, with its counts of captures
        #: and replays (``decode_graph.counts``)
        self.decode_graph = MegastepGraph()

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    def _init_values(self, seed: int):
        """(name, float32 value) of every parameter, drawn in a fixed order
        from one seeded generator on the model's device.

        The distributions are the reference's (``model.py`` init): embedding
        and learned-position rows N(0, 0.02^2); projections N(0, 1/fan_in)
        with ``wo``, ``w_down`` and the SSM's ``out_proj`` at their own
        fan-in, the experts', the shared expert's and the router's too;
        the SSM's ``conv_w`` N(0, 1/W), its ``D`` ones and its ``conv_b``,
        ``dt_bias``, ``A_log`` and ``norm_scale`` zeros; zero RMSNorm gains, unit
        LayerNorm gains; zero biases; probe weights N(0, 1/fan_in).
        """
        cfg = self.cfg
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = dict(self.named_parameters())

        def normal(name, scale):
            return name, torch.randn(params[name].shape, generator=gen,
                                     dtype=torch.float32, device=dev) * scale

        def filled(name, value):
            return name, torch.full(params[name].shape, value,
                                    dtype=torch.float32, device=dev)

        def zeros(name):
            return filled(name, 0.0)

        def norm(name):
            if name + "_bias" in params:        # LayerNorm: unit gain
                return [filled(name, 1.0), zeros(name + "_bias")]
            return [zeros(name)]                # RMSNorm: 1 + scale

        d, qd, ff = cfg.d_model, cfg.q_dim, cfg.d_ff
        d_in = cfg.ssm_expand * d

        def block(pre, kind):
            yield from norm(pre + "norm1")
            if kind in SSM_KINDS:
                yield normal(pre + "in_proj", d ** -0.5)
                yield normal(pre + "out_proj", d_in ** -0.5)
                yield normal(pre + "conv_w", cfg.ssm_conv ** -0.5)
                for name in ("conv_b", "dt_bias", "A_log", "norm_scale"):
                    yield zeros(pre + name)
                yield filled(pre + "D", 1.0)
            if kind == KIND_SSM:
                return
            yield from norm(pre + "norm2")
            proj_in = [w for w in ("wq", "wk", "wv", "w_gate", "w_up")
                       if pre + w in params]
            for w in proj_in:
                yield normal(pre + w, d ** -0.5)
            if pre + "wo" in params:
                yield normal(pre + "wo", qd ** -0.5)
            if pre + "w_down" in params:
                yield normal(pre + "w_down", ff ** -0.5)
            for b in ("bq", "bk", "bv", "b_up", "b_down"):
                if pre + b in params:
                    yield zeros(pre + b)
            if kind in MOE_KINDS:
                yield normal(pre + "moe_router", d ** -0.5)
                yield normal(pre + "moe_w_gate", d ** -0.5)
                yield normal(pre + "moe_w_up", d ** -0.5)
                yield normal(pre + "moe_w_down", ff ** -0.5)
            if pre + "shared_w_gate" in params:
                yield normal(pre + "shared_w_gate", d ** -0.5)
                yield normal(pre + "shared_w_up", d ** -0.5)
                yield normal(pre + "shared_w_down",
                             cfg.shared_expert_ff ** -0.5)
            if pre + "cross_wq" in params:
                for w in ("wq", "wk", "wv"):
                    yield normal(pre + "cross_" + w, d ** -0.5)
                yield normal(pre + "cross_wo", qd ** -0.5)
                for b in ("bq", "bk", "bv"):
                    if pre + "cross_" + b in params:
                        yield zeros(pre + "cross_" + b)
                yield from norm(pre + "norm_cross")

        yield normal("embed", 0.02)
        if not cfg.tie_embeddings:
            yield normal("unembed", 0.02)
        if cfg.learned_positions:
            yield normal("pos_embed", 0.02)
        yield from norm("final_norm")
        for li, kind in enumerate(cfg.layer_kinds):
            yield from block(f"layers.{li}.", kind)
        if cfg.num_encoder_layers:
            yield normal("encoder.pos", 0.02)
            for li in range(cfg.num_encoder_layers):
                yield from block(f"encoder.layers.{li}.", KIND_ATTN)
            yield from norm("encoder.final_norm")
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
    def _embed(self, tokens, positions):
        """Token rows in the compute dtype, plus the learned position rows
        (positions clipped to the table) where the config has them."""
        with detail("model.embed"):
            h = embed_tokens(self.cfg, self.embed, tokens)
            if self.cfg.learned_positions:
                idx = positions.clamp(0, self.pos_embed.shape[0] - 1).long()
                h = h + self.pos_embed[idx].to(h.dtype)
        return h

    def encode(self, enc_embeds):
        """Run the encoder over frontend embeddings (B,T,d) -> (B,T,d) in
        the compute dtype: learned positions, then each block's
        non-causal self-attention (the ``flash_attention`` kernel) and
        MLP, then the encoder's final norm."""
        cfg = self.cfg
        if not cfg.num_encoder_layers:
            raise ValueError(f"{cfg.name} has no encoder")
        enc = self.encoder
        h = enc_embeds.to(cdtype(cfg))
        h = h + enc.pos[None, :h.shape[1]].to(h.dtype)
        for blk in enc.layers:
            h, _ = tfm.block_train(cfg, KIND_ATTN, _weights(blk), h,
                                   causal=False)
        return _final_norm(cfg, enc, h)

    @torch.no_grad()
    def build_cross_cache(self, cache: dict, enc_out):
        """Fill each cross-attention layer's ``ck``/``cv`` from the encoder
        output (B,T,d); the leaves are replaced by tensors of B rows and T
        keys. Returns the cache."""
        cfg = self.cfg
        for ri, (kinds, nb) in enumerate(self.runs):
            for j, sub in enumerate(cache[f"run_{ri}"]):
                if "ck" not in sub:
                    continue
                lis = [li for li, slot in enumerate(self.slots)
                       if slot[:2] == (ri, j)]          # in block order
                kvs = [attn.cross_kv(cfg, tfm.cross_weights(self.layers[li]),
                                     enc_out) for li in lis]
                sub["ck"] = torch.stack([k for k, _ in kvs])
                sub["cv"] = torch.stack([v for _, v in kvs])
        return cache

    def _train_trunk(self, tokens, enc_out=None, prefix=None):
        """Yield (hidden state, router aux loss) after every layer, train-path
        semantics: causal attention over positions 0..S-1, cross-attention
        over ``enc_out`` where given. A VLM's ``prefix`` embeddings (B,P,d)
        go before the embedded tokens (``embed_scale`` scales the tokens
        only), and the positions run over all P + S rows."""
        cfg = self.cfg
        S = tokens.shape[1]
        h = self._embed(tokens, torch.arange(S, device=tokens.device)
                        .expand(tokens.shape))
        if prefix is not None:
            h = torch.cat([prefix.to(h.dtype), h], dim=1)
        remat = cfg.remat and torch.is_grad_enabled()
        for li, kind in enumerate(cfg.layer_kinds):
            w = _weights(self.layers[li])
            if remat:
                h, aux = checkpoint(tfm.block_train, cfg, kind, w, h,
                                    enc_out, use_reentrant=False)
            else:
                h, aux = tfm.block_train(cfg, kind, w, h, enc_out)
            yield h, aux

    def _encoder_out(self, batch: dict):
        """The encoder's output for ``batch["enc_embeds"]``, if given; keys
        the reference does not know are refused."""
        extra = set(batch) - {"tokens", "labels", "enc_embeds",
                              "prefix_embeds"}
        if extra:
            raise NotImplementedError(
                f"batch keys {sorted(extra)} are not known")
        if "enc_embeds" in batch:
            return self.encode(batch["enc_embeds"])
        return None

    def forward_train(self, batch: dict):
        """batch: {"tokens": (B,S), "labels": (B,S)} int (labels -1 where no
        loss is taken), and for an encoder-decoder optionally
        ``"enc_embeds"`` (B,T,d), run through the encoder first; for a VLM
        optionally ``"prefix_embeds"`` (B,P,d), prepended to the embedded
        tokens at positions 0..P-1 with labels -1 (as the reference's
        vision prefix).

        Returns (loss, {"aux_loss", "tap" (B,P+S,d), "n_tok"}): the mean
        next-token cross-entropy over labels >= 0 plus
        ``router_aux_weight`` times the summed MoE router aux losses
        (``aux_loss``; 0 without MoE), the tap layer's hidden state and
        the number of such labels. With ``cfg.remat`` and grad on, each
        decoder block is recomputed in the backward
        (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
        """
        enc_out = self._encoder_out(batch)
        prefix = batch.get("prefix_embeds")
        labels = batch["labels"]
        if prefix is not None:
            labels = torch.cat([labels.new_full(prefix.shape[:2], -1),
                                labels], dim=1)
        tap = h = None
        aux_total = torch.zeros((), device=batch["tokens"].device)
        for li, (h, aux) in enumerate(self._train_trunk(batch["tokens"],
                                                        enc_out, prefix)):
            aux_total = aux_total + aux
            if li == self.tap_layer:
                tap = h
        h = _final_norm(self.cfg, self, h)
        loss, n_tok = _chunked_ce(self.cfg, self._unembed_table(), h, labels)
        aux = {"aux_loss": aux_total, "tap": tap, "n_tok": n_tok}
        return loss + self.cfg.router_aux_weight * aux_total, aux

    def forward(self, batch: dict):
        """The module call is the training forward (``forward_train``): it
        is what ``torch.func.functional_call`` runs with the masters."""
        return self.forward_train(batch)

    def forward_all_taps(self, batch: dict):
        """Profiling pass (paper Section 3.1: embeddings of every layer):
        the hidden state after every layer, (num_layers, B, S, d), with
        train-path semantics and no loss. As in the reference, a
        ``prefix_embeds`` entry is not read here."""
        enc_out = self._encoder_out(batch)
        return torch.stack([h for h, _ in self._train_trunk(batch["tokens"],
                                                            enc_out)])

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
        Cross-attention layers hold zeroed ``ck``/``cv`` of ``encoder_seq``
        keys per slot under either layout, as the reference's do. Under
        ``cfg.kv_quant`` the slot caches are int8 with their scales; the
        paged layout refuses it, as the reference's does.
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
                                   enc_seq=self.cfg.encoder_seq,
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
    def prefill_chunk(self, cache: dict, tokens, valid=None,
                      prefix_embeds=None, enc_embeds=None):
        """Process a chunk of prompt tokens for every active row.

        tokens: (B,C) int; valid: (B,C) bool (contiguous prefixes) or None;
        prefix_embeds: (B,P,d) a VLM's prefix embeddings, placed at
        positions ``lengths + 0..P-1`` before the chunk, whose valid tokens
        move up by P (every row takes all P; the engine passes none, as the
        reference's does); enc_embeds: (B,T,d) frontend embeddings of an
        encoder-decoder, run through the encoder into the cross caches
        first (``encode``, then ``build_cross_cache``). Returns (next_logits
        (B,V) f32, cache, tap_sum (B,d) f32, n_new (B,) int32), n_new
        counting the prefix.
        """
        cfg = self.cfg
        B, C = tokens.shape
        dev = tokens.device
        if valid is None:
            valid = torch.ones((B, C), dtype=torch.bool, device=dev)
        offsets = cache["lengths"]
        if enc_embeds is not None:
            cache = self.build_cross_cache(cache, self.encode(enc_embeds))
        q_pos = torch.where(
            valid, offsets[:, None] + torch.arange(C, dtype=torch.int32,
                                                   device=dev), -1)
        h = self._embed(tokens, q_pos)
        if prefix_embeds is not None:
            P = prefix_embeds.shape[1]
            ppos = offsets[:, None] + torch.arange(P, dtype=torch.int32,
                                                   device=dev)
            h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
            q_pos = torch.cat([ppos, torch.where(valid, q_pos + P, -1)],
                              dim=1)
            valid = torch.cat([torch.ones((B, P), dtype=torch.bool,
                                          device=dev), valid], dim=1)
        h, tap = self._trunk(cache, h, q_pos)
        n_new = valid.sum(dim=1, dtype=torch.int32)
        cache["lengths"] = offsets + n_new

        with detail("model.head"):
            # next-token logits from the last valid position of each row
            last_idx = (n_new - 1).clamp_min(0).long()
            h_last = h[torch.arange(B, device=h.device), last_idx]
            h_last = _final_norm(cfg, self, h_last)
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
        with detail("model.head"):
            hn = _final_norm(cfg, self, h[:, 0])
            logits = unembed(cfg, self._unembed_table(), hn)
        return logits, cache, tap[:, 0]

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens, active=None):
        """One iteration: generate-one-token for every active row.

        tokens: (B,1) int; active: (B,) bool. Fuses the probe classifier.
        Returns (logits (B,V) f32, cache, tap (B,d), probe_logits (B,k)).
        """
        logits, cache, tap = self._decode(cache, tokens, active)
        with detail("model.head"):
            probe_logits = predictor.apply_probe(self.probe, tap)
        return logits, cache, tap, probe_logits

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

        On a CUDA device the megastep is one CUDA graph, captured at the
        first call of each key and replayed after (``models.decode_graph``;
        ``decode_graph.counts`` counts both); on the CPU and meta it runs
        eagerly.
        """
        B = tokens.shape[0]
        dev = tokens.device
        if active is None:
            active = torch.ones(B, dtype=torch.bool, device=dev)
        if budget is None:
            budget = torch.full((B,), k, dtype=torch.int32, device=dev)
        if dev.type == "cuda":
            return self.decode_graph.run(self._megastep, cache, tokens,
                                         active, budget, k, eos_id)
        return self._megastep(cache, tokens, active, budget, k, eos_id)

    def _megastep(self, cache: dict, tokens, active, budget, k: int,
                  eos_id: int):
        """``decode_multi``'s body, eager: what the CUDA graph captures."""
        B = tokens.shape[0]
        dev = tokens.device
        budget = budget.to(torch.int32).clamp_max(k)
        tok = tokens.to(torch.int32)
        emitted = torch.zeros(B, dtype=torch.int32, device=dev)
        halted = torch.zeros(B, dtype=torch.bool, device=dev)
        toks, probs = [], []
        for _ in range(k):
            with detail("model.sample"):
                act = active & ~halted & (emitted < budget)
            with detail("model.decode_step"):
                logits, cache, _, probe_logits = self.decode_step(cache, tok,
                                                                  act)
            with detail("model.sample"):
                nxt = logits.argmax(dim=-1).to(torch.int32)
                if eos_id >= 0:
                    halted = halted | (act & (nxt == eos_id))
                emitted = emitted + act.to(torch.int32)
                probs.append(torch.softmax(probe_logits.float(), dim=-1))
                toks.append(torch.where(act, nxt, -1))
                tok = torch.where(act, nxt, tok[:, 0])[:, None]
        return torch.stack(toks, 1), cache, torch.stack(probs, 1), emitted


def _final_norm(cfg: ModelConfig, owner: nn.Module, h):
    """The final norm of ``owner`` (the model or its encoder), with its
    bias under the audio family's LayerNorm."""
    return apply_norm(cfg, owner.final_norm, h,
                      getattr(owner, "final_norm_bias", None))


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
_SSM_NAMES = ("in_proj", "out_proj", "conv_w", "conv_b", "dt_bias", "A_log",
              "D", "norm_scale")
_NORMS = ("norm1", "norm2", "norm_cross")
_GROUP_PREFIX = {"attn": "", "mlp": "", "ssm": "", "cross": "cross_",
                 "moe": "moe_"}


def _weights(module: nn.Module):
    """A block's weights as they are now (the masters inside
    ``functional_call``), as attributes of a namespace. A checkpointed
    block is recomputed in the backward, after ``functional_call`` has put
    the module's own parameters back, so it is handed the tensors
    themselves."""
    return types.SimpleNamespace(**dict(module.named_parameters()))


def _to_torch(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _block_from_tree(p, i: int, pre: str, out: dict) -> None:
    """Block ``i`` of a stacked reference block tree ``p`` into ``out``
    under the port's names: ``norm1`` -> ``norm1`` (and its LayerNorm
    bias -> ``norm1_bias``), ``attn``/``mlp``/``ssm`` leaves keep their
    names, ``cross.*`` -> ``cross_*``, ``moe.*`` -> ``moe_*``."""
    for group, leaves in p.items():
        for leaf, value in leaves.items():
            if group in _NORMS:
                name = group if leaf == "scale" else f"{group}_{leaf}"
            else:
                name = _GROUP_PREFIX[group] + leaf
            out[pre + name] = _to_torch(value[i])


def _block_tree(names, stack) -> dict:
    """The reference block tree of a block whose port names are ``names``
    (the inverse of ``_block_from_tree``); ``stack(name)`` gives the
    stacked leaf."""
    ssm = set(_SSM_NAMES)
    p: dict = {}
    for name in names:
        norm = name.removesuffix("_bias")
        if norm in _NORMS:
            group, leaf = norm, "bias" if name != norm else "scale"
        elif name.startswith(("cross_", "moe_")):
            group, leaf = name.split("_", 1)
        elif name in ssm:
            group, leaf = "ssm", name
        elif name in _ATTN_NAMES:
            group, leaf = "attn", name
        else:
            group, leaf = "mlp", name
        p.setdefault(group, {})[leaf] = stack(name)
    return p


def _norm_tree(params: dict, name: str) -> dict:
    tree = {"scale": params[name]}
    if name + "_bias" in params:
        tree["bias"] = params[name + "_bias"]
    return tree


def params_from_jax(cfg: ModelConfig, tree) -> dict[str, torch.Tensor]:
    """Map the reference parameter pytree onto this model's state dict.

    ``tree`` is the reference ``Model.init`` output (or a restored
    checkpoint) with numpy (or torch) leaves. Per-run stacked layer params
    are un-stacked into one entry per layer, the encoder's stacked layers
    into ``encoder.layers.<i>``. The result loads with
    ``model.load_state_dict(...)``, which casts each tensor to the
    parameter's dtype.
    """
    out = {"embed": _to_torch(tree["embed"])}
    for name, node in (("final_norm", tree["final_norm"]),
                       ("encoder.final_norm",
                        tree.get("encoder", {}).get("final_norm"))):
        for leaf, value in (node or {}).items():
            out[name if leaf == "scale" else f"{name}_{leaf}"] = \
                _to_torch(value)
    for name in ("unembed", "pos_embed"):
        if name in tree:
            out[name] = _to_torch(tree[name])
    for li, (ri, j, i) in enumerate(tfm.layer_slots(cfg)):
        _block_from_tree(tree["layers"][ri][j], i, f"layers.{li}.", out)
    if "encoder" in tree:
        out["encoder.pos"] = _to_torch(tree["encoder"]["pos"])
        for li in range(cfg.num_encoder_layers):
            _block_from_tree(tree["encoder"]["layers"], li,
                             f"encoder.layers.{li}.", out)
    for name in ("w1", "b1", "w2", "b2"):
        out[f"probe.{name}"] = _to_torch(tree["probe"][name])
    return out


def params_to_jax(cfg: ModelConfig, params: dict) -> dict:
    """The inverse of ``params_from_jax``: the reference parameter tree
    (the structure of its ``Model.init`` output) from this model's state
    dict or float32 masters. Per-layer entries are stacked back into one
    leaf per run and pattern position (the encoder's into one stack);
    leaves stay torch tensors. ``training.checkpoint.save`` writes the
    tree in the reference's ``.npz`` format."""
    tree = {"embed": params["embed"],
            "final_norm": _norm_tree(params, "final_norm")}
    for name in ("unembed", "pos_embed"):
        if name in params:
            tree[name] = params[name]

    def block(lis, pre):
        first = f"{pre}{lis[0]}."
        names = [k[len(first):] for k in params if k.startswith(first)]
        return _block_tree(names, lambda name: torch.stack(
            [params[f"{pre}{li}.{name}"] for li in lis]))

    slots = tfm.layer_slots(cfg)
    tree["layers"] = tuple(
        tuple(block([li for li, (r, jj, _) in enumerate(slots)
                     if (r, jj) == (ri, j)], "layers.")     # in block order
              for j in range(len(kinds)))
        for ri, (kinds, _) in enumerate(tfm.split_runs(cfg)))
    if cfg.num_encoder_layers:
        tree["encoder"] = {
            "pos": params["encoder.pos"],
            "layers": block(list(range(cfg.num_encoder_layers)),
                            "encoder.layers."),
            "final_norm": _norm_tree(params, "encoder.final_norm")}
    tree["probe"] = {name: params[f"probe.{name}"]
                     for name in ("w1", "b1", "w2", "b2")}
    return tree
