"""The serving model: a dense GQA decoder with the fused TRAIL probe.

``Model(cfg, device=...)`` is an ``nn.Module`` with one ``Block`` per layer
and exposes the cached forward passes of the reference
``repro.models.model.Model``:

  init(seed)                               -> fills the parameters
  init_cache(batch, max_len, "paged")      -> cache dict (paged KV pool)
  prefill_chunk(cache, tokens, valid)      -> (logits_last, cache, tap_sum, n_new)
  decode_step(cache, tokens, active)       -> (logits, cache, tap, probe_logits)
  decode_multi(cache, tokens, active, budget, k=, eos_id=)
                                           -> (tokens, cache, probe_probs, n_emitted)

The parameters live on the model, so no method takes them. The cache is
updated in place and also returned. Only ``KIND_ATTN`` stacks are ported
so far: any other layer kind, ``kv_quant``, windows, cross-attention and
prefix embeds raise ``NotImplementedError``.

``params_from_jax`` and ``load_npz`` bring the reference package's weights
across (as numpy arrays or from its ``.npz`` checkpoint format) without
importing JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.config import KIND_ATTN, ModelConfig
from repro_torch.core import predictor
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_norm, embed_tokens, pdtype,
                                       unembed)


def _check_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.layer_kinds)
    if kinds != {KIND_ATTN}:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds - {KIND_ATTN})} are not "
            "ported (only KIND_ATTN)")
    if cfg.kv_quant:
        raise NotImplementedError(f"{cfg.name}: kv_quant is not ported")
    if cfg.cross_attention or cfg.num_encoder_layers:
        raise NotImplementedError(f"{cfg.name}: cross-attention is not ported")
    if cfg.num_prefix_tokens:
        raise NotImplementedError(f"{cfg.name}: prefix embeds are not ported")
    if not cfg.use_rope:
        raise NotImplementedError(f"{cfg.name}: learned positions are not "
                                  "ported")
    if cfg.family == "audio":
        raise NotImplementedError(f"{cfg.name}: LayerNorm is not ported")


class Model(nn.Module):
    """Cached forward passes over one ``ModelConfig`` (see module docstring).

    Paged attention goes through ``repro_torch.kernels.ops``: the CUDA
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
        self.final_norm = param(d, dtype=pd)
        self.layers = nn.ModuleList(tfm.Block(cfg, self.device)
                                    for _ in range(cfg.num_layers))
        pc = cfg.probe
        self.probe = nn.ParameterDict({
            "w1": param(d, pc.hidden), "b1": param(pc.hidden),
            "w2": param(pc.hidden, pc.num_bins), "b2": param(pc.num_bins)})

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, seed: int = 0) -> "Model":
        """Fill every parameter from a seeded generator on the model's device.

        The distributions are the reference's (``model.py`` init): embedding
        rows N(0, 0.02^2); projections N(0, 1/fan_in) with ``wo`` and
        ``w_down`` at their own fan-in; zero norm gains and biases; probe
        weights N(0, 1/fan_in). Values are drawn in float32 and stored in
        each parameter's dtype. Returns the model.
        """
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def normal(p, scale):
            p.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float32,
                                device=self.device) * scale)

        normal(self.embed, 0.02)
        if not cfg.tie_embeddings:
            normal(self.unembed, 0.02)
        self.final_norm.zero_()
        d, qd, ff = cfg.d_model, cfg.q_dim, cfg.d_ff
        for blk in self.layers:
            blk.norm1.zero_()
            blk.norm2.zero_()
            for w in (blk.wq, blk.wk, blk.wv, blk.w_gate, blk.w_up):
                normal(w, d ** -0.5)
            normal(blk.wo, qd ** -0.5)
            normal(blk.w_down, ff ** -0.5)
            if cfg.qkv_bias:
                for b in (blk.bq, blk.bk, blk.bv):
                    b.zero_()
        probe = predictor.init_probe(gen, d, cfg.probe, device=self.device)
        for name, value in probe.items():
            self.probe[name].copy_(value)
        return self

    # ------------------------------------------------------------------
    # Cache
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, kv_layout: str = "paged",
                   page_size: int = 16) -> dict:
        """A paged cache: 1 null page + batch * ceil(max_len/page_size) pages
        behind a (batch, pages_per_seq) block table, K/V stacked per run."""
        if kv_layout != "paged":
            raise NotImplementedError(
                f"kv_layout={kv_layout!r} is not ported (only 'paged')")
        pages_per_seq = -(-max_len // page_size)
        num_pages = 1 + batch * pages_per_seq          # page 0 = null page
        cache: dict = {
            "lengths": torch.zeros(batch, dtype=torch.int32,
                                   device=self.device),
            "block_table": torch.zeros((batch, pages_per_seq),
                                       dtype=torch.int32, device=self.device),
        }
        for ri, (kinds, nb) in enumerate(self.runs):
            cache[f"run_{ri}"] = tuple(
                tfm.init_run_cache(self.cfg, kind, nb, num_pages, page_size,
                                   device=self.device)
                for kind in kinds)
        return cache

    # ------------------------------------------------------------------
    # Cached forward (chunked prefill; decode is the S=1 case)
    # ------------------------------------------------------------------
    def _trunk(self, cache: dict, h, q_pos):
        cfg = self.cfg
        block_table = cache["block_table"]
        tap = None
        for li, (blk, (ri, j, i)) in enumerate(zip(self.layers, self.slots)):
            sub = cache[f"run_{ri}"][j]
            cache_l = {key: sub[key][i] for key in ("pk", "pv", "pkpos")}
            h, _ = tfm.block_cached(cfg, cfg.layer_kinds[li], blk, h, cache_l,
                                    q_pos, block_table)
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
        h = embed_tokens(cfg, self.embed, tokens)
        h, tap = self._trunk(cache, h, q_pos)
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

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens, active=None):
        """One iteration: generate-one-token for every active row.

        tokens: (B,1) int; active: (B,) bool. Fuses the probe classifier.
        Returns (logits (B,V) f32, cache, tap (B,d), probe_logits (B,k)).
        """
        cfg = self.cfg
        B = tokens.shape[0]
        if active is None:
            active = torch.ones(B, dtype=torch.bool, device=tokens.device)
        lengths = cache["lengths"]
        q_pos = torch.where(active, lengths, -1)[:, None]
        h = embed_tokens(cfg, self.embed, tokens)
        h, tap = self._trunk(cache, h, q_pos)
        cache["lengths"] = lengths + active.to(torch.int32)
        hn = apply_norm(cfg, self.final_norm, h[:, 0])
        logits = unembed(cfg, self._unembed_table(), hn)
        tap = tap[:, 0]
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


# ---------------------------------------------------------------------------
# Weights from the reference package
# ---------------------------------------------------------------------------

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
    if "unembed" in tree:
        out["unembed"] = _to_torch(tree["unembed"])
    names = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
    for li, (ri, j, i) in enumerate(tfm.layer_slots(cfg)):
        p = tree["layers"][ri][j]
        pre = f"layers.{li}."
        out[pre + "norm1"] = _to_torch(p["norm1"]["scale"][i])
        out[pre + "norm2"] = _to_torch(p["norm2"]["scale"][i])
        for name in names:
            if name in p["attn"]:
                out[pre + name] = _to_torch(p["attn"][name][i])
        for name in ("w_gate", "w_up", "w_down"):
            out[pre + name] = _to_torch(p["mlp"][name][i])
    for name in ("w1", "b1", "w2", "b2"):
        out[f"probe.{name}"] = _to_torch(tree["probe"][name])
    return out


def load_npz(path) -> dict:
    """Read a checkpoint in the reference's flat ``.npz`` layout.

    Keys are ``/``-joined paths; ``__len__``/``__tuple__`` markers rebuild
    lists and tuples; bfloat16 leaves are stored as uint16 views under a
    ``::bf16`` suffix and come back as ``torch.bfloat16`` tensors. Other
    leaves come back as torch tensors too. Uses numpy alone.
    """
    with np.load(path) as z:
        flat = {}
        for key in z.files:
            if key.endswith("::bf16"):
                flat[key[:-6]] = torch.from_numpy(
                    z[key].astype(np.uint16)).view(torch.bfloat16)
            else:
                flat[key] = torch.from_numpy(np.array(z[key]))
    root: dict = {}
    meta: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        if parts[-1] in ("__len__", "__tuple__"):
            meta["/".join(parts[:-1]) + "/" + parts[-1]] = val
            continue
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    def fix(node, prefix=""):
        if not isinstance(node, dict):
            return node
        n_key = f"{prefix}__len__"
        if n_key in meta:
            seq = [fix(node[str(i)], f"{prefix}{i}/")
                   for i in range(int(meta[n_key]))]
            return tuple(seq) if bool(meta[f"{prefix}__tuple__"]) else seq
        return {k: fix(v, f"{prefix}{k}/") for k, v in node.items()}

    return fix(root)
