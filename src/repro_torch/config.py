"""Configuration system: a copy of the reference package's ``config``.

A single :class:`ModelConfig` dataclass describes every architecture in the
assigned pool (dense GQA, MoE, SSM, hybrid, encoder-decoder, VLM). The port
keeps its own copy so that it imports nothing of the reference package;
configs load from ``repro_torch/configs``. The port's model runs only the
``KIND_ATTN`` layers so far and raises ``NotImplementedError`` for the rest.

Layer heterogeneity (gemma-style local:global alternation, hybrid stacks) is
expressed with ``layer_kinds`` — a tuple of per-layer kind strings, which the
model groups into runs of identical pattern.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Any

# Layer kinds understood by the model.
KIND_ATTN = "attn"        # full (global) causal self-attention + MLP
KIND_LOCAL = "local"      # sliding-window causal self-attention + MLP
KIND_SSM = "ssm"          # Mamba2 SSD block (no MLP; block includes gating)
KIND_MOE = "moe"          # attention + mixture-of-experts MLP
KIND_HYBRID = "hybrid"    # Hymba-style parallel attention + SSM heads + MLP

VALID_KINDS = (KIND_ATTN, KIND_LOCAL, KIND_SSM, KIND_MOE, KIND_HYBRID)

# Architecture families (metadata; drives input stubs and shape skips).
FAMILY_DENSE = "dense"
FAMILY_MOE = "moe"
FAMILY_SSM = "ssm"
FAMILY_HYBRID = "hybrid"
FAMILY_AUDIO = "audio"    # enc-dec with stub audio frontend
FAMILY_VLM = "vlm"        # decoder with stub vision-prefix frontend


@dataclass(frozen=True)
class ProbeConfig:
    """The paper's length-prediction probe (Section 3.1).

    A two-layer MLP (d_model -> hidden -> num_bins) applied to the hidden
    state after ``tap_layer``; during prefill the input is the mean of all
    prompt-token embeddings at that layer.
    """

    tap_layer: int = 11           # paper: layer 11 of 32 (Llama3-8B)
    hidden: int = 512             # paper: 512-d hidden, ReLU
    num_bins: int = 10            # paper: k = 10 equal-width bins
    max_len: int = 512            # paper: lengths in [0, 512]

    @property
    def bin_width(self) -> float:
        """Width of one equal-width length bin."""
        return self.max_len / self.num_bins

    def bin_mean(self, i: int) -> float:
        """Midpoint of bin ``i``: m_i = (b_i + b_{i+1}) / 2 (paper S3.1)."""
        return self.bin_width * (i + 0.5)


@dataclass(frozen=True)
class ModelConfig:
    """One architecture in the assigned pool, fully described.

    The model (``repro_torch.models.model``) consumes only this
    dataclass; defaults describe a small dense GQA decoder and each
    family overrides the sections it needs (MoE, SSM, encoder-decoder,
    VLM prefix). Frozen so configs can key caches safely.
    """

    # -- identity ----------------------------------------------------------
    name: str = "model"
    family: str = FAMILY_DENSE
    source: str = ""              # citation ([arXiv:...] / [hf:...])

    # -- trunk dimensions --------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0             # 0 -> d_model // num_heads
    d_ff: int = 1024              # dense MLP hidden (per-expert hidden for MoE)
    vocab_size: int = 32000

    # -- attention flavour -------------------------------------------------
    layer_kinds: tuple[str, ...] = ()   # empty -> homogeneous from family
    sliding_window: int = 0             # window for KIND_LOCAL layers
    qkv_bias: bool = False              # qwen1.5
    attn_logit_softcap: float = 0.0     # gemma2: 50.0
    final_logit_softcap: float = 0.0    # gemma2: 30.0
    rope_theta: float = 10000.0
    use_rope: bool = True

    # -- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False    # arctic: dense MLP in parallel w/ MoE
    router_aux_weight: float = 0.01     # load-balance loss weight
    capacity_factor: float = 1.25       # static-shape expert capacity

    # -- SSM (Mamba2 SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128                # SSD chunk length
    ssm_conv: int = 4                   # depthwise conv width
    ssm_groups: int = 1                 # B/C groups (mamba2 default: shared)

    # -- encoder-decoder (whisper) -------------------------------------------
    num_encoder_layers: int = 0
    encoder_seq: int = 0                # stub frontend: #frames/patches
    cross_attention: bool = False

    # -- VLM (paligemma) ------------------------------------------------------
    num_prefix_tokens: int = 0          # stub vision prefix length

    # -- KV cache ---------------------------------------------------------
    kv_quant: bool = False              # int8 KV with per-(token,head) scales

    # -- norms / embeddings ----------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False           # gemma-style sqrt(d_model) scaling

    # -- training -----------------------------------------------------------
    remat: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # -- the paper's probe -----------------------------------------------------
    probe: ProbeConfig = field(default_factory=ProbeConfig)

    # ------------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if not self.layer_kinds:
            if self.family == FAMILY_SSM:
                kinds = (KIND_SSM,) * self.num_layers
            elif self.family == FAMILY_MOE:
                kinds = (KIND_MOE,) * self.num_layers
            elif self.family == FAMILY_HYBRID:
                kinds = (KIND_HYBRID,) * self.num_layers
            else:
                kinds = (KIND_ATTN,) * self.num_layers
            object.__setattr__(self, "layer_kinds", kinds)
        if len(self.layer_kinds) != self.num_layers:
            raise ValueError(
                f"{self.name}: layer_kinds has {len(self.layer_kinds)} entries "
                f"for num_layers={self.num_layers}")
        for k in self.layer_kinds:
            if k not in VALID_KINDS:
                raise ValueError(f"{self.name}: unknown layer kind {k!r}")
        if self.num_heads and self.num_kv_heads and self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: num_heads must divide by num_kv_heads")
        # Clamp the probe tap into range (paper uses mid-stack).
        tap = min(self.probe.tap_layer, self.num_layers - 1)
        if tap != self.probe.tap_layer:
            object.__setattr__(self, "probe", dataclasses.replace(self.probe, tap_layer=tap))

    # -- derived -------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        """Total query projection width (num_heads * head_dim)."""
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        """Total key/value projection width (num_kv_heads * head_dim)."""
        return self.num_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        """True when every layer is an SSM block (no KV cache at all)."""
        return all(k == KIND_SSM for k in self.layer_kinds)

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer needs an unbounded full-attention KV cache."""
        return all(k in (KIND_SSM, KIND_LOCAL) for k in self.layer_kinds)

    @property
    def has_global_attention(self) -> bool:
        """True when any layer carries an unbounded full-attention KV cache."""
        return any(k in (KIND_ATTN, KIND_MOE, KIND_HYBRID) for k in self.layer_kinds)

    @property
    def supports_long_decode(self) -> bool:
        """long_500k eligibility: SSM/hybrid/sliding-window archs.

        Hybrid (hymba) attention heads use a sliding window in our config;
        gemma2/3 globals are a bounded fraction of layers and their per-step
        decode is linear — we follow DESIGN.md section 5.
        """
        n_global = sum(k in (KIND_ATTN, KIND_MOE) for k in self.layer_kinds)
        return (self.family in (FAMILY_SSM, FAMILY_HYBRID)
                or (self.sliding_window > 0
                    and n_global <= self.num_layers // 2))

    @property
    def has_decoder(self) -> bool:
        """Every assigned arch has a decode path (whisper: its decoder)."""
        return True

    def layer_runs(self) -> tuple[tuple[str, int], ...]:
        """Compress layer_kinds into maximal (kind, run_length) runs."""
        runs: list[tuple[str, int]] = []
        for k in self.layer_kinds:
            if runs and runs[-1][0] == k:
                runs[-1] = (k, runs[-1][1] + 1)
            else:
                runs.append((k, 1))
        return tuple(runs)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + trunk)."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for kind in self.layer_kinds:
            n += self._layer_params(kind)
        if self.num_encoder_layers:
            enc = self.num_encoder_layers * self._layer_params(KIND_ATTN)
            n += enc
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        n = self.vocab_size * self.d_model
        for kind in self.layer_kinds:
            n += self._layer_params(kind, active=True)
        if self.num_encoder_layers:
            n += self.num_encoder_layers * self._layer_params(KIND_ATTN)
        return n

    def _layer_params(self, kind: str, active: bool = False) -> int:
        """Parameter count of one layer of ``kind`` (active: routed only)."""
        d, ff = self.d_model, self.d_ff
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = 3 * d * ff  # gated (gate/up/down)
        if kind == KIND_SSM:
            return self._ssm_params()
        if kind == KIND_MOE:
            ne = self.experts_per_token if active else self.num_experts
            moe = ne * 3 * d * ff + d * self.num_experts
            if self.moe_dense_residual:
                moe += 3 * d * ff
            return attn + moe
        if kind == KIND_HYBRID:
            return attn + self._ssm_params() + mlp
        return attn + mlp

    def _ssm_params(self) -> int:
        """Parameter count of one Mamba2 SSD block."""
        d = self.d_model
        d_in = self.ssm_expand * d
        nh = max(d_in // self.ssm_head_dim, 1)
        # in_proj produces [z, x, B, C, dt]; B/C shared across heads (groups).
        bc = 2 * self.ssm_groups * self.ssm_state
        zxbcdt = 2 * d_in + bc + nh
        return d * zxbcdt + d_in * d + self.ssm_conv * (d_in + bc)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "mamba2-370m", "whisper-tiny", "paligemma-3b", "granite-3-8b",
    "arctic-480b", "qwen1.5-32b", "gemma3-1b", "hymba-1.5b",
    "gemma2-9b", "olmoe-1b-7b",
)

_EXTRA_IDS = ("trail-llama",)   # the paper's own serving model (reduced scale)


def _module_name(arch: str) -> str:
    """Map an arch id to its ``repro_torch.configs`` module name."""
    return "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    """Load the full-size config for an architecture id."""
    if arch not in ARCH_IDS + _EXTRA_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS + _EXTRA_IDS}")
    mod = importlib.import_module(_module_name(arch))
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Load the reduced smoke-test variant (<=2 layers, d_model<=512, <=4 experts)."""
    mod = importlib.import_module(_module_name(arch))
    return mod.SMOKE


def all_configs() -> dict[str, ModelConfig]:
    """Load every assigned full-size config, keyed by arch id."""
    return {a: get_config(a) for a in ARCH_IDS}


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    """One assigned benchmark input shape (sequence x batch x mode)."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                     # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applies(cfg: ModelConfig, shape: InputShape) -> bool:
    """DESIGN.md section 5 skip rules."""
    if shape.name == "long_500k":
        return cfg.supports_long_decode
    return True


def pattern_local_global(num_layers: int, local: int, glob: int = 1,
                         window_kind: str = KIND_LOCAL) -> tuple[str, ...]:
    """Build an (L..LG)* repeating pattern truncated to num_layers."""
    block = (window_kind,) * local + (KIND_ATTN,) * glob
    kinds: list[str] = []
    while len(kinds) < num_layers:
        kinds.extend(block)
    return tuple(kinds[:num_layers])
