"""Shared primitives: norms, RoPE, the MLPs, softcap, embeddings.

Compute happens in ``cfg.dtype`` with float32 norm accumulation and float32
RoPE, as in the reference ``repro.models.layers``. Every matmul casts its
weight to the activation's dtype at use, as the reference does: a no-op for
the serving model's matmul weights, which are held pre-cast in the compute
dtype, and the cast of the float32 masters that training passes in. Norm
scales, the embedding table and the probe stay in ``cfg.param_dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype string."""
    return _DTYPES[name]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    """Compute dtype of the model (``cfg.dtype``)."""
    return torch_dtype(cfg.dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    """Parameter dtype of the model (``cfg.param_dtype``)."""
    return torch_dtype(cfg.param_dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with a ``1 + scale`` gain and float32 accumulation."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm (population variance, gain ``scale`` itself, then
    ``bias``) with float32 accumulation, cast back to ``x.dtype``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg: ModelConfig, scale: torch.Tensor, x: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """The family's norm: LayerNorm with ``bias`` for the audio family
    (whisper), RMSNorm otherwise."""
    if cfg.family == "audio":
        return layer_norm(scale, bias, x, cfg.norm_eps)
    return rms_norm(scale, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> (cos, sin) of shape (..., head_dim//2), f32."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE in float32. x: (..., P, H, hd); positions: (..., P)."""
    hd = x.shape[-1]
    cos, sin = rope_table(positions, hd, theta)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP, softcap, embeddings
# ---------------------------------------------------------------------------

def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor) -> torch.Tensor:
    """Gated-SiLU MLP: ``(silu(x Wg) * x Wu) Wd`` in the compute dtype."""
    dt = x.dtype
    return (F.silu(x @ w_gate.to(dt)) * (x @ w_up.to(dt))) @ w_down.to(dt)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """Whisper's biased MLP: ``gelu(x Wu + bu) Wd + bd`` with the tanh
    approximation of GELU (``jax.nn.gelu``'s default), in the compute
    dtype."""
    dt = x.dtype
    h = F.gelu(x @ w_up.to(dt) + b_up.to(dt), approximate="tanh")
    return h @ w_down.to(dt) + b_down.to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Soft-cap logits to (-cap, cap) via tanh; ``cap=0`` is identity."""
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def embed_tokens(cfg: ModelConfig, table: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Look up token rows and cast them to the compute dtype; Granite's
    ``embed_multiplier`` scales the rows before the cast (one rounding)."""
    h = table[tokens]
    if cfg.embed_multiplier != 1.0:
        h = h * cfg.embed_multiplier
    h = h.to(cdtype(cfg))
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return h


def unembed(cfg: ModelConfig, table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """h: (..., d) -> float32 logits (..., V) against the float32 table,
    divided by Granite's ``logit_divisor``."""
    logits = h.float() @ table.float().T
    if cfg.logit_divisor != 1.0:
        logits = logits / cfg.logit_divisor
    return softcap(logits, cfg.final_logit_softcap)


def residual(cfg: ModelConfig, h: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """h plus a residual branch y, times Granite's ``residual_multiplier``
    in the same operation (one rounding, no launch of its own)."""
    if cfg.residual_multiplier != 1.0:
        return torch.add(h, y, alpha=cfg.residual_multiplier)
    return h + y
