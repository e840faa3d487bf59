"""Serving step functions (the reference ``repro.launch.steps``).

``make_serve_step`` is the paper's fused per-iteration hot path: decode
one token for every sequence and refine the length posterior (probe MLP,
softmax and Bayes filter) in the same step, the probe and filter in one
``kernels.ops.probe_update`` call (Section 3.2's overlap trick, here on the
card with no host round-trip). ``make_prefill_step`` binds one model's
chunked prefill; ``make_train_step_for`` one model's training step with
its default AdamW configuration.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.smoothing import expected_length, transition_matrix
from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train import make_train_step


def make_serve_step(model: Model):
    """The fused decode + probe serving step of ``model``."""
    cfg = model.cfg
    T = torch.as_tensor(transition_matrix(cfg.probe), dtype=torch.float32,
                        device=model.device)
    probe = model.probe

    @torch.no_grad()
    def serve_step(cache, tokens, q_prev):
        """tokens: (B,1); q_prev: (B,k) posterior from the last iteration.

        Returns (next_token (B,) int32, cache, q_new (B,k), pred_remaining
        (B,)); the cache is updated in place.
        """
        logits, cache, tap = model._decode(cache, tokens, None)
        q_new, _ = ops.probe_update(tap, probe["w1"], probe["b1"],
                                    probe["w2"], probe["b2"], q_prev, T)
        pred_remaining = expected_length(q_new, cfg.probe)
        next_tok = logits.argmax(dim=-1).to(torch.int32)
        return next_tok, cache, q_new, pred_remaining

    return serve_step


def make_prefill_step(model: Model):
    """A chunked-prefill step bound to one model."""
    def prefill_step(cache, tokens, valid=None):
        """Prefill one token chunk into the cache (``Model.prefill_chunk``)."""
        return model.prefill_chunk(cache, tokens, valid)
    return prefill_step


def default_opt_config(cfg: ModelConfig) -> opt_mod.AdamWConfig:
    """Production AdamW defaults, sized to the arch's parameter count:
    bfloat16 moments above 1e11 parameters, as in the reference."""
    moment_dtype = "bfloat16" if cfg.param_count() > 1e11 else "float32"
    return opt_mod.AdamWConfig(lr=3e-4, warmup_steps=200, total_steps=20000,
                               moment_dtype=moment_dtype)


def make_train_step_for(model: Model):
    """A train step bound to the model with its default optimizer config."""
    return make_train_step(model, default_opt_config(model.cfg))
