"""Serving step functions (the reference ``repro.launch.steps``).

``make_serve_step`` is the paper's fused per-iteration hot path: decode
one token for every sequence and refine the length posterior (probe MLP,
softmax and Bayes filter) in the same step, the probe and filter in one
``kernels.ops.probe_update`` call (Section 3.2's overlap trick, here on the
card with no host round-trip). ``make_prefill_step`` binds one model's
chunked prefill; ``make_train_step_for`` one model's training step with
its default AdamW configuration. ``input_specs`` builds every input of
these steps at one of the reference's input shapes as meta tensors, which
allocate nothing: the dry run (``launch.dryrun``) runs the steps on them.
"""

from __future__ import annotations

import torch

from repro_torch.config import (FAMILY_AUDIO, FAMILY_VLM, INPUT_SHAPES,
                                ModelConfig)
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
    def prefill_step(cache, tokens, valid=None, **frontend):
        """Prefill one token chunk into the cache (``Model.prefill_chunk``;
        ``frontend``: its ``prefix_embeds`` or ``enc_embeds``)."""
        return model.prefill_chunk(cache, tokens, valid, **frontend)
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


# ---------------------------------------------------------------------------
# Meta-tensor stand-ins for every step input (no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape_name: str, model: Model) -> dict:
    """Every input of the step of ``INPUT_SHAPES[shape_name]``'s mode, on
    ``model``'s device: build the model on ``"meta"`` and nothing is
    allocated. Keys as the reference's: ``mode``, ``params``, ``batch``,
    and ``opt`` (train) or ``cache`` (prefill, decode).

    ``params`` is what the step reads: the float32 masters, keyed like the
    state dict, for train (the reference's parameter dtype), and the
    module's own parameters otherwise (matmul weights in the compute
    dtype). ``opt`` is ``training.optimizer.init`` on the masters under
    ``default_opt_config``; ``cache`` is ``model.init_cache(B, S)``,
    contiguous, as in the reference; ``batch`` holds the tokens (and
    labels to train, or the probe posterior ``q_prev`` to decode), with a
    VLM's ``prefix_embeds`` or an encoder-decoder's ``enc_embeds`` to
    train and prefill.
    """
    shape = INPUT_SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    dev = model.device

    def empty(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=dev)

    frontend = {}
    if cfg.family == FAMILY_AUDIO:
        frontend["enc_embeds"] = empty(B, cfg.encoder_seq, cfg.d_model,
                                       dtype=torch.float32)
    if cfg.family == FAMILY_VLM:
        frontend["prefix_embeds"] = empty(B, cfg.num_prefix_tokens,
                                          cfg.d_model, dtype=torch.float32)

    if shape.mode == "train":
        params = {k: torch.empty_like(p, dtype=torch.float32)
                  for k, p in model.named_parameters()}
        batch = {"tokens": empty(B, S), "labels": empty(B, S), **frontend}
        opt = opt_mod.init(default_opt_config(cfg), params)
        return {"mode": "train", "params": params, "opt": opt,
                "batch": batch}

    params = dict(model.named_parameters())
    cache = model.init_cache(B, S)
    if shape.mode == "prefill":
        return {"mode": "prefill", "params": params, "cache": cache,
                "batch": {"tokens": empty(B, S), **frontend}}

    # decode: one token against a seq_len cache, probe posterior carried
    batch = {"tokens": empty(B, 1),
             "q_prev": empty(B, cfg.probe.num_bins, dtype=torch.float32)}
    return {"mode": "decode", "params": params, "cache": cache,
            "batch": batch}
