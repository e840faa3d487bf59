"""AdamW with linear warmup and cosine decay, on dicts of tensors (the
reference ``repro.training.optimizer``).

The LM trainer and the probe trainer (the paper's Section 3.1 recipe:
AdamW, cosine annealing from 0.01 to 0) share it. Parameters, gradients
and moments are dicts keyed alike. As in the reference, every leaf is
updated each step: a leaf without a gradient (``None``, such as the probe
under the LM loss, which does not reach it) counts as a zero gradient, so
its moments decay and a matrix still takes its weight decay; the global
norm counts it as zeros. The arithmetic is float32 on the parameters'
device; moments are stored in ``moment_dtype``. ``update`` returns new
tensors and leaves its inputs as they were.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.layers import torch_dtype


@dataclass(frozen=True)
class AdamWConfig:
    """AdamW hyperparameters plus the warmup/cosine schedule shape."""

    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.0
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac * lr`` (float32)."""
    step = torch.as_tensor(step).float()
    warm = (step / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    t = ((step - cfg.warmup_steps)
         / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(cfg: AdamWConfig, params: dict) -> dict:
    """Fresh optimizer state: zero moments (in ``moment_dtype``) and step 0."""
    dt = torch_dtype(cfg.moment_dtype)
    device = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": {k: torch.zeros_like(p, dtype=dt) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=dt) for k, p in params.items()}}


def global_norm(tree: dict) -> torch.Tensor:
    """L2 norm over every leaf (float32 accumulation); ``None`` leaves are
    zeros."""
    total = 0.0
    for x in tree.values():
        if x is not None:
            total = total + x.float().square().sum()
    return torch.sqrt(torch.as_tensor(total))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, state: dict, params: dict):
    """One AdamW step. Returns (new_params, new_state, metrics) with
    metrics {"grad_norm", "lr"}; ``grads`` may hold ``None`` (zeros)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / gnorm.clamp_min(1e-9), max=1.0)
             if cfg.clip_norm else 1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    c1 = 1.0 - b1 ** stepf
    c2 = 1.0 - b2 ** stepf
    new_p, new_mu, new_nu = {}, {}, {}
    for key, p in params.items():
        g = grads.get(key)
        g = (torch.zeros_like(p, dtype=torch.float32) if g is None
             else g.float() * scale)
        mu, nu = state["mu"][key], state["nu"][key]
        mu32 = mu.float() * b1 + (1 - b1) * g
        nu32 = nu.float() * b2 + (1 - b2) * g.square()
        upd = (mu32 / c1) / ((nu32 / c2).sqrt() + cfg.eps)
        p32 = p.float()
        if p.dim() >= 2 and cfg.weight_decay:     # no decay on norms/biases
            upd = upd + cfg.weight_decay * p32
        new_p[key] = (p32 - lr * upd).to(p.dtype)
        new_mu[key] = mu32.to(mu.dtype)
        new_nu[key] = nu32.to(nu.dtype)
    return (new_p, {"step": step, "mu": new_mu, "nu": new_nu},
            {"grad_norm": gnorm, "lr": lr})
