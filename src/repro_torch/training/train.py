"""Training loops (the reference ``repro.training.train``): the LM trainer
for the ~100M serving model and the smoke configs, and the probe trainer
(the paper's Section 3.1 recipe).

The loops are eager. The LM's master weights are a dict of float32
tensors keyed like the model's state dict (``Model.init_params`` or
``params_from_jax``); ``forward_train`` runs through
``torch.func.functional_call`` with them in place of the module's own
parameters, whose matmul weights are held in the compute dtype for
serving. After training, ``model.load_state_dict(params)`` casts the
masters into the serving model.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import functional_call

from repro_torch.config import ProbeConfig
from repro_torch.core import predictor as probe_mod
from repro_torch.core.bins import bin_index, bin_means
from repro_torch.training import optimizer as opt_mod

_BATCH_KEYS = ("tokens", "labels", "enc_embeds")


def make_loss_fn(model):
    """``(params, batch) -> (loss, aux)``: ``model.forward_train`` with
    ``params`` in place of the module's parameters."""
    def loss_fn(params, batch):
        """The training loss of ``batch`` under ``params``."""
        return functional_call(model, params, (batch,))
    return loss_fn


def make_train_step(model, ocfg: opt_mod.AdamWConfig):
    """Build the ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` step: forward, backward and one AdamW update."""
    loss_fn = make_loss_fn(model)

    def train_step(params, opt_state, batch):
        """One forward/backward/AdamW step; returns the new state and
        metrics (device tensors)."""
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, aux = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
        params, opt_state, om = opt_mod.update(
            ocfg, dict(zip(live, grads)), opt_state, params)
        metrics = {"loss": loss.detach(), "aux_loss": aux["aux_loss"].detach(),
                   "n_tok": aux["n_tok"].detach(), **om}
        return params, opt_state, metrics

    return train_step


def train_lm(model, params: dict, data_iter, ocfg: opt_mod.AdamWConfig,
             n_steps: int, log_every: int = 20, callback=None):
    """Train the LM for ``n_steps`` batches of ``data_iter`` (numpy dicts of
    ``batches``), on the model's device.

    Returns (params, opt_state, history); history holds the metrics of
    every ``log_every``-th step and of the last, as floats with the step.
    """
    step_fn = make_train_step(model, ocfg)
    opt_state = opt_mod.init(ocfg, params)
    history = []
    for step, batch in enumerate(data_iter):
        if step >= n_steps:
            break
        tb = {k: torch.from_numpy(np.asarray(batch[k])).to(model.device)
              for k in _BATCH_KEYS if k in batch}
        params, opt_state, m = step_fn(params, opt_state, tb)
        if step % log_every == 0 or step == n_steps - 1:
            rec = {k: float(v) for k, v in m.items()}
            rec["step"] = step
            history.append(rec)
            if callback:
                callback(rec)
    return params, opt_state, history


# ---------------------------------------------------------------------------
# Probe training (paper Section 3.1)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ProbeTrainConfig:
    """The paper's probe-training recipe knobs (Section 3.1)."""

    epochs: int = 30                # paper: 30 epochs
    batch: int = 32                 # paper: batch 32
    lr: float = 0.01                # paper: cosine 0.01 -> 0
    seed: int = 0


def train_probe(taps: np.ndarray, remaining: np.ndarray, pc: ProbeConfig,
                d_model: int, tc: ProbeTrainConfig = ProbeTrainConfig(),
                probe_params: dict | None = None, log=None, device="cuda"):
    """Train the probe MLP on harvested (tap, remaining) pairs on ``device``.

    Cross-entropy over length bins, AdamW, cosine annealing: the paper's
    recipe (Section 3.1 'Predictor architecture'). The initial weights are
    ``probe_params`` when given, else drawn from a ``torch.Generator``
    seeded with ``tc.seed``; the minibatch order is the reference's numpy
    permutation. Returns (probe_params, history) with one record
    {"epoch", "loss", "acc"} per epoch.
    """
    n = taps.shape[0]
    steps_per_epoch = max(n // tc.batch, 1)
    ocfg = opt_mod.AdamWConfig(lr=tc.lr, warmup_steps=0,
                               total_steps=tc.epochs * steps_per_epoch,
                               weight_decay=0.01, clip_norm=0.0)
    if probe_params is None:
        gen = torch.Generator(device=device).manual_seed(tc.seed)
        probe_params = probe_mod.init_probe(gen, d_model, pc, device=device)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
              for k, v in probe_params.items()}
    x_all = torch.as_tensor(taps, dtype=torch.float32, device=device)
    y_all = bin_index(remaining, pc).to(device)
    opt_state = opt_mod.init(ocfg, params)
    rng = np.random.default_rng(tc.seed)
    history = []
    for ep in range(tc.epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(device)
        losses = []
        for i in range(steps_per_epoch):
            idx = perm[i * tc.batch:(i + 1) * tc.batch]
            live = {k: v.detach().requires_grad_() for k, v in params.items()}
            loss = probe_mod.probe_loss(live, x_all[idx], y_all[idx])
            grads = torch.autograd.grad(loss, list(live.values()))
            params, opt_state, _ = opt_mod.update(
                ocfg, dict(zip(live, grads)), opt_state, params)
            losses.append(loss.detach())
        acc = float(probe_mod.probe_accuracy(params, x_all[:4096],
                                             y_all[:4096]))
        rec = {"epoch": ep, "loss": float(torch.stack(losses).double().mean()),
               "acc": acc}
        history.append(rec)
        if log:
            log(rec)
    return params, history


def probe_mae(probe_params: dict, taps: np.ndarray, remaining: np.ndarray,
              pc: ProbeConfig) -> float:
    """Mean absolute error of the expected-length predictions (Figure 2/3):
    the probe's bin posterior times the bin means, against ``remaining``."""
    dev = probe_params["w1"].device
    with torch.no_grad():
        p = probe_mod.probe_probs(
            probe_params, torch.as_tensor(taps, device=dev)).cpu().numpy()
    pred = p @ bin_means(pc)
    return float(np.mean(np.abs(pred - remaining)))
