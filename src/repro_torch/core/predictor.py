"""The probe: remaining-output-length classifier on recycled embeddings.

Paper Section 3.1: a 2-layer MLP (d_model -> 512 -> k bins, ReLU) applied to
the tap layer's hidden state of the *serving model itself*:
  * prompt phase: input = mean of all prompt-token embeddings at the tap layer
  * decode phase: input = the embedding of the token just generated

Parameters are a dict of float32 tensors ``{"w1", "b1", "w2", "b2"}``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ProbeConfig


def init_probe(generator: torch.Generator, d_model: int, pc: ProbeConfig,
               device="cuda") -> dict:
    """Initialize the 2-layer MLP probe head (paper Section 3.1)."""
    s1, s2 = d_model ** -0.5, pc.hidden ** -0.5
    f32 = torch.float32
    return {
        "w1": torch.randn(d_model, pc.hidden, generator=generator, dtype=f32,
                          device=device) * s1,
        "b1": torch.zeros(pc.hidden, dtype=f32, device=device),
        "w2": torch.randn(pc.hidden, pc.num_bins, generator=generator,
                          dtype=f32, device=device) * s2,
        "b2": torch.zeros(pc.num_bins, dtype=f32, device=device),
    }


def apply_probe(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d_model) -> logits (..., num_bins). float32 throughout."""
    h = torch.relu(x.float() @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def probe_probs(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Softmax bin posterior of the probe at embeddings ``x``."""
    return torch.softmax(apply_probe(p, x), dim=-1)


def probe_loss(p: dict, x: torch.Tensor, bin_labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over bins. x: (N,d); bin_labels: (N,) int."""
    return F.cross_entropy(apply_probe(p, x), bin_labels.long())


def probe_accuracy(p: dict, x: torch.Tensor, bin_labels: torch.Tensor) -> torch.Tensor:
    """Top-1 bin accuracy of the probe against gold labels."""
    return (apply_probe(p, x).argmax(-1) == bin_labels).float().mean()
