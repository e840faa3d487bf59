"""Bayesian per-iteration refinement of the probe's bin distribution.

Paper Section 3.1 + Appendix A. The remaining length shrinks by one each
iteration, so probability mass drifts from bin B_{i+1} into B_i at rate
1/bin_size (uniform-within-bin assumption). The filter is:

  q_prior(t) = T @ q(t-1)
  q(t)(i)    = q_prior(t)(i) * p(t)(i) / sum_j q_prior(t)(j) * p(t)(j)

with the bidiagonal transition matrix
  T[i, i]   = 1 - 1/bin_size
  T[i, i+1] = 1/bin_size          (drift from B_{i+1} to B_i)

All functions are batched: q, p are (..., k) tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ProbeConfig
from repro_torch.core.bins import bin_means


def transition_matrix(pc: ProbeConfig) -> np.ndarray:
    """Appendix A matrix; computed once from bin sizes."""
    k = pc.num_bins
    r = 1.0 / pc.bin_width
    T = np.eye(k) * (1.0 - r)
    for i in range(k - 1):
        T[i, i + 1] = r
    T[0, 0] = 1.0    # bin 0 absorbs (request finishes from B_0)
    return T


def bayes_update(q_prev: torch.Tensor, p_t: torch.Tensor, T) -> torch.Tensor:
    """One filter step. q_prev, p_t: (..., k); T: (k, k). Returns q_t."""
    T = torch.as_tensor(T, dtype=q_prev.dtype, device=q_prev.device)
    prior = q_prev @ T.T
    post = prior * p_t
    z = post.sum(dim=-1, keepdim=True)
    return torch.where(z > 0, post / z.clamp_min(1e-30), prior)


def expected_length(q: torch.Tensor, pc: ProbeConfig) -> torch.Tensor:
    """L_t = sum_i q(i) * m_i  (paper Section 3.1)."""
    m = torch.as_tensor(bin_means(pc), dtype=q.dtype, device=q.device)
    return q @ m


def refine_sequence(p_seq: torch.Tensor, pc: ProbeConfig) -> torch.Tensor:
    """Filter a whole prediction sequence (offline eval): p_seq (T,k) -> q (T,k)."""
    T = transition_matrix(pc)
    qs = [p_seq[0]]
    for p in p_seq[1:]:
        qs.append(bayes_update(qs[-1], p, T))
    return torch.stack(qs)
