"""Length-bin geometry (paper Section 3.1).

k equal-width bins over [0, max_len]; bin i covers
[max_len*i/k, max_len*(i+1)/k) with mean m_i = (b_i + b_{i+1})/2.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ProbeConfig


def bin_edges(pc: ProbeConfig) -> np.ndarray:
    """Equal-width bin edges b_0..b_k over [0, max_len]."""
    return np.linspace(0.0, pc.max_len, pc.num_bins + 1)


def bin_means(pc: ProbeConfig) -> np.ndarray:
    """Bin midpoints m_i = (b_i + b_{i+1}) / 2 (the prediction values)."""
    e = bin_edges(pc)
    return (e[:-1] + e[1:]) / 2.0


def bin_index(lengths, pc: ProbeConfig) -> torch.Tensor:
    """Map remaining-length values to bin ids (clipped into range)."""
    idx = torch.floor_divide(torch.as_tensor(lengths), pc.bin_width)
    return idx.clamp(0, pc.num_bins - 1).to(torch.int32)


def log_bin_edges(pc: ProbeConfig) -> np.ndarray:
    """Beyond-paper: logarithmic bins (paper Section 6 future work)."""
    e = np.geomspace(1.0, pc.max_len, pc.num_bins)
    return np.concatenate([[0.0], e])


def bin_index_log(lengths, pc: ProbeConfig) -> torch.Tensor:
    """Map remaining-length values to logarithmic bin ids."""
    e = torch.as_tensor(log_bin_edges(pc)[1:-1], dtype=torch.float32)
    x = torch.as_tensor(lengths).to(torch.float32)
    idx = torch.searchsorted(e, x, right=True)
    return idx.clamp(0, pc.num_bins - 1).to(torch.int32)
