"""Plain PyTorch versions of the kernels (the semantics contract).

Ported from the reference ``repro.kernels.ref``. The CPU tests hold these
against the JAX package, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card. A wrapper in ``ops.py`` takes them only for
tensors that lie on the CPU.

One deliberate difference from the reference oracle: a query with no
valid key (an inactive row, q_pos = -1) comes out as zeros in both
versions here, as it does in the reference's Pallas kernels and in the
CUDA kernels. The reference ``decode_attention_ref`` (plain softmax)
returns the mean of V for such a row instead.
"""

from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30    # large-negative instead of -inf: keeps softmax NaN-free


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x


def _masked_softmax(scores: torch.Tensor, vmask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in which a row with nothing valid (an
    inactive query, q_pos = -1) comes out as zeros, matching the kernels'
    l = max(sum p, 1e-30) guard."""
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(vmask, torch.exp(scores - m), 0.0)
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def decode_attention_ref(q, k, v, kpos, q_pos, *, window: int = 0,
                         softcap: float = 0.0):
    """q: (B,H,hd) one query/row; k/v: (B,M,KH,hd); kpos: (B,M); q_pos: (B,)."""
    B, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, hd).float()
    scores = torch.einsum("bkgh,bmkh->bkgm", qg, k.float()) * (hd ** -0.5)
    scores = _softcap(scores, softcap)
    valid = (kpos >= 0) & (kpos <= q_pos[:, None])
    if window:
        valid &= kpos > (q_pos[:, None] - window)
    vmask = valid[:, None, None, :]
    scores = torch.where(vmask, scores, NEG_INF)
    out = torch.einsum("bkgm,bmkh->bkgh", _masked_softmax(scores, vmask),
                       v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, kpos_pages, block_table,
                               q_pos, *, window: int = 0,
                               softcap: float = 0.0):
    """q: (B,H,hd); k/v_pages: (P,ps,KH,hd) shared page pool; kpos_pages:
    (P,ps); block_table: (B,pmax) int32 (0 = null page, kpos -1); q_pos: (B,).

    Gathers each sequence's pages in logical order and runs the contiguous
    decode version over the flattened view.
    """
    B = q.shape[0]
    KH, hd = k_pages.shape[2], k_pages.shape[3]
    bt = block_table.long()
    k = k_pages[bt].reshape(B, -1, KH, hd)
    v = v_pages[bt].reshape(B, -1, KH, hd)
    kpos = kpos_pages[bt].reshape(B, -1)
    return decode_attention_ref(q, k, v, kpos, q_pos, window=window,
                                softcap=softcap)


def paged_decode_attention_multi_ref(q, k_pages, v_pages, kpos_pages,
                                     block_table, q_pos, *, window: int = 0,
                                     softcap: float = 0.0):
    """q: (B,T,H,hd); q_pos: (B,T) (-1 = inactive query); pool args as in
    ``paged_decode_attention_ref``. All T queries attend over the gathered
    pages (position-mask causality); a query with nothing valid, such as
    an inactive one, comes out as zeros.
    """
    B, T, H, hd = q.shape
    KH = k_pages.shape[2]
    G = H // KH
    bt = block_table.long()
    k = k_pages[bt].reshape(B, -1, KH, hd)
    v = v_pages[bt].reshape(B, -1, KH, hd)
    kpos = kpos_pages[bt].reshape(B, -1)
    qg = q.reshape(B, T, KH, G, hd).float()
    scores = torch.einsum("btkgh,bmkh->bkgtm", qg, k.float()) * (hd ** -0.5)
    scores = _softcap(scores, softcap)
    valid = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= q_pos[:, :, None])
    if window:
        valid &= kpos[:, None, :] > (q_pos[:, :, None] - window)
    vmask = valid[:, None, None]
    scores = torch.where(vmask, scores, NEG_INF)
    out = torch.einsum("bkgtm,bmkh->btkgh", _masked_softmax(scores, vmask),
                       v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)
