"""Attention: GQA with position-based masking, over a paged KV pool.

Ported from the reference ``repro.models.attention``. All masks derive from
absolute positions: query positions ``q_pos`` (B, S) and key positions
``pkpos``, -1 marking an inactive query or an empty slot. Causality is
``k_pos <= q_pos``.

The paged cache holds K/V in a pool of fixed-size pages shared by every
sequence and addressed through a (B, pmax) block table; physical page 0 is
the null page, whose ``pkpos`` stays -1. Unlike the reference, which
returns a new cache, ``paged_cache_write`` updates the pool in place
(``index_copy_``): a full-size pool is gigabytes and must not be copied
per layer. Attention itself always goes through ``repro_torch.kernels.ops``:
the CUDA kernels for tensors on the card, their plain versions
(``kernels/ref.py``) for tensors on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, cdtype


def project_qkv(cfg: ModelConfig, p, hq: torch.Tensor, hkv=None):
    """hq: (B,S,d) queries source; hkv: (B,M,d) keys/values source.

    ``p`` holds the projections ``wq``/``wk``/``wv`` (and ``bq``/``bk``/
    ``bv`` under ``cfg.qkv_bias``) in the compute dtype.
    """
    hkv = hq if hkv is None else hkv
    q = hq @ p.wq
    k = hkv @ p.wk
    v = hkv @ p.wv
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    B = hq.shape[0]
    q = q.reshape(B, hq.shape[1], cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, hkv.shape[1], cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, hkv.shape[1], cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def init_paged_kv_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                        n_layers: int, device="cuda") -> dict:
    """A paged cache for a run of ``n_layers`` global-attention layers.

    K/V live in a pool of ``num_pages`` fixed-size pages shared by every
    sequence; per-sequence block tables (held at the cache's top level)
    map logical page ``pos // page_size`` to a physical page. Physical
    page 0 is the null page: its ``pkpos`` stays -1, so block-table rows
    can point unallocated logical pages at it and masking does the rest.
    """
    if cfg.kv_quant:
        raise NotImplementedError("paged KV does not support kv_quant yet")
    shape = (n_layers, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "pkpos": torch.full((n_layers, num_pages, page_size), -1,
                            dtype=torch.int32, device=device),
        "pk": torch.zeros(shape, dtype=cdtype(cfg), device=device),
        "pv": torch.zeros(shape, dtype=cdtype(cfg), device=device),
    }


def paged_cache_write(cache_l: dict, k_new, v_new, positions, block_table):
    """Write S new entries per sequence through the block table, in place.

    cache_l: {"pk": (P,ps,KH,hd), "pv": ..., "pkpos": (P,ps)};
    k_new/v_new: (B,S,KH,hd); positions: (B,S) absolute (-1 = inactive);
    block_table: (B, pmax). Writes resolving to the null page (0) or past
    the table are dropped: they are redirected to slot 0 of the null page
    with that slot's own current contents, so nothing changes there and
    no host synchronisation is needed to filter them out.
    """
    pk, pv, pkpos = cache_l["pk"], cache_l["pv"], cache_l["pkpos"]
    P, ps, KH, hd = pk.shape
    pmax = block_table.shape[1]
    pidx = torch.div(positions, ps, rounding_mode="floor")
    page_ids = torch.gather(block_table, 1, pidx.clamp(0, pmax - 1).long())
    ok = (positions >= 0) & (pidx < pmax) & (page_ids > 0)
    flat = torch.where(ok, page_ids * ps + positions % ps, 0).reshape(-1).long()
    okf = ok.reshape(-1)
    for pool, new in ((pk, k_new), (pv, v_new)):
        flat_pool = pool.view(P * ps, KH, hd)
        vals = torch.where(okf[:, None, None],
                           new.reshape(-1, KH, hd).to(pool.dtype),
                           flat_pool[0])
        flat_pool.index_copy_(0, flat, vals)
    flat_pos = pkpos.view(P * ps)
    flat_pos.index_copy_(0, flat, torch.where(
        okf, positions.reshape(-1).to(torch.int32), flat_pos[0]))
    return cache_l


def self_attention_paged(cfg: ModelConfig, p, h, cache_l, q_pos, block_table):
    """One layer of paged cached self-attention (global attention only).

    h: (B,S,d); q_pos: (B,S). Returns (out (B,S,d), cache_l updated in
    place). The new K/V are written first; then the flash-decode kernels
    attend over the pool through the block table, the position mask
    giving causality: single-query for decode (S=1), multi-query for
    prefill chunks.
    """
    q, k, v = project_qkv(cfg, p, h)
    if cfg.use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    B, S = h.shape[:2]
    paged_cache_write(cache_l, k, v, q_pos, block_table)
    if S == 1:
        out = ops.paged_decode_attention(
            q[:, 0].contiguous(), cache_l["pk"], cache_l["pv"],
            cache_l["pkpos"], block_table, q_pos[:, 0].contiguous(),
            softcap=cfg.attn_logit_softcap)[:, None]
    else:
        out = ops.paged_decode_attention_multi(
            q.contiguous(), cache_l["pk"], cache_l["pv"], cache_l["pkpos"],
            block_table, q_pos.contiguous(),
            softcap=cfg.attn_logit_softcap)
    return out.reshape(B, S, cfg.q_dim) @ p.wo, cache_l
