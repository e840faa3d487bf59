"""Attention: GQA with position-based masking, over slot or paged caches.

Ported from the reference ``repro.models.attention``. All masks derive from
absolute positions: query positions ``q_pos`` (B, S) and key positions
``kpos``/``pkpos``, -1 marking an inactive query or an empty slot.
Causality is ``k_pos <= q_pos``; sliding windows add ``k_pos > q_pos - W``,
so ring-buffer caches need no special-case masking: the stored position of
an overwritten slot simply moves forward.

Two cache layouts:

* slot caches (``k``/``v``/``kpos``), one row of slots per sequence: the
  contiguous layout (slot = position) and the rings of sliding-window
  layers (slot = position % ring, under either engine layout); under
  ``cfg.kv_quant`` int8 K/V with float32 per-(token, KV head) scales
  (``k_scale``/``v_scale``);
* the paged cache (``pk``/``pv``/``pkpos``): K/V in a pool of fixed-size
  pages shared by every sequence and addressed through a (B, pmax) block
  table; physical page 0 is the null page, whose ``pkpos`` stays -1.

Unlike the reference, which returns a new cache, ``cache_write`` and
``paged_cache_write`` update the cache in place (``index_copy_``): a
full-size cache is gigabytes and must not be copied per layer. Decode
attention and the paged prefill attention go through
``repro_torch.kernels.ops`` (the CUDA kernels for tensors on the card,
their plain versions in ``kernels/ref.py`` on the CPU). The prefill chunk
of a slot cache attends with ``attend`` in plain torch, as the reference
does outside any Pallas kernel. The training path's full-sequence
attention (``self_attention_full``: causal in the decoder, non-causal in
the whisper encoder) goes through ``ops.flash_attention`` inside a
``torch.autograd.Function`` whose backward differentiates the plain
version. Cross-attention over the encoder's K/V is plain ``attend``, as
in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import apply_rope, cdtype


def project_qkv(cfg: ModelConfig, p, hq: torch.Tensor, hkv=None):
    """hq: (B,S,d) queries source; hkv: (B,M,d) keys/values source.

    ``p`` holds the projections ``wq``/``wk``/``wv`` (and ``bq``/``bk``/
    ``bv`` under ``cfg.qkv_bias``); each is cast to ``hq``'s dtype at use.
    """
    hkv = hq if hkv is None else hkv
    dt = hq.dtype
    q = hq @ p.wq.to(dt)
    k = hkv @ p.wk.to(dt)
    v = hkv @ p.wv.to(dt)
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    B = hq.shape[0]
    q = q.reshape(B, hq.shape[1], cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, hkv.shape[1], cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, hkv.shape[1], cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


# ---------------------------------------------------------------------------
# Core attention with position masks (plain torch)
# ---------------------------------------------------------------------------

ATTEND_BLOCK_K = 1024          # KV block for the online-softmax path
ATTEND_DENSE_LIMIT = 1 << 24   # use dense scores below S*M of ~16M elements


def _mask(q_pos, k_pos, window: int, causal: bool):
    """(B,1,1,S,M) validity of key positions for query positions."""
    kp = k_pos[:, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & (kp > qp - window)
    return valid


def _scores(cfg: ModelConfig, qg, k, scale: float):
    """Scaled, soft-capped float32 scores (B,KH,G,S,M), computed in place
    after the product to keep one (S, M) buffer per step."""
    s = torch.einsum("bskgh,bmkh->bkgsm", qg, k.float()).mul_(scale)
    if cfg.attn_logit_softcap:
        cap = cfg.attn_logit_softcap
        s.div_(cap).tanh_().mul_(cap)
    return s


def _differentiable(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def attend(cfg: ModelConfig, q, k, v, q_pos, k_pos, *, window: int = 0,
           causal: bool = True):
    """q: (B,S,H,hd); k/v: (B,M,KH,hd); q_pos: (B,S); k_pos: (B,M).

    Returns (B,S,H,hd) in q's dtype. float32 softmax; GQA via head
    grouping; a query with nothing valid comes out as 0. Large S*M takes
    the blocked online-softmax path (O(S*block) memory instead of O(S*M);
    same semantics). Both compute in place to save memory; under autograd
    (the training path's cross-attention) the dense path runs out of
    place instead, so that its backward sees what its forward saw.
    """
    S, M = q.shape[1], k.shape[1]
    if _differentiable(q, k, v):
        return _attend_dense_autograd(cfg, q, k, v, q_pos, k_pos,
                                      window=window, causal=causal)
    if S * M > ATTEND_DENSE_LIMIT and M > ATTEND_BLOCK_K:
        return _attend_blocked(cfg, q, k, v, q_pos, k_pos, window=window,
                               causal=causal)
    return _attend_dense(cfg, q, k, v, q_pos, k_pos, window=window,
                         causal=causal)


def _attend_dense(cfg: ModelConfig, q, k, v, q_pos, k_pos, *, window: int,
                  causal: bool):
    B, S, H, hd = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, S, KH, H // KH, hd).float()
    valid = _mask(q_pos, k_pos, window, causal)
    s = _scores(cfg, qg, k, cfg.score_scale).masked_fill_(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = s.sub_(m).exp_().masked_fill_(~valid, 0.0)
    p.div_(p.sum(dim=-1, keepdim=True).clamp_min_(1e-30))
    out = torch.einsum("bkgsm,bmkh->bskgh", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _attend_dense_autograd(cfg: ModelConfig, q, k, v, q_pos, k_pos, *,
                           window: int, causal: bool):
    B, S, H, hd = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, S, KH, H // KH, hd).float()
    valid = _mask(q_pos, k_pos, window, causal)
    s = torch.einsum("bskgh,bmkh->bkgsm", qg, k.float()) * cfg.score_scale
    if cfg.attn_logit_softcap:
        s = torch.tanh(s / cfg.attn_logit_softcap) * cfg.attn_logit_softcap
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(~valid, 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgsm,bmkh->bskgh", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _attend_blocked(cfg: ModelConfig, q, k, v, q_pos, k_pos, *, window: int,
                    causal: bool, block: int = ATTEND_BLOCK_K):
    B, S, H, hd = q.shape
    M, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, S, KH, G, hd).float()
    m_run = torch.full((B, KH, G, S), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros_like(m_run)
    acc = torch.zeros((B, KH, G, S, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, M, block):
        kc, vc = k[:, c0:c0 + block], v[:, c0:c0 + block]
        valid = _mask(q_pos, k_pos[:, c0:c0 + block], window, causal)
        s = _scores(cfg, qg, kc, cfg.score_scale).masked_fill_(~valid,
                                                               NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = s.sub_(m_new[..., None]).exp_().masked_fill_(~valid, 0.0)
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgsm,bmkh->bkgsh", p, vc.float())
        m_run = m_new
    out = acc / l_run.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Training-path attention (no cache): full causal sequences
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """``ops.flash_attention`` with a gradient.

    The forward runs the kernel (on the card; the plain version on the CPU)
    and saves q, k and v. The reference has no backward kernel (``jax.grad``
    differentiates its plain ``attend``), so the backward recomputes the
    plain version under autograd and returns its dq, dk and dv. ``causal``
    (default on) is off for the whisper encoder's self-attention; ``scale``
    is the score scale (None: head_dim**-0.5).
    """

    @staticmethod
    def forward(ctx, q, k, v, window: int, softcap: float,
                causal: bool = True, scale: float | None = None):
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.softcap, ctx.causal = window, softcap, causal
        ctx.scale = scale
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.flash_attention_ref(q, k, v, causal=ctx.causal,
                                          window=ctx.window,
                                          softcap=ctx.softcap,
                                          scale=ctx.scale)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
        return dq, dk, dv, None, None, None, None


def self_attention_full(cfg: ModelConfig, p, h, *, window: int = 0,
                        causal: bool = True):
    """Training-path attention over whole sequences at positions 0..S-1:
    causal for the decoder, not for the whisper encoder. h: (B,S,d) ->
    (B,S,d); ``p`` holds the projections."""
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device).expand(B, S)
    q, k, v = project_qkv(cfg, p, h)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                               window, cfg.attn_logit_softcap, causal,
                               cfg.score_scale)
    return out.reshape(B, S, cfg.q_dim) @ p.wo.to(h.dtype)


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder -> encoder output)
# ---------------------------------------------------------------------------

def cross_kv(cfg: ModelConfig, p, enc_out):
    """The encoder's K/V for one decoder layer's cross-attention, computed
    once per request batch. enc_out: (B,T,d) -> k, v: (B,T,KH,hd). ``p``
    holds that layer's cross projections (``wk``/``wv``, and ``bk``/``bv``
    under ``cfg.qkv_bias``)."""
    B, T = enc_out.shape[:2]
    dt = enc_out.dtype
    k = enc_out @ p.wk.to(dt)
    v = enc_out @ p.wv.to(dt)
    if cfg.qkv_bias:
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    return (k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim))


def cross_attention(cfg: ModelConfig, p, h, ck, cv):
    """h: (B,S,d) decoder states; ck/cv: (B,T,KH,hd) -> (B,S,d).

    Non-causal over all T keys, in plain torch (``attend``) as in the
    reference: the ``flash_attention`` kernel takes K/V only as long as
    its queries."""
    B, S = h.shape[:2]
    dt = h.dtype
    q = h @ p.wq.to(dt)
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    T = ck.shape[1]
    qp = torch.zeros((B, S), dtype=torch.int32, device=h.device)
    kp = torch.zeros((B, T), dtype=torch.int32, device=h.device)
    out = attend(cfg, q, ck, cv, qp, kp, causal=False)
    return out.reshape(B, S, cfg.q_dim) @ p.wo.to(dt)


# ---------------------------------------------------------------------------
# Self-attention over a slot cache (prefill chunk / decode)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  window: int = 0, device="cuda") -> dict:
    """A stacked slot cache for a run of ``n_layers`` identical layers.

    Each row holds ``min(window, max_len)`` ring slots for a windowed
    layer, else ``max_len`` slots, plus one sink slot at the end: the
    writes that the reference drops land there (see ``cache_write``), and
    its ``kpos`` stays -1, so it is never attended. With ``cfg.kv_quant``
    the K/V payload is int8 with float32 per-(token, KV head) scales
    ``k_scale``/``v_scale`` of shape (n_layers, batch, slots + 1, KH), as
    in the reference: half the bytes of a bf16 cache, for MHA decode
    shapes whose bf16 cache does not fit (qwen1.5-32b).
    """
    slots = min(window, max_len) if window else max_len
    shape = (n_layers, batch, slots + 1, cfg.num_kv_heads, cfg.head_dim)
    cache = {"kpos": torch.full(shape[:3], -1, dtype=torch.int32,
                                device=device)}
    kv_dtype = torch.int8 if cfg.kv_quant else cdtype(cfg)
    for name in ("k", "v"):
        cache[name] = torch.zeros(shape, dtype=kv_dtype, device=device)
        if cfg.kv_quant:
            cache[name + "_scale"] = torch.zeros(shape[:4],
                                                 dtype=torch.float32,
                                                 device=device)
    return cache


def _quantize(x):
    """x: (B,S,KH,hd) -> (int8 values, float32 per-(token, head) scales).

    As the reference computes it: the scale is max |x| / 127 (at least
    1e-12), and the values round(x / scale), half to even, clipped to
    +-127; the division is kept (not a multiply by the reciprocal), so the
    payloads and scales equal the reference's in float32."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-12)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    """Invert ``_quantize``: int8 values times per-(token, head) scales,
    in float32."""
    return q.float() * scale[..., None].float()


def cache_write(cache_l: dict, k_new, v_new, positions, window: int):
    """Write S new entries per sequence into one layer's slot cache, in place.

    cache_l: {"k": (B,slots+1,KH,hd), "v": ..., "kpos": (B,slots+1)};
    k_new/v_new: (B,S,KH,hd); positions: (B,S) absolute (-1 = inactive).
    Position p goes to slot ``p % slots`` when windowed (a ring), else to
    slot p. As in the reference (``mode="drop"``), inactive positions and,
    without a window, positions past the last slot are not written; and
    where several entries of one call map to the same slot (a chunk longer
    than the ring) the last one wins. Both hold without a host
    synchronisation and deterministically on the card, where
    ``index_copy_`` gives duplicate indices no defined winner: every entry
    that must not land, dropped or overtaken, is sent to the row's sink
    slot (index ``slots``) with position -1, so the sink's ``kpos`` stays
    -1 and its K/V, whichever entry wins there, are never attended. The
    last entry per slot is found with a ``scatter_reduce`` of ``amax`` over
    the entry index, which has one answer. An int8 cache (``k_scale`` and
    ``v_scale`` present) takes the quantised values and their scales
    through the same slot index.
    """
    kpos = cache_l["kpos"]
    B, M, KH, hd = cache_l["k"].shape
    slots = M - 1
    S = positions.shape[1]
    ok = positions >= 0
    if window:
        slot = positions % slots
    else:
        slot = positions
        ok = ok & (positions < slots)
    slot = torch.where(ok, slot, slots).long()
    if S > 1:
        src = torch.arange(S, device=slot.device).expand(B, S)
        last = torch.full((B, M), -1, dtype=torch.long, device=slot.device)
        last.scatter_reduce_(1, slot, src, "amax")
        ok = ok & (last.gather(1, slot) == src)
        slot = torch.where(ok, slot, slots)
    rows = torch.arange(B, device=slot.device)[:, None] * M
    flat = (rows + slot).reshape(-1)
    for name, new in (("k", k_new), ("v", v_new)):
        if name + "_scale" in cache_l:      # int8: the values and scales
            new, scale = _quantize(new)
            cache_l[name + "_scale"].view(B * M, KH).index_copy_(
                0, flat, scale.reshape(-1, KH))
        cache_l[name].view(B * M, KH, hd).index_copy_(
            0, flat, new.reshape(-1, KH, hd).to(cache_l[name].dtype))
    kpos.view(B * M).index_copy_(
        0, flat, torch.where(ok, positions, -1).reshape(-1).to(torch.int32))
    return cache_l


def self_attention_cached(cfg: ModelConfig, p, h, cache_l, q_pos, *,
                          window: int = 0):
    """One layer of cached self-attention over a slot cache.

    h: (B,S,d); cache_l holds this layer's slots (updated in place); q_pos:
    (B,S) absolute positions of the chunk tokens. Returns (out (B,S,d),
    cache_l). Decode (S=1) writes the token first and attends over the
    updated cache with the flash-decode kernel (an int8 cache with its
    scales): a ring slot overwritten by the new token held a position <=
    q_pos - window, already masked. A prefill chunk attends over the
    pre-write cache (an int8 one dequantised into the chunk's dtype) plus
    the fresh, unquantised in-chunk K/V, then writes: writing first would
    let ring slots be overwritten by later in-chunk tokens that earlier
    queries still need.
    """
    q, k, v = project_qkv(cfg, p, h)
    if cfg.use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    B, S = h.shape[:2]
    if S == 1:
        cache_write(cache_l, k, v, q_pos, window)
        out = ops.decode_attention(
            q[:, 0].contiguous(), cache_l["k"], cache_l["v"], cache_l["kpos"],
            q_pos[:, 0].contiguous(), window=window,
            softcap=cfg.attn_logit_softcap, k_scale=cache_l.get("k_scale"),
            v_scale=cache_l.get("v_scale"), scale=cfg.score_scale)[:, None]
        return out.reshape(B, S, cfg.q_dim) @ p.wo.to(h.dtype), cache_l
    if "k_scale" in cache_l:
        k_cache = dequantize(cache_l["k"], cache_l["k_scale"]).to(k.dtype)
        v_cache = dequantize(cache_l["v"], cache_l["v_scale"]).to(v.dtype)
    else:
        k_cache, v_cache = cache_l["k"], cache_l["v"]
    k_all = torch.cat([k_cache, k.to(k_cache.dtype)], dim=1)
    v_all = torch.cat([v_cache, v.to(v_cache.dtype)], dim=1)
    kpos_all = torch.cat([cache_l["kpos"], q_pos.to(torch.int32)], dim=1)
    out = attend(cfg, q, k_all, v_all, q_pos, kpos_all, window=window)
    cache_write(cache_l, k, v, q_pos, window)
    return out.reshape(B, S, cfg.q_dim) @ p.wo.to(h.dtype), cache_l


# ---------------------------------------------------------------------------
# Paged self-attention (block-table indirection over a shared page pool)
# ---------------------------------------------------------------------------

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
            softcap=cfg.attn_logit_softcap,
            scale=cfg.score_scale)[:, None]
    else:
        out = ops.paged_decode_attention_multi(
            q.contiguous(), cache_l["pk"], cache_l["pv"], cache_l["pkpos"],
            block_table, q_pos.contiguous(),
            softcap=cfg.attn_logit_softcap, scale=cfg.score_scale)
    return out.reshape(B, S, cfg.q_dim) @ p.wo.to(h.dtype), cache_l
