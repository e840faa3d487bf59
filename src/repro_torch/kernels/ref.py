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

from repro_torch.core.predictor import apply_probe
from repro_torch.core.smoothing import bayes_update

NEG_INF = -2.0 ** 30    # large-negative instead of -inf: keeps softmax NaN-free


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x


def score_scale(scale: float | None, hd: int) -> float:
    """The attention score scale: ``scale``, or hd^-0.5 where it is None
    (here and in the kernels' bindings)."""
    return hd ** -0.5 if scale is None else float(scale)


def _masked_softmax(scores: torch.Tensor, vmask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in which a row with nothing valid (an
    inactive query, q_pos = -1) comes out as zeros, matching the kernels'
    l = max(sum p, 1e-30) guard."""
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(vmask, torch.exp(scores - m), 0.0)
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float | None = None):
    """q: (B,S,H,hd); k/v: (B,S,KH,hd) -> (B,S,H,hd) in q's dtype.

    Dense-position attention over one sequence: key j is valid for the
    query at position i when j <= i (``causal``) and j > i - ``window``
    (``window`` > 0). Scores are float32, scaled by ``scale`` (None:
    hd^-0.5) and soft-capped before the mask; masked keys get probability
    exactly 0. Only the S real keys exist here, so none past the sequence ever counts (the
    reference's Pallas kernel lets its zero padding in when not causal).
    """
    B, S, H, hd = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, S, KH, H // KH, hd).float()
    scores = torch.einsum("bskgh,bmkh->bkgsm", qg, k.float()) * score_scale(
        scale, hd)
    scores = _softcap(scores, softcap)
    pos = torch.arange(S, device=q.device)
    qi, ki = pos[:, None], pos[None, :]
    valid = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        valid &= ki <= qi
    if window:
        valid &= ki > qi - window
    scores = torch.where(valid, scores, NEG_INF)
    out = torch.einsum("bkgsm,bmkh->bskgh", _masked_softmax(scores, valid),
                       v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _deq(x, scale):
    """x in float32, times its per-(token, KV head) scale when given (an
    int8 cache), as the reference's ``attend`` dequantises."""
    x = x.float()
    return x if scale is None else x * scale[..., None].float()


def decode_attention_ref(q, k, v, kpos, q_pos, *, window: int = 0,
                         softcap: float = 0.0, k_scale=None, v_scale=None,
                         scale: float | None = None):
    """q: (B,H,hd) one query/row; k/v: (B,M,KH,hd); kpos: (B,M); q_pos: (B,).

    k_scale/v_scale: (B,M,KH) float32 scales of an int8 cache (None for a
    float one); each K/V row is dequantised by its scale."""
    B, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, hd).float()
    scores = torch.einsum("bkgh,bmkh->bkgm", qg, _deq(k, k_scale)) * \
        score_scale(scale, hd)
    scores = _softcap(scores, softcap)
    valid = (kpos >= 0) & (kpos <= q_pos[:, None])
    if window:
        valid &= kpos > (q_pos[:, None] - window)
    vmask = valid[:, None, None, :]
    scores = torch.where(vmask, scores, NEG_INF)
    out = torch.einsum("bkgm,bmkh->bkgh", _masked_softmax(scores, vmask),
                       _deq(v, v_scale))
    return out.reshape(B, H, hd).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, kpos_pages, block_table,
                               q_pos, *, window: int = 0,
                               softcap: float = 0.0,
                               scale: float | None = None):
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
                                softcap=softcap, scale=scale)


def paged_decode_attention_multi_ref(q, k_pages, v_pages, kpos_pages,
                                     block_table, q_pos, *, window: int = 0,
                                     softcap: float = 0.0,
                                     scale: float | None = None):
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
    scores = torch.einsum("btkgh,bmkh->bkgtm", qg, k.float()) * score_scale(
        scale, hd)
    scores = _softcap(scores, softcap)
    valid = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= q_pos[:, :, None])
    if window:
        valid &= kpos[:, None, :] > (q_pos[:, :, None] - window)
    vmask = valid[:, None, None]
    scores = torch.where(vmask, scores, NEG_INF)
    out = torch.einsum("bkgtm,bmkh->btkgh", _masked_softmax(scores, vmask),
                       v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


def probe_update_ref(tap, w1, b1, w2, b2, q_prev, T):
    """Fused probe + Bayes filter. tap: (B,d); w1: (d,hid); w2: (hid,k);
    q_prev: (B,k); T: (k,k). Returns (q_new (B,k), p (B,k) the probe's
    softmax), both float32."""
    p = torch.softmax(apply_probe({"w1": w1, "b1": b1, "w2": w2, "b2": b2},
                                  tap), dim=-1)
    return bayes_update(q_prev.float(), p, T), p


def ssd_scan_ref(x, dt, A, Bm, Cm, init_state=None, *, chunk: int):
    """Chunked SSD scan (Mamba-2), the form the reference model computes
    (``models/ssm.py`` ``ssd_chunked``), all float32 inside.

    x: (B,L,nh,hp); dt: (B,L,nh) post-softplus; A: (nh,) negative; Bm/Cm:
    (B,L,N) shared by the heads; init_state: (B,nh,hp,N) or None (zeros);
    ``chunk`` divides L. Per chunk, with cum the inclusive cumsum of dt*A:
    y_t = sum_{s<=t} (C_t.B_s) exp(cum_t - cum_s) dt_s x_s
          + exp(cum_t) C_t S^T, and S <- exp(cum_Q) S
          + sum_s dt_s exp(cum_Q - cum_s) x_s B_s^T.
    Returns (y (B,L,nh,hp) float32, final state (B,nh,hp,N) float32).
    A position with dt = 0 leaves the state as it is.
    """
    Bsz, L, nh, hp = x.shape
    N = Bm.shape[-1]
    if L % chunk:
        raise ValueError(f"chunk {chunk} does not divide L={L}")
    nc = L // chunk
    f32 = torch.float32
    xr = x.reshape(Bsz, nc, chunk, nh, hp).to(f32)
    dtr = dt.reshape(Bsz, nc, chunk, nh).to(f32)
    Br = Bm.reshape(Bsz, nc, chunk, N).to(f32)
    Cr = Cm.reshape(Bsz, nc, chunk, N).to(f32)
    cum = torch.cumsum(dtr * A.to(f32), dim=2)            # (B,nc,Q,nh)

    # intra-chunk: exp(cum_t - cum_s) only where s <= t (it overflows above
    # the diagonal, and inf * 0 would be NaN in the product or its gradient)
    CB = torch.einsum("bctn,bcsn->bcts", Cr, Br)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,t,s,nh)
    dec = torch.exp(torch.where(tri[:, :, None], diff, -torch.inf))
    M = CB[..., None] * dec * dtr[:, :, None, :, :]
    y_intra = torch.einsum("bctsh,bcshp->bcthp", M, xr)

    # chunk summaries and the recurrence over chunks
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtr           # (B,nc,Q,nh)
    Sc = torch.einsum("bcsh,bcshp,bcsn->bchpn", w, xr, Br)
    chunk_dec = torch.exp(cum[:, :, -1, :])                # (B,nc,nh)
    S = (torch.zeros((Bsz, nh, hp, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    S_prev = []
    for c in range(nc):
        S_prev.append(S)
        S = chunk_dec[:, c, :, None, None] * S + Sc[:, c]
    S_prev = torch.stack(S_prev, dim=1)                    # (B,nc,nh,hp,N)
    y_inter = torch.einsum("bctn,bcth,bchpn->bcthp", Cr, torch.exp(cum),
                           S_prev)
    return (y_intra + y_inter).reshape(Bsz, L, nh, hp), S


def ssm_state_update_ref(state, x, dt, A, Bm, Cm, D, keep):
    """Mamba-2 single-token state update, in place on ``state``, as the
    reference model's decode step computes it (``models/ssm.py``
    ``ssm_decode_step``), all float32.

    state: (B,nh,hp,N) float32; x: (B,nh,hp); dt: (B,nh) post-softplus; A:
    (nh,) negative; Bm/Cm: (B,N) shared by the heads; D: (nh,); keep: (B,)
    bool. Where ``keep``, with a = exp(dt A):
    s <- a s + dt x B^T and y = s C + D x (with the new s); elsewhere the
    state stays as it was, bit for bit, and y is 0. Returns y (B,nh,hp).
    """
    a = torch.exp(dt * A)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, x, Bm)
    new = a[:, :, None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", new, Cm) + D[None, :, None] * x
    state.copy_(torch.where(keep[:, None, None, None], new, state))
    return torch.where(keep[:, None, None], y, 0.0)


def moe_experts_ref(hf, w_gate, w_up, w_down, entry, offsets, weight,
                    k: int):
    """Each expert's gated-SiLU MLP over the entries routed to it, as the
    grouped kernel computes it (``csrc/moe_experts.cu``): products in
    float32 on the activation dtype's values, the activation
    silu(g) * u rounded once to that dtype, the down product scaled by
    the entry's router weight.

    hf: (T,d); w_gate/w_up: (E,d,ff); w_down: (E,ff,d); entry: (T*k,) int,
    the entries token * k + j sorted by expert; offsets: (E+1,) int, expert
    e's entries at sorted positions offsets[e] .. offsets[e+1] - 1 (the
    first offsets[E] are live); weight: (T*k,) float32, token-major.
    Returns (T*k, d) float32, 0 on the rows of entries that are not live.
    Reads the offsets on the host: a plain version, not for a graph."""
    T, d = hf.shape
    out = torch.zeros((T * k, d), dtype=torch.float32, device=hf.device)
    bounds = offsets.tolist()
    for e in range(w_gate.shape[0]):
        if bounds[e] == bounds[e + 1]:
            continue
        q = entry[bounds[e]:bounds[e + 1]].long()
        x = hf[q // k].float()
        g = x @ w_gate[e].float()
        act = (torch.nn.functional.silu(g) * (x @ w_up[e].float())).to(
            hf.dtype)
        out[q] = (act.float() @ w_down[e].float()) * weight[q, None]
    return out
