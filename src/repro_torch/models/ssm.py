"""Mamba-2 SSD (state-space duality) mixer. [arXiv:2405.21060]

Prefill chunks and training forwards run the chunked SSD scan through the
``SSDScan`` Function: its forward is ``kernels.ops.ssd_scan`` (the CUDA
kernel on the card, its plain version on the CPU), its backward
differentiates the plain version. Decode is the O(1) recurrent update in
plain torch, as in the reference ``repro.models.ssm``, which has no kernel
for it.

State of one layer, per row:
  ssm_state: (B, nh, hp, N) float32 — the running SSD state
  conv_buf:  (B, W-1, C_conv) float32 — the last W-1 pre-conv inputs

Unlike the reference, a cached chunk advances each row's state by exactly
its valid tokens (``q_pos >= 0``, a contiguous prefix): the other
positions get dt = 0, which decays by exp(0) = 1 and injects nothing, and
the conv buffer is cut at the row's last valid token. Outputs at valid
positions are unchanged by that. The reference runs every row over every
position of the chunk, so padding and rows that take no part leak into
its recurrent state.

``p`` is any object holding the layer's SSM weights as attributes
(``in_proj``, ``out_proj``, ``conv_w``, ``conv_b``, ``dt_bias``,
``A_log``, ``D``, ``norm_scale``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops, ref


def ssm_dims(cfg: ModelConfig):
    """Derived SSM sizes: (inner dim, n_heads, conv channels)."""
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_in, nh, conv_ch


def _split_zxbcdt(cfg: ModelConfig, proj):
    d_in, nh, conv_ch = ssm_dims(cfg)
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + conv_ch]
    dt = proj[..., d_in + conv_ch:]
    assert dt.shape[-1] == nh
    return z, xbc, dt


def _causal_conv(p, xbc, conv_buf=None, n_valid=None):
    """Depthwise causal conv of width W as W shifted adds, in float32.

    xbc: (B,L,C); conv_buf: (B,W-1,C) history or None (zeros); n_valid:
    (B,) valid tokens per row, or None (all L). Returns (out (B,L,C) in
    xbc's dtype, new_buf (B,W-1,C)): the W-1 inputs before position
    n_valid of [conv_buf; xbc], so a row with no valid token keeps its
    buffer.
    """
    W = p.conv_w.shape[0]
    B, L, C = xbc.shape
    if conv_buf is None:
        conv_buf = torch.zeros((B, W - 1, C), dtype=xbc.dtype,
                               device=xbc.device)
    ext = torch.cat([conv_buf.to(xbc.dtype), xbc], dim=1)    # (B,W-1+L,C)
    out = torch.zeros((B, L, C), dtype=torch.float32, device=xbc.device)
    for i in range(W):
        out = out + ext[:, i:i + L].float() * p.conv_w[i].float()
    out = F.silu(out + p.conv_b.float()).to(xbc.dtype)
    if n_valid is None:
        return out, ext[:, L:]
    idx = n_valid.long()[:, None] + torch.arange(W - 1, device=xbc.device)
    return out, ext.gather(1, idx[..., None].expand(B, W - 1, C))


def _gated_out(cfg: ModelConfig, p, y, z, out_dtype):
    """Gate with silu(z), the gated RMSNorm of Mamba-2, out_proj."""
    y = y * F.silu(z.float())
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * (1.0 + p.norm_scale.float())
    return y.to(out_dtype) @ p.out_proj.to(out_dtype)


class SSDScan(torch.autograd.Function):
    """``ops.ssd_scan`` with a gradient.

    The forward runs the kernel (on the card; the plain version on the
    CPU) and saves its inputs. The reference has no backward kernel
    (``jax.grad`` differentiates its plain ``ssd_chunked``), so the
    backward recomputes the plain version, float32 inside, under autograd
    and returns the gradients of x, dt, A, Bm, Cm and the initial state,
    each in its input's dtype.
    """

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk: int):
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        ctx.chunk = chunk
        return ops.ssd_scan(x, dt, A, Bm, Cm, init_state, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, ds):
        ins = [None if t is None else t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in ins if t is not None and t.requires_grad]
        with torch.enable_grad():
            outs = ref.ssd_scan_ref(*ins, chunk=ctx.chunk)
        grads = iter(torch.autograd.grad(outs, wanted, (dy, ds)))
        return (*(next(grads) if t is not None and t.requires_grad else None
                  for t in ins), None)


def ssm_forward(cfg: ModelConfig, p, h, state=None, conv_buf=None,
                q_pos=None):
    """Full-sequence or chunk forward. h: (B,L,d); state (B,nh,hp,N) and
    conv_buf (B,W-1,C) carried from earlier chunks, or None (zeros);
    q_pos: (B,L) positions, -1 where the chunk holds no token of the row
    (a contiguous valid prefix), or None (all valid).

    Returns (out (B,L,d), (new_state, new_conv_buf)). The scan runs in
    chunks of ``min(cfg.ssm_chunk, L)`` halved until they divide L.
    """
    d_in, nh, _ = ssm_dims(cfg)
    N = cfg.ssm_groups * cfg.ssm_state
    hp = cfg.ssm_head_dim
    B, L = h.shape[:2]
    proj = h @ p.in_proj.to(h.dtype)
    z, xbc, dt_raw = _split_zxbcdt(cfg, proj)
    n_valid = None if q_pos is None else (q_pos >= 0).sum(dim=1)
    xbc, new_buf = _causal_conv(p, xbc, conv_buf, n_valid)
    x = xbc[..., :d_in].reshape(B, L, nh, hp)
    Bm = xbc[..., d_in:d_in + N]
    Cm = xbc[..., d_in + N:]
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())
    if q_pos is not None:
        dt = torch.where(q_pos[..., None] >= 0, dt, 0.0)
    A = -torch.exp(p.A_log.float())
    chunk = min(cfg.ssm_chunk, L)
    while L % chunk:          # chunk must divide L; fall back to smaller
        chunk //= 2
    y, S_fin = SSDScan.apply(x.contiguous(), dt.contiguous(), A,
                             Bm.contiguous(), Cm.contiguous(), state, chunk)
    y = y.to(x.dtype)        # the reference's chunked scan returns x's dtype
    y = y.float() + p.D.float()[None, None, :, None] * x.float()
    return (_gated_out(cfg, p, y.reshape(B, L, d_in), z, h.dtype),
            (S_fin, new_buf))


def ssm_decode_step(cfg: ModelConfig, p, h, state, conv_buf):
    """One-token recurrent update. h: (B,1,d); state: (B,nh,hp,N);
    conv_buf: (B,W-1,C). Returns (out (B,1,d), (state, conv_buf)), new
    tensors for every row (the caller keeps inactive rows' old state)."""
    d_in, nh, _ = ssm_dims(cfg)
    N = cfg.ssm_groups * cfg.ssm_state
    hp = cfg.ssm_head_dim
    B = h.shape[0]
    proj = h @ p.in_proj.to(h.dtype)                         # (B,1,zxbcdt)
    z, xbc, dt_raw = _split_zxbcdt(cfg, proj)
    xbc, new_buf = _causal_conv(p, xbc, conv_buf)
    x = xbc[:, 0, :d_in].reshape(B, nh, hp).float()
    Bm = xbc[:, 0, d_in:d_in + N].float()
    Cm = xbc[:, 0, d_in + N:].float()
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias.float())    # (B,nh)
    a = torch.exp(dt * -torch.exp(p.A_log.float()))
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, x, Bm)
    state = a[:, :, None, None] * state.float() + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cm)
    y = y + p.D.float()[None, :, None] * x
    return (_gated_out(cfg, p, y.reshape(B, 1, d_in), z, h.dtype),
            (state, new_buf))


def init_ssm_state(cfg: ModelConfig, batch: int, n_layers: int,
                   device="cuda") -> dict:
    """Zeroed per-layer state of a run (SSM state and conv buffer)."""
    d_in, nh, conv_ch = ssm_dims(cfg)
    N = cfg.ssm_groups * cfg.ssm_state
    return {
        "ssm_state": torch.zeros((n_layers, batch, nh, cfg.ssm_head_dim, N),
                                 dtype=torch.float32, device=device),
        "conv_buf": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=torch.float32, device=device),
    }


def update_state(cache_l: dict, state, conv_buf, keep=None) -> None:
    """Write a layer's new SSM state and conv buffer into its cache in
    place; with ``keep`` (B,) bool, rows where it is False keep their old
    values (the reference's ``_mask_recurrent`` select, on the device)."""
    old_s, old_b = cache_l["ssm_state"], cache_l["conv_buf"]
    if keep is not None:
        state = torch.where(keep[:, None, None, None], state, old_s)
        conv_buf = torch.where(keep[:, None, None], conv_buf.to(old_b.dtype),
                               old_b)
    old_s.copy_(state)
    old_b.copy_(conv_buf)
