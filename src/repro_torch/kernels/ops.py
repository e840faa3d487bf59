"""Public kernel wrappers: dispatch on the device of the query tensor.

A tensor that lies on the CPU goes to the plain PyTorch version in
``ref.py`` (that is how the CPU tests run the model). A tensor on the
``meta`` device gets empty meta outputs of the shapes and dtypes the
plain version returns, and nothing runs: that is how the dry run,
``launch.dryrun``, runs a step at full size and counts what a kernel
allocates on the card, its outputs alone. A CUDA tensor goes to the
hand-written kernel, which launches or raises: nothing here falls back
from a kernel to its plain version. The kernels' launch counts are
``launches`` (reset with ``reset_launches``). Each kernel call opens the
detail span ``kernel.<key of launches>`` (``repro_torch.metrics.spans``)
around its binding: the checks, the arguments and the launch, on the
host."""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_experts as _moe
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import probe as _probe
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssm_state_update as _ssm_upd
from repro_torch.metrics.spans import detail

launches = build.launches
reset_launches = build.reset_launches

def decode_attention(q, k, v, kpos, q_pos, *, window=0, softcap=0.0,
                     k_scale=None, v_scale=None, scale=None):
    """Single-step decode attention against a contiguous or ring slot
    cache; an int8 cache comes with its per-(slot, KV head) float32
    scales ``k_scale``/``v_scale``. Each attention wrapper takes the
    score ``scale`` (None: head_dim**-0.5)."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, kpos, q_pos, window=window,
                                        softcap=softcap, k_scale=k_scale,
                                        v_scale=v_scale, scale=scale)
    with detail("kernel.decode_attention_int8" if k.dtype == torch.int8
                else "kernel.decode_attention"):
        return _dec.decode_attention(q, k, v, kpos, q_pos, window=window,
                                     softcap=softcap, k_scale=k_scale,
                                     v_scale=v_scale, scale=scale)


def paged_decode_attention(q, k_pages, v_pages, kpos_pages, block_table,
                           q_pos, *, window=0, softcap=0.0, scale=None):
    """Single-step decode attention against a paged KV cache."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(
            q, k_pages, v_pages, kpos_pages, block_table, q_pos,
            window=window, softcap=softcap, scale=scale)
    with detail("kernel.paged_decode_attention"):
        return _paged.paged_decode_attention(
            q, k_pages, v_pages, kpos_pages, block_table, q_pos,
            window=window, softcap=softcap, scale=scale)


def paged_decode_attention_multi(q, k_pages, v_pages, kpos_pages,
                                 block_table, q_pos, *, window=0,
                                 softcap=0.0, scale=None):
    """Multi-query decode attention against a paged KV cache."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return ref.paged_decode_attention_multi_ref(
            q, k_pages, v_pages, kpos_pages, block_table, q_pos,
            window=window, softcap=softcap, scale=scale)
    with detail("kernel.paged_decode_attention_multi"):
        return _paged.paged_decode_attention_multi(
            q, k_pages, v_pages, kpos_pages, block_table, q_pos,
            window=window, softcap=softcap, scale=scale)


def probe_update(tap, w1, b1, w2, b2, q_prev, T):
    """Fused TRAIL probe step: probe MLP, softmax and one Bayes-filter
    step. Returns (q_new, p), both float32."""
    if tap.device.type == "meta":
        return (torch.empty_like(q_prev, dtype=torch.float32),
                torch.empty_like(q_prev, dtype=torch.float32))
    if tap.device.type == "cpu":
        return ref.probe_update_ref(tap, w1, b1, w2, b2, q_prev, T)
    with detail("kernel.probe_update"):
        return _probe.probe_update(tap, w1, b1, w2, b2, q_prev, T)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None):
    """Full-sequence attention (training and profiling forwards).
    q: (B,S,H,hd); k/v: (B,S,KH,hd) -> (B,S,H,hd) in q's dtype."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
    with detail("kernel.flash_attention"):
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      softcap=softcap, scale=scale)


def ssd_scan(x, dt, A, Bm, Cm, init_state=None, *, chunk):
    """Chunked SSD (Mamba-2) scan from ``init_state`` (None: zeros).
    x: (B,L,nh,hp); dt: (B,L,nh); A: (nh,); Bm/Cm: (B,L,N) -> (y
    (B,L,nh,hp), final state (B,nh,hp,N)), both float32. The kernel
    raises on an input that requires a gradient: ``models.ssm.SSDScan``
    gives the scan its gradient."""
    if x.device.type == "meta":
        B, _, nh, hp = x.shape
        return (torch.empty_like(x, dtype=torch.float32),
                x.new_empty((B, nh, hp, Bm.shape[-1]), dtype=torch.float32))
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm, init_state, chunk=chunk)
    with detail("kernel.ssd_scan"):
        return _ssd.ssd_scan(x, dt, A, Bm, Cm, init_state, chunk=chunk)


def ssm_state_update(state, x, dt, A, Bm, Cm, D, keep):
    """Mamba-2 single-token update of the float32 SSM state, in place.
    state: (B,nh,hp,N); x: (B,nh,hp); dt: (B,nh) post-softplus; A, D:
    (nh,); Bm/Cm: (B,N); keep: (B,) bool -> y (B,nh,hp) float32. Rows
    where ``keep`` is False keep their state bit for bit and get y = 0."""
    if state.device.type == "meta":
        return torch.empty_like(x, dtype=torch.float32)
    if state.device.type == "cpu":
        return ref.ssm_state_update_ref(state, x, dt, A, Bm, Cm, D, keep)
    with detail("kernel.ssm_state_update"):
        return _ssm_upd.ssm_state_update(state, x, dt, A, Bm, Cm, D, keep)


def moe_experts(hf, w_gate, w_up, w_down, entry, offsets, weight, k):
    """The experts of a dropless MoE call over their routed entries.
    hf: (T,d); w_gate/w_up: (E,d,ff), w_down: (E,ff,d); entry: (T*k,)
    int32, the entries token * k + j sorted by expert; offsets: (E+1,)
    int32, each expert's first sorted position (offsets[E] the live
    entries); weight: (T*k,) float32 router weights -> (T*k, d) float32,
    each live entry's weighted expert output on its row (other rows: 0 in
    the plain version, not written by the kernel)."""
    if hf.device.type == "meta":
        return hf.new_empty((entry.shape[0], hf.shape[1]),
                            dtype=torch.float32)
    if hf.device.type == "cpu":
        return ref.moe_experts_ref(hf, w_gate, w_up, w_down, entry, offsets,
                                   weight, k)
    with detail("kernel.moe_experts"):
        return _moe.moe_experts(hf, w_gate, w_up, w_down, entry, offsets,
                                weight, k)
