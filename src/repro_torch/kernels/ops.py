"""Public kernel wrappers: dispatch on the device of the query tensor.

A tensor that lies on the CPU goes to the plain PyTorch version in
``ref.py`` (that is how the CPU tests run the model). A CUDA tensor goes
to the hand-written kernel, which launches or raises: nothing here falls
back from a kernel to its plain version. The kernels' launch counts are
``launches`` (reset with ``reset_launches``).
"""

from __future__ import annotations

from repro_torch.kernels import build, ref
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import probe as _probe
from repro_torch.kernels import ssd_scan as _ssd

launches = build.launches
reset_launches = build.reset_launches


def decode_attention(q, k, v, kpos, q_pos, *, window=0, softcap=0.0,
                     k_scale=None, v_scale=None):
    """Single-step decode attention against a contiguous or ring slot
    cache; an int8 cache comes with its per-(slot, KV head) float32
    scales ``k_scale``/``v_scale``."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, kpos, q_pos, window=window,
                                        softcap=softcap, k_scale=k_scale,
                                        v_scale=v_scale)
    return _dec.decode_attention(q, k, v, kpos, q_pos, window=window,
                                 softcap=softcap, k_scale=k_scale,
                                 v_scale=v_scale)


def paged_decode_attention(q, k_pages, v_pages, kpos_pages, block_table,
                           q_pos, *, window=0, softcap=0.0):
    """Single-step decode attention against a paged KV cache."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(
            q, k_pages, v_pages, kpos_pages, block_table, q_pos,
            window=window, softcap=softcap)
    return _paged.paged_decode_attention(
        q, k_pages, v_pages, kpos_pages, block_table, q_pos, window=window,
        softcap=softcap)


def paged_decode_attention_multi(q, k_pages, v_pages, kpos_pages,
                                 block_table, q_pos, *, window=0,
                                 softcap=0.0):
    """Multi-query decode attention against a paged KV cache."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention_multi_ref(
            q, k_pages, v_pages, kpos_pages, block_table, q_pos,
            window=window, softcap=softcap)
    return _paged.paged_decode_attention_multi(
        q, k_pages, v_pages, kpos_pages, block_table, q_pos, window=window,
        softcap=softcap)


def probe_update(tap, w1, b1, w2, b2, q_prev, T):
    """Fused TRAIL probe step: probe MLP, softmax and one Bayes-filter
    step. Returns (q_new, p), both float32."""
    if tap.device.type == "cpu":
        return ref.probe_update_ref(tap, w1, b1, w2, b2, q_prev, T)
    return _probe.probe_update(tap, w1, b1, w2, b2, q_prev, T)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Full-sequence attention (training and profiling forwards).
    q: (B,S,H,hd); k/v: (B,S,KH,hd) -> (B,S,H,hd) in q's dtype."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap)


def ssd_scan(x, dt, A, Bm, Cm, init_state=None, *, chunk):
    """Chunked SSD (Mamba-2) scan from ``init_state`` (None: zeros).
    x: (B,L,nh,hp); dt: (B,L,nh); A: (nh,); Bm/Cm: (B,L,N) -> (y
    (B,L,nh,hp), final state (B,nh,hp,N)), both float32. The kernel
    raises on an input that requires a gradient: ``models.ssm.SSDScan``
    gives the scan its gradient."""
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm, init_state, chunk=chunk)
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, init_state, chunk=chunk)
