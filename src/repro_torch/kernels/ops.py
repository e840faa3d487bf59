"""Public kernel wrappers: dispatch on the device of the query tensor.

A tensor that lies on the CPU goes to the plain PyTorch version in
``ref.py`` (that is how the CPU tests run the model). A tensor on the
``meta`` device goes to the plain version too: there it computes the
output's shape and dtype alone and allocates nothing (that is how the dry
run, ``launch.dryrun``, runs a step at full size). A CUDA tensor goes to
the hand-written kernel, which launches or raises: nothing here falls
back from a kernel to its plain version, and nothing computes on meta.
The kernels' launch counts are ``launches`` (reset with
``reset_launches``). Each kernel call opens the detail span
``kernel.<key of launches>`` (``repro_torch.metrics.spans``) around its
binding: the checks, the arguments and the launch, on the host.

``META_KERNEL`` lets a caller stand in for a kernel call on meta: set to
``fn(plain, *args, **kwargs)``, each such call returns ``fn``'s result.
The dry run's footprint count uses it to count a call's outputs alone,
which is all that the kernel allocates on the card, where the plain
version holds float32 copies of whole caches on its way.
"""

from __future__ import annotations

from contextvars import ContextVar

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import probe as _probe
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssm_state_update as _ssm_upd
from repro_torch.metrics.spans import detail

launches = build.launches
reset_launches = build.reset_launches

#: devices whose tensors take the plain versions
_PLAIN_DEVICES = ("cpu", "meta")

#: the stand-in for a kernel call on meta (see the module docstring)
META_KERNEL: ContextVar = ContextVar("META_KERNEL", default=None)


def _plain(fn, *args, **kwargs):
    """The plain version ``fn`` on CPU or meta tensors (on meta through
    ``META_KERNEL`` when one is set); ``args[0]`` is the tensor the
    wrapper dispatched on."""
    hook = META_KERNEL.get()
    if hook is None or args[0].device.type != "meta":
        return fn(*args, **kwargs)
    return hook(fn, *args, **kwargs)


def decode_attention(q, k, v, kpos, q_pos, *, window=0, softcap=0.0,
                     k_scale=None, v_scale=None, scale=None):
    """Single-step decode attention against a contiguous or ring slot
    cache; an int8 cache comes with its per-(slot, KV head) float32
    scales ``k_scale``/``v_scale``. Each attention wrapper takes the
    score ``scale`` (None: head_dim**-0.5)."""
    if q.device.type in _PLAIN_DEVICES:
        return _plain(ref.decode_attention_ref, q, k, v, kpos, q_pos,
                      window=window, softcap=softcap, k_scale=k_scale,
                      v_scale=v_scale, scale=scale)
    with detail("kernel.decode_attention_int8" if k.dtype == torch.int8
                else "kernel.decode_attention"):
        return _dec.decode_attention(q, k, v, kpos, q_pos, window=window,
                                     softcap=softcap, k_scale=k_scale,
                                     v_scale=v_scale, scale=scale)


def paged_decode_attention(q, k_pages, v_pages, kpos_pages, block_table,
                           q_pos, *, window=0, softcap=0.0, scale=None):
    """Single-step decode attention against a paged KV cache."""
    if q.device.type in _PLAIN_DEVICES:
        return _plain(ref.paged_decode_attention_ref, q, k_pages, v_pages,
                      kpos_pages, block_table, q_pos, window=window,
                      softcap=softcap, scale=scale)
    with detail("kernel.paged_decode_attention"):
        return _paged.paged_decode_attention(
            q, k_pages, v_pages, kpos_pages, block_table, q_pos,
            window=window, softcap=softcap, scale=scale)


def paged_decode_attention_multi(q, k_pages, v_pages, kpos_pages,
                                 block_table, q_pos, *, window=0,
                                 softcap=0.0, scale=None):
    """Multi-query decode attention against a paged KV cache."""
    if q.device.type in _PLAIN_DEVICES:
        return _plain(ref.paged_decode_attention_multi_ref, q, k_pages,
                      v_pages, kpos_pages, block_table, q_pos, window=window,
                      softcap=softcap, scale=scale)
    with detail("kernel.paged_decode_attention_multi"):
        return _paged.paged_decode_attention_multi(
            q, k_pages, v_pages, kpos_pages, block_table, q_pos,
            window=window, softcap=softcap, scale=scale)


def probe_update(tap, w1, b1, w2, b2, q_prev, T):
    """Fused TRAIL probe step: probe MLP, softmax and one Bayes-filter
    step. Returns (q_new, p), both float32."""
    if tap.device.type in _PLAIN_DEVICES:
        return _plain(ref.probe_update_ref, tap, w1, b1, w2, b2, q_prev, T)
    with detail("kernel.probe_update"):
        return _probe.probe_update(tap, w1, b1, w2, b2, q_prev, T)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None):
    """Full-sequence attention (training and profiling forwards).
    q: (B,S,H,hd); k/v: (B,S,KH,hd) -> (B,S,H,hd) in q's dtype."""
    if q.device.type in _PLAIN_DEVICES:
        return _plain(ref.flash_attention_ref, q, k, v, causal=causal,
                      window=window, softcap=softcap, scale=scale)
    with detail("kernel.flash_attention"):
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      softcap=softcap, scale=scale)


def ssd_scan(x, dt, A, Bm, Cm, init_state=None, *, chunk):
    """Chunked SSD (Mamba-2) scan from ``init_state`` (None: zeros).
    x: (B,L,nh,hp); dt: (B,L,nh); A: (nh,); Bm/Cm: (B,L,N) -> (y
    (B,L,nh,hp), final state (B,nh,hp,N)), both float32. The kernel
    raises on an input that requires a gradient: ``models.ssm.SSDScan``
    gives the scan its gradient."""
    if x.device.type in _PLAIN_DEVICES:
        return _plain(ref.ssd_scan_ref, x, dt, A, Bm, Cm, init_state,
                      chunk=chunk)
    with detail("kernel.ssd_scan"):
        return _ssd.ssd_scan(x, dt, A, Bm, Cm, init_state, chunk=chunk)


def ssm_state_update(state, x, dt, A, Bm, Cm, D, keep):
    """Mamba-2 single-token update of the float32 SSM state, in place.
    state: (B,nh,hp,N); x: (B,nh,hp); dt: (B,nh) post-softplus; A, D:
    (nh,); Bm/Cm: (B,N); keep: (B,) bool -> y (B,nh,hp) float32. Rows
    where ``keep`` is False keep their state bit for bit and get y = 0."""
    if state.device.type in _PLAIN_DEVICES:
        return _plain(ref.ssm_state_update_ref, state, x, dt, A, Bm, Cm, D,
                      keep)
    with detail("kernel.ssm_state_update"):
        return _ssm_upd.ssm_state_update(state, x, dt, A, Bm, Cm, D, keep)
