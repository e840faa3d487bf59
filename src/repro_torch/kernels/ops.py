"""Public kernel wrappers: dispatch on the device of the query tensor.

A tensor that lies on the CPU goes to the plain PyTorch version in
``ref.py`` (that is how the CPU tests run the model). A CUDA tensor goes
to the hand-written kernel, which launches or raises: nothing here falls
back from a kernel to its plain version. The kernels' launch counts are
``launches`` (reset with ``reset_launches``).
"""

from __future__ import annotations

from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import ref

launches = _paged.launches
reset_launches = _paged.reset_launches


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
