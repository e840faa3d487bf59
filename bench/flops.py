"""Operation and byte counts of the work a step did, and the chip's peaks.

A frozen copy of the arithmetic of ``repro_torch/launch/analysis.py``
(``model_flops_estimate``: 2 N per token for inference plus the attention
terms 4 * q_dim * keys per layer; the H100's published peaks), computed
from the configuration file's numbers and the shapes of the work alone, so
that they read the same work whatever kernel a later change runs there.

Counts are per token or per call, summed by the callers. Bytes count each
input read once and each output written once, at the dtype the
configuration states (bfloat16: 2 bytes).

These counts are those of a pre-norm attention decoder, dense or MoE, in
which every layer attends. The readers take them from ``Record.work``: this
module, or the ``work`` of a configuration's model module (``models/``),
which has the same functions (``step_flops``, ``decode_attn_bytes``,
``prefill_attn_work``, ``attn_layers``) for its own architecture. The
peaks and ``bound_s`` are the chip's and stay here.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, dense bfloat16 FLOP/s and HBM3 bytes/s (data sheet)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
ACT_BYTES = 2


def q_dim(m: dict) -> int:
    """Width of the query projection."""
    return m["num_heads"] * m["head_dim"]


def kv_dim(m: dict) -> int:
    """Width of the key (or value) projection."""
    return m["num_kv_heads"] * m["head_dim"]


def attn_layers(m: dict) -> int:
    """Layers whose attention the paged kernels run: every layer."""
    return m["num_layers"]


def layer_params(m: dict) -> int:
    """Parameters one token touches in one layer: the attention
    projections and the MLP, or for a mixture of experts the router and
    the ``experts_per_token`` experts it picks."""
    d, ff = m["d_model"], m["d_ff"]
    attn = 2 * d * q_dim(m) + 2 * d * kv_dim(m)
    if m.get("num_experts"):
        return attn + d * m["num_experts"] + \
            m["experts_per_token"] * 3 * d * ff
    return attn + 3 * d * ff


def trunk_flops(m: dict) -> float:
    """Matmul FLOPs of one token through every layer (2 per parameter)."""
    return 2.0 * m["num_layers"] * layer_params(m)


def unembed_flops(m: dict) -> float:
    """FLOPs of one token's logits over the vocabulary."""
    return 2.0 * m["vocab_size"] * m["d_model"]


def attn_flops(m: dict, keys: int) -> float:
    """QK^T and PV of one query over ``keys`` keys, every layer."""
    return 4.0 * q_dim(m) * keys * attn_layers(m)


def prefill_row_flops(m: dict, start: int, n: int) -> float:
    """Model FLOPs of n prompt positions from ``start`` on in one row: the
    trunk for each, and causal attention over start + i + 1 keys. No
    logits: decode consumes a prompt's last token."""
    keys = n * start + n * (n + 1) // 2
    return n * trunk_flops(m) + attn_flops(m, keys)


def decode_token_flops(m: dict, keys: int) -> float:
    """Model FLOPs of one emitted token whose query sees ``keys`` keys."""
    return trunk_flops(m) + unembed_flops(m) + attn_flops(m, keys)


def decode_attn_bytes(m: dict, keys: int) -> float:
    """Bytes one single-query attention needs in every layer: K and V of
    ``keys`` positions, the query read and the output written."""
    return attn_layers(m) * ACT_BYTES * (2 * keys * kv_dim(m) +
                                         2 * q_dim(m))


def prefill_attn_work(m: dict, start: int, n: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one layer's causal chunk attention for a row of
    n queries from ``start`` on: QK^T and PV over start + i + 1 keys each;
    K and V of start + n positions, the queries and the outputs."""
    keys = n * start + n * (n + 1) // 2
    flops = 4.0 * q_dim(m) * keys
    nbytes = ACT_BYTES * (2 * (start + n) * kv_dim(m) + 2 * n * q_dim(m))
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)


def step_flops(m: dict, prefill: list, decode: list) -> float:
    """Model FLOPs of one step's useful work: each row's prompt positions
    fed, (start, n), and each row's emitted tokens, (keys seen by its
    first, n), the t-th of which sees t more keys."""
    work = sum(prefill_row_flops(m, st, n) for st, n in prefill)
    return work + sum(decode_token_flops(m, keys + t)
                      for keys, n in decode for t in range(n))
