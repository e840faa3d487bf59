"""Mixture-of-experts MLP with sort-based capacity dispatch.

Ported from the reference ``repro.models.moe`` on one device: the routed
tokens of a call are one shard, so ``moe_mlp`` is the reference's
single-shard path (its shard-local ``vmap`` is for a TPU mesh). Shapes are
static: tokens go into an (E, C, d) buffer with capacity
C = ceil(T * k / E * capacity_factor) slots an expert (at least 4), taken
in a stable sort by expert; a token past its expert's capacity lands in an
overflow bin and contributes 0 (dropped-token semantics). The expert
products are plain batched matmuls, as in the reference, where they run
outside any Pallas kernel.

Nothing here synchronises with the host: expert counts come from a
``scatter_add_`` (not ``bincount``), the token index of each routed entry
from an ``expand`` (not ``repeat_interleave`` with tensor repeats), and the
combine sums each token's k contributions after putting them back in
token order through the inverse of the sort (not ``index_add_``, whose
floating-point sums are not deterministic on the card). Ties among router
probabilities go to the lower expert index, as ``jax.lax.top_k`` breaks
them: the top k come from a stable descending sort.

A dropless call on the cached path (``moe_mlp`` with ``live``, where
``expert_capacity`` holds every token: no expert can then overflow, since
a token's k experts are distinct) routes only the tokens that hold one:
a dead token's entries go to a sentinel expert E that sorts last, each
expert's entries are found by a stable sort (``group``), and the experts
run over them alone (``ops.moe_experts``: the grouped kernel on the card,
which reads no weight of an expert that no live token routes to; its plain
version on the CPU). With nothing dropped, a live token's output is what
it would be with the dead tokens removed, and a dead token's routed output
is 0. Calls that can drop keep the sort dispatch, whose capacity counts
the dead tokens too, as the reference's does (ROADMAP Queue 3).

The router's aux loss follows Switch: aux = E * sum_e f_e * p_e, with f_e
the share of tokens whose first choice is e and p_e the mean router
probability of e. ``moe_mlp_dense`` (every expert on every token) is the
oracle.

Weights are passed as an object holding ``moe_router`` (d, E), kept in the
parameter dtype and used in float32, and ``moe_w_gate``/``moe_w_up``
(E, d, ff) and ``moe_w_down`` (E, ff, d), cast to the activation's dtype at
use.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.metrics.spans import detail
from repro_torch.models.layers import gated_mlp


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Per-expert token slot budget for ``n_tokens`` routed tokens."""
    cap = math.ceil(n_tokens * cfg.experts_per_token / cfg.num_experts
                    * cfg.capacity_factor)
    return max(cap, 4)


def top_k(cfg: ModelConfig, router: torch.Tensor, hf: torch.Tensor):
    """hf: (t,d) -> (probs (t,E) f32, top_p (t,k) f32, top_i (t,k) int64):
    float32 router logits and softmax; the top k by a stable descending
    sort (ties to the lower index), renormalised to sum to 1."""
    logits = hf.float() @ router.float()
    probs_full = torch.softmax(logits, dim=-1)                   # (t,E)
    k = cfg.experts_per_token
    top_p, top_i = torch.sort(probs_full, dim=-1, descending=True,
                              stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    return probs_full, top_p / top_p.sum(dim=-1, keepdim=True), top_i


def route(cfg: ModelConfig, router: torch.Tensor, hf: torch.Tensor):
    """hf: (t,d) -> (top_p (t,k) f32, top_i (t,k) int64, aux scalar f32):
    ``top_k`` and the router's aux loss."""
    probs_full, top_p, top_i = top_k(cfg, router, hf)
    E, t = cfg.num_experts, hf.shape[0]
    first = top_i[:, 0]
    f = torch.zeros(E, device=hf.device).scatter_add_(
        0, first, torch.ones_like(first, dtype=torch.float32)) / t  # (E,)
    pbar = probs_full.mean(dim=0)
    aux = E * (f * pbar).sum()
    return top_p, top_i, aux


def experts(p, xe: torch.Tensor) -> torch.Tensor:
    """The gated-SiLU expert MLPs over (E, C, d) rows -> (E, C, d)."""
    dt = xe.dtype
    g = F.silu(torch.bmm(xe, p.moe_w_gate.to(dt)))
    u = torch.bmm(xe, p.moe_w_up.to(dt))
    return torch.bmm(g * u, p.moe_w_down.to(dt))


def dispatch(cfg: ModelConfig, top_p, top_i, hf):
    """Sort the t*k routed entries by expert (stable, so in token order
    within an expert) and copy each kept token into its expert's next
    free slot. Returns (xe (E,C,d), slot, keep, sorted weights, order):
    ``slot`` is each sorted entry's row of the flattened buffer, E*C (the
    overflow bin) for one past its expert's capacity."""
    t, d = hf.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    C = expert_capacity(cfg, t)
    dev = hf.device
    flat_e = top_i.reshape(t * k)
    flat_tok = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_tok[order], top_p.reshape(t * k)[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=dev) - starts[se]
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)     # E*C = overflow bin
    # only the overflow bin, which is dropped, takes duplicate writes
    buf = hf.new_zeros((E * C + 1, d)).index_copy(0, slot, hf[st])
    return buf[:E * C].reshape(E, C, d), slot, keep, sw, order


def combine(ye, slot, keep, sw, order, t: int):
    """Each sorted entry's expert output times its router weight (0 when
    dropped), put back in token order through the inverse of the sort and
    summed over each token's k entries. ye: (E,C,d) -> (t,d)."""
    d = ye.shape[-1]
    dt = ye.dtype
    yflat = torch.cat([ye.reshape(-1, d), ye.new_zeros((1, d))])
    contrib = yflat[slot] * sw[:, None].to(dt) * keep[:, None].to(dt)
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    return contrib[inverse].reshape(t, -1, d).sum(dim=1)


def moe_tokens(cfg: ModelConfig, p, hf: torch.Tensor):
    """Sort-based dispatch over one token shard. hf: (t,d) -> ((t,d), aux)."""
    with detail("moe.route"):
        top_p, top_i, aux = route(cfg, p.moe_router, hf)
    with detail("moe.dispatch"):
        xe, slot, keep, sw, order = dispatch(cfg, top_p, top_i, hf)
    with detail("moe.experts"):
        ye = experts(p, xe)
    with detail("moe.combine"):
        return combine(ye, slot, keep, sw, order, hf.shape[0]), aux


def group(cfg: ModelConfig, top_i, live):
    """Sort the t*k routed entries of the live tokens by expert (stable,
    so in token order within an expert); a dead token's entries go to the
    sentinel expert E and sort last. Returns (entry (t*k,) int32, each
    sorted entry's token-major index token * k + j; offsets (E+1,) int32,
    each expert's first sorted position, offsets[E] the live entries)."""
    t, k = top_i.shape
    E = cfg.num_experts
    flat_e = torch.where(live[:, None], top_i, E).reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(E + 1, dtype=torch.int32,
                         device=top_i.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return order.to(torch.int32), offsets


def moe_live_tokens(cfg: ModelConfig, p, hf: torch.Tensor, live):
    """The experts over the live tokens alone, for a dropless call on the
    cached path. hf: (t,d); live: (t,) bool -> ((t,d), aux 0: the cached
    path drops the router's aux loss, so none is computed); a dead
    token's output is 0. Each token's k weighted expert outputs are summed
    in float32 in a fixed order and rounded once."""
    t, d = hf.shape
    k = cfg.experts_per_token
    dt = hf.dtype
    with detail("moe.route"):
        _, top_p, top_i = top_k(cfg, p.moe_router, hf)
    with detail("moe.dispatch"):
        entry, offsets = group(cfg, top_i, live)
    with detail("moe.experts"):
        contrib = ops.moe_experts(hf, p.moe_w_gate.to(dt), p.moe_w_up.to(dt),
                                  p.moe_w_down.to(dt), entry, offsets,
                                  top_p.reshape(t * k), k)
    with detail("moe.combine"):
        y = contrib.reshape(t, k, d).sum(dim=1)
        return torch.where(live[:, None], y, 0.0).to(dt), 0.0


def dropless(cfg: ModelConfig, n_tokens: int) -> bool:
    """Whether no expert can overflow in a call of ``n_tokens`` tokens:
    each token's k experts are distinct, so an expert takes at most
    ``n_tokens`` entries."""
    return expert_capacity(cfg, n_tokens) >= n_tokens


def shared_expert(p, x: torch.Tensor) -> torch.Tensor:
    """The shared expert (granite-4.0-h): a gated-SiLU MLP that every token
    takes beside its routed experts, ``shared_w_gate``/``shared_w_up``
    (d, ff_s) and ``shared_w_down`` (ff_s, d)."""
    with detail("moe.shared"):
        return gated_mlp(x, p.shared_w_gate, p.shared_w_up, p.shared_w_down)


def moe_mlp(cfg: ModelConfig, p, h: torch.Tensor, live=None):
    """h: (B,S,d) -> (out (B,S,d), aux loss scalar). ``live`` (B,S) bool
    marks the positions that hold a token (the cached path); None: all
    do. A dropless call with ``live`` runs the experts over the live
    tokens alone (``moe_live_tokens``; a dead position's routed output is
    0, and no aux loss is computed: the aux returned is 0). Otherwise
    capacity comes from all B * S routed tokens of the call,
    padded and inactive rows included, as in the reference. With
    ``cfg.shared_expert_ff`` the shared expert's output is added to the
    routed experts'."""
    B, S, d = h.shape
    hf = h.reshape(B * S, d)
    if live is not None and dropless(cfg, B * S):
        out, aux = moe_live_tokens(cfg, p, hf, live.reshape(B * S))
    else:
        out, aux = moe_tokens(cfg, p, hf)
    out = out.reshape(B, S, d)
    if cfg.shared_expert_ff:
        out = out + shared_expert(p, h)
    return out, aux


def moe_mlp_dense(cfg: ModelConfig, p, h: torch.Tensor):
    """One-hot dense-dispatch oracle (every expert computes every token,
    E/k times the sparse path's work; nothing is dropped)."""
    B, S, d = h.shape
    T = B * S
    hf = h.reshape(T, d)
    top_p, top_i, aux = route(cfg, p.moe_router, hf)
    w = torch.zeros((T, cfg.num_experts), dtype=torch.float32,
                    device=h.device).scatter_(1, top_i, top_p)
    dt = h.dtype
    g = F.silu(torch.einsum("td,edf->tef", hf, p.moe_w_gate.to(dt)))
    u = torch.einsum("td,edf->tef", hf, p.moe_w_up.to(dt))
    ye = torch.einsum("tef,efd->ted", g * u, p.moe_w_down.to(dt))
    out = torch.einsum("ted,te->td", ye.float(), w)
    return out.to(dt).reshape(B, S, d), aux
