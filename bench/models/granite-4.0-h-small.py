"""The model module of ``configs/granite-4.0-h-small.json``
(``"model_module": "granite-4.0-h-small"``): IBM's Granite 4.0-H, Mamba-2
mixers and NoPE attention layers, each followed by a mixture of experts
with a shared expert, with Granite's multipliers.

It exports what the harness takes from such a module (``harness.Models``):
``STD``, the scales of the mixer's and the shared expert's leaves, merged
over ``weights.STD``; ``Reference``, the plain reference of this
architecture; and ``work``, the operation and byte counts of its work,
with ``flops``'s functions. It reads the configuration's ``model`` section
alone and imports nothing of the program.
"""

from types import SimpleNamespace

import flops
import torch
from reference import Q_BLOCK
from reference import Reference as Base

#: standard deviation of each leaf the standard scales lack or that this
#: model draws otherwise, by the last part of its name. The embedding is
#: drawn at 0.02 / ``embed_multiplier``, so that the scaled rows entering
#: the trunk have the standard 0.02: drawn at 0.02 itself, the x12 rows
#: outweigh the x0.22 branches of all 20 layers in the tied head, every
#: position's top logit is its own input token (11 standard deviations
#: above the others), and no precision or fault past the embedding moves
#: a served token.
STD = {
    "embed": lambda m: 0.02 / m["embed_multiplier"],
    "in_proj": lambda m: m["d_model"] ** -0.5,
    "out_proj": lambda m: (m["ssm_expand"] * m["d_model"]) ** -0.5,
    "conv_w": lambda m: m["ssm_conv"] ** -0.5,
    "conv_b": lambda m: 0.1,
    "dt_bias": lambda m: 0.1,
    "A_log": lambda m: 0.1,
    "D": lambda m: 0.1,
    "norm_scale": lambda m: 0.1,
    "shared_w_gate": lambda m: m["d_model"] ** -0.5,
    "shared_w_up": lambda m: m["d_model"] ** -0.5,
    "shared_w_down": lambda m: m["shared_expert_ff"] ** -0.5,
}


def dims(m: dict) -> tuple[int, int, int]:
    """(inner width, heads, state width) of a Mamba-2 mixer."""
    d_in = m["ssm_expand"] * m["d_model"]
    return d_in, d_in // m["ssm_head_dim"], m["ssm_groups"] * m["ssm_state"]


class Reference(Base):
    """``reference.Reference`` for Granite 4.0-H.

    The token embeddings times ``embed_multiplier``. Each layer: RMSNorm,
    then in an ``"ssm_moe"`` layer the Mamba-2 mixer (the input projection
    into z, x, B, C and dt; a causal depthwise convolution with bias and
    SiLU over x, B and C; dt through softplus after its bias; the state
    recurrence h = exp(dt A) h + dt x B^T read as y = h C + D x, one
    position after another; y gated by SiLU(z), an RMSNorm with a
    ``1 + scale`` gain, the output projection), in a ``"moe"`` layer
    grouped-query causal attention with no positions (NoPE) and scores
    scaled by ``attn_scale``; the branch times ``residual_multiplier``
    added to the residual. Then RMSNorm, the float32 router's top
    ``experts_per_token`` renormalised, each chosen expert on every token
    that picks it, plus the shared expert on every token; that branch
    times ``residual_multiplier`` too. The logits divided by
    ``logit_divisor``. The control rounds the inputs of every product to
    float8: the projections, experts and shared expert, attention's
    queries, keys, values and probabilities, and the recurrence's x, B
    and C."""

    def _embed(self, ids):
        return super()._embed(ids) * self.m["embed_multiplier"]

    def _rope(self, x, pos):
        return x                                    # NoPE

    def _attention(self, q, k, v):
        """Causal attention of one sequence, scores times ``attn_scale``."""
        S, H, hd = q.shape
        G = H // k.shape[1]
        k = self._act(k).repeat_interleave(G, dim=1)
        v = self._act(v).repeat_interleave(G, dim=1)
        q = self._act(q)
        out = torch.empty_like(q)
        keys = torch.arange(S, device=q.device)
        for a in range(0, S, Q_BLOCK):
            b = min(a + Q_BLOCK, S)
            s = torch.einsum("shd,thd->hst", q[a:b], k[:b]) * \
                self.m["attn_scale"]
            mask = keys[None, :b] > keys[a:b, None]
            s.masked_fill_(mask[None], float("-inf"))
            p = self._act(torch.softmax(s, dim=-1))
            out[a:b] = torch.einsum("hst,thd->shd", p, v[:b])
        return out

    def _layer(self, li, x, pos, lens):
        m = self.m
        pre = f"layers.{li}."
        r = m["residual_multiplier"]
        hn = self._norm(x, pre + "norm1")
        if m["layer_kinds"][li] == "ssm_moe":
            branch = torch.cat([self._mixer(h, pre) for h in hn.split(lens)])
        else:
            branch = self._self_attention(hn, pre, pos, lens)
        x = x + r * branch
        hn = self._norm(x, pre + "norm2")
        return x + r * (self._moe(hn, pre) + self._mlp(hn, pre + "shared_"))

    def _logits(self, xs):
        return super()._logits(xs) / self.m["logit_divisor"]

    def _mixer(self, hn, pre: str):
        """The mixer over one sequence's normed hidden states (T, d)."""
        m, w = self.m, self.w
        d_in, nh, N = dims(m)
        hp = m["ssm_head_dim"]
        T = hn.shape[0]
        proj = self._mm(hn, self._weight(pre + "in_proj"))
        z, xbc = proj[:, :d_in], proj[:, d_in:2 * d_in + 2 * N]
        dt = proj[:, 2 * d_in + 2 * N:]
        cw = w[pre + "conv_w"].float()
        W = cw.shape[0]
        ext = torch.cat([xbc.new_zeros(W - 1, xbc.shape[1]), xbc])
        conv = sum(ext[i:i + T] * cw[i] for i in range(W))
        xbc = torch.nn.functional.silu(conv + w[pre + "conv_b"].float())
        xs = self._act(xbc[:, :d_in]).view(T, nh, hp)
        Bm = self._act(xbc[:, d_in:d_in + N])
        Cm = self._act(xbc[:, d_in + N:])
        dt = torch.nn.functional.softplus(dt + w[pre + "dt_bias"].float())
        decay = torch.exp(dt * -torch.exp(w[pre + "A_log"].float()))
        h = hn.new_zeros(nh, hp, N)
        ys = []
        for t in range(T):
            h = decay[t, :, None, None] * h + \
                dt[t, :, None, None] * xs[t, :, :, None] * Bm[t]
            ys.append(h @ Cm[t])
        y = torch.stack(ys) + w[pre + "D"].float()[:, None] * xs
        y = y.reshape(T, d_in) * torch.nn.functional.silu(z)
        var = y.square().mean(dim=-1, keepdim=True)
        y = y * torch.rsqrt(var + m["norm_eps"]) * \
            (1.0 + w[pre + "norm_scale"].float())
        return self._mm(y, self._weight(pre + "out_proj"))


# -- the counts --------------------------------------------------------------
def attn_layers(m: dict) -> int:
    """Layers that attend: the ``"moe"`` ones."""
    return sum(k == "moe" for k in m["layer_kinds"])


def mixer_params(m: dict) -> int:
    """Matmul parameters of one mixer: the two projections."""
    d_in, nh, N = dims(m)
    return m["d_model"] * (2 * d_in + 2 * N + nh) + d_in * m["d_model"]


def moe_params(m: dict) -> int:
    """Parameters one token touches in one layer's feed-forward part: the
    router, its ``experts_per_token`` experts and the shared expert."""
    d = m["d_model"]
    return d * m["num_experts"] + 3 * d * (
        m["experts_per_token"] * m["d_ff"] + m["shared_expert_ff"])


def attn_params(m: dict) -> int:
    """Matmul parameters of one attention layer's four projections."""
    d = m["d_model"]
    return 2 * d * flops.q_dim(m) + 2 * d * flops.kv_dim(m)


def trunk_flops(m: dict) -> float:
    """FLOPs of one token through every layer, 2 a parameter touched, with
    the mixers' recurrence (the state's update and its read, 2 each per
    element of the state)."""
    d_in, _, N = dims(m)
    n_attn = attn_layers(m)
    n_ssm = m["num_layers"] - n_attn
    return 2.0 * (n_attn * attn_params(m) + n_ssm * mixer_params(m) +
                  m["num_layers"] * moe_params(m)) + n_ssm * 4.0 * d_in * N


def step_flops(m: dict, prefill: list, decode: list) -> float:
    """``flops.step_flops`` for this trunk: useful work only (no dropless
    padding, no unchosen expert), attention in the ``"moe"`` layers."""
    def attn(keys):
        return 4.0 * flops.q_dim(m) * keys * attn_layers(m)
    trunk = trunk_flops(m)
    work = sum(n * trunk + attn(n * st + n * (n + 1) // 2)
               for st, n in prefill)
    return work + sum(trunk + flops.unembed_flops(m) + attn(keys + t)
                      for keys, n in decode for t in range(n))


def decode_attn_bytes(m: dict, keys: int) -> float:
    """``flops.decode_attn_bytes`` over the ``"moe"`` layers alone."""
    return flops.decode_attn_bytes(m, keys) / m["num_layers"] * \
        attn_layers(m)


work = SimpleNamespace(attn_layers=attn_layers, step_flops=step_flops,
                       decode_attn_bytes=decode_attn_bytes,
                       prefill_attn_work=flops.prefill_attn_work)
