"""A configuration's model module, as a configuration file names it
(``"model_module": NAME`` for ``models/NAME.py``): a hybrid of Mamba-2
mixers and attention layers, ``layer_kinds`` of ``"ssm"`` and ``"attn"``.
The tests lay it out in a throwaway cell; no cell of ``BENCHMARK.json``
uses it.

It exports what the harness takes from such a module (``harness.Models``):
``STD``, the scales of the mixer's leaves, merged over ``weights.STD``;
``Reference``, the plain reference with the mixer in its ``"ssm"`` layers;
and ``work``, the operation and byte counts of the hybrid's work, with
``flops``'s functions.
"""

from types import SimpleNamespace

import flops
import torch
from reference import Reference as Base

#: standard deviation of each Mamba-2 leaf, by the last part of its name
STD = {
    "in_proj": lambda m: m["d_model"] ** -0.5,
    "out_proj": lambda m: (m["ssm_expand"] * m["d_model"]) ** -0.5,
    "conv_w": lambda m: m["ssm_conv"] ** -0.5,
    "conv_b": lambda m: 0.1,
    "dt_bias": lambda m: 0.1,
    "A_log": lambda m: 0.1,
    "D": lambda m: 0.1,
    "norm_scale": lambda m: 0.1,
}


def dims(m: dict) -> tuple[int, int, int]:
    """(inner width, heads, state width) of a Mamba-2 mixer."""
    d_in = m["ssm_expand"] * m["d_model"]
    return d_in, d_in // m["ssm_head_dim"], m["ssm_groups"] * m["ssm_state"]


class Reference(Base):
    """``reference.Reference`` with a Mamba-2 mixer in the ``"ssm"``
    layers: the input projection into z, x, B, C and dt; a causal
    depthwise convolution and SiLU over x, B and C; dt through softplus
    after its bias; the state recurrence h = exp(dt A) h + dt x B^T, read
    as y = h C + D x, one position after another; y gated by SiLU(z), an
    RMSNorm with a ``1 + scale`` gain, and the output projection. The
    mixer is the layer (no MLP). The control rounds the inputs of the two
    projections and of the recurrence's products to float8."""

    def _layer(self, li, x, pos, lens):
        if self.m["layer_kinds"][li] != "ssm":
            return super()._layer(li, x, pos, lens)
        pre = f"layers.{li}."
        hn = self._norm(x, pre + "norm1")
        return x + torch.cat([self._mixer(h, pre)
                              for h in hn.split(lens)])

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
    """Layers that attend: the ``"attn"`` ones."""
    return sum(k == "attn" for k in m["layer_kinds"])


def mixer_params(m: dict) -> int:
    """Matmul parameters of one mixer: the two projections."""
    d_in, nh, N = dims(m)
    return m["d_model"] * (2 * d_in + 2 * N + nh) + d_in * m["d_model"]


def trunk_flops(m: dict) -> float:
    """Matmul FLOPs of one token through every layer, with the mixers'
    recurrence (the state's update and its read, 2 each per element)."""
    d_in, _, N = dims(m)
    n_ssm = m["num_layers"] - attn_layers(m)
    return 2.0 * (attn_layers(m) * flops.layer_params(m) +
                  n_ssm * mixer_params(m)) + n_ssm * 4.0 * d_in * N


def step_flops(m: dict, prefill: list, decode: list) -> float:
    """``flops.step_flops`` with this trunk and attention in the
    ``"attn"`` layers alone."""
    def attn(keys):
        return 4.0 * flops.q_dim(m) * keys * attn_layers(m)
    work = sum(n * trunk_flops(m) + attn(n * st + n * (n + 1) // 2)
               for st, n in prefill)
    return work + sum(trunk_flops(m) + flops.unembed_flops(m) +
                      attn(keys + t) for keys, n in decode
                      for t in range(n))


def decode_attn_bytes(m: dict, keys: int) -> float:
    """``flops.decode_attn_bytes`` over the ``"attn"`` layers alone."""
    return flops.decode_attn_bytes(m, keys) / m["num_layers"] * \
        attn_layers(m)


work = SimpleNamespace(attn_layers=attn_layers, step_flops=step_flops,
                       decode_attn_bytes=decode_attn_bytes,
                       prefill_attn_work=flops.prefill_attn_work)
