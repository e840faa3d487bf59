"""The plain reference: the configuration's forward pass in float32, written
from the configuration file alone with plain ``torch`` operations.

It imports nothing of the program and reads only the weights the benchmark
drew (``weights.Weights.views``) and the token ids it generated and was
served. A pre-norm decoder: RMSNorm with a ``1 + gain`` scale, half-split
RoPE, grouped-query causal attention scaled by ``head_dim ** -0.5``, a
gated-SiLU MLP, or for a mixture of experts a float32 softmax router whose
top ``experts_per_token`` (ties to the lower index) are renormalised and
each run on every token that picks it (dropless), then the final norm and
the logits against the embedding (tied) or unembedding table. The length
probe is a ReLU MLP on the hidden state after layer ``tap_layer``, its
softmax the posterior.

``quant="fp8"`` is the control: the same computation with every input of
a product that the configuration computes in bfloat16 (the projections,
the experts, attention's queries, keys, values and probabilities, and the
hidden states entering the router, the logits and the probe) rounded to
float8 e4m3 with a scale per row, the step below bfloat16.

Matmuls run in float32 with TF32 off. Work goes layer by layer over all
sequences at once, each layer's weights cast to float32 once.

Another architecture subclasses it in a configuration's model module
(``models/<name>.py``) and overrides the pieces that differ: ``_embed``,
``_layer`` (one layer of the trunk), ``_logits``, or those below them.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0
Q_BLOCK = 512        # queries a block in attention


@contextlib.contextmanager
def full_float32():
    """TF32 off for matmuls and convolutions, restored afterwards."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def fp8(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (its largest magnitude maps to the format's largest), back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """The forward pass of one model section over given weight views."""

    def __init__(self, m: dict, views: dict, quant: str | None = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        self.m = m
        self.w = views
        self.quant = quant

    # -- pieces ---------------------------------------------------------
    def _act(self, x):
        """An activation as it enters a bfloat16 product."""
        return fp8(x) if self.quant else x

    def _weight(self, name: str) -> torch.Tensor:
        """A matmul weight (in, out) in float32; per output column fp8."""
        w = self.w[name].float()
        return fp8(w, dim=-2) if self.quant else w

    def _mm(self, x, w):
        return self._act(x) @ w

    def _norm(self, x, name: str):
        g = self.w[name].float()
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.m["norm_eps"]) * (1.0 + g)

    def _rope(self, x, pos):
        hd = x.shape[-1]
        half = hd // 2
        freq = self.m["rope_theta"] ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = pos.float()[:, None] * freq
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, q, k, v):
        """Causal attention of one sequence: q (S,H,hd), k/v (S,KH,hd)."""
        S, H, hd = q.shape
        G = H // k.shape[1]
        k = self._act(k).repeat_interleave(G, dim=1)
        v = self._act(v).repeat_interleave(G, dim=1)
        q = self._act(q)
        out = torch.empty_like(q)
        keys = torch.arange(S, device=q.device)
        for a in range(0, S, Q_BLOCK):
            b = min(a + Q_BLOCK, S)
            s = torch.einsum("shd,thd->hst", q[a:b], k[:b]) * hd ** -0.5
            mask = keys[None, :b] > keys[a:b, None]
            s.masked_fill_(mask[None], float("-inf"))
            p = self._act(torch.softmax(s, dim=-1))
            out[a:b] = torch.einsum("hst,thd->shd", p, v[:b])
        return out

    def _mlp(self, x, pre: str):
        wg, wu, wd = (self._weight(pre + n) for n in ("w_gate", "w_up",
                                                      "w_down"))
        return self._mm(torch.nn.functional.silu(self._mm(x, wg)) *
                        self._mm(x, wu), wd)

    def _moe(self, x, pre: str):
        m = self.m
        router = self.w[pre + "moe_router"].float()
        probs = torch.softmax(self._act(x) @ router, dim=-1)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        k = m["experts_per_token"]
        top_p, top_i = top_p[:, :k], top_i[:, :k]
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        wg, wu, wd = (self._weight(pre + n) for n in (
            "moe_w_gate", "moe_w_up", "moe_w_down"))
        out = torch.zeros_like(x)
        for e in range(m["num_experts"]):
            tok, slot = (top_i == e).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = x[tok]
            y = self._mm(torch.nn.functional.silu(self._mm(xe, wg[e])) *
                         self._mm(xe, wu[e]), wd[e])
            out.index_add_(0, tok, y * top_p[tok, slot][:, None])
        return out

    def _self_attention(self, hn, pre: str, pos, lens):
        """A layer's attention over its normed input, projected out."""
        m = self.m
        H, KH, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        q = self._mm(hn, self._weight(pre + "wq")).view(-1, H, hd)
        k = self._mm(hn, self._weight(pre + "wk")).view(-1, KH, hd)
        v = self._mm(hn, self._weight(pre + "wv")).view(-1, KH, hd)
        q, k = self._rope(q, pos), self._rope(k, pos)
        att = torch.cat([self._attention(qs, ks, vs) for qs, ks, vs in
                         zip(q.split(lens), k.split(lens), v.split(lens))])
        return self._mm(att.reshape(-1, H * hd), self._weight(pre + "wo"))

    # -- the pass -------------------------------------------------------
    def _embed(self, ids):
        """The hidden states of the token ids entering layer 0."""
        return self.w["embed"].float()[ids]

    def _layer(self, li: int, x, pos, lens):
        """Layer ``li`` over the hidden states x (every sequence, one after
        another; ``pos`` each position's, ``lens`` each sequence's length):
        attention, then the MLP or the MoE, each pre-normed."""
        pre = f"layers.{li}."
        x = x + self._self_attention(self._norm(x, pre + "norm1"), pre, pos,
                                     lens)
        hn = self._norm(x, pre + "norm2")
        return x + (self._moe(hn, pre) if self.m.get("num_experts")
                    else self._mlp(hn, pre))

    def _logits(self, xs):
        """Logits over the vocabulary of final hidden states."""
        w = self.w
        table = w["embed"] if self.m["tie_embeddings"] else w["unembed"]
        return self._act(self._norm(xs, "final_norm")) @ table.float().T

    @torch.no_grad()
    def run(self, seqs: list[list[int]], logits_from: list[int],
            tap_at: list[list[int]]):
        """Forward every sequence (token ids) from position 0.

        Returns, per sequence, (logits (n, V) float32 at positions
        ``logits_from[i]`` .. end, probe posteriors (len(tap_at[i]),
        num_bins) at the positions ``tap_at[i]``).
        """
        with full_float32():
            return self._run(seqs, logits_from, tap_at)

    def _run(self, seqs, logits_from, tap_at):
        m, w = self.m, self.w
        dev = w["embed"].device
        lens = [len(s) for s in seqs]
        ids = torch.tensor([t for s in seqs for t in s], dtype=torch.long,
                           device=dev)
        pos = torch.cat([torch.arange(n, device=dev) for n in lens])
        x = self._embed(ids)
        taps = None
        for li in range(m["num_layers"]):
            x = self._layer(li, x, pos, lens)
            if li == m["probe"]["tap_layer"]:
                taps = x
        out = []
        for i, (xs, ts) in enumerate(zip(x.split(lens), taps.split(lens))):
            logits = self._logits(xs[logits_from[i]:])
            t = self._act(ts[tap_at[i]])
            h = torch.relu(t @ w["probe.w1"].float() + w["probe.b1"].float())
            post = torch.softmax(h @ w["probe.w2"].float() +
                                 w["probe.b2"].float(), dim=-1)
            out.append((logits, post))
        return out
