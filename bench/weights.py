"""A configuration file's model, with weights drawn from the run's seed.

The weights are the benchmark's: it draws them on the device, in the dtype
each is served in, with one ``torch.Generator`` into one flat buffer per
dtype (a few large calls), then scales each group of leaves that share a
standard deviation. The port's ``Model`` is built on the meta device and
its parameters are bound to views of those buffers, so the weights exist
once, and the plain reference reads the same tensors.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

#: standard deviation of each leaf, by the last part of its name; a
#: callable takes the model section of the configuration file
STD = {
    "embed": lambda m: 0.02,
    "unembed": lambda m: 0.02,
    "norm1": lambda m: 0.1,
    "norm2": lambda m: 0.1,
    "final_norm": lambda m: 0.1,
    "wq": lambda m: m["d_model"] ** -0.5,
    "wk": lambda m: m["d_model"] ** -0.5,
    "wv": lambda m: m["d_model"] ** -0.5,
    "wo": lambda m: (m["num_heads"] * m["head_dim"]) ** -0.5,
    "w_gate": lambda m: m["d_model"] ** -0.5,
    "w_up": lambda m: m["d_model"] ** -0.5,
    "w_down": lambda m: m["d_ff"] ** -0.5,
    "moe_router": lambda m: m["d_model"] ** -0.5,
    "moe_w_gate": lambda m: m["d_model"] ** -0.5,
    "moe_w_up": lambda m: m["d_model"] ** -0.5,
    "moe_w_down": lambda m: m["d_ff"] ** -0.5,
    "w1": lambda m: m["d_model"] ** -0.5,
    "b1": lambda m: 0.1,
    "w2": lambda m: m["probe"]["hidden"] ** -0.5,
    "b2": lambda m: 0.1,
}
ALIGN = 128          # elements: each leaf starts 256- or 512-byte aligned
CHUNK = 1 << 28      # elements drawn per generator call


def load_config(root: Path, name: str) -> dict:
    """The configuration file ``configs/<name>.json`` under ``root``."""
    return json.loads((root / "configs" / f"{name}.json").read_text())


def model_section(conf: dict, smoke: bool = False) -> dict:
    """The model's settings as they are run; ``smoke`` puts the file's
    small sizes in place of the published ones (CPU rehearsals only)."""
    m = dict(conf["model"])
    if smoke:
        m.update(conf["smoke"])
    return m


def frozen(v):
    """A JSON value with its lists made tuples, at every depth."""
    if isinstance(v, list):
        return tuple(frozen(x) for x in v)
    if isinstance(v, dict):
        return {k: frozen(x) for k, x in v.items()}
    return v


def model_config(name: str, m: dict):
    """The port's ``ModelConfig`` for a model section; its lists (say
    ``layer_kinds``) become tuples, so that the frozen config hashes."""
    from repro_torch.config import ModelConfig, ProbeConfig
    kw = {k: frozen(v) for k, v in m.items() if k != "probe"}
    return ModelConfig(name=name, probe=ProbeConfig(**frozen(m["probe"])),
                       **kw)


class Weights:
    """Flat per-dtype buffers and the views of every leaf, by name; ``std``
    maps a leaf's last name part to its standard deviation."""

    def __init__(self, model: torch.nn.Module, m: dict, device,
                 std: dict = STD):
        self.m = m
        self.device = torch.device(device)
        groups: dict[torch.dtype, list] = {}
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf not in std:
                raise KeyError(f"no standard deviation for leaf {name!r}")
            groups.setdefault(p.dtype, []).append((std[leaf](m), name, p))
        self.flat: dict[torch.dtype, torch.Tensor] = {}
        self.spans: dict[torch.dtype, list] = {}   # (std, start, end)
        self.views: dict[str, torch.Tensor] = {}
        for dt, leaves in groups.items():
            leaves.sort(key=lambda x: (x[0], x[1]))
            off, spans = 0, []
            layout = []
            for sd, name, p in leaves:
                off = -(-off // ALIGN) * ALIGN
                layout.append((name, p.shape, off))
                if spans and spans[-1][0] == sd:
                    spans[-1][2] = off + p.numel()
                else:
                    spans.append([sd, off, off + p.numel()])
                off += p.numel()
            flat = torch.empty(off, dtype=dt, device=self.device)
            self.flat[dt], self.spans[dt] = flat, spans
            for name, shape, start in layout:
                self.views[name] = flat[start:start + shape.numel()].view(
                    shape)
        for name, view in self.views.items():
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            mod._parameters[leaf] = torch.nn.Parameter(view,
                                                       requires_grad=False)

    @torch.no_grad()
    def draw(self, seed: int) -> None:
        """Fill every leaf from ``seed``: standard normals in chunks, then
        one scale a group of leaves that share a standard deviation. The
        padding between leaves is drawn too and never read."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed & (2**63 - 1))
        for dt in sorted(self.flat, key=str):
            flat = self.flat[dt]
            for a in range(0, flat.numel(), CHUNK):
                flat[a:a + CHUNK].normal_(generator=gen)
            for std, a, b in self.spans[dt]:
                flat[a:b].mul_(std)


def build(conf: dict, seed: int, device, smoke: bool = False,
          std: dict = STD):
    """(the port's Model, its Weights) for a configuration file, with the
    weights drawn from ``seed`` on ``device`` at the scales ``std``."""
    from repro_torch.models.model import Model
    m = model_section(conf, smoke)
    cfg = model_config(conf["name"], m)
    model = Model(cfg, device="meta")
    w = Weights(model, m, device, std)
    model.device = torch.device(device)
    w.draw(seed)
    return model, w
