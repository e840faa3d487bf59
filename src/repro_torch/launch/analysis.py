"""Roofline terms of one dry-run case (the reference ``repro.launch.analysis``).

The reference extracts them from a compiled XLA program; the port has no
such program, so its dry run (``launch.dryrun``) reads the analytic terms
alone and leaves the raw-HLO fields ``null``. ``parse_collectives`` is
kept, equal to the reference's, for HLO text of the reference's meshes:

  * collective term -- parsed from the partitioned HLO text per
    *computation*, then scaled by each while's ``known_trip_count``
    (recursively, so KV-block scans nested inside layer scans are handled);
  * compute term   -- analytic MODEL_FLOPS (6*N_active*D train, 2*N*D
    inference, + attention window terms), the exact lower bound on matmul
    work;
  * memory term    -- analytic traffic model (weight shards + optimizer
    state + activations + KV-cache streaming per device).

Hardware constants, one ``Chip`` each:

  * TPU v5e (the reference's meshes): 197 bf16 TFLOP/s, 819 GB/s HBM,
    ~50 GB/s ICI, 16 GB of HBM; ``PEAK_FLOPS``, ``HBM_BW`` and ``ICI_BW``
    keep the reference's names, so its reports come out equal.
  * NVIDIA H100 (SXM, ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``: ``NVIDIA H100 80GB HBM3, 700.00 W``): 989
    bf16 dense TFLOP/s, 3.35 TB/s HBM3, 80e9 B of HBM, 450 GB/s NVLink
    per direction (900 GB/s both ways). A card set below 700 W runs
    slower under load than these peaks say.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from repro_torch.config import (KIND_LOCAL, KIND_SSM, KIND_SSM_MOE,
                                InputShape, ModelConfig)

PEAK_FLOPS = 197e12
HBM_BW = 819e9
ICI_BW = 50e9

H100_PEAK_FLOPS = 989e12
H100_HBM_BW = 3.35e12
H100_NVLINK_BW = 450e9
H100_HBM_BYTES = 80e9


@dataclass(frozen=True)
class Chip:
    """One device kind's peaks: bf16 dense FLOP/s, HBM bytes/s, the link
    between devices in bytes/s (one direction) and HBM bytes."""

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    hbm_bytes: float


TPU_V5E = Chip("TPU v5e", PEAK_FLOPS, HBM_BW, ICI_BW, 16e9)
H100 = Chip("NVIDIA H100 80GB HBM3", H100_PEAK_FLOPS, H100_HBM_BW,
            H100_NVLINK_BW, H100_HBM_BYTES)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_SHAPE_RE = re.compile(
    r"\b(pred|s8|u8|s16|u16|bf16|f16|s32|u32|f32|s64|u64|f64|c64|c128)"
    r"\[([\d,]*)\]")

_COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")

_COMP_HEAD = re.compile(r"^(ENTRY\s+)?%?([\w\.\-]+)\s*\(")  # nested parens ok
_WHILE_BODY = re.compile(r"body=%?([\w\.\-]+)")
_TRIP = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALLS = re.compile(r"(?:calls|to_apply)=%?([\w\.\-]+)")


def shape_bytes(dtype: str, dims: str) -> int:
    """Byte size of one HLO shape literal (dtype + comma-joined dims)."""
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def _line_result_bytes(rhs: str) -> int:
    head = rhs.split("(", 1)[0] if not rhs.startswith("(") else \
        rhs[:rhs.index(")") + 1]
    return sum(shape_bytes(dt, dims) for dt, dims in _SHAPE_RE.findall(head))


def parse_collectives(hlo_text: str) -> dict[str, float]:
    """Trip-count-aware collective bytes per op kind (per-device program)."""
    # 1. split into computations
    comps: dict[str, dict] = {}
    entry = None
    cur = None
    for line in hlo_text.splitlines():
        if not line.startswith(" ") and "->" in line and line.rstrip().endswith("{"):
            m = _COMP_HEAD.match(line.strip())
            if m:
                cur = m.group(2)
                comps[cur] = {"coll": {}, "subs": []}
                if m.group(1):
                    entry = cur
                continue
        if cur is None or " = " not in line:
            continue
        _, rhs = line.split(" = ", 1)
        op_hit = None
        for op in _COLL_OPS:
            if re.search(rf"\b{op}(-start)?\(", rhs):
                op_hit = op
                break
        if op_hit:
            b = _line_result_bytes(rhs)
            comps[cur]["coll"][op_hit] = comps[cur]["coll"].get(op_hit, 0) + b
        if " while(" in rhs:
            mb = _WHILE_BODY.search(rhs)
            mt = _TRIP.search(rhs)
            if mb:
                comps[cur]["subs"].append(
                    (mb.group(1), int(mt.group(1)) if mt else 1))
        else:
            for name in _CALLS.findall(rhs):
                comps[cur]["subs"].append((name, 1))

    # 2. DFS from entry, scaling by trip counts (memoized on comp name)
    memo: dict[str, dict[str, float]] = {}

    def total(name: str, depth=0) -> dict[str, float]:
        """Trip-count-scaled collective bytes of one computation subtree."""
        if name in memo or depth > 32 or name not in comps:
            return memo.get(name, {})
        out = dict(comps[name]["coll"])
        for sub, trips in comps[name]["subs"]:
            for op, b in total(sub, depth + 1).items():
                out[op] = out.get(op, 0.0) + trips * b
        memo[name] = out
        return out

    res = {op: 0.0 for op in _COLL_OPS}
    if entry:
        res.update({op: float(b) for op, b in total(entry).items()})
    return res


# ---------------------------------------------------------------------------
# Analytic compute / memory models (per device)
# ---------------------------------------------------------------------------

def model_flops_estimate(cfg: ModelConfig, shape: InputShape) -> float:
    """Global step FLOPs: 6*N*D train / 2*N*D inference + attention terms."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        base = 6.0 * n * tokens
        attn = 3.0 * _attn_flops_prefill(cfg, shape.seq_len) * shape.global_batch
        return base + attn
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens + _attn_flops_prefill(
            cfg, shape.seq_len) * shape.global_batch
    return (2.0 * n + _attn_flops_decode(cfg, shape.seq_len)) * shape.global_batch


def _attn_flops_prefill(cfg: ModelConfig, S: int) -> float:
    f = 0.0
    for kind in cfg.layer_kinds:
        if kind in (KIND_SSM, KIND_SSM_MOE):
            f += 6.0 * cfg.ssm_expand * cfg.d_model * cfg.ssm_state * S
            continue
        eff = min(S, cfg.sliding_window) if kind == KIND_LOCAL else S
        f += 4.0 * cfg.q_dim * eff * S / (1 if kind == KIND_LOCAL else 2)
    return f


def _attn_flops_decode(cfg: ModelConfig, ctx: int) -> float:
    f = 0.0
    for kind in cfg.layer_kinds:
        if kind in (KIND_SSM, KIND_SSM_MOE):
            f += 4.0 * cfg.ssm_expand * cfg.d_model * cfg.ssm_state
            continue
        eff = min(ctx, cfg.sliding_window) if kind == KIND_LOCAL else ctx
        f += 4.0 * cfg.q_dim * eff
    return f


def model_bytes_estimate(cfg: ModelConfig, shape: InputShape,
                         n_chips: int) -> float:
    """Per-device HBM traffic per step (weights + state + activations)."""
    from repro_torch.serving.kv_cache import bytes_for_context
    wbytes = cfg.param_count() * 2.0            # bf16 weights, read once
    per_dev = wbytes / n_chips
    if shape.mode == "train":
        # fwd+bwd weight reads, f32 grads r/w, AdamW moments r/w, master r/w
        per_dev += (cfg.param_count() * (2.0 + 4.0 * 2 + 4.0 * 4)) / n_chips
        tokens = shape.global_batch * shape.seq_len
        per_dev += tokens * cfg.d_model * 2.0 * cfg.num_layers * 8 / n_chips
    elif shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        per_dev += tokens * cfg.d_model * 2.0 * cfg.num_layers * 4 / n_chips
        per_dev += shape.global_batch * bytes_for_context(
            cfg, shape.seq_len) / n_chips
    else:
        per_dev += shape.global_batch * bytes_for_context(
            cfg, shape.seq_len) / n_chips
    return per_dev


@dataclass
class Roofline:
    """Per-device roofline terms of one case on one kind of chip (the TPU
    v5e unless ``chip`` says otherwise). The raw-HLO fields are ``None``
    where no compiled program exists, as in the port's dry run: then the
    memory term is the analytic one alone."""

    flops_per_device: float | None    # raw HLO (while bodies counted once)
    bytes_per_device: float | None    # raw HLO
    collective_bytes: float           # trip-count-scaled, per device
    n_chips: int
    model_flops: float = 0.0          # analytic, global
    model_bytes_per_device: float = 0.0
    collectives: dict = field(default_factory=dict)
    chip: Chip = TPU_V5E

    @property
    def compute_s(self) -> float:
        """Analytic matmul seconds/step/device (exact lower bound)."""
        return self.model_flops / self.n_chips / self.chip.peak_flops

    @property
    def memory_s(self) -> float:
        """Analytic HBM seconds/step/device."""
        return self.model_bytes_per_device / self.chip.hbm_bw

    @property
    def collective_s(self) -> float:
        """Link seconds/step/device (trip-count-scaled collective bytes)."""
        return self.collective_bytes / self.chip.link_bw

    @property
    def hlo_compute_s(self) -> float | None:
        """Raw-HLO compute seconds (while bodies counted once)."""
        if self.flops_per_device is None:
            return None
        return self.flops_per_device / self.chip.peak_flops

    @property
    def hlo_memory_s(self) -> float | None:
        """Raw-HLO memory seconds (while bodies counted once)."""
        if self.bytes_per_device is None:
            return None
        return self.bytes_per_device / self.chip.hbm_bw

    def _memory_term(self) -> float:
        return max(self.memory_s, self.hlo_memory_s or 0.0)

    @property
    def bottleneck(self) -> str:
        """The dominating roofline term: compute | memory | collective."""
        terms = {"compute": self.compute_s,
                 "memory": self._memory_term(),
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float | None:
        """MODEL_FLOPS / global HLO FLOPs. NOTE: >1 just means the HLO count
        hides while-loop trips; <1 flags remat/dispatch-redundancy waste."""
        if self.flops_per_device is None:
            return None
        total = self.flops_per_device * self.n_chips
        return self.model_flops / total if total else 0.0

    def as_dict(self) -> dict:
        """JSON-friendly report form (dry-run artifact ``roofline`` key)."""
        return {
            "flops_per_device_hlo_raw": self.flops_per_device,
            "bytes_per_device_hlo_raw": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes,
            "collectives_by_op": self.collectives,
            "compute_s": self.compute_s,
            "memory_s": self._memory_term(),
            "memory_s_analytic": self.memory_s,
            "memory_s_hlo_raw": self.hlo_memory_s,
            "compute_s_hlo_raw": self.hlo_compute_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "n_chips": self.n_chips,
            "chip": self.chip.name,
        }
