"""olmoe-1b-7b — 64-expert top-8 MoE.

[arXiv:2409.02060] 16L d_model=2048 16H (kv=16) d_ff=1024 vocab=50304.
"""

import dataclasses

from repro_torch.config import FAMILY_MOE, ModelConfig, ProbeConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family=FAMILY_MOE,
    source="[arXiv:2409.02060]",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,                  # per-expert hidden
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    tie_embeddings=False,
    probe=ProbeConfig(tap_layer=6),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="olmoe-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=64,
    vocab_size=512,
    num_experts=4,
    experts_per_token=2,
    layer_kinds=(),
    probe=ProbeConfig(tap_layer=0, hidden=32, num_bins=5, max_len=64),
)
