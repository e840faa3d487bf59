"""arctic-480b — 128-expert top-2 MoE with a dense residual MLP path.

[hf:Snowflake/snowflake-arctic-base] 35L d_model=7168 56H (kv=8) d_ff=4864
vocab=32000, MoE 128e top-2, dense-MoE hybrid residual.
"""

import dataclasses

from repro_torch.config import FAMILY_MOE, ModelConfig, ProbeConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family=FAMILY_MOE,
    source="[hf:Snowflake/snowflake-arctic-base]",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,                  # per-expert hidden
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,    # arctic's dense residual path
    probe=ProbeConfig(tap_layer=12),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="arctic-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    num_experts=4,
    experts_per_token=2,
    layer_kinds=(),
    probe=ProbeConfig(tap_layer=0, hidden=32, num_bins=5, max_len=64),
)
