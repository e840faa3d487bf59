"""granite-3-8b — dense GQA decoder.

[hf:ibm-granite/granite-3.0-2b-base] 40L d_model=4096 32H (kv=8) d_ff=12800
vocab=49155.
"""

import dataclasses

from repro_torch.config import FAMILY_DENSE, ModelConfig, ProbeConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family=FAMILY_DENSE,
    source="[hf:ibm-granite/granite-3.0-2b-base]",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    probe=ProbeConfig(tap_layer=14),   # mid-stack, paper's 11/32 ratio
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="granite-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    layer_kinds=(),
    probe=ProbeConfig(tap_layer=0, hidden=32, num_bins=5, max_len=64),
)
