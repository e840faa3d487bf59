"""gemma3-1b — dense, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt] 26L d_model=1152 4H (kv=1) d_ff=6912 vocab=262144.
Pattern (5 local + 1 global) repeating; local window 512.
"""

import dataclasses

from repro_torch.config import (FAMILY_DENSE, ModelConfig, ProbeConfig,
                          pattern_local_global)

CONFIG = ModelConfig(
    name="gemma3-1b",
    family=FAMILY_DENSE,
    source="[hf:google/gemma-3-1b-pt]",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    layer_kinds=pattern_local_global(26, local=5, glob=1),
    sliding_window=512,
    rope_theta=1_000_000.0,
    embed_scale=True,
    probe=ProbeConfig(tap_layer=9),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="gemma3-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    layer_kinds=pattern_local_global(2, local=1, glob=1),
    sliding_window=16,
    probe=ProbeConfig(tap_layer=0, hidden=32, num_bins=5, max_len=64),
)
