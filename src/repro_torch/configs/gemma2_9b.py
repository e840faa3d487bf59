"""gemma2-9b — dense, alternating local/global attention, logit softcaps.

[arXiv:2408.00118] 42L d_model=3584 16H (kv=8) d_ff=14336 vocab=256000.
Window 4096; attn softcap 50.0; final softcap 30.0.
"""

import dataclasses

from repro_torch.config import (FAMILY_DENSE, ModelConfig, ProbeConfig,
                          pattern_local_global)

CONFIG = ModelConfig(
    name="gemma2-9b",
    family=FAMILY_DENSE,
    source="[arXiv:2408.00118]",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    layer_kinds=pattern_local_global(42, local=1, glob=1),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    embed_scale=True,
    probe=ProbeConfig(tap_layer=14),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="gemma2-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    layer_kinds=pattern_local_global(2, local=1, glob=1),
    sliding_window=16,
    probe=ProbeConfig(tap_layer=0, hidden=32, num_bins=5, max_len=64),
)
