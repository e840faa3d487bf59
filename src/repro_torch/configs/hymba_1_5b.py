"""hymba-1.5b — hybrid-head model: parallel attention + Mamba heads per layer.

[arXiv:2411.13676] 32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001
ssm_state=16.  Attention heads use a sliding window (Hymba uses SWA for all
but 3 layers; we model the SWA regime, which is what makes it long-context).
"""

import dataclasses

from repro_torch.config import FAMILY_HYBRID, ModelConfig, ProbeConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family=FAMILY_HYBRID,
    source="[arXiv:2411.13676]",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    sliding_window=1024,        # hymba SWA window
    probe=ProbeConfig(tap_layer=11),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="hymba-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    ssm_state=8,
    ssm_head_dim=32,
    sliding_window=16,
    layer_kinds=(),
    probe=ProbeConfig(tap_layer=0, hidden=32, num_bins=5, max_len=64),
)
