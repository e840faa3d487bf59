"""trail-llama — the paper's serving model at reproducible scale.

The paper serves Llama3-8B-instruct (32L, d_model=4096). Offline and on CPU
we train/serve a ~100M Llama-style decoder with the same probe design
(tap at the 11/32 fractional depth -> layer 4 of 12).
"""

import dataclasses

from repro_torch.config import FAMILY_DENSE, ModelConfig, ProbeConfig

CONFIG = ModelConfig(
    name="trail-llama",
    family=FAMILY_DENSE,
    source="[arXiv:2404 TRAIL eval model, reduced]",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=32000,
    probe=ProbeConfig(tap_layer=4, hidden=512, num_bins=10, max_len=512),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="trail-llama-smoke",
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
