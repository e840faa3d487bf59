"""paligemma-3b — VLM; SigLIP vision tower is a stub (prefix patch embeddings).

[arXiv:2407.07726] 18L d_model=2048 8H (kv=1, MQA) d_ff=16384 vocab=257216.
"""

import dataclasses

from repro_torch.config import FAMILY_VLM, ModelConfig, ProbeConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family=FAMILY_VLM,
    source="[arXiv:2407.07726]",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    num_prefix_tokens=256,       # 224px / 14px SigLIP patches (stub)
    embed_scale=True,
    probe=ProbeConfig(tap_layer=9),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="paligemma-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    num_prefix_tokens=16,
    layer_kinds=(),
    probe=ProbeConfig(tap_layer=0, hidden=32, num_bins=5, max_len=64),
)
