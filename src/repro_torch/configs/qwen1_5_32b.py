"""qwen1.5-32b — dense MHA decoder with QKV bias.

[hf:Qwen/Qwen1.5-0.5B] 64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064.
"""

import dataclasses

from repro_torch.config import FAMILY_DENSE, ModelConfig, ProbeConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family=FAMILY_DENSE,
    source="[hf:Qwen/Qwen1.5-0.5B]",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    tie_embeddings=False,
    probe=ProbeConfig(tap_layer=22),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="qwen-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    layer_kinds=(),
    probe=ProbeConfig(tap_layer=0, hidden=32, num_bins=5, max_len=64),
)
