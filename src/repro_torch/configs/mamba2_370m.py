"""mamba2-370m — pure SSM (state-space duality), attention-free.

[arXiv:2405.21060] 48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128.
"""

import dataclasses

from repro_torch.config import FAMILY_SSM, ModelConfig, ProbeConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family=FAMILY_SSM,
    source="[arXiv:2405.21060]",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,            # unused (attention-free)
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    use_rope=False,
    probe=ProbeConfig(tap_layer=24),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="mamba2-smoke",
    num_layers=2,
    d_model=128,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=32,
    layer_kinds=(),
    probe=ProbeConfig(tap_layer=0, hidden=32, num_bins=5, max_len=64),
)
