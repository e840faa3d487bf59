"""granite-4.0-h-small — Mamba-2 and NoPE attention, every layer followed
by a mixture of experts with a shared expert.

[hf:ibm-granite/granite-4.0-h-small] 40L d_model=4096; attention at layers
5, 15, 25 and 35 (32H, kv=8, head_dim 128, no positions, scores scaled by
1/128), Mamba-2 elsewhere (expand 2: 128 heads of 64, state 128, 1 group,
conv 4 with bias); after every mixer 72 experts of width 768, top 10, plus
a shared expert of width 1536; embeddings x12, residual branches x0.22,
logits / 16; vocab=100352, tied. The SSD scan runs chunks of 128 (the
kernel's largest; published 256): the scan's result does not depend on
the chunk beyond rounding.
"""

import dataclasses

from repro_torch.config import (FAMILY_HYBRID, KIND_MOE, KIND_SSM_MOE,
                                ModelConfig, ProbeConfig)

#: attention layers of the published 40
ATTENTION_AT = (5, 15, 25, 35)

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family=FAMILY_HYBRID,
    source="[hf:ibm-granite/granite-4.0-h-small]",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,                   # per-expert hidden
    vocab_size=100352,
    layer_kinds=tuple(KIND_MOE if i in ATTENTION_AT else KIND_SSM_MOE
                      for i in range(40)),
    use_rope=False,
    learned_pos=False,          # NoPE
    attn_scale=1.0 / 128,       # attention_multiplier
    num_experts=72,
    experts_per_token=10,
    capacity_factor=7.2,        # 72 / 10: dropless
    shared_expert_ff=1536,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    ssm_conv=4,
    ssm_groups=1,
    norm_eps=1e-5,
    embed_multiplier=12.0,
    residual_multiplier=0.22,
    logit_divisor=16.0,
    probe=ProbeConfig(tap_layer=14),   # the paper's 11/32, scaled to 40
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="granite-4.0-h-smoke",
    num_layers=3,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=64,
    vocab_size=512,
    layer_kinds=(KIND_SSM_MOE, KIND_MOE, KIND_SSM_MOE),
    attn_scale=1.0 / 32,
    num_experts=8,
    experts_per_token=3,
    capacity_factor=8 / 3,
    shared_expert_ff=96,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=8,
    probe=ProbeConfig(tap_layer=1, hidden=32, num_bins=5, max_len=64),
)
