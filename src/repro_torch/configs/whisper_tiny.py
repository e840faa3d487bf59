"""whisper-tiny — encoder-decoder audio model; conv/mel frontend is a stub.

[arXiv:2212.04356] 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
``input_specs`` provides precomputed frame embeddings (1500, 384) per request.
"""

import dataclasses

from repro_torch.config import FAMILY_AUDIO, ModelConfig, ProbeConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family=FAMILY_AUDIO,
    source="[arXiv:2212.04356]",
    num_layers=4,                # decoder layers
    num_encoder_layers=4,
    encoder_seq=1500,            # 30s of audio at 50 frames/s (stub embeddings)
    cross_attention=True,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    use_rope=False,              # whisper uses learned positions; we use rope=False + learned
    tie_embeddings=True,
    probe=ProbeConfig(tap_layer=2),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="whisper-smoke",
    num_layers=2,
    num_encoder_layers=2,
    encoder_seq=64,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=0,
    d_ff=256,
    vocab_size=512,
    layer_kinds=(),
    probe=ProbeConfig(tap_layer=0, hidden=32, num_bins=5, max_len=64),
)
