"""seamless-m4t-large-v2 [audio] — enc-dec, 24L encoder + 24L decoder,
d_model=1024 16H d_ff=8192 vocab=256206.  The speech frontend is a STUB
per assignment: input_specs supplies precomputed frame embeddings
(B, S, d_model) consumed by the bidirectional encoder; the text decoder
cross-attends to encoder output. [arXiv:2308.11596; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,             # decoder
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    pattern=("selfcross",),
    norm_type="layernorm",
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=2,
    encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
)
