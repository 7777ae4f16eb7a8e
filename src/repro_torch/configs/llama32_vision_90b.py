"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256; gated cross-attention image layers every 5th
layer (20 total).  The vision frontend is a STUB per assignment:
input_specs supplies precomputed patch embeddings (B, 1600, d_model).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    pattern=("global", "global", "global", "global", "cross"),
    rope_theta=500_000.0,
    tie_embeddings=False,
    vision_tokens=1600,
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    vision_tokens=24,
)
