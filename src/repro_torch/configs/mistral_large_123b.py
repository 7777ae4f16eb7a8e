"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768, full attention.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    pattern=("global",),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
)
