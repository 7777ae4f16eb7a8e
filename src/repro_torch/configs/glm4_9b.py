"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552, partial RoPE (0.5), QKV bias. [hf:THUDM/glm-4-9b; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151_552,
    pattern=("global",),
    qkv_bias=True,
    rope_fraction=0.5,
    rope_theta=10_000.0,
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
