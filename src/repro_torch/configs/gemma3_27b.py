"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global interleave, sliding window 1024, QK-norm,
dual rope bases (1M global / 10k local), sandwich norms.
[hf:google/gemma-3-27b-pt family; unverified]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    norm_style="sandwich",
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=8,           # one full 6-group + a 2-layer tail
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    window=8,
)
