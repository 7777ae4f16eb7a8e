"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000, local(4096):global alternating, attn/final logit softcaps,
sandwich norms. [arXiv:2408.00118; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    pattern=("local", "global"),
    window=4096,
    rope_theta=10_000.0,
    attn_softcap=50.0,
    final_softcap=30.0,
    norm_style="sandwich",
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    window=8,
)
