"""rwkv6-7b [ssm] — "Finch": 32L d_model=4096 (attention-free, 64 heads
of size 64) d_ff=14336 vocab=65536, data-dependent decay.
[arXiv:2404.05892; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig, RWKVConfig

FULL = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,              # d_model / head_size
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    pattern=("rwkv",),
    norm_type="layernorm",
    tie_embeddings=False,
    rwkv=RWKVConfig(head_size=64, lora_decay=64, lora_mix=32),
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    rwkv=RWKVConfig(head_size=16, lora_decay=8, lora_mix=8),
)
