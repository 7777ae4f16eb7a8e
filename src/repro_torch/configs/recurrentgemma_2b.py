"""recurrentgemma-2b [hybrid] — Griffin: 26L d_model=2560, RG-LRU
(width 2560) + local MQA attention (kv=1, window 2048), pattern
(recurrent, recurrent, attention), d_ff=7680 GeGLU, vocab=256000.
[arXiv:2402.19427; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig, RGLRUConfig

FULL = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    rope_theta=10_000.0,
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4, power=8.0),
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=5,              # one (R,R,A) group + (R,R) tail
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    window=8,
    rglru=RGLRUConfig(lru_width=64, conv_width=4, power=8.0),
)
