"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) vocab=32000;
Dense-MoE hybrid: every layer has a dense-residual MLP in parallel with a
128-expert top-2 MoE (expert d_ff 4864).
[hf:Snowflake/snowflake-arctic-base; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,                 # dense-residual branch
    vocab_size=32000,
    pattern=("global",),
    rope_theta=10_000.0,
    tie_embeddings=False,
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        d_ff_expert=4864,
        dense_residual=True,
        router="softmax",
        aux_loss_weight=0.01,
    ),
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
    moe=dataclasses.replace(FULL.moe, num_experts=8, top_k=2,
                            d_ff_expert=32),
)
