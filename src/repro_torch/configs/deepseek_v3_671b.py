"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff(dense)=18432
vocab=129280; MLA (q-LoRA 1536, kv-LoRA 512, nope 128, rope 64, v 128);
MoE: 1 shared + 256 routed experts (d_ff 2048) top-8, sigmoid router with
routed scaling 2.5, first 3 layers dense; MTP head. [arXiv:2412.19437; hf]

Simplifications recorded in docs/design-notes.md §6: node-limited
routing group selection and the aux-free bias update are replaced by
a standard load-balance aux loss (weight 1e-4)."""

import dataclasses

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,          # MLA supersedes GQA (latent KV cache)
    head_dim=128,
    d_ff=18432,                # dense layers (first 3)
    vocab_size=129_280,
    pattern=("global",),
    rope_theta=10_000.0,
    tie_embeddings=False,
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        first_dense_layers=3,
        router="sigmoid",
        routed_scaling=2.5,
        aux_loss_weight=1e-4,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    ),
    mtp=True,
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=4,              # 1 dense + 3 moe
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    moe=dataclasses.replace(FULL.moe, num_experts=8, top_k=2,
                            d_ff_expert=32, first_dense_layers=1),
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                  qk_rope_dim=8, v_head_dim=16),
)
