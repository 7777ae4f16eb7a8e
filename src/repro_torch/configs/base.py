"""Config schema for the model zoo, shapes, training and mesh — the
counterpart of ``repro.configs.base``, with torch dtypes.

One ``ModelConfig`` covers all 10 assigned architectures via family
switches (dense / moe / ssm / vlm / audio / hybrid); each arch file in
this package instantiates the exact published figures and a reduced
smoke-test variant of the same family.  The figures are the
reference's, field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    first_dense_layers: int = 0       # deepseek: first 3 layers dense
    dense_residual: bool = False      # arctic: dense MLP in parallel
    capacity_factor: float = 1.25
    router: str = "softmax"           # softmax | sigmoid (deepseek v3)
    aux_loss_weight: float = 0.01
    routed_scaling: float = 1.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 2560
    conv_width: int = 4
    power: float = 8.0                # c in a_t = a^(c * r_t)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    lora_decay: int = 64              # rank of the data-dependent decay LoRA
    lora_mix: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | vlm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # layer pattern, cycled over depth: entries are
    #   "global" | "local" | "cross" | "rwkv" | "rglru"
    pattern: tuple[str, ...] = ("global",)
    window: int = 4096                # local-attention window
    # attention details
    qkv_bias: bool = False
    use_qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: Optional[float] = None
    rope_fraction: float = 1.0        # glm4: 0.5
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    norm_style: str = "pre"           # pre | sandwich (gemma2/3)
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm (rwkv, seamless)
    act: str = "silu"                 # silu | gelu
    tie_embeddings: bool = True
    embed_scale: bool = False         # gemma: scale embeds by sqrt(d)
    # family extensions
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # encoder-decoder (audio): encoder of this many layers feeds cross-attn
    encoder_layers: int = 0
    # vision: number of precomputed patch-embedding tokens fed to cross-attn
    vision_tokens: int = 0
    # MTP (deepseek): extra next-next-token prediction block
    mtp: bool = False
    mtp_loss_weight: float = 0.3
    # dtypes
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # reduction engine for loss/norm/etc: 'mma' (paper) | 'vpu' (baseline)
    reduce_method: str = "mma"
    # perf knobs
    attn_chunk: int = 1024            # KV-chunk for online-softmax attention
    remat: str = "dots"               # none | full | dots
    scan_layers: bool = True
    # §Perf optimizations (False = paper-faithful baseline; the dry-run
    # records baseline and optimized separately)
    local_banded: bool = False        # block-banded sliding-window attn
    moe_layout: str = "etp"           # etp (EP x ETP) | ep2d (seq-split +
    #                                   EP over data x model, no psum)
    attn_seq_shard: bool = False      # shard seq over 'model' in attn
    #                                   (archs whose heads % 16 != 0)
    fast_norm: bool = False           # f32 stats, in-dtype normalization
    bf16_activation_ar: bool = False  # emit TP-boundary dots in bf16 so
    #                                   activation all-reduces ride the
    #                                   wire at 2 bytes, not 4 (§Perf)
    rwkv_chunk: int = 0               # chunk-parallel WKV (0 = sequential
    #                                   scan); S/chunk-length state scan
    onehot_embed: bool = False        # gather as one-hot ones-MMA matmul
    ce_vocab_chunk: int = 0           # online-logsumexp CE over vocab
    #                                   chunks (0 = full logits)
    # attention engine routing (the `attention` op in core/dispatch.py):
    # '' = legacy size heuristic (direct for decode/small, chunked for
    # long prefill); 'auto' = autotuned; or an engine/alias name
    # ('fused_pallas' | 'unfused_mma' | 'vpu' | 'pallas' | 'mma')
    attn_method: str = ""
    attn_precision: Optional[object] = None   # MmaPolicy for attention
    attn_slo_ms: Optional[float] = None       # |lat: SLO objective
    # fused rmsnorm->matmul routing (the `norm_matmul` op): '' = legacy
    # two-op path (rmsnorm + separate torch matmul); 'auto' = autotuned
    # fused-vs-unfused arbitration; or an engine/alias name
    # ('fused_pallas' | 'unfused_mma' | 'vpu' | 'pallas' | 'mma')
    norm_matmul_method: str = ""
    # repro_torch.core.precision.MmaPolicy
    norm_matmul_precision: Optional[object] = None
    norm_matmul_slo_ms: Optional[float] = None      # |lat: objective

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """The per-layer kind for all num_layers, cycling the pattern."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                         # train_4k | prefill_32k | ...
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1             # gradient accumulation
    zero_optimizer: bool = True       # shard optimizer state over 'data'
    moment_dtype: torch.dtype = torch.float32
    seed: int = 0
