"""deepseek-v3-671b [moe] — 61L d_model=7168, MLA (128H, kv_lora=512,
rope_dim=64), 3 dense-MLP prefix layers (d_ff=18432) then MoE layers with
1 shared + 256 routed experts top-8 (d_expert=2048), vocab=129280.
[arXiv:2412.19437]"""
from __future__ import annotations

import torch

from repro_torch.config import HeteroProfile, MLAConfig, ModelConfig, MoEConfig

NUM_LAYERS = 61
DENSE_PREFIX = 3
EXITS = (15, 30, 45)


def config(sliding_window=None) -> ModelConfig:
    ffns = ("mlp",) * DENSE_PREFIX + ("moe",) * (NUM_LAYERS - DENSE_PREFIX)
    return ModelConfig(
        name="deepseek-v3-671b", arch_type="moe",
        num_layers=NUM_LAYERS, d_model=7168, num_heads=128, num_kv_heads=128,
        d_ff=18432, vocab_size=129280, head_dim=128,
        block_pattern=("mla",) * NUM_LAYERS, ffn_pattern=ffns,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048,
                      num_shared_experts=1, d_shared_expert=2048,
                      capacity_factor=1.25),
        exit_layers=EXITS, sliding_window=sliding_window,
        source="arXiv:2412.19437",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke", arch_type="moe",
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, head_dim=32,
        block_pattern=("mla",) * 4, ffn_pattern=("mlp", "moe", "moe", "moe"),
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64,
                      num_shared_experts=1, d_shared_expert=64),
        exit_layers=(2,), dtype=torch.float32, param_dtype=torch.float32,
        source="arXiv:2412.19437",
    )


def smoke_bf16() -> ModelConfig:
    """The smoke config in bf16 with the published MLA head split (128 +
    64 rope, values 128; latent 64) and the routers in fp32
    (``MoEConfig.router_dtype``).  MLA runs no kernel: the serving gate is
    the one kernel this family launches."""
    return smoke().with_(
        name="deepseek-v3-671b-smoke-bf16",
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=64, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        head_dim=64, dtype=torch.bfloat16, param_dtype=torch.bfloat16)


def profile() -> HeteroProfile:
    return HeteroProfile(split_layers=(EXITS[0],) * 4 + (EXITS[1],) * 4
                         + (EXITS[2],) * 4)
