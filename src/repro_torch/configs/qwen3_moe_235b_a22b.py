"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4),
128 routed experts top-8 (d_expert=1536, no shared expert), vocab=151936.
[hf:Qwen/Qwen3-30B-A3B family scaled per assignment]"""
from __future__ import annotations

import torch

from repro_torch.config import HeteroProfile, ModelConfig, MoEConfig

NUM_LAYERS = 94
EXITS = (23, 47, 70)


def config(sliding_window=None) -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", arch_type="moe",
        num_layers=NUM_LAYERS, d_model=4096, num_heads=64, num_kv_heads=4,
        d_ff=1536, vocab_size=151936, head_dim=128,
        ffn_pattern=("moe",) * NUM_LAYERS,
        moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536,
                      capacity_factor=1.25),
        exit_layers=EXITS, sliding_window=sliding_window,
        source="hf:Qwen/Qwen3-30B-A3B",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", arch_type="moe",
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=32,
        ffn_pattern=("moe",) * 4,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64),
        exit_layers=(2,), dtype=torch.float32, param_dtype=torch.float32,
        source="hf:Qwen/Qwen3-30B-A3B",
    )


def smoke_bf16() -> ModelConfig:
    """The smoke config at a full head width (64) in bf16, as
    ``glm4_9b.smoke_bf16``: the attention forward's tile and decode routes
    and the backward's tile routes run here, where the fp32 head-dim-32
    smoke takes only the row routes.  The router stays fp32
    (``MoEConfig.router_dtype``)."""
    return smoke().with_(name="qwen3-moe-smoke-bf16", num_heads=4,
                         num_kv_heads=2, head_dim=64, dtype=torch.bfloat16,
                         param_dtype=torch.bfloat16)


def profile() -> HeteroProfile:
    return HeteroProfile(split_layers=(EXITS[0],) * 4 + (EXITS[1],) * 4
                         + (EXITS[2],) * 4)
