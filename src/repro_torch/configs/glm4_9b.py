"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552, RoPE + GQA.  [hf:THUDM/glm-4-9b]"""
from __future__ import annotations

import torch

from repro_torch.config import HeteroProfile, ModelConfig

EXITS = (10, 20, 30)


def config(sliding_window=None) -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", arch_type="dense",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
        d_ff=13696, vocab_size=151552, head_dim=128,
        rope_theta=10000.0, act="silu", exit_layers=EXITS,
        sliding_window=sliding_window,
        source="hf:THUDM/glm-4-9b",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke", arch_type="dense",
        num_layers=4, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32, exit_layers=(1, 2),
        dtype=torch.float32, param_dtype=torch.float32,
        source="hf:THUDM/glm-4-9b",
    )


def smoke_bf16() -> ModelConfig:
    """The smoke config at a full head width (64) in bf16: the attention
    forward's tile and decode routes and the backward's tile routes run
    here, where the fp32 head-dim-32 smoke takes only the row routes."""
    return smoke().with_(name="glm4-9b-smoke-bf16", num_heads=4,
                         num_kv_heads=2, head_dim=64, dtype=torch.bfloat16,
                         param_dtype=torch.bfloat16)


def profile() -> HeteroProfile:
    return HeteroProfile(split_layers=(EXITS[0],) * 4 + (EXITS[1],) * 4
                         + (EXITS[2],) * 4)
