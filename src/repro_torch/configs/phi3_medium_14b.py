"""phi3-medium-14b [dense] — 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352, RoPE + SwiGLU + GQA.  [arXiv:2404.14219]"""
from __future__ import annotations

import torch

from repro_torch.config import HeteroProfile, ModelConfig

EXITS = (10, 20, 30)


def config(sliding_window=None) -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", arch_type="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
        d_ff=17920, vocab_size=100352, head_dim=128,
        rope_theta=10000.0, act="silu", exit_layers=EXITS,
        sliding_window=sliding_window,
        source="arXiv:2404.14219",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b-smoke", arch_type="dense",
        num_layers=4, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32, exit_layers=(1, 2),
        dtype=torch.float32, param_dtype=torch.float32,
        source="arXiv:2404.14219",
    )


def smoke_bf16() -> ModelConfig:
    """The smoke config at a full head width (64) in bf16 with the model's
    GQA group (4): the attention forward's tile and decode routes and
    the backward's tile routes run here, where the fp32 head-dim-32 smoke
    takes only the row routes."""
    return smoke().with_(name="phi3-medium-14b-smoke-bf16", num_heads=8,
                         num_kv_heads=2, head_dim=64, dtype=torch.bfloat16,
                         param_dtype=torch.bfloat16)


def profile() -> HeteroProfile:
    return HeteroProfile(split_layers=(EXITS[0],) * 4 + (EXITS[1],) * 4
                         + (EXITS[2],) * 4)
