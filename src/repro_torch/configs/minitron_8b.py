"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000; width/depth-pruned Nemotron-4.  [arXiv:2407.14679]"""
from __future__ import annotations

import torch

from repro_torch.config import HeteroProfile, ModelConfig

EXITS = (8, 16, 24)


def config(sliding_window=None) -> ModelConfig:
    return ModelConfig(
        name="minitron-8b", arch_type="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=16384, vocab_size=256000, head_dim=128,
        rope_theta=10000.0, act="silu", exit_layers=EXITS,
        sliding_window=sliding_window,
        source="arXiv:2407.14679",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b-smoke", arch_type="dense",
        num_layers=4, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32, exit_layers=(1, 2),
        dtype=torch.float32, param_dtype=torch.float32,
        source="arXiv:2407.14679",
    )


def smoke_bf16() -> ModelConfig:
    """The smoke config at a full head width (64) in bf16 with the model's
    GQA group (4): the attention forward's tile and decode routes and
    the backward's tile routes run here, where the fp32 head-dim-32 smoke
    takes only the row routes."""
    return smoke().with_(name="minitron-8b-smoke-bf16", num_heads=8,
                         num_kv_heads=2, head_dim=64, dtype=torch.bfloat16,
                         param_dtype=torch.bfloat16)


def profile() -> HeteroProfile:
    return HeteroProfile(split_layers=(EXITS[0],) * 4 + (EXITS[1],) * 4
                         + (EXITS[2],) * 4)
