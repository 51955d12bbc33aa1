"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, GQA, no biases.  [hf:CohereForAI/c4ai-command-r-v01]"""
from __future__ import annotations

import torch

from repro_torch.config import HeteroProfile, ModelConfig

EXITS = (10, 20, 30)


def config(sliding_window=None) -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", arch_type="dense",
        num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=22528, vocab_size=256000, head_dim=128,
        rope_theta=10000.0, act="silu", exit_layers=EXITS,
        sliding_window=sliding_window,
        source="hf:CohereForAI/c4ai-command-r-v01",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b-smoke", arch_type="dense",
        num_layers=4, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32, exit_layers=(1, 2),
        dtype=torch.float32, param_dtype=torch.float32,
        source="hf:CohereForAI/c4ai-command-r-v01",
    )


def smoke_bf16() -> ModelConfig:
    """The smoke config at a full head width (64) in bf16 with the model's
    GQA group (8): the attention forward's tile and decode routes and
    the backward's tile routes run here, where the fp32 head-dim-32 smoke
    takes only the row routes."""
    return smoke().with_(name="command-r-35b-smoke-bf16", num_heads=8,
                         num_kv_heads=1, head_dim=64, dtype=torch.bfloat16,
                         param_dtype=torch.bfloat16)


def profile() -> HeteroProfile:
    return HeteroProfile(split_layers=(EXITS[0],) * 4 + (EXITS[1],) * 4
                         + (EXITS[2],) * 4)
