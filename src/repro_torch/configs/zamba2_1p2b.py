"""zamba2-1.2b [hybrid] — 38L d_model=2048, Mamba2 backbone with a single
globally-shared attention(+MLP) block applied every 6th layer; shared block:
32H (kv=32) d_ff=8192; ssm_state=64; vocab=32000.  [arXiv:2411.15242]"""
from __future__ import annotations

import torch

from repro_torch.config import HeteroProfile, ModelConfig, SSMConfig

NUM_LAYERS = 38
SHARED_EVERY = 6
EXITS = (10, 20, 29)


def _patterns(num_layers: int, shared_every: int):
    """Mamba2 layers without an FFN, the shared attention + MLP block at
    every ``shared_every``-th layer."""
    blocks, ffns = [], []
    for l in range(num_layers):
        shared = (l + 1) % shared_every == 0
        blocks.append("shared_attn" if shared else "mamba2")
        ffns.append("mlp" if shared else "none")
    return tuple(blocks), tuple(ffns)


def config(sliding_window=None) -> ModelConfig:
    blocks, ffns = _patterns(NUM_LAYERS, SHARED_EVERY)
    return ModelConfig(
        name="zamba2-1.2b", arch_type="hybrid",
        num_layers=NUM_LAYERS, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32000, head_dim=64,
        block_pattern=blocks, ffn_pattern=ffns,
        ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2,
                      head_dim=64, chunk_size=256),
        exit_layers=EXITS, sliding_window=sliding_window,
        source="arXiv:2411.15242",
    )


def smoke() -> ModelConfig:
    blocks, ffns = _patterns(4, 3)
    return ModelConfig(
        name="zamba2-1.2b-smoke", arch_type="hybrid",
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, head_dim=32,
        block_pattern=blocks, ffn_pattern=ffns,
        ssm=SSMConfig(kind="mamba2", d_state=16, d_conv=4, expand=2,
                      head_dim=32, chunk_size=8),
        exit_layers=(2,), dtype=torch.float32, param_dtype=torch.float32,
        source="arXiv:2411.15242",
    )


def smoke_bf16() -> ModelConfig:
    """The smoke config at the published attention head width (64) in
    bf16: the shared block's attention at GQA 1 takes the forward's tile
    and decode routes and the backward's tile routes, where the fp32
    head-dim-32 smoke takes only the row routes.  The shared block sits at
    layer 2, beside the exit (2,), as in the smoke."""
    return smoke().with_(name="zamba2-1.2b-smoke-bf16", head_dim=64,
                         dtype=torch.bfloat16, param_dtype=torch.bfloat16)


def profile() -> HeteroProfile:
    return HeteroProfile(split_layers=(EXITS[0],) * 4 + (EXITS[1],) * 4
                         + (EXITS[2],) * 4)
