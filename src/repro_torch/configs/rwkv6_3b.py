"""rwkv6-3b [ssm] — Finch: 32L d_model=2560, attention-free RWKV6 time-mix
with data-dependent per-channel decay + channel-mix FFN d_ff=8960,
vocab=65536, head_dim=64 (40 heads).  [arXiv:2404.05892]"""
from __future__ import annotations

import torch

from repro_torch.config import HeteroProfile, ModelConfig, SSMConfig

NUM_LAYERS = 32
EXITS = (8, 16, 24)


def config(sliding_window=None) -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", arch_type="ssm",
        num_layers=NUM_LAYERS, d_model=2560, num_heads=40, num_kv_heads=40,
        d_ff=8960, vocab_size=65536, head_dim=64,
        block_pattern=("rwkv6",) * NUM_LAYERS,
        ffn_pattern=("rwkv_cm",) * NUM_LAYERS,
        ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk_size=128),
        exit_layers=EXITS, sliding_window=sliding_window,
        source="arXiv:2404.05892",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke", arch_type="ssm",
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, head_dim=32,
        block_pattern=("rwkv6",) * 4, ffn_pattern=("rwkv_cm",) * 4,
        ssm=SSMConfig(kind="rwkv6", head_dim=32, chunk_size=8),
        exit_layers=(2,), dtype=torch.float32, param_dtype=torch.float32,
        source="arXiv:2404.05892",
    )


def smoke_bf16() -> ModelConfig:
    """The smoke config at the model's head width (64, two heads) in bf16
    with 16-token chunks: the wkv kernels run at the head dim and dtype of
    rwkv6-3b, where the fp32 smoke runs head dim 32 and chunk 8."""
    return smoke().with_(name="rwkv6-3b-smoke-bf16", num_heads=2,
                         num_kv_heads=2, head_dim=64,
                         ssm=SSMConfig(kind="rwkv6", head_dim=64,
                                       chunk_size=16),
                         dtype=torch.bfloat16, param_dtype=torch.bfloat16)


def profile() -> HeteroProfile:
    return HeteroProfile(split_layers=(EXITS[0],) * 4 + (EXITS[1],) * 4
                         + (EXITS[2],) * 4)
