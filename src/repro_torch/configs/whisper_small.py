"""whisper-small [audio] — enc-dec; the 12L **decoder** (d_model=768, 12H
kv=12, d_ff=3072, vocab=51865, GeLU, biases) with cross attention over
stubbed encoder states (1500 frames of 768-dim embeddings: the conv/mel
frontend and the encoder itself are the allowed stub, docs/DESIGN.md §4).
Deviation: RoPE replaces Whisper's learned absolute positions (does not
affect split/exit semantics).  [arXiv:2212.04356]"""
from __future__ import annotations

import torch

from repro_torch.config import HeteroProfile, ModelConfig

EXITS = (3, 6, 9)


def config(sliding_window=None) -> ModelConfig:
    return ModelConfig(
        name="whisper-small", arch_type="audio",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        d_ff=3072, vocab_size=51865, head_dim=64,
        act="gelu", use_qkv_bias=True, use_mlp_bias=True,
        cross_attention=True, cross_source_len=1500,
        exit_layers=EXITS, sliding_window=sliding_window,
        source="arXiv:2212.04356",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke", arch_type="audio",
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, head_dim=32,
        act="gelu", use_qkv_bias=True, use_mlp_bias=True,
        cross_attention=True, cross_source_len=16,
        exit_layers=(2,), dtype=torch.float32, param_dtype=torch.float32,
        source="arXiv:2212.04356",
    )


def smoke_bf16() -> ModelConfig:
    """The smoke config at the published head width (64) in bf16: self
    and cross attention take the forward's tile and decode routes and the
    backward's tile routes (cross attention at Tq != Tk), where the fp32
    head-dim-32 smoke takes only the row routes."""
    return smoke().with_(name="whisper-small-smoke-bf16", head_dim=64,
                         dtype=torch.bfloat16, param_dtype=torch.bfloat16)


def profile() -> HeteroProfile:
    return HeteroProfile(split_layers=(EXITS[0],) * 4 + (EXITS[1],) * 4
                         + (EXITS[2],) * 4)
