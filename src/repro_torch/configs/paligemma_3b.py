"""paligemma-3b [vlm] — SigLIP vision tower (stubbed: 256 patch embeddings
of dim 1152 before the tokens) + 18L gemma decoder: d_model=2048 8H (GQA
kv=1) d_ff=16384 vocab=257216, head_dim=256.  [arXiv:2407.07726]"""
from __future__ import annotations

import torch

from repro_torch.config import HeteroProfile, ModelConfig

EXITS = (5, 9, 13)


def config(sliding_window=None) -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", arch_type="vlm",
        num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
        d_ff=16384, vocab_size=257216, head_dim=256,
        act="gelu", exit_layers=EXITS, sliding_window=sliding_window,
        source="arXiv:2407.07726",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b-smoke", arch_type="vlm",
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=1,
        d_ff=256, vocab_size=512, head_dim=32,
        act="gelu", exit_layers=(2,),
        dtype=torch.float32, param_dtype=torch.float32,
        source="arXiv:2407.07726",
    )


def smoke_bf16() -> ModelConfig:
    """The smoke config at the published head width (256) and GQA 8 (H 8,
    Hkv 1) in bf16: the forward's tile and decode routes and the
    backward's tile routes at head dim 256."""
    return smoke().with_(name="paligemma-3b-smoke-bf16", num_heads=8,
                         head_dim=256, dtype=torch.bfloat16,
                         param_dtype=torch.bfloat16)


def profile() -> HeteroProfile:
    return HeteroProfile(split_layers=(EXITS[0],) * 4 + (EXITS[1],) * 4
                         + (EXITS[2],) * 4)
