"""Output heads (counterpart of ``repro/models/heads.py``): final norm +
unembedding.  The exit head (the paper's client output layer) is the same
function with its own weights."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.common import fan_in_init, init_rmsnorm, rmsnorm


def init_lm_head(cfg: ModelConfig, generator, device) -> dict:
    return {
        "norm": init_rmsnorm(cfg.d_model, cfg.param_dtype, device),
        "w": fan_in_init((cfg.d_model, cfg.vocab_size), cfg.param_dtype,
                         generator, device),
    }


def lm_head(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rmsnorm(params["norm"], x, cfg.norm_eps) @ params["w"]


init_exit_head = init_lm_head
exit_head = lm_head
