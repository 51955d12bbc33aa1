"""Output heads (counterpart of ``repro/models/heads.py``): final norm +
unembedding.  The exit head (the paper's client output layer) is the same
function with its own weights.  Over a ``"model"`` group
(``launch/tensor_parallel.py``) a head whose ``w`` is split over the vocab
is column-parallel and its logits stay split, (..., V / P) on each rank:
the vocab-parallel cross entropy reads them so, and serving gathers them
(:func:`whole_logits`)."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models.common import fan_in_init, init_rmsnorm, rmsnorm


def init_lm_head(cfg: ModelConfig, generator, device) -> dict:
    return {
        "norm": init_rmsnorm(cfg.d_model, cfg.param_dtype, device),
        "w": fan_in_init((cfg.d_model, cfg.vocab_size), cfg.param_dtype,
                         generator, device),
    }


def lm_head(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return tp.linear(rmsnorm(params["norm"], x, cfg.norm_eps), params["w"],
                     cfg.d_model, cfg.vocab_size)[0]


def whole_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits whole over the vocab: gathered over the active ``"model"``
    group where a vocab-parallel head left them split."""
    return tp.whole(logits, logits.shape[-1] != cfg.vocab_size)


init_exit_head = init_lm_head
exit_head = lm_head
