"""One pre-norm residual block = mixer + FFN (counterpart of
``repro/models/blocks.py``).  The port runs ``"attn"`` (GQA) mixers and
``"mlp"`` FFNs; every other kind raises ``NotImplementedError``."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import init_rmsnorm, rmsnorm
from repro_torch.models.mlp import init_mlp, mlp_forward

_PENDING = ("not ported to repro_torch yet; see ROADMAP.md Queue 1, "
            "'Remaining mixers and the configs zoo'")


def check_kinds(cfg: ModelConfig, mixer: str, ffn: str) -> None:
    if mixer != "attn":
        raise NotImplementedError(f"{cfg.name}: mixer {mixer!r} is {_PENDING}")
    if ffn != "mlp":
        raise NotImplementedError(f"{cfg.name}: ffn {ffn!r} is {_PENDING}")
    if cfg.cross_attention:
        raise NotImplementedError(f"{cfg.name}: cross attention is {_PENDING}")


def init_block(cfg: ModelConfig, mixer: str, ffn: str, generator,
               device) -> dict:
    check_kinds(cfg, mixer, ffn)
    return {"norm1": init_rmsnorm(cfg.d_model, cfg.param_dtype, device),
            "mixer": attn_mod.init_gqa(cfg, generator, device),
            "norm2": init_rmsnorm(cfg.d_model, cfg.param_dtype, device),
            "ffn": init_mlp(cfg, generator, device)}


def init_block_cache(cfg: ModelConfig, mixer: str, ffn: str, batch: int,
                     max_len: int, dtype, device) -> dict:
    check_kinds(cfg, mixer, ffn)
    return {"mixer": attn_mod.init_gqa_cache(cfg, batch, max_len, dtype,
                                             device)}


def block_forward(params: dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, mixer: str, ffn: str, *,
                  cache: Optional[dict] = None,
                  cache_len: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (x, cache); the cache is updated in place."""
    check_kinds(cfg, mixer, ffn)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    m, _ = attn_mod.gqa_forward(params["mixer"], h, positions, cfg,
                                cache=cache["mixer"] if cache else None,
                                cache_len=cache_len)
    x = x + m
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + mlp_forward(params["ffn"], h2, cfg), cache
