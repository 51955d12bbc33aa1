"""One pre-norm residual block = mixer + FFN (counterpart of
``repro/models/blocks.py``).  The port runs ``"attn"`` (GQA) and
``"rwkv6"`` mixers and ``"mlp"`` and ``"rwkv_cm"`` FFNs; every other kind
raises ``NotImplementedError``."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import init_rmsnorm, rmsnorm
from repro_torch.models.mlp import init_mlp, mlp_forward

_PENDING = ("not ported to repro_torch yet; see ROADMAP.md Queue 1, "
            "'Remaining mixers and the configs zoo'")


MIXERS = ("attn", "rwkv6")
FFNS = ("mlp", "rwkv_cm")


def check_kinds(cfg: ModelConfig, mixer: str, ffn: str) -> None:
    if mixer not in MIXERS:
        raise NotImplementedError(f"{cfg.name}: mixer {mixer!r} is {_PENDING}")
    if ffn not in FFNS:
        raise NotImplementedError(f"{cfg.name}: ffn {ffn!r} is {_PENDING}")
    if cfg.cross_attention:
        raise NotImplementedError(f"{cfg.name}: cross attention is {_PENDING}")


def init_block(cfg: ModelConfig, mixer: str, ffn: str, generator,
               device) -> dict:
    check_kinds(cfg, mixer, ffn)
    init_mixer = (attn_mod.init_gqa if mixer == "attn"
                  else ssm_mod.init_rwkv6)
    init_ffn = init_mlp if ffn == "mlp" else ssm_mod.init_rwkv_cm
    return {"norm1": init_rmsnorm(cfg.d_model, cfg.param_dtype, device),
            "mixer": init_mixer(cfg, generator, device),
            "norm2": init_rmsnorm(cfg.d_model, cfg.param_dtype, device),
            "ffn": init_ffn(cfg, generator, device)}


def init_block_cache(cfg: ModelConfig, mixer: str, ffn: str, batch: int,
                     max_len: int, dtype, device) -> dict:
    check_kinds(cfg, mixer, ffn)
    if mixer == "attn":
        c = {"mixer": attn_mod.init_gqa_cache(cfg, batch, max_len, dtype,
                                              device)}
    else:
        c = {"mixer": ssm_mod.init_rwkv6_cache(cfg, batch, dtype, device)}
    if ffn == "rwkv_cm":
        c["cm_last"] = torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                   device=device)
    return c


def block_forward(params: dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, mixer: str, ffn: str, *,
                  cache: Optional[dict] = None,
                  cache_len: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (x, cache); the cache is updated in place."""
    check_kinds(cfg, mixer, ffn)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    mc = cache["mixer"] if cache else None
    if mixer == "attn":
        m, _ = attn_mod.gqa_forward(params["mixer"], h, positions, cfg,
                                    cache=mc, cache_len=cache_len)
    else:
        m, _ = ssm_mod.rwkv6_forward(params["mixer"], h, cfg, cache=mc)
    x = x + m
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    if ffn == "mlp":
        f = mlp_forward(params["ffn"], h2, cfg)
    else:
        f = ssm_mod.rwkv_cm_forward(params["ffn"], h2, cfg,
                                    last=cache["cm_last"] if cache else None)
        if cache:
            cache["cm_last"].copy_(h2[:, -1:])
    return x + f, cache
