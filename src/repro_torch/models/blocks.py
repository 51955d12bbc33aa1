"""One pre-norm residual block = mixer + FFN (counterpart of
``repro/models/blocks.py``).  Mixers: ``"attn"`` (GQA), ``"mla"``
(DeepSeek latent attention), ``"mamba2"``, ``"rwkv6"``; FFNs: ``"mlp"``,
``"moe"``, ``"rwkv_cm"`` and ``"none"`` (a block without ``norm2`` and
``ffn``, as Zamba2's Mamba2 layers).  Under ``cfg.cross_attention`` an
``"attn"`` or ``"mla"`` block also holds ``norm_x`` and ``cross``
(Whisper's decoder), which attend over the encoder states ``enc`` after
the mixer and before the FFN; cross attention keeps no cache."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import init_rmsnorm, rmsnorm
from repro_torch.models.mlp import init_mlp, mlp_forward

MIXER_INIT = {"attn": attn_mod.init_gqa, "mla": attn_mod.init_mla,
              "mamba2": ssm_mod.init_mamba2, "rwkv6": ssm_mod.init_rwkv6}
MIXERS = tuple(MIXER_INIT)
FFNS = ("mlp", "moe", "rwkv_cm", "none")
FFN_INIT = {"mlp": init_mlp, "moe": moe_mod.init_moe,
            "rwkv_cm": ssm_mod.init_rwkv_cm}


def check_kinds(cfg: ModelConfig, mixer: str, ffn: str) -> None:
    if mixer not in MIXERS:
        raise ValueError(f"{cfg.name}: unknown mixer {mixer!r}; expected "
                         f"one of {MIXERS}")
    if ffn not in FFNS:
        raise ValueError(f"{cfg.name}: unknown ffn {ffn!r}; expected one "
                         f"of {FFNS}")


def init_block(cfg: ModelConfig, mixer: str, ffn: str, generator,
               device) -> dict:
    check_kinds(cfg, mixer, ffn)
    p = {"norm1": init_rmsnorm(cfg.d_model, cfg.param_dtype, device),
         "mixer": MIXER_INIT[mixer](cfg, generator, device)}
    if ffn != "none":
        p["norm2"] = init_rmsnorm(cfg.d_model, cfg.param_dtype, device)
        p["ffn"] = FFN_INIT[ffn](cfg, generator, device)
    if cfg.cross_attention and mixer in ("attn", "mla"):
        p["norm_x"] = init_rmsnorm(cfg.d_model, cfg.param_dtype, device)
        p["cross"] = attn_mod.init_cross_attn(cfg, generator, device)
    return p


def init_block_cache(cfg: ModelConfig, mixer: str, ffn: str, batch: int,
                     max_len: int, dtype, device) -> dict:
    check_kinds(cfg, mixer, ffn)
    if mixer == "attn":
        c = {"mixer": attn_mod.init_gqa_cache(cfg, batch, max_len, dtype,
                                              device)}
    elif mixer == "mla":
        c = {"mixer": attn_mod.init_mla_cache(cfg, batch, max_len, dtype,
                                              device)}
    elif mixer == "mamba2":
        c = {"mixer": ssm_mod.init_mamba2_cache(cfg, batch, dtype, device)}
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
                  moe_groups: int = 1,
                  enc: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Optional[dict],
                             Optional[torch.Tensor]]:
    """Returns (x, cache, aux); the cache is updated in place.  ``aux`` is
    the MoE router's load-balance loss (fp32 scalar), ``None`` for a block
    without a router; a ``"moe"`` FFN routes the rows in ``moe_groups``
    groups (``models/moe.py``).  ``enc`` (B, S, d), the projected encoder
    states, feeds the block's cross attention where it has one."""
    check_kinds(cfg, mixer, ffn)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    mc = cache["mixer"] if cache else None
    if mixer == "attn":
        m, _ = attn_mod.gqa_forward(params["mixer"], h, positions, cfg,
                                    cache=mc, cache_len=cache_len)
    elif mixer == "mla":
        m, _ = attn_mod.mla_forward(params["mixer"], h, positions, cfg,
                                    cache=mc, cache_len=cache_len)
    elif mixer == "mamba2":
        m, _ = ssm_mod.mamba2_forward(params["mixer"], h, cfg, cache=mc)
    else:
        m, _ = ssm_mod.rwkv6_forward(params["mixer"], h, cfg, cache=mc)
    x = x + m
    if "cross" in params and enc is not None:
        hx = rmsnorm(params["norm_x"], x, cfg.norm_eps)
        x = x + attn_mod.cross_attn_forward(params["cross"], hx, enc, cfg)
    aux = None
    if ffn == "none":
        return x, cache, aux
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    if ffn == "mlp":
        f = mlp_forward(params["ffn"], h2, cfg, d_ff=cfg.d_ff)
    elif ffn == "moe":
        f, aux = moe_mod.moe_forward(params["ffn"], h2, cfg, moe_groups)
    else:
        f = ssm_mod.rwkv_cm_forward(params["ffn"], h2, cfg,
                                    last=cache["cm_last"] if cache else None)
        if cache:
            cache["cm_last"].copy_(h2[:, -1:])
    return x + f, cache, aux
