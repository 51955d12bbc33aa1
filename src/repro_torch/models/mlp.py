"""Feed-forward block: SwiGLU (counterpart of ``repro/models/mlp.py``).
The three products are plain large matrix products (``torch.matmul``), as
the JAX package left them to XLA."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.common import activation, fan_in_init


def init_mlp(cfg: ModelConfig, generator, device, d_ff: int = 0) -> dict:
    d, dff = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "w_gate": fan_in_init((d, dff), cfg.param_dtype, generator, device),
        "w_up": fan_in_init((d, dff), cfg.param_dtype, generator, device),
        "w_down": fan_in_init((dff, d), cfg.param_dtype, generator, device),
    }
    if cfg.use_mlp_bias:
        p["b_up"] = torch.zeros((dff,), dtype=cfg.param_dtype, device=device)
        p["b_down"] = torch.zeros((d,), dtype=cfg.param_dtype, device=device)
    return p


def mlp_forward(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = activation(cfg.act)
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    if "b_up" in params:
        up = up + params["b_up"]
    out = (act(gate) * up) @ params["w_down"]
    if "b_down" in params:
        out = out + params["b_down"]
    return out.to(x.dtype)
